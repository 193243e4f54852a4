"""Fused wave-packet march: all packet substeps of one flow step fed by
ONE window gather per packet per flow step.

This is the production-scale version of the windowed interpolation idea
(ops/interp.build_windows): the reference sub-cycles each flow step with
ode23, paying a 6x6 Lagrangian stencil gather per packet per stage
(/root/reference/qg_flow_ray_trace/interpolate.m:12-50 via
interpolate_U.m and qgsw_raytrace.m:149,258-268).

Key observation: over ONE flow step a packet moves at most
dt*(|U|+Cg)/dx cells — under the production CFL that is < 1 cell. So a
stencil window gathered once per flow step, widened by a `margin` of
cells on each side, contains every stencil node that any substage of
that step can touch. The march then needs NO gathers at all:

  per flow step:
    build W  = cell windows of the new snapshot    (nx*ny, K), K = nf*SW^2
    gather   pw = W[cell(x)] per packet, both snapshots
    march    all n_substeps x stages on the gathered windows: Lagrange
             weights, margin shift, time blend, dispersion, RK/symplectic
             update

Two engines run the march, chosen once per configuration (MarchSpec.
engine): `march_reference`, plain XLA, and `march_pallas`, a Pallas
kernel on the Triton route that reads each packet's window row once and
keeps the packet state in registers across all stages.

Within-margin arithmetic is IDENTICAL to the reference stencil: the
extended weights place the same 6 Lagrange weights (Durran Ch. 6,
interpolate.m:37-44) at the packet's current cell inside the wider
window; positions that drift past the margin are clamped to the nearest
in-window stencil and counted in the `overflow` output (callers assert
it stays zero; see required_margin).

Layouts: `tiles_transposed=True` (production) gathers contiguous window
ROWS, (Np, K) per packet; False gathers columns of the (K, ncells)
array into (K, Np). The packet axis stays last in every packet-state
array ((4, Np) = [x, y, kx, ky]).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.custom_batching import custom_vmap
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "MarchSpec",
    "ENGINES",
    "march_engine",
    "required_margin",
    "build_margin_windows",
    "build_gather_windows",
    "packet_cells",
    "gather_packet_windows",
    "march_reference",
    "march_pallas",
    "fused_march",
]

# Engine per JAX platform: the Triton-route kernel on NVIDIA GPUs, the
# plain XLA march on the CPU. Any other platform is an error.
ENGINES = {"gpu": "pallas", "cpu": "xla"}

# Packets per kernel program (a power of two) and warps per program:
# the fastest of 16:2 .. 128:8 on an H100 at the headline widths, within
# 2 % of 32:4 and 64:8 (PERF.md).
BLOCK = 16
NUM_WARPS = 2


def march_engine(platform: str) -> str:
    """The march engine for a JAX platform name ('gpu', 'cpu')."""
    try:
        return ENGINES[platform]
    except KeyError:
        raise ValueError(
            f"no packet-march engine for platform {platform!r}; "
            f"supported: {sorted(ENGINES)}") from None


class MarchSpec(NamedTuple):
    """Static configuration of the fused march (hashable; closed over by
    jit and passed as a nondiff argument to the custom VJP)."""

    nx: int
    ny: int
    dx: float
    dy: float
    f: float
    Cg: float
    n_substeps: int = 4
    stepper: str = "rk23"          # 'rk23' | 'rk4' | 'symplectic'
    order: int = 2                 # Lagrange stencil half-width (Iord)
    margin: int = 1                # drift allowance, cells per flow step
    nf: int = 6                    # fields: u, v, ux, uy, vx, vy
    tiles_transposed: bool = False # pw gathered as (Np, K) rows
    engine: str = "xla"            # 'xla' (march_reference) | 'pallas'
    # Windows carry only (u, v) (nf=2); the march evaluates the
    # velocity-gradient tensor by DIFFERENTIATING the Lagrange
    # interpolant (w'_i(fx) w_j(fy) / dx) instead of interpolating
    # spectrally differentiated grids (grid_U.m:1-18). 3x smaller
    # windows, so 3x less gather traffic; accuracy cost quantified in
    # benchmarks/gradinterp_accuracy.py: ~1.3e-7 relative at 512^2 (vs
    # 3e-9 for the spectral-gradient path) — below the f32 epsilon
    # production runs live at.
    grad_from_interp: bool = False
    # Both snapshots' packet windows arrive in ONE gathered array,
    # stacked on the K axis ((2K, Np), or (Np, 2K) tiles_transposed) —
    # halves the number of gather indices per flow step. fused_march's
    # pw2 argument is then a dummy.
    combined_gather: bool = False

    @property
    def S(self) -> int:
        return 2 * self.order + 2

    @property
    def SW(self) -> int:
        return self.S + 2 * self.margin

    @property
    def K(self) -> int:
        return self.nf * self.SW * self.SW


def required_margin(dt: float, u_max: float, Cg: float, dx: float,
                    headroom: float = 3.0, nx: int | None = None,
                    order: int = 2) -> int:
    """Margin (cells) covering the worst-case packet drift over one flow
    step: |dx/dt| <= |U| + |Cg_group| <= u_max + Cg (group speed of the
    SW dispersion is bounded by Cg). `headroom` scales u_max because the
    flow can strengthen past its initial maximum during the run; the
    kernel's overflow counter catches violations at runtime.

    With `nx` given, the margin is capped so the window (SW = 2*order+2
    + 2*margin) never exceeds the periodic grid — a wider window would
    duplicate cells and the build would slice out of range (hit when a
    CFL recheck on a strongly-decayed flow produced a huge dt). A
    capped margin that proves too small surfaces through the kernel's
    overflow counter, which drivers treat as discard-and-retry/halt."""
    m = max(1, int(np.ceil(dt * (headroom * u_max + Cg) / dx)))
    if nx is not None:
        m = min(m, max_margin(nx, order))
    return m


def max_margin(nx: int, order: int = 2) -> int:
    """Largest margin whose window still fits the periodic grid."""
    return max(1, (nx - (2 * order + 2)) // 2)


# ---------------------------------------------------------------------------
# Window build + gather (XLA side)
# ---------------------------------------------------------------------------

def build_margin_windows(F, spec: MarchSpec):
    """(nf, nx, ny) fields -> (K, nx*ny) cell-window array W:
    W[(f*SW + sx)*SW + sy, i*ny + j] = F[f, i + sx - (order+margin),
    j + sy - (order+margin)] (periodic). Rows are shifted flattened
    copies of the fields — contiguous writes, no relayout (the
    (ncells, K)-minor layout of interp.build_windows costs a 400 MB
    transpose per step at 512^2/margin-1)."""
    F = F[:spec.nf]  # grad_from_interp (nf=2) keeps only (u, v)
    nf, nx, ny = F.shape
    SW = spec.SW
    lo = spec.order + spec.margin
    hi = spec.order + 1 + spec.margin
    if lo > min(nx, ny) or hi > min(nx, ny):
        raise ValueError(
            f"march window (margin={spec.margin}, SW={SW}) exceeds the "
            f"{nx}x{ny} periodic grid; cap the margin with "
            "required_margin(..., nx=) / max_margin")
    Fp = jnp.concatenate([F[:, :, ny - lo:], F, F[:, :, :hi]], axis=2)
    Fp = jnp.concatenate([Fp[:, nx - lo:], Fp, Fp[:, :hi]], axis=1)
    rows = [Fp[f, sx:sx + nx, sy:sy + ny].reshape(nx * ny)
            for f in range(nf) for sx in range(SW) for sy in range(SW)]
    return jnp.stack(rows, axis=0)


def build_gather_windows(F, spec: MarchSpec):
    """Cell-window array in the layout gather_packet_windows expects:
    (K, ncells) when tiles_transposed=False, else (ncells, K), whose
    rows a per-packet gather reads contiguously."""
    W = build_margin_windows(F, spec)
    return W.T if spec.tiles_transposed else W


def packet_cells(x, y, spec: MarchSpec):
    """Origin cell of each packet: (oi, oj) int32 in [0, n)."""
    xl = jnp.mod(x / spec.dx, spec.nx)
    yl = jnp.mod(y / spec.dy, spec.ny)
    oi = jnp.floor(xl).astype(jnp.int32)
    oj = jnp.floor(yl).astype(jnp.int32)
    oi = jnp.where(oi >= spec.nx, oi - spec.nx, oi)
    oj = jnp.where(oj >= spec.ny, oj - spec.ny, oj)
    return oi, oj


def gather_packet_windows(W, oi, oj, spec: MarchSpec):
    """One take-style gather per packet: W (K, ncells) -> pw.

    tiles_transposed=False: gather columns -> (K, Np) directly.
    tiles_transposed=True: gather rows of W.T's layout — caller must
    pass W already transposed to (ncells, K); returns (Np, K)."""
    starts = oi * spec.ny + oj
    if spec.tiles_transposed:
        return W.at[starts].get(mode="promise_in_bounds")      # (Np, K)
    return W.at[:, starts].get(mode="promise_in_bounds")       # (K, Np)


# ---------------------------------------------------------------------------
# Shared march arithmetic (runs inside the kernel AND as the XLA
# reference/backward implementation — one source of truth)
# ---------------------------------------------------------------------------

def _lagrange_ws(fr, order: int):
    """S Lagrange basis weights at fractional position fr (B,) in [0,1)
    for nodes -order..order+1 (interpolate.m:33-44, sign-correct form —
    see ops/interp.lagrange_weights). Python-unrolled so the kernel
    traces it to plain elementwise arithmetic."""
    offs = list(range(-order, order + 2))
    denom = []
    for i in offs:
        d = 1.0
        for j in offs:
            if j != i:
                d *= (i - j)
        denom.append(d)
    a = [fr - o for o in offs]
    ws = []
    for idx in range(len(offs)):
        p = None
        for j in range(len(offs)):
            if j == idx:
                continue
            p = a[j] if p is None else p * a[j]
        ws.append(p * (1.0 / denom[idx]))
    return ws


def _lagrange_dws(fr, order: int):
    """d/dfr of the S Lagrange basis weights (exact — the basis is a
    degree-(S-1) polynomial): L_i'(fr) = sum_m Pi_{j != i,m}(fr - o_j)
    / denom_i. Python-unrolled like _lagrange_ws; the physical
    derivative needs a further 1/dx scale at the call site."""
    offs = list(range(-order, order + 2))
    denom = []
    for i in offs:
        d = 1.0
        for j in offs:
            if j != i:
                d *= (i - j)
        denom.append(d)
    a = [fr - o for o in offs]
    dws = []
    for idx in range(len(offs)):
        s = None
        for m in range(len(offs)):
            if m == idx:
                continue
            p = None
            for j in range(len(offs)):
                if j == idx or j == m:
                    continue
                p = a[j] if p is None else p * a[j]
            if p is None:  # order 0: two nodes, constant derivative
                p = jnp.ones_like(fr)
            s = p if s is None else s + p
        dws.append(s * (1.0 / denom[idx]))
    return dws


def _extended_weights(ws, d, margin: int, width: int, axis: int):
    """Place the S stencil weights into a `width`-wide window row at
    integer shift d (B,) in [-margin, margin]: window position p holds
    ws[p - d - margin] (zero outside, and zero at padding positions
    p >= SW). Select-sum instead of a dynamic gather — d is per-packet.
    axis=0 returns (width, B), axis=1 returns (B, width)."""
    if axis == 0:
        t = jnp.arange(width, dtype=jnp.int32)[:, None] - (d + margin)[None, :]
        put = lambda w: w[None, :]
    else:
        t = jnp.arange(width, dtype=jnp.int32)[None, :] - (d + margin)[:, None]
        put = lambda w: w[:, None]
    zero = jnp.zeros((), ws[0].dtype)
    out = None
    for s, w in enumerate(ws):
        term = jnp.where(t == s, put(w), zero)
        out = term if out is None else out + term
    return out


def _cell_offsets(x0, x1, oi, oj, spec: MarchSpec):
    """Fractional cell position (fx, fy), the integer shift (di, dj) of
    the packet's current cell from its gather cell (oi, oj) clamped to
    the margin, and the margin excess ov (B,) int32 (0 in-window)."""
    nx, ny, m = spec.nx, spec.ny, spec.margin
    xl = jnp.mod(x0 * (1.0 / spec.dx), nx)
    yl = jnp.mod(x1 * (1.0 / spec.dy), ny)
    i0f = jnp.floor(xl)
    j0f = jnp.floor(yl)
    fx = xl - i0f
    fy = yl - j0f
    i0 = i0f.astype(jnp.int32)
    j0 = j0f.astype(jnp.int32)
    i0 = jnp.where(i0 >= nx, i0 - nx, i0)   # floor(mod) fp edge
    j0 = jnp.where(j0 >= ny, j0 - ny, j0)
    di = i0 - oi
    di = jnp.where(di > nx // 2, di - nx, di)
    di = jnp.where(di < -(nx // 2), di + nx, di)
    dj = j0 - oj
    dj = jnp.where(dj > ny // 2, dj - ny, dj)
    dj = jnp.where(dj < -(ny // 2), dj + ny, dj)
    ov = jnp.maximum(jnp.maximum(jnp.abs(di), jnp.abs(dj)) - m, 0)
    di = jnp.clip(di, -m, m)
    dj = jnp.clip(dj, -m, m)
    return fx, fy, di, dj, ov


def _eval_fields(pw1, pw2, x0, x1, alpha, oi, oj, spec: MarchSpec):
    """Interpolate the 6 time-blended fields at packet positions from
    the margin windows. pw*: (nf, SW, SW, B); returns ((6, B), ov).

    Identical arithmetic to BlendedFlow.at on the windowed path
    (models/fields.py) for |drift| <= margin: same Lagrange weights,
    same field values, blend folded into the reduction."""
    fx, fy, di, dj, ov = _cell_offsets(x0, x1, oi, oj, spec)
    SW, m = spec.SW, spec.margin
    wex = _extended_weights(_lagrange_ws(fx, spec.order), di, m, SW, 0)
    wey = _extended_weights(_lagrange_ws(fy, spec.order), dj, m, SW, 0)
    one = jnp.asarray(1.0, pw1.dtype)
    v = ((one - alpha) * pw1 + alpha * pw2)           # blend
    # SEPARABLE contraction: the 2-D stencil weight is wex (x) wey, so
    # contract the y axis once per field (ty = sum_j v[..,j,:] wey_j)
    # and finish with SW-long x contractions (exact reassociation of
    # the same products).
    ty = (v * wey[None, None, :, :]).sum(2)           # (nf, SW, B)
    if not spec.grad_from_interp:
        vals = (ty * wex[None, :, :]).sum(1)          # (nf, B)
        return vals, ov
    # nf=2 windows (u, v): the velocity-gradient tensor comes from the
    # DERIVATIVE of the Lagrange interpolant instead of interpolating
    # spectrally differentiated grids (grid_U.m:1-18) — ~1.3e-7
    # relative at 512^2 (benchmarks/gradinterp_accuracy.py).
    dwex = _extended_weights(_lagrange_dws(fx, spec.order), di, m, SW, 0)
    dwey = _extended_weights(_lagrange_dws(fy, spec.order), dj, m, SW, 0)
    tdy = (v * dwey[None, None, :, :]).sum(2)         # (nf, SW, B)
    u = (ty[0] * wex).sum(0)
    vv = (ty[1] * wex).sum(0)
    ux = (ty[0] * dwex).sum(0) * (1.0 / spec.dx)
    uy = (tdy[0] * wex).sum(0) * (1.0 / spec.dy)
    vx = (ty[1] * dwex).sum(0) * (1.0 / spec.dx)
    vy = (tdy[1] * wex).sum(0) * (1.0 / spec.dy)
    return jnp.stack([u, vv, ux, uy, vx, vy]), ov


def _march_core(evaluate, x0, x1, k0, k1, sub_dt, spec: MarchSpec):
    """All n_substeps of one flow step. evaluate(x0, x1, alpha) returns
    the 6 interpolated fields (indexable, each (B,)) and the margin
    excess; sub_dt is the substep length (dt_flow / n_substeps; 0
    freezes packets). The flow blend fraction ramps alpha = (i +
    stage)/n over the step, exactly the reference's interpolate_U
    convention (interpolate_U.m:19-23). Steppers match models/rays.py:
    rk23 = Bogacki-Shampine stages of MATLAB's ode23
    (qgsw_raytrace.m:149), rk4, symplectic = Strang phi1/phi2/phi1
    (ode_symplectic.m:33-37)."""
    n = spec.n_substeps
    gH = spec.Cg ** 2
    f2 = spec.f ** 2
    h = sub_dt
    ov_tot = jnp.zeros(x0.shape, jnp.int32)

    def rhs(xx0, xx1, kk0, kk1, alpha):
        F, ov = evaluate(xx0, xx1, alpha)
        om = jnp.sqrt(f2 + gH * (kk0 * kk0 + kk1 * kk1))
        inv = 1.0 / om
        return (F[0] + gH * kk0 * inv, F[1] + gH * kk1 * inv,
                -(F[2] * kk0 + F[4] * kk1), -(F[3] * kk0 + F[5] * kk1),
                ov)

    for i in range(n):
        a0 = i / n
        da = 1.0 / n
        if spec.stepper == "rk23":
            d = rhs(x0, x1, k0, k1, a0)
            e = rhs(x0 + 0.5 * h * d[0], x1 + 0.5 * h * d[1],
                    k0 + 0.5 * h * d[2], k1 + 0.5 * h * d[3],
                    a0 + 0.5 * da)
            g = rhs(x0 + 0.75 * h * e[0], x1 + 0.75 * h * e[1],
                    k0 + 0.75 * h * e[2], k1 + 0.75 * h * e[3],
                    a0 + 0.75 * da)
            c = h / 9.0
            x0 = x0 + c * (2.0 * d[0] + 3.0 * e[0] + 4.0 * g[0])
            x1 = x1 + c * (2.0 * d[1] + 3.0 * e[1] + 4.0 * g[1])
            k0 = k0 + c * (2.0 * d[2] + 3.0 * e[2] + 4.0 * g[2])
            k1 = k1 + c * (2.0 * d[3] + 3.0 * e[3] + 4.0 * g[3])
            ov_tot = jnp.maximum(ov_tot,
                                 jnp.maximum(d[4], jnp.maximum(e[4], g[4])))
        elif spec.stepper == "rk4":
            d = rhs(x0, x1, k0, k1, a0)
            e = rhs(x0 + 0.5 * h * d[0], x1 + 0.5 * h * d[1],
                    k0 + 0.5 * h * d[2], k1 + 0.5 * h * d[3],
                    a0 + 0.5 * da)
            g = rhs(x0 + 0.5 * h * e[0], x1 + 0.5 * h * e[1],
                    k0 + 0.5 * h * e[2], k1 + 0.5 * h * e[3],
                    a0 + 0.5 * da)
            q = rhs(x0 + h * g[0], x1 + h * g[1],
                    k0 + h * g[2], k1 + h * g[3], a0 + da)
            c = h / 6.0
            x0 = x0 + c * (d[0] + 2.0 * (e[0] + g[0]) + q[0])
            x1 = x1 + c * (d[1] + 2.0 * (e[1] + g[1]) + q[1])
            k0 = k0 + c * (d[2] + 2.0 * (e[2] + g[2]) + q[2])
            k1 = k1 + c * (d[3] + 2.0 * (e[3] + g[3]) + q[3])
            ov_tot = jnp.maximum(
                ov_tot, jnp.maximum(jnp.maximum(d[4], e[4]),
                                    jnp.maximum(g[4], q[4])))
        elif spec.stepper == "symplectic":
            om = jnp.sqrt(f2 + gH * (k0 * k0 + k1 * k1))
            cinv = 0.5 * h * gH / om
            x0 = x0 + cinv * k0
            x1 = x1 + cinv * k1
            F, ov = evaluate(x0, x1, a0 + 0.5 * da)
            k0n = k0 - h * (F[2] * k0 + F[4] * k1)
            k1n = k1 - h * (F[3] * k0 + F[5] * k1)
            x0 = x0 + h * F[0]
            x1 = x1 + h * F[1]
            k0, k1 = k0n, k1n
            om = jnp.sqrt(f2 + gH * (k0 * k0 + k1 * k1))
            cinv = 0.5 * h * gH / om
            x0 = x0 + cinv * k0
            x1 = x1 + cinv * k1
            ov_tot = jnp.maximum(ov_tot, ov)
        else:
            raise ValueError(f"unknown stepper {spec.stepper!r}")
    return x0, x1, k0, k1, ov_tot


# ---------------------------------------------------------------------------
# XLA engine (CPU engine, test oracle, VJP backward)
# ---------------------------------------------------------------------------

def march_reference(pw1, pw2, xk, oi, oj, sub_dt, spec: MarchSpec):
    """Pure-XLA fused march over all packets at once. pw*: (K, Np) (or
    (Np, K) when spec.tiles_transposed); xk (4, Np) = [x, y, kx, ky];
    returns (xk_out (4, Np), overflow (Np,) int32).

    combined_gather: pw1 carries BOTH snapshots stacked on the K axis
    ((2K, Np) / (Np, 2K)); pw2 is ignored (pass any array)."""
    if spec.grad_from_interp and spec.nf != 2:
        raise ValueError("grad_from_interp windows hold (u, v): nf must "
                         f"be 2, got {spec.nf}")
    if spec.combined_gather:
        w = pw1.T if spec.tiles_transposed else pw1          # (2K, Np)
        p = w.reshape(2, spec.nf, spec.SW, spec.SW, -1)
        p1, p2 = p[0], p[1]
    else:
        if spec.tiles_transposed:
            pw1 = pw1.T
            pw2 = pw2.T
        p1 = pw1.reshape(spec.nf, spec.SW, spec.SW, -1)
        p2 = pw2.reshape(spec.nf, spec.SW, spec.SW, -1)
    r = _march_core(
        lambda a, b, al: _eval_fields(p1, p2, a, b, al, oi, oj, spec),
        xk[0], xk[1], xk[2], xk[3], sub_dt, spec)
    return jnp.stack(r[:4]), r[4]


# ---------------------------------------------------------------------------
# Pallas engine (Triton route)
# ---------------------------------------------------------------------------

def _tile_eval(tiles, x0, x1, alpha, oi, oj, spec: MarchSpec):
    """_eval_fields on per-field window tiles held by one kernel
    program: tiles[s][f] is snapshot s, field f as (B, W, W) with W =
    SW rounded up to a power of two (padding entries are zero and get
    zero weight). Same products, summed in the same separable order."""
    fx, fy, di, dj, ov = _cell_offsets(x0, x1, oi, oj, spec)
    W, m = tiles[0][0].shape[-1], spec.margin
    wex = _extended_weights(_lagrange_ws(fx, spec.order), di, m, W, 1)
    wey = _extended_weights(_lagrange_ws(fy, spec.order), dj, m, W, 1)
    if spec.grad_from_interp:
        dwex = _extended_weights(_lagrange_dws(fx, spec.order), di, m, W, 1)
        dwey = _extended_weights(_lagrange_dws(fy, spec.order), dj, m, W, 1)
    vals = []
    grads = []
    for f in range(spec.nf):
        v = (1.0 - alpha) * tiles[0][f] + alpha * tiles[1][f]   # (B, W, W)
        ty = (v * wey[:, None, :]).sum(2)                        # (B, W)
        vals.append((ty * wex).sum(1))
        if spec.grad_from_interp:
            tdy = (v * dwey[:, None, :]).sum(2)
            grads.append(((ty * dwex).sum(1) * (1.0 / spec.dx),
                          (tdy * wex).sum(1) * (1.0 / spec.dy)))
    if spec.grad_from_interp:
        (ux, uy), (vx, vy) = grads
        return (vals[0], vals[1], ux, uy, vx, vy), ov
    return tuple(vals), ov


def _march_kernel(dt_ref, *refs, spec: MarchSpec, n: int):
    if spec.combined_gather:
        pw_ref, xk_ref, oi_ref, oj_ref, out_ref, ov_ref = refs
        sources = ((pw_ref, 0), (pw_ref, spec.K))
    else:
        pw1_ref, pw2_ref, xk_ref, oi_ref, oj_ref, out_ref, ov_ref = refs
        sources = ((pw1_ref, 0), (pw2_ref, 0))
    B, SW = BLOCK, spec.SW
    W = pl.next_power_of_2(SW)
    rows = pl.program_id(0) * B + jnp.arange(B, dtype=jnp.int32)
    live = rows < n
    w = jnp.arange(W, dtype=jnp.int32)
    # window (sx, sy) of field f sits at column f*SW^2 + sx*SW + sy of
    # the packet's contiguous row; W x W tiles mask the SW x SW part
    cols = w[:, None] * SW + w[None, :]
    in_win = (w[:, None] < SW) & (w[None, :] < SW)
    tmask = live[:, None, None] & in_win[None]
    tiles = [[plgpu.load(ref.at[rows[:, None, None],
                                (off + f * SW * SW + cols)[None]],
                         mask=tmask, other=0.0)
              for f in range(spec.nf)]
             for ref, off in sources]
    xk = [plgpu.load(xk_ref.at[c, rows], mask=live, other=0.0)
          for c in range(4)]
    oi = plgpu.load(oi_ref.at[rows], mask=live, other=0)
    oj = plgpu.load(oj_ref.at[rows], mask=live, other=0)
    dt = dt_ref[0]
    r = _march_core(
        lambda a, b, al: _tile_eval(tiles, a, b, al, oi, oj, spec),
        xk[0], xk[1], xk[2], xk[3], dt, spec)
    for c in range(4):
        plgpu.store(out_ref.at[c, rows], r[c], mask=live)
    plgpu.store(ov_ref.at[rows], r[4], mask=live)


def march_pallas(pw1, pw2, xk, oi, oj, sub_dt, spec: MarchSpec,
                 interpret: bool = False):
    """march_reference as one Pallas kernel on the Triton route: one
    program per BLOCK packets (any packet count; the last block is
    masked), each reading its packets' window rows once and running
    every stage of every substep on them in registers. Needs the
    production row layout (tiles_transposed). Inputs and outputs as
    march_reference; `interpret` runs the kernel in the Pallas
    interpreter (tests on the CPU)."""
    if not spec.tiles_transposed:
        raise ValueError("march_pallas reads (Np, K) window rows: "
                         "needs tiles_transposed=True")
    if spec.grad_from_interp and spec.nf != 2:
        raise ValueError("grad_from_interp windows hold (u, v): nf must "
                         f"be 2, got {spec.nf}")
    n = xk.shape[-1]
    dt = jnp.asarray(sub_dt, xk.dtype).reshape(1)
    pw_args = (pw1,) if spec.combined_gather else (pw1, pw2)
    out, ov = pl.pallas_call(
        functools.partial(_march_kernel, spec=spec, n=n),
        grid=(pl.cdiv(n, BLOCK),),
        out_shape=(jax.ShapeDtypeStruct((4, n), xk.dtype),
                   jax.ShapeDtypeStruct((n,), jnp.int32)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="packet_march",
    )(dt, *pw_args, xk, oi.astype(jnp.int32), oj.astype(jnp.int32))
    return out, ov


# ---------------------------------------------------------------------------
# custom_vjp wrapper: engine forward, XLA-reference backward
# ---------------------------------------------------------------------------

def _engine_march(pw1, pw2, xk, oi, oj, sub_dt, spec: MarchSpec):
    if spec.engine == "pallas":
        return march_pallas(pw1, pw2, xk, oi, oj, sub_dt, spec)
    if spec.engine == "xla":
        return march_reference(pw1, pw2, xk, oi, oj, sub_dt, spec)
    raise ValueError(f"unknown march engine {spec.engine!r}")


# A kernel is opaque to the SPMD partitioner, which would gather every
# packet onto every device. The engine is therefore wrapped in a
# custom_partitioning rule: packets are independent, so each device
# marches the packets it holds, sharded however the caller placed xk
# (its last axis), with no collective. One device lowers the engine
# as is. Under vmap (ensemble members) the engine is vmapped as is;
# a sharded ensemble shard_maps whole members
# (parallel.ensemble.run_ensemble_chunk(mesh=)).

@functools.partial(custom_partitioning, static_argnums=(6,))
def _partitioned_march(pw1, pw2, xk, oi, oj, sub_dt, spec: MarchSpec):
    return _engine_march(pw1, pw2, xk, oi, oj, sub_dt, spec)


def _march_sharding_rule(spec, mesh, operand_types, result_types):
    pw = "n k" if spec.tiles_transposed else "k n"
    pw2 = ("a b" if spec.combined_gather else
           "n l" if spec.tiles_transposed else "l n")
    return f"{pw}, {pw2}, c n, n, n, -> c n, n"


def _march_partition(spec, mesh, arg_shapes, result_shape):
    NS, P = jax.sharding.NamedSharding, jax.sharding.PartitionSpec
    xk_spec = arg_shapes[2].sharding.spec
    pk = xk_spec[1] if len(xk_spec) > 1 else None
    pw = NS(mesh, P(pk, None) if spec.tiles_transposed else P(None, pk))
    args = (pw, NS(mesh, P()) if spec.combined_gather else pw,
            NS(mesh, P(None, pk)), NS(mesh, P(pk)), NS(mesh, P(pk)),
            NS(mesh, P()))
    results = (NS(mesh, P(None, pk)), NS(mesh, P(pk)))
    return mesh, functools.partial(_engine_march, spec=spec), results, args


_partitioned_march.def_partition(partition=_march_partition,
                                 sharding_rule=_march_sharding_rule)


@functools.cache
def _device_march(spec: MarchSpec):
    @custom_vmap
    def march(pw1, pw2, xk, oi, oj, sub_dt):
        return _partitioned_march(pw1, pw2, xk, oi, oj, sub_dt, spec)

    @march.def_vmap
    def _batched(axis_size, in_batched, *args):
        axes = [0 if b else None for b in in_batched]
        out = jax.vmap(functools.partial(_engine_march, spec=spec),
                       in_axes=axes)(*args)
        return out, (True, True)

    return march


@functools.partial(jax.custom_vjp, nondiff_argnums=(6,))
def fused_march(pw1, pw2, xk, oi, oj, sub_dt, spec: MarchSpec):
    """Differentiable fused march. The forward runs spec.engine on each
    device's packets; the backward always differentiates the XLA
    reference (same arithmetic, clean shapes: the cotangent w.r.t. the
    packet windows is dense per-packet weight outer products — no
    scatter)."""
    return _device_march(spec)(pw1, pw2, xk, oi, oj,
                               jnp.asarray(sub_dt, xk.dtype))


def _fused_march_fwd(pw1, pw2, xk, oi, oj, sub_dt, spec):
    out = fused_march(pw1, pw2, xk, oi, oj, sub_dt, spec)
    return out, (pw1, pw2, xk, oi, oj, sub_dt)


def _fused_march_bwd(spec, res, ct):
    pw1, pw2, xk, oi, oj, sub_dt = res
    ct_xk, _ = ct  # overflow output is integer — no cotangent

    def f(pw1_, pw2_, xk_, dt_):
        return march_reference(pw1_, pw2_, xk_, oi, oj, dt_, spec)[0]

    _, vjp = jax.vjp(f, pw1, pw2, xk, sub_dt)
    g_pw1, g_pw2, g_xk, g_dt = vjp(ct_xk)
    zi = np.zeros(oi.shape, jax.dtypes.float0)
    zj = np.zeros(oj.shape, jax.dtypes.float0)
    return g_pw1, g_pw2, g_xk, zi, zj, g_dt


fused_march.defvjp(_fused_march_fwd, _fused_march_bwd)
