"""Off-grid field evaluation: periodic Lagrangian stencil interpolation.

Vectorised, differentiable replacement for the reference's per-particle
double loop (/root/reference/qg_flow_ray_trace/interpolate.m:12-50 and its
duplicates interpolate_par.m / ray_trace_sw/interpolate.m). The algorithm
is identical — order-`order` 2-D Lagrangian interpolation on a
(2*order+2)^2 stencil with periodic wraparound (Durran Ch. 6) — but all
packets and all fields are evaluated in one batched gather + tensor
contraction, which XLA fuses.

Layout: every per-packet array keeps the packet axis LAST — stencil
indices/weights are (S, Np) and gathered values (nf, S, S, Np) — so the
large axis is the minor (contiguous) one and the small stencil axes
never end up minor.

Notes vs the reference:
  * The reference's weight formula carries a spurious (-1) sign in each
    1-D basis (denominator (j-i) instead of (i-j),
    interpolate.m:37-38) that cancels in the 2-D product; we use the
    sign-correct basis in each dimension.
  * The reference adds bump=1e-10 to avoid "NaNs" (interpolate.m:13); the
    product-form basis has no division by (a - j), so no bump is needed.

Gradients: exact w.r.t. both positions (piecewise-polynomial) and field
values (linear), via JAX autodiff; the transpose of the gather is a
scatter-add, which XLA emits natively.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from .grid import SpectralGrid

__all__ = [
    "lagrange_weights",
    "stencil_and_weights",
    "cell_and_weights",
    "interp_stencil_apply",
    "interpolate",
    "interpolate_stack",
    "build_windows",
    "interp_windowed",
]

# Packets per gather op: bounds the per-op index count and the raw
# gather buffer XLA may materialize. Chosen on another accelerator and
# kept until measured on this one (ROADMAP).
_GATHER_CHUNK = 131072

# Minimum packet count for the windowed gather path (build_windows /
# interp_windowed below): the (nx*ny, S*S*nf) window build costs one
# pass over a (S*S)x field-memory footprint per snapshot, and only pays
# off once the per-eval gather dominates. Chosen on another accelerator
# and kept until measured on this one (ROADMAP).
_WINDOW_MIN_NP = 65536


def _gather_apply(Fflat, flat_idx, w2):
    """Gather all nf fields per index in ONE op and reduce the stencil.

    Fflat: (nf, nx*ny); flat_idx, w2: (S, S, C) -> (nf, C).

    One gather of nf-element slices instead of nf scalar gathers (the
    gather's cost is mostly per INDEX). Indices are pre-wrapped into
    range -> skip the gather's clamp.
    """
    vals = Fflat.at[:, flat_idx].get(mode="promise_in_bounds")  # (nf,S,S,C)
    # mul+sum, not einsum/dot: a dot_general with the packet axis as
    # batch would transpose the operand to (C*S*S, nf).
    return (vals * w2[None]).sum((1, 2))


def _lagrange_denominators(order: int) -> np.ndarray:
    offsets = np.arange(-order, order + 2)
    denom = np.ones(len(offsets))
    for a, i in enumerate(offsets):
        for j in offsets:
            if j != i:
                denom[a] *= (i - j)
    return denom


def lagrange_weights(frac, order: int = 2):
    """1-D Lagrange basis weights at fractional cell position `frac`.

    Args:
      frac: (...,) array in [0, 1), position within the cell relative to
        the left node.
      order: stencil half-width parameter; stencil nodes are the integers
        -order .. order+1 (order=2 -> 6-point, the reference's Iord=2,
        interpolate.m:12).
    Returns:
      (2*order+2, ...) weights (node axis FIRST), summing to 1 over it.
    """
    offsets = np.arange(-order, order + 2)
    denom = _lagrange_denominators(order)
    a = frac[None] - offsets.reshape((-1,) + (1,) * frac.ndim)  # (S, ...)
    ws = []
    for idx in range(len(offsets)):
        mask = np.arange(len(offsets)) != idx
        ws.append(jnp.prod(a[mask], axis=0) / denom[idx])
    return jnp.stack(ws, axis=0)


def stencil_and_weights(x, y, grid: SpectralGrid, order: int = 2):
    """Compute periodic stencil indices and separable weights for packet
    positions.

    Args:
      x, y: (Np,) positions (any real values; periodic wrap applied).
    Returns:
      (ix, iy, wx, wy): ix, iy int32 (S, Np) grid indices; wx, wy (S, Np).
    """
    offsets = np.arange(-order, order + 2)
    xl = jnp.mod(x / grid.dx, grid.nx)
    yl = jnp.mod(y / grid.dy, grid.ny)
    i0 = jnp.floor(xl)
    j0 = jnp.floor(yl)
    ax = xl - i0
    ay = yl - j0
    wx = lagrange_weights(ax, order)
    wy = lagrange_weights(ay, order)
    ix = jnp.mod(i0[None].astype(jnp.int32) + offsets[:, None], grid.nx)
    iy = jnp.mod(j0[None].astype(jnp.int32) + offsets[:, None], grid.ny)
    return ix.astype(jnp.int32), iy.astype(jnp.int32), wx, wy


def cell_and_weights(x, y, grid: SpectralGrid, order: int = 2):
    """Cell indices and separable weights only — the windowed gather path
    needs one (i0, j0) per packet, not the (S, Np) per-node index arrays.

    Returns:
      (i0, j0, wx, wy): i0, j0 int32 (Np,) cell indices in [0, n);
      wx, wy (S, Np) Lagrange weights.
    """
    xl = jnp.mod(x / grid.dx, grid.nx)
    yl = jnp.mod(y / grid.dy, grid.ny)
    i0 = jnp.floor(xl)
    j0 = jnp.floor(yl)
    wx = lagrange_weights(xl - i0, order)
    wy = lagrange_weights(yl - j0, order)
    # floor of mod can still hit n exactly from float rounding at the
    # right edge; fold it back.
    i0 = jnp.mod(i0.astype(jnp.int32), grid.nx)
    j0 = jnp.mod(j0.astype(jnp.int32), grid.ny)
    return i0, j0, wx, wy


def build_windows(F, order: int = 2):
    """Materialize the full (S x S, nf) interpolation window of every grid
    cell: returns W of shape (nx*ny, S*S*nf) where row (i*ny + j) holds
    F[:, i-order:i+order+2, j-order:j+order+2] (periodic) laid out as
    (sx, sy, f).

    Why: a 'take'-style gather (size-1 on the indexed axis, all other
    axes fetched whole) costs mostly per INDEX, so pre-building windows
    turns the 36-indices-per-packet stencil gather (interpolate.m's 6x6
    loop) into ONE index per packet, for one build per snapshot. The
    memory cost is (S*S)x the field stack (226 MB at 512^2, nf=6, f32).
    """
    if F.ndim == 2:
        F = F[None]
    nf, nx, ny = F.shape
    S = 2 * order + 2
    Fp = jnp.concatenate([F[:, :, ny - order:], F, F[:, :, :order + 2]],
                         axis=2)
    Fp = jnp.concatenate([Fp[:, nx - order:], Fp, Fp[:, :order + 2]],
                         axis=1)                     # (nf, nx+S-1+1, ny+...)
    rows = []
    for sx in range(S):
        cols = [Fp[:, sx:sx + nx, sy:sy + ny] for sy in range(S)]
        rows.append(jnp.stack(cols, axis=0))         # (Sy, nf, nx, ny)
    W = jnp.stack(rows, axis=0)                       # (Sx, Sy, nf, nx, ny)
    W = jnp.transpose(W, (3, 4, 0, 1, 2))             # (nx, ny, Sx, Sy, nf)
    return W.reshape(nx * ny, S * S * nf)


def _window_apply(W, nf, starts, wx, wy):
    """One chunk of the windowed gather: starts (C,), wx/wy (S, C)."""
    S, C = wx.shape
    g = W.at[starts].get(mode="promise_in_bounds")    # (C, S*S*nf)
    g = g.reshape(C, S, S, nf)
    return jnp.einsum("cxyf,xc,yc->fc", g, wx, wy,
                      precision=lax.Precision.HIGHEST)


def interp_windowed(W, nf, x, y, grid: SpectralGrid, order: int = 2):
    """Interpolate nf stacked fields from a prebuilt window array W
    (see build_windows) at packet positions. Exactly the same arithmetic
    as interpolate_stack — one take-style gather per packet instead of
    S*S point gathers."""
    i0, j0, wx, wy = cell_and_weights(x, y, grid, order)
    starts = i0 * grid.ny + j0                         # (Np,)
    Np = starts.shape[0]
    S = 2 * order + 2
    if Np <= _GATHER_CHUNK:
        return _window_apply(W, nf, starts, wx, wy)
    C = _GATHER_CHUNK
    pad = (-Np) % C
    if pad:
        starts = jnp.pad(starts, (0, pad))
        wx = jnp.pad(wx, ((0, 0), (0, pad)))
        wy = jnp.pad(wy, ((0, 0), (0, pad)))
    nc = (Np + pad) // C
    st = starts.reshape(nc, C)
    wxc = jnp.moveaxis(wx.reshape(S, nc, C), 1, 0)
    wyc = jnp.moveaxis(wy.reshape(S, nc, C), 1, 0)
    out = lax.map(lambda a: _window_apply(W, nf, *a), (st, wxc, wyc))
    return jnp.moveaxis(out, 0, 1).reshape(nf, nc * C)[:, :Np]


def interp_stencil_apply(F, ix, iy, wx, wy):
    """Apply precomputed stencil to stacked fields.

    Args:
      F: (nf, nx, ny) or (nx, ny) fields.
      ix, iy: (S, Np) int32 indices; wx, wy: (S, Np) weights.
    Returns:
      (nf, Np) or (Np,) interpolated values.
    """
    single = F.ndim == 2
    if single:
        F = F[None]
    nf, nx, ny = F.shape
    S, Np = ix.shape
    flat_idx = ix[:, None, :] * ny + iy[None, :, :]          # (S, S, Np)
    w2 = wx[:, None, :] * wy[None, :, :]                       # (S, S, Np)
    Fflat = F.reshape(nf, nx * ny)
    if Np <= _GATHER_CHUNK:
        out = _gather_apply(Fflat, flat_idx, w2)
    else:
        # Chunk the packet axis: an unchunked gather at 1e6 packets
        # lets XLA materialize the (S*S*Np, nf)-shaped raw gather
        # output at once. lax.map reuses one chunk buffer.
        C = _GATHER_CHUNK
        pad = (-Np) % C
        if pad:
            flat_idx = jnp.pad(flat_idx, ((0, 0), (0, 0), (0, pad)))
            w2 = jnp.pad(w2, ((0, 0), (0, 0), (0, pad)))
        nc = (Np + pad) // C
        fi = jnp.moveaxis(flat_idx.reshape(S, S, nc, C), 2, 0)
        wc = jnp.moveaxis(w2.reshape(S, S, nc, C), 2, 0)
        out = lax.map(lambda a: _gather_apply(Fflat, *a), (fi, wc))
        out = jnp.moveaxis(out, 0, 1).reshape(nf, nc * C)[:, :Np]
    return out[0] if single else out


def interpolate(F, x, y, grid: SpectralGrid, order: int = 2):
    """Interpolate a single field to packet positions.

    Drop-in equivalent of the reference `interpolate(x, y, F, dx, dy)`
    (qg_flow_ray_trace/interpolate.m), vectorised over packets.
    """
    ix, iy, wx, wy = stencil_and_weights(x, y, grid, order)
    return interp_stencil_apply(F, ix, iy, wx, wy)


def interpolate_stack(F, x, y, grid: SpectralGrid, order: int = 2):
    """Interpolate a stack of fields (nf, nx, ny) at shared positions —
    the reference calls `interpolate` 12 times per evaluation
    (interpolate_U.m:5-17); here the stencil is computed once."""
    ix, iy, wx, wy = stencil_and_weights(x, y, grid, order)
    return interp_stencil_apply(F, ix, iy, wx, wy)


def _cubic_conv_weights(frac):
    """Keys cubic-convolution (a=-1/2, MATLAB interp2 'cubic' kernel)
    weights for nodes -1, 0, 1, 2 at fractional position frac in [0,1).
    Returns (4, ...) with the node axis first."""
    t = frac[None]
    w_m1 = -0.5 * t * (1 - t) ** 2
    w_0 = 1 - 2.5 * t**2 + 1.5 * t**3
    w_1 = 0.5 * t * (1 + 4 * t - 3 * t**2)
    w_2 = 0.5 * t**2 * (t - 1)
    return jnp.concatenate([w_m1, w_0, w_1, w_2], axis=0)


def interpolate_cubic(F, x, y, grid: SpectralGrid):
    """Periodic bicubic-convolution interpolation — the reference's
    interpolate2.m intent (MATLAB interp2 'cubic' on a periodic
    4-point halo-extended grid), implemented correctly; the reference's
    version is buggy (see why_isnt_interpolate2_working.m:32-49, which
    sweeps y-slices comparing it against the Lagrangian stencil)."""
    offsets = np.arange(-1, 3)
    xl = jnp.mod(x / grid.dx, grid.nx)
    yl = jnp.mod(y / grid.dy, grid.ny)
    i0 = jnp.floor(xl)
    j0 = jnp.floor(yl)
    wx = _cubic_conv_weights(xl - i0)
    wy = _cubic_conv_weights(yl - j0)
    ix = jnp.mod(i0[None].astype(jnp.int32) + offsets[:, None], grid.nx)
    iy = jnp.mod(j0[None].astype(jnp.int32) + offsets[:, None], grid.ny)
    return interp_stencil_apply(F, ix.astype(jnp.int32),
                                iy.astype(jnp.int32), wx, wy)
