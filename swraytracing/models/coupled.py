"""Lock-step coupled flow + wave-packet driver (layer L4).

Re-design of the production SLURM entry point
/root/reference/qg_flow_ray_trace/qgsw_raytrace.m: every flow step
advances the one-layer QG field one AB3 step, then sub-cycles the packet
ray ODE between the previous and new flow snapshots with linear blending
in time (interpolate_U.m:19-23). The reference sub-cycles with adaptive
MATLAB ode23 (qgsw_raytrace.m:149); we use a fixed number of RK23/RK4
substeps per flow step, which keeps the whole loop a `lax.scan` (static
shapes, reproducible, reverse-differentiable).

The velocity/gradient grids of the *previous* step are reused as the
blend-start snapshot, so the per-step cost is one QG RHS (5 FFTs) + one
grid_U (6 FFTs) + n_substeps fused packet updates — the reference
recomputes grid_U twice per step (12 extra FFTs) and pays a 36-point
scalar gather per packet per ode23 stage.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from ..utils import pytree as struct

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp
from ..ops import interp as _interp
from ..ops import pallas_window as pwin
from .dispersion import Dispersion
from .fields import BlendedFlow, flow_from_qk
from .qg import (QGParams, QGState, qg_init, qg_step, initial_q_ring,
                 inertial_ring_forcing, max_speed)
from . import rays

__all__ = ["CoupledConfig", "CoupledSetup", "CoupledCarry", "setup_coupled",
           "coupled_flow_packet_step", "run_coupled_chunk", "ring_packet_ics",
           "prepare_carry_windows", "march_n_fields", "window_threshold"]


class CoupledConfig(NamedTuple):
    """Mirrors the qgsw_raytrace positional signature
    (qgsw_raytrace.m:1) plus the tuning constants it hard-codes."""

    nx: int = 256
    n_packets: int = 50
    near_inertial_factor: float = 2.0   # w0: initial omega / f
    T_Fr_days: float = 6000.0
    packet_delay_days: float = 1000.0
    U_g: float = 0.4
    f: float = 3.0
    Cg: float = 1.0
    L: float = 2.0 * np.pi
    beta: float = 0.0
    r_drag: float = 0.1
    forcing_strength: float = 0.1
    CFL_fraction: float = 0.05          # qgsw_raytrace.m:29
    steps_per_save: int = 50
    packet_steps_per_save: int = 5
    # Packet substeps per flow step. 2 is the shipping default: it
    # stays inside the reference's ode23 1e-6 tolerance envelope in
    # EVERY committed regime (lockstep_step docstring tables — ~2600x
    # margin at the two-layer headline config, 3.3x at the most extreme
    # one-layer point, w0=16 at 10x-CFL dt) with half the march's stage
    # evaluations of 4. Set 4 to restore the wider margin.
    n_substeps: int = 2
    stepper: str = "rk23"               # 'rk23' | 'rk4' | 'symplectic'
    seed: int = 146                     # rng(146), qgsw_raytrace.m:23
    ring_ic: bool = True                # False reproduces the reference bug
    reference_quirks: bool = False
    dealias: bool = False
    # Fused packet march (ops/pallas_window.py): gather each packet's
    # margin-widened stencil window ONCE per flow step and run all
    # substeps on it with zero per-stage gathers. Engages at n_packets
    # >= window_min_np; the per-stage path below that.
    fused_march: bool = True
    # Packet count above which window-based paths engage (both the fused
    # march and the windowed-interp path). The window build costs one
    # pass over (S*S)x the field memory per snapshot and only pays off
    # once the per-eval gather dominates. The value was chosen on
    # another accelerator and is kept until measured on this one
    # (ROADMAP). Engagement is decided ONCE, at setup_coupled — the
    # carry's pytree structure (prev_fields nf, window slot) depends on
    # it, so it must never be re-read mid-run.
    window_min_np: int = 65536
    # Windows hold only (u, v); the march forms the velocity-gradient
    # tensor by differentiating the Lagrange interpolant (3x less
    # gather/window traffic; ~1.3e-7 relative gradient error at 512^2 —
    # benchmarks/gradinterp_accuracy.py — below the f32 epsilon
    # production runs live at). Turn off for bit-parity with the
    # per-stage spectral-gradient path.
    march_uv_windows: bool = True
    # ONE gather per packet per flow step over both snapshots stacked
    # on the window axis (half the gather indices). Arithmetic is
    # bit-identical to two gathers.
    march_combined_gather: bool = True
    # Explicit march margin (cells) overriding required_margin's CFL
    # sizing; None = size from dt and the initial max speed. Drivers
    # widen the margin automatically when the kernel reports overflow.
    march_margin: int | None = None


class CoupledSetup(NamedTuple):
    grid: SpectralGrid
    disp: Dispersion
    qg_params: QGParams
    dt: float
    n_steps: int
    packet_delay: float
    packet_step_start: int
    Fr: float
    U0: float
    T: float
    march: pwin.MarchSpec | None = None


@struct.dataclass
class CoupledCarry:
    flow_state: QGState
    packet_x: jnp.ndarray        # (2, Np) coordinate-first
    packet_k: jnp.ndarray        # (2, Np)
    # (nf, nx, ny) grid_U fields of the previous step. nf is fixed at
    # setup by march_n_fields: 6 ([u, v, u_x, u_y, v_x, v_y]) on every
    # path except the fused march with uv windows, which carries only
    # (u, v) (nf=2; grad U is formed in-kernel). Checkpoints record nf
    # implicitly via this shape; drivers reconcile on resume when the
    # resuming config implies a different nf.
    prev_fields: jnp.ndarray
    # Prebuilt interpolation windows of prev_fields (ops/interp.
    # build_windows, or ops/pallas_window.build_gather_windows on the
    # fused-march path), carried across flow steps so each lock-step
    # builds windows only for its NEW snapshot — the previous step
    # already built this one as its win2. None below window_min_np
    # packets (stencil-gather path).
    prev_win: jnp.ndarray | None = None
    # Running max of the fused march's margin-overflow counter (scalar
    # int32; 0 = every stencil stayed inside its gathered window). Only
    # populated on the fused-march path; drivers surface it next to the
    # blow-up check.
    overflow: jnp.ndarray | None = None


def ring_packet_ics(cfg: CoupledConfig, grid: SpectralGrid, seed=None):
    """Packet ICs (qgsw_raytrace.m:54-60): |k| on the near-inertial ring
    sqrt((w0^2-1) f^2 / Cg^2), equally spaced angles; positions uniform.
    Returns x, k as (2, Np) coordinate-first arrays."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    i = np.arange(1, cfg.n_packets + 1)
    wf = np.sqrt((cfg.near_inertial_factor**2 - 1.0) * cfg.f**2 / cfg.Cg**2)
    k = wf * np.stack([np.cos(2 * np.pi * i / cfg.n_packets),
                       np.sin(2 * np.pi * i / cfg.n_packets)], axis=0)
    x = rng.uniform(0.0, cfg.L, (2, cfg.n_packets))
    return jax.device_put(x), jax.device_put(k)


def setup_coupled(cfg: CoupledConfig):
    """Build grid, params, ICs and the CFL time step, mirroring
    qgsw_raytrace.m:13-73.

    Returns (setup, carry0).
    """
    grid = SpectralGrid.square(cfg.nx, cfg.L)
    disp = Dispersion(f=cfg.f, Cg=cfg.Cg)
    Kd2 = cfg.f / cfg.Cg  # K_d2 = f/Cg as the reference (qgsw_raytrace.m:27)

    qk0 = initial_q_ring(cfg.seed, grid, cfg.U_g, Kd2, ring=cfg.ring_ic)
    forcing = inertial_ring_forcing(cfg.forcing_strength, grid, cfg.f, cfg.Cg)

    U0 = float(jax.jit(max_speed, static_argnums=(1, 2))(qk0, grid, Kd2))
    Fr = U0 / cfg.Cg
    T_days = cfg.T_Fr_days / cfg.f
    T = T_days / Fr**2
    dt = cfg.CFL_fraction * grid.dx / U0
    n_steps = int(np.ceil(T / dt))
    packet_delay = cfg.packet_delay_days / cfg.f
    packet_step_start = int(np.ceil(packet_delay / dt))

    ef = sp.exp_filter(grid)
    qp = QGParams(Kd2=Kd2, beta=cfg.beta, r_drag=cfg.r_drag, dt=dt,
                  forcing=jnp.asarray(forcing), filter=jnp.asarray(ef),
                  dealias=cfg.dealias, reference_quirks=cfg.reference_quirks)

    px0, pk0 = ring_packet_ics(cfg, grid)
    march = build_march_spec(cfg, grid, dt, U0)
    nf0 = march_n_fields(march)
    fields0 = jax.jit(
        lambda q: flow_from_qk(q, grid, Kd2, n_fields=nf0).fields)(qk0)
    carry0 = CoupledCarry(flow_state=qg_init(qk0), packet_x=px0,
                          packet_k=pk0, prev_fields=fields0)
    setup = CoupledSetup(grid=grid, disp=disp, qg_params=qp, dt=dt,
                         n_steps=n_steps, packet_delay=packet_delay,
                         packet_step_start=packet_step_start, Fr=Fr, U0=U0,
                         T=T, march=march)
    return setup, carry0


def default_platform() -> str:
    """Platform of the device new arrays and computations go to: the
    `jax.default_device` in force, else the default backend's."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def build_march_spec(cfg, grid: SpectralGrid, dt: float, U0: float):
    """MarchSpec for the fused packet march, margin sized to the CFL
    step (required_margin). The engine is the one for the platform the
    run is placed on (pallas_window.march_engine: the Pallas kernel on a
    GPU, the XLA march on the CPU, an error on anything else).

    Returns None when the march does not engage — fused_march off, an
    incompatible stepper, or n_packets below window_min_np. Engagement
    is decided HERE, once: `march is not None` is the single source of
    truth for the fused path everywhere downstream (lockstep_step,
    march_n_fields, prepare_carry_windows)."""
    if not getattr(cfg, "fused_march", False):
        return None
    if cfg.stepper not in ("rk23", "rk4", "symplectic"):
        return None
    if cfg.n_packets < window_threshold(cfg):
        return None
    if min(grid.nx, grid.ny) < 2 * 2 + 4:  # S + 2 at order 2
        # grid too small for even a margin-1 window (max_margin's
        # floor of 1 would not fit) — fall back to the stencil paths
        return None
    margin = getattr(cfg, "march_margin", None)
    if margin is None:
        margin = pwin.required_margin(dt, U0, cfg.Cg, grid.dx,
                                      nx=min(grid.nx, grid.ny))
    uv = getattr(cfg, "march_uv_windows", False)
    return pwin.MarchSpec(
        nx=grid.nx, ny=grid.ny, dx=grid.dx, dy=grid.dy,
        f=cfg.f, Cg=cfg.Cg, n_substeps=cfg.n_substeps,
        stepper=cfg.stepper, margin=margin, tiles_transposed=True,
        engine=pwin.march_engine(default_platform()),
        nf=2 if uv else 6, grad_from_interp=uv,
        combined_gather=getattr(cfg, "march_combined_gather", False))


def window_threshold(cfg) -> int:
    """The engagement threshold for window-based paths, from the config
    (falling back to ops/interp's measured default for configs predating
    the field)."""
    return getattr(cfg, "window_min_np", _interp._WINDOW_MIN_NP)


def march_n_fields(march, n_packets: int | None = None) -> int:
    """Field-grid count the lock-step needs: the fused march with uv
    windows (grad_from_interp) forms grad U in-kernel, so only (u, v)
    grids are computed — the four gradient-grid inverse transforms of
    grid_U.m are skipped. Every other path needs the full 6 stack.

    `march is None` means the fused path is disengaged (build_march_spec
    decides once, at setup); n_packets is accepted for backwards
    compatibility but no longer consulted."""
    return march.nf if march is not None else 6


def _substep_fn(name: str):
    if name == "rk23":
        return rays.rk23_step
    if name == "rk4":
        return rays.rk4_step
    if name == "symplectic":
        return None  # handled specially (no alpha ramp within substep)
    raise ValueError(f"unknown stepper {name!r}")


def lockstep_step(carry: CoupledCarry, flow_step_fn, fields_fn, grid, disp,
                  dt, packet_delay, n_substeps: int, stepper: str,
                  march: pwin.MarchSpec | None = None,
                  window_min_np: int | None = None) -> CoupledCarry:
    """Generic lock-step iteration (qgsw_raytrace.m:121-151 and
    qg2layersw_raytrace.m:152-197): advance the flow one step, rebuild
    velocity grids, sub-cycle packets against the time-blended snapshots.
    Packets are frozen (dt=0) until t > packet_delay, matching the
    reference's gating.

    Fixed sub-stepping vs the reference's adaptive ode23 (SURVEY hard
    part #4): the reference sub-cycles each flow step with MATLAB ode23
    at rtol=1e-6/atol=1e-7. Our stepping (rk23 stages; n_substeps=2 is
    the shipping default, 4 the wider-margin option) was
    validated against rays.rk23_adaptive at those tolerances and at
    rtol=1e-10 truth over one flow step at the production configs
    (benchmarks/substep_study.py, 256^2, w0 in {2,16}; errors are
    max|dy|/max|k| vs truth):

        omega*dt    adaptive@1e-6   rk23 n=2   n=4       n=8
        0.018 (CFL) 4.5e-11         2.5e-11    3.1e-12   3.8e-13
        0.147 (CFL) 1.8e-11         3.0e-11    3.7e-12   4.6e-13
        1.474 (10x) 6.2e-10         3.0e-07    3.8e-08   4.7e-09

    i.e. n_substeps=4 stays >= 26x inside the reference's 1e-6
    envelope even at omega*dt ~ 1.5 — the largest value reachable with
    the committed run configurations (w0=16, the dt=0.024 long-run
    logs). The symplectic stepper trades pointwise accuracy
    (~2.6e-4 at that regime) for exact phase-space conservation; use it
    for throughput, rk23 for ode23 parity
    (tests/test_rays.py::test_fixed_substeps_within_ode23_envelope).

    The TWO-LAYER headline configuration (512^2, the path
    qg2layersw_raytrace.m:184-197 sub-cycles identically;
    benchmarks/substep_study2.py) has a smaller CFL dt and is even
    further inside the envelope (adaptive@1e-6 err ~1.1-1.9e-10):

        omega*dt      rk23 n=1   n=2        n=4        n=8
        0.035 (w0=2)  2.5e-09    3.1e-10    5.6e-11    7.9e-12
        0.278 (w0=16) 3.1e-09    3.9e-10    4.9e-11    2.0e-11

    Args:
      flow_step_fn: flow_state -> flow_state (one solver step; must
        advance .t).
      fields_fn: flow_state -> (nf, nx, ny) stacked velocity/gradients
        (nf = march.nf on the fused path, 6 otherwise — march_n_fields).
      march: fused-march spec, or None when disengaged. Engagement was
        decided at setup (build_march_spec); this function trusts that
        decision and verifies the carry matches it.
      window_min_np: threshold for the windowed-interp fallback path
        (non-march); defaults to ops/interp._WINDOW_MIN_NP. Pass the
        config's value so path choice is a pure function of the config.
    """
    if window_min_np is None:
        window_min_np = _interp._WINDOW_MIN_NP
    new_state = flow_step_fn(carry.flow_state)
    fields2 = fields_fn(new_state)
    Np = carry.packet_x.shape[-1]

    exp_nf = march_n_fields(march)
    if carry.prev_fields.shape[0] != exp_nf:
        raise ValueError(
            f"carry.prev_fields holds {carry.prev_fields.shape[0]} field "
            f"grids but this configuration's path needs {exp_nf} "
            f"(march {'engaged' if march is not None else 'disengaged'}"
            f"{f', nf={march.nf}' if march is not None else ''}). The "
            "carry was built under a different march/window configuration "
            "— rebuild it with setup_coupled/setup_coupled2 or reconcile "
            "prev_fields (drivers do this on checkpoint resume).")
    if fields2.shape[0] != exp_nf:
        raise ValueError(
            f"fields_fn produced {fields2.shape[0]} field grids but the "
            f"path needs {exp_nf}; pass n_fields=march_n_fields(march).")

    if march is not None:
        assert march.stepper == stepper and march.n_substeps == n_substeps, \
            ("MarchSpec built for a different stepper configuration: "
             f"{march.stepper} x{march.n_substeps} vs {stepper} x"
             f"{n_substeps}; rebuild the setup with the new config")
        # Fused-march path (ops/pallas_window.py): windows gathered ONCE
        # per flow step with a `margin` drift allowance, all substeps run
        # with zero per-stage gathers. Identical arithmetic to the
        # per-stage path (tested) as long as no packet drifts more than
        # `margin` cells within the step — the running max of the
        # march's overflow counter is carried for drivers to assert on.
        win2 = pwin.build_gather_windows(fields2, march)
        win1 = carry.prev_win
        if win1 is None or win1.shape != win2.shape:
            win1 = pwin.build_gather_windows(carry.prev_fields, march)
        active = new_state.t > packet_delay
        sub_dt = jnp.where(active, dt / n_substeps, 0.0)
        x, k = carry.packet_x, carry.packet_k
        oi, oj = pwin.packet_cells(x[0], x[1], march)
        xk = jnp.concatenate([x, k], axis=0)
        if march.combined_gather:
            # Both snapshots' windows stacked on the K axis -> ONE
            # gather per packet per flow step (MarchSpec.combined_gather).
            winc = jnp.concatenate(
                [win1, win2], axis=-1 if march.tiles_transposed else 0)
            pwc = pwin.gather_packet_windows(winc, oi, oj, march)
            dummy = jnp.zeros((1, 1), pwc.dtype)
            out, ov = pwin.fused_march(pwc, dummy, xk, oi, oj, sub_dt,
                                       march)
        else:
            pw1 = pwin.gather_packet_windows(win1, oi, oj, march)
            pw2 = pwin.gather_packet_windows(win2, oi, oj, march)
            out, ov = pwin.fused_march(pw1, pw2, xk, oi, oj, sub_dt,
                                       march)
        px, pk = out[:2], out[2:]
        new_ov = jnp.max(ov)
        overflow = (new_ov if carry.overflow is None
                    else jnp.maximum(carry.overflow, new_ov))
        out_win = win2 if carry.prev_win is not None else None
        return CoupledCarry(flow_state=new_state, packet_x=px,
                            packet_k=pk, prev_fields=fields2,
                            prev_win=out_win, overflow=overflow)

    win2 = None
    if Np >= window_min_np:
        # Large packet counts: prebuild interpolation windows so every
        # substage RHS does one gather index per packet instead of 36
        # (ops/interp.build_windows). Only the NEW
        # snapshot's windows are built here; the blend-start snapshot
        # reuses the win2 the previous step carried forward (hoisted by
        # ensure_carry_windows before the first step).
        win1 = carry.prev_win
        if win1 is None:
            # No carried window (e.g. remat mode, which keeps the big
            # window arrays out of the per-step AD residuals): build
            # both here, recomputed in the backward sweep.
            win1 = _interp.build_windows(carry.prev_fields)
        win2 = _interp.build_windows(fields2)
        flow = BlendedFlow(fields1=carry.prev_fields, fields2=fields2,
                           grid=grid, win1=win1, win2=win2)
    else:
        flow = BlendedFlow(fields1=carry.prev_fields, fields2=fields2,
                           grid=grid)

    active = new_state.t > packet_delay
    m = n_substeps
    sub_dt = jnp.where(active, dt / m, 0.0)

    step = _substep_fn(stepper)

    def body(i, xk):
        x, k = xk
        a0 = i / m
        if step is None:
            return rays.symplectic_step(x, k, sub_dt, disp, flow,
                                        alpha=a0 + 0.5 / m)
        return step(x, k, sub_dt, disp, flow, alpha0=a0, dalpha=1.0 / m)

    px, pk = lax.fori_loop(0, m, body, (carry.packet_x, carry.packet_k))
    # Structure-stable window carry: a carry that came in with windows
    # leaves with the new snapshot's; one without stays without (the
    # windows built above stay internal to this step).
    out_win = win2 if carry.prev_win is not None else None
    return CoupledCarry(flow_state=new_state, packet_x=px, packet_k=pk,
                        prev_fields=fields2, prev_win=out_win,
                        overflow=carry.overflow)


def prepare_carry_windows(carry: CoupledCarry, remat: bool = False,
                          march: pwin.MarchSpec | None = None,
                          window_min_np: int | None = None
                          ) -> CoupledCarry:
    """Make the carry's window/overflow slots consistent with the path
    lockstep_step will take, so scan/fori_loop bodies are
    structure-stable. Forward runs on a window path (fused march, or
    windowed interp above window_min_np packets) get prev_fields'
    windows prebuilt (each step then builds windows only for its new
    snapshot); the builder follows the path (margin windows for the
    fused march, stencil windows otherwise). remat (differentiable)
    runs strip the slot: jax.checkpoint saves step inputs as residuals,
    and carrying the window array would cost (S*S)x the field memory
    per step — window building stays internal to the step and is
    recomputed in the backward sweep instead."""
    if window_min_np is None:
        window_min_np = _interp._WINDOW_MIN_NP
    march_on = march is not None
    engaged = march_on or carry.packet_x.shape[-1] >= window_min_np
    want_ov = march_on
    if want_ov and carry.overflow is None:
        carry = carry.replace(overflow=jnp.zeros((), jnp.int32))
    if not want_ov and carry.overflow is not None:
        carry = carry.replace(overflow=None)
    use_win = not remat and engaged
    if use_win:
        build = ((lambda f: pwin.build_gather_windows(f, march))
                 if march_on else _interp.build_windows)
        win = carry.prev_win
        if march_on and win is not None:
            # Stale-window check must follow the window layout:
            # tiles_transposed stores (ncells, K), otherwise (K, ncells)
            # (ADVICE round 2: comparing shape[-1] to K under the
            # untransposed layout compared ncells to K).
            k_ax = -1 if march.tiles_transposed else 0
            rebuild = win.shape[k_ax] != march.K
        else:
            rebuild = win is None
        if rebuild:
            return carry.replace(prev_win=build(carry.prev_fields))
        return carry
    if carry.prev_win is not None:
        return carry.replace(prev_win=None)
    return carry


def coupled_flow_packet_step(carry: CoupledCarry, s: CoupledSetup,
                             cfg: CoupledConfig) -> CoupledCarry:
    """One-layer QG lock-step iteration (qgsw_raytrace.m:121-151)."""
    grid, qp = s.grid, s.qg_params
    nf = march_n_fields(s.march)
    return lockstep_step(
        carry,
        flow_step_fn=lambda st: qg_step(st, grid, qp),
        fields_fn=lambda st: flow_from_qk(st.qk, grid, qp.Kd2,
                                          n_fields=nf).fields,
        grid=grid, disp=s.disp, dt=s.dt, packet_delay=s.packet_delay,
        n_substeps=cfg.n_substeps, stepper=cfg.stepper, march=s.march,
        window_min_np=window_threshold(cfg))


def run_coupled_chunk(carry: CoupledCarry, s: CoupledSetup,
                      cfg: CoupledConfig, n_saves: int,
                      remat: bool = False, diag_fn=None):
    """Advance n_saves * packet_steps_per_save flow steps, emitting a
    packet snapshot every packet_steps_per_save steps (the reference's
    packet save cadence, qgsw_raytrace.m:153-163).

    Jit with static (s, cfg, n_saves). Returns
    (carry, (px (n_saves,2,Np), pk (n_saves,2,Np), t (n_saves,))).

    diag_fn: optional carry -> pytree device diagnostic (e.g.
    analysis.device_diag.omega_hist_counts over packet_k). When given,
    each save emits (diag, t) INSTEAD of the full packet arrays and the
    return becomes (carry, (diag (n_saves, ...), t (n_saves,))) — the
    O(bins)-per-save fetch path that keeps the host transfer of
    production-length runs small (the reference's equivalent
    statistic is formed post-hoc from frames, load_data.m:33-52).

    remat=True rematerialises each lock-step iteration in reverse-mode
    AD: gradient memory drops from O(total steps * full intermediate
    set) to O(total steps * carry) — the standard trade for
    differentiating long coupled runs (SURVEY.md section 5, long-
    sequence axis). Forward-only runs should leave it off.
    """
    step = lambda cc: coupled_flow_packet_step(cc, s, cfg)
    if remat:
        step = jax.checkpoint(step)
    carry = prepare_carry_windows(carry, remat, s.march,
                                  window_threshold(cfg))

    def one_save(c, _):
        def body(i, cc):
            return step(cc)

        c = lax.fori_loop(0, cfg.packet_steps_per_save, body, c)
        if diag_fn is not None:
            return c, (diag_fn(c), c.flow_state.t)
        return c, (c.packet_x, c.packet_k, c.flow_state.t)

    return lax.scan(one_save, carry, None, length=n_saves)
