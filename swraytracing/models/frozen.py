"""Frozen-flow raytracing drivers (BASELINE.json configs 1-3 and the
restart-frame workflow).

Reference parity:
  * `raytrace_frozen` — packets through a STEADY flow (analytic or
    gridded) with any integrator, reporting the absolute-frequency
    conservation error dOmega/Omega0 — the reference's primary
    integrator-correctness metric
    (/root/reference/SW_zero_background_raytracing.m:85-132,
    symplectic_full_fourier.m).
  * `raytrace_pv_snapshot` — loads a PV frame from a frame-addressed
    .bin (reference or ours), inverts it to a streamfunction exactly as
    SW_zero_background_raytracing.m:26-30 (psi_k = -q_k/(K_d^2 + K^2)),
    and raytraces through the frozen SpectralScheme-equivalent flow.
  * `raytrace_rsw_restart` — the ray_trace_sw/raytrace_sw.m workflow:
    wave/vortex-decompose an RSW (u, v, h) state, advect packets with
    the geostrophic part + spatially varying depth H = 1 + eta_g using
    the x-k-a stepper with the wave-action equation
    (step_packet_xka.m:63-91).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp
from .dispersion import Dispersion
from . import rays
from .fields import flow_from_qk, GriddedFlow, _stack_from_psik
from .rsw import wave_vortex_decompose, RSWParams

__all__ = ["FrozenResult", "raytrace_frozen", "raytrace_pv_snapshot",
           "raytrace_rsw_restart", "ring_ics"]


class FrozenResult(NamedTuple):
    x: jnp.ndarray            # (nframes, 2, Np) coordinate-first
    k: jnp.ndarray            # (nframes, 2, Np)
    t: jnp.ndarray            # (nframes,)
    omega: jnp.ndarray        # (nframes, Np) intrinsic frequency
    omega_abs0: jnp.ndarray   # (Np,) initial absolute frequency
    omega_abs: jnp.ndarray    # (nframes, Np)

    @property
    def conservation_error(self):
        """max |dOmega_abs / Omega_abs(0)| per frame — the
        SW_zero_background_raytracing.m:85-132 metric."""
        return jnp.max(jnp.abs((self.omega_abs - self.omega_abs0[None])
                               / self.omega_abs0[None]), axis=-1)


def ring_ics(n_packets: int, w0: float, disp: Dispersion, L=2 * np.pi,
             seed: int = 146):
    """Near-inertial ring ICs: |k| = sqrt((w0^2-1) f^2/Cg^2), equally
    spaced angles, uniform random positions (qgsw_raytrace.m:54-60).
    Returns x0, k0 as (2, Np) coordinate-first arrays."""
    rng = np.random.default_rng(seed)
    i = np.arange(1, n_packets + 1)
    kr = np.sqrt((w0**2 - 1.0) * disp.f**2 / disp.Cg**2)
    k0 = kr * np.stack([np.cos(2 * np.pi * i / n_packets),
                        np.sin(2 * np.pi * i / n_packets)], 0)
    x0 = rng.uniform(0.0, L, (2, n_packets))
    return jax.device_put(x0), jax.device_put(k0)


def raytrace_frozen(flow, x0, k0, disp: Dispersion, dt: float, nsteps: int,
                    save_every: int = 1, stepper: str = "symplectic"
                    ) -> FrozenResult:
    """Integrate packets through a steady flow and collect the
    conservation diagnostics."""
    from ..ops.interp import _WINDOW_MIN_NP
    if (isinstance(flow, GriddedFlow) and flow.win is None
            and x0.shape[-1] >= _WINDOW_MIN_NP):
        # Frozen flow: the window build amortizes over the entire run
        # (one gather index per packet per eval instead of 36).
        flow = flow.windowed()
    step = {
        "symplectic": lambda x, k, t: rays.symplectic_step(
            x, k, dt, disp, flow),
        "yoshida4": lambda x, k, t: rays.yoshida4_step(
            x, k, dt, disp, flow),
        "rk4": lambda x, k, t: rays.rk4_step(x, k, dt, disp, flow),
        "rk23": lambda x, k, t: rays.rk23_step(x, k, dt, disp, flow),
    }[stepper]
    xs, ks, ts = rays.integrate_rays(x0, k0, dt, nsteps, step,
                                     save_every=save_every)
    ev0 = flow.at(x0[0], x0[1])
    om_abs0 = disp.absolute_frequency(k0, ev0.uv)
    om = jax.vmap(disp.omega)(ks)  # coordinate axis is 1 in the frame stack

    def abs_at(x, k):
        ev = flow.at(x[0], x[1])
        return disp.absolute_frequency(k, ev.uv)

    om_abs = jax.vmap(abs_at)(xs, ks)
    return FrozenResult(x=xs, k=ks, t=ts, omega=om, omega_abs0=om_abs0,
                        omega_abs=om_abs)


def raytrace_pv_snapshot(pv_path, frame: int, nx: int, Kd2: float,
                         disp: Dispersion, n_packets: int = 50,
                         w0: float = 2.0, dt: float = 1e-3,
                         nsteps: int = 1000, save_every: int = 10,
                         stepper: str = "symplectic", L=2 * np.pi,
                         seed: int = 146) -> FrozenResult:
    """Frozen-PV-frame raytracing (SW_zero_background_raytracing.m):
    read PV grid frame from a .bin, invert, trace rays."""
    from ..io import binio

    q = binio.read_field(pv_path, nx, nx, frames=frame)
    grid = SpectralGrid.square(nx, L)
    flow = GriddedFlow(fields=jax.jit(
        lambda g: flow_from_qk(sp.to_spectral(g, grid), grid, Kd2).fields
    )(jnp.asarray(q)), grid=grid)
    x0, k0 = ring_ics(n_packets, w0, disp, L, seed)
    return raytrace_frozen(flow, x0, k0, disp, dt, nsteps, save_every,
                           stepper)


def raytrace_rsw_restart(u, v, h, disp: Dispersion, grid: SpectralGrid,
                         x0, k0, a0=None, dt: float = 1e-3,
                         nsteps: int = 1000, save_every: int = 10):
    """raytrace_sw.m workflow: wave/vortex-decompose (u, v, h), advect
    packets through the geostrophic flow with depth refraction and the
    wave-action equation (step_packet_xka semantics).

    Returns (x, k, a, t) frame stacks.
    """
    p = RSWParams(f=disp.f, Cg=disp.Cg)

    @jax.jit
    def build(u_, v_, h_):
        (ug, vg, hg), _ = wave_vortex_decompose(u_, v_, h_, grid, p)
        # geostrophic velocity-gradient grids from the decomposed flow
        Sk = sp.to_spectral(jnp.stack([ug, vg]), grid)
        fields = jnp.concatenate([
            jnp.stack([ug, vg]),
            sp.to_grid(jnp.stack([sp.ddx(Sk[0], grid),
                                  sp.ddy(Sk[0], grid),
                                  sp.ddx(Sk[1], grid),
                                  sp.ddy(Sk[1], grid)]), grid)])
        return fields, 1.0 + hg

    fields, H = build(jnp.asarray(u), jnp.asarray(v), jnp.asarray(h))
    flow = GriddedFlow(fields=fields, grid=grid)
    a0 = jnp.ones(x0.shape[-1]) if a0 is None else jnp.asarray(a0)

    nframes = nsteps // save_every

    def frame(carry, _):
        def body(i, xka):
            x, k, a = xka
            return rays.rk4_xka_step(x, k, a, dt, disp, flow, H=H)

        x, k, a = lax.fori_loop(0, save_every, body, carry)
        return (x, k, a), (x, k, a)

    (_, _, _), (xs, ks, as_) = lax.scan(frame, (x0, k0, a0), None,
                                        length=nframes)
    ts = dt * save_every * (1 + jnp.arange(nframes))
    return xs, ks, as_, ts
