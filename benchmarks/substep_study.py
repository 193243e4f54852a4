"""Fixed-substep accuracy vs the reference's adaptive ode23 (SURVEY hard
part #4): over ONE production flow step, integrate the packet ensemble
with n_substeps in {1,2,4,8,16} of fixed rk23/rk4/symplectic and compare
against (a) adaptive ode23 at the reference tolerances rtol=1e-6,
atol=1e-7 (SW_zero_background_raytracing.m:71-79) and (b) a tight
rtol=1e-10 run used as truth.

Run on CPU x64 (python benchmarks/substep_study.py); prints the table
quoted in models/coupled.py lockstep_step's docstring.
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import functools

import numpy as np
import jax.numpy as jnp

from swraytracing.models.coupled import (CoupledConfig, setup_coupled,
                                             coupled_flow_packet_step)
from swraytracing.models.fields import BlendedFlow, flow_from_qk
from swraytracing.models.qg import qg_step
from swraytracing.models import rays

NX = 256
NP = 512


def study(w0, dt_scale=1.0):
    cfg = CoupledConfig(nx=NX, n_packets=NP, near_inertial_factor=w0,
                        T_Fr_days=6000.0, packet_delay_days=0.0)
    s, carry = setup_coupled(cfg)
    # advance the flow a few steps so the blend endpoints differ
    for _ in range(3):
        carry = jax.jit(functools.partial(
            coupled_flow_packet_step, s=s, cfg=cfg))(carry)
    st2 = jax.jit(lambda st: qg_step(st, s.grid, s.qg_params))(
        carry.flow_state)
    F2 = jax.jit(lambda q: flow_from_qk(q, s.grid, s.qg_params.Kd2).fields)(
        st2.qk)
    flow = BlendedFlow(fields1=carry.prev_fields, fields2=F2, grid=s.grid)
    dt = s.dt * dt_scale
    x0, k0 = carry.packet_x, carry.packet_k
    omega = np.sqrt(cfg.f**2 + cfg.Cg**2
                    * float(jnp.sum(k0[:, 0]**2)))
    print(f"\nw0={w0}  dt={dt:.5f}  omega*dt={omega*dt:.4f}  Np={NP}")

    xt, kt, tt, na, nt = jax.jit(lambda x, k: rays.rk23_adaptive(
        x, k, dt, s.disp, flow, rtol=1e-10, atol=1e-12))(x0, k0)
    xr, kr, tr, na6, nt6 = jax.jit(lambda x, k: rays.rk23_adaptive(
        x, k, dt, s.disp, flow, rtol=1e-6, atol=1e-7))(x0, k0)

    assert float(tt) == dt and float(tr) == dt, 'truncated oracle'
    scale = float(jnp.max(jnp.abs(kt)))

    def err(xa, ka):
        return max(float(jnp.max(jnp.abs(xa - xt))),
                   float(jnp.max(jnp.abs(ka - kt)))) / scale

    e_ref = err(xr, kr)
    print(f"  adaptive ode23 @ (1e-6,1e-7): err={e_ref:.3e} "
          f"({int(na6)} acc / {int(nt6)} att steps)  <- reference envelope")

    steppers = {"rk23": rays.rk23_step, "rk4": rays.rk4_step}
    rows = {}
    for name, step in steppers.items():
        for m in (1, 2, 4, 8, 16):
            def run(x, k):
                def body(i, xk):
                    a0 = i / m
                    return step(xk[0], xk[1], dt / m, s.disp, flow,
                                alpha0=a0, dalpha=1.0 / m)
                return jax.lax.fori_loop(0, m, body, (x, k))
            xa, ka = jax.jit(run)(x0, k0)
            rows[(name, m)] = err(xa, ka)
    for m in (1, 2, 4, 8, 16):
        def run(x, k):
            def body(i, xk):
                return rays.symplectic_step(xk[0], xk[1], dt / m, s.disp,
                                            flow, alpha=(i + 0.5) / m)
            return jax.lax.fori_loop(0, m, body, (x, k))
        xa, ka = jax.jit(run)(x0, k0)
        rows[("sympl", m)] = err(xa, ka)

    print(f"  {'n_substeps':>10s} " + "".join(f"{m:>11d}" for m in
                                              (1, 2, 4, 8, 16)))
    for name in ("rk23", "rk4", "sympl"):
        print(f"  {name:>10s} " + "".join(
            f"{rows[(name, m)]:11.3e}" for m in (1, 2, 4, 8, 16)))
    return e_ref, rows


for w0 in (2.0, 16.0):
    study(w0)
# the long-run coupled dt in the committed reference logs is up to 10x
# our CFL-derived dt (dt=0.0242 at Fr~0.10); check that regime too
study(16.0, dt_scale=10.0)
