"""Fixed-substep accuracy vs adaptive ode23 for the TWO-LAYER headline
configuration (512^2, qg2layersw_raytrace.m:184-197 sub-cycles packets
the same way as the one-layer driver) — the VERDICT r2 stretch item:
substep_study.py covered one-layer 256^2; this adds the production
two-layer 512^2 rows quoted in models/coupled.py lockstep_step.

Run on CPU x64: python benchmarks/substep_study2.py
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import functools

import numpy as np
import jax.numpy as jnp

from swraytracing.models.coupled2 import (Coupled2Config,
                                              setup_coupled2,
                                              coupled2_flow_packet_step)
from swraytracing.models.fields import BlendedFlow
from swraytracing.models.qg2 import qg2_step, top_layer_flow
from swraytracing.models import rays

NX = 512
NP = 512


def study(w0, dt_scale=1.0):
    cfg = Coupled2Config(nx=NX, n_packets=NP, near_inertial_factor=w0,
                         T_Fr_days=6000.0, packet_delay_days=0.0)
    s, carry = setup_coupled2(cfg)
    for _ in range(3):
        carry = jax.jit(functools.partial(
            coupled2_flow_packet_step, s=s, cfg=cfg))(carry)
    st2 = jax.jit(lambda st: qg2_step(st, s.grid, s.ops, s.params))(
        carry.flow_state)
    F2 = jax.jit(lambda q: top_layer_flow(
        q, s.grid, s.ops, s.params, cfg.one_layer_quirk).fields)(st2.qk)
    flow = BlendedFlow(fields1=carry.prev_fields, fields2=F2, grid=s.grid)
    dt = s.dt * dt_scale
    x0, k0 = carry.packet_x, carry.packet_k
    omega = np.sqrt(cfg.f**2 + cfg.Cg**2 * float(jnp.sum(k0[:, 0]**2)))
    print(f"\ntwo-layer {NX}^2  w0={w0}  dt={dt:.5f}  "
          f"omega*dt={omega*dt:.4f}  Np={NP}")

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

    rows = {}
    for m in (1, 2, 4, 8):
        def run_rk23(x, k):
            def body(i, xk):
                a0 = i / m
                return rays.rk23_step(xk[0], xk[1], dt / m, s.disp, flow,
                                      alpha0=a0, dalpha=1.0 / m)
            return jax.lax.fori_loop(0, m, body, (x, k))

        def run_sym(x, k):
            def body(i, xk):
                return rays.symplectic_step(xk[0], xk[1], dt / m, s.disp,
                                            flow, alpha=(i + 0.5) / m)
            return jax.lax.fori_loop(0, m, body, (x, k))

        xa, ka = jax.jit(run_rk23)(x0, k0)
        rows[("rk23", m)] = err(xa, ka)
        xa, ka = jax.jit(run_sym)(x0, k0)
        rows[("sympl", m)] = err(xa, ka)

    print(f"  {'n_substeps':>10s} " + "".join(f"{m:>11d}"
                                              for m in (1, 2, 4, 8)))
    for name in ("rk23", "sympl"):
        print(f"  {name:>10s} " + "".join(
            f"{rows[(name, m)]:11.3e}" for m in (1, 2, 4, 8)))
    return e_ref, rows


for w0 in (2.0, 16.0):
    study(w0)
