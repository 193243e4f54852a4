"""Differentiable science at RUN scale (VERDICT r3 item 4): jax.grad of
a physical objective — the final frequency-spread std(omega)^2 of the
packet ensemble, the quantity whose growth IS the reference's scattering
result — w.r.t. the background-flow amplitude, through a MULTI-CHUNK
rematerialized coupled run (>=1e3 lock-step iterations at 256^2, fused
march engaged). The reference (MATLAB, no autodiff) cannot touch this:
it answers "how sensitive is the scattering to U_g?" with 20 more SLURM
runs; here it is one backward sweep.

The scalar parameter `a` scales the initial PV spectrum (qk0 -> a*qk0),
which is exactly a U_g relabeling (initial_q_ring normalizes amplitude
linearly), so dL/da is the U_g-sensitivity of the spread.

Validation: central finite differences on the SAME compiled loss.
  * accelerator f32, production-ish scale (2^16 packets, 1250 steps): few-%%
    agreement expected (f32 roundoff through 1e3 chaotic-ish steps).
  * CPU f64, reduced scale: tight agreement (~1e-6).
Writes GRAD_r04.json.
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))
import functools
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from swraytracing.models.coupled import (CoupledConfig, setup_coupled,
                                             run_coupled_chunk)

results = {}


def study(tag, nx, n_packets, n_saves, fd_eps):
    cfg = CoupledConfig(nx=nx, n_packets=n_packets, T_Fr_days=6000.0,
                        packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0)
    s, carry0 = setup_coupled(cfg)
    qk0 = carry0.flow_state.qk
    n_steps = n_saves * cfg.packet_steps_per_save

    # carry passed as an ARGUMENT, not closed over: a closed-over device
    # array would be embedded in the program as a constant
    @jax.jit
    def loss(a, c0):
        c = c0.replace(flow_state=c0.flow_state.replace(
            qk=a.astype(qk0.real.dtype) * c0.flow_state.qk))
        c2, _ = run_coupled_chunk(c, s, cfg, n_saves, remat=True)
        om = jnp.sqrt(cfg.f**2 + cfg.Cg**2
                      * (c2.packet_k[0]**2 + c2.packet_k[1]**2))
        return jnp.var(om)

    one = jnp.asarray(1.0)
    L0 = float(loss(one, carry0))              # compile + value
    t0 = time.perf_counter()
    L0 = float(loss(one, carry0))
    fwd_s = time.perf_counter() - t0

    g_fn = jax.jit(jax.grad(loss))
    g = float(g_fn(one, carry0))               # compile
    t0 = time.perf_counter()
    g = float(g_fn(one, carry0))
    grad_s = time.perf_counter() - t0

    fd = (float(loss(one + fd_eps, carry0))
          - float(loss(one - fd_eps, carry0))) / (2.0 * fd_eps)
    rel = abs(g - fd) / max(abs(fd), 1e-30)
    row = dict(nx=nx, n_packets=n_packets, coupled_steps=n_steps,
               march_engaged=s.march is not None,
               loss_std_omega=float(np.sqrt(L0)), dloss_da_ad=g,
               dloss_da_fd=fd, fd_eps=fd_eps, rel_err=rel,
               forward_s=round(fwd_s, 4), fwd_plus_bwd_s=round(grad_s, 4))
    try:
        ms = jax.devices()[0].memory_stats()
        if ms:
            row["peak_bytes_in_use"] = int(ms.get("peak_bytes_in_use", 0))
    except Exception:
        pass
    results[tag] = row
    print(tag, json.dumps(row, indent=1), flush=True)


if __name__ == "__main__":
    mode = _sys.argv[1] if len(_sys.argv) > 1 else "device"
    if mode == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        # march engaged via explicit window_min_np would need packets
        # >= threshold; keep the validation on the default path but
        # >=250 steps so the remat chain is exercised
        study("cpu_f64", nx=128, n_packets=4096, n_saves=50,
              fd_eps=1e-5)
    else:
        study("device_f32", nx=256, n_packets=2**16, n_saves=250,
              fd_eps=1e-2)
    out = _pl.Path(__file__).resolve().parents[1] / "GRAD_r04.json"
    old = json.loads(out.read_text()) if out.exists() else {}
    old.update(results)
    out.write_text(json.dumps(old, indent=1))
    print("wrote", out)
