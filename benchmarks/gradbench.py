"""Backward-pass wall time of one coupled two-layer flow step at 1e6
packets: fused-march path vs the legacy stencil path. A path whose
backward fails to compile or run is recorded as failed. Writes
GRAD_r03.json.
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))
import json
import time
import jax, jax.numpy as jnp

from swraytracing.models.coupled2 import (Coupled2Config, setup_coupled2,
                                              run_coupled2_chunk)
from swraytracing.ops import interp

cfg = Coupled2Config(nx=512, n_packets=1_000_000, T_Fr_days=6000.0,
                     packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0,
                     packet_steps_per_save=1)
results = {"nx": 512, "n_packets": 1_000_000, "stepper": cfg.stepper,
           "n_substeps": cfg.n_substeps}


def timed(name, fn, *a, n=2):
    try:
        r = fn(*a)          # compile + warmup; fn returns a SCALAR
        float(r)
    except Exception as e:
        msg = f"{type(e).__name__}: {str(e)[:200]}"
        print(f"{name:40s} FAILED {msg}", flush=True)
        results[name] = {"failed": msg}
        return
    t0 = time.perf_counter()
    for _ in range(n):
        float(fn(*a))
    dt = (time.perf_counter() - t0) / n
    results[name] = round(dt, 5)
    print(f"{name:40s} {dt*1e3:9.1f} ms", flush=True)


for name, fused, minnp in [("fused-march", True, 65536),
                           ("stencil (legacy)", False, 1 << 62)]:
    c = cfg._replace(fused_march=fused, window_min_np=minnp)
    s, carry = setup_coupled2(c)

    def loss(pk0, carry, s=s, c=c):
        cc = carry.replace(packet_k=pk0)
        cc, _ = run_coupled2_chunk(cc, s, c, 1)
        return jnp.sum(cc.packet_k ** 2) * 1e-6

    fwd = jax.jit(loss)
    timed(f"forward 1 flow step ({name})", fwd, carry.packet_k, carry)
    g = jax.jit(lambda pk, cc, l=loss: jnp.sum(jax.grad(l)(pk, cc) ** 2))
    timed(f"fwd+bwd 1 flow step ({name})", g, carry.packet_k, carry)

out = _pl.Path(__file__).resolve().parents[1] / "GRAD_r03.json"
out.write_text(json.dumps(results, indent=2) + "\n")
print(f"wrote {out}")
