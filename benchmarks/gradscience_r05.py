"""GRAD_r05 (round-4 verdict weak #2 / item 5): validate the RUN-SCALE
accelerator f32 gradient against a MATCHED-CONFIG f64 AD oracle — same nx,
steps, substeps, march engagement, and time step; only the packet count
is what CPU f64 can carry (2^14, which still engages the fused-march
path via window_min_np).

GRAD_r04's device_f32 row was validated only against f32 finite
differences at fd_eps=1e-2 — at f32 through a 1250-step chain the FD
noise is the same order as the reported 2.3% error, so it bounded
nothing tightly; the f64 oracle there ran at a different config (128^2,
250 steps, no march). Here every leg computes THE SAME loss
L(a) = var(omega_final) for qk0 -> a*qk0 at 256^2, 1250 coupled steps,
n_substeps=2, fused march engaged, with dt PINNED to the f64 setup
value so the three legs differentiate the same trajectory map:

  cpu64 — f64 AD + f64 central FD (the oracle; FD confirms the AD)
  cpu32 — f32 AD with identical (XLA-reference) march arithmetic:
          isolates PRECISION from backend/kernel differences
  device — f32 AD through the kernel forward / XLA-ref backward

The f32 budget: ad_f32_cpu_vs_f64 is pure rounding accumulated by the
chain; ad_device_vs_cpu_f32 adds kernel-vs-XLA arithmetic (fusion/FMA
order); ad_device_vs_f64 is the headline bound. Run legs as
  python benchmarks/gradscience_r05.py cpu64|cpu32|device
(rows merge into GRAD_r05.json; derived deltas update on each run).

Reference: SURVEY §7 hard part #1 (f32-vs-f64 drift budget);
qgsw_raytrace.m has no adjoint — this surface exists only here.
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))
import json
import time

import numpy as np

MODE = _sys.argv[1] if len(_sys.argv) > 1 else "device"

import jax  # noqa: E402

if MODE.startswith("cpu"):
    jax.config.update("jax_platforms", "cpu")
if MODE == "cpu64":
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from swraytracing.models.coupled import (CoupledConfig, setup_coupled,  # noqa: E402
                                             run_coupled_chunk)

NX = 256
NP = 2**14
N_SAVES = 250          # x packet_steps_per_save=5 -> 1250 coupled steps
# dt from the f64 setup (computed once on CPU x64 and pinned here so
# every leg integrates the same map; value printed by the cpu64 leg) —
# f32 setups reproduce it to ~1e-7 relative, but pinning removes even
# that leg-to-leg trajectory difference.
DT_PIN_FILE = _pl.Path(__file__).with_suffix(".dtpin")


def build():
    cfg = CoupledConfig(nx=NX, n_packets=NP, T_Fr_days=6000.0,
                        packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0,
                        window_min_np=2**13)
    s, carry0 = setup_coupled(cfg)
    assert s.march is not None, "march must be engaged for the matched config"
    if MODE == "cpu64":
        DT_PIN_FILE.write_text(repr(float(s.dt)))
    dt = float(DT_PIN_FILE.read_text()) if DT_PIN_FILE.exists() \
        else float(s.dt)
    s = s._replace(dt=dt)
    return cfg, s, carry0


def main():
    cfg, s, carry0 = build()
    qk0 = carry0.flow_state.qk

    @jax.jit
    def loss(a, c0):
        c = c0.replace(flow_state=c0.flow_state.replace(
            qk=a.astype(qk0.real.dtype) * c0.flow_state.qk))
        c2, _ = run_coupled_chunk(c, s, cfg, N_SAVES, remat=True)
        om = jnp.sqrt(cfg.f**2 + cfg.Cg**2
                      * (c2.packet_k[0]**2 + c2.packet_k[1]**2))
        return jnp.var(om)

    one = jnp.asarray(1.0)
    L0 = float(loss(one, carry0))
    t0 = time.perf_counter()
    L0 = float(loss(one, carry0))
    fwd_s = time.perf_counter() - t0

    g_fn = jax.jit(jax.grad(loss))
    g = float(g_fn(one, carry0))
    t0 = time.perf_counter()
    g = float(g_fn(one, carry0))
    grad_s = time.perf_counter() - t0

    row = dict(nx=NX, n_packets=NP, coupled_steps=N_SAVES * 5,
               n_substeps=cfg.n_substeps, dt=float(s.dt),
               march_engaged=True, loss_std_omega=float(np.sqrt(L0)),
               dloss_da_ad=g, forward_s=round(fwd_s, 4),
               fwd_plus_bwd_s=round(grad_s, 4))
    if MODE == "cpu64":
        eps = 1e-5
        fd = (float(loss(one + eps, carry0))
              - float(loss(one - eps, carry0))) / (2 * eps)
        row.update(dloss_da_fd=fd, fd_eps=eps,
                   ad_vs_fd_rel=abs(g - fd) / max(abs(fd), 1e-30))

    out = _pl.Path(__file__).resolve().parents[1] / "GRAD_r05.json"
    data = json.loads(out.read_text()) if out.exists() else {}
    data[MODE] = row
    if "cpu64" in data:
        g64 = data["cpu64"]["dloss_da_ad"]
        for leg in ("cpu32", "device"):
            if leg in data:
                data[f"ad_{leg}_vs_f64_rel"] = abs(
                    data[leg]["dloss_da_ad"] - g64) / abs(g64)
    if "cpu32" in data and "device" in data:
        data["ad_device_vs_cpu32_rel"] = abs(
            data["device"]["dloss_da_ad"] - data["cpu32"]["dloss_da_ad"]) \
            / abs(data["cpu32"]["dloss_da_ad"])
    out.write_text(json.dumps(data, indent=1))
    print(MODE, json.dumps(row, indent=1))
    print("wrote", out)


if __name__ == "__main__":
    main()
