"""Headline benchmark: coupled QG flow + wave-packet raytracing throughput.

Metric: packet-steps/sec/chip — one packet advanced through one coupled
flow step counts as one packet-step. The MATLAB reference sustains
~40-45 flow steps/s with 50 packets at 256^2 on a 6-CPU node
(BASELINE.md), i.e. ~2.1e3 packet-steps/s. The BASELINE.json north star
(config 5) is 1e6 packets on a 512^2 TWO-LAYER flow at >= 10x that; the
default run here is exactly that configuration. BENCH_MODEL=qg1 selects
the one-layer (qgsw_raytrace.m) configuration instead.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"} — the device as JAX reports it (platform, kind, count).
"""

import json
import os
import time

NX = int(os.environ.get("BENCH_NX", "512"))
NP = int(os.environ.get("BENCH_NP", str(1_048_576)))
N_SAVES = int(os.environ.get("BENCH_SAVES", "2"))
MODEL = os.environ.get("BENCH_MODEL", "qg2")
# Packet sub-stepper: rk23 (default; mirrors the reference's ode23
# sub-cycling) | rk4 | symplectic (1 flow eval per substep instead of
# rk23's 3; 2nd order, exactly conservative in steady flow; the
# reference's own ode_symplectic.m).
STEPPER = os.environ.get("BENCH_STEPPER", "rk23")
# Flow steps per jitted call (one lax.scan chunk).
STEPS_PER_CALL = int(os.environ.get("BENCH_STEPS_PER_CALL", "20"))
# Packet substeps per flow step. Default 2, validated against the
# adaptive-ode23 oracle (models/coupled.py lockstep_step docstring: err
# 3.1-3.9e-10 at the headline config, ~2600x inside the reference's 1e-6
# envelope). BENCH_SUBSTEPS=4 restores the wider-margin config.
N_SUBSTEPS = int(os.environ.get("BENCH_SUBSTEPS", "2"))
BASELINE_PACKET_STEPS_PER_SEC = 2.1e3  # MATLAB reference, BASELINE.md


def main():
    import functools

    import jax

    from swraytracing.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if MODEL == "qg2":
        from swraytracing.models.coupled2 import (
            Coupled2Config as Config, setup_coupled2 as setup,
            run_coupled2_chunk as run_chunk)
    else:
        from swraytracing.models.coupled import (
            CoupledConfig as Config, setup_coupled as setup,
            run_coupled_chunk as run_chunk)
    cfg = Config(nx=NX, n_packets=NP, T_Fr_days=6000.0,
                 packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0,
                 packet_steps_per_save=STEPS_PER_CALL, stepper=STEPPER,
                 n_substeps=N_SUBSTEPS)
    s, carry = setup(cfg)

    run = jax.jit(functools.partial(run_chunk, s=s, cfg=cfg, n_saves=1))

    # Warm-up: TWO calls. The first compiles the initial-carry structure
    # (prev_win=None) and returns a carry whose window slot is populated;
    # the second compiles the steady-state structure that every
    # subsequent call reuses.
    for _ in range(2):
        carry, hist = jax.block_until_ready(run(carry))

    t0 = time.perf_counter()
    for _ in range(N_SAVES):
        carry, hist = run(carry)
    jax.block_until_ready((carry, hist))
    elapsed = time.perf_counter() - t0

    flow_steps = N_SAVES * cfg.packet_steps_per_save
    packet_steps_per_sec = flow_steps * cfg.n_packets / elapsed
    devs = jax.devices()
    print(json.dumps({
        "metric": (f"packet-steps/sec/chip ({NP:.0e} packets, {NX}^2 "
                   f"{'two-layer' if MODEL == 'qg2' else 'one-layer'} QG)"),
        "value": round(packet_steps_per_sec, 1),
        "unit": "packet-steps/s",
        "vs_baseline": round(
            packet_steps_per_sec / BASELINE_PACKET_STEPS_PER_SEC, 2),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }))


if __name__ == "__main__":
    main()
