"""Rays/s scaling measurement across device meshes.

The build target (BASELINE.json north star) asks for rays/s measured at
1 chip, 1 host, and N hosts with >= 85% scaling efficiency at 4 hosts.
The reference has no analogue (its only parallelism is a SLURM job
array, runqgsw_raytrace.sbatch:10). This harness times the coupled
flow+packet step over meshes built from device prefixes (1, 2, ..., N
devices), packets sharded on the mesh's packet axis and the flow
replicated, and reports throughput + efficiency vs the single-device
run. It works identically on a virtual CPU mesh
(xla_force_host_platform_device_count), one real chip, or a pod slice —
`jax.jit` + GSPMD insert the collectives; nothing here is
backend-specific. Every timed call ends in jax.block_until_ready.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import jax

from . import sharding as shd

__all__ = ["ScalingPoint", "measure_packet_scaling"]


class ScalingPoint(NamedTuple):
    n_devices: int
    packets: int
    seconds_per_step: float
    packet_steps_per_sec: float
    efficiency: float  # vs the 1-device point (weak- or strong-scaling)


def _time_steps(run, carry, iters: int) -> float:
    # TWO warmup calls: the first compiles the initial-carry structure
    # (prev_win=None), the second the steady-state structure every
    # later call reuses — timing after one warmup clocks a recompile
    # inside the window.
    carry2, _ = jax.block_until_ready(run(carry))
    carry2, _ = jax.block_until_ready(run(carry2))
    t0 = time.perf_counter()
    for _ in range(iters):
        carry2, _ = jax.block_until_ready(run(carry2))
    return (time.perf_counter() - t0) / iters


def measure_packet_scaling(setup_fn, run_fn, base_packets: int,
                           device_counts: Sequence[int] | None = None,
                           weak: bool = True, iters: int = 2,
                           steps_per_call: int = 1
                           ) -> list[ScalingPoint]:
    """Measure packet-steps/s over increasing device counts.

    Args:
      setup_fn: n_packets -> (setup, carry) — e.g.
        `lambda np_: setup_coupled(cfg._replace(n_packets=np_))`.
      run_fn: (setup,) -> jitted carry -> (carry, aux) one-chunk runner.
      base_packets: packets per device (weak scaling) or total packets
        (strong scaling).
      device_counts: prefixes of jax.devices() to use; default
        (1, 2, ..., len(devices)) powers of two.
      weak: True = fixed packets PER DEVICE (the production regime: more
        hosts -> more rays); False = fixed TOTAL packets.
      steps_per_call: flow steps one run_fn call advances (its
        n_saves * packet_steps_per_save) — rates are per flow STEP, so
        a multi-step call must declare its step count.
    """
    devs = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32)
                         if d <= len(devs)]
    points = []
    base_rate = None
    for nd in device_counts:
        np_total = base_packets * nd if weak else base_packets
        s, carry = setup_fn(np_total)
        mesh = shd.make_mesh(devs[:nd], ensemble=1)
        carry = carry.replace(
            packet_x=shd.shard_packets(mesh, carry.packet_x),
            packet_k=shd.shard_packets(mesh, carry.packet_k),
            prev_fields=jax.device_put(carry.prev_fields,
                                       shd.replicated(mesh)))
        run = run_fn(s)
        sec = _time_steps(run, carry, iters) / steps_per_call
        rate = np_total / sec
        if base_rate is None:
            # per-device rate at the first point; ideal total rate at nd
            # devices is base_rate * nd for both weak and strong scaling
            base_rate = rate / nd
        eff = rate / (base_rate * nd)
        points.append(ScalingPoint(n_devices=nd, packets=np_total,
                                   seconds_per_step=sec,
                                   packet_steps_per_sec=rate,
                                   efficiency=eff))
    return points
