#!/usr/bin/env python3
"""On-card proof that the coupled QG + wave-packet main path runs on an
NVIDIA GPU, through the entry points a user calls, at the sizes users
run.

    python chip_smoke.py            # phases 0-4 on one GPU
    python chip_smoke.py --multi    # phase 0 + phase 5 on four GPUs

Phases (one process; JAX reserves most of a card's memory per process):

  0  device: JAX must find a GPU, else exit nonzero with no result line
  1  packet-march kernel vs its plain XLA twin at the headline widths
     (512^2 two-layer QG, 2^20 packets, uv windows, combined gather) for
     rk23 (n_substeps=2) and symplectic: deviations, overflow equality,
     kernel-alone and whole-lock-step times for both engines
  2  headline path as bench.py runs it (run_coupled2_chunk): finite,
     overflow 0, omega/f spread grows, packet-steps/s, compile seconds,
     peak memory; plus the same run on the CPU backend at 128^2
  3  production driver through the CLI (`qgsw`, 256^2, 2^17 packets),
     then `--resume`: frames, run.log and checkpoints read back
  4  jax.grad of a packet functional w.r.t. the PV spectrum through
     run_coupled2_chunk (512^2, 2^20 packets, 2 flow steps): the custom
     VJP with the kernel forward and with the XLA twin forward, each
     checked against plain autodiff of the twin; times and temp bytes
  5  (--multi) headline chunk sharded over 4 cards vs one card, and a
     4-member ensemble sharded by member vs one device: steady-state
     rates per card, a device trace of the ensemble chunk, and a census
     of the collectives in the compiled sharded programs

Every time is printed next to the card's name and power limit. The last
line of standard output is one JSON object with the device JAX reports;
it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "smoke"
HEADLINE_NX = 512
HEADLINE_NP = 2 ** 20

CARD = "card: unknown"


class PhaseFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def say(phase, msg, timed=False):
    """One output line; lines that carry a time also carry the card."""
    print(f"[phase {phase}] {msg}" + (f"  |  {CARD}" if timed else ""),
          flush=True)


# ---------------------------------------------------------------------------
# Card and device
# ---------------------------------------------------------------------------

def parse_card_line(text: str) -> tuple[str, str]:
    """(name, power limit) from the first line of
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    line = text.strip().splitlines()[0].strip() if text.strip() else ""
    name, sep, limit = line.rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {text!r}")
    return name.strip(), limit.strip()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = parse_card_line(out)
    return f"{name}, {limit}"


def require_gpu():
    """Phase 0: JAX must report a GPU as its first device."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise PhaseFailure(
            f"JAX found no GPU (first device platform {dev.platform!r}); "
            "this script measures the card and never runs on the CPU")
    return dev


def device_summary():
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def peak_bytes() -> int | str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def _sync(x):
    import jax

    return jax.block_until_ready(x)


# ---------------------------------------------------------------------------
# Shared setup
# ---------------------------------------------------------------------------

def headline_config(nx=HEADLINE_NX, n_packets=HEADLINE_NP, steps=20,
                    stepper="rk23", n_substeps=2, **kw):
    """bench.py's configuration: Coupled2Config at the headline size.
    Below the default window threshold (small test sizes) the threshold
    drops to n_packets, so the fused march still engages."""
    from swraytracing.models.coupled2 import Coupled2Config

    kw.setdefault("window_min_np", min(
        Coupled2Config._field_defaults["window_min_np"], n_packets))
    return Coupled2Config(nx=nx, n_packets=n_packets, T_Fr_days=6000.0,
                          packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0,
                          packet_steps_per_save=steps, stepper=stepper,
                          n_substeps=n_substeps, **kw)


def march_inputs(fields1, fields2, x, k, spec):
    """Gathered windows + packet state exactly as lockstep_step feeds the
    march: (pw1, pw2, xk, oi, oj)."""
    import jax.numpy as jnp
    from swraytracing.ops import pallas_window as pwin

    w1 = pwin.build_gather_windows(fields1, spec)
    w2 = pwin.build_gather_windows(fields2, spec)
    oi, oj = pwin.packet_cells(x[0], x[1], spec)
    xk = jnp.concatenate([x, k], axis=0)
    if spec.combined_gather:
        pwc = pwin.gather_packet_windows(
            jnp.concatenate([w1, w2], axis=-1), oi, oj, spec)
        return pwc, jnp.zeros((1, 1), pwc.dtype), xk, oi, oj
    return (pwin.gather_packet_windows(w1, oi, oj, spec),
            pwin.gather_packet_windows(w2, oi, oj, spec), xk, oi, oj)


def row_deviation(got, want):
    """Per row (x, y, kx, ky): max |got - want| and the row's max |want|."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return [(float(np.abs(g - w).max()), float(np.abs(w).max()))
            for g, w in zip(got, want)]


def omega_spread(pk, f, Cg):
    """Standard deviation of omega/f over the packets."""
    import jax.numpy as jnp

    om = jnp.sqrt(f ** 2 + Cg ** 2 * (pk[0] ** 2 + pk[1] ** 2)) / f
    return float(jnp.std(om))


def timed_chunks(run, carry, n):
    """Run n chunks back to back, then block; returns (seconds, carry,
    last history)."""
    t0 = time.perf_counter()
    hist = None
    for _ in range(n):
        carry, hist = run(carry)
    _sync((carry, hist))
    return time.perf_counter() - t0, carry, hist


def compiled_chunk(run, carry):
    """Compile `run` for the carry's structure; returns (compiled,
    seconds)."""
    t0 = time.perf_counter()
    comp = run.lower(carry).compile()
    return comp, time.perf_counter() - t0


def print_trace_summary(phase, trace_dir, what, top=12):
    """Per device line of a profiler trace: busy time, window, idle
    share and the heaviest operations (utils.profiling)."""
    from swraytracing.utils.profiling import device_trace_summary

    for ln in device_trace_summary(trace_dir, top=top):
        idle = 1.0 - ln["busy_ns"] / max(ln["window_ns"], 1.0)
        say(phase, f"trace {what}: {ln['plane']} / {ln['line']}: "
                   f"{ln['events']} events, busy {ln['busy_ns'] / 1e6:.3f}"
                   f" ms of {ln['window_ns'] / 1e6:.3f} ms (idle "
                   f"{idle:.1%})", timed=True)
        for name, ns in ln["top"]:
            say(phase, f"    {ns / 1e6:10.3f} ms  {name[:110]}")


# ---------------------------------------------------------------------------
# Phase 1: march kernel vs XLA twin
# ---------------------------------------------------------------------------

# Kernel and twin evaluate the same products; they differ only in FMA
# contraction and summation order, i.e. a few roundings per stage. Over
# one flow step (3 stages x 2 substeps for rk23) that stays far below 32
# f32 ulps of each row's largest magnitude (|x| ~ L = 20, |k| ~ 5).
MARCH_TOL_ULPS = 32


def phase_march(nx=HEADLINE_NX, n_packets=HEADLINE_NP,
                steppers=(("rk23", 2), ("symplectic", 2)),
                lockstep_engines=("pallas", "xla"), steps=10, iters=5,
                interpret=False, trace_dir=None):
    import jax
    import numpy as np
    from swraytracing.models.coupled2 import (setup_coupled2,
                                              run_coupled2_chunk)
    from swraytracing.models.qg2 import qg2_step, top_layer_flow
    from swraytracing.ops import pallas_window as pwin

    results = {}
    for stepper, nsub in steppers:
        cfg = headline_config(nx, n_packets, steps=steps, stepper=stepper,
                              n_substeps=nsub)
        s, carry = setup_coupled2(cfg)
        check(s.march is not None, "fused march did not engage")
        spec = s.march
        st1 = jax.jit(lambda st: qg2_step(st, s.grid, s.ops, s.params))(
            carry.flow_state)
        fields2 = jax.jit(lambda q: top_layer_flow(
            q, s.grid, s.ops, s.params, cfg.one_layer_quirk,
            n_fields=spec.nf).fields)(st1.qk)
        inputs = jax.jit(functools.partial(march_inputs, spec=spec))(
            carry.prev_fields, fields2, carry.packet_x, carry.packet_k)
        dt = s.dt / nsub
        kern = jax.jit(lambda *a: pwin.march_pallas(
            *a, dt, spec, interpret=interpret))
        twin = jax.jit(lambda *a: pwin.march_reference(*a, dt, spec))
        times = {}
        outs = {}
        for name, fn in (("kernel", kern), ("xla", twin)):
            outs[name] = _sync(fn(*inputs))           # compile + warm
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*inputs)
            _sync(out)
            times[name] = (time.perf_counter() - t0) / iters
        (xk_k, ov_k), (xk_x, ov_x) = outs["kernel"], outs["xla"]
        eps = float(np.finfo(np.asarray(xk_x).dtype).eps)
        devs = row_deviation(xk_k, xk_x)
        tag = f"{stepper} n_substeps={nsub} {nx}^2 Np={n_packets}"
        for name, (d, scale) in zip(("x", "y", "kx", "ky"), devs):
            tol = MARCH_TOL_ULPS * eps * scale
            say(1, f"{tag}: max|kernel-xla| {name} = {d:.3e} "
                   f"(tol {tol:.3e} = {MARCH_TOL_ULPS} ulp x "
                   f"max|{name}| {scale:.3e})")
            check(d <= tol, f"{tag}: {name} deviation {d} > {tol}")
            check(np.isfinite(d), f"{tag}: non-finite {name}")
        check(np.array_equal(np.asarray(ov_k), np.asarray(ov_x)),
              f"{tag}: overflow outputs differ")
        say(1, f"{tag}: overflow equal (max {int(np.max(ov_x))})")
        say(1, f"{tag}: march alone: kernel {times['kernel'] * 1e3:.3f} ms,"
               f" xla {times['xla'] * 1e3:.3f} ms", timed=True)

        step_ms = {}
        for engine in lockstep_engines:
            s_e = s._replace(march=spec._replace(engine=engine))
            run = jax.jit(functools.partial(run_coupled2_chunk, s=s_e,
                                            cfg=cfg, n_saves=1))
            c, _ = run(carry)                         # initial structure
            c, _ = _sync(run(c))                      # steady structure
            el, c, _ = timed_chunks(run, c, iters)
            step_ms[engine] = el / (iters * steps) * 1e3
            check(int(c.overflow) == 0, f"{tag}/{engine}: overflow")
            say(1, f"{tag}: whole lock-step, {engine} march: "
                   f"{step_ms[engine]:.3f} ms/step "
                   f"({n_packets / step_ms[engine] * 1e3:.4e} "
                   "packet-steps/s)", timed=True)
            if trace_dir is not None and stepper == "rk23":
                d = Path(trace_dir) / f"{stepper}_{engine}"
                with jax.profiler.trace(str(d)):
                    _, c, _ = timed_chunks(run, c, 1)
                print_trace_summary(1, d, f"{tag}, {steps}-step chunk, "
                                          f"{engine} march")
                shutil.rmtree(d)        # raw traces are hundreds of MB
        results[stepper] = {"kernel_ms": times["kernel"] * 1e3,
                            "xla_ms": times["xla"] * 1e3,
                            "step_ms": step_ms, "devs": devs}
    return results


# ---------------------------------------------------------------------------
# Phase 2: headline path
# ---------------------------------------------------------------------------

# GPU vs CPU at 128^2: cuFFT and the CPU FFT round differently, and the
# march sums in another order; ten smooth-flow steps keep the packet
# states within 1e-4 of each row's largest magnitude (~840 f32 ulps).
CPU_CMP_REL_TOL = 1e-4


def phase_headline(nx=HEADLINE_NX, n_packets=HEADLINE_NP, steps=20,
                   chunks=2, cmp_nx=128, cmp_packets=2 ** 14,
                   cmp_steps=10):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from swraytracing.models.coupled2 import (setup_coupled2,
                                              run_coupled2_chunk)

    cfg = headline_config(nx, n_packets, steps=steps)
    s, carry = setup_coupled2(cfg)
    check(s.march is not None, "fused march did not engage")
    spread0 = omega_spread(carry.packet_k, cfg.f, cfg.Cg)
    run = jax.jit(functools.partial(run_coupled2_chunk, s=s, cfg=cfg,
                                    n_saves=1))
    comp0, tc0 = compiled_chunk(run, carry)
    carry, _ = _sync(comp0(carry))                    # warm-up 1
    comp1, tc1 = compiled_chunk(run, carry)
    carry, _ = _sync(comp1(carry))                    # warm-up 2
    el, carry, (px, pk, ts) = timed_chunks(comp1, carry, chunks)
    flow_steps = chunks * steps
    rate = flow_steps * n_packets / el
    say(2, f"headline {nx}^2 two-layer, Np={n_packets}, rk23 n=2, engine "
           f"{s.march.engine}: {rate:.6e} packet-steps/s "
           f"({el / flow_steps * 1e3:.3f} ms/flow step over {flow_steps} "
           f"steps), compile {tc0 + tc1:.1f} s, peak_bytes_in_use "
           f"{peak_bytes()}", timed=True)
    finite = all(bool(jnp.isfinite(a).all()) for a in
                 (carry.packet_x, carry.packet_k, carry.flow_state.qk,
                  px, pk, ts))
    check(finite, "non-finite values in the headline run")
    check(int(carry.overflow) == 0, f"overflow {int(carry.overflow)}")
    spread1 = omega_spread(carry.packet_k, cfg.f, cfg.Cg)
    say(2, f"finite: yes; overflow: 0; omega/f spread {spread0:.3e} -> "
           f"{spread1:.3e} after {4 * steps} flow steps")
    check(spread1 > spread0, "omega/f spread did not grow")

    # same physics on the CPU backend at reduced size
    cfg_s = headline_config(cmp_nx, cmp_packets, steps=cmp_steps,
                            window_min_np=cmp_packets)
    res = {}
    for name, dev in (("device", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            s_, c_ = setup_coupled2(cfg_s)
            check(s_.march is not None, "window path not forced")
            c_, (px_, pk_, _) = jax.jit(functools.partial(
                run_coupled2_chunk, s=s_, cfg=cfg_s, n_saves=1))(c_)
            res[name] = (np.concatenate([np.asarray(px_[-1]),
                                         np.asarray(pk_[-1])]),
                         s_.march.engine, c_.packet_x.dtype)
    (a, eng_a, dt_a), (b, eng_b, dt_b) = res["device"], res["cpu"]
    check(dt_a == dt_b, f"dtypes differ: {dt_a} vs {dt_b}")
    for name, (d, scale) in zip(("x", "y", "kx", "ky"),
                                row_deviation(a, b)):
        tol = CPU_CMP_REL_TOL * scale
        say(2, f"{cmp_nx}^2 Np={cmp_packets} {cmp_steps} steps, "
               f"{eng_a} on {jax.devices()[0].platform} vs {eng_b} on cpu "
               f"({dt_a}): max|dev| {name} = {d:.3e} (tol {tol:.3e} = "
               f"{CPU_CMP_REL_TOL:g} x max|{name}|)")
        check(d <= tol, f"device vs cpu {name}: {d} > {tol}")
    return {"rate": rate, "compile_s": tc0 + tc1}


# ---------------------------------------------------------------------------
# Phase 3: production driver through the CLI, then --resume
# ---------------------------------------------------------------------------

def _cli(argv):
    """Run the CLI in-process; returns its captured stdout."""
    from swraytracing.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    | {line}", flush=True)
    check(rc == 0, f"CLI returned {rc}")
    return text


def phase_cli(nx=256, n_packets=2 ** 17, chunks_first=2, chunks_more=2,
              out_dir=OUT_DIR):
    import numpy as np
    from swraytracing.io import binio, checkpoint, runmeta

    run_dir = Path(out_dir) / "qgsw"
    shutil.rmtree(run_dir, ignore_errors=True)
    steps_per_chunk = 50       # CoupledConfig: steps_per_save=50
    saves_per_chunk = 10       # ... / packet_steps_per_save=5
    base = ["qgsw", "--nx", str(nx), "--packets", str(n_packets),
            "--delay-days", "0.01", "--out", str(run_dir),
            "--checkpoint-every", "1"]

    t0 = time.perf_counter()
    _cli(base + ["--max-steps", str(chunks_first * steps_per_chunk)])
    t1 = time.perf_counter()
    n1 = binio.frame_count(str(run_dir / "packet_x"), n_packets, 2)
    pv1 = binio.frame_count(str(run_dir / "pv"), nx, nx)
    check(n1 == 1 + chunks_first * saves_per_chunk,
          f"packet frames {n1}")
    check(pv1 == 1 + chunks_first, f"pv frames {pv1}")
    ck = checkpoint.latest_checkpoint(run_dir)
    check(ck is not None and ck.endswith(f"{chunks_first:012d}.npz"),
          f"checkpoint {ck}")
    say(3, f"qgsw {nx}^2 Np={n_packets}: {chunks_first} chunks in "
           f"{t1 - t0:.1f} s (incl. compile); {n1} packet frames, {pv1} pv "
           f"frames, checkpoint {Path(ck).name}", timed=True)

    ts_saved = binio.read_field(str(run_dir / "packet_time"))
    out = _cli(base + ["--max-steps",
                       str((chunks_first + chunks_more) * steps_per_chunk),
                       "--resume"])
    t2 = time.perf_counter()
    check(f"at chunk {chunks_first}" in out, "resume did not start from "
          f"the saved chunk {chunks_first}")
    n2 = binio.frame_count(str(run_dir / "packet_x"), n_packets, 2)
    pv2 = binio.frame_count(str(run_dir / "pv"), nx, nx)
    total = chunks_first + chunks_more
    check(n2 == 1 + total * saves_per_chunk, f"packet frames {n2}")
    check(pv2 == 1 + total, f"pv frames {pv2}")
    ts = binio.read_field(str(run_dir / "packet_time"))
    check(np.array_equal(ts[:len(ts_saved)], ts_saved),
          "resume rewrote frames before the checkpoint")
    check(bool(np.all(np.diff(ts) > 0)), "packet times not increasing")
    x = binio.read_field(str(run_dir / "packet_x"), n_packets, 2,
                         frames=[1, n2])
    k = binio.read_field(str(run_dir / "packet_k"), n_packets, 2,
                         frames=[1, n2])
    pv = binio.read_field(str(run_dir / "pv"), nx, nx, frames=pv2)
    check(all(np.isfinite(a).all() for a in (x, k, pv, ts)),
          "non-finite frames")
    check(not np.array_equal(k[..., 0], k[..., 1]), "packets never moved")
    log = runmeta.parse_run_log(str(run_dir / "run.log"))
    check(log["nx"] == nx and log["n_packets"] == n_packets,
          f"run.log {log}")
    ck2 = checkpoint.latest_checkpoint(run_dir)
    check(ck2.endswith(f"{total:012d}.npz"), f"checkpoint {ck2}")
    with np.load(ck2) as z:
        check(all(np.isfinite(z[f]).all() for f in z.files
                  if z[f].dtype.kind in "fc"), "non-finite checkpoint")
    say(3, f"resume: continued at chunk {chunks_first} (t={ts_saved[-1]:.4f})"
           f" to chunk {total} (t={ts[-1]:.4f}) in {t2 - t1:.1f} s; {n2} "
           f"packet frames, {pv2} pv frames, run.log nx={log['nx']} "
           f"Np={log['n_packets']}, checkpoint {Path(ck2).name}",
        timed=True)
    shutil.rmtree(run_dir)      # ~170 MB of frames at the full size


# ---------------------------------------------------------------------------
# Phase 4: gradient through the lock-step
# ---------------------------------------------------------------------------

# The custom-VJP gradients run the same XLA backward on residuals from
# forwards that differ by a few ulps; plain autodiff of the twin sums
# the same products in another order; the flow cotangent sums 2^20
# packet contributions through a scatter-add whose order is not fixed.
# 1e-3 of the largest gradient entry bounds these effects in float32.
GRAD_REL_TOL = 1e-3


def phase_grad(nx=HEADLINE_NX, n_packets=HEADLINE_NP, n_steps=2,
               engine=None):
    """Three gradients of one packet functional: the custom VJP with the
    engine's forward, the custom VJP with the XLA twin's forward, and
    plain autodiff through the twin (no custom VJP) as the reference
    both are checked against."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from unittest import mock
    from swraytracing.models.coupled2 import (setup_coupled2,
                                              run_coupled2_chunk)
    from swraytracing.ops import pallas_window as pwin

    cfg = headline_config(nx, n_packets, steps=n_steps)
    s, carry = setup_coupled2(cfg)
    check(s.march is not None, "fused march did not engage")
    engine = engine or s.march.engine

    def loss(qk, s_):
        c = carry.replace(flow_state=carry.flow_state.replace(qk=qk))
        c, (px, pk, ts) = run_coupled2_chunk(c, s_, cfg, 1)
        return jnp.mean(pk[-1, 0] ** 2 + pk[-1, 1] ** 2)

    variants = (
        (f"custom VJP, {engine} forward", engine, pwin.fused_march),
        ("custom VJP, xla twin forward", "xla", pwin.fused_march),
        ("plain autodiff of the xla twin", "xla", pwin.march_reference))
    grads, stats = {}, {}
    for name, eng, march_fn in variants:
        s_e = s._replace(march=s.march._replace(engine=eng))
        gfn = jax.jit(jax.grad(functools.partial(loss, s_=s_e)))
        t0 = time.perf_counter()
        with mock.patch.object(pwin, "fused_march", march_fn):
            comp = gfn.lower(carry.flow_state.qk).compile()
        tc = time.perf_counter() - t0
        temp = getattr(comp.memory_analysis(), "temp_size_in_bytes", "n/a")
        _sync(comp(carry.flow_state.qk))
        t0 = time.perf_counter()
        g = _sync(comp(carry.flow_state.qk))
        el = time.perf_counter() - t0
        check(bool(jnp.isfinite(jnp.abs(g)).all()), f"{name}: non-finite")
        grads[name] = np.asarray(g)
        stats[name] = (el, temp)
        say(4, f"grad d<|k|^2>/dqk, {n_steps} flow steps, {nx}^2 "
               f"Np={n_packets}, {name}: {el * 1e3:.1f} ms, compile "
               f"{tc:.1f} s, program temp bytes {temp}, process "
               f"peak_bytes_in_use {peak_bytes()}", timed=True)
    ref_name = variants[-1][0]
    ref = grads.pop(ref_name)
    scale = float(np.abs(ref).max())
    check(scale > 0, "zero gradient")
    for name, g in grads.items():
        dev = float(np.abs(g - ref).max()) / scale
        say(4, f"rel max|grad({name}) - grad({ref_name})| = {dev:.3e} "
               f"(tol {GRAD_REL_TOL:g} of max|grad|)")
        check(dev <= GRAD_REL_TOL, f"{name}: gradient deviation {dev}")
    return stats


# ---------------------------------------------------------------------------
# Phase 5: four cards
# ---------------------------------------------------------------------------

# Sharding splits independent packets (and members); the flow is
# replicated. Per-packet arithmetic is the same program on every card,
# so the sharded and single-card states agree to a few ulps.
SHARD_TOL_ULPS = 8

def _max_ulp_dev(a, b, eps):
    return max(d / max(scale * eps, 1e-300)
               for d, scale in row_deviation(a, b))


def _timed_rate(comp, args, n_chunks, packet_steps):
    """Warm the compiled steady-state program once, then time n_chunks
    calls back to back; returns (packet-steps/s, carry, last output)."""
    c, _ = _sync(comp(*args))
    rest = args[1:]
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        c, out = comp(c, *rest)
    _sync((c, out))
    el = time.perf_counter() - t0
    return n_chunks * packet_steps / el, c, out


def _trace_chunk(phase, comp, args, what, trace_dir):
    import jax

    d = Path(trace_dir)
    with jax.profiler.trace(str(d)):
        _sync(comp(*args))
    print_trace_summary(phase, d, what, top=4)
    shutil.rmtree(d)        # raw traces are hundreds of MB


def phase_multi(n_dev=4, nx=HEADLINE_NX, packets_per_dev=HEADLINE_NP,
                steps=10, ens_nx=256, ens_packets=2 ** 17, ens_steps=10,
                chunks=3, trace_dir=OUT_DIR / "trace5"):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from swraytracing.models.coupled import CoupledConfig
    from swraytracing.models.coupled2 import (setup_coupled2,
                                              run_coupled2_chunk)
    from swraytracing.parallel.ensemble import (setup_ensemble,
                                                run_ensemble_chunk)
    from swraytracing.parallel.sharding import make_mesh, collective_census

    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"need {n_dev} devices, have {len(devs)}")
    mesh = make_mesh(devs, ensemble=1)
    one = devs[0]

    # (a) headline chunk, packets sharded over the cards vs one card; the
    # march partitions itself by the packets' sharding (fused_march)
    n_packets = packets_per_dev * n_dev
    cfg = headline_config(nx, n_packets, steps=steps)
    s, carry = setup_coupled2(cfg)
    run = jax.jit(functools.partial(run_coupled2_chunk, s=s, cfg=cfg,
                                    n_saves=1))
    pack = NamedSharding(mesh, P(None, "packets"))
    repl = NamedSharding(mesh, P())
    c_sh = carry.replace(
        packet_x=jax.device_put(carry.packet_x, pack),
        packet_k=jax.device_put(carry.packet_k, pack),
        prev_fields=jax.device_put(carry.prev_fields, repl),
        flow_state=jax.device_put(carry.flow_state, repl))
    c_one = jax.device_put(carry, one)
    out, rates = {}, {}
    for name, c, cards in (("sharded", c_sh, n_dev), ("one card", c_one, 1)):
        comp0, _ = compiled_chunk(run, c)
        c, _ = _sync(comp0(c))
        comp1, _ = compiled_chunk(run, c)
        rate, c, _ = _timed_rate(comp1, (c,), chunks, steps * n_packets)
        rates[name] = rate / cards
        out[name] = (np.concatenate([np.asarray(c.packet_x),
                                     np.asarray(c.packet_k)]), comp1)
        shards = {sh.device.id for sh in c.packet_x.addressable_shards}
        say(5, f"(a) {nx}^2 Np={n_packets} ({packets_per_dev}/card), "
               f"{name}: {rate:.6e} packet-steps/s over {chunks} x {steps} "
               f"steps, {rate / cards:.6e} per card, packet state on "
               f"devices {sorted(shards)}", timed=True)
        check(int(c.overflow) == 0, f"(a) {name}: overflow")
    say(5, f"(a) per-card efficiency of the sharded run: "
           f"{rates['sharded'] / rates['one card']:.3f}")
    eps = float(np.finfo(out["one card"][0].dtype).eps)
    dev = _max_ulp_dev(out["sharded"][0], out["one card"][0], eps)
    say(5, f"(a) sharded vs one card: max deviation {dev:.2f} ulp of each "
           f"row's max magnitude (tol {SHARD_TOL_ULPS})")
    check(dev <= SHARD_TOL_ULPS, f"(a) sharded vs one card: {dev} ulp")
    census = collective_census(out["sharded"][1].as_text())
    say(5, f"(a) collective census of the sharded chunk: {census or '{}'}")
    check(census.get("all-gather", 0) == 0, f"(a) all-gather: {census}")
    check(census.get("all-to-all", 0) == 0, f"(a) all-to-all: {census}")
    del out, c_sh, c_one, carry

    # (b) 4-member one-layer ensemble, sharded by member vs one device
    base = CoupledConfig(nx=ens_nx, n_packets=ens_packets, T_Fr_days=6000.0,
                         packet_delay_days=0.01,
                         packet_steps_per_save=ens_steps,
                         window_min_np=min(65536, ens_packets))
    cfgs = [base._replace(near_inertial_factor=w0, U_g=ug)
            for w0, ug in ((2.0, 0.4), (4.0, 0.4), (2.0, 0.8), (4.0, 0.8))]
    s_e, es, carry_b = setup_ensemble(cfgs)
    emesh = make_mesh(devs, ensemble=n_dev)
    memb = NamedSharding(emesh, P("ensemble"))
    outs, rates = {}, {}
    for name, m, cards, (cb, e) in (
            ("by member", emesh, n_dev,
             (jax.device_put(carry_b, memb), jax.device_put(es, memb))),
            ("one card", None, 1,
             (jax.device_put(carry_b, one), jax.device_put(es, one)))):
        run_e = jax.jit(functools.partial(run_ensemble_chunk, s=s_e,
                                          cfg=base, n_saves=1, mesh=m))
        cb, _ = _sync(run_e.lower(cb, e).compile()(cb, e))
        comp = run_e.lower(cb, e).compile()    # steady-state structure
        rate, cb, _ = _timed_rate(comp, (cb, e), chunks,
                                  ens_steps * len(cfgs) * ens_packets)
        rates[name] = rate / cards
        outs[name] = (np.concatenate([np.asarray(cb.packet_x),
                                      np.asarray(cb.packet_k)], axis=1),
                      comp)
        shards = {sh.device.id for sh in cb.packet_x.addressable_shards}
        say(5, f"(b) ensemble of {len(cfgs)} x {ens_nx}^2 Np={ens_packets}, "
               f"{name}: {rate:.6e} packet-steps/s over {chunks} x "
               f"{ens_steps} steps, {rate / cards:.6e} per card, members "
               f"on devices {sorted(shards)}", timed=True)
        check(int(np.max(np.asarray(cb.overflow))) == 0,
              f"(b) {name}: overflow")
        if trace_dir is not None:
            _trace_chunk(5, comp, (cb, e), f"(b) {name}, one {ens_steps}-"
                                           "step chunk", trace_dir)
    say(5, f"(b) per-card efficiency of the member-sharded run: "
           f"{rates['by member'] / rates['one card']:.3f}")
    a, b = outs["by member"][0], outs["one card"][0]
    dev = max(_max_ulp_dev(a[i], b[i], eps) for i in range(len(cfgs)))
    say(5, f"(b) by member vs one card: max deviation {dev:.2f} ulp "
           f"(tol {SHARD_TOL_ULPS})")
    check(dev <= SHARD_TOL_ULPS, f"(b) by member vs one card: {dev} ulp")
    census = collective_census(outs["by member"][1].as_text())
    say(5, f"(b) collective census of the sharded ensemble: "
           f"{census or '{}'}")
    check(census.get("all-gather", 0) == 0, f"(b) all-gather: {census}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four-card phase (5) only")
    ap.add_argument("--trace", default=None,
                    help="write phase-1 profiler traces under this dir")
    args = ap.parse_args(argv)

    # The GPU runs the program; the CPU backend serves phase 2's
    # reference run, so keep it available next to a restricted list.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax
    from swraytracing.utils.compile_cache import enable_compile_cache

    try:
        dev = require_gpu()
    except PhaseFailure as e:
        print(f"[phase 0] FAIL: {e}", file=sys.stderr, flush=True)
        return 2
    CARD = "card: " + card_line()
    import jaxlib

    cache = enable_compile_cache()
    say(0, f"device_kind={dev.device_kind} count={len(jax.devices())} "
           f"jax={jax.__version__} jaxlib={jaxlib.__version__} "
           f"compile cache {cache}")
    say(0, CARD)
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    if args.multi:
        phases = {5: phase_multi}
    else:
        phases = {1: lambda: phase_march(trace_dir=args.trace),
                  2: phase_headline, 3: phase_cli, 4: phase_grad}
    for p, fn in phases.items():
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report which phase failed, then stop
            import traceback

            traceback.print_exc()
            print(f"[phase {p}] FAIL: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            return 1
        say(p, f"PASS in {time.perf_counter() - t0:.1f} s", timed=True)
    print(json.dumps({"ok": True, "device": device_summary()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
