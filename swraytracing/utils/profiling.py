"""Profiling helpers: JAX traces + throughput timing.

The reference's only instrumentation is tic/toc wall-clock lines in its
run logs (qgsw_raytrace.m:114,178-179). Here:
  * `trace(dir)` — context manager around jax.profiler.trace (view in
    TensorBoard / xprof) for kernel-level device timelines;
  * `Timer` — blocking wall-clock timing of jitted callables with
    steps/sec + packet-steps/sec derived rates (what bench.py reports).
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "Timer", "time_callable"]


@contextlib.contextmanager
def trace(log_dir: str):
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def time_callable(fn, *args, warmup: int = 1, iters: int = 3):
    """Time a jitted callable, each call ended by jax.block_until_ready
    (JAX dispatches asynchronously: without it the clock measures the
    enqueue); returns (mean_seconds, last_output)."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters, out


def _union_ns(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_trace_summary(trace_dir, top: int = 12) -> list:
    """Reduce the newest profiler trace under `trace_dir` to device time.

    For each line of each device plane (`/device:...`): event count,
    summed duration, busy time (union of the line's intervals), the
    window from its first start to its last end, and the `top` event
    names by summed duration. Times in nanoseconds, from the device's
    own clock in the trace."""
    from pathlib import Path

    from jax.profiler import ProfileData

    paths = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda p: p.stat().st_mtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    out = []
    for plane in ProfileData.from_file(str(paths[-1])).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            by_name, spans = {}, []
            for ev in line.events:
                s, d = float(ev.start_ns), float(ev.duration_ns)
                by_name[ev.name] = by_name.get(ev.name, 0.0) + d
                spans.append((s, s + d))
            if not spans:
                continue
            out.append({
                "plane": plane.name, "line": line.name,
                "events": len(spans), "sum_ns": sum(by_name.values()),
                "busy_ns": _union_ns(spans),
                "window_ns": max(e for _, e in spans)
                - min(s for s, _ in spans),
                "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            })
    return out
