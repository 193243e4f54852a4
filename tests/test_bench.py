"""Smoke test for bench.py: a breakage here (e.g. a bad config kwarg
behind a BENCH_* env) would break the benchmark, so exercise the real
script end-to-end at tiny dims on the CPU, including its env knobs."""

import json
import os
import subprocess
import sys


def test_bench_smoke_tiny():
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               BENCH_NX="32", BENCH_NP="512", BENCH_SAVES="1",
               BENCH_STEPS_PER_CALL="2", BENCH_SUBSTEPS="2",
               BENCH_STEPPER="rk23")
    r = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..",
                                      "bench.py")],
        capture_output=True, text=True, env=env, timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("{")][-1]
    out = json.loads(line)
    assert out["unit"] == "packet-steps/s"
    assert out["value"] > 0 and out["vs_baseline"] > 0
    assert out["device"] == {"platform": "cpu", "kind": "cpu",
                             "count": out["device"]["count"]}
