"""CLI smoke tests (python -m swraytracing ...) — the headless-
MATLAB replacement surface (runqgsw_raytrace.sbatch:31 equivalent)."""

import sys
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _run(*args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "swraytracing", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": "/root"})


def test_cli_help_lists_subcommands():
    r = _run("--help")
    assert r.returncode == 0
    for sub in ("qgsw", "qg2", "sweep", "analyze"):
        assert sub in r.stdout


def test_cli_ensemble_sweep(tmp_path):
    base = tmp_path / "cli-sweep"
    r = _run("sweep", "--ensemble", "--nx", "32", "--packets", "16",
             "--t-fr-days", "30", "--delay-days", "0.1", "--base-dir",
             str(base), "--max-steps", "60", "--hist-bins", "32",
             "--platform", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    # 20 member dirs with histogram frames + reference-format logs
    runs = sorted(base.glob("run-*"))
    assert len(runs) == 20
    assert (runs[0] / "omega_hist.bin").exists()
    assert (runs[0] / "run.log").exists()


def test_cli_qgsw_runs_and_analyzes(tmp_path):
    out = tmp_path / "cli-run"
    r = _run("qgsw", "--nx", "32", "--packets", "4", "--t-fr-days", "30",
             "--delay-days", "0.1", "--out", str(out), "--max-steps",
             "60", "--platform", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "run.log").exists() and (out / "packet_x.bin").exists()
    r2 = _run("analyze", str(out), "--out", str(tmp_path / "figs"))
    assert r2.returncode == 0, r2.stderr[-2000:]
    figs = list((tmp_path / "figs").glob("*.png"))
    assert figs, "analyze produced no figures"
