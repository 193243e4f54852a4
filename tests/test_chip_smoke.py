"""chip_smoke.py off the card: the card-line parser, the refusal to run
on the CPU, and every phase function at a tiny size on the CPU (the
'pallas' engine through the Pallas interpreter where a phase calls the
kernel directly)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("NVIDIA H100 80GB HBM3, 400.00 W\nNVIDIA H100 80GB HBM3, 400.00 W\n",
     ("NVIDIA H100 80GB HBM3", "400.00 W")),
    ("", None),
    ("no comma here", None),
])
def test_parse_card_line(text, want):
    if want is None:
        with pytest.raises(ValueError):
            cs.parse_card_line(text)
    else:
        assert cs.parse_card_line(text) == want


def _last_line_ok(stdout: str) -> bool:
    lines = [l for l in stdout.splitlines() if l.strip()]
    return bool(lines) and lines[-1].startswith('{"ok"')


def test_refuses_cpu(tmp_path):
    """Without a GPU: nonzero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       timeout=300, cwd=tmp_path)
    assert r.returncode != 0
    assert not _last_line_ok(r.stdout)
    assert "no GPU" in r.stderr


def test_needs_the_repository(tmp_path):
    """Alone in a directory, the script cannot import the program and
    fails without a result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, env=dict(env, JAX_PLATFORMS="cpu"),
                       timeout=300, cwd=tmp_path)
    assert r.returncode != 0
    assert not _last_line_ok(r.stdout)


PHASES = {
    "march": lambda tmp: cs.phase_march(
        nx=32, n_packets=100, steppers=(("rk23", 2),),
        lockstep_engines=("xla",), steps=2, iters=1, interpret=True),
    "headline": lambda tmp: cs.phase_headline(
        nx=32, n_packets=256, steps=2, chunks=1, cmp_nx=32,
        cmp_packets=128, cmp_steps=2),
    "cli": lambda tmp: cs.phase_cli(nx=32, n_packets=64, out_dir=tmp),
    "grad": lambda tmp: cs.phase_grad(nx=32, n_packets=128),
    "multi": lambda tmp: cs.phase_multi(
        nx=32, packets_per_dev=32, steps=2, ens_nx=32, ens_packets=64,
        ens_steps=2, chunks=1, trace_dir=tmp / "trace5"),
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_tiny_on_cpu(phase, tmp_path, capsys):
    PHASES[phase](tmp_path)
    out = capsys.readouterr().out
    assert "[phase" in out
