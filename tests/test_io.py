"""I/O tests: native binary round-trips, reference-format compatibility,
run metadata, checkpoint/resume."""

import numpy as np
import pytest

from swraytracing.io import binio, runmeta, checkpoint


def test_native_library_builds():
    assert binio.native_available(), "C++ swrt_io library failed to build"


def test_native_library_built_from_source_when_missing(tmp_path,
                                                       monkeypatch):
    """The shared library is not in git: a checkout without it builds
    it from native/swrt_io.cpp with native/Makefile on first use."""
    import shutil

    src = binio._NATIVE_DIR
    for name in ("Makefile", "swrt_io.cpp"):
        shutil.copy(src / name, tmp_path / name)
    monkeypatch.setattr(binio, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(binio, "_LIB", None)
    monkeypatch.setattr(binio, "_LIB_TRIED", False)
    assert not (tmp_path / "libswrt_io.so").exists()
    assert binio.native_available()
    assert (tmp_path / "libswrt_io.so").exists()
    f = str(tmp_path / "x")
    binio.write_field(np.arange(6.0).reshape(2, 3), f, 1)
    np.testing.assert_array_equal(binio.read_field(f, 2, 3, frames=1),
                                  np.arange(6.0).reshape(2, 3))


def test_real_field_roundtrip(tmp_path):
    f = str(tmp_path / "pv")
    rng = np.random.default_rng(0)
    frames = [rng.standard_normal((16, 8)) for _ in range(4)]
    for i, fr in enumerate(frames):
        binio.write_field(fr, f, i + 1)
    # single frame
    got = binio.read_field(f, 16, 8, frames=3)
    np.testing.assert_array_equal(got, frames[2])
    # multiple frames -> stacked last axis
    got = binio.read_field(f, 16, 8, frames=[1, 4])
    np.testing.assert_array_equal(got[..., 0], frames[0])
    np.testing.assert_array_equal(got[..., 1], frames[3])
    assert binio.frame_count(f, 16, 8) == 4


def test_complex_field_roundtrip(tmp_path):
    f = str(tmp_path / "spec")
    rng = np.random.default_rng(1)
    a = rng.standard_normal((9, 5)) + 1j * rng.standard_normal((9, 5))
    b = 2 * a
    binio.write_field(a, f, 1)
    binio.write_field(b, f, 2)
    # nx == 2*ny - 1 triggers the reference's complex heuristic
    got = binio.read_field(f, 9, 5, frames=[1, 2])
    np.testing.assert_array_equal(got[..., 0], a)
    np.testing.assert_array_equal(got[..., 1], b)


def test_overwrite_frame_in_place(tmp_path):
    """Frame-addressed writes must be idempotent / overwritable (the
    reference's crash-resume property: rewriting frame j leaves others)."""
    f = str(tmp_path / "x")
    binio.write_field(np.full((4, 4), 1.0), f, 1)
    binio.write_field(np.full((4, 4), 2.0), f, 2)
    binio.write_field(np.full((4, 4), 9.0), f, 1)
    np.testing.assert_array_equal(binio.read_field(f, 4, 4, frames=1),
                                  np.full((4, 4), 9.0))
    np.testing.assert_array_equal(binio.read_field(f, 4, 4, frames=2),
                                  np.full((4, 4), 2.0))


def test_timeseries_mode(tmp_path):
    f = str(tmp_path / "t")
    for i in range(5):
        binio.write_field(np.asarray(float(i) * 1.5), f, i + 1)
    np.testing.assert_allclose(binio.read_field(f),
                               1.5 * np.arange(5))


def test_column_major_layout(tmp_path):
    """The on-disk byte order must be MATLAB column-major so reference
    read_field sees the same matrix."""
    f = str(tmp_path / "cm")
    a = np.arange(6.0).reshape(2, 3)
    binio.write_field(a, f, 1)
    raw = np.fromfile(f + ".bin", np.float64)
    np.testing.assert_array_equal(raw, [0, 3, 1, 4, 2, 5])


def test_run_log_roundtrip(tmp_path):
    rd = runmeta.RunDir(tmp_path / "run-0")
    rd.write_params(nx=64, f=3.0, note="test")
    assert rd.read_params()["nx"] == 64
    rd.log_metrics(step=1, ke=0.5)
    rd.log_metrics(step=2, ke=0.6)
    assert rd.read_metrics()[1]["ke"] == 0.6
    rd.write_run_log(nx=256, n_packets=50, k_radius=6.0, dt=0.004845,
                     T=666.666667, spin_up=400.0, steps_per_save=50,
                     packet_steps_per_save=5, f=3.0, Cg=1.0, U_g=0.5,
                     U0=0.50657, Fr=0.50657, Kd2=3.0)
    rd.finish_run_log()
    got = runmeta.parse_run_log(rd.file("run.log"))
    assert got["nx"] == 256 and got["n_packets"] == 50
    assert abs(got["Fr"] - 0.50657) < 1e-9
    assert "wall_seconds" in got


def test_parse_reference_run_log():
    """Our parser must read a run.log in the reference's MATLAB format
    (qgsw_raytrace.m:76-88 header + elapsed-time footer); the fixture
    was written by RunDir.write_run_log."""
    from pathlib import Path

    got = runmeta.parse_run_log(
        Path(__file__).parent / "data" / "reference_run.log")
    assert got["nx"] == 256
    assert got["n_packets"] == 50
    assert got["f"] == 3.0
    assert abs(got["U_g"] - 0.5) < 1e-12
    assert abs(got["wall_seconds"] - 3132.769) < 1e-6


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    from swraytracing.models.coupled import CoupledConfig, setup_coupled

    cfg = CoupledConfig(nx=32, n_packets=4, T_Fr_days=5.0)
    s, carry = setup_coupled(cfg)
    p = checkpoint.save_state(tmp_path / "ckpt", carry, step=7)
    assert p.endswith("000000000007.npz")
    got = checkpoint.restore_state(p, carry)
    np.testing.assert_array_equal(np.asarray(got.packet_x),
                                  np.asarray(carry.packet_x))
    np.testing.assert_array_equal(np.asarray(got.flow_state.qk),
                                  np.asarray(carry.flow_state.qk))
    assert checkpoint.latest_checkpoint(tmp_path) == p


def test_profiling_helpers():
    """Timer measures wall time; time_callable blocks on every call's
    outputs and returns the last one."""
    import time as _time
    import jax
    import jax.numpy as jnp
    from swraytracing.utils.profiling import Timer, time_callable

    with Timer() as t:
        _time.sleep(0.01)
    assert 0.005 < t.elapsed < 1.0

    f = jax.jit(lambda x: (x * 2.0, {"s": jnp.sum(x)}))
    dt, out = time_callable(f, jnp.arange(8.0), warmup=1, iters=2)
    assert dt >= 0.0
    np.testing.assert_allclose(np.asarray(out[0]),
                               2.0 * np.arange(8.0))


def test_async_writer_orders_and_propagates_errors(tmp_path):
    """AsyncWriter preserves per-file frame order (FIFO worker) and
    re-raises worker exceptions on flush/close."""
    import numpy as np
    import pytest
    from swraytracing.io import binio
    from swraytracing.io.asyncwriter import AsyncWriter

    f = str(tmp_path / "frames")
    with AsyncWriter() as w:
        for frame in range(1, 6):
            w.submit(binio.write_field,
                     np.full((4, 4), float(frame)), f, frame)
        w.flush()
        got = binio.read_field(f, 4, 4, frames=[1, 3, 5])
        assert got.shape == (4, 4, 3)
        np.testing.assert_array_equal(got[0, 0, :], [1.0, 3.0, 5.0])

    def boom():
        raise RuntimeError("disk full")

    w2 = AsyncWriter()
    w2.submit(boom)
    with pytest.raises(RuntimeError, match="disk full"):
        w2.flush()
    # the error is STICKY: close() raises again (a failed run must not
    # look successful; frames after the failure were skipped)
    with pytest.raises(RuntimeError, match="disk full"):
        w2.close()
