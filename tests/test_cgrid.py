"""C-grid solver tests (swp equivalent)."""

import numpy as np
import jax
import jax.numpy as jnp

from swraytracing.models import cgrid
from swraytracing.models.cgrid import SWPParams


def test_avg_dif_match_reference_semantics():
    f = jnp.asarray(np.arange(12.0).reshape(3, 4))
    # periodic average along axis 0
    fa = cgrid.avg(f, 0, periodic=True)
    np.testing.assert_allclose(np.asarray(fa[-1]),
                               0.5 * (np.asarray(f[0]) + np.asarray(f[-1])))
    # wall rule: last = f(end)/2
    fw = cgrid.avg(f, 0, periodic=False)
    np.testing.assert_allclose(np.asarray(fw[-1]), 0.5 * np.asarray(f[-1]))
    # dif wall rule: last = -f(end)
    fd = cgrid.dif(f, 0, periodic=False)
    np.testing.assert_allclose(np.asarray(fd[-1]), -np.asarray(f[-1]))
    # shift moves the periodic element to the front
    fs = cgrid.dif(f, 0, periodic=True, shift=True)
    np.testing.assert_allclose(np.asarray(fs[0]),
                               np.asarray(f[0]) - np.asarray(f[-1]))


def test_laplacian_of_harmonic():
    n = 64
    L = 2 * np.pi
    x = np.arange(n) * L / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    f = np.sin(2 * X) * np.cos(3 * Y)
    lap = cgrid.laplacian(jnp.asarray(f), L / n, L / n, True, True)
    # centered-difference laplacian approximates -(4+9) f
    np.testing.assert_allclose(np.asarray(lap), -13.0 * f, atol=0.5)


def test_swp_geostrophic_state_steady():
    """A balanced state on the f-plane stays nearly steady."""
    n = 64
    L = 2 * np.pi
    x = np.arange(n) * L / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    h0 = 0.01 * np.sin(X) * np.sin(Y)
    p = SWPParams(Roi=5.0, Cg=2.0, dttune=0.2)
    us, vs, hs, ts, ke, ape, htot = jax.jit(
        lambda h: cgrid.swp(jnp.zeros((n, n)), jnp.zeros((n, n)), h, p,
                            nt=100, save_every=50, geovel=True),
        )(jnp.asarray(h0))
    assert bool(jnp.isfinite(hs).all())
    # height anomaly remains close to initial (balanced)
    drift = float(jnp.max(jnp.abs(hs[-1] - jnp.asarray(h0))))
    assert drift < 0.2 * 0.01, drift


def test_swp_mass_conservation_periodic():
    n = 32
    rng = np.random.default_rng(0)
    h0 = 0.01 * rng.standard_normal((n, n))
    u0 = 0.05 * rng.standard_normal((n, n))
    v0 = 0.05 * rng.standard_normal((n, n))
    p = SWPParams(Roi=3.0, Cg=1.0, Nu=0.05)
    us, vs, hs, ts, ke, ape, htot = cgrid.swp(u0, v0, h0, p, nt=100,
                                              save_every=25)
    np.testing.assert_allclose(np.asarray(htot), float(htot[0]), atol=1e-9)


def test_swp_walls_and_topography_run():
    n = 32
    x = np.arange(n) * 2 * np.pi / n
    X, Y = np.meshgrid(x, x, indexing="ij")
    hb = 0.05 * np.exp(-((X - np.pi) ** 2 + (Y - np.pi) ** 2))
    h0 = 0.01 * np.cos(X)
    p = SWPParams(Roi=2.0, Beta=0.1, Cg=1.0, Drag=0.01, periodx=True,
                  periody=False, Nu=0.1)
    us, vs, hs, ts, ke, ape, htot = cgrid.swp(
        np.zeros((n, n)), np.zeros((n, n)), h0, p, hb=hb, nt=60,
        save_every=30)
    assert bool(jnp.isfinite(hs).all())


def test_swp_restart_matches_continuous(tmp_path):
    """Direct-to-file run + restart from the returned state (the
    reference's F_in.frame/F_in.time workflow, swp.m:26-28) must
    reproduce a single continuous run exactly: RK3 carries no history,
    so a save-boundary restart is bit-exact, and the file frames must
    continue the numbering."""
    from swraytracing.io import binio

    n = 32
    rng = np.random.default_rng(1)
    h0 = 0.01 * rng.standard_normal((n, n))
    u0 = 0.05 * rng.standard_normal((n, n))
    v0 = 0.05 * rng.standard_normal((n, n))
    p = SWPParams(Roi=3.0, Cg=1.0, Nu=0.05)

    # continuous: 40 steps, 2 frames
    us, vs, hs, ts, *_ = cgrid.swp(u0, v0, h0, p, nt=40, save_every=20)

    # file run of 20 steps, then restart for 20 more
    d = tmp_path / "swp"
    r1, _ = cgrid.swp_to_files(u0, v0, h0, d, p, nt=20, save_every=20)
    assert r1["frame"] == 1
    r2, _ = cgrid.swp_to_files(r1["u"], r1["v"], r1["h"], d, p, nt=20,
                               save_every=20, frame0=r1["frame"],
                               t0=r1["time"])
    assert r2["frame"] == 2
    np.testing.assert_allclose(r2["h"], np.asarray(hs[-1]), atol=1e-12)
    np.testing.assert_allclose(r2["time"], float(ts[-1]), rtol=1e-12)
    # both frames readable from the same file, matching the continuous run
    h_frames = np.asarray(binio.read_field(str(d / "h.bin"), n, n, 1,
                                           [1, 2]))
    h_frames = h_frames.reshape(n, n, 2)
    np.testing.assert_allclose(h_frames[..., 0], np.asarray(hs[0]),
                               atol=1e-12)
    np.testing.assert_allclose(h_frames[..., 1], np.asarray(hs[1]),
                               atol=1e-12)


def test_cgrid_pv_uniform_flow():
    n = 16
    p = SWPParams(Roi=4.0, Cg=1.0)
    H = jnp.ones((n, n))
    q = cgrid.cgrid_pv(jnp.ones((n, n)) * 0.3, jnp.zeros((n, n)), H, p,
                       0.1, 0.1)
    np.testing.assert_allclose(np.asarray(q), 4.0, rtol=1e-12)
