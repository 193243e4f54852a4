"""Frozen-flow raytracing driver tests (BASELINE configs 1-3)."""

import numpy as np
import jax.numpy as jnp

from swraytracing.ops.grid import SpectralGrid
from swraytracing.ops import spectral as sp
from swraytracing.models.dispersion import Dispersion
from swraytracing.models import analytic, frozen
from swraytracing.io import binio

DISP = Dispersion(f=3.0, Cg=1.0)


def test_config1_zero_background():
    """Config 1: U=0 — Omega_abs conserved exactly; omega == omega_abs."""
    flow = analytic.childress_soward(U0=0.0)
    x0, k0 = frozen.ring_ics(4, 2.0, DISP)
    res = frozen.raytrace_frozen(flow, x0, k0, DISP, 0.01, 200, 100)
    assert float(jnp.max(res.conservation_error)) < 1e-12
    np.testing.assert_allclose(np.asarray(res.omega),
                               np.asarray(res.omega_abs), rtol=1e-12)


def test_config2_vorticity_well_histogram():
    """Config 2: steady vorticity-well flow, omega spreads but
    Omega_abs is conserved (symplectic)."""
    flow = analytic.vorticity_well(A=0.3, sigma=1.2)
    x0, k0 = frozen.ring_ics(64, 2.0, DISP, seed=7)
    res = frozen.raytrace_frozen(flow, x0, k0, DISP, 0.005, 2000, 500)
    err = float(res.conservation_error[-1])
    assert err < 5e-3, err
    # omega distribution spreads off the ring
    assert float(res.omega[-1].std()) > 1e-3
    # integrators agree on the invariant quality ranking
    res_rk = frozen.raytrace_frozen(flow, x0, k0, DISP, 0.005, 2000, 500,
                                    stepper="rk4")
    assert float(res_rk.conservation_error[-1]) < 1e-5


def test_config3_pv_snapshot_roundtrip(tmp_path):
    """Config 3: write a QG PV frame to .bin, reload it through the
    frozen-snapshot driver, check conservation in the steady flow."""
    from swraytracing.models.qg import initial_q_ring

    nx = 64
    grid = SpectralGrid.square(nx)
    qk = initial_q_ring(3, grid, 0.3, 3.0)
    q = sp.to_grid(qk, grid)
    binio.write_field(np.asarray(q), tmp_path / "pv", 1)
    binio.write_field(np.asarray(q) * 0.5, tmp_path / "pv", 2)

    res = frozen.raytrace_pv_snapshot(tmp_path / "pv", frame=1, nx=nx,
                                      Kd2=3.0, disp=DISP, n_packets=16,
                                      dt=0.002, nsteps=1000, save_every=250)
    assert float(res.conservation_error[-1]) < 2e-2
    assert bool(jnp.isfinite(res.x).all())


def test_rsw_restart_action_raytracing():
    """raytrace_sw.m workflow: decomposed RSW state, x-k-a advection."""
    from swraytracing.models.exact_linear import (geostrophic_ic,
                                                      plane_wave_ic)

    grid = SpectralGrid.square(64)
    X, Y = grid.meshgrid()
    ug, vg, hg = geostrophic_ic(grid, 3.0, 1.0,
                                0.05 * np.sin(X) * np.sin(Y))
    uw, vw, hw = plane_wave_ic(grid, 3.0, 1.0, 5, 0, eta0=0.02)
    u = np.asarray(ug) + uw
    v = np.asarray(vg) + vw
    h = np.asarray(hg) + hw
    x0, k0 = frozen.ring_ics(8, 2.0, DISP, seed=2)
    xs, ks, as_, ts = frozen.raytrace_rsw_restart(
        u, v, h, DISP, grid, x0, k0, dt=0.002, nsteps=200, save_every=100)
    assert bool(jnp.isfinite(xs).all())
    assert bool(jnp.isfinite(as_).all())
    # action stays positive and O(1)
    assert float(as_[-1].min()) > 0.5 and float(as_[-1].max()) < 2.0
