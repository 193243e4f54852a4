"""Reversible-symplectic O(1)-memory gradient tests."""

import numpy as np
import jax
import jax.numpy as jnp

from swraytracing.models.dispersion import Dispersion
from swraytracing.models import analytic, rays
from swraytracing.models.fields import flow_from_psi_grid
from swraytracing.models.reversible import (make_reversible_integrator,
                                                inverse_symplectic_step)
from swraytracing.ops.grid import SpectralGrid

DISP = Dispersion(f=3.0, Cg=1.0)


def _ics(n=8, ki=8.0, seed=0):
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    x0 = jnp.asarray(rng.uniform(0, 2 * np.pi, (2, n)))
    k0 = jnp.asarray(ki * np.stack([np.cos(ang), np.sin(ang)], 0))
    return x0, k0


def test_inverse_step_reconstructs():
    """inverse o forward = identity to fixed-point tolerance."""
    flow = analytic.childress_soward(U0=0.2)
    x0, k0 = _ics()
    dt = 0.01
    x1, k1 = rays.symplectic_step(x0, k0, dt, DISP, flow)
    xr, kr = inverse_symplectic_step(x1, k1, dt, DISP, flow)
    np.testing.assert_allclose(np.asarray(xr), np.asarray(x0), atol=1e-12)
    np.testing.assert_allclose(np.asarray(kr), np.asarray(k0), atol=1e-12)


def test_reversible_forward_matches_scan():
    flow = analytic.childress_soward(U0=0.15)
    x0, k0 = _ics()
    dt, n = 0.01, 200
    integ = make_reversible_integrator(DISP, dt, n)
    xN, kN = integ(x0, k0, flow)
    step = lambda x, k, t: rays.symplectic_step(x, k, dt, DISP, flow)
    xs, ks, _ = rays.integrate_rays(x0, k0, dt, n, step, save_every=n)
    np.testing.assert_allclose(np.asarray(xN), np.asarray(xs[-1]),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(kN), np.asarray(ks[-1]),
                               rtol=1e-12)


def test_reversible_grad_matches_autodiff_analytic():
    """O(1)-memory VJP == plain reverse-mode through the scan, for both
    packet ICs and the analytic flow parameters."""
    x0, k0 = _ics(4)
    dt, n = 0.01, 100

    def loss_rev(U0, k0_):
        flow = analytic.childress_soward(U0=U0)
        integ = make_reversible_integrator(DISP, dt, n)
        xN, kN = integ(x0, k0_, flow)
        return jnp.mean(kN**2) + jnp.mean(jnp.sin(xN) ** 2)

    def loss_scan(U0, k0_):
        flow = analytic.childress_soward(U0=U0)
        step = lambda x, k, t: rays.symplectic_step(x, k, dt, DISP, flow)
        xs, ks, _ = rays.integrate_rays(x0, k0_, dt, n, step, save_every=n)
        return jnp.mean(ks[-1] ** 2) + jnp.mean(jnp.sin(xs[-1]) ** 2)

    U0 = jnp.asarray(0.12)
    gU_r, gk_r = jax.grad(loss_rev, argnums=(0, 1))(U0, k0)
    gU_s, gk_s = jax.grad(loss_scan, argnums=(0, 1))(U0, k0)
    np.testing.assert_allclose(float(gU_r), float(gU_s), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(gk_r), np.asarray(gk_s),
                               rtol=1e-7, atol=1e-12)


def test_reversible_grad_wrt_gridded_flow_spectrum():
    """Gradient w.r.t. the gridded flow FIELDS (hence, through the
    linear spectral construction, the flow spectrum) — the BASELINE.json
    differentiable-raytracing requirement at O(1) memory."""
    grid = SpectralGrid.square(32)
    X, Y = grid.meshgrid()
    psi0 = jnp.asarray(0.1 * (np.sin(X) * np.sin(Y)))
    x0, k0 = _ics(4)
    dt, n = 0.01, 60

    def loss_rev(psi):
        flow = flow_from_psi_grid(psi, grid)
        integ = make_reversible_integrator(DISP, dt, n)
        xN, kN = integ(x0, k0, flow)
        return jnp.mean(kN**2)

    def loss_scan(psi):
        flow = flow_from_psi_grid(psi, grid)
        step = lambda x, k, t: rays.symplectic_step(x, k, dt, DISP, flow)
        xs, ks, _ = rays.integrate_rays(x0, k0, dt, n, step, save_every=n)
        return jnp.mean(ks[-1] ** 2)

    g_r = jax.grad(loss_rev)(psi0)
    g_s = jax.grad(loss_scan)(psi0)
    np.testing.assert_allclose(np.asarray(g_r), np.asarray(g_s),
                               rtol=1e-6, atol=1e-10)
    # and against finite differences
    d = jnp.asarray(np.random.default_rng(3).standard_normal(psi0.shape))
    eps = 1e-6
    fd = (loss_scan(psi0 + eps * d) - loss_scan(psi0 - eps * d)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(g_r, d)), float(fd),
                               rtol=1e-4)


def test_long_loop_reconstruction_stability():
    """Reconstruction drift over 2000 steps stays at roundoff level."""
    flow = analytic.childress_soward(U0=0.2)
    x0, k0 = _ics(8, ki=10.0)
    dt, n = 0.005, 2000
    integ = make_reversible_integrator(DISP, dt, n)
    xN, kN = integ(x0, k0, flow)

    def back(_, xk):
        from swraytracing.models.reversible import (
            inverse_symplectic_step as inv)
        return inv(*xk, dt, DISP, flow)

    import jax.lax as lax
    xr, kr = lax.fori_loop(0, n, back, (xN, kN))
    assert float(jnp.abs(xr - x0).max()) < 1e-9
    assert float(jnp.abs(kr - k0).max()) < 1e-9
