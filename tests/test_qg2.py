"""Two-layer QG solver tests: operator algebra, exact linear evolution,
stability, and the coupled driver (reference qg2layersw_raytrace.m)."""

import numpy as np
import jax
import jax.numpy as jnp

from swraytracing.ops.grid import SpectralGrid
from swraytracing.models import qg2
from swraytracing.models.coupled2 import (Coupled2Config, setup_coupled2,
                                              run_coupled2_chunk)


def test_inversion_matrix_is_inverse():
    """B must invert the 2-layer coupling matrix M = [[-K2-F, F],
    [F, -K2-F]] at every nonzero mode."""
    grid = SpectralGrid.square(16, 20.0)
    Kd2 = 3.0
    F = Kd2 / 2.0
    B = qg2._inversion_matrix(grid, Kd2)
    K2 = grid.K2
    M = np.array([[-K2 - F, F + 0 * K2], [F + 0 * K2, -K2 - F]])
    prod = np.einsum("ij...,jk...->ik...", B, M)
    nz = K2 > 0
    for i in range(2):
        for j in range(2):
            want = 1.0 if i == j else 0.0
            np.testing.assert_allclose(prod[i, j][nz], want, atol=1e-10)


def test_expm2_matches_scipy():
    from scipy.linalg import expm as scipy_expm

    rng = np.random.default_rng(0)
    A = (rng.standard_normal((2, 2, 5)) + 1j * rng.standard_normal((2, 2, 5)))
    E = qg2._expm2(A, 0.37)
    for m in range(5):
        np.testing.assert_allclose(E[:, :, m], scipy_expm(0.37 * A[:, :, m]),
                                   rtol=1e-10)
    # defective / equal-eigenvalue case (delta = 0)
    A0 = np.array([[1.0, 1.0], [0.0, 1.0]], dtype=complex)[:, :, None]
    np.testing.assert_allclose(qg2._expm2(A0, 0.5)[:, :, 0],
                               scipy_expm(0.5 * A0[:, :, 0]), rtol=1e-10)


def test_single_mode_evolves_by_exact_exponential():
    """For a single-Fourier-mode PV, J(psi, q) vanishes identically, so
    the integrating-factor AB3 must reproduce qk(t) = exp(t L) qk0 to
    machine precision — this pins down the exp-factor history
    propagation (qg2layersw_raytrace.m:168-181)."""
    grid = SpectralGrid.square(32, 20.0)
    p = qg2.QG2Params(Kd2=3.0, shear=0.5, r=0.4, nu_tune=0.1, alpha=4)
    dt = 0.01
    ops = qg2.build_operators(grid, p, dt)

    qk0 = np.zeros((2,) + grid.spectral_shape, dtype=np.complex128)
    kx_i, ky_i = 3, 2
    qk0[0, kx_i, ky_i] = 1.0 + 0.5j
    qk0[1, kx_i, ky_i] = -0.3 + 0.2j
    qk0 = jnp.asarray(qk0)

    n = 20
    st = qg2.qg2_init(qk0)
    st, _, _ = qg2.simulate_qg2(st, grid, ops, p, n, n)

    En = qg2._expm2(np.asarray(
        qg2.build_operators(grid, p, n * dt).expLdt * 0), 0)  # placeholder
    # exact: exp(n dt L) = expLdt^n per mode; compute by repeated matmul
    E = np.asarray(ops.expLdt)[:, :, kx_i, ky_i]
    En = np.eye(2, dtype=complex)
    for _ in range(n):
        En = E @ En
    want = En @ np.asarray(qk0)[:, kx_i, ky_i]
    got = np.asarray(st.qk)[:, kx_i, ky_i]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # all other modes stay zero
    mask = np.ones(grid.spectral_shape, bool)
    mask[kx_i, ky_i] = False
    assert np.abs(np.asarray(st.qk)[:, mask]).max() < 1e-14


def test_two_layer_solver_stable():
    """Shear-forced two-layer run stays finite and bounded (baroclinic
    growth saturated by drag + hyperviscosity)."""
    grid = SpectralGrid.square(64, 20.0)
    p = qg2.QG2Params(Kd2=3.0, shear=0.5)
    qk0 = qg2.initial_q2_ring(5, grid, 0.4, 3.0, k_min=5, k_max=10)
    dt = 0.5 * 0.25 * grid.dx / 0.9  # ~half-CFL at u~shear+U_g
    ops = qg2.build_operators(grid, p, dt)
    st = qg2.qg2_init(qk0)
    st, qks, ts = qg2.simulate_qg2(st, grid, ops, p, 300, 100)
    assert bool(jnp.isfinite(jnp.abs(st.qk)).all())
    u = float(qg2.max_speed2(st.qk, grid, ops, p))
    assert np.isfinite(u) and u < 50.0, u


def test_coupled2_end_to_end():
    cfg = Coupled2Config(nx=48, n_packets=16, T_Fr_days=20.0,
                         packet_delay_days=0.5, packet_steps_per_save=5)
    s, carry = setup_coupled2(cfg)
    assert s.dt > 0 and s.n_steps > 0
    carry, (px, pk, ts) = jax.jit(
        lambda c: run_coupled2_chunk(c, s, cfg, 8))(carry)
    assert bool(jnp.isfinite(px).all()) and bool(jnp.isfinite(pk).all())
    # packets moved and are being refracted
    assert float(jnp.abs(px[-1] - px[0]).max()) > 1e-3
    om0 = np.sqrt(cfg.f**2 + cfg.Cg**2 * np.sum(np.asarray(pk[0]) ** 2, -1))
    omT = np.sqrt(cfg.f**2 + cfg.Cg**2 * np.sum(np.asarray(pk[-1]) ** 2, -1))
    assert omT.std() > 0  # frequencies evolving


def test_coupled2_quirk_mode_runs():
    cfg = Coupled2Config(nx=32, n_packets=4, T_Fr_days=5.0,
                         packet_delay_days=0.1, one_layer_quirk=True,
                         ring_ic=False, packet_steps_per_save=2)
    s, carry = setup_coupled2(cfg)
    carry, (px, pk, ts) = run_coupled2_chunk(carry, s, cfg, 2)
    assert bool(jnp.isfinite(px).all())
