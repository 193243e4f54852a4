"""1-D solver tests (sw1 / sw1d / ybj1d family)."""

import numpy as np
import jax.numpy as jnp

from swraytracing.models import sw1d

F, CG = 3.0, 1.0


def _wave_ic(n, k, eta0):
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    w = np.sqrt(F**2 + CG**2 * k**2)
    h = eta0 * np.cos(k * x)
    u = eta0 * w / k * np.cos(k * x)
    v = eta0 * F / k * np.sin(k * x)
    return np.stack([u, v, h], axis=1), w, x


def test_sw1_linear_wave_translates():
    n, k, eta0 = 128, 3, 1e-5
    U0, w, x = _wave_ic(n, k, eta0)
    p = sw1d.SW1Params(f=F, Cg=CG)
    Us, ts, ke, pe, _ = sw1d.sw1(jnp.asarray(U0), p, 200, 200)
    T = float(ts[-1])
    h_exp = eta0 * np.cos(k * x - w * T)
    np.testing.assert_allclose(np.asarray(Us[-1][:, 2]), h_exp,
                               atol=eta0 * 5e-3)


def test_sw1_energy_bounded_nonlinear():
    n = 128
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    U0 = np.stack([0.1 * np.sin(x), 0.05 * np.cos(2 * x),
                   0.05 * np.cos(x)], axis=1)
    p = sw1d.SW1Params(f=F, Cg=CG)
    Us, ts, ke, pe, _ = sw1d.sw1(jnp.asarray(U0), p, 400, 100)
    E = np.asarray(ke) + np.asarray(pe)
    assert np.isfinite(E).all()
    assert abs(E[-1] - E[0]) / E[0] < 1e-2


def test_sw1_particles_advance():
    n = 64
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    U0 = np.stack([0.3 * np.ones(n), np.zeros(n), np.zeros(n)], axis=1)
    p = sw1d.SW1Params(f=F, Cg=CG)
    xp0 = jnp.asarray([0.0, 1.0, 2.0])
    Us, ts, ke, pe, xps = sw1d.sw1(jnp.asarray(U0), p, 50, 50, Xp0=xp0)
    # u field starts uniform 0.3; particle displacement ~ integral of u
    assert np.all(np.asarray(xps[-1]) > np.asarray(xp0))


def test_sw1_forced_linear_dispersion():
    """Ro=0: pure linear waves, frequency sqrt(1 + Bu k^2) (sw1d.m
    nondimensional form with f=1)."""
    n, k, Bu, eta0 = 128, 2, 0.5, 1e-4
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    w = np.sqrt(1.0 + Bu * k**2)
    h = eta0 * np.cos(k * x)
    u = eta0 * w / (k * Bu) * Bu * np.cos(k * x)  # u = eta w/k (Bu=g'H)
    v = eta0 / k * np.sin(k * x)
    U0 = np.stack([u, v, h], axis=1)
    dt = 2e-3
    nsteps = 400
    Us, ts, ke, pe = sw1d.sw1_forced(jnp.asarray(U0), Ro=0.0, Bu=Bu,
                                     V0=0.0, Kv=1, dt=dt, nsteps=nsteps,
                                     save_every=nsteps)
    T = float(ts[-1])
    h_exp = eta0 * np.cos(k * x - w * T)
    np.testing.assert_allclose(np.asarray(Us[-1][:, 2]), h_exp,
                               atol=eta0 * 1e-2)


def test_sw1rk3nu_single_mode_matches_expm():
    """One spectral mode of the damped linear system (Ro=0) evolves by
    the exact matrix exponential of
        d/dt [u,v,h]_k = [[-nu k^2S, 1, -i Bu k], [-1, -nu k^2S, 0],
                          [-i k, 0, 0]] [u,v,h]_k
    (sw1rk3nu.m rhs: hyperviscosity on u,v only, none on h); the solver
    should match to RK3 error."""
    import scipy.linalg

    n, k, Bu, nu, S = 64, 3, 0.5, 1e-6, 2
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    # real IC projecting onto mode k: u = cos kx, v = sin kx, h = cos kx
    U0 = np.stack([np.cos(k * x), np.sin(k * x), np.cos(k * x)], axis=1)
    nsteps = 200
    Us, ts, ke, pe = sw1d.sw1rk3nu(jnp.asarray(U0), Ro=0.0, Bu=Bu, nu=nu,
                                   nsteps=nsteps, save_every=nsteps, S=S)
    T = float(ts[-1])
    d = nu * float(k) ** (2 * S)
    M = np.array([[-d, 1.0, -1j * Bu * k],
                  [-1.0, -d, 0.0],
                  [-1j * k, 0.0, 0.0]], dtype=complex)
    # spectral coefficients at +k of the IC (half-spectrum convention)
    c0 = np.array([0.5, -0.5j, 0.5], dtype=complex)
    cT = scipy.linalg.expm(M * T) @ c0
    u_exp = 2 * np.real(cT[0] * np.exp(1j * k * x))
    v_exp = 2 * np.real(cT[1] * np.exp(1j * k * x))
    h_exp = 2 * np.real(cT[2] * np.exp(1j * k * x))
    got = np.asarray(Us[-1])
    np.testing.assert_allclose(got[:, 0], u_exp, atol=1e-6)
    np.testing.assert_allclose(got[:, 1], v_exp, atol=1e-6)
    np.testing.assert_allclose(got[:, 2], h_exp, atol=1e-6)


def test_sw1rk3nu_matches_sw1_forced_when_inviscid():
    """nu=0, V0=0: sw1rk3nu and sw1_forced integrate the identical
    nondimensional system with the same RK3 — trajectories must agree to
    roundoff when run at the same dt."""
    n, Bu, Ro = 64, 0.8, 0.05
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    U0 = np.stack([0.2 * np.cos(2 * x), 0.1 * np.sin(x),
                   0.1 * np.cos(x)], axis=1)
    kmax = n // 2 - 1
    vmax0 = max(np.sqrt(Bu + 1.0),
                np.sqrt(np.max(np.abs(U0[:, 0]))**2
                        + np.max(np.abs(U0[:, 1]))**2))
    dt = 0.01 * 2 * np.pi / kmax / vmax0  # sw1rk3nu's own constant dt
    nsteps = 50
    Ua, ta, _, _ = sw1d.sw1rk3nu(jnp.asarray(U0), Ro=Ro, Bu=Bu, nu=0.0,
                                 nsteps=nsteps, save_every=nsteps)
    Ub, tb, _, _ = sw1d.sw1_forced(jnp.asarray(U0), Ro=Ro, Bu=Bu, V0=0.0,
                                   Kv=1, dt=dt, nsteps=nsteps,
                                   save_every=nsteps)
    np.testing.assert_allclose(float(ta[-1]), float(tb[-1]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(Ua[-1]), np.asarray(Ub[-1]),
                               rtol=1e-10, atol=1e-12)


def test_ybj1d_free_evolution_exact():
    """V0=0: each mode evolves by exp(-i Bu k^2 t / 2) exactly (to RK3
    error)."""
    n, Bu = 64, 0.7
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    A0 = np.exp(1j * 2 * x) + 0.5 * np.exp(-1j * 3 * x)
    dt, nsteps = 1e-3, 500
    As, ts = sw1d.ybj1d(jnp.asarray(A0), Bu, 0.0, 1, dt, nsteps, nsteps)
    T = float(ts[-1])
    A_exp = (np.exp(1j * 2 * x) * np.exp(-0.5j * Bu * 4 * T)
             + 0.5 * np.exp(-1j * 3 * x) * np.exp(-0.5j * Bu * 9 * T))
    np.testing.assert_allclose(np.asarray(As[-1]), A_exp, atol=1e-6)


def test_ybj1d_forced_conserves_action():
    """|A|^2 integral (wave action) is conserved by the YBJ equation
    (the operator is i*(Hermitian))."""
    n = 64
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    A0 = np.exp(1j * x) + 0.3 * np.exp(2j * x)
    As, ts = sw1d.ybj1d(jnp.asarray(A0), 0.5, 0.4, 2, 1e-3, 1000, 250)
    act = [float(np.sum(np.abs(np.asarray(a)) ** 2)) for a in As]
    np.testing.assert_allclose(act, act[0], rtol=1e-6)


def test_advect1d_constant_velocity():
    u = jnp.full((32,), 0.5)
    dx = 2 * np.pi / 32
    x = jnp.asarray([0.0, 3.0])
    x2 = sw1d.advect1d(x, u, dx, 0.1)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x) + 0.05,
                               rtol=1e-12)
