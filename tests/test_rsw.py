"""RSW solver tests against exact linear solutions (rsw/lsw.m ground
truth, formalising rsw/standingwave.m, planewave.m, swexamples.m checks)."""

import numpy as np
import jax
import jax.numpy as jnp

from swraytracing.ops.grid import SpectralGrid
from swraytracing.models import rsw
from swraytracing.models.exact_linear import (linear_sw_solution,
                                                 plane_wave_ic,
                                                 geostrophic_ic)

F, CG = 3.0, 1.0


def test_linear_solution_reproduces_ic():
    """t=0 must return the IC exactly — regression for the reference's
    getSk.m double-normalisation defect (which breaks this)."""
    grid = SpectralGrid.square(32)
    rng = np.random.default_rng(0)
    u0, v0, h0 = (rng.standard_normal(grid.shape) for _ in range(3))
    u, v, h = linear_sw_solution(u0, v0, h0, F, CG, [0.0], grid)
    np.testing.assert_allclose(u[0], u0, atol=1e-10)
    np.testing.assert_allclose(v[0], v0, atol=1e-10)
    np.testing.assert_allclose(h[0], h0, atol=1e-10)


def test_plane_wave_is_linear_eigenmode():
    """A plane_wave_ic evolved by the exact linear solution is a pure
    phase translation at speed omega/K."""
    grid = SpectralGrid.square(64)
    k_i, l_i = 3, 0
    u0, v0, h0 = plane_wave_ic(grid, F, CG, k_i, l_i, eta0=0.01)
    w = np.sqrt(F**2 + CG**2 * k_i**2)
    T = 0.7
    u, v, h = linear_sw_solution(u0, v0, h0, F, CG, [T], grid)
    # translated IC: theta = k x - w t -> shift x by w t / k
    u0s, v0s, h0s = plane_wave_ic(grid, F, CG, k_i, l_i, eta0=0.01,
                                  phase=-w * T)
    np.testing.assert_allclose(h[0], h0s, atol=1e-12)
    np.testing.assert_allclose(u[0], u0s, atol=1e-12)
    np.testing.assert_allclose(v[0], v0s, atol=1e-12)


def test_nonlinear_swk_matches_linear_at_small_amplitude():
    """swk at eta0=1e-4 must track the exact linear solution to O(eta^2)
    + time-discretisation error."""
    grid = SpectralGrid.square(64)
    p = rsw.RSWParams(f=F, Cg=CG)
    u0, v0, h0 = plane_wave_ic(grid, F, CG, 3, 2, eta0=1e-4)
    st = rsw.rsw_init(u0, v0, h0, grid, p)
    nsteps = 200
    st, S, ts, ke, pe = jax.jit(
        lambda s: rsw.simulate_rsw(s, grid, p, nsteps, nsteps))(st)
    T = float(st.t)
    ul, vl, hl = linear_sw_solution(u0, v0, h0, F, CG, [T], grid)
    scale = 1e-4
    assert np.max(np.abs(np.asarray(S[-1][2]) - hl[0])) / scale < 5e-3
    assert np.max(np.abs(np.asarray(S[-1][0]) - ul[0])) / scale < 2e-2


def test_linearized_swku_zero_background_matches_linear():
    """swkU with U=V=0 IS the linear SW system; the AB3 solution must
    match lsw to time-stepping accuracy even at O(1) amplitude."""
    grid = SpectralGrid.square(64)
    p = rsw.RSWParams(f=F, Cg=CG)
    u0, v0, h0 = plane_wave_ic(grid, F, CG, 2, 1, eta0=0.3)
    st = rsw.rsw_init(u0, v0, h0, grid, p)
    zero = jnp.zeros(grid.shape)
    nsteps = 150
    st, S, ts, ke, pe = jax.jit(lambda s: rsw.simulate_rsw(
        s, grid, p, nsteps, nsteps,
        background_fn=lambda t: (zero, zero)))(st)
    T = float(st.t)
    ul, vl, hl = linear_sw_solution(u0, v0, h0, F, CG, [T], grid)
    np.testing.assert_allclose(np.asarray(S[-1][2]), hl[0], atol=2e-4)
    np.testing.assert_allclose(np.asarray(S[-1][0]), ul[0], atol=2e-3)


def test_energy_conservation_nonlinear():
    """Total energy drift of an inviscid-scale geostrophic+wave state
    stays small over a few hundred steps (swk.m ke/pe diagnostics)."""
    grid = SpectralGrid.square(64)
    p = rsw.RSWParams(f=F, Cg=CG)
    X, Y = grid.meshgrid()
    psi = 0.05 * (np.sin(X) * np.sin(Y) + 0.3 * np.cos(2 * X))
    ug, vg, hg = geostrophic_ic(grid, F, CG, psi)
    uw, vw, hw = plane_wave_ic(grid, F, CG, 4, 1, eta0=0.02)
    st = rsw.rsw_init(np.asarray(ug) + uw, np.asarray(vg) + vw,
                      np.asarray(hg) + hw, grid, p)
    st, S, ts, ke, pe = jax.jit(
        lambda s: rsw.simulate_rsw(s, grid, p, 300, 50))(st)
    E = np.asarray(ke) + np.asarray(pe)
    assert not bool(st.blown)
    assert np.abs(E[-1] - E[0]) / E[0] < 5e-3, E


def test_wave_vortex_decomposition():
    grid = SpectralGrid.square(64)
    p = rsw.RSWParams(f=F, Cg=CG)
    X, Y = grid.meshgrid()
    ug, vg, hg = geostrophic_ic(grid, F, CG, 0.1 * np.sin(X) * np.sin(2 * Y))
    (g_, _, _), (uw, vw, hw) = rsw.wave_vortex_decompose(
        jnp.asarray(ug), jnp.asarray(vg), jnp.asarray(hg), grid, p)
    # geostrophic input -> wave residual ~ 0
    assert float(jnp.abs(uw).max()) < 1e-10
    assert float(jnp.abs(hw).max()) < 1e-10
    # plane gravity wave -> vortex part ~ 0
    u0, v0, h0 = plane_wave_ic(grid, F, CG, 3, 1, eta0=0.01)
    (ug2, vg2, hg2), _ = rsw.wave_vortex_decompose(
        jnp.asarray(u0), jnp.asarray(v0), jnp.asarray(h0), grid, p)
    assert float(jnp.abs(ug2).max()) < 1e-12 * 1e3  # tiny vs eta0=1e-2
    assert float(jnp.abs(hg2).max()) < 1e-12 * 1e3


def test_killpv_and_pvdamp_run():
    grid = SpectralGrid.square(32)
    u0, v0, h0 = plane_wave_ic(grid, F, CG, 2, 2, eta0=0.05)
    for p in (rsw.RSWParams(f=F, Cg=CG, killpv=True),
              rsw.RSWParams(f=F, Cg=CG, pv_damp_rate=0.1)):
        st = rsw.rsw_init(u0, v0, h0, grid, p)
        zero = jnp.zeros(grid.shape)
        st, S, ts, ke, pe = rsw.simulate_rsw(
            st, grid, p, 20, 20, background_fn=lambda t: (zero, zero))
        assert bool(jnp.isfinite(S).all())


def test_particle_advection_cellular():
    """Particles in psi = cos x cos y stay on streamlines
    (rsw/testparticles.m; advect_particles is the function the reference
    calls but never defines)."""
    grid = SpectralGrid.square(64)
    X, Y = grid.meshgrid()
    psi = np.cos(X) * np.cos(Y)
    u = np.sin(Y) * np.cos(X)   # -psi_y
    v = -np.sin(X) * np.cos(Y)  # psi_x
    xp = jnp.asarray(np.random.default_rng(1).uniform(0.5, 2.5, (2, 16)))
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    step = jax.jit(lambda x: rsw.advect_particles(x, uj, vj, grid, 0.02))
    x = xp
    for _ in range(200):
        x = step(x)
    psi0 = np.cos(np.asarray(xp[0])) * np.cos(np.asarray(xp[1]))
    psiT = np.cos(np.asarray(x[0])) * np.cos(np.asarray(x[1]))
    np.testing.assert_allclose(psiT, psi0, atol=1e-5)


def test_example_ics_run_stably():
    """swexamples.m IC library: each canned IC runs in swk and stays
    finite; the wave/vortex split behaves as constructed."""
    from swraytracing.models import examples

    grid = SpectralGrid.square(64)
    p = rsw.RSWParams(f=F, Cg=CG)
    cases = {
        "packet": examples.wave_packet_ic(grid, F, CG),
        "adjust": examples.zero_pv_adjustment_ic(grid, F, CG),
        "vortex": examples.rigid_lid_vortex_ic(grid, F, CG),
        "inertial": examples.inertial_oscillation_ic(grid),
        "standing": examples.counter_propagating_ic(grid, F, CG),
        "bath": examples.wave_bath_ic(grid, F, CG, aw=0.02),
    }
    for name, (u0, v0, h0) in cases.items():
        st = rsw.rsw_init(u0, v0, h0, grid, p)
        st, S, ts, ke, pe = rsw.simulate_rsw(st, grid, p, 30, 30)
        assert bool(jnp.isfinite(S).all()), name
        assert not bool(st.blown), name


def test_inertial_oscillation_rotates_at_f():
    """Uniform flow rotates at exactly f (swexamples.m inertial case)."""
    from swraytracing.models import examples

    grid = SpectralGrid.square(32)
    p = rsw.RSWParams(f=F, Cg=CG)
    u0, v0, h0 = examples.inertial_oscillation_ic(grid, u0=0.1)
    st = rsw.rsw_init(u0, v0, h0, grid, p)
    st, S, ts, ke, pe = rsw.simulate_rsw(st, grid, p, 200, 200)
    T = float(st.t)
    np.testing.assert_allclose(np.asarray(S[-1][0]),
                               0.1 * np.cos(F * T), atol=2e-4)
    np.testing.assert_allclose(np.asarray(S[-1][1]),
                               -0.1 * np.sin(F * T), atol=2e-4)


def test_wave_vortex_spectra_separates_bands():
    """wavespecic2d-style IC: wave energy in |k|<=5, geostrophic energy
    in the 10<|k|<=13 band; the decomposed iso-spectra must reflect it."""
    from swraytracing.models import examples

    grid = SpectralGrid.square(64)
    p = rsw.RSWParams(f=F, Cg=CG)
    (u, v, h), (ug, vg, hg) = examples.wave_and_geostrophic_spectrum_ic(
        grid, F, CG, aw=0.05, ag=0.2)
    spec = rsw.wave_vortex_spectra(jnp.asarray(u), jnp.asarray(v),
                                   jnp.asarray(h), grid, p)
    ke_g = np.asarray(spec["ke_g"])  # rings K=1..kmax
    ke_w = np.asarray(spec["ke_w"])
    assert ke_w[:5].sum() > 10 * ke_w[9:13].sum()   # waves at low K
    assert ke_g[9:13].sum() > 10 * ke_g[:5].sum()   # vortex in its band


def test_swks_bernoulli_variant_runs():
    """swks.m = swk with the Bernoulli missing its 1/2
    (swks.m:176); covered by bernoulli_half=False."""
    grid = SpectralGrid.square(32)
    p = rsw.RSWParams(f=F, Cg=CG, bernoulli_half=False)
    u0, v0, h0 = plane_wave_ic(grid, F, CG, 2, 1, eta0=0.01)
    st = rsw.rsw_init(u0, v0, h0, grid, p)
    st, S, ts, ke, pe = rsw.simulate_rsw(st, grid, p, 40, 40)
    assert bool(jnp.isfinite(S).all()) and not bool(st.blown)


def test_translating_cs_background_swku_tc():
    """swkU_tc: linearized waves over a TRANSLATING Childress-Soward
    background recomputed per step (swkU_tc.m:202-220)."""
    from swraytracing.models import examples

    grid = SpectralGrid.square(48)
    p = rsw.RSWParams(f=F, Cg=CG)
    bg = examples.translating_cs_background(grid, F, CG, ag=0.1, raXT=0.2)
    # background translates: U(t=0) != U(t=2)
    U0g, _ = bg(jnp.asarray(0.0))
    U2g, _ = bg(jnp.asarray(2.0))
    assert float(jnp.abs(U0g - U2g).max()) > 1e-3
    u0, v0, h0 = plane_wave_ic(grid, F, CG, 3, 1, eta0=0.02)
    st = rsw.rsw_init(u0, v0, h0, grid, p)
    st, S, ts, ke, pe = jax.jit(lambda s: rsw.simulate_rsw(
        s, grid, p, 60, 60, background_fn=bg))(st)
    assert bool(jnp.isfinite(S).all())


def test_swknd_linear_wave_dispersion():
    """swknd (nondimensional RSW via the swk change of variables) must
    propagate a small plane wave at omega = sqrt(1 + gam^2 K^2) in
    swknd TIME — this exercises the full mapping (amplitude scalings
    U=gam u, H=ep h AND the time scaling T=ep t); a bare parameter
    substitution without them fails this test."""
    n, ep, gam = 64, 0.5, 0.7
    ki, li = 3, 2
    eta0 = 1e-5
    grid = SpectralGrid.square(n)
    X, Y = grid.meshgrid()
    K2 = ki**2 + li**2
    w = np.sqrt(1.0 + gam**2 * K2)
    th = ki * X + li * Y
    h0 = eta0 * np.cos(th)
    u0 = eta0 / (gam * K2) * (w * ki * np.cos(th) - li * np.sin(th))
    v0 = eta0 / (gam * K2) * (w * li * np.cos(th) + ki * np.sin(th))
    S, ts, ke, pe, _ = jax.jit(lambda u, v, h: rsw.swknd(
        u, v, h, ep, gam, 300, 300, nutune=1e-3))(u0, v0, h0)
    T = float(ts[-1])
    h_exp = eta0 * np.cos(th - w * T)
    np.testing.assert_allclose(np.asarray(S[-1, 2]), h_exp,
                               atol=eta0 * 2e-2)


def test_swknd_particle_grid_inertial_oscillation():
    """Uniform initial u: exact inertial oscillation u = u0 cos(t_nd),
    v = -u0 sin(t_nd) (swknd Coriolis parameter is 1), so the particle
    grid displaces by (u0 sin t, u0 (cos t - 1)) — checks the np^2
    particle option AND the particle velocity/time rescale."""
    n, ep, gam, u0a = 32, 0.4, 0.8, 0.01
    S, ts, ke, pe, xps = rsw.swknd(u0a * np.ones((n, n)), np.zeros((n, n)),
                                   np.zeros((n, n)), ep, gam, 200, 200,
                                   np_particles=3)
    assert xps.shape[-1] == 9
    T = float(ts[-1])
    np.testing.assert_allclose(float(S[-1, 0].mean()), u0a * np.cos(T),
                               atol=u0a * 1e-3)
    x0 = (np.arange(3) / 3) * 2 * np.pi + 1e-7
    X, Y = np.meshgrid(x0, x0, indexing="ij")
    np.testing.assert_allclose(np.asarray(xps[-1][0]),
                               X.ravel() + u0a * np.sin(T),
                               atol=u0a * 2e-2)
    np.testing.assert_allclose(np.asarray(xps[-1][1]),
                               Y.ravel() + u0a * (np.cos(T) - 1.0),
                               atol=u0a * 2e-2)


def test_doppler_wave_field_builder():
    from swraytracing.models import examples

    grid = SpectralGrid.square(48)
    (u, v, eta), (ug, vg, etag), ew = examples.doppler_wave_field(
        grid, F, CG, [0.0, 0.5], k_range=range(3, 5), l_range=range(5, 7))
    assert eta.shape == (2, 48, 48)
    assert np.isfinite(eta).all() and np.isfinite(ew).all()
    assert np.abs(eta[1] - eta[0]).max() > 1e-3  # waves moved
    # wave part renormalised per time: max|etaw| = aw exactly
    np.testing.assert_allclose(np.abs(eta - etag).max(axis=(1, 2)),
                               0.1, rtol=1e-12)


def test_doppler_refract_wave_differs_from_unrefracted():
    """Refraction by the CS vorticity (dopplerrefractwave.m:63) must
    change the evolved wave field but not the t=0 snapshot's eta (the
    t=0 phase theta = kx+ly+phi is omega-independent; u,v do depend on
    omega through the polarisation)."""
    from swraytracing.models import examples

    grid = SpectralGrid.square(48)
    kw = dict(k_range=range(3, 5), l_range=range(5, 7), seed=3)
    (u0, v0, e0), _, _ = examples.doppler_wave_field(
        grid, F, CG, [0.0, 0.5], **kw)
    (u1, v1, e1), (ug, vg, etag, vortg) = \
        examples.doppler_refract_wave_field(grid, F, CG, [0.0, 0.5], **kw)
    np.testing.assert_allclose(e1[0], e0[0], atol=1e-12)
    assert np.abs(e1[1] - e0[1]).max() > 1e-6
    assert np.isfinite(vortg).all()


def test_doppler_refract_wave_sw_extracts_geostrophic():
    """Feeding a purely geostrophic state into the _sw variant must
    recover it (up to the ag renormalisation) as the mean flow."""
    from swraytracing.models import examples
    from swraytracing.models.exact_linear import geostrophic_ic

    grid = SpectralGrid.square(48)
    X, Y = grid.meshgrid()
    psi = 0.05 * (np.sin(X) * np.sin(Y) + 0.25 * np.cos(X) * np.cos(Y))
    u, v, h = (np.asarray(a) for a in geostrophic_ic(grid, F, CG, psi))
    ag = 0.2
    (ut, vt, et), (ug, vg, etag, vortg) = examples.doppler_refract_wave_sw(
        u, v, h, grid, F, CG, [0.0], ag=ag, aw=0.05,
        k_range=range(3, 5), l_range=range(5, 7))
    # extracted etag is the input h rescaled so max|etag| = ag
    np.testing.assert_allclose(etag, h * (ag / np.abs(h).max()),
                               atol=1e-10)
    np.testing.assert_allclose(ug, u * (ag / np.abs(h).max()), atol=1e-9)


def test_exact_linear_1d():
    from swraytracing.models.exact_linear import linear_sw_solution_1d

    n, k = 64, 3
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    w = np.sqrt(F**2 + CG**2 * k**2)
    h0 = 0.01 * np.cos(k * x)
    u0 = 0.01 * w / k * np.cos(k * x)
    v0 = 0.01 * F / k * np.sin(k * x)
    T = 0.4
    u, v, h = linear_sw_solution_1d(u0, v0, h0, F, CG, [T])
    np.testing.assert_allclose(h[0], 0.01 * np.cos(k * x - w * T),
                               atol=1e-12)
