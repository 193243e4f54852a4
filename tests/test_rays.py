"""Ray integrator tests — formalising the reference's physics checks:
absolute-frequency conservation (SW_zero_background_raytracing.m:85-132),
cellular-flow closed orbits (rsw/testparticles.m), zero-background
straight rays, and gradient correctness vs finite differences (which the
reference cannot do at all — no autodiff in MATLAB)."""

import numpy as np
import jax
import jax.numpy as jnp

from swraytracing.models.dispersion import Dispersion
from swraytracing.models import analytic, rays
from swraytracing.models.fields import flow_from_psi_grid
from swraytracing.ops.grid import SpectralGrid


DISP = Dispersion(f=3.0, Cg=1.0)


def ring_ics(np_, ki, seed=0, L=2 * np.pi):
    # packet arrays are coordinate-first (2, Np)
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(np_) / np_
    x0 = jnp.asarray(rng.uniform(0, L, (2, np_)))
    k0 = jnp.asarray(ki * np.stack([np.cos(ang), np.sin(ang)], 0))
    return x0, k0


def omega_abs(flow, disp, x, k):
    ev = flow.at(x[0], x[1])
    return disp.absolute_frequency(k, ev.uv)


def test_dispersion_identities():
    k = jnp.asarray([[3.0], [4.0]])
    om = DISP.omega(k)
    np.testing.assert_allclose(np.asarray(om), np.sqrt(9.0 + 25.0))
    cg = DISP.group_velocity(k)
    np.testing.assert_allclose(np.asarray(cg)[:, 0],
                               np.array([3.0, 4.0]) / float(om[0]))
    # group velocity = d omega / dk (autodiff cross-check)
    g = jax.grad(lambda kk: DISP.omega(kk[:, None])[0])(
        jnp.asarray([3.0, 4.0]))
    np.testing.assert_allclose(np.asarray(g), np.asarray(cg)[:, 0],
                               rtol=1e-12)


def test_zero_background_straight_rays():
    """Config 'SW_zero_background_raytracing': U=0 — k constant, x moves
    at the constant group velocity, omega exactly conserved."""
    flow = analytic.childress_soward(U0=0.0)
    x0, k0 = ring_ics(8, 5.0)
    dt = 0.01
    step = lambda x, k, t: rays.symplectic_step(x, k, dt, DISP, flow)
    xs, ks, ts = rays.integrate_rays(x0, k0, dt, 100, step, save_every=100)
    np.testing.assert_allclose(np.asarray(ks[-1]), np.asarray(k0), atol=1e-12)
    expect = x0 + 1.0 * DISP.group_velocity(k0)  # T = 100*0.01
    np.testing.assert_allclose(np.asarray(xs[-1]), np.asarray(expect),
                               rtol=1e-10)


def test_absolute_frequency_conservation_symplectic():
    """Steady Childress-Soward flow: Omega = omega + U.k is a ray
    invariant; the reference plots dOmega/Omega0 as its integrator metric."""
    flow = analytic.childress_soward(U0=0.1, km=1.0, a=0.25)
    x0, k0 = ring_ics(16, 10.0)
    dt = 0.005
    Om0 = omega_abs(flow, DISP, x0, k0)
    step = lambda x, k, t: rays.symplectic_step(x, k, dt, DISP, flow)
    xs, ks, _ = rays.integrate_rays(x0, k0, dt, 1000, step, save_every=1000)
    OmT = omega_abs(flow, DISP, xs[-1], ks[-1])
    err = np.max(np.abs((np.asarray(OmT) - np.asarray(Om0)) / np.asarray(Om0)))
    assert err < 2e-3, err


def test_absolute_frequency_conservation_rk4():
    flow = analytic.childress_soward(U0=0.1, km=1.0, a=0.25)
    x0, k0 = ring_ics(16, 10.0)
    dt = 0.005
    Om0 = omega_abs(flow, DISP, x0, k0)
    step = lambda x, k, t: rays.rk4_step(x, k, dt, DISP, flow)
    xs, ks, _ = rays.integrate_rays(x0, k0, dt, 1000, step, save_every=1000)
    OmT = omega_abs(flow, DISP, xs[-1], ks[-1])
    err = np.max(np.abs((np.asarray(OmT) - np.asarray(Om0)) / np.asarray(Om0)))
    assert err < 1e-6, err


def test_integrators_agree_small_dt():
    flow = analytic.childress_soward(U0=0.1)
    x0, k0 = ring_ics(8, 10.0)
    dt = 1e-3
    outs = {}
    for name, fn in [
        ("sym", lambda x, k, t: rays.symplectic_step(x, k, dt, DISP, flow)),
        ("yosh", lambda x, k, t: rays.yoshida4_step(x, k, dt, DISP, flow)),
        ("rk4", lambda x, k, t: rays.rk4_step(x, k, dt, DISP, flow)),
        ("rk23", lambda x, k, t: rays.rk23_step(x, k, dt, DISP, flow)),
    ]:
        xs, ks, _ = rays.integrate_rays(x0, k0, dt, 200, fn, save_every=200)
        outs[name] = (np.asarray(xs[-1]), np.asarray(ks[-1]))
    for name in ("yosh", "rk4", "rk23"):
        np.testing.assert_allclose(outs[name][0], outs["rk4"][0], atol=2e-5)
        np.testing.assert_allclose(outs[name][1], outs["rk4"][1], atol=2e-4)


def test_cellular_flow_closed_orbits():
    """Fluid particles (k=0 rays have zero group velocity and zero
    refraction) in psi = cos x cos y follow closed streamlines — the
    rsw/testparticles.m check. The streamfunction value is conserved."""
    flow = analytic.cellular(A=1.0)
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.uniform(0.5, 2.5, (2, 32)))
    k0 = jnp.zeros((2, 32))
    dt = 0.01
    step = lambda x, k, t: rays.rk4_step(x, k, dt, DISP, flow)
    xs, ks, _ = rays.integrate_rays(x0, k0, dt, 500, step, save_every=500)
    psi0 = flow.streamfunction(x0[0], x0[1])
    psiT = flow.streamfunction(xs[-1][0], xs[-1][1])
    np.testing.assert_allclose(np.asarray(psiT), np.asarray(psi0), atol=1e-7)
    np.testing.assert_allclose(np.asarray(ks[-1]), 0.0, atol=1e-14)


def test_gridded_flow_matches_analytic():
    """GriddedFlow built from the CS streamfunction sampled on a grid must
    agree with the AnalyticFlow rays (SpectralScheme vs DifferenceScheme
    equivalence, cf. why_isnt_interpolate2_working.m comparisons)."""
    grid = SpectralGrid.square(128)
    X, Y = grid.meshgrid()
    U0, a = 0.1, 0.25
    psi = U0 * (np.sin(X) * np.sin(Y) + a * np.cos(X) * np.cos(Y))
    gflow = flow_from_psi_grid(jnp.asarray(psi), grid)
    aflow = analytic.childress_soward(U0=U0, km=1.0, a=a)
    x0, k0 = ring_ics(8, 10.0)
    dt = 0.01
    res = {}
    for name, fl in [("grid", gflow), ("ana", aflow)]:
        step = lambda x, k, t: rays.rk4_step(x, k, dt, DISP, fl)
        xs, ks, _ = rays.integrate_rays(x0, k0, dt, 100, step, save_every=100)
        res[name] = (np.asarray(xs[-1]), np.asarray(ks[-1]))
    np.testing.assert_allclose(res["grid"][0], res["ana"][0], atol=1e-5)
    np.testing.assert_allclose(res["grid"][1], res["ana"][1], atol=1e-4)


def test_action_conserved_in_uniform_flow():
    """step_packet_xka: with U spatially constant (grad U = 0, divC ~
    -|C|^2/omega nonzero only through U terms)... in a zero flow, action
    is exactly conserved and k unchanged."""
    grid = SpectralGrid.square(32)
    zero = flow_from_psi_grid(jnp.zeros(grid.shape), grid)
    x0, k0 = ring_ics(8, 5.0)
    a0 = jnp.ones(8)
    x, k, a = x0, k0, a0
    for _ in range(20):
        x, k, a = rays.rk4_xka_step(x, k, a, 0.01, DISP, zero)
    # With U=0, cg_sw.m:29 gives spatially-constant divC = -|C|^2/omega,
    # so da/dt = -a*divC integrates exactly to a(T) = exp(-divC*T);
    # k is unchanged.
    np.testing.assert_allclose(np.asarray(k), np.asarray(k0), atol=1e-10)
    C = DISP.group_velocity(k0)
    om = DISP.omega(k0)
    divC = -(C[0] ** 2 + C[1] ** 2) / om
    expect = np.exp(-np.asarray(divC) * 0.2)
    np.testing.assert_allclose(np.asarray(a), expect, rtol=1e-6)


def test_gradients_vs_finite_differences():
    """Exact gradients through the symplectic loop w.r.t. flow parameter
    and packet ICs — the BASELINE.json gradient requirement."""
    x0, k0 = ring_ics(4, 8.0)
    dt = 0.01

    def loss(U0, k0_):
        fl = analytic.childress_soward(U0=U0)
        step = lambda x, k, t: rays.symplectic_step(x, k, dt, DISP, fl)
        xs, ks, _ = rays.integrate_rays(x0, k0_, dt, 50, step, save_every=50)
        return jnp.mean(ks[-1] ** 2) + jnp.mean(xs[-1] ** 2)

    gU, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(0.1), k0)
    eps = 1e-6
    fdU = (loss(0.1 + eps, k0) - loss(0.1 - eps, k0)) / (2 * eps)
    np.testing.assert_allclose(float(gU), float(fdU), rtol=1e-5)
    dk = jnp.asarray(np.random.default_rng(2).standard_normal(k0.shape))
    fdk = (loss(0.1, k0 + eps * dk) - loss(0.1, k0 - eps * dk)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(gk, dk)), float(fdk), rtol=1e-5)


def test_rk4_frozen_step_uniform_flow_exact():
    """rk4_frozen_step (step_packet.m semantics: group velocity frozen at
    the initial k, grad U frozen at the initial position) is EXACT in a
    uniform flow: x advances by dt*(U + C(k0)), k is unchanged."""
    from swraytracing.models.fields import GriddedFlow

    grid = SpectralGrid.square(32)
    U0 = 0.37
    # uniform flow u = U0, v = 0, all gradients zero (a linear psi is
    # not periodic, so build the gridded fields directly)
    fields = jnp.zeros((6, 32, 32)).at[0].set(U0)
    flow = GriddedFlow(fields=fields, grid=grid)
    x0, k0 = ring_ics(16, 2.5)
    dt = 0.05
    x1, k1 = rays.rk4_frozen_step(x0, k0, dt, DISP, flow)
    C = DISP.group_velocity(k0)
    expect = x0 + dt * (jnp.stack([jnp.full(x0.shape[1], U0),
                                   jnp.zeros(x0.shape[1])]) + C)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(expect),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(k1), np.asarray(k0),
                               rtol=0, atol=1e-12)


def test_rk4_frozen_matches_rk4_small_dt():
    """In a smooth cellular flow the frozen-coefficient RK4 converges to
    the full RK4 as dt -> 0 (both are consistent discretizations of the
    same ray ODE)."""
    grid = SpectralGrid.square(64)
    X, Y = grid.meshgrid()
    flow = flow_from_psi_grid(jnp.asarray(0.1 * np.cos(X) * np.cos(Y)),
                              grid)
    x0, k0 = ring_ics(8, 2.5, seed=3)
    dt = 1e-3
    xa, ka = rays.rk4_frozen_step(x0, k0, dt, DISP, flow)
    xb, kb = rays.rk4_step(x0, k0, dt, DISP, flow)
    # the two schemes differ at O(dt^2) within one step
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xb),
                               rtol=0, atol=5e-7)
    np.testing.assert_allclose(np.asarray(ka), np.asarray(kb),
                               rtol=0, atol=5e-7)


def test_fixed_substeps_within_ode23_envelope():
    """SURVEY hard part #4 / VERDICT item 4: the production fixed
    sub-cycling (rk23 stages, n_substeps=4) must stay inside the
    reference's adaptive-ode23 tolerance envelope (rtol=1e-6, atol=1e-7;
    SW_zero_background_raytracing.m:71-79) over one flow step, at the
    WORST committed regime omega*dt ~ 1.5 (w0=16 with the dt=0.024
    long-run logs). Errors measured against an rtol=1e-10 adaptive
    truth. Full study: benchmarks/substep_study.py."""
    import functools
    from swraytracing.models.coupled import (CoupledConfig,
                                                 setup_coupled,
                                                 coupled_flow_packet_step)
    from swraytracing.models.fields import BlendedFlow, flow_from_qk
    from swraytracing.models.qg import qg_step

    cfg = CoupledConfig(nx=64, n_packets=64, near_inertial_factor=16.0,
                        packet_delay_days=0.0)
    s, carry = setup_coupled(cfg)
    carry = jax.jit(functools.partial(coupled_flow_packet_step, s=s,
                                      cfg=cfg))(carry)
    st2 = jax.jit(lambda st: qg_step(st, s.grid, s.qg_params))(
        carry.flow_state)
    F2 = jax.jit(
        lambda q: flow_from_qk(q, s.grid, s.qg_params.Kd2).fields)(st2.qk)
    flow = BlendedFlow(fields1=carry.prev_fields, fields2=F2, grid=s.grid)
    x0, k0 = carry.packet_x, carry.packet_k
    omega0 = np.sqrt(9.0 + float(jnp.sum(k0[:, 0] ** 2)))
    dt = 1.5 / omega0  # the worst reachable omega*dt regime

    xt, kt, tt, _, _ = jax.jit(lambda x, k: rays.rk23_adaptive(
        x, k, dt, s.disp, flow, rtol=1e-10, atol=1e-12))(x0, k0)
    xr, kr, tr, na, nt = jax.jit(lambda x, k: rays.rk23_adaptive(
        x, k, dt, s.disp, flow, rtol=1e-6, atol=1e-7))(x0, k0)
    assert int(na) > 0 and int(nt) >= int(na)
    # completed integrations: a truncated oracle would invalidate the
    # envelope comparison below (VERDICT r3 weak #6)
    assert float(tt) == dt and float(tr) == dt

    def err_at(m):
        def run_fixed(x, k):
            def body(i, xk):
                return rays.rk23_step(xk[0], xk[1], dt / m, s.disp, flow,
                                      alpha0=i / m, dalpha=1.0 / m)
            return jax.lax.fori_loop(0, m, body, (x, k))

        xf, kf = jax.jit(run_fixed)(x0, k0)
        scale = float(jnp.max(jnp.abs(kt)))
        return max(float(jnp.max(jnp.abs(xf - xt))),
                   float(jnp.max(jnp.abs(kf - kt)))) / scale

    err_ref = max(float(jnp.max(jnp.abs(xr - xt))),
                  float(jnp.max(jnp.abs(kr - kt)))) / \
        float(jnp.max(jnp.abs(kt)))
    # The SHIPPING default (n_substeps=2 since round 5) must stay
    # inside the reference envelope even at this worst regime (measured
    # ~3e-7, a 3.3x margin — the CoupledConfig.n_substeps comment);
    # the wider-margin option n=4 keeps the old far-below bound.
    err_default = err_at(cfg.n_substeps)
    assert err_default < 1e-6, err_default
    err_wide = err_at(4)
    assert err_wide < 1e-6, err_wide
    assert err_wide < max(err_ref, 1e-9) * 50 or err_wide < 1e-7, \
        (err_wide, err_ref)
