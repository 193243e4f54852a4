"""Interpolation tests — formalising the reference's comparison scripts
(scratch/interpolate_test.m, scratch/fourier_interpolate_test.m,
why_isnt_interpolate2_working.m): Lagrangian stencil vs direct Fourier
(NUFFT) evaluation on band-limited fields."""

import numpy as np
import jax
import jax.numpy as jnp

from swraytracing.ops.grid import SpectralGrid
from swraytracing.ops import spectral as sp
from swraytracing.ops.interp import (
    lagrange_weights, interpolate, interpolate_stack)
from swraytracing.ops.nufft import eval_spectrum_at, eval_spectrum_and_grad_at


def test_weights_partition_of_unity():
    fr = jnp.linspace(0.0, 0.999, 37)
    w = lagrange_weights(fr, order=2)
    assert w.shape == (6, 37)  # node axis first, packet axis last
    np.testing.assert_allclose(np.asarray(w.sum(0)), 1.0, atol=1e-12)


def test_weights_nodal():
    """At frac=0 the weight must be 1 on the left node, 0 elsewhere."""
    w = np.asarray(lagrange_weights(jnp.array([0.0]), order=2))[:, 0]
    expected = np.zeros(6)
    expected[2] = 1.0  # node offset 0 is index 2 in offsets -2..3
    np.testing.assert_allclose(w, expected, atol=1e-12)


def test_polynomial_reproduction():
    """Order-2 (6-point) Lagrangian interp is exact for degree<=5
    polynomials of the grid coordinate (within one period)."""
    grid = SpectralGrid.square(64)
    xg = grid.x
    # polynomial in the periodic sense: use a smooth band-limited field
    f = np.sin(2 * xg)[:, None] * np.cos(3 * grid.y)[None, :]
    rng = np.random.default_rng(0)
    xp = rng.uniform(-np.pi, np.pi, 200)
    yp = rng.uniform(-np.pi, np.pi, 200)
    fi = np.asarray(interpolate(jnp.asarray(f), jnp.asarray(xp),
                                jnp.asarray(yp), grid))
    exact = np.sin(2 * xp) * np.cos(3 * yp)
    # 6th-order accurate: at nx=64 and k<=3, error ~ (k dx)^6 ~ 1e-6
    np.testing.assert_allclose(fi, exact, atol=5e-6)


def test_matches_reference_algorithm():
    """Bit-for-bit match (modulo the bump constant) of the reference's
    per-particle loop (qg_flow_ray_trace/interpolate.m), re-run here in
    numpy."""
    grid = SpectralGrid.square(16)
    rng = np.random.default_rng(1)
    F = rng.standard_normal(grid.shape)
    xp = rng.uniform(-10, 10, 25)
    yp = rng.uniform(-10, 10, 25)

    def reference_interp(x, y, F, dx, dy):
        Iord = 2
        nx, ny = F.shape
        out = np.zeros_like(x)
        for m in range(len(x)):
            xl = np.mod(x[m] / dx, nx)
            yl = np.mod(y[m] / dy, ny)
            i0 = 1 + np.floor(xl)
            j0 = 1 + np.floor(yl)
            ax = 1 + xl - i0
            ay = 1 + yl - j0
            wx = np.ones(2 * (Iord + 1))
            wy = np.ones(2 * (Iord + 1))
            for i in range(-Iord, Iord + 2):
                for j in range(-Iord, Iord + 2):
                    if i != j:
                        wx[i + Iord] *= (ax - j) / (j - i)
                        wy[i + Iord] *= (ay - j) / (j - i)
            for i in range(-Iord, Iord + 2):
                for j in range(-Iord, Iord + 2):
                    ig = int(np.mod(i0 + i - 1, nx))
                    jg = int(np.mod(j0 + j - 1, nx))
                    out[m] += wx[i + Iord] * wy[j + Iord] * F[ig, jg]
        return out

    ours = np.asarray(interpolate(jnp.asarray(F), jnp.asarray(xp),
                                  jnp.asarray(yp), grid))
    ref = reference_interp(xp, yp, F, grid.dx, grid.dy)
    np.testing.assert_allclose(ours, ref, atol=1e-12)


def test_against_nufft():
    """Lagrangian interp converges to the direct spectral evaluation —
    the fourier_interpolate_test.m check."""
    grid = SpectralGrid.square(128)
    rng = np.random.default_rng(2)
    # smooth random band-limited field (modes <= 6)
    fk = np.zeros(grid.spectral_shape, dtype=complex)
    for k in range(-6, 7):
        for l in range(0, 7):
            fk[k % grid.nx, l] = (rng.standard_normal()
                                  + 1j * rng.standard_normal()) * 0.1
    fk[:, 0] = 0
    fk = jnp.asarray(fk * grid.nyquist_mask)
    f = sp.to_grid(fk, grid)
    xp = jnp.asarray(rng.uniform(-3, 3, 100))
    yp = jnp.asarray(rng.uniform(-3, 3, 100))
    fi = interpolate(f, xp, yp, grid)
    fs = eval_spectrum_at(fk, xp, yp, grid)
    # 6-point Lagrangian truncation error ~ (k_max dx)^6 ~ 6e-4 relative
    np.testing.assert_allclose(np.asarray(fi), np.asarray(fs), atol=5e-5)


def test_nufft_matches_grid():
    grid = SpectralGrid.square(32)
    X, Y = grid.meshgrid()
    f = np.cos(2 * X + 3 * Y) + 0.3 * np.sin(5 * Y)
    fk = sp.to_spectral(jnp.asarray(f), grid)
    vals = eval_spectrum_at(fk, jnp.asarray(X.ravel()), jnp.asarray(Y.ravel()),
                            grid)
    np.testing.assert_allclose(np.asarray(vals), f.ravel(), atol=1e-10)
    v, vx, vy = eval_spectrum_and_grad_at(
        fk, jnp.asarray(X.ravel()), jnp.asarray(Y.ravel()), grid)
    np.testing.assert_allclose(np.asarray(vx),
                               (-2 * np.sin(2 * X + 3 * Y)).ravel(), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(vy),
        (-3 * np.sin(2 * X + 3 * Y) + 1.5 * np.cos(5 * Y)).ravel(), atol=1e-9)


def test_stack_matches_single():
    grid = SpectralGrid.square(32)
    rng = np.random.default_rng(3)
    F = jnp.asarray(rng.standard_normal((4,) + grid.shape))
    xp = jnp.asarray(rng.uniform(-3, 3, 50))
    yp = jnp.asarray(rng.uniform(-3, 3, 50))
    stacked = interpolate_stack(F, xp, yp, grid)
    for i in range(4):
        single = interpolate(F[i], xp, yp, grid)
        np.testing.assert_allclose(np.asarray(stacked[i]), np.asarray(single),
                                   atol=1e-14)


def test_gradients_wrt_positions_and_field():
    """Autodiff through the gather: d/dx matches the analytic derivative,
    and d/dF is a valid linearisation."""
    grid = SpectralGrid.square(64)
    X, Y = grid.meshgrid()
    f = jnp.asarray(np.sin(2 * X) * np.cos(Y))

    def val(x):
        return interpolate(f, x[None], jnp.asarray([0.3]), grid)[0]

    x0 = 0.731
    g = jax.grad(val)(jnp.asarray(x0))
    exact = 2 * np.cos(2 * x0) * np.cos(0.3)
    np.testing.assert_allclose(float(g), exact, rtol=1e-4)

    def valF(F):
        return interpolate(F, jnp.asarray([0.5]), jnp.asarray([1.1]), grid)[0]

    gF = jax.grad(valF)(f)
    # directional derivative check
    dF = jnp.asarray(np.random.default_rng(4).standard_normal(grid.shape))
    eps = 1e-6
    fd = (valF(f + eps * dF) - valF(f - eps * dF)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(gF, dF)), float(fd), rtol=1e-6)


def test_cubic_interpolation_accuracy():
    """interpolate_cubic (the corrected interpolate2.m) reproduces nodes
    exactly and converges on smooth fields; the 6-point Lagrangian
    stencil stays more accurate (higher order)."""
    import numpy as np
    import jax.numpy as jnp
    from swraytracing.ops.grid import SpectralGrid
    from swraytracing.ops.interp import interpolate, interpolate_cubic

    grid = SpectralGrid.square(64)
    X, Y = grid.meshgrid()
    F = jnp.asarray(np.sin(3 * X) * np.cos(2 * Y))
    # node reproduction
    xg = jnp.asarray(grid.x[5:9])
    yg = jnp.asarray(grid.y[11:15])
    got = interpolate_cubic(F, xg, yg, grid)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(F)[5:9, 11:15].diagonal(),
                               atol=1e-13)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0, 2 * np.pi, 300))
    y = jnp.asarray(rng.uniform(0, 2 * np.pi, 300))
    exact = np.sin(3 * np.asarray(x)) * np.cos(2 * np.asarray(y))
    errc = np.abs(np.asarray(interpolate_cubic(F, x, y, grid)) - exact).max()
    errl = np.abs(np.asarray(interpolate(F, x, y, grid)) - exact).max()
    assert errc < 1e-3
    assert errl < errc  # 6-point Lagrangian beats bicubic


def test_chunked_gather_matches_unchunked(monkeypatch):
    """The large-Np chunked gather path (ops.interp._GATHER_CHUNK) must be
    numerically identical to the single-gather path, including through
    padding of a non-multiple packet count, and differentiable."""
    import jax
    from swraytracing.ops import interp as interp_mod

    grid = SpectralGrid.square(32)
    X, Y = grid.meshgrid()
    F = jnp.stack([jnp.asarray(np.cos(X) * np.sin(2 * Y)),
                   jnp.asarray(np.sin(X + Y))])
    rng = np.random.default_rng(3)
    n = 1000  # not a multiple of the patched chunk
    xp = jnp.asarray(rng.uniform(0, 2 * np.pi, n))
    yp = jnp.asarray(rng.uniform(0, 2 * np.pi, n))

    big = interpolate_stack(F, xp, yp, grid)
    monkeypatch.setattr(interp_mod, "_GATHER_CHUNK", 128)
    chunked = interpolate_stack(F, xp, yp, grid)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(big),
                               rtol=1e-12, atol=1e-12)

    def loss(f):
        return jnp.sum(interpolate_stack(f, xp, yp, grid) ** 2)

    g = jax.grad(loss)(F)
    monkeypatch.undo()
    g0 = jax.grad(loss)(F)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g0),
                               rtol=1e-11, atol=1e-12)


def test_windowed_matches_stencil(monkeypatch):
    """The windowed gather path (build_windows + interp_windowed — one
    take-style index per packet) must match the 36-point stencil path,
    including through the chunked branch and padding, and stay
    differentiable w.r.t. the field."""
    from swraytracing.ops import interp as interp_mod
    from swraytracing.ops.interp import build_windows, interp_windowed

    grid = SpectralGrid.square(32)
    X, Y = grid.meshgrid()
    F = jnp.stack([jnp.asarray(np.cos(X) * np.sin(2 * Y)),
                   jnp.asarray(np.sin(X + Y)),
                   jnp.asarray(np.cos(3 * X))])
    rng = np.random.default_rng(7)
    n = 999  # not a multiple of the patched chunk
    xp = jnp.asarray(rng.uniform(-5.0, 15.0, n))  # exercises periodic wrap
    yp = jnp.asarray(rng.uniform(-5.0, 15.0, n))

    ref = interpolate_stack(F, xp, yp, grid)
    W = build_windows(F)
    got = interp_windowed(W, 3, xp, yp, grid)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)

    monkeypatch.setattr(interp_mod, "_GATHER_CHUNK", 128)
    got_chunked = interp_windowed(W, 3, xp, yp, grid)
    np.testing.assert_allclose(np.asarray(got_chunked), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)

    def loss_windowed(f):
        return jnp.sum(interp_windowed(build_windows(f), 3, xp, yp,
                                       grid) ** 2)

    def loss_stencil(f):
        return jnp.sum(interpolate_stack(f, xp, yp, grid) ** 2)

    gw = jax.grad(loss_windowed)(F)
    gs = jax.grad(loss_stencil)(F)
    np.testing.assert_allclose(np.asarray(gw), np.asarray(gs),
                               rtol=1e-10, atol=1e-12)


def test_windowed_flow_classes_match():
    """GriddedFlow.windowed() / BlendedFlow.windowed() evaluate exactly
    like their stencil-path counterparts."""
    from swraytracing.models.fields import GriddedFlow, BlendedFlow

    grid = SpectralGrid.square(32)
    X, Y = grid.meshgrid()
    rng = np.random.default_rng(11)
    f1 = jnp.asarray(rng.standard_normal((6, 32, 32)))
    f2 = jnp.asarray(rng.standard_normal((6, 32, 32)))
    xp = jnp.asarray(rng.uniform(0, 2 * np.pi, 200))
    yp = jnp.asarray(rng.uniform(0, 2 * np.pi, 200))

    g = GriddedFlow(fields=f1, grid=grid)
    ev_a = g.at(xp, yp)
    ev_b = g.windowed().at(xp, yp)
    np.testing.assert_allclose(np.asarray(ev_b.uv), np.asarray(ev_a.uv),
                               rtol=1e-12, atol=1e-12)

    b = BlendedFlow(fields1=f1, fields2=f2, grid=grid)
    ev_a = b.at(xp, yp, 0.3)
    ev_b = b.windowed().at(xp, yp, 0.3)
    for va, vb in zip(ev_a, ev_b):
        np.testing.assert_allclose(np.asarray(vb), np.asarray(va),
                                   rtol=1e-12, atol=1e-12)
