"""Spectral core tests — formalising the reference's visual checks
(rsw/sw1test.m dealiased products vs oversampled analytic signals)."""

import numpy as np
import jax.numpy as jnp
import pytest

from swraytracing.ops.grid import SpectralGrid
from swraytracing.ops import spectral as sp


@pytest.fixture
def grid():
    return SpectralGrid.square(32)


def random_field(grid, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(grid.shape)
    # band-limit below the Nyquist so round-trips are exact
    fk = np.fft.rfft2(f)
    fk[grid.nx // 2, :] = 0
    fk[:, -1] = 0
    return np.fft.irfft2(fk, s=grid.shape)


def test_roundtrip(grid):
    f = random_field(grid)
    fk = sp.to_spectral(jnp.asarray(f), grid)
    f2 = sp.to_grid(fk, grid)
    np.testing.assert_allclose(np.asarray(f2), f, atol=1e-12)


def test_derivative_analytic(grid):
    X, Y = grid.meshgrid()
    f = np.sin(3 * X) * np.cos(2 * Y)
    fk = sp.to_spectral(jnp.asarray(f), grid)
    fx = sp.to_grid(sp.ddx(fk, grid), grid)
    fy = sp.to_grid(sp.ddy(fk, grid), grid)
    np.testing.assert_allclose(np.asarray(fx), 3 * np.cos(3 * X) * np.cos(2 * Y),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(fy), -2 * np.sin(3 * X) * np.sin(2 * Y),
                               atol=1e-10)


def test_padded_product_exact():
    """Dealiased product of two band-limited fields must equal the
    analytic product's truncation (the rsw/sw1test.m check, in 2-D)."""
    grid = SpectralGrid.square(64)
    X, Y = grid.meshgrid()
    f = np.cos(5 * X + 2 * Y)
    g = np.sin(7 * X - 3 * Y)
    fk = sp.to_spectral(jnp.asarray(f), grid)
    gk = sp.to_spectral(jnp.asarray(g), grid)
    pk = sp.padded_product(fk, gk, grid)
    # analytic product: cos(a)sin(b) = [sin(a+b) - sin(a-b)]/2
    prod = 0.5 * (np.sin(12 * X - Y) - np.sin(-2 * X + 5 * Y))
    pk_true = sp.to_spectral(jnp.asarray(prod), grid)
    np.testing.assert_allclose(np.asarray(pk), np.asarray(pk_true), atol=1e-12)


def test_padded_product_no_aliasing():
    """Modes beyond the resolvable range must not alias back: product of
    two waves at kmax-1 lands at 2*(kmax-1) which must be absent."""
    grid = SpectralGrid.square(32)
    X, _ = grid.meshgrid()
    km = grid.kmax - 1
    f = np.cos(km * X)
    fk = sp.to_spectral(jnp.asarray(f), grid)
    pk = np.asarray(sp.padded_product(fk, fk, grid))
    # f^2 = 1/2 + cos(2 km x)/2; 2km > kmax so only the mean survives
    expected = np.zeros_like(pk)
    expected[0, 0] = 0.5
    np.testing.assert_allclose(pk, expected, atol=1e-12)


def test_refspec_layout_roundtrip(grid):
    f = random_field(grid, 3)
    fk = np.asarray(sp.to_spectral(jnp.asarray(f), grid))
    ref = sp.rfft2_to_refspec(fk, grid)
    assert ref.shape == (2 * grid.kmax + 1, grid.kmax + 1)
    back = sp.refspec_to_rfft2(ref, grid)
    np.testing.assert_allclose(back, fk, atol=1e-14)


def test_refspec_matches_matlab_convention(grid):
    """Our refspec layout must equal MATLAB's
    fftshift(fft2(f))/nx^2 with first row/col dropped (g2k.m:8-9)."""
    f = random_field(grid, 4)
    fk_matlab = np.fft.fftshift(np.fft.fft2(f)) / grid.nx**2
    kmax = grid.kmax
    # MATLAB fkt(2:end, kmax+2:end) in 0-based indexing:
    ref_expected = fk_matlab[1:, kmax + 1:]
    fk = np.asarray(sp.to_spectral(jnp.asarray(f), grid))
    ref = sp.rfft2_to_refspec(fk, grid)
    np.testing.assert_allclose(ref, ref_expected, atol=1e-12)


def test_exp_filter_profile(grid):
    ef = sp.exp_filter(grid)
    assert ef.shape == grid.spectral_shape
    # low wavenumbers untouched
    assert ef[1, 1] == 1.0
    # filter decreases monotonically beyond cutoff along ky axis
    col = ef[0, :]
    kc_idx = int(np.ceil(0.75 * np.pi / (2 * np.pi / grid.ny)))
    tail = col[kc_idx:grid.nky - 1]
    assert np.all(np.diff(tail) <= 1e-15)


def test_isospectrum_ring():
    grid = SpectralGrid.square(64)
    X, Y = grid.meshgrid()
    f = np.cos(3 * X) + np.sin(4 * Y)
    fk = sp.to_spectral(jnp.asarray(f), grid)
    e = np.asarray(sp.isospectrum(jnp.abs(fk) ** 2, grid))
    # cos(3x): two modes amplitude 1/2 -> total |fk|^2 = 2*(1/4) = 1/2 at K=3
    np.testing.assert_allclose(e[2], 0.5, atol=1e-12)
    np.testing.assert_allclose(e[3], 0.5, atol=1e-12)
    assert np.all(np.abs(np.delete(e, [2, 3])) < 1e-12)


def test_1d_padded_product():
    n = 64
    x = 2 * np.pi * np.arange(n) / n
    f = np.cos(5 * x)
    g = np.cos(7 * x)
    fk = sp.to_spectral_1d(jnp.asarray(f), n)
    gk = sp.to_spectral_1d(jnp.asarray(g), n)
    pk = np.asarray(sp.padded_product_1d(fk, gk, n))
    true = sp.to_spectral_1d(jnp.asarray(0.5 * (np.cos(12 * x) + np.cos(2 * x))), n)
    np.testing.assert_allclose(pk, np.asarray(true), atol=1e-12)
