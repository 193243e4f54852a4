"""Spectral transform core (layer L0 of the reference).

One shared module replacing the reference's copy-pasted g2k/k2g/fulspec
family (/root/reference/qg_flow_ray_trace/{g2k,k2g,fulspec}.m and the
duplicates inlined in rsw/swk.m:267-313 etc.).

Layout: `jnp.fft.rfft2` half-plane, shape (nx, ny//2+1). Normalisation
matches the reference (forward divides by nx*ny, inverse multiplies), so
spectral coefficients are directly comparable with MATLAB outputs after
the layout conversion helpers below.

Dealiased products use plain 3/2 zero-padding instead of the reference's
staggered-grid Orszag trick (rsw/swk.m:92-100, 221-263): one padded FFT
replaces two packed grids, and the result is identical (exact
de-aliasing of quadratic products).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .grid import SpectralGrid

__all__ = [
    "to_spectral",
    "to_grid",
    "ddx",
    "ddy",
    "enforce_hermitian",
    "refspec_to_rfft2",
    "rfft2_to_refspec",
    "exp_filter",
    "padded_product",
    "dealiased_jacobian",
    "isospectrum",
    "to_spectral_1d",
    "to_grid_1d",
    "padded_product_1d",
]


# ---------------------------------------------------------------------------
# Basic transforms (g2k / k2g equivalents): jnp.fft.rfft2 / irfft2
# ---------------------------------------------------------------------------

def to_spectral(f, grid: SpectralGrid):
    """Grid -> half-plane spectrum; reference g2k
    (qg_flow_ray_trace/g2k.m:1-10), with Nyquist modes zeroed to match the
    reference's truncated mode set."""
    fk = jnp.fft.rfft2(f) / (grid.nx * grid.ny)
    return fk * jnp.asarray(grid.nyquist_mask, dtype=fk.dtype)


def to_grid(fk, grid: SpectralGrid):
    """Half-plane spectrum -> grid; reference k2g
    (qg_flow_ray_trace/k2g.m:1-9). Assumes the ky=0 column is Hermitian
    (true for spectra of real fields; use enforce_hermitian otherwise)."""
    return jnp.fft.irfft2(fk, s=(grid.nx, grid.ny)) * (grid.nx * grid.ny)


def ddx(fk, grid: SpectralGrid):
    """Spectral d/dx (i*kx multiply), cf. rsw/dxk.m."""
    return fk * jnp.asarray(1j * grid.kx, dtype=fk.dtype)


def ddy(fk, grid: SpectralGrid):
    return fk * jnp.asarray(1j * grid.ky, dtype=fk.dtype)


def enforce_hermitian(fk, grid: SpectralGrid):
    """Project the kx content of the ky=0 (and Nyquist-ky, if present)
    columns onto Hermitian symmetry so irfft2 sees a consistent spectrum.

    The reference builds this symmetry by construction in fulspec.m:16-17;
    here it is needed only when a spectrum is assembled by hand.
    """
    fk = jnp.asarray(fk)
    col0 = fk[:, 0]
    sym = 0.5 * (col0 + jnp.conj(jnp.roll(col0[::-1], 1)))
    fk = fk.at[:, 0].set(sym)
    if grid.ny % 2 == 0:
        coln = fk[:, -1]
        symn = 0.5 * (coln + jnp.conj(jnp.roll(coln[::-1], 1)))
        fk = fk.at[:, -1].set(symn)
    return fk


# ---------------------------------------------------------------------------
# Layout conversion to/from the reference's fftshifted half-plane
# ---------------------------------------------------------------------------

def refspec_to_rfft2(fk_ref, grid: SpectralGrid):
    """Convert a reference-layout spectrum (2*kmax+1, kmax+1), kx in
    [-kmax, kmax] (shifted), ky in [0, kmax], into the rfft2 layout.

    Used to ingest spectral .bin frames written by the MATLAB code
    (read_field.m spectral mode: nx == 2*ny - 1).
    """
    kmax = grid.kmax
    out = np.zeros(grid.spectral_shape, dtype=np.complex128)
    fk_ref = np.asarray(fk_ref)
    # rows of fk_ref: kx = -kmax..kmax -> rfft2 row index kx mod nx
    for i, kx in enumerate(range(-kmax, kmax + 1)):
        out[kx % grid.nx, : kmax + 1] = fk_ref[i, :]
    return out


def rfft2_to_refspec(fk, grid: SpectralGrid):
    """Inverse of refspec_to_rfft2 (for writing reference-compatible
    spectral frames)."""
    kmax = grid.kmax
    fk = np.asarray(fk)
    out = np.zeros((2 * kmax + 1, kmax + 1), dtype=np.complex128)
    for i, kx in enumerate(range(-kmax, kmax + 1)):
        out[i, :] = fk[kx % grid.nx, : kmax + 1]
    return out


# ---------------------------------------------------------------------------
# Spectral filters
# ---------------------------------------------------------------------------

def exp_filter(grid: SpectralGrid, cutoff: float = 0.75 * np.pi,
               decay_width: float = 0.25 * np.pi,
               floor: float = 1e-15) -> np.ndarray:
    """Exponential spectral filter of the reference QG solver
    (qgsw_raytrace.m:222-230): E(k*) = exp(log(floor)/width^4 *
    (k* - kc)^4) for k* >= kc, 1 otherwise, with k* = |k| * dx.

    Returns a static numpy array (nx, nky) to be closed over by jitted
    steppers.
    """
    ikx = np.fft.fftfreq(grid.nx, d=1.0 / grid.nx)[:, None]
    iky = np.arange(grid.nky)[None, :]
    # k* uses the *integer* wavenumber times dx, as the reference's
    # kstar = sqrt((kx*dx)^2+(ky*dx)^2) with integer kx_, ky_ and dx=L/nx.
    kstar = np.sqrt((ikx * (2 * np.pi / grid.nx)) ** 2
                    + (iky * (2 * np.pi / grid.ny)) ** 2)
    const = np.log(floor) / decay_width**4
    ef = np.where(kstar >= cutoff, np.exp(const * (kstar - cutoff) ** 4), 1.0)
    return ef * grid.nyquist_mask


# ---------------------------------------------------------------------------
# Dealiased products (3/2-rule zero padding)
# ---------------------------------------------------------------------------

def _pad_spectrum(fk, grid: SpectralGrid, mx: int, my_half: int):
    """Zero-pad an rfft2 spectrum (nx, nky) to (mx, my_half)."""
    nx, nky = grid.nx, grid.nky
    out = jnp.zeros((mx, my_half), dtype=fk.dtype)
    h = nx // 2
    out = out.at[:h, :nky].set(fk[:h, :])
    out = out.at[mx - h:, :nky].set(fk[nx - h:, :])
    return out


def _unpad_spectrum(fk_big, grid: SpectralGrid, mx: int):
    nx, nky = grid.nx, grid.nky
    h = nx // 2
    top = fk_big[:h, :nky]
    bot = fk_big[mx - h:, :nky]
    mid = jnp.zeros((nx - 2 * h, nky), dtype=fk_big.dtype)
    return jnp.concatenate([top, mid, bot], axis=0)


def padded_grid(grid: SpectralGrid) -> SpectralGrid:
    """The 3/2-padded companion grid used for dealiased products."""
    return SpectralGrid(nx=3 * grid.nx // 2, ny=3 * grid.ny // 2,
                        Lx=grid.Lx, Ly=grid.Ly)


def padded_product(fk, gk, grid: SpectralGrid):
    """Exactly dealiased spectral product: returns spectrum of f*g.

    Replacement for the reference's staggered-grid Orszag
    machinery (rsw/swk.m:221-263 k2gp/gprod/gp2k): both factors are
    zero-padded to 3/2 resolution, multiplied on the fine grid, and
    truncated back. Quadratic aliasing cancels identically.
    """
    big = padded_grid(grid)
    mx, myh = big.nx, big.nky
    # to_grid/to_spectral on the padded grid: their 1/N^2
    # normalisations cancel through the product.
    fbig = to_grid(_pad_spectrum(fk, grid, mx, myh), big)
    gbig = to_grid(_pad_spectrum(gk, grid, mx, myh), big)
    pk = to_spectral(fbig * gbig, big)
    return _unpad_spectrum(pk, grid, mx) * jnp.asarray(
        grid.nyquist_mask, dtype=fk.dtype)


def dealiased_jacobian(ak, bk, grid: SpectralGrid, dealias: bool = True):
    """Spectral Jacobian J(a, b) = a_x b_y - a_y b_x.

    dealias=False reproduces the reference QG solver's plain (aliased)
    pseudo-spectral Jacobian (qgsw_raytrace.m:272-283); True uses the
    3/2-rule product.
    """
    akx, aky = ddx(ak, grid), ddy(ak, grid)
    bkx, bky = ddx(bk, grid), ddy(bk, grid)
    if dealias:
        return padded_product(akx, bky, grid) - padded_product(aky, bkx, grid)
    ax, ay = to_grid(akx, grid), to_grid(aky, grid)
    bx, by = to_grid(bkx, grid), to_grid(bky, grid)
    return to_spectral(ax * by - ay * bx, grid)


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def isospectrum(fk2, grid: SpectralGrid):
    """Azimuthal ring-sum of a half-plane spectral density.

    Reference: rsw/isospectrum.m (which operates on the full plane); here
    the ky>0 half-plane is double-counted to account for the conjugate
    half, matching the full-plane sum for densities of real fields.

    Args:
      fk2: real spectral density on the rfft2 half-plane (e.g. |fk|^2).
    Returns:
      (kmax,) array, ring K=1..kmax sums.
    """
    ikx = np.fft.fftfreq(grid.nx, d=1.0 / grid.nx)[:, None]
    iky = np.arange(grid.nky)[None, :]
    Kround = np.floor(np.sqrt(ikx**2 + iky**2) + 0.5).astype(np.int32)
    # double-count interior ky>0 columns (conjugate half-plane)
    weight = np.where((iky > 0) & (iky < grid.ny - iky), 2.0, 1.0)
    kmax = grid.kmax
    rings = jnp.zeros((kmax + 1,), dtype=fk2.dtype)
    flat_bins = jnp.asarray(np.minimum(Kround, kmax).ravel())
    valid = jnp.asarray((Kround <= kmax).ravel().astype(np.float64))
    vals = (fk2 * jnp.asarray(weight)).ravel() * valid
    rings = rings.at[flat_bins].add(vals)
    return rings[1:]


# ---------------------------------------------------------------------------
# 1-D transforms (for the sw1/ybj1d family)
# ---------------------------------------------------------------------------

def to_spectral_1d(f, n: int):
    return jnp.fft.rfft(f) / n


def to_grid_1d(fk, n: int):
    return jnp.fft.irfft(fk, n=n) * n


def padded_product_1d(fk, gk, n: int):
    """1-D dealiased product via 3/2-rule padding (reference
    rsw/sw1d.m:30-33 KMAXBIG = 3*(KMAX+1)/2-1 zero-padding)."""
    m = 3 * n // 2
    nk = n // 2 + 1
    mk = m // 2 + 1
    pad = jnp.zeros((mk,), dtype=fk.dtype)
    fb = pad.at[:nk].set(fk)
    gb = pad.at[:nk].set(gk)
    fg = jnp.fft.irfft(fb, n=m) * m
    gg = jnp.fft.irfft(gb, n=m) * m
    pk = jnp.fft.rfft(fg * gg) / m
    return pk[:nk]
