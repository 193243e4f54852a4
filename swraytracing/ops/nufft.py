"""Direct (NUFFT-style, type-2) evaluation of half-plane spectra at
arbitrary points.

The reference prototypes this in scratch/fourier_interpolate_test.m as the
ground-truth alternative to Lagrangian stencil interpolation. Here it is a
first-class differentiable path: the evaluation is two complex matmuls per
packet batch, run at HIGHEST precision (a float32 matmul may otherwise
run in TF32 on a GPU), and gradients w.r.t. the spectral
coefficients flow through linearly — this is the
"differentiable-in-spectrum" evaluation demanded for flow-parameter
gradients, where the stencil gather's grid fields would otherwise have to
be re-differentiated through an inverse FFT.

Cost is O(Np * nx * nky), so use for validation and for moderate mode
counts; the Lagrangian gather (ops/interp.py) is the production hot path.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

from .grid import SpectralGrid

__all__ = ["eval_spectrum_at", "eval_spectrum_and_grad_at"]

_HIGHEST = lax.Precision.HIGHEST


def _phase_matrices(x, y, grid: SpectralGrid, dtype):
    kx = jnp.asarray(grid.kx[:, 0], dtype=dtype)   # (nx,)
    ky = jnp.asarray(grid.ky[0, :], dtype=dtype)   # (nky,)
    ax = jnp.exp(1j * x[:, None] * kx[None, :])    # (Np, nx)
    ay = jnp.exp(1j * y[:, None] * ky[None, :])    # (Np, nky)
    return ax, ay


def _halfplane_weights(grid: SpectralGrid):
    w = np.full((grid.nky,), 2.0)
    w[0] = 1.0
    if grid.ny % 2 == 0:
        w[-1] = 1.0  # Nyquist column is not doubled (masked anyway)
    return w


def eval_spectrum_at(fk, x, y, grid: SpectralGrid):
    """Evaluate real field with half-plane spectrum `fk` at points (x, y).

    f(x) = Re sum_k fk e^{i k.x}, with ky>0 columns double-counted for the
    conjugate half-plane. Matches to_grid() exactly at grid points.

    Args:
      fk: (nx, nky) complex spectrum (our normalisation, see ops.spectral).
      x, y: (Np,) positions.
    Returns: (Np,) real values.
    """
    real_dtype = jnp.real(fk).dtype
    ax, ay = _phase_matrices(x.astype(real_dtype), y.astype(real_dtype),
                             grid, fk.dtype)
    fkw = fk * jnp.asarray(_halfplane_weights(grid), dtype=fk.dtype)
    t = jnp.matmul(ax, fkw, precision=_HIGHEST)   # (Np, nky)
    return jnp.real(jnp.sum(t * ay, axis=-1))


def eval_spectrum_and_grad_at(fk, x, y, grid: SpectralGrid):
    """Evaluate f, df/dx, df/dy at points in one pass (shared phase
    matrices)."""
    real_dtype = jnp.real(fk).dtype
    ax, ay = _phase_matrices(x.astype(real_dtype), y.astype(real_dtype),
                             grid, fk.dtype)
    w = jnp.asarray(_halfplane_weights(grid), dtype=fk.dtype)
    ikx = jnp.asarray(1j * grid.kx, dtype=fk.dtype)
    iky = jnp.asarray(1j * grid.ky, dtype=fk.dtype)
    mm = functools.partial(jnp.matmul, precision=_HIGHEST)
    f = jnp.real(jnp.sum(mm(ax, fk * w) * ay, axis=-1))
    fx = jnp.real(jnp.sum(mm(ax, fk * ikx * w) * ay, axis=-1))
    fy = jnp.real(jnp.sum(mm(ax, fk * iky * w) * ay, axis=-1))
    return f, fx, fy
