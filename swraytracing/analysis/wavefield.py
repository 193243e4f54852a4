"""Simulated wavefield reconstruction from the packet ensemble.

Implements the visualization the reference sketches but never ran (the
commented block at /root/reference/ray_trace_sw/raytrace_sw.m:204-218):
each packet contributes a plane wave cos(k_p . x - omega_p t) under a
"fiduciary" amplitude envelope A_p(x) centered at the packet position
with peak sqrt(a_p / omega_p) (equipartition: wave action a = E/omega,
surface amplitude ~ sqrt(E/omega) up to the constant the reference
leaves in `ampfunc`), summed over packets and optionally added to the
geostrophic surface eta_g.

Shape: a `lax.scan` over packets accumulating the (nx, ny)
field — the packet counts this diagnostic is used at (the reference
plots tens of packets) never warrant a (Np, nx, ny) broadcast, and the
scan keeps peak memory at one grid regardless of Np.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.grid import SpectralGrid
from ..models.dispersion import Dispersion

__all__ = ["reconstruct_wavefield"]


def reconstruct_wavefield(x, k, grid: SpectralGrid, disp: Dispersion,
                          t=0.0, action=None, width=None, eta_g=None):
    """Sum of enveloped plane waves at the packet phase-space points.

    Args:
      x: (2, Np) packet positions (coordinate-first, carry layout).
      k: (2, Np) wavevectors.
      grid: target grid.
      disp: dispersion (omega_p = sqrt(f^2 + Cg^2 |k_p|^2), the H=1
        form of cg_sw.m:22 — the reference sketch evaluates a local
        depth; pass a modified Dispersion for that).
      t: evaluation time (phase omega*t, raytrace_sw.m:212).
      action: (Np,) wave action a_p; None = 1 for every packet. The
        envelope peak is sqrt(a_p / omega_p) (raytrace_sw.m:210).
      width: Gaussian envelope scale; the reference's `ampfunc` uses
        2*pi/50 of its domain — default L/50 here.
      eta_g: optional (nx, ny) geostrophic surface to add
        (raytrace_sw.m:216 plots etag + etaw).
    Returns:
      (nx, ny) wavefield (plus eta_g if given).
    """
    if width is None:
        width = grid.Lx / 50.0
    X, Y = grid.meshgrid()
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    om = disp.omega(k)
    a = jnp.ones(x.shape[-1], X.dtype) if action is None \
        else jnp.asarray(action)
    amax = jnp.sqrt(jnp.maximum(a, 0.0) / om)
    t = jnp.asarray(t, X.dtype)

    def add_packet(eta, p):
        xp, yp, kx, ky, w, A = p
        # periodic displacement: nearest-image Gaussian envelope
        dx = jnp.mod(X - xp + grid.Lx / 2, grid.Lx) - grid.Lx / 2
        dy = jnp.mod(Y - yp + grid.Ly / 2, grid.Ly) - grid.Ly / 2
        env = A * jnp.exp(-(dx * dx + dy * dy) / (2.0 * width**2))
        # phase anchored at the packet (the reference's k*x_ + l*y_
        # global phase makes the pattern translate through the
        # envelope; anchoring at the packet keeps the local
        # wavenumber identical and the packet crest-centered)
        return eta + env * jnp.cos(kx * dx + ky * dy - w * t), None

    ps = jnp.stack([x[0], x[1], k[0], k[1], om, amax], axis=-1)
    eta0 = jnp.zeros(grid.shape, X.dtype)
    eta, _ = lax.scan(add_packet, eta0, ps)
    return eta if eta_g is None else eta + jnp.asarray(eta_g)
