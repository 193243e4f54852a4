"""Accuracy probe: gradient fields from the DERIVATIVE OF THE LAGRANGE
INTERPOLANT of (u, v) vs the reference's interpolation of SPECTRALLY
differentiated gradient grids (grid_U.m:1-18 + interpolate.m).

Motivation (PERF.md roofline): the fused-march step is gather-bound —
two take-gathers of 384-float rows (6 fields x 8^2 window), 12.6 ms
each at 1e6 packets. If the windows hold only (u, v), K drops to 128
floats and BOTH snapshots fit one 1 KB-row gather; the kernel then
evaluates u_x etc. by differentiating the 6-point Lagrange basis
(w'_i(fx) w_j(fy) / dx). This probe quantifies what that costs in
accuracy against the exact spectral gradient evaluated directly at the
off-grid points (ops/nufft.eval_spectrum_and_grad_at — machine-exact
for a band-limited field).

Run on CPU with x64. Verdict criterion: the derivative-of-interpolant
error must be within ~an order of magnitude of the interpolated-
spectral-gradient error at production resolution (512^2, filtered QG
spectrum); both are then far below the f32 noise floor the production
runs live at.
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from swraytracing.ops.grid import SpectralGrid
from swraytracing.ops import spectral as sp
from swraytracing.ops.nufft import eval_spectrum_at
from swraytracing.models.qg import initial_q_ring
from swraytracing.models.fields import flow_from_qk
from swraytracing.ops.interp import lagrange_weights

ORDER = 2
S = 2 * ORDER + 2


def lagrange_dweights(frac, order=ORDER):
    """d/dfrac of lagrange_weights via autodiff (exact: polynomials)."""
    f = lambda fr: jnp.stack(lagrange_weights(fr, order))
    return jax.vmap(jax.jacfwd(lambda fr: f(fr)))(frac).T


def interp_with_weights(F, x, y, grid, wx, wy, dwx=None, dwy=None):
    """6x6 Lagrangian eval of (nf,nx,ny) F at points, with optional
    derivative weights replacing the value weights on one axis."""
    nx, ny = grid.nx, grid.ny
    xl = jnp.mod(x / grid.dx, nx)
    yl = jnp.mod(y / grid.dy, ny)
    i0 = jnp.floor(xl).astype(int)
    j0 = jnp.floor(yl).astype(int)
    out = []
    for wa, wb, sc in ((wx, wy, 1.0),
                       (dwx, wy, 1.0 / grid.dx) if dwx is not None else (None, None, 0),
                       (wx, dwy, 1.0 / grid.dy) if dwy is not None else (None, None, 0)):
        if wa is None:
            continue
        acc = 0.0
        for a in range(S):
            ia = jnp.mod(i0 + a - ORDER, nx)
            for b in range(S):
                jb = jnp.mod(j0 + b - ORDER, ny)
                acc = acc + wa[a] * wb[b] * F[:, ia, jb]
        out.append(acc * sc)
    return out


def main(nx=512, n_pts=4096, seed=146):
    grid = SpectralGrid.square(nx)
    qk = initial_q_ring(seed, grid, 0.4, 3.0)
    fl = flow_from_qk(qk, grid, 3.0)
    u, v, ux, uy, vx, vy = [fl.fields[i] for i in range(6)]

    # spectral coefficients of u for the exact off-grid truth
    uxk = sp.to_spectral(ux, grid)
    uyk = sp.to_spectral(uy, grid)

    rng = np.random.default_rng(seed)
    L = grid.nx * grid.dx
    x = jnp.asarray(rng.uniform(0, L, n_pts))
    y = jnp.asarray(rng.uniform(0, L, n_pts))

    # truth: direct spectral evaluation at the points
    ux_true = eval_spectrum_at(uxk, x, y, grid).real
    uy_true = eval_spectrum_at(uyk, x, y, grid).real

    xl = jnp.mod(x / grid.dx, grid.nx)
    yl = jnp.mod(y / grid.dy, grid.ny)
    fx = xl - jnp.floor(xl)
    fy = yl - jnp.floor(yl)
    wx = lagrange_weights(fx, ORDER)
    wy = lagrange_weights(fy, ORDER)
    dwx = list(lagrange_dweights(fx))
    dwy = list(lagrange_dweights(fy))

    F1 = jnp.stack([ux, uy])
    (ref_eval,) = interp_with_weights(F1, x, y, grid, wx, wy)
    ux_ref, uy_ref = ref_eval[0], ref_eval[1]

    Fu = u[None]
    _, ux_di, uy_di = interp_with_weights(Fu, x, y, grid, wx, wy, dwx, dwy)
    ux_di, uy_di = ux_di[0], uy_di[0]

    scale = float(jnp.abs(ux_true).max())
    e_ref = (float(jnp.abs(ux_ref - ux_true).max()) / scale,
             float(jnp.abs(uy_ref - uy_true).max()) / scale)
    e_di = (float(jnp.abs(ux_di - ux_true).max()) / scale,
            float(jnp.abs(uy_di - uy_true).max()) / scale)
    print(f"nx={nx}  max|u_x| = {scale:.3e}")
    print(f"interp(spectral grad)  rel err: ux {e_ref[0]:.3e}  uy {e_ref[1]:.3e}")
    print(f"d/dx(interp u)         rel err: ux {e_di[0]:.3e}  uy {e_di[1]:.3e}")
    print(f"ratio: {e_di[0]/e_ref[0]:.1f}x / {e_di[1]/e_ref[1]:.1f}x")


if __name__ == "__main__":
    for nx in (128, 256, 512):
        main(nx=nx)
