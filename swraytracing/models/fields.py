"""Flow-field abstraction: evaluate U and grad(U) at packet positions.

Redesign of the reference's L2 layer — the RaytracingScheme
class family (/root/reference/RaytracingScheme.m, SpectralScheme.m,
DifferenceScheme.m) and the procedural grid_U + interpolate_U path
(/root/reference/qg_flow_ray_trace/grid_U.m, interpolate_U.m).

Design: each flow is a frozen pytree dataclass (utils/pytree.py) with an
`.at(x, y, alpha)` method returning a FlowEval of (u, v, u_x, u_y, v_x, v_y) at the packet
positions, so fields can be carried through `lax.scan` and `jit`
boundaries. `alpha` in [0, 1] is the within-flow-step time fraction used
for linear blending between two flow snapshots (interpolate_U.m:19-23);
time-independent fields ignore it.

Instead of the reference DifferenceScheme's central finite differences
with h = eps^(1/3) (DifferenceScheme.m:9,20-46), AnalyticFlow derives
velocities and gradients from the streamfunction by JAX autodiff — exact
to machine precision and free of step-size tuning.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from ..utils import pytree as struct

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp
from ..ops.interp import (stencil_and_weights, interp_stencil_apply,
                          build_windows, interp_windowed)

__all__ = [
    "FlowEval",
    "GriddedFlow",
    "BlendedFlow",
    "AnalyticFlow",
    "flow_from_qk",
    "flow_from_psik",
    "flow_from_psi_grid",
]

# Field stacking order used throughout: [u, v, u_x, u_y, v_x, v_y].
U, V, UX, UY, VX, VY = range(6)


class FlowEval(NamedTuple):
    """Velocity and velocity-gradient tensor at packet positions."""

    u: jnp.ndarray
    v: jnp.ndarray
    u_x: jnp.ndarray
    u_y: jnp.ndarray
    v_x: jnp.ndarray
    v_y: jnp.ndarray

    @property
    def uv(self):
        """(2, Np) velocity — coordinate axis FIRST so the packet axis
        stays last (see ops/interp.py layout note)."""
        return jnp.stack([self.u, self.v], axis=0)

    def refraction(self, k):
        """(grad U)^T k — the ray refraction term dk/dt = -(grad U)^T k
        (RaytracingScheme.m:9-16). k is (2, Np) coordinate-first."""
        kk, ll = k[0], k[1]
        return jnp.stack(
            [self.u_x * kk + self.v_x * ll, self.u_y * kk + self.v_y * ll],
            axis=0,
        )

    # Derived diagnostics (RaytracingScheme.m:18-31)
    @property
    def vorticity(self):
        return self.v_x - self.u_y

    @property
    def strain(self):
        return jnp.sqrt((self.u_x - self.v_y) ** 2 + (self.v_x + self.u_y) ** 2)

    @property
    def okubo_weiss(self):
        # sigma^2 - zeta^2 in the standard convention
        return (self.u_x - self.v_y) ** 2 + (self.v_x + self.u_y) ** 2 \
            - (self.v_x - self.u_y) ** 2


@struct.dataclass
class GriddedFlow:
    """Flow given by gridded (u, v, grad U) fields, evaluated off-grid by
    Lagrangian stencil interpolation — the SpectralScheme equivalent."""

    fields: jnp.ndarray  # (6, nx, ny) stacked [u, v, ux, uy, vx, vy]
    grid: SpectralGrid = struct.field(pytree_node=False)
    order: int = struct.field(pytree_node=False, default=2)
    win: jnp.ndarray | None = None  # optional prebuilt windows

    def windowed(self) -> "GriddedFlow":
        """Return a copy with the interpolation windows prebuilt (one
        take-style gather index per packet instead of 36 point gathers —
        see ops/interp.build_windows). Worth it above ~64k packets."""
        return self.replace(win=build_windows(self.fields, self.order))

    def at(self, x, y, alpha=0.0) -> FlowEval:
        if self.win is not None:
            nf = self.fields.shape[0]

            # checkpoint: don't save the gathered (Np, S*S*nf) windows
            # as AD residuals (see BlendedFlow.at).
            @jax.checkpoint
            def eval_w(w, xx, yy):
                return interp_windowed(w, nf, xx, yy, self.grid,
                                       self.order)

            vals = eval_w(self.win, x, y)
            return FlowEval(*vals)
        ix, iy, wx, wy = stencil_and_weights(x, y, self.grid, self.order)
        vals = interp_stencil_apply(self.fields, ix, iy, wx, wy)
        return FlowEval(*vals)

    def velocity_at(self, x, y, alpha=0.0):
        ix, iy, wx, wy = stencil_and_weights(x, y, self.grid, self.order)
        vals = interp_stencil_apply(self.fields[:2], ix, iy, wx, wy)
        return vals[0], vals[1]


@struct.dataclass
class BlendedFlow:
    """Two flow snapshots blended linearly in within-step time `alpha`,
    as the reference's interpolate_U (interpolate_U.m:19-23). The twelve
    per-snapshot interpolations share one stencil computation."""

    fields1: jnp.ndarray  # (6, nx, ny) at step start
    fields2: jnp.ndarray  # (6, nx, ny) at step end
    grid: SpectralGrid = struct.field(pytree_node=False)
    order: int = struct.field(pytree_node=False, default=2)
    win1: jnp.ndarray | None = None  # optional prebuilt windows
    win2: jnp.ndarray | None = None

    def windowed(self) -> "BlendedFlow":
        """Prebuild interpolation windows for both snapshots (once per
        flow step); each eval then blends the window arrays — O(nx*ny)
        bandwidth, noise next to the gather — and does ONE take-style
        gather per packet (ops/interp.build_windows)."""
        return self.replace(win1=build_windows(self.fields1, self.order),
                            win2=build_windows(self.fields2, self.order))

    def at(self, x, y, alpha) -> FlowEval:
        # Blend the GRIDS first, then gather 6 fields: interpolation is
        # linear so this equals blending the 12 gathered values
        # (interpolate_U.m:19-23), at half the gather traffic — the
        # gather is the hot path at 1e6 packets, the O(nx*ny) blend is
        # noise next to it.
        if self.win1 is not None:
            nf = self.fields1.shape[0]

            # checkpoint: without it reverse-mode AD saves every eval's
            # gathered (Np, S*S*nf) windows as residuals — 3.4 GB per
            # substage at 1e6 packets, OOM within one flow step.
            # Recomputing the blend+gather in the backward costs ~30 ms
            # against the already-live win1/win2.
            @jax.checkpoint
            def eval_w(w1, w2, xx, yy, a):
                w = (1.0 - a) * w1 + a * w2
                return interp_windowed(w, nf, xx, yy, self.grid,
                                       self.order)

            vals = eval_w(self.win1, self.win2, x, y, alpha)
            return FlowEval(*vals)
        ix, iy, wx, wy = stencil_and_weights(x, y, self.grid, self.order)
        blended = (1.0 - alpha) * self.fields1 + alpha * self.fields2
        vals = interp_stencil_apply(blended, ix, iy, wx, wy)  # (6, Np)
        return FlowEval(*vals)

    def velocity_at(self, x, y, alpha):
        ix, iy, wx, wy = stencil_and_weights(x, y, self.grid, self.order)
        blended = ((1.0 - alpha) * self.fields1[:2]
                   + alpha * self.fields2[:2])
        vals = interp_stencil_apply(blended, ix, iy, wx, wy)  # (2, Np)
        return vals[0], vals[1]


@struct.dataclass
class AnalyticFlow:
    """Flow defined by an analytic streamfunction psi(x, y, t, *params);
    u = -psi_y, v = psi_x and the gradient tensor come from autodiff.

    Replaces DifferenceScheme.m (finite differences of a psi handle) with
    exact derivatives. `params` is a pytree of traced parameters so the
    flow is differentiable w.r.t. its own coefficients.
    """

    params: Any
    t: jnp.ndarray | float = 0.0
    psi: Callable = struct.field(pytree_node=False, default=None)

    def _point_eval(self, xy):
        def psi_fn(p):
            return self.psi(p[0], p[1], self.t, self.params)

        g = jax.grad(psi_fn)(xy)          # (psi_x, psi_y)
        H = jax.hessian(psi_fn)(xy)       # [[psi_xx, psi_xy], ...]
        u = -g[1]
        v = g[0]
        u_x = -H[0, 1]
        u_y = -H[1, 1]
        v_x = H[0, 0]
        v_y = H[0, 1]
        return jnp.stack([u, v, u_x, u_y, v_x, v_y])

    def at(self, x, y, alpha=0.0) -> FlowEval:
        pts = jnp.stack([x, y], axis=-1)
        vals = jax.vmap(self._point_eval)(pts)  # (Np, 6)
        return FlowEval(*(vals[:, i] for i in range(6)))

    def velocity_at(self, x, y, alpha=0.0):
        def psi_fn(p):
            return self.psi(p[0], p[1], self.t, self.params)

        g = jax.vmap(jax.grad(psi_fn))(jnp.stack([x, y], axis=-1))
        return -g[:, 1], g[:, 0]

    def streamfunction(self, x, y):
        return self.psi(x, y, self.t, self.params)


# ---------------------------------------------------------------------------
# Constructors from spectral state
# ---------------------------------------------------------------------------

def _stack_from_psik(psik, grid: SpectralGrid, shear: float = 0.0,
                     n_fields: int = 6):
    """n_fields=2 builds only (u, v) — the fused packet march with
    uv windows (ops/pallas_window.MarchSpec.grad_from_interp) forms
    grad U in-kernel, so the four gradient-grid inverse transforms
    (half of grid_U.m's spectral work) are skipped entirely."""
    uk = -sp.ddy(psik, grid)
    vk = sp.ddx(psik, grid)
    if n_fields == 2:
        comps = jnp.stack([uk, vk])
    else:
        comps = jnp.stack([
            uk, vk,
            sp.ddx(uk, grid), sp.ddy(uk, grid),
            sp.ddx(vk, grid), sp.ddy(vk, grid),
        ])
    fields = sp.to_grid(comps, grid)  # batched over the components
    if shear:
        fields = fields.at[U].add(shear)
    return fields


def flow_from_qk(qk, grid: SpectralGrid, Kd2: float, shear: float = 0.0,
                 order: int = 2, n_fields: int = 6) -> GriddedFlow:
    """QG PV -> velocity/gradient grids; reference grid_U
    (qg_flow_ray_trace/grid_U.m:1-18): psik = -qk/(K_d2 + K2), u = -psi_y,
    v = psi_x, plus optional uniform shear added to u."""
    denom = jnp.asarray(Kd2 + grid.K2)
    denom = jnp.where(denom == 0, 1.0, denom)  # guard k=0 when Kd2 = 0
    psik = -qk / denom
    return GriddedFlow(fields=_stack_from_psik(psik, grid, shear, n_fields),
                       grid=grid, order=order)


def flow_from_psik(psik, grid: SpectralGrid, order: int = 2) -> GriddedFlow:
    """Streamfunction spectrum -> GriddedFlow; the SpectralScheme
    constructor (SpectralScheme.m:16-35)."""
    return GriddedFlow(fields=_stack_from_psik(psik, grid), grid=grid,
                       order=order)


def flow_from_psi_grid(psi, grid: SpectralGrid, order: int = 2) -> GriddedFlow:
    return flow_from_psik(sp.to_spectral(psi, grid), grid, order)
