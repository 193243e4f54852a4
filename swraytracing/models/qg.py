"""One-layer quasi-geostrophic pseudo-spectral solver.

Re-design of the solver inlined in
/root/reference/qg_flow_ray_trace/qgsw_raytrace.m:
  * PV inversion psi_k = -q_k / (K_d^2 + K^2)            (:271)
  * pseudo-spectral Jacobian                              (:272-283)
  * AB3 time stepping with forward-Euler / AB2 bootstrap  (:121-136)
  * exponential spectral filter applied every step        (:137, :222-230)
  * beta, linear drag, inertial-ring surface forcing      (:285, :216-220)
  * random-phase ring initial PV normalised to max speed  (:191-214)

State is a pytree scanned with `lax.scan`; the RHS is 4 inverse + 1
forward real FFT per step (the reference spends 6 complex FFTs).

Reference quirks (see SURVEY.md §4) and how we treat them:
  * qgsw_raytrace.m:285 adds `r_drag*K2` and the forcing as *constants*
    (missing `.*qk`), i.e. a static spectral forcing rather than drag;
    and the Jacobian enters with a reversed advection sign relative to
    u = -psi_y, v = psi_x. `reference_quirks=True` reproduces both
    exactly — including the fact that the literal committed RHS is
    violently unstable (the O(r_drag*K2) injection at every sub-filter
    mode produces |u| ~ 25 after ONE step at 64^2 and NaN within ~50;
    the committed production run.logs must predate this line). The
    default implements the evidently intended physics
    q_t + J(psi, q) + beta v = forcing - r_drag * zeta.
  * initial_q's chained comparison `k_min^2 < K2 <= k_max^2`
    (qgsw_raytrace.m:202) is always true in MATLAB, so the "ring" IC
    actually fills the whole square |k|,|l| <= k_max; pass
    `ring=False` to reproduce that.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from ..utils import pytree as struct

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp

__all__ = [
    "QGParams",
    "QGState",
    "qg_rhs",
    "qg_init",
    "qg_step",
    "simulate_qg",
    "simulate_qg_particles",
    "initial_q_ring",
    "inertial_ring_forcing",
    "max_speed",
]


class QGParams(NamedTuple):
    """Static-ish solver parameters (arrays are closed over by jit)."""

    Kd2: float                  # deformation wavenumber squared, f/Cg in ref
    beta: float = 0.0
    r_drag: float = 0.1
    dt: float = 1e-3
    forcing: jnp.ndarray | None = None   # (nx, nky) static spectral forcing
    filter: jnp.ndarray | None = None    # (nx, nky) per-step spectral filter
    dealias: bool = False                # reference uses no dealiasing
    reference_quirks: bool = False


@struct.dataclass
class QGState:
    qk: jnp.ndarray       # (nx, nky) complex PV spectrum
    rhs_m1: jnp.ndarray   # previous RHS (AB history)
    rhs_m2: jnp.ndarray   # RHS two steps back
    t: jnp.ndarray        # scalar time
    step: jnp.ndarray     # scalar int32 step counter


def _psik(qk, grid: SpectralGrid, Kd2):
    denom = jnp.asarray(Kd2 + grid.K2)
    denom = jnp.where(denom == 0, 1.0, denom)
    return -qk / denom


def qg_rhs(qk, grid: SpectralGrid, p: QGParams):
    """dq_k/dt. See module docstring for the quirks switch."""
    psik = _psik(qk, grid, p.Kd2)
    Jk = sp.dealiased_jacobian(psik, qk, grid, dealias=p.dealias)
    beta_term = p.beta * sp.ddx(psik, grid)
    if p.reference_quirks:
        # qgsw_raytrace.m:285 verbatim: dq = J - beta*psikx + r*K2 + F
        dq = Jk - beta_term + p.r_drag * jnp.asarray(grid.K2, qk.dtype)
    else:
        # q_t = -J(psi,q) - beta psi_x - r_drag * zeta,  zeta_k = -K2 psi_k
        drag = p.r_drag * jnp.asarray(grid.K2) * psik
        dq = -Jk - beta_term + drag
    if p.forcing is not None:
        dq = dq + p.forcing
    return dq


def qg_init(qk0, t0: float = 0.0) -> QGState:
    def build(q):
        z = jnp.zeros_like(q)
        return QGState(qk=q, rhs_m1=z, rhs_m2=z,
                       t=jnp.asarray(t0, jnp.real(q).dtype),
                       step=jnp.asarray(0, jnp.int32))

    return jax.jit(build)(qk0)


def qg_step(state: QGState, grid: SpectralGrid, p: QGParams) -> QGState:
    """One AB3 step with Euler/AB2 bootstrap (qgsw_raytrace.m:121-137)."""
    Qn = qg_rhs(state.qk, grid, p)
    dt = p.dt

    def euler(_):
        return dt * Qn

    def ab2(_):
        return dt / 2.0 * (3.0 * Qn - state.rhs_m1)

    def ab3(_):
        return dt / 12.0 * (23.0 * Qn - 16.0 * state.rhs_m1
                            + 5.0 * state.rhs_m2)

    dq = lax.switch(jnp.minimum(state.step, 2), [euler, ab2, ab3], None)
    qk = state.qk + dq
    if p.filter is not None:
        qk = qk * jnp.asarray(p.filter, qk.dtype)
    return QGState(qk=qk, rhs_m1=Qn, rhs_m2=state.rhs_m1,
                   t=state.t + dt, step=state.step + 1)


def simulate_qg(state: QGState, grid: SpectralGrid, p: QGParams,
                nsteps: int, save_every: int = 1):
    """Run nsteps, saving the PV spectrum every save_every steps.

    Returns (final_state, qk_frames (nframes, nx, nky), t_frames).
    """
    nframes = nsteps // save_every

    def frame(st, _):
        def body(i, s):
            return qg_step(s, grid, p)

        st = lax.fori_loop(0, save_every, body, st)
        return st, (st.qk, st.t)

    state, (qks, ts) = lax.scan(frame, state, None, length=nframes)
    return state, qks, ts


def simulate_qg_particles(state: QGState, xp, grid: SpectralGrid,
                          p: QGParams, nsteps: int, save_every: int = 1):
    """QG flow + passive Lagrangian particles advected by the
    geostrophic velocity — the experiment of the reference's
    pyqgParticleAdvection.ipynb notebook (pyqg QGModel + particle
    cloud), and the particle option of the RSW solvers
    (rsw/swk.m:184-186), on this solver. Each flow step advances the
    particles one RK4 step in the post-step velocity grids (frozen over
    the step, like rsw/advect1d.m).

    Args:
      xp: (2, Np) particle positions, coordinate-first.
    Returns:
      (final_state, xp_final, xp_frames (nframes, 2, Np), t_frames).
    """
    from .fields import flow_from_qk
    from .rsw import advect_particles

    nframes = nsteps // save_every

    def frame(carry, _):
        def body(i, c):
            st, x = c
            st = qg_step(st, grid, p)
            uv = flow_from_qk(st.qk, grid, p.Kd2).fields[:2]
            x = advect_particles(x, uv[0], uv[1], grid, p.dt)
            return st, x

        st, x = lax.fori_loop(0, save_every, body, carry)
        return (st, x), (x, st.t)

    (state, xp), (xs, ts) = lax.scan(frame, (state, xp), None,
                                     length=nframes)
    return state, xp, xs, ts


# ---------------------------------------------------------------------------
# Initial conditions and forcing
# ---------------------------------------------------------------------------

def initial_q_ring(key, grid: SpectralGrid, U_g: float, Kd2: float,
                   k_min: int = 5, k_max: int = 8, ring: bool = True):
    """Random-phase PV spectrum normalised so max |u| = U_g
    (qgsw_raytrace.m:191-214).

    Each mode (k, l) contributes -(Kd2 + K^2) cos(k x + l y + phi_kl) to
    q. `ring=True` keeps k_min^2 < K^2 <= k_max^2 (the documented intent);
    `ring=False` reproduces the reference's always-true chained comparison
    (every mode in the square, including the mean).

    Wavenumbers are integer multiples of the domain wavenumber 2*pi/L, as
    in the two-layer driver (qg2layersw_raytrace.m:19-21).
    Returns qk (our rfft2 layout).
    """
    if hasattr(key, "shape") and getattr(key, "ndim", 0) > 0:  # jax PRNG key
        phases = np.asarray(jax.random.uniform(
            key, (2 * k_max + 1, 2 * k_max + 1), minval=0.0,
            maxval=2 * np.pi))
    else:  # plain int seed
        rng = np.random.default_rng(int(key))
        phases = rng.uniform(0, 2 * np.pi, (2 * k_max + 1, 2 * k_max + 1))

    qk = np.zeros(grid.spectral_shape, dtype=np.complex128)
    scale_k = 2.0 * np.pi / grid.Lx  # physical wavenumber per integer mode
    for k in range(-k_max, k_max + 1):
        for l in range(-k_max, k_max + 1):
            K2i = k * k + l * l
            if ring and not (k_min**2 < K2i <= k_max**2):
                continue
            if abs(k) > grid.kmax or abs(l) > grid.kmax:
                continue  # mode not representable on this grid
            phi = phases[k + k_max, l + k_max]
            amp = -(Kd2 + K2i * scale_k**2)
            # cos(kx+ly+phi) -> 0.5 e^{i phi} at (k,l) + conj at (-k,-l)
            c = 0.5 * amp * np.exp(1j * phi)
            if l > 0:
                qk[k % grid.nx, l] += c
            elif l < 0:
                qk[(-k) % grid.nx, -l] += np.conj(c)
            else:  # l == 0: both half-plane slots live in the ky=0 column
                qk[k % grid.nx, 0] += c
                qk[(-k) % grid.nx, 0] += np.conj(c)
    qk *= grid.nyquist_mask

    # Normalise to max speed U_g using the induced geostrophic velocities.
    return jax.jit(
        lambda q: q * (U_g / max_speed(q, grid, Kd2)))(jax.device_put(qk))


def max_speed(qk, grid: SpectralGrid, Kd2, shear: float = 0.0):
    """max sqrt(u^2 + v^2) of the flow induced by qk (qgsw_raytrace.m:63-66)."""
    psik = _psik(qk, grid, Kd2)
    u = sp.to_grid(-sp.ddy(psik, grid), grid) + shear
    v = sp.to_grid(sp.ddx(psik, grid), grid)
    return jnp.sqrt(jnp.max(u * u + v * v))


def inertial_ring_forcing(strength: float, grid: SpectralGrid, f: float,
                          Cg: float) -> np.ndarray:
    """Static spectral forcing on near-inertial modes
    (qgsw_raytrace.m:216-220): strength where 0.9 f < omega < 1.1 f with
    omega = sqrt(f^2 + Cg^2 K^2)."""
    omega = np.sqrt(f**2 + Cg**2 * grid.K2)
    forces = np.where((0.9 * f < omega) & (omega < 1.1 * f), strength, 0.0)
    return forces * grid.nyquist_mask
