"""Two-layer quasi-geostrophic solver with background shear.

Re-design of the solver inlined in
/root/reference/qg_flow_ray_trace/qg2layersw_raytrace.m:
  * per-mode 2x2 PV inversion psi = B q with F = K_d^2/2
    (qg2layersw_raytrace.m:129-137); B is the closed-form inverse of
    [[-K2-F, F], [F, -K2-F]], zeroed at the mean mode;
  * linear operator L = shear + diffusion/drag/beta terms integrated
    EXACTLY by a per-mode 2x2 matrix exponential (:140-149) — the
    reference uses pageeig/pageinv per mode; here exp(dt L) is the
    closed-form 2x2 expm (exp(mu)[cosh(d) I + sinh(d)/d (L - mu I)]),
    computed once on the host in float64 and closed over as a constant;
  * integrating-factor AB3 on the nonlinear Jacobian with exp-factor
    propagation of the history terms (:168-181): the AB3 history RHS
    values are multiplied by exp(dt L) / exp(2 dt L) before combining,
    and the update is qk <- exp(dt L) (qk + dq);
  * nonlinear term: per-layer pseudo-spectral Jacobian, same reversed
    advection sign as the one-layer solver (:309-323), optional
    dealiasing (reference has none).

The reference adapts dt when the CFL check fails and rebuilds the
exponential operators (:154-165). Here dt is fixed per `QG2Operators`
(scan/checkpoint-friendly); `build_operators` is cheap, so an outer
driver can re-chunk with a new dt between scans if a run's max speed
drifts (the production one-layer driver never adapts either).

Reference quirks handled:
  * the two-layer initial_q (:258-281) builds cos(k*X + l*Y) with
    INTEGER k,l on the L=20 domain — wavelengths are not periodic on the
    domain, so the IC has spectral leakage; our `initial_q2_ring` seeds
    the ring in spectral space (periodic by construction) with physical
    wavenumbers 2*pi*k/L, and the ring test k_min^2 < K2 <= k_max^2 is
    applied as written (the reference's chained comparison is always
    true in MATLAB, filling the whole square; pass ring=False for that);
  * packet advection "with the top layer" (:185-189) actually calls the
    ONE-layer inversion psik = -qk/(K_d2+K2) on the full two-layer array
    (grid_U.m:2); `top_layer_flow` implements the intended physics (top
    layer of the true 2x2 inversion) — use `one_layer_quirk=True` to
    reproduce the reference's evaluation.
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
from .fields import GriddedFlow, _stack_from_psik

__all__ = [
    "QG2Params",
    "QG2Operators",
    "QG2State",
    "build_operators",
    "qg2_init",
    "qg2_rhs",
    "qg2_step",
    "simulate_qg2",
    "initial_q2_ring",
    "top_layer_flow",
    "max_speed2",
]


class QG2Params(NamedTuple):
    """Physical/tuning parameters (qg2layersw_raytrace.m:24-34)."""

    Kd2: float                 # deformation wavenumber^2; F = Kd2/2
    shear: float = 0.5         # imposed vertical shear (shear_strength)
    beta: float = 0.0
    r: float = 0.4             # linear drag
    nu_tune: float = 0.1       # nu = nu_tune * dx^(2*alpha)
    alpha: int = 4             # hyperviscosity order
    dealias: bool = False      # reference Jacobian is aliased


class QG2Operators(NamedTuple):
    """Static per-mode operator arrays, built host-side per (grid, dt)."""

    B: np.ndarray          # (2, 2, nx, nky) inversion matrix (real)
    expLdt: np.ndarray     # (2, 2, nx, nky) complex exp(dt L)
    expL2dt: np.ndarray    # (2, 2, nx, nky) complex exp(2 dt L)
    dt: float


@struct.dataclass
class QG2State:
    qk: jnp.ndarray        # (2, nx, nky) complex PV spectra
    rhs_m1: jnp.ndarray    # AB history
    rhs_m2: jnp.ndarray
    t: jnp.ndarray
    step: jnp.ndarray


# ---------------------------------------------------------------------------
# Operator construction (host-side, float64)
# ---------------------------------------------------------------------------

def _inversion_matrix(grid: SpectralGrid, Kd2: float) -> np.ndarray:
    """B with psi = B q; the closed-form 2x2 inverse of the coupling
    matrix, matching qg2layersw_raytrace.m:129-137 (zero at K2=0)."""
    F = Kd2 / 2.0
    K2 = grid.K2
    det = K2 * (K2 + 2.0 * F)
    det = np.where(det == 0.0, np.inf, det)
    B = np.empty((2, 2) + K2.shape)
    B[0, 0] = (-F - K2) / det
    B[0, 1] = -F / det
    B[1, 0] = -F / det
    B[1, 1] = (-F - K2) / det
    return B


def _expm2(A: np.ndarray, t: float) -> np.ndarray:
    """Closed-form exp(t*A) for per-mode 2x2 matrices A (2,2,...).

    Eigenvalue form: with mu = tr/2, delta = sqrt((a-d)^2/4 + bc), the
    eigenvalues are mu +- delta and
      exp(tA) = c0 I + c1 (A - mu I),
      c0 = (e^{t l1} + e^{t l2})/2, c1 = (e^{t l1} - e^{t l2})/(2 delta),
    which stays finite for strongly damped modes (the naive
    e^{t mu} cosh(t delta) form is 0 * inf there)."""
    a, b, c, d = A[0, 0], A[0, 1], A[1, 0], A[1, 1]
    mu = 0.5 * (a + d)
    delta = np.sqrt((0.25 * (a - d) ** 2 + b * c).astype(np.complex128))
    e1 = np.exp(t * (mu + delta))
    e2 = np.exp(t * (mu - delta))
    c0 = 0.5 * (e1 + e2)
    small = np.abs(t * delta) < 1e-12
    denom = np.where(small, 1.0, 2.0 * delta)
    c1 = np.where(small, t * np.exp(t * mu), (e1 - e2) / denom)
    E = np.empty(np.broadcast_shapes(A.shape, (2, 2) + mu.shape),
                 dtype=np.complex128)
    E[0, 0] = c0 + c1 * (a - mu)
    E[0, 1] = c1 * b
    E[1, 0] = c1 * c
    E[1, 1] = c0 + c1 * (d - mu)
    return E


def build_operators(grid: SpectralGrid, p: QG2Params, dt: float
                    ) -> QG2Operators:
    """B, exp(dt L), exp(2 dt L) per qg2layersw_raytrace.m:129-149."""
    F = p.Kd2 / 2.0
    K2 = grid.K2
    kx = grid.kx  # (nx, 1) physical wavenumbers
    nu = p.nu_tune * grid.dx ** (2 * p.alpha)
    B = _inversion_matrix(grid, p.Kd2)

    diffusion_factor = ((nu * K2**p.alpha + p.r) * K2
                        - 1j * kx * p.beta)            # (nx, nky) complex
    diffusion = B * diffusion_factor                   # scalar * 2x2

    # mean_flow_terms = i kx shear * diag(-1, 1) @ (I + 2F B)
    M = np.zeros((2, 2) + K2.shape, dtype=np.complex128)
    eye2FB = np.empty_like(B)
    eye2FB[0, 0] = 1.0 + 2.0 * F * B[0, 0]
    eye2FB[0, 1] = 2.0 * F * B[0, 1]
    eye2FB[1, 0] = 2.0 * F * B[1, 0]
    eye2FB[1, 1] = 1.0 + 2.0 * F * B[1, 1]
    shear_factor = 1j * kx * p.shear
    M[0] = -shear_factor * eye2FB[0]
    M[1] = +shear_factor * eye2FB[1]

    L = M + diffusion
    return QG2Operators(B=B, expLdt=_expm2(L, dt), expL2dt=_expm2(L, 2 * dt),
                        dt=float(dt))


# ---------------------------------------------------------------------------
# RHS and stepping
# ---------------------------------------------------------------------------

def _mat2(A, x):
    """Per-mode 2x2 matrix times 2-vector of spectra: (2,2,nx,nky) x
    (2,nx,nky) -> (2,nx,nky). Reference mmult3 (:333-338). HIGHEST
    precision: a float32 contraction may otherwise run in TF32 on a GPU
    (about three decimal digits)."""
    return jnp.einsum("ij...,j...->i...", jnp.asarray(A, x.dtype), x,
                      precision=lax.Precision.HIGHEST)


def qg2_rhs(qk, grid: SpectralGrid, ops: QG2Operators, p: QG2Params):
    """Nonlinear term: per-layer Jacobian with the reference's sign
    (qg2layersw_raytrace.m:309-323)."""
    psik = _mat2(ops.B, qk)
    return sp.dealiased_jacobian(psik, qk, grid, dealias=p.dealias)


def qg2_init(qk0, t0: float = 0.0) -> QG2State:
    def build(q):
        z = jnp.zeros_like(q)
        return QG2State(qk=q, rhs_m1=z, rhs_m2=z,
                        t=jnp.asarray(t0, jnp.real(q).dtype),
                        step=jnp.asarray(0, jnp.int32))

    return jax.jit(build)(qk0)


def qg2_step(state: QG2State, grid: SpectralGrid, ops: QG2Operators,
             p: QG2Params) -> QG2State:
    """One integrating-factor AB3 step (qg2layersw_raytrace.m:168-181):
    history RHS terms are propagated by exp(dt L)/exp(2 dt L), and the
    combined update is qk <- exp(dt L)(qk + dq)."""
    Qn = qg2_rhs(state.qk, grid, ops, p)
    dt = ops.dt

    def euler(_):
        return dt * Qn

    def ab2(_):
        return dt / 2.0 * (3.0 * Qn - _mat2(ops.expLdt, state.rhs_m1))

    def ab3(_):
        return dt / 12.0 * (23.0 * Qn
                            - 16.0 * _mat2(ops.expLdt, state.rhs_m1)
                            + 5.0 * _mat2(ops.expL2dt, state.rhs_m2))

    dq = lax.switch(jnp.minimum(state.step, 2), [euler, ab2, ab3], None)
    qk = _mat2(ops.expLdt, state.qk + dq)
    return QG2State(qk=qk, rhs_m1=Qn, rhs_m2=state.rhs_m1,
                    t=state.t + dt, step=state.step + 1)


def simulate_qg2(state: QG2State, grid: SpectralGrid, ops: QG2Operators,
                 p: QG2Params, nsteps: int, save_every: int = 1):
    nframes = nsteps // save_every

    def frame(st, _):
        st = lax.fori_loop(0, save_every,
                           lambda i, s: qg2_step(s, grid, ops, p), st)
        return st, (st.qk, st.t)

    state, (qks, ts) = lax.scan(frame, state, None, length=nframes)
    return state, qks, ts


# ---------------------------------------------------------------------------
# Flow evaluation and diagnostics
# ---------------------------------------------------------------------------

def top_layer_flow(qk, grid: SpectralGrid, ops: QG2Operators, p: QG2Params,
                   one_layer_quirk: bool = False,
                   n_fields: int = 6) -> GriddedFlow:
    """Velocity/gradient grids of the top layer for packet advection
    (qg2layersw_raytrace.m:185-189). Default: top layer of the true 2x2
    inversion + imposed shear. one_layer_quirk=True reproduces the
    reference's accidental one-layer inversion psik = -qk1/(K_d2+K2).
    n_fields=2: only (u, v) — see fields._stack_from_psik."""
    if one_layer_quirk:
        denom = np.where(p.Kd2 + grid.K2 == 0, 1.0, p.Kd2 + grid.K2)
        psik_top = -qk[0] / jnp.asarray(denom)
    else:
        psik_top = _mat2(ops.B, qk)[0]
    return GriddedFlow(
        fields=_stack_from_psik(psik_top, grid, p.shear, n_fields),
        grid=grid)


def max_speed2(qk, grid: SpectralGrid, ops: QG2Operators, p: QG2Params):
    """max speed over BOTH layers incl. shear on the top layer
    (qg2layersw_raytrace.m:157-159; grid_U adds shear to every layer's u
    there — we add it to the top layer only, matching the physics)."""
    psik = _mat2(ops.B, qk)
    uk = -sp.ddy(psik, grid)
    vk = sp.ddx(psik, grid)
    u = sp.to_grid(uk, grid)
    v = sp.to_grid(vk, grid)
    u = u.at[0].add(p.shear)
    return jnp.sqrt(jnp.max(u * u + v * v))


def initial_q2_ring(seed, grid: SpectralGrid, U_g: float, Kd2: float,
                    k_min: int = 10, k_max: int = 30, ring: bool = True):
    """Two-layer PV IC: q2 = -q1 with q1 a random-phase ring normalised
    to max speed U_g (qg2layersw_raytrace.m:57-59, 258-281).

    Seeded in spectral space with physical wavenumbers (periodic on the
    domain), unlike the reference's integer-wavenumber cos() sum which is
    non-periodic on its L=20 box.
    """
    from .qg import initial_q_ring  # shares the single-layer ring builder

    q1k = initial_q_ring(seed, grid, U_g, Kd2, k_min=k_min, k_max=k_max,
                         ring=ring)
    return jax.jit(lambda q: jnp.stack([q, -q]))(q1k)
