"""Nonlinear and linearized rotating shallow-water solvers (2-D).

Re-design of the reference's swk family:
  * `swk` nonlinear RSW in vorticity/Bernoulli form
    (/root/reference/rsw/swk.m:5-12, getrhs :201-217):
        u_t =  v (f + zeta) - B_x
        v_t = -u (f + zeta) - B_y
        h_t = -(u h)_x - (v h)_y - div u,      B = (u^2+v^2)/2 + Cg^2 h
  * `swkU` linearized about a prescribed steady flow (U, V) in
    conservative form (/root/reference/rsw/swkU.m:216-246), with the
    optional `killpv` projection (swkU.m:193-197) and the `swkUqx`
    residual-PV damping step (/root/reference/rsw/swkUqx.m:243-262);
  * `swkU_tc` time-dependent background: the (U, V) grids are recomputed
    from a streamfunction callable every step
    (/root/reference/rsw/swkU_tc.m:202-205).

Numerics, as the reference: AB3 with trapezoidal hyperviscosity of order
`a` applied to u and v as the per-mode filter pair (fU, fR)
(swk.m:102-109, update at :182), Umax-adaptive dt (Courant, :151) carried
through the scan as state, blow-up detection Umax > 1e6 (:144-148, here a
sticky `blown` flag that freezes the state instead of aborting the scan),
and exactly dealiased quadratic products — via 3/2 zero-padding
instead of the reference's packed staggered grids (equivalent; see
ops/spectral.py). The AB3 bootstrap copies the first RHS into both
history slots (swk.m:139), reproducing the reference's startup exactly.

Particles: `advect_particles` implements the RK4+interpolation particle
step that swk.m:185 *calls* but the reference never defines.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from ..utils import pytree as struct

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp
from ..ops.interp import interpolate_stack

__all__ = [
    "RSWParams",
    "RSWState",
    "rsw_filters",
    "rsw_init",
    "rsw_rhs",
    "rsw_step",
    "simulate_rsw",
    "swknd",
    "energy",
    "advect_particles",
    "potential_vorticity",
    "wave_vortex_decompose",
]


class RSWParams(NamedTuple):
    """Physics + tuning (swk.m:46-49).

    Variant coverage of the reference's swk family:
      * swks ("flux-form") differs from swk ONLY in its Bernoulli
        missing the 1/2 on the kinetic term (swks.m:176 `gprod(u,u) +
        gprod(v,v)` vs swk.m:208 `.5*gprod(u,u)+.5*gprod(v,v)`; its h
        equation is identical despite the header) — set
        bernoulli_half=False to reproduce it;
      * swknd (nondimensional, parameters ep = U/(f Ld), gam = Ld/L) is
        the same solver under the substitution f -> 1/ep,
        Cg^2 -> gam^2/ep^2 on the unit domain — use those values here
        rather than a separate code path.
    """

    f: float
    Cg: float
    hyper_order: int = 8        # a, nu del^a
    nutune: float = 1.0
    dttune: float = 0.1         # Courant number
    dealias: bool = True
    killpv: bool = False        # swkU.m:50,193-197
    pv_damp_rate: float = 0.0   # swkUqx.m PV_damping rate (0 = off)
    bernoulli_half: bool = True  # False = swks.m:176 variant

    @property
    def Cmax(self):
        return float(np.sqrt(self.Cg**2 + self.f**2))


@struct.dataclass
class RSWState:
    Sk: jnp.ndarray       # (3, nx, nky) spectra of (u, v, h)
    rhs_m1: jnp.ndarray   # AB3 history
    rhs_m2: jnp.ndarray
    t: jnp.ndarray        # scalar time
    dt: jnp.ndarray       # scalar adaptive time step
    step: jnp.ndarray     # int32
    blown: jnp.ndarray    # bool: Umax exceeded 1e6 at some step


def rsw_filters(grid: SpectralGrid, p: RSWParams):
    """Trapezoidal hyperdiffusion pair (fU, fR) (swk.m:102-109):
    nudt = nutune*2*pi/(nx*kmax^a); fR = 1/(1 + nudt/2 K^a);
    fU = (1 - nudt/2 K^a) * fR, with K the INTEGER wavenumber magnitude.
    Applied to the u,v layers only. Static numpy arrays."""
    ikx = np.fft.fftfreq(grid.nx, 1.0 / grid.nx)[:, None]
    iky = np.arange(grid.nky)[None, :]
    K = np.sqrt(ikx**2 + iky**2)
    kmax = grid.kmax
    nudt = p.nutune * 2 * np.pi / (grid.nx * kmax**p.hyper_order)
    Ka = K**p.hyper_order
    fR = 1.0 / (1.0 + 0.5 * nudt * Ka)
    fU = (1.0 - 0.5 * nudt * Ka) * fR
    ones = np.ones_like(fR)
    return (np.stack([fU, fU, ones]) * grid.nyquist_mask,
            np.stack([fR, fR, ones]) * grid.nyquist_mask)


def rsw_init(u0, v0, h0, grid: SpectralGrid, p: RSWParams,
             t0: float = 0.0) -> RSWState:
    Sk = sp.to_spectral(jnp.stack([jnp.asarray(u0), jnp.asarray(v0),
                                   jnp.asarray(h0)]), grid)
    z = jnp.zeros_like(Sk)
    umax = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(u0))),
                       jnp.max(jnp.abs(jnp.asarray(v0))))
    umax = jnp.maximum(umax, p.Cmax)
    dt = p.dttune * grid.dx / umax
    rdt = jnp.real(Sk).dtype
    return RSWState(Sk=Sk, rhs_m1=z, rhs_m2=z,
                    t=jnp.asarray(t0, rdt), dt=dt.astype(rdt),
                    step=jnp.asarray(0, jnp.int32),
                    blown=jnp.asarray(False))


# ---------------------------------------------------------------------------
# RHS
# ---------------------------------------------------------------------------

def _to_work_grid(stack, grid, dealias):
    """Inverse-transform a stack of spectra to the (padded) work grid."""
    if not dealias:
        return sp.to_grid(stack, grid), grid
    big = sp.padded_grid(grid)
    padded = jax.vmap(lambda fk: sp._pad_spectrum(fk, grid, big.nx, big.nky)
                      )(stack)
    return sp.to_grid(padded, big), big


def _from_work_grid(stack_g, grid, work_grid, dealias):
    pk = sp.to_spectral(stack_g, work_grid)
    if not dealias:
        return pk
    return jax.vmap(lambda fk: sp._unpad_spectrum(fk, grid, work_grid.nx)
                    )(pk) * jnp.asarray(grid.nyquist_mask, pk.dtype)


def rsw_rhs(Sk, grid: SpectralGrid, p: RSWParams, UV=None):
    """Spectral RHS. UV=None: nonlinear swk form (swk.m:201-217);
    UV=(U, V) grid fields of the prescribed background: linearized swkU
    conservative form (swkU.m:216-246).

    Returns (Rk (3, nx, nky), umax) — umax is the grid-space
    max(|u|, |v|) needed for the Courant condition, computed here where
    the grid fields already exist.
    """
    uk, vk, hk = Sk[0], Sk[1], Sk[2]
    zk = sp.ddx(vk, grid) - sp.ddy(uk, grid)
    divk = sp.ddx(uk, grid) + sp.ddy(vk, grid)

    if UV is None:
        fields, wg = _to_work_grid(jnp.stack([uk, vk, hk, zk]), grid,
                                   p.dealias)
        u, v, h, zeta = fields
        umax = jnp.maximum(jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v)))
        bfac = 0.5 if p.bernoulli_half else 1.0
        prods = jnp.stack([v * zeta, u * zeta, bfac * (u * u + v * v),
                           u * h, v * h])
        pk = _from_work_grid(prods, grid, wg, p.dealias)
        vz_k, uz_k, ke_k, uh_k, vh_k = pk
        Bk = ke_k + p.Cg**2 * hk
        Ru = vz_k + p.f * vk - sp.ddx(Bk, grid)
        Rv = -uz_k - p.f * uk - sp.ddy(Bk, grid)
        Rh = -sp.ddx(uh_k, grid) - sp.ddy(vh_k, grid) - divk
    else:
        U, V = UV
        fields, wg = _to_work_grid(jnp.stack([uk, vk, hk, divk]), grid,
                                   p.dealias)
        u, v, h, divu = fields
        umax = jnp.maximum(jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v)))
        Ub, _ = _to_work_grid(jnp.stack([sp.to_spectral(U, grid),
                                         sp.to_spectral(V, grid)]), grid,
                              p.dealias)
        Ug, Vg = Ub
        prods = jnp.stack([Ug * u, Vg * u + v * Ug, Ug * divu,
                           Ug * v + u * Vg, Vg * v, Vg * divu,
                           Ug * h, Vg * h])
        pk = _from_work_grid(prods, grid, wg, p.dealias)
        Uu_k, VuvU_k, Udiv_k, UvuV_k, Vv_k, Vdiv_k, Uh_k, Vh_k = pk
        Ru = (-2.0 * sp.ddx(Uu_k, grid) - sp.ddy(VuvU_k, grid) + Udiv_k
              + p.f * vk - p.Cg**2 * sp.ddx(hk, grid))
        Rv = (-sp.ddx(UvuV_k, grid) - 2.0 * sp.ddy(Vv_k, grid) + Vdiv_k
              - p.f * uk - p.Cg**2 * sp.ddy(hk, grid))
        Rh = -sp.ddx(Uh_k, grid) - sp.ddy(Vh_k, grid) - divk
    return jnp.stack([Ru, Rv, Rh]), umax, divk


def _killpv_project(Sk, divk, grid: SpectralGrid, p: RSWParams):
    """Reset vorticity to f*h keeping divergence (swkU.m:193-197). Uses
    the PRE-update divergence, as the reference's stale global does."""
    K2 = np.where(grid.K2 == 0, np.inf, grid.K2)
    Km2 = jnp.asarray(1.0 / K2)
    hk = Sk[2]
    uk = -Km2 * (sp.ddx(divk, grid) - p.f * sp.ddy(hk, grid))
    vk = -Km2 * (sp.ddy(divk, grid) + p.f * sp.ddx(hk, grid))
    return jnp.stack([uk, vk, hk])


def _pv_damp(Sk, grid: SpectralGrid, p: RSWParams):
    """Relax out the residual (unbalanced) PV (swkUqx.m:243-262):
    pv_res = zeta - f h; psi_res = pv_res_k / (-(Cg^2/f) K2 - f);
    subtract rate * (u_res, v_res, psi_res)."""
    uk, vk, hk = Sk[0], Sk[1], Sk[2]
    zk = sp.ddx(vk, grid) - sp.ddy(uk, grid)
    pvk = zk - p.f * hk
    denom = jnp.asarray(-(p.Cg**2 / p.f) * grid.K2 - p.f)
    psik = pvk / denom
    c = p.Cg**2 / p.f
    u_res = -c * sp.ddy(psik, grid)
    v_res = c * sp.ddx(psik, grid)
    r = p.pv_damp_rate
    return jnp.stack([uk - r * u_res, vk - r * v_res, hk - r * psik])


# ---------------------------------------------------------------------------
# Stepping
# ---------------------------------------------------------------------------

_AB3 = (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0)  # Durran 3.81 (swk.m:116)


def rsw_step(state: RSWState, grid: SpectralGrid, p: RSWParams, filters,
             UV=None) -> RSWState:
    """One AB3 + trapezoidal-filter step (swk.m:130-193)."""
    fU, fR = filters
    Rk, umax, divk = rsw_rhs(state.Sk, grid, p, UV)

    first = state.step == 0
    Rm1 = jnp.where(first, Rk, state.rhs_m1)
    Rm2 = jnp.where(first, Rk, state.rhs_m2)

    umax = jnp.maximum(umax, p.Cmax)
    blown = state.blown | (umax > 1e6)
    dt = jnp.where(blown, 0.0, p.dttune * grid.dx / umax)

    a1, a2, a3 = _AB3
    Sk = (jnp.asarray(fU) * state.Sk
          + dt * jnp.asarray(fR) * (a1 * Rk + a2 * Rm1 + a3 * Rm2))
    if p.killpv:
        Sk = _killpv_project(Sk, divk, grid, p)
    if p.pv_damp_rate:
        Sk = _pv_damp(Sk, grid, p)
    return RSWState(Sk=Sk, rhs_m1=Rk, rhs_m2=Rm1, t=state.t + dt, dt=dt,
                    step=state.step + 1, blown=blown)


def simulate_rsw(state: RSWState, grid: SpectralGrid, p: RSWParams,
                 nsteps: int, save_every: int = 1,
                 background_fn: Callable | None = None, Xp0=None,
                 particle_vel_scale: float = 1.0):
    """Run nsteps, saving (u, v, h) grids + (t, ke, pe) per frame.

    background_fn: optional t -> (U, V) grid fields for the linearized
    solvers; a time-dependent callable gives swkU_tc, a constant closure
    gives swkU, None gives nonlinear swk.

    Xp0: optional (2, Np) Lagrangian particle positions advected one RK4
    step per flow step in the post-step velocity (swk.m:184-186,
    swknd.m np^2 option); particle frames are appended to the returns.
    particle_vel_scale rescales the advecting velocity (the swknd
    change of variables needs dx/dT = u/(gam*ep) — see swknd below).
    """
    filters = rsw_filters(grid, p)
    nframes = nsteps // save_every
    has_p = Xp0 is not None
    xp0 = jnp.asarray(Xp0) if has_p else jnp.zeros((2, 1))

    def one(carry):
        st, xp = carry
        UV = background_fn(st.t) if background_fn is not None else None
        st2 = rsw_step(st, grid, p, filters, UV)
        if has_p:
            uv = sp.to_grid(st2.Sk[:2], grid)
            xp = advect_particles(xp, particle_vel_scale * uv[0],
                                  particle_vel_scale * uv[1], grid, st2.dt)
        return st2, xp

    def frame(carry, _):
        carry = lax.fori_loop(0, save_every, lambda i, c: one(c), carry)
        st, xp = carry
        S = sp.to_grid(st.Sk, grid)
        ke, pe = energy(S[0], S[1], S[2], p)
        return carry, (S, st.t, ke, pe, xp)

    (state, _), (S_frames, ts, kes, pes, xps) = lax.scan(
        frame, (state, xp0), None, length=nframes)
    if has_p:
        return state, S_frames, ts, kes, pes, xps
    return state, S_frames, ts, kes, pes


def swknd(u0, v0, h0, ep: float, gam: float, nsteps: int,
          save_every: int = 1, nutune: float = 1.0, np_particles: int = 0,
          dttune: float = 0.1, dealias: bool = True):
    """Nondimensional RSW (/root/reference/rsw/swknd.m:1-45):
        u_t = v(1 + ep zeta) - B_x + nu del^a u
        v_t = -u(1 + ep zeta) - B_y + nu del^a v
        h_t = -gam [(1+ep h) u]_x - gam [(1+ep h) v]_y
    with B = gam [ep (u^2+v^2)/2 + h], ep = U/(f Ld), gam = Ld/L.

    Solved by exact change of variables into the dimensional swk core
    (term-by-term match of swknd.m getrhs:197-212 against swk.m getrhs):
        U = gam*ep/tau' ... with tau = f = 1/ep:
        U = gam u,  V = gam v,  H = ep h,  T = ep t,
        f = 1/ep,   Cg = gam/ep
    — each swknd term maps onto the corresponding swk term exactly
    (Coriolis: tau alpha = f alpha; vorticity/KE: tau alpha gam ep =
    alpha^2; pressure: Cg^2 = tau alpha gam / beta; mass: tau beta gam =
    alpha, with alpha = gam, beta = ep, tau = 1/ep). Differences kept
    from swk's machinery, documented: the trapezoidal filter applies to
    u,v only (swknd.m:178 filters all three layers; h-filtering is a
    mass sink the swk family avoids), and the adaptive dt/nu are
    computed in mapped variables. dttune defaults to 0.1 rather than
    swknd.m's 0.5 (:47): the Courant condition dt = dttune*dx/Umax only
    bounds ADVECTION, but AB3 needs omega_max*dt < 0.724 for the
    fastest gravity wave omega_max ~ gam*sqrt(2)*kmax/ep (in mapped
    time) — at 64^2 with gam=0.7 the reference's 0.5 is linearly
    UNSTABLE (blows up from a 1e-5 plane wave within t~3) and only
    survives in the reference under heavy hyperviscosity.

    np_particles > 0 advects an np^2 uniform particle grid
    (swknd.m:103-109,181-183); dx/dt_nd = u means dx/dT = u/(gam ep) in
    mapped time, hence the velocity rescale.

    Returns (S_frames (nf, 3, nx, ny) in swknd variables, t (swknd
    time), ke, pe, Xp (nf, 2, np^2) or None) with the swknd.m:158-159
    energy definitions ke = sum(.5 (1+ep h)(u^2+v^2)),
    pe = sum(.5/ep^2 (1+ep h)^2).
    """
    u0, v0, h0 = (jnp.asarray(a) for a in (u0, v0, h0))
    nx = u0.shape[0]
    grid = SpectralGrid.square(nx, 2.0 * np.pi)
    p = RSWParams(f=1.0 / ep, Cg=gam / ep, nutune=nutune, dttune=dttune,
                  dealias=dealias)
    st = rsw_init(gam * u0, gam * v0, ep * h0, grid, p)
    if np_particles:
        x0 = (np.arange(np_particles) / np_particles) * grid.Lx + 1e-7
        X, Y = np.meshgrid(x0, x0, indexing="ij")
        xp0 = jnp.asarray(np.stack([X.ravel(), Y.ravel()]))
        st, S, ts, _, _, xps = simulate_rsw(
            st, grid, p, nsteps, save_every, Xp0=xp0,
            particle_vel_scale=1.0 / (gam * ep))
    else:
        st, S, ts, _, _ = simulate_rsw(st, grid, p, nsteps, save_every)
        xps = None
    # back to swknd variables: u = U/gam, h = H/ep, t = T/ep
    S_nd = S.at[:, :2].divide(gam).at[:, 2].divide(ep)
    u, v, h = S_nd[:, 0], S_nd[:, 1], S_nd[:, 2]
    ke = 0.5 * jnp.sum((1 + ep * h) * (u**2 + v**2), axis=(1, 2))
    pe = 0.5 / ep**2 * jnp.sum((1 + ep * h) ** 2, axis=(1, 2))
    return S_nd, ts / ep, ke, pe, xps


def energy(u, v, h, p: RSWParams):
    """KE/PE diagnostics (swk.m:157-158): ke = mean((1+h)(u^2+v^2))/2,
    pe = Cg^2 mean(h^2)/2."""
    ke = 0.5 * jnp.mean((1.0 + h) * (u * u + v * v))
    pe = 0.5 * p.Cg**2 * jnp.mean(h * h)
    return ke, pe


def advect_particles(xp, u, v, grid: SpectralGrid, dt):
    """RK4 particle advection in the gridded (u, v) — the function
    swk.m:185 calls but the reference never defines. xp: (2, Np)
    coordinate-first (ops/interp.py layout note)."""
    uv = jnp.stack([u, v])

    def vel(x):
        vals = interpolate_stack(uv, x[0], x[1], grid)
        return jnp.stack([vals[0], vals[1]], axis=0)

    k1 = dt * vel(xp)
    k2 = dt * vel(xp + 0.5 * k1)
    k3 = dt * vel(xp + 0.5 * k2)
    k4 = dt * vel(xp + k3)
    return xp + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0


# ---------------------------------------------------------------------------
# Diagnostics (rsw/getswpv.m, rsw/wavevortdecomp.m)
# ---------------------------------------------------------------------------

def potential_vorticity(u, v, h, grid: SpectralGrid, p: RSWParams):
    """(zeta, q, qlin) per rsw/getswpv.m:16-20: q = (zeta + f)/(1 + h),
    qlin = zeta - f h."""
    Sk = sp.to_spectral(jnp.stack([u, v]), grid)
    zeta = sp.to_grid(sp.ddx(Sk[1], grid) - sp.ddy(Sk[0], grid), grid)
    q = (zeta + p.f) / (1.0 + h)
    qlin = zeta - p.f * h
    return zeta, q, qlin


def wave_vortex_decompose(u, v, h, grid: SpectralGrid, p: RSWParams):
    """Linear wave/vortex splitting of (u, v, h) (rsw/wavevortdecomp.m
    method): project each spectral mode onto the vortical (geostrophic)
    eigenvector; the remainder is the wave part. Returns
    ((ug, vg, hg), (uw, vw, hw))."""
    f, C = p.f, p.Cg
    kx = jnp.asarray(grid.kx)
    ky = jnp.asarray(grid.ky)
    K2 = jnp.asarray(grid.K2)
    W2 = f**2 + C**2 * K2

    Sk = sp.to_spectral(jnp.stack([u, v, C * h]), grid)
    uk, vk, chk = Sk[0], Sk[1], Sk[2]
    # vortical eigenvector V0 = (-i l C, i k C, f); |V0|^2 = W^2
    proj = (jnp.conj(-1j * ky * C) * uk + jnp.conj(1j * kx * C) * vk
            + f * chk) / W2
    ugk = proj * (-1j * ky * C)
    vgk = proj * (1j * kx * C)
    hgk = proj * f
    G = sp.to_grid(jnp.stack([ugk, vgk, hgk]), grid)
    ug, vg, hg = G[0], G[1], G[2] / C
    return (ug, vg, hg), (u - ug, v - vg, h - hg)


def wave_vortex_spectra(u, v, h, grid: SpectralGrid, p: RSWParams):
    """Isotropic KE/PE spectra of the wave and vortex parts — the
    rsw/wavevortdecomp.m:24-55 diagnostics (it calls `iso_spectra`,
    which the reference does not ship; ops.spectral.isospectrum is the
    shipped isospectrum applied per energy density here).

    Returns dict with 'ke_g', 'pe_g', 'ke_w', 'pe_w', each (kmax,)."""
    (ug, vg, hg), (uw, vw, hw) = wave_vortex_decompose(u, v, h, grid, p)

    def spec2(a, b=None):
        ak = sp.to_spectral(a, grid)
        d = jnp.abs(ak) ** 2
        if b is not None:
            d = d + jnp.abs(sp.to_spectral(b, grid)) ** 2
        return sp.isospectrum(d, grid)

    return {
        "ke_g": 0.5 * spec2(ug, vg),
        "pe_g": 0.5 * p.Cg**2 * spec2(hg),
        "ke_w": 0.5 * spec2(uw, vw),
        "pe_w": 0.5 * p.Cg**2 * spec2(hw),
    }
