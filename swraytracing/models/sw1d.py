"""One-dimensional solvers: RSW (nonlinear + forced) and the YBJ
near-inertial envelope equation.

Reference parity:
  * `sw1` — nonlinear 1-D rotating shallow water
    (/root/reference/rsw/sw1.m:5-10):
        u_t = f v - Cg^2 h_x - (u^2/2)_x
        v_t = -f u - u v_x
        h_t = -u_x - (h u)_x
    pseudo-spectral on the rfft half-spectrum (identical to the
    reference's K = 0..KMAX layout), 3/2-padded dealiased products
    (sw1.m:124-141), AB3 with per-step trapezoidal hyperviscous filters
    rebuilt from the adaptive dt (sw1.m:119-126), RK4 particle
    advection with linear interpolation (rsw/advect1d.m).
  * `sw1_forced` — the nondimensional forced variant
    (/root/reference/rsw/sw1d.m:6-13): Ro/Bu scaling, imposed barotropic
    V_x(x) = -V0 sin(Kv x) forcing the v equation, Williamson RK3
    (sw1d.m:38, :77-81).
  * `ybj1d` — Young–Ben Jelloul NIW amplitude equation
    (/root/reference/rsw/ybj1d.m:6-8): A_T + (i/2)(V_x A - Bu A_xx) = 0,
    complex field, full-spectrum FFT, RK3.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["SW1Params", "sw1", "sw1_forced", "sw1rk3nu", "ybj1d",
           "advect1d"]

_RK3 = (1.0 / 3.0, 5.0 / 9.0, 15.0 / 16.0, 153.0 / 128.0, 8.0 / 15.0)
_AB3 = (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0)


class SW1Params(NamedTuple):
    f: float
    Cg: float
    hyper_order: int = 8      # sw1.m:31
    nutune: float = 0.01      # sw1.m:32
    dttune: float = 0.3       # sw1.m:33


def _to_k(f):
    """grid -> half-spectrum (K = 0..KMAX), sw1.m g2s; drops Nyquist by
    construction of KMAX = NX/2 - 1."""
    n = f.shape[0]
    return jnp.fft.rfft(f, axis=0)[: n // 2] / n


def _to_g(fk, n):
    """half-spectrum -> grid, sw1.m s2g."""
    kmax1 = fk.shape[0]
    pad = jnp.zeros((n // 2 + 1 - kmax1,) + fk.shape[1:], fk.dtype)
    return jnp.fft.irfft(jnp.concatenate([fk, pad]), n=n, axis=0) * n


def _pad_big(fk, n):
    """zero-pad half-spectrum to the 3/2 grid; returns (big grid field,
    NXBIG) — sw1.m:113-118 semantics."""
    kmax = n // 2 - 1
    kmaxbig = 3 * (kmax + 1) // 2 - 1
    nbig = 2 * (kmaxbig + 1)
    return _to_g(fk, nbig), nbig


def _unpad_big(fg_big, n):
    kmax = n // 2 - 1
    nbig = fg_big.shape[0]
    return jnp.fft.rfft(fg_big, axis=0)[: kmax + 1] / nbig


def _ik(n, dtype=jnp.complex128):
    K = np.arange(n // 2)
    return jnp.asarray(1j * K)


def sw1_rhs(Uk, n, p: SW1Params):
    """sw1.m rhs (:142-148): products u*u, u*v_x, u*h on the padded
    grid."""
    iK = _ik(n)
    wk = jnp.stack([Uk[:, 0], iK * Uk[:, 1], Uk[:, 2]], axis=1)
    wg, _ = _pad_big(wk, n)
    u, vx, h = wg[:, 0], wg[:, 1], wg[:, 2]
    prods = jnp.stack([u * u, u * vx, u * h], axis=1)
    pk = _unpad_big(prods, n)
    Ru = p.f * Uk[:, 1] - p.Cg**2 * iK * Uk[:, 2] - 0.5 * iK * pk[:, 0]
    Rv = -p.f * Uk[:, 0] - pk[:, 1]
    Rh = -iK * Uk[:, 0] - iK * pk[:, 2]
    return jnp.stack([Ru, Rv, Rh], axis=1)


def sw1(U0, p: SW1Params, nsteps: int, save_every: int = 1, Xp0=None):
    """Nonlinear 1-D RSW (sw1.m). U0: (nx, 3) grids of (u, v, h).

    Returns (U_frames (nf, nx, 3), t_frames, ke, pe, Xp_frames|None).
    Adaptive dt and the per-step trapezoidal filters are traced, so the
    whole run is one scan (filters depend on dt: sw1.m:119-126).
    """
    U0 = jnp.asarray(U0)
    n = U0.shape[0]
    dx = 2 * np.pi / n
    Cmax = np.sqrt(p.Cg**2 + p.f**2)
    Ka = jnp.asarray(np.arange(n // 2, dtype=np.float64) ** p.hyper_order)
    Uk0 = _to_k(U0)
    z = jnp.zeros_like(Uk0)
    has_p = Xp0 is not None
    xp0 = jnp.asarray(Xp0) if has_p else jnp.zeros((1,))

    def step(carry):
        Uk, Rm1, Rm2, t, step_i, xp = carry
        U = _to_g(Uk, n)
        Rk = sw1_rhs(Uk, n, p)
        first = step_i == 0
        Rm1 = jnp.where(first, Rk, Rm1)
        Rm2 = jnp.where(first, Rk, Rm2)
        vmax = jnp.maximum(jnp.max(jnp.abs(U[:, :2])), Cmax)
        dt = p.dttune * dx / vmax
        nu = p.nutune * dx**p.hyper_order / dt
        up = 1.0 - 0.5 * dt * nu * Ka
        dn = 1.0 / (1.0 + 0.5 * dt * nu * Ka)
        fup = jnp.stack([up, up, jnp.ones_like(up)], axis=1)
        fdn = jnp.stack([dn, dn, jnp.ones_like(dn)], axis=1)
        a1, a2, a3 = _AB3
        Uk = fdn * (fup * Uk + dt * (a1 * Rk + a2 * Rm1 + a3 * Rm2))
        if has_p:
            xp = advect1d(xp, U[:, 0], dx, dt)
        return (Uk, Rk, Rm1, t + dt, step_i + 1, xp)

    def frame(carry, _):
        carry = lax.fori_loop(0, save_every, lambda i, c: step(c), carry)
        Uk, _, _, t, _, xp = carry
        U = _to_g(Uk, n)
        H = 1.0 + U[:, 2]
        ke = jnp.sum(0.5 * H * (U[:, 0] ** 2 + U[:, 1] ** 2))
        pe = jnp.sum(0.5 * p.Cg**2 * H**2)
        return carry, (U, t, ke, pe, xp)

    carry0 = (Uk0, z, z, jnp.asarray(0.0, U0.dtype),
              jnp.asarray(0, jnp.int32), xp0)
    _, (Us, ts, kes, pes, xps) = lax.scan(frame, carry0, None,
                                          length=nsteps // save_every)
    return Us, ts, kes, pes, (xps if has_p else None)


def _rk3(yk, dt, rhs):
    """Williamson low-storage RK3 (sw1d.m:38, :77-81)."""
    c1, c2, c3, c4, c5 = _RK3
    rk = dt * rhs(yk)
    y1 = yk + c1 * rk
    r1 = dt * rhs(y1) - c2 * rk
    y2 = y1 + c3 * r1
    return y2 + c5 * (dt * rhs(y2) - c4 * r1)


def sw1_forced(U0, Ro: float, Bu: float, V0: float, Kv: int, dt: float,
               nsteps: int, save_every: int = 1):
    """Forced nondimensional 1-D RSW (sw1d.m:6-13):
        u_t = v - Bu h_x - Ro (u^2/2)_x
        v_t = -u - Ro u v_x - Ro u V_x
        h_t = -u_x - Ro (h u)_x
    with V_x = -V0 sin(Kv x), RK3 at fixed dt. Returns (U, t, ke, pe)
    frames."""
    U0 = jnp.asarray(U0)
    n = U0.shape[0]
    iK = _ik(n)
    kmax = n // 2 - 1
    nbig = 2 * (3 * (kmax + 1) // 2 - 1 + 1)
    xb = np.linspace(0.0, 2 * np.pi, nbig, endpoint=False)
    VXb = jnp.asarray(-V0 * np.sin(Kv * xb))

    def rhs(Uk):
        wk = jnp.stack([Uk[:, 0], iK * Uk[:, 1], Uk[:, 2]], axis=1)
        wg, _ = _pad_big(wk, n)
        u, vx, h = wg[:, 0], wg[:, 1], wg[:, 2]
        prods = jnp.stack([u * u, u * (vx + VXb), u * h], axis=1)
        pk = _unpad_big(prods, n)
        Ru = Uk[:, 1] - Bu * iK * Uk[:, 2] - 0.5 * Ro * iK * pk[:, 0]
        Rv = -Uk[:, 0] - Ro * pk[:, 1]
        Rh = -iK * Uk[:, 0] - Ro * iK * pk[:, 2]
        return jnp.stack([Ru, Rv, Rh], axis=1)

    def frame(Uk, _):
        Uk = lax.fori_loop(0, save_every, lambda i, y: _rk3(y, dt, rhs), Uk)
        U = _to_g(Uk, n)
        H = 1.0 + U[:, 2]
        ke = jnp.sum(0.5 * H * (U[:, 0] ** 2 + U[:, 1] ** 2))
        pe = jnp.sum(0.5 * Bu * H**2)
        return Uk, (U, ke, pe)

    Uk, (Us, kes, pes) = lax.scan(frame, _to_k(U0), None,
                                  length=nsteps // save_every)
    ts = dt * save_every * (1 + jnp.arange(nsteps // save_every))
    return Us, ts, kes, pes


def sw1rk3nu(U0, Ro: float, Bu: float, nu: float, nsteps: int,
             save_every: int = 1, S: int = 4, dttune: float = 0.01):
    """Nondimensional 1-D RSW with *explicit* hyperviscosity, RK3
    (/root/reference/rsw/sw1rk3nu.m:1-25):
        u_t = v - Bu h_x - Ro (u^2/2)_x - nu (-1)^S d^{2S}u/dx^{2S}
        v_t = -u - Ro u v_x             - nu (-1)^S d^{2S}v/dx^{2S}
        h_t = -u_x - Ro (h u)_x
    i.e. spectral damping -nu K^{2S} on u and v only (sw1rk3nu.m rhs),
    unlike sw1's trapezoidal per-step filter and sw1_forced's imposed
    barotropic V — this is the reference's third distinct viscosity
    treatment, kept as its own entry point.

    Reference quirk (documented, reproduced): sw1rk3nu.m:52-54 computes
    the "adaptive" vmax from `Ui`, which is never reassigned inside the
    loop — so dt is in fact CONSTANT, fixed by the initial condition:
    dt = dttune*2*pi/KMAX / max(sqrt(Bu+1), max|u0,v0|). We compute it
    the same way (once, from U0).

    Returns (U_frames (nf, nx, 3), t_frames, ke, pe)."""
    U0 = jnp.asarray(U0)
    n = U0.shape[0]
    kmax = n // 2 - 1
    iK = _ik(n)
    Kp = jnp.asarray(np.arange(n // 2, dtype=np.float64) ** (2 * S))

    cgw = np.sqrt(Bu + 1.0)  # gravity-wave speed at k=1 (sw1rk3nu.m:49)
    vmax0 = float(np.maximum(
        cgw, np.sqrt(np.max(np.abs(np.asarray(U0[:, 0])))**2
                     + np.max(np.abs(np.asarray(U0[:, 1])))**2)))
    dt = dttune * 2.0 * np.pi / kmax / vmax0

    def rhs(Uk):
        wk = jnp.stack([Uk[:, 0], iK * Uk[:, 1], Uk[:, 2]], axis=1)
        wg, _ = _pad_big(wk, n)
        u, vx, h = wg[:, 0], wg[:, 1], wg[:, 2]
        prods = jnp.stack([u * u, u * vx, u * h], axis=1)
        pk = _unpad_big(prods, n)
        Ru = (Uk[:, 1] - Bu * iK * Uk[:, 2] - 0.5 * Ro * iK * pk[:, 0]
              - nu * Kp * Uk[:, 0])
        Rv = -Uk[:, 0] - Ro * pk[:, 1] - nu * Kp * Uk[:, 1]
        Rh = -iK * Uk[:, 0] - Ro * iK * pk[:, 2]
        return jnp.stack([Ru, Rv, Rh], axis=1)

    # sw1rk3nu.m:62 divides by Ro^2 in PE; at Ro=0 (pure linear runs)
    # report the quadratic-in-h PE instead of the reference's Inf.
    pe_fac = 0.5 / Ro**2 if Ro != 0.0 else 0.5

    def frame(Uk, _):
        Uk = lax.fori_loop(0, save_every, lambda i, y: _rk3(y, dt, rhs), Uk)
        U = _to_g(Uk, n)
        H = 1.0 + Ro * U[:, 2]
        ke = jnp.sum(0.5 * H * (U[:, 0] ** 2 + U[:, 1] ** 2))
        pe = jnp.sum(pe_fac * (H**2 if Ro != 0.0 else U[:, 2] ** 2))
        return Uk, (U, ke, pe)

    Uk, (Us, kes, pes) = lax.scan(frame, _to_k(U0), None,
                                  length=nsteps // save_every)
    ts = dt * save_every * (1 + jnp.arange(nsteps // save_every))
    return Us, ts, kes, pes


def ybj1d(A0, Bu: float, V0: float, Kv: int, dt: float, nsteps: int,
          save_every: int = 1):
    """YBJ NIW envelope A_T + (i/2)(V_x A - Bu A_xx) = 0 (ybj1d.m),
    complex A on the full spectrum, dealiased V_x A product, RK3.
    Returns (A_frames, t_frames)."""
    A0 = jax.device_put(np.asarray(A0).astype(np.complex128
                                   if np.asarray(A0).dtype == np.complex128
                                   else np.complex64))
    n = A0.shape[0]
    kmax = n // 2 - 1
    kmaxbig = 3 * (kmax + 1) // 2 - 1
    nbig = 2 * (kmaxbig + 1)
    K = jnp.asarray(np.concatenate([np.arange(kmax + 1),
                                    np.arange(-kmax - 1, 0)]))
    xb = np.linspace(0.0, 2 * np.pi, nbig, endpoint=False)
    VXb = jnp.asarray(-V0 * np.sin(Kv * xb), A0.real.dtype)

    def rhs(Ak):
        big = jnp.zeros((nbig,), Ak.dtype)
        big = big.at[: kmax + 1].set(Ak[: kmax + 1])
        big = big.at[nbig - kmax - 1:].set(Ak[kmax + 1:])
        Ab = jnp.fft.ifft(big) * nbig
        AVk = jnp.fft.fft(Ab * VXb) / nbig
        AV = jnp.concatenate([AVk[: kmax + 1], AVk[nbig - kmax - 1:]])
        return -0.5j * (AV + Bu * K**2 * Ak)

    Ak0 = jnp.fft.fft(A0) / n

    def frame(Ak, _):
        Ak = lax.fori_loop(0, save_every, lambda i, y: _rk3(y, dt, rhs), Ak)
        return Ak, jnp.fft.ifft(Ak) * n

    Ak, As = lax.scan(frame, Ak0, None, length=nsteps // save_every)
    ts = dt * save_every * (1 + jnp.arange(nsteps // save_every))
    return As, ts


def advect1d(xp, u, dx, dt):
    """RK4 particle advection with periodic linear interpolation of the
    gridded 1-D velocity (rsw/advect1d.m:1-10)."""
    n = u.shape[0]

    def vel(x):
        xi = jnp.mod(x / dx, n)
        i0 = jnp.floor(xi).astype(jnp.int32)
        w = xi - i0
        return (1.0 - w) * u[i0 % n] + w * u[(i0 + 1) % n]

    k1 = dt * vel(xp)
    k2 = dt * vel(xp + 0.5 * k1)
    k3 = dt * vel(xp + 0.5 * k2)
    k4 = dt * vel(xp + k3)
    return xp + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
