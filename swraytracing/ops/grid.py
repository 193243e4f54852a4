"""Spectral grid descriptor for doubly periodic 2-D domains.

Replacement for the reference's scattered wavenumber setup
(e.g. /root/reference/qg_flow_ray_trace/qgsw_raytrace.m:13-20,
/root/reference/rsw/swk.m:78-100). The reference stores spectra on an
fftshifted upper half-plane of shape (2*kmax+1, kmax+1) with the Nyquist
row/column dropped; we use the standard `jnp.fft.rfft2` half-plane layout
(nx, ny//2 + 1), which maps directly onto XLA's FFT, and carry a mask
that zeroes the Nyquist modes so the retained mode set matches the
reference exactly (|kx| <= kmax, 0 <= ky <= kmax with kmax = nx/2 - 1).

Everything here is static (Python-level) metadata: wavenumber arrays are
materialised once per (nx, ny, L) and closed over by jitted functions, so
nothing in this module is traced.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = ["SpectralGrid"]


@dataclasses.dataclass(frozen=True)
class SpectralGrid:
    """Static description of a periodic rectangular grid.

    Attributes:
      nx, ny: number of grid points in x (first axis) and y (second axis).
      Lx, Ly: domain lengths. The reference uses L = 2*pi for the RSW/QG
        solvers (rsw/swk.m:85) and L = 20 for the two-layer run
        (qg_flow_ray_trace/qg2layersw_raytrace.m:13).
    """

    nx: int
    ny: int
    Lx: float
    Ly: float

    # -- constructors ------------------------------------------------------

    @staticmethod
    def square(nx: int, L: float = 2.0 * np.pi) -> "SpectralGrid":
        return SpectralGrid(nx=nx, ny=nx, Lx=float(L), Ly=float(L))

    # -- grid-space coordinates -------------------------------------------

    @property
    def dx(self) -> float:
        return self.Lx / self.nx

    @property
    def dy(self) -> float:
        return self.Ly / self.ny

    @cached_property
    def x(self) -> np.ndarray:
        """Periodic sample points in [0, Lx).

        Index 0 sits at x = 0, matching both the FFT convention and the
        off-grid interpolation's index map (index = x/dx mod nx,
        qg_flow_ray_trace/interpolate.m:21). Use `wrap_centered` to view
        positions in [-L/2, L/2) as the reference drivers do on save
        (qgsw_raytrace.m:160).
        """
        return self.dx * np.arange(self.nx)

    @cached_property
    def y(self) -> np.ndarray:
        return self.dy * np.arange(self.ny)

    def wrap_centered(self, pos, axis: str = "x"):
        """Map positions into [-L/2, L/2) (mod L), the reference's output
        convention mod(x + L/2, L) - L/2."""
        L = self.Lx if axis == "x" else self.Ly
        return np.mod(np.asarray(pos) + L / 2, L) - L / 2

    def meshgrid(self):
        """(X, Y) with indexing='ij' (first axis = x), as the reference's
        ndgrid (qg2layersw_raytrace.m:16)."""
        return np.meshgrid(self.x, self.y, indexing="ij")

    # -- spectral-space layout (rfft2) -------------------------------------

    @property
    def nky(self) -> int:
        """Number of retained ky modes in the rfft2 layout."""
        return self.ny // 2 + 1

    @property
    def kmax(self) -> int:
        """Largest retained integer wavenumber, matching the reference's
        kmax = nx/2 - 1 (qgsw_raytrace.m:18)."""
        return self.nx // 2 - 1

    @cached_property
    def kx(self) -> np.ndarray:
        """Physical x-wavenumbers in FFT order, shape (nx, 1)."""
        k = np.fft.fftfreq(self.nx, d=1.0 / self.nx)
        return (2.0 * np.pi / self.Lx) * k[:, None]

    @cached_property
    def ky(self) -> np.ndarray:
        """Physical y-wavenumbers (non-negative half), shape (1, nky)."""
        k = np.arange(self.nky)
        return (2.0 * np.pi / self.Ly) * k[None, :]

    @cached_property
    def K2(self) -> np.ndarray:
        """|k|^2 on the rfft2 half-plane, shape (nx, nky)."""
        return self.kx**2 + self.ky**2

    @cached_property
    def K(self) -> np.ndarray:
        return np.sqrt(self.K2)

    @cached_property
    def nyquist_mask(self) -> np.ndarray:
        """1.0 on modes the reference retains, 0.0 on the Nyquist row/col.

        The reference's half-plane layout simply has no slot for the
        Nyquist modes (fulspec.m zero-pads them); applying this mask after
        every forward transform reproduces that truncation.
        """
        m = np.ones((self.nx, self.nky))
        m[self.nx // 2, :] = 0.0
        m[:, self.nky - 1] = 0.0 if self.ny % 2 == 0 else 1.0
        return m

    def dealias_mask(self, circular: bool = True) -> np.ndarray:
        """Orszag 2/3-rule mask.

        circular=True matches the reference's radial cutoff
        kcut = sqrt(8/9) * (kmax + 1) (rsw/swk.m:92-95); False gives the
        standard per-axis 2/3 rule.
        """
        ikx = np.fft.fftfreq(self.nx, d=1.0 / self.nx)[:, None]
        iky = np.arange(self.nky)[None, :]
        if circular:
            kcut = np.sqrt(8.0 / 9.0) * (self.kmax + 1)
            m = (np.sqrt(ikx**2 + iky**2) <= kcut).astype(np.float64)
        else:
            cx = (2.0 / 3.0) * (self.nx // 2)
            cy = (2.0 / 3.0) * (self.ny // 2)
            m = ((np.abs(ikx) <= cx) & (iky <= cy)).astype(np.float64)
        return m * self.nyquist_mask

    # -- misc ---------------------------------------------------------------

    @property
    def spectral_shape(self) -> tuple:
        return (self.nx, self.nky)

    @property
    def shape(self) -> tuple:
        return (self.nx, self.ny)
