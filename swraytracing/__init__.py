"""swraytracing — shallow-water wave-packet raytracing in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
MATLAB research code ndefilippis/SWRaytracing: pseudo-spectral QG/RSW
background-flow solvers, differentiable off-grid evaluation of the flow
velocity and its gradients, symplectic and Runge–Kutta ray integrators
for near-inertial wave packets, a lock-step coupled flow+packet driver,
reference-compatible frame-addressed binary I/O, and the e(omega)
analysis pipeline — all pure-functional, scan/jit-compatible, and
shardable over device meshes.
"""

from .ops.grid import SpectralGrid
from .models.dispersion import Dispersion

__version__ = "0.1.0"
__all__ = ["SpectralGrid", "Dispersion"]
