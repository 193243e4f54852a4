"""Device-mesh sharding for packet ensembles (the reference has none).

The reference's only parallelism is a SLURM job array over 20 parameter
configs plus MATLAB's threaded FFT (SURVEY.md section 2.7, the
reference's runqgsw_raytrace.sbatch:10). Here:

  * axis "ensemble": independent (w0, U_g, f, Cg) configs — the SLURM
    sweep becomes a batched leading axis, one flow per member,
    vmapped/pjit-sharded over devices;
  * axis "packets": wave packets within one config — embarrassingly
    parallel in the forward pass; flow spectra are replicated across
    this axis (a 512^2 complex128 PV spectrum is ~4 MB — replication is
    free next to 1e6-packet state), and reverse-mode AD of
    flow-parameter gradients inserts the psum across packet shards
    automatically.

Everything here uses `jax.sharding` annotations + jit (the SPMD
partitioner inserts collectives). The packet march partitions itself by
the sharding of the packets it is given (ops/pallas_window.fused_march).
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "packet_sharding", "ensemble_sharding",
           "replicated", "shard_packets", "collective_census"]


def make_mesh(devices: Sequence | None = None,
              ensemble: int = 1,
              axis_names: tuple = ("ensemble", "packets")) -> Mesh:
    """Build a 2-D (ensemble, packets) mesh over the given devices.

    `ensemble` divides the device count; the remainder shards packets.
    ensemble=1 gives pure packet sharding (single-config runs).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % ensemble:
        raise ValueError(f"ensemble={ensemble} must divide n_devices={n}")
    arr = np.asarray(devices).reshape(ensemble, n // ensemble)
    return Mesh(arr, axis_names)


def packet_sharding(mesh: Mesh, batched: bool = False,
                    ndim: int = 2) -> NamedSharding:
    """Sharding for packet arrays. The packet axis is LAST (coordinate-
    first (2, Np) layout; see ops/interp.py): (..., Np) shards over the
    packets axis, or (E, ..., Np) over (ensemble, packets) when batched."""
    if batched:
        return NamedSharding(
            mesh, P("ensemble", *[None] * (ndim - 2), "packets"))
    return NamedSharding(
        mesh, P(*[None] * (ndim - 1), ("ensemble", "packets")))


def ensemble_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-config flow state (E, nx, nky): split the
    ensemble axis, replicate each member's spectrum across the packet
    axis."""
    return NamedSharding(mesh, P("ensemble"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_packets(mesh: Mesh, *arrays, batched: bool = False):
    """device_put packet arrays with the packet sharding (last axis =
    packets; works for (2, Np), (Np,), and batched (E, ..., Np))."""
    out = tuple(
        jax.device_put(a, packet_sharding(mesh, batched, ndim=a.ndim))
        for a in arrays)
    return out if len(out) > 1 else out[0]


_COLLECTIVE = re.compile(r"= (?:\([^)]*\)|\S+) (all-reduce|all-gather|"
                         r"reduce-scatter|collective-permute|all-to-all)"
                         r"(?:-start)?\(")


def collective_census(hlo_text: str) -> dict:
    """Count the collective definitions in compiled HLO text, by kind
    (async pairs counted once: -start yes, -done no)."""
    counts = {}
    for m in _COLLECTIVE.finditer(hlo_text):
        counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts
