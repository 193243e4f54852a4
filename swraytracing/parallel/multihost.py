"""Multi-host execution helpers.

The reference's only multi-node mechanism is SLURM launching independent
MATLAB processes (SURVEY.md section 2.7). Here: one SPMD program over
all hosts — `jax.distributed.initialize()` + a global (ensemble,
packets) mesh spanning every device; packet arrays are created
host-locally and assembled into global arrays, and the SPMD
partitioner inserts the collectives.

Exercised for real by tests/test_multiprocess.py: two OS processes with
4 virtual CPU devices each join through jax.distributed over localhost
(gRPC coordinator + gloo collectives standing in for DCN), assemble
process-local packet blocks into global sharded arrays, run the jitted
coupled chunk SPMD, and the assembled result matches a single-process
run. Real pods use the identical calls with auto-detected arguments.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharding import make_mesh

__all__ = ["initialize", "global_packet_array", "host_local_slice"]


def initialize(coordinator: str | None = None, num_processes: int | None
               = None, process_id: int | None = None):
    """jax.distributed.initialize; without a cluster environment give
    the coordinator address, process count and id explicitly. Call
    before any jax op."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_packet_array(local_np_array, mesh: Mesh, spec: P | None = None):
    """Assemble per-host packet blocks into one global sharded array
    (jax.make_array_from_process_local_data): each host contributes its
    local packets. Packet arrays are coordinate-first (2, Np_local), so
    the sharded packet axis is the LAST one by default."""
    if spec is None:
        ndim = np.asarray(local_np_array).ndim
        spec = P(*[None] * (ndim - 1), ("ensemble", "packets"))
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding,
                                                  np.asarray(local_np_array))


def host_local_slice(global_array, axis: int = -1):
    """The addressable (this-host) shards of a global array, concatenated
    along the packet axis (last, coordinate-first layout) — for host-side
    I/O of packet frames (each host writes its own slice; frame-addressed
    binio supports disjoint writes)."""
    shards = [np.asarray(s.data) for s in global_array.addressable_shards]
    return np.concatenate(shards, axis=axis) if shards else np.empty((0,))
