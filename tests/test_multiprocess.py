"""REAL multi-process execution of the coupled driver (the multi-host
path, parallel/multihost.py): two OS processes, each owning 4 virtual
CPU devices, joined by jax.distributed over localhost — the same
coordinator + global-mesh + make_array_from_* machinery a multi-host
cluster uses (localhost gRPC/gloo stand in for the network). Each process assembles its
process-local packet block into the global sharded array, runs the
jitted coupled chunk SPMD, and writes back only its addressable slice;
the test verifies the assembled result equals a single-process run.

This upgrades multihost.py from wired-but-unexercised to executed:
initialize(), global_packet_array(), host_local_slice() all run for
real across a process boundary.
"""

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

WORKER = r"""
import functools, json, os, sys
import numpy as np

import jax
jax.config.update("jax_platforms", "cpu")

proc_id = int(sys.argv[1])
coord = sys.argv[2]
out_path = sys.argv[3]

from swraytracing.parallel import multihost as mh
mh.initialize(coordinator=coord, num_processes=2, process_id=proc_id)

jax.config.update("jax_enable_x64", True)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, jax.devices()

from jax.sharding import NamedSharding, PartitionSpec as P
from swraytracing.models.coupled import (CoupledConfig, setup_coupled,
                                             run_coupled_chunk)
from swraytracing.parallel.sharding import make_mesh

cfg = CoupledConfig(nx=32, n_packets=64, T_Fr_days=10.0,
                    packet_delay_days=0.1)
s, carry = setup_coupled(cfg)
mesh = make_mesh(jax.devices(), ensemble=1)

# every process holds the same deterministic host arrays (seeded setup);
# contribute the process-local half of the packet axis, replicate the rest
def put(leaf, spec):
    arr = np.asarray(leaf)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sh,
                                        lambda idx: arr[idx])

def put_tree(tree):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        name = path[-1].name if hasattr(path[-1], "name") else ""
        if name in ("packet_x", "packet_k"):
            out.append(put(leaf, P(None, ("ensemble", "packets"))))
        else:
            out.append(put(leaf, P()))
    return jax.tree_util.tree_unflatten(treedef, out)

# exercise multihost.global_packet_array: each process contributes its
# process-LOCAL packet block; the global array spans both
half = cfg.n_packets // 2
local_block = np.asarray(carry.packet_x)[:, proc_id * half:(proc_id + 1)
                                         * half]
gx = mh.global_packet_array(local_block, mesh)
assert gx.shape == (2, cfg.n_packets), gx.shape
back = mh.host_local_slice(gx)
assert np.array_equal(back, local_block)

carry = put_tree(carry)
run = jax.jit(functools.partial(run_coupled_chunk, s=s, cfg=cfg,
                                n_saves=2))
c2, (px, pk, ts) = run(carry)
local_x = mh.host_local_slice(c2.packet_x)
local_k = mh.host_local_slice(c2.packet_k)
np.savez(out_path, x=local_x, k=local_k,
         n_local_devices=jax.local_device_count())
print("worker", proc_id, "ok", local_x.shape)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_coupled_matches_single(tmp_path):
    # single-process reference (this pytest process, 8 virtual devices)
    import jax
    from swraytracing.models.coupled import (CoupledConfig,
                                                 setup_coupled,
                                                 run_coupled_chunk)

    cfg = CoupledConfig(nx=32, n_packets=64, T_Fr_days=10.0,
                        packet_delay_days=0.1)
    s, carry = setup_coupled(cfg)
    c_ref, _ = jax.jit(functools.partial(run_coupled_chunk, s=s, cfg=cfg,
                                         n_saves=2))(carry)
    ref_x = np.asarray(c_ref.packet_x)
    ref_k = np.asarray(c_ref.packet_k)

    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_PROCESSES", None)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
    procs = []
    for i in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, str(worker_py), str(i), coord,
             str(tmp_path / f"out{i}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"

    parts_x, parts_k = [], []
    for i in (0, 1):
        with np.load(tmp_path / f"out{i}.npz") as d:
            parts_x.append(d["x"])
            parts_k.append(d["k"])
            assert int(d["n_local_devices"]) == 4
    got_x = np.concatenate(parts_x, axis=-1)
    got_k = np.concatenate(parts_k, axis=-1)
    np.testing.assert_allclose(got_x, ref_x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_k, ref_k, rtol=1e-12, atol=1e-12)
