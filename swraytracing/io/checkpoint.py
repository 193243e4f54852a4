"""Deterministic checkpoint/resume of full simulation state.

The reference's only restart mechanism is "frames already written are
kept" in its append-per-frame binaries (SURVEY.md section 5;
write_field.m fseek addressing) plus ad-hoc .mat restarts
(raytrace_sw.m:11). Here any pytree (flow state + packet state + step
counters, e.g. CoupledCarry) round-trips to an .npz with its tree
structure recorded, so a crashed run resumes bit-exactly at the last
checkpointed step.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import jax

from ..utils.host import fetch

__all__ = ["save_state", "restore_state", "latest_checkpoint"]


def save_state(path, state, step: int | None = None) -> str:
    """Save a pytree to <path>[_<step>].npz (atomic rename)."""
    path = Path(path)
    if step is not None:
        path = path.with_name(f"{path.stem}_{step:012d}")
    path = path.with_suffix(".npz")
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i}": fetch(leaf) for i, leaf in enumerate(leaves)}
    tmp = path.with_suffix(".npz.tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, __treedef__=np.frombuffer(
            json.dumps(str(treedef)).encode(), dtype=np.uint8), **arrays)
    tmp.rename(path)
    return str(path)


def restore_state(path, like, to_device: bool = False):
    """Restore into the structure of pytree `like` (shapes/dtypes must
    match what was saved). `to_device=True` additionally ships the leaves
    to the default device."""
    with np.load(path) as data:
        leaves_like, treedef = jax.tree_util.tree_flatten(like)
        n = len(leaves_like)
        leaves = [np.asarray(data[f"leaf_{i}"]) for i in range(n)]
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    return jax.device_put(tree) if to_device else tree


def latest_checkpoint(directory, prefix: str = "ckpt") -> str | None:
    cands = sorted(Path(directory).glob(f"{prefix}_*.npz"))
    return str(cands[-1]) if cands else None
