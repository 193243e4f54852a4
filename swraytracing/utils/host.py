"""Device -> host transfer of pytrees."""

from __future__ import annotations

import numpy as np
import jax

__all__ = ["fetch"]


def fetch(tree):
    """Copy a pytree of device arrays to host numpy arrays."""
    return jax.tree.map(np.asarray, tree)
