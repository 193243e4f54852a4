"""Frozen dataclasses registered as JAX pytrees.

`@dataclass` makes a frozen dataclass whose fields are pytree children
unless declared with `field(pytree_node=False)`, which makes them static
metadata (part of the treedef: hashed by jit, never traced). Instances
get `.replace(**changes)`, so carries are updated functionally inside
`lax.scan` / `jit` bodies.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(*, pytree_node: bool = True, **kwargs):
    """dataclasses.field that records whether the field is a pytree child
    (traced array data) or static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node},
                             **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + jax.tree_util.register_dataclass."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
