"""utils/pytree.py: the frozen pytree dataclass that carries simulation
state (CoupledCarry, QG states, flows) through jit, vmap, grad and
lax.scan."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from swraytracing.utils import pytree


@pytree.dataclass
class _Thing:
    a: jnp.ndarray
    scale: float = pytree.field(pytree_node=False, default=2.0)
    b: jnp.ndarray | None = None


def test_replace_and_frozen():
    t = _Thing(a=jnp.ones(3))
    u = t.replace(b=jnp.zeros(2))
    assert t.b is None and u.b.shape == (2,)
    assert u.scale == 2.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.a = jnp.zeros(3)


def test_static_fields_are_treedef_metadata():
    t = _Thing(a=jnp.ones(3), scale=5.0, b=jnp.ones(2))
    leaves, treedef = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2                       # a, b; scale is static
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.scale == 5.0
    # a different static value is a different treedef (a jit retrace)
    assert treedef != jax.tree_util.tree_structure(t.replace(scale=1.0))
    # None children stay None through tree.map
    assert jax.tree.map(lambda x: x * 2, _Thing(a=jnp.ones(1))).b is None


def test_jit_vmap_grad_through_coupled_carry():
    from swraytracing.models.coupled import CoupledConfig, setup_coupled

    s, carry = setup_coupled(CoupledConfig(nx=16, n_packets=8,
                                           T_Fr_days=5.0))
    # jit: a carry in, a replaced carry out
    moved = jax.jit(lambda c: c.replace(packet_x=c.packet_x + 1.0))(carry)
    np.testing.assert_allclose(np.asarray(moved.packet_x),
                               np.asarray(carry.packet_x) + 1.0)
    assert moved.prev_win is None and moved.overflow is None
    # vmap over a stacked batch of carries
    batch = jax.tree.map(lambda a: jnp.stack([a, a]), carry)
    sums = jax.vmap(lambda c: jnp.sum(c.packet_k ** 2))(batch)
    assert sums.shape == (2,)
    # grad w.r.t. a field inside the carry
    g = jax.grad(lambda px: jnp.sum(
        carry.replace(packet_x=px).packet_x ** 2))(carry.packet_x)
    np.testing.assert_allclose(np.asarray(g), 2 * np.asarray(carry.packet_x))
