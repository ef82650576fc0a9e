"""``dvf_tpu_torch.convert.from_jax`` carries a JAX pytree into the port."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvf_tpu_torch.convert import from_jax


def test_nested_tree_keeps_structure_values_and_dtypes():
    Pair = collections.namedtuple("Pair", "a b")
    tree = {
        "conv": {"w": jnp.arange(24, dtype=jnp.float32).reshape(2, 3, 4),
                 "b": jnp.zeros((4,), jnp.bfloat16) + 1.5},
        "steps": jnp.asarray(7, jnp.int32),
        "window": (jnp.ones((2, 2), jnp.uint8), None),
        "stack": [jnp.asarray([1, -2], jnp.int16), Pair(jnp.asarray(True), 3)],
    }
    got = from_jax(jax.device_get(tree), "cpu")
    assert got["conv"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(got["conv"]["w"].numpy(),
                                  np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    assert got["conv"]["b"].dtype == torch.bfloat16
    assert got["conv"]["b"].float().tolist() == [1.5] * 4
    assert got["steps"].dtype == torch.int32 and got["steps"].item() == 7
    assert isinstance(got["window"], tuple) and got["window"][1] is None
    assert got["window"][0].dtype == torch.uint8
    assert isinstance(got["stack"], list)
    assert got["stack"][0].dtype == torch.int16
    assert type(got["stack"][1]) is Pair and got["stack"][1].b == 3
    assert got["stack"][1].a.dtype == torch.bool


def test_unsupported_leaf_raises():
    with pytest.raises(TypeError, match="device_get"):
        from_jax({"x": object()}, "cpu")
