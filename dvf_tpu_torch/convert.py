"""Carry JAX parameters and state into the port.

``from_jax`` takes a parameter or state pytree of the JAX package, given
as numpy arrays (``jax.device_get(tree)`` or an orbax checkpoint restored
to numpy), and returns the same structure of torch tensors on ``device``
with the same dtypes. Containers are nested dicts, tuples and lists;
``None`` and Python scalars pass through. The port does not import JAX: the
caller hands over numpy.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # an owned, writable copy; keeps 0-d shapes
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands out ml_dtypes'):
        # carry the 16-bit patterns across and reinterpret them.
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax(tree: Any, device: Union[str, torch.device]) -> Any:
    """Numpy pytree → the same pytree of tensors on ``device``."""
    device = torch.device(device)
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    if isinstance(tree, np.ndarray):
        return _leaf(tree, device)
    if isinstance(tree, np.generic):
        return _leaf(np.asarray(tree), device)
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [from_jax(v, device) for v in tree]
        # namedtuples rebuild from positional fields
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [from_jax(v, device) for v in tree]
    raise TypeError(
        f"from_jax: unsupported leaf of type {type(tree).__name__}; pass "
        f"numpy arrays (jax.device_get the tree first)")
