"""Carry JAX parameters and state into the port.

``from_jax`` takes a parameter or state pytree of the JAX package, given
as numpy arrays (``jax.device_get(tree)`` or an orbax checkpoint restored
to numpy), and returns the same structure of torch tensors on ``device``
with the same dtypes. Containers are nested dicts, tuples and lists;
``None`` and Python scalars pass through. ``train_state_from_jax`` carries
a whole train state of either family across, its optax Adam state
included. The port does not import JAX: the caller hands over numpy.
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


def train_state_from_jax(state: Any, config: Any,
                         device: Union[str, torch.device]) -> Any:
    """A JAX ``TrainState`` / ``SrTrainState`` given as numpy
    (``jax.device_get(state)``) → the port's, on ``device``.

    optax's ``(ScaleByAdamState(count, mu, nu), EmptyState())`` becomes
    the port's ``torch.optim.Adam`` state at ``config.learning_rate``:
    ``mu`` the first moments, ``nu`` the second, ``count`` the step."""
    from dvf_tpu_torch.train import optim

    dev = torch.device(device)
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    params = optim.trainable(from_jax(state.params, dev), dev)
    opt = optim.adam(params, config.learning_rate)
    optim.set_adam_state(opt, params, int(adam.count),
                         optim.flatten(from_jax(adam.mu, dev)),
                         optim.flatten(from_jax(adam.nu, dev)))
    step = from_jax(np.asarray(state.step, np.int32), dev)
    if hasattr(state, "vgg_params"):
        from dvf_tpu_torch.train.style import TrainState

        return TrainState(params=params, opt_state=opt,
                          vgg_params=from_jax(state.vgg_params, dev),
                          style_grams=[from_jax(np.asarray(g), dev)
                                       for g in state.style_grams],
                          step=step)
    from dvf_tpu_torch.train.sr import SrTrainState

    return SrTrainState(params=params, opt_state=opt, step=step)
