"""The optimizer and the param-tree helpers both train families share.

The reference optimizes with ``optax.adam(lr)``. The port uses
``torch.optim.Adam`` with optax's defaults (betas 0.9 / 0.999, eps 1e-8,
no weight decay): its two bias corrections reduce to optax's update, so
one step from the same state agrees to float32 rounding. Its state is
the optimizer's own per-parameter ``exp_avg`` (optax's ``mu``),
``exp_avg_sq`` (``nu``) and ``step`` (``count``, shared by every leaf);
:func:`adam` fills it at construction (zero moments, count 0), so a fresh
state checkpoints like optax's initial one.

Param trees are nested dicts of tensors, keyed like the reference's;
:func:`flatten` names each leaf by its path ("<layer>/<leaf>"), the key of
the ``.npz`` checkpoints.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import torch

from dvf_tpu_torch.models.layers import exact_f32_convs

BETAS = (0.9, 0.999)
EPS = 1e-8


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict → {"a/b": leaf}, in the dict's own order."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b": leaf} → nested dict (the inverse of :func:`flatten`)."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        *parents, name = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return tree


def trainable(params: Any, device: torch.device) -> Dict[str, Any]:
    """An owned copy of a param tree on ``device``, each leaf a float
    tensor that requires grad (the reference's layout, so
    ``convert.from_jax`` output and checkpoints drop in)."""
    return unflatten({k: torch.as_tensor(v).detach().to(device).clone()
                      .requires_grad_(True) for k, v in flatten(params).items()})


def adam(params: Any, learning_rate: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over the leaves of ``params`` with optax's
    defaults, its state filled as optax's ``init`` fills it."""
    leaves = flatten(params)
    opt = torch.optim.Adam(list(leaves.values()), lr=learning_rate,
                           betas=BETAS, eps=EPS, weight_decay=0.0)
    set_adam_state(opt, params, 0,
                   {k: torch.zeros_like(v) for k, v in leaves.items()},
                   {k: torch.zeros_like(v) for k, v in leaves.items()})
    return opt


def adam_state(opt: torch.optim.Adam, params: Any
               ) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(count, first moments, second moments), the moments keyed by leaf
    path. The count is read from a CPU tensor: no device sync."""
    leaves = flatten(params)
    states = [opt.state[p] for p in leaves.values()]
    count = int(states[0]["step"])
    return (count, {k: s["exp_avg"] for k, s in zip(leaves, states)},
            {k: s["exp_avg_sq"] for k, s in zip(leaves, states)})


def set_adam_state(opt: torch.optim.Adam, params: Any, count: int,
                   mu: Dict[str, Any], nu: Dict[str, Any]) -> None:
    """Put optax's (count, mu, nu) into ``opt``: each moment copied onto
    its leaf's device and dtype; ``step`` a CPU float32 tensor, as
    ``torch.optim.Adam`` keeps it when it is neither capturable nor
    fused."""
    leaves = flatten(params)
    if set(mu) != set(leaves) or set(nu) != set(leaves):
        raise KeyError(f"adam moments {sorted(set(mu) ^ set(leaves))} do not "
                       f"match the params")
    for k, p in leaves.items():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.as_tensor(mu[k]).detach().to(p.device, p.dtype).clone(),
            "exp_avg_sq": torch.as_tensor(nu[k]).detach().to(p.device, p.dtype).clone(),
        }


def clone(params: Any, opt: torch.optim.Adam) -> Tuple[Dict[str, Any], torch.optim.Adam]:
    """Independent copies of a param tree and of its optimizer (its
    learning rate, moments and count)."""
    new = trainable(params, next(iter(flatten(params).values())).device)
    new_opt = adam(new, opt.param_groups[0]["lr"])
    set_adam_state(new_opt, new, *adam_state(opt, params))
    return new, new_opt


def single_device(mesh: Any, what: str) -> None:
    """The train steps run on one device, the state's: any mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what} over a mesh (the sharded train state) is not ported "
            f"yet (ROADMAP Queue 1 item 4c-iii); pass mesh=None (one device, "
            f"the state's)")


def descend(opt: torch.optim.Adam, loss_fn: Callable[[], Tuple[torch.Tensor, dict]],
            dtypes) -> dict:
    """One optimizer step on ``loss_fn()``'s loss: forward AND backward run
    with cuDNN's TF32 off where one of ``dtypes`` (the nets' compute
    dtypes) is float32 — a backward outside the block would convolve in
    TF32 on a card. Returns the loss function's metrics, detached 0-d
    tensors on the device (nothing here waits for the device)."""
    opt.zero_grad(set_to_none=True)
    with contextlib.ExitStack() as stack:
        for dtype in dtypes:
            stack.enter_context(exact_f32_convs(dtype))
        loss, metrics = loss_fn()
        loss.backward()
    opt.step()
    return {k: v.detach() for k, v in metrics.items()}
