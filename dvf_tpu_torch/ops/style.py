"""Style-transfer filter op (port of ``dvf_tpu.ops.style``).

Wraps :mod:`dvf_tpu_torch.models.style_transfer` as a registered,
stateful filter: the network params ARE the filter state, moved to the
engine's device once by ``init_state`` and returned unchanged each batch
(inference only). Covers BASELINE.json configs[4]. The mesh hooks
(``specialize``, ``state_pspecs``) wait for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.models.layers import tree_to
from dvf_tpu_torch.models.style_transfer import (
    StyleNetConfig,
    apply_style_net,
    init_style_net,
    pp_sequential_apply,
    to_pp_params,
)
from dvf_tpu_torch.ops.registry import measured_default_for, register_filter

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_of(dtype: Optional[str]) -> torch.dtype:
    """The model compute dtype named by a factory's ``dtype`` argument."""
    if dtype is None:
        dtype = "bfloat16"
    if dtype not in _DTYPES:
        raise ValueError(
            f"dtype must be 'bfloat16' or 'float32', got {dtype!r}")
    return _DTYPES[dtype]


@register_filter("style_transfer")
def style_transfer(
    params: Optional[Any] = None,
    base_channels: int = 32,
    n_residual: int = 5,
    seed: int = 0,
    parallel: str = "tp",
    fast_convs: Optional[bool] = None,
    dtype: Optional[str] = None,
) -> Filter:
    """``params=None`` → seeded random weights (demo/benchmark weights);
    pass a trained param tree (tensors or numpy arrays in the reference's
    layout, e.g. ``train.checkpoint.load_params``) for real stylization.

    ``fast_convs=None`` resolves the exact conv rewrites from the measured
    winner (``MEASURED_DEFAULTS["style_fast"]``: "ref" until an A/B on the
    card commits one). ``dtype``: "bfloat16" (default) or "float32".
    ``parallel``: "tp" runs the flat net; "pp" carries the trunk as
    stacked blocks (the pipeline grouping) and loops over them. On one
    device both compute the same function.
    """
    if parallel not in ("tp", "pp"):
        raise ValueError(f"parallel must be 'tp' or 'pp', got {parallel!r}")
    if fast_convs is None:
        fast_convs = measured_default_for("style_fast") == "fast"
    config = StyleNetConfig(
        base_channels=base_channels, n_residual=n_residual,
        compute_dtype=compute_dtype_of(dtype), fast_convs=bool(fast_convs))

    def flat_params(device):
        flat = params if params is not None else init_style_net(seed, config)
        return tree_to(flat, device)

    if parallel == "pp":
        _seq_apply = pp_sequential_apply(config)

        def fn(batch: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
            return _seq_apply(state, batch), state

        def init_state(batch_shape, dtype, device):
            return to_pp_params(flat_params(device), config)
    else:
        def fn(batch: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
            return apply_style_net(state, batch, config), state

        def init_state(batch_shape, dtype, device):
            return flat_params(device)

    return Filter(
        name=f"style_transfer(c={base_channels},r={n_residual},{parallel})",
        fn=fn,
        init_state=init_state,
        compute_dtype=torch.float32,
    )
