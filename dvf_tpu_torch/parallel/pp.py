"""Layer pipeline parallelism helpers (port of ``dvf_tpu.parallel.pp``).

Only :func:`stack_layer_params` is ported: the single-device
``parallel="pp"`` path of the style net runs the stacked residual trunk
as a sequential loop. ``pipeline_apply`` (the GPipe schedule across
devices) waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch


def stack_layer_params(params_list: Sequence[Any]) -> Any:
    """Stack per-layer param trees (same structure: nested dicts of
    tensors) along a new leading axis: L trees → one tree whose leaves
    have leading dim L."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_layer_params([p[k] for p in params_list]) for k in first}
    return torch.stack(list(params_list), dim=0)
