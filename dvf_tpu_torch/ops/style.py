"""Style-transfer filter op (port of ``dvf_tpu.ops.style``).

Wraps :mod:`dvf_tpu_torch.models.style_transfer` as a registered,
stateful filter: the network params ARE the filter state, moved to the
engine's device once by ``init_state`` and returned unchanged each batch
(inference only). Covers BASELINE.json configs[4]. On a mesh with a
``model`` axis, ``specialize`` swaps in the tensor-parallel forward
(``parallel="tp"``) or the layer pipeline (``parallel="pp"``), and
``state_pspecs`` places the weights.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.models.layers import compute_dtype_of, tree_to
from dvf_tpu_torch.models.style_transfer import (
    StyleNetConfig,
    apply_style_net,
    init_style_net,
    param_pspecs,
    pp_inner_apply,
    pp_param_pspecs,
    pp_sequential_apply,
    to_pp_params,
    tp_inner_steps,
)
from dvf_tpu_torch.ops.registry import measured_default_for, register_filter

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
    ``parallel`` picks the model-axis strategy ``specialize`` builds
    when the mesh's model axis > 1:

    - ``"tp"`` — Megatron column/row tensor parallelism with an explicit
      sum across the ranks after each row-parallel conv
      (models.style_transfer.tp_inner_steps, parallel.sharded.tp_filter).
    - ``"pp"`` — layer pipeline parallelism over the residual trunk
      (models.style_transfer.pp_inner_apply / parallel.pp): each device
      owns n_residual/S contiguous blocks and activations hop stages on a
      GPipe schedule. Requires the model axis to divide n_residual; else
      the generic body runs with replicated weights (a line on stderr).

    On one device both compute the same function ("pp" loops over the
    stacked blocks).
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

    name = f"style_transfer(c={base_channels},r={n_residual},{parallel})"

    def specialize(mesh, batch_shape) -> Optional[Filter]:
        n_model = mesh.axis_size("model")
        if n_model <= 1:
            return None  # generic body; params replicate over size-1 axis
        from dvf_tpu_torch.parallel.sharded import model_axis_filter, tp_filter

        if parallel == "tp":
            return tp_filter(name, tp_inner_steps(config), param_pspecs(config),
                             init_state, config.compute_dtype, mesh, batch_shape)
        if config.n_residual % n_model != 0:
            import sys

            print(
                f"[style_transfer] pp needs model axis ({n_model}) to "
                f"divide n_residual ({config.n_residual}); running "
                f"unspecialized (replicated params)",
                file=sys.stderr,
            )
            return None
        return model_axis_filter(f"pp({name})", pp_inner_apply(config),
                                 pp_param_pspecs(config), init_state,
                                 config.compute_dtype, mesh, batch_shape)

    return Filter(
        name=name,
        fn=fn,
        init_state=init_state,
        compute_dtype=torch.float32,
        # TP specs are safe on any mesh (a size-1 model axis replicates);
        # PP's trunk specs are not (an indivisible model axis must
        # replicate), so the base PP filter replicates the whole grouping
        # and only the specialised filter stage-shards the trunk.
        state_pspecs=(lambda: pp_param_pspecs(config, stage_axis=None))
        if parallel == "pp" else (lambda: param_pspecs(config)),
        specialize=specialize,
    )
