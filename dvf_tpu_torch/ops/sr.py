"""Super-resolution and upscale filter ops (port of ``dvf_tpu.ops.sr``).

``super_resolution`` wraps :mod:`dvf_tpu_torch.models.espcn` as a
stateful filter whose params are its state, like ``style_transfer``.
Both filters here change the output geometry ((H, W) → (H·r, W·r)); the
engine sizes its output from what the filter returns. On a mesh with a
``model`` axis, ``super_resolution``'s ``specialize`` swaps in the
tensor-parallel body, as ``style_transfer`` does.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.models.espcn import (EspcnConfig, apply_espcn, init_espcn,
                                        param_pspecs, tp_inner_apply)
from dvf_tpu_torch.models.layers import tree_to, upsample_nearest
from dvf_tpu_torch.ops.registry import measured_default_for, register_filter
from dvf_tpu_torch.ops.style import compute_dtype_of, tp_filter


@register_filter("upscale")
def upscale(scale: int = 2, method: str = "nearest") -> Filter:
    """Stateless geometry-restoring upscale (the quality controller's
    return path in the reference). ``method``: ``nearest`` (exact pixel
    replication, dtype-preserving, so it runs on uint8 frames) or
    ``linear`` (bilinear with half-pixel centres, float frames; at ×s ≥ 1
    it is ``jax.image.resize``'s linear method: a border sample takes the
    edge pixel)."""
    s = int(scale)
    if s < 1:
        raise ValueError(f"scale must be >= 1, got {scale}")
    if method not in ("nearest", "linear"):
        raise ValueError(f"method must be 'nearest' or 'linear', "
                         f"got {method!r}")

    def fn(batch: torch.Tensor) -> torch.Tensor:
        if s == 1:
            return batch
        if method == "nearest":
            return upsample_nearest(batch, s)
        _, h, w, _ = batch.shape
        y = F.interpolate(batch.permute(0, 3, 1, 2), size=(h * s, w * s),
                          mode="bilinear", align_corners=False, antialias=False)
        return y.permute(0, 2, 3, 1)

    return stateless(f"upscale(scale={s})", fn,
                     uint8_ok=(method == "nearest"), halo=None)


@register_filter("super_resolution")
def super_resolution(
    params: Optional[Any] = None,
    scale: int = 2,
    seed: int = 0,
    fast_convs: Optional[bool] = None,
    dtype: Optional[str] = None,
) -> Filter:
    """``params=None`` → seeded random weights (benchmark weights); pass
    a trained param tree (``train.checkpoint.load_params``) for real
    upscaling. ``fast_convs=None`` resolves the space-to-depth rewrite
    from ``MEASURED_DEFAULTS["espcn_fast"]`` ("ref" until an A/B on the
    card commits a winner); ``dtype`` as in ``style_transfer``."""
    if fast_convs is None:
        fast_convs = measured_default_for("espcn_fast") == "fast"
    config = EspcnConfig(scale=scale, compute_dtype=compute_dtype_of(dtype),
                         fast_convs=bool(fast_convs))

    def fn(batch: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
        return apply_espcn(state, batch, config), state

    def init_state(batch_shape, dtype, device):
        return tree_to(params if params is not None else init_espcn(seed, config),
                       device)

    name = f"super_resolution(x{scale})"

    def specialize(mesh, batch_shape) -> Optional[Filter]:
        if mesh.axis_size("model") <= 1:
            return None  # generic body; params replicate over size-1 axis
        return tp_filter(name, tp_inner_apply(config), param_pspecs(config),
                         init_state, config.compute_dtype, mesh, batch_shape)

    return Filter(
        name=name,
        fn=fn,
        init_state=init_state,
        compute_dtype=torch.float32,
        state_pspecs=lambda: param_pspecs(config),
        specialize=specialize,
    )
