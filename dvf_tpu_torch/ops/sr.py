"""Super-resolution and upscale filter ops (port of ``dvf_tpu.ops.sr``).

``super_resolution`` wraps :mod:`dvf_tpu_torch.models.espcn` (the
default, ``arch="espcn"``) or :mod:`dvf_tpu_torch.models.hat`
(``arch="hat"``, ×4) as a stateful filter whose params are its state,
like ``style_transfer``. Both filters here change the output geometry
((H, W) → (H·r, W·r)); the engine sizes its output from what the filter
returns. On a mesh with a ``model`` axis, ESPCN's ``specialize`` swaps in
the tensor-parallel body (``parallel.sharded.tp_filter``), as
``style_transfer`` does; HAT has none and runs the generic body with
replicated weights.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.models.espcn import (EspcnConfig, apply_espcn, init_espcn,
                                        param_pspecs, tp_inner_steps)
from dvf_tpu_torch.models.hat import (HatConfig, HatStats, apply_prepared, init_hat,
                                      marks_for, prepare_hat)
from dvf_tpu_torch.models.layers import compute_dtype_of, tree_to, upsample_nearest
from dvf_tpu_torch.ops.registry import measured_default_for, register_filter


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
    arch: str = "espcn",
    tracer: Any = None,
) -> Filter:
    """``params=None`` → seeded random weights (benchmark weights); pass
    a trained param tree (``train.checkpoint.load_params``) for real
    upscaling. ``fast_convs=None`` resolves the space-to-depth rewrite
    from ``MEASURED_DEFAULTS["espcn_fast"]`` ("ref" until an A/B on the
    card commits a winner); ``dtype`` as in ``style_transfer``.

    ``arch="hat"``: HAT-SRx4 (:mod:`dvf_tpu_torch.models.hat`), ``scale``
    4 only, ``params`` an ``init_hat`` tree, ``fast_convs`` unused. An
    enabled ``tracer`` (``obs.trace.Tracer``) gets its spans, and the
    filter's ``fn.stats`` (``HatStats``) its counters."""
    cd = compute_dtype_of(dtype)
    if arch == "hat":
        return _hat_filter(params, scale, seed, cd, tracer)
    if arch != "espcn":
        raise ValueError(f"arch must be 'espcn' or 'hat', got {arch!r}")
    if fast_convs is None:
        fast_convs = measured_default_for("espcn_fast") == "fast"
    config = EspcnConfig(scale=scale, compute_dtype=cd, fast_convs=bool(fast_convs))

    def fn(batch: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
        return apply_espcn(state, batch, config), state

    def init_state(batch_shape, dtype, device):
        return tree_to(params if params is not None else init_espcn(seed, config),
                       device)

    name = f"super_resolution(x{scale})"

    def specialize(mesh, batch_shape) -> Optional[Filter]:
        if mesh.axis_size("model") <= 1:
            return None  # generic body; params replicate over size-1 axis
        from dvf_tpu_torch.parallel.sharded import tp_filter

        return tp_filter(name, tp_inner_steps(config), param_pspecs(config),
                         init_state, config.compute_dtype, mesh, batch_shape)

    return Filter(
        name=name,
        fn=fn,
        init_state=init_state,
        compute_dtype=torch.float32,
        state_pspecs=lambda: param_pspecs(config),
        specialize=specialize,
    )


class _HatStep:
    """HAT's filter body: the forward on the prepared weights (the state),
    its spans and counters recorded while ``tracer`` is enabled; each
    span's ``seq`` is the number of this body's call, from 0."""

    def __init__(self, config: HatConfig, tracer):
        self.config, self.tracer = config, tracer
        self.stats = HatStats()

    def __call__(self, batch: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
        traced = self.tracer is not None and self.tracer.enabled
        stats = self.stats if traced else None
        marks = marks_for(self.tracer, batch.device, self.stats.batches)
        y = apply_prepared(state, batch, self.config, stats, marks)
        if traced:
            self.stats.batches += 1
            self.stats.frames += batch.shape[0]
        return y.to(batch.dtype), state


def _hat_filter(params, scale, seed, compute_dtype, tracer) -> Filter:
    if scale != 4:
        raise ValueError(f"arch='hat' is the published x4 network; scale must be 4, got {scale}")
    config = HatConfig(compute_dtype=compute_dtype)

    def init_state(batch_shape, dtype, device):
        return prepare_hat(params if params is not None else init_hat(seed, config),
                           config, device)

    def specialize(mesh, batch_shape) -> Optional[Filter]:
        n_model = mesh.axis_size("model")
        if n_model > 1:
            import sys

            print(f"[super_resolution] hat has no tensor-parallel body; running "
                  f"unspecialized over the model axis ({n_model}) with replicated "
                  f"params", file=sys.stderr)
        return None

    return Filter(name="super_resolution(hat,x4)", fn=_HatStep(config, tracer),
                  init_state=init_state, compute_dtype=torch.float32,
                  specialize=specialize)
