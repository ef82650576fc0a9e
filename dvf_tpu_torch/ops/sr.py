"""Super-resolution and upscale filter ops (port of ``dvf_tpu.ops.sr``).

``super_resolution`` wraps :mod:`dvf_tpu_torch.models.espcn` (the
default, ``arch="espcn"``), :mod:`dvf_tpu_torch.models.hat`
(``arch="hat"``, ×4) or :mod:`dvf_tpu_torch.models.basicvsrpp`
(``arch="basicvsrpp"``, ×4, a clip filter: the batch is one clip of
consecutive frames) as a stateful filter whose params are its state,
like ``style_transfer``. Both filters here change the output geometry
((H, W) → (H·r, W·r)); the engine sizes its output from what the filter
returns. On a mesh with a ``model`` axis, ESPCN's ``specialize`` swaps in
the tensor-parallel body (``parallel.sharded.tp_filter``), as
``style_transfer`` does; HAT and BasicVSR++ have none and run the generic
body with replicated weights, and BasicVSR++ refuses a mesh that would
split its clip (a ``data`` or ``space`` axis above 1).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.models import basicvsrpp
from dvf_tpu_torch.models.espcn import (EspcnConfig, apply_espcn, init_espcn,
                                        param_pspecs, tp_inner_steps)
from dvf_tpu_torch.models.hat import (HatConfig, HatStats, apply_prepared, init_hat,
                                      prepare_hat)
from dvf_tpu_torch.models.layers import compute_dtype_of, marks_for, tree_to, upsample_nearest
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
    filter's ``fn.stats`` (``HatStats``) its counters.

    ``arch="basicvsrpp"``: BasicVSR++ ×4
    (:mod:`dvf_tpu_torch.models.basicvsrpp`), ``scale`` 4 only, ``params``
    an ``init_basicvsrpp`` tree; a clip filter (``Filter.clip``): each
    batch is one clip of consecutive frames, so the batch size is the clip
    length. Spans and counters (``VsrStats``) as HAT's."""
    cd = compute_dtype_of(dtype)
    if arch == "hat":
        return _hat_filter(params, scale, seed, cd, tracer)
    if arch == "basicvsrpp":
        return _basicvsrpp_filter(params, scale, seed, cd, tracer)
    if arch != "espcn":
        raise ValueError(f"arch must be 'espcn', 'hat' or 'basicvsrpp', got {arch!r}")
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


class _VsrStep:
    """BasicVSR++'s filter body: the forward of one clip (the batch) on the
    prepared weights (the state), its spans and counters recorded while
    ``tracer`` is enabled; each span's ``seq`` is the number of this
    body's call, from 0. ``stats`` reads the padded frames counted on the
    device (one wait for the card, when read)."""

    def __init__(self, config: basicvsrpp.BasicVsrConfig, tracer):
        self.config, self.tracer = config, tracer
        self._stats = basicvsrpp.VsrStats()
        self._padded = None      # device count of padded frames not yet read

    @property
    def stats(self) -> basicvsrpp.VsrStats:
        if self._padded is not None:
            self._stats.padded_frames += int(self._padded)
            self._padded = None
        return self._stats

    def __call__(self, batch: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
        traced = self.tracer is not None and self.tracer.enabled
        stats = self._stats if traced else None
        marks = marks_for(self.tracer, batch.device, self._stats.clips)
        y = basicvsrpp.apply_prepared(state, batch, self.config, stats, marks)
        if traced:
            self._stats.clips += 1
            self._stats.frames += batch.shape[0]
            same = (batch[1:] == batch[:-1]).flatten(1).all(1).flip(0)
            tail = torch.cumprod(same.int(), 0).sum()
            self._padded = tail if self._padded is None else self._padded + tail
        return y.to(batch.dtype), state


def _basicvsrpp_filter(params, scale, seed, compute_dtype, tracer) -> Filter:
    if scale != 4:
        raise ValueError(f"arch='basicvsrpp' is the published x4 network; scale must be 4, "
                         f"got {scale}")
    config = basicvsrpp.BasicVsrConfig(compute_dtype=compute_dtype)
    name = "super_resolution(basicvsrpp,x4)"

    def init_state(batch_shape, dtype, device):
        return basicvsrpp.prepare_basicvsrpp(
            params if params is not None else basicvsrpp.init_basicvsrpp(seed, config),
            config, device)

    def specialize(mesh, batch_shape) -> Optional[Filter]:
        for axis in ("data", "space"):
            if mesh.axis_size(axis) > 1:
                raise ValueError(
                    f"{name} is a clip filter: a {axis!r} axis of {mesh.axis_size(axis)} "
                    f"would split its clip of consecutive frames")
        n_model = mesh.axis_size("model")
        if n_model > 1:
            import sys

            print(f"[super_resolution] basicvsrpp has no tensor-parallel body; running "
                  f"unspecialized over the model axis ({n_model}) with replicated "
                  f"params", file=sys.stderr)
        return None

    return Filter(name=name, fn=_VsrStep(config, tracer), init_state=init_state,
                  compute_dtype=torch.float32, specialize=specialize, clip=True)
