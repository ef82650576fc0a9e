"""Pointwise filters (port of ``dvf_tpu.ops.pointwise``).

``invert`` is the reference's one op (``cv2.bitwise_not``): on uint8 it
runs as ``255 - x`` directly on the wire dtype, with no float round trip.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.ops.registry import register_filter
from dvf_tpu_torch.utils.image import rgb_to_gray


@register_filter("invert")
def invert() -> Filter:
    """Color invert (cv2.bitwise_not)."""
    def fn(batch: torch.Tensor) -> torch.Tensor:
        if batch.dtype == torch.uint8:
            return 255 - batch
        return 1.0 - batch

    return stateless("invert", fn, uint8_ok=True, halo=0)


@register_filter("identity")
def identity() -> Filter:
    """Pass-through — the null filter, to measure pipeline overhead."""
    return stateless("identity", lambda batch: batch, uint8_ok=True, halo=0)


@register_filter("grayscale")
def grayscale() -> Filter:
    """Rec.601 luma, broadcast back to the input's channels."""
    def fn(batch: torch.Tensor) -> torch.Tensor:
        return rgb_to_gray(batch, keepdims=True).expand(batch.shape)

    return stateless("grayscale", fn, halo=0)


@register_filter("brightness_contrast")
def brightness_contrast(alpha: float = 1.0, beta: float = 0.0) -> Filter:
    """out = alpha * x + beta (x in [0,1])."""
    def fn(batch: torch.Tensor) -> torch.Tensor:
        return torch.clamp(alpha * batch + beta, 0.0, 1.0)

    return stateless(f"brightness_contrast(a={alpha},b={beta})", fn, halo=0)


@register_filter("gamma")
def gamma(g: float = 2.2) -> Filter:
    """Gamma correction: out = x ** g on x clipped to [0,1]."""
    def fn(batch: torch.Tensor) -> torch.Tensor:
        return torch.pow(torch.clamp(batch, 0.0, 1.0), g)

    return stateless(f"gamma({g})", fn, halo=0)


@register_filter("threshold")
def threshold(t: float = 0.5) -> Filter:
    """Binary threshold at t."""
    def fn(batch: torch.Tensor) -> torch.Tensor:
        return (batch > t).to(batch.dtype)

    return stateless(f"threshold({t})", fn, halo=0)


# Classic sepia matrix, rows = output RGB.
_SEPIA = ((0.393, 0.769, 0.189),
          (0.349, 0.686, 0.168),
          (0.272, 0.534, 0.131))


@register_filter("sepia")
def sepia() -> Filter:
    """Classic sepia tone matrix."""
    def fn(batch: torch.Tensor) -> torch.Tensor:
        m = torch.tensor(_SEPIA, dtype=batch.dtype, device=batch.device)
        out = torch.einsum("...c,oc->...o", batch, m)
        return torch.clamp(out, 0.0, 1.0)

    return stateless("sepia", fn, halo=0)


@register_filter("posterize")
def posterize(levels: int = 4) -> Filter:
    """Quantize each channel to ``levels`` evenly-spaced values."""
    if levels < 2:
        raise ValueError("levels must be >= 2")

    def fn(batch: torch.Tensor) -> torch.Tensor:
        n = float(levels - 1)
        return torch.round(torch.clamp(batch, 0.0, 1.0) * n) / n

    return stateless(f"posterize({levels})", fn, halo=0)


@register_filter("median_blur")
def median_blur(ksize: int = 3) -> Filter:
    """3×3 median matching ``cv2.medianBlur``: edge-replicate borders and
    Smith's 19-exchange median-of-9 network over the shifted views.
    ``halo=None``: the border is edge-replicate, not reflect-101, so the
    filter is never spatially sharded."""
    if ksize != 3:
        raise ValueError(
            f"median_blur supports ksize=3 only (got {ksize}); larger "
            f"medians need a different algorithm (histogram-based) to be "
            f"worth their arithmetic on any backend")

    def fn(batch: torch.Tensor) -> torch.Tensor:
        h, w = batch.shape[1], batch.shape[2]
        x = F.pad(batch.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
        x = x.permute(0, 2, 3, 1)
        v = [x[:, dy:dy + h, dx:dx + w, :]
             for dy in range(3) for dx in range(3)]

        def ex(a, b):
            # compare-exchange: v[a] <- min, v[b] <- max
            v[a], v[b] = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])

        ex(1, 2); ex(4, 5); ex(7, 8)
        ex(0, 1); ex(3, 4); ex(6, 7)
        ex(1, 2); ex(4, 5); ex(7, 8)
        ex(0, 3); ex(5, 8); ex(4, 7)
        ex(3, 6); ex(1, 4); ex(2, 5)
        ex(4, 7); ex(4, 2); ex(6, 4)
        ex(4, 2)
        return v[4].contiguous()

    return stateless("median_blur(k=3)", fn, halo=None)
