"""Image dtype helpers shared by the filter library.

The on-device frame format is float32 NHWC in ``[0, 1]``; the wire/host
format is uint8 NHWC. Both casts reproduce ``dvf_tpu.utils.image`` bit for
bit: ``to_float`` multiplies by the float32 value of ``1/255`` (not a
division), and ``to_uint8`` clips, scales by 255 and rounds half to even
(``torch.round``, like ``jnp.round``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# Rec.601 luma weights — what cv2.cvtColor(..., COLOR_RGB2GRAY) uses.
_LUMA = (0.299, 0.587, 0.114)


def to_float(frame: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> float [0,1]; float inputs pass through as ``dtype``."""
    if frame.dtype == torch.uint8:
        return frame.to(dtype) * (1.0 / 255.0)
    return frame.to(dtype)


def to_uint8(frame: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8 [0,255]: clip, scale, round half to even."""
    if frame.dtype == torch.uint8:
        return frame
    scaled = torch.clamp(frame, 0.0, 1.0) * 255.0
    return torch.round(scaled).to(torch.uint8)


def rgb_to_gray(frame: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Rec.601 grayscale of (..., H, W, 3+) float frames."""
    r, g, b = frame[..., 0], frame[..., 1], frame[..., 2]
    gray = _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b
    return gray[..., None] if keepdims else gray


def center_crop(frame: torch.Tensor, size: int) -> torch.Tensor:
    """Center-crop (..., H, W, C) to (..., size, size, C), the reference
    app's crop of the 1280x720 capture to ``target_size``²."""
    h, w = frame.shape[-3], frame.shape[-2]
    top = (h - size) // 2
    left = (w - size) // 2
    return frame[..., top:top + size, left:left + size, :]


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize float NHWC ``x`` to ``size`` = (h, w): the counterpart of
    ``jax.image.resize(x, (b, h, w, c), method="linear")``.

    Half-pixel centres (``align_corners=False``) and, as JAX does by
    default, an antialiasing triangle filter widened by the scale factor
    on a downscale (``antialias=True``; without it a 2x downscale differs
    from JAX's by tenths of the range). Returns a contiguous NHWC tensor.
    """
    h, w = size
    if tuple(x.shape[1:3]) == (h, w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()
