"""Bilateral filter — edge-preserving smoothing (port of
``dvf_tpu.ops.bilateral``).

``bilateral_nhwc`` is the plain version of the hand-written bilateral
kernel (``dvf_tpu_torch.ops.kernels.bilateral_nhwc``): the d×d window
unrolled into shifted views, weight = spatial Gaussian × exp(−‖Δrgb‖² /
2σc²), reflect-101 borders, float32 numerator and denominator. The range
kernel uses Euclidean color distance like cv2.bilateralFilter.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.ops.conv import reflect_pad_nhwc
from dvf_tpu_torch.ops.registry import get_filter, register_filter


def bilateral_nhwc(
    batch: torch.Tensor,
    d: int = 5,
    sigma_color: float = 0.1,
    sigma_space: float = 2.0,
) -> torch.Tensor:
    """Bilateral filter over float NHWC in [0,1].

    ``sigma_color`` is in [0,1] intensity units (cv2 uses [0,255] units;
    scale by 255 to compare).
    """
    if d % 2 != 1:
        raise ValueError(f"window d must be odd, got {d}")
    r = d // 2
    h, w = batch.shape[1], batch.shape[2]
    pad = reflect_pad_nhwc(batch, r, r)

    inv2sc = 1.0 / (2.0 * sigma_color * sigma_color)
    num = torch.zeros_like(batch)
    den = torch.zeros(batch.shape[:-1] + (1,), dtype=batch.dtype,
                      device=batch.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            sw = math.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space * sigma_space))
            shifted = pad[:, r + dy:r + dy + h, r + dx:r + dx + w, :]
            diff = shifted - batch
            dist2 = torch.sum(diff * diff, dim=-1, keepdim=True)
            wgt = sw * torch.exp(-dist2 * inv2sc)
            num = num + wgt * shifted
            den = den + wgt
    return num / den


@register_filter("bilateral")
def bilateral(d: int = 5, sigma_color: float = 0.1, sigma_space: float = 2.0,
              impl: Optional[str] = None) -> Filter:
    """Edge-preserving bilateral smoothing (cv2.bilateralFilter semantics).

    ``impl=None`` resolves to "pallas", the hand-written kernel
    (``bilateral_pallas``); "jnp" pins the plain torch version. Both
    declare the same halo.
    """
    if impl is None:
        impl = "pallas"
    if impl == "pallas":
        return get_filter("bilateral_pallas", d=d, sigma_color=sigma_color,
                          sigma_space=sigma_space)
    if impl != "jnp":
        raise ValueError(f"impl must be 'jnp' or 'pallas', got {impl!r}")

    def fn(batch: torch.Tensor) -> torch.Tensor:
        return bilateral_nhwc(batch, d=d, sigma_color=sigma_color,
                              sigma_space=sigma_space)

    return stateless(f"bilateral(d={d},sc={sigma_color},ss={sigma_space})", fn,
                     halo=d // 2)
