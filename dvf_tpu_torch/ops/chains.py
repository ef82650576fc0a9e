"""Prebuilt filter chains (port of ``dvf_tpu.ops.chains``).

``sobel_bilateral`` is BASELINE.json configs[2] ("Sobel-edge + bilateral
filter chain, 1080p, batch=16"). Its ``impl="chain"`` form — the two plain
ops composed — is the plain version of the fused Sobel+bilateral kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from dvf_tpu_torch.api.filter import Filter, FilterChain, stateless
from dvf_tpu_torch.ops.bilateral import bilateral_nhwc
from dvf_tpu_torch.ops.conv import sobel_gradients
from dvf_tpu_torch.ops.registry import get_filter, register_filter
from dvf_tpu_torch.utils.image import rgb_to_gray


@register_filter("sobel_bilateral")
def sobel_bilateral(
    d: int = 5, sigma_color: float = 0.1, sigma_space: float = 2.0,
    magnitude_scale: float = 1.0, impl: Optional[str] = None,
) -> Filter:
    """BASELINE configs[2]: Sobel edges then bilateral.

    ``impl=None`` resolves to "pallas", the fused hand-written kernel
    (``sobel_bilateral_pallas``: the edge map never leaves shared
    memory). "chain" pins the two plain ops composed. Both declare the
    same halo.
    """
    if impl is None:
        impl = "pallas"
    if impl == "pallas":
        return get_filter("sobel_bilateral_pallas", d=d,
                          sigma_color=sigma_color, sigma_space=sigma_space,
                          magnitude_scale=magnitude_scale)
    if impl != "chain":
        raise ValueError(f"impl must be 'chain' or 'pallas', got {impl!r}")
    return FilterChain(
        get_filter("sobel", magnitude_scale=magnitude_scale),
        # impl pinned: "chain" is the plain baseline end to end — unpinned,
        # the nested bilateral would resolve to the kernel.
        get_filter("bilateral", d=d, sigma_color=sigma_color,
                   sigma_space=sigma_space, impl="jnp"),
        name=f"sobel_bilateral(d={d})",
    )


@register_filter("chain")
def chain(specs=()) -> Filter:
    """Generic chain from a list of (name, config) pairs or names."""
    members = []
    for spec in specs:
        if isinstance(spec, str):
            members.append(get_filter(spec))
        else:
            name, cfg = spec
            members.append(get_filter(name, **cfg))
    return FilterChain(*members)


@register_filter("cartoon")
def cartoon(d: int = 5, sigma_color: float = 0.15, sigma_space: float = 3.0,
            levels: int = 6, edge_scale: float = 2.0) -> Filter:
    """Cartoon effect: bilateral smoothing + posterized colors, darkened
    along Sobel edges."""
    if levels < 2:
        raise ValueError("levels must be >= 2")  # levels=1 → 0/0 = NaN frames

    def fn(batch: torch.Tensor) -> torch.Tensor:
        smooth = bilateral_nhwc(batch, d=d, sigma_color=sigma_color,
                                sigma_space=sigma_space)
        n = float(levels - 1)
        quant = torch.round(torch.clamp(smooth, 0.0, 1.0) * n) / n
        gx, gy = sobel_gradients(rgb_to_gray(batch))
        edge = torch.clamp(torch.sqrt(gx * gx + gy * gy) * edge_scale, 0.0, 1.0)
        return (quant * (1.0 - edge)).to(batch.dtype)

    # Bilateral (d//2) and Sobel (1) both read the original batch: the
    # halo is their max, and never 0.
    return stateless(f"cartoon(d={d},levels={levels})", fn,
                     halo=max(d // 2, 1))
