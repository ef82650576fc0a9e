"""Convolutional filters: separable Gaussian blur, box blur and the
running-sum box filter, Sobel edges (port of ``dvf_tpu.ops.conv``).

The plain formulation is stencil-as-shifted-FMAs (``impl="shift"``): k
shifted slices of one reflect-101-padded buffer, multiply-added per axis
in tap order. It is the plain version of the hand-written separable blur
kernel (``dvf_tpu_torch.ops.kernels.sep_blur_nhwc``) and the numerics
reference the kernel is held to. ``impl="depthwise"`` (two grouped
``F.conv2d`` passes) stays reachable as an explicit A/B pin; on a card it
goes through cuDNN, which computes float32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False. Borders are reflect-101
(``F.pad(mode="reflect")``), cv2's default ``BORDER_REFLECT_101``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.ops.registry import get_filter, register_filter
from dvf_tpu_torch.utils.image import rgb_to_gray

Taps = Union[torch.Tensor, np.ndarray, Sequence[float]]

# cv2.getGaussianKernel's fixed 1/256-quantized taps for small ksize.
_CV2_SMALL_GAUSS = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
    9: (0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375,
        0.19921875, 0.1171875, 0.05078125, 0.015625),
}


def gaussian_kernel_1d(ksize: int, sigma: float,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Match cv2.getGaussianKernel: fixed 1/256-quantized taps for small
    ksize with sigma<=0, else sigma<=0 -> 0.3*((k-1)*0.5 - 1) + 0.8."""
    if sigma <= 0 and ksize in _CV2_SMALL_GAUSS:
        return torch.tensor(_CV2_SMALL_GAUSS[ksize], dtype=dtype)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) / 2.0
    xs = [i - half for i in range(ksize)]
    vals = [math.exp(-(x * x) / (2.0 * sigma * sigma)) for x in xs]
    total = sum(vals)
    return torch.tensor([v / total for v in vals], dtype=dtype)


def taps_f32(taps: Taps) -> List[float]:
    """1-D taps as Python floats holding float32 values, the precision the
    reference multiplies with."""
    if isinstance(taps, torch.Tensor):
        taps = taps.detach().cpu().numpy()
    return [float(v) for v in np.asarray(taps, dtype=np.float32).reshape(-1)]


def reflect_pad_nhwc(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-101 pad H by ``ph`` and W by ``pw`` on an NHWC tensor."""
    xp = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), mode="reflect")
    return xp.permute(0, 2, 3, 1)


def _shifted_sep_conv(batch: torch.Tensor, kh: Taps, kw: Taps) -> torch.Tensor:
    """Separable conv as k shifted-slice multiply-adds per axis, taps
    accumulated in index order (H pass, then W pass)."""
    th, tw = taps_f32(kh), taps_f32(kw)
    rh, rw = len(th) // 2, len(tw) // 2
    x = reflect_pad_nhwc(batch, rh, rw)
    h = batch.shape[1]
    acc = th[0] * x[:, :h, :, :]
    for i in range(1, len(th)):
        acc = acc + th[i] * x[:, i:i + h, :, :]
    w = batch.shape[2]
    out = tw[0] * acc[:, :, :w, :]
    for j in range(1, len(tw)):
        out = out + tw[j] * acc[:, :, j:j + w, :]
    return out


def _depthwise_sep_conv(batch: torch.Tensor, kh: Taps, kw: Taps) -> torch.Tensor:
    """Two grouped 1-D convs (H then W) with reflect-101 borders."""
    c = batch.shape[-1]
    th = torch.tensor(taps_f32(kh), dtype=batch.dtype, device=batch.device)
    tw = torch.tensor(taps_f32(kw), dtype=batch.dtype, device=batch.device)
    rh, rw = th.numel() // 2, tw.numel() // 2
    x = F.pad(batch.permute(0, 3, 1, 2), (rw, rw, rh, rh), mode="reflect")
    x = F.conv2d(x, th.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.conv2d(x, tw.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return x.permute(0, 2, 3, 1)


def sep_conv2d(batch: torch.Tensor, kh: Taps, kw: Taps,
               impl: str = "shift") -> torch.Tensor:
    """Separable conv over float NHWC: ``impl`` "shift" (the plain
    version of the separable-blur kernel) or "depthwise" (``F.conv2d``,
    an A/B pin only)."""
    if impl == "shift":
        return _shifted_sep_conv(batch, kh, kw)
    if impl == "depthwise":
        return _depthwise_sep_conv(batch, kh, kw)
    raise ValueError(f"impl must be 'shift' or 'depthwise', got {impl!r}")


@register_filter("gaussian_blur")
def gaussian_blur(ksize: int = 9, sigma: float = 0.0,
                  impl: Optional[str] = None) -> Filter:
    """Separable Gaussian blur matching cv2.GaussianBlur taps.

    ``impl=None`` resolves to "pallas" — the hand-written separable-blur
    kernel (``gaussian_blur_pallas``) — for ksize >= 9, and to "shift"
    (plain torch ops) below, as the reference computes small blurs outside
    any kernel. "shift" and "depthwise" are explicit pins. Halo is
    ksize // 2 for every impl.
    """
    if impl is None:
        impl = "pallas" if ksize >= 9 else "shift"
    if impl == "pallas":
        return get_filter("gaussian_blur_pallas", ksize=ksize, sigma=sigma)
    if impl not in ("shift", "depthwise"):
        raise ValueError(
            f"impl must be 'shift', 'depthwise', or 'pallas', got {impl!r}")
    kern = gaussian_kernel_1d(ksize, sigma)

    def fn(batch: torch.Tensor) -> torch.Tensor:
        return sep_conv2d(batch, kern, kern, impl=impl)

    return stateless(f"gaussian_blur(k={ksize},s={sigma})", fn, halo=ksize // 2)


def box_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Uniform win×win windowed mean via running sums over float NHWC,
    reflect-101 borders like :func:`sep_conv2d`: O(1) per pixel in the
    window size. cv2's Farneback default window (``flags=0``), behind
    ``flow_warp(win_type="box")`` and ``box_blur(impl="cumsum")``.

    The running sums reach O(H·W) before the hi-lo difference, so they
    are taken in float64 (the reference's float32 associative scan drifts
    ~2e-5 at 720p; a sequential float32 scan would drift more), and the
    window sums are rounded to float32 before the division, as the
    reference divides."""
    if win % 2 != 1 or win < 1:
        raise ValueError(f"win must be odd and positive, got {win}")
    r = win // 2
    xp = reflect_pad_nhwc(x, r, r)

    def running(c: torch.Tensor, dim: int) -> torch.Tensor:
        hi = c.narrow(dim, win - 1, c.shape[dim] - win + 1)
        lo = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)),
                        c.narrow(dim, 0, c.shape[dim] - win)], dim=dim)
        return hi - lo

    s = running(torch.cumsum(xp, dim=1, dtype=torch.float64), 1)
    s = running(torch.cumsum(s, dim=2), 2)
    return s.to(x.dtype) / float(win * win)


@register_filter("box_blur")
def box_blur(ksize: int = 3, impl: str = "shift") -> Filter:
    """Separable box (mean) blur; ``impl`` "shift" or "depthwise"
    (:func:`sep_conv2d` lowerings) or "cumsum" (:func:`box_filter`
    running sums)."""
    if impl not in ("shift", "depthwise", "cumsum"):
        raise ValueError(
            f"impl must be 'shift', 'depthwise' or 'cumsum', got {impl!r}")
    if impl == "cumsum" and (ksize % 2 != 1 or ksize < 1):
        raise ValueError(f"ksize must be odd for impl='cumsum', got {ksize}")
    kern = np.full((ksize,), 1.0 / ksize, dtype=np.float32)

    def fn(batch: torch.Tensor) -> torch.Tensor:
        if impl == "cumsum":
            return box_filter(batch, ksize)
        return sep_conv2d(batch, kern, kern, impl=impl)

    return stateless(f"box_blur(k={ksize})", fn, halo=ksize // 2)


# Sobel ksize=3 taps, separable: d = [-1, 0, 1], s = [1, 2, 1].
_SOBEL_D = (-1.0, 0.0, 1.0)
_SOBEL_S = (1.0, 2.0, 1.0)


def sobel_gradients(batch: torch.Tensor):
    """Per-channel Sobel dx, dy (cv2.Sobel ksize=3, reflect-101 borders)."""
    gx = _shifted_sep_conv(batch, _SOBEL_S, _SOBEL_D)
    gy = _shifted_sep_conv(batch, _SOBEL_D, _SOBEL_S)
    return gx, gy


@register_filter("sobel")
def sobel(magnitude_scale: float = 1.0, on_gray: bool = True) -> Filter:
    """Sobel edge magnitude, broadcast back to the channels when ``on_gray``."""

    def fn(batch: torch.Tensor) -> torch.Tensor:
        x = rgb_to_gray(batch) if on_gray else batch
        gx, gy = sobel_gradients(x)
        mag = torch.sqrt(gx * gx + gy * gy) * magnitude_scale
        mag = torch.clamp(mag, 0.0, 1.0)
        if on_gray:
            mag = mag.expand(batch.shape)
        return mag.to(batch.dtype)

    return stateless(f"sobel(scale={magnitude_scale})", fn, halo=1)


@register_filter("sharpen")
def sharpen(amount: float = 1.0, ksize: int = 5, sigma: float = 1.0) -> Filter:
    """Unsharp mask: x + amount * (x - blur(x))."""
    kern = gaussian_kernel_1d(ksize, sigma)

    def fn(batch: torch.Tensor) -> torch.Tensor:
        blurred = _shifted_sep_conv(batch, kern, kern)
        return torch.clamp(batch + amount * (batch - blurred), 0.0, 1.0)

    return stateless(f"sharpen(a={amount})", fn, halo=ksize // 2)


@register_filter("emboss")
def emboss(strength: float = 1.0) -> Filter:
    """Classic 3x3 emboss on luma, +0.5 gray offset: nine shifted-slice
    multiply-adds (zero taps skipped), reflect-101 borders."""
    kern = np.array(
        [[-2.0, -1.0, 0.0],
         [-1.0, 1.0, 1.0],
         [0.0, 1.0, 2.0]],
        dtype=np.float32,
    ) * strength

    def fn(batch: torch.Tensor) -> torch.Tensor:
        gray = rgb_to_gray(batch)
        h, w = gray.shape[1], gray.shape[2]
        x = reflect_pad_nhwc(gray, 1, 1)
        y = torch.zeros_like(gray)
        for dy in range(3):
            for dx in range(3):
                tap = float(kern[dy, dx])
                if tap != 0.0:
                    y = y + tap * x[:, dy:dy + h, dx:dx + w, :]
        out = torch.clamp(y + 0.5, 0.0, 1.0)
        return out.expand(batch.shape).to(batch.dtype)

    return stateless(f"emboss(s={strength})", fn, halo=1)
