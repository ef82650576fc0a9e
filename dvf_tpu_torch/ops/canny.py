"""Canny edge detection (port of ``dvf_tpu.ops.canny``).

Sobel gradients (the shared reflect-101 ``sobel_gradients``) → non-maximum
suppression with cv2's 4-sector quantization as vectorized selects →
double threshold → hysteresis as the fixpoint of
``s ← (dilate₈(s) ∧ weak) ∨ strong``. Thresholds are in cv2's units (the
gradient of a 0..255 gray image).

The reference runs the fixpoint as a ``lax.while_loop`` on the device.
Here the host decides when to stop, and asking the device whether a round
changed anything is a host sync, so it asks once every
:data:`CHECK_EVERY` rounds. A round past the fixpoint changes nothing,
and no more than ``max_iters`` rounds run in all, so the result is the
reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.ops.conv import sobel_gradients
from dvf_tpu_torch.ops.registry import register_filter
from dvf_tpu_torch.utils.image import rgb_to_gray

_TG22 = 0.41421356  # tan(22.5°)
_TG67 = 2.41421356  # tan(67.5°)
CHECK_EVERY = 8     # hysteresis rounds between convergence checks


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """(B, H, W) map shifted by (dy, dx), zero-filled outside — borders
    compare against 0, so border ridges can still survive NMS."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Non-maximum suppression with cv2's 4-sector quantization."""
    ax, ay = gx.abs(), gy.abs()
    horiz = ay <= _TG22 * ax                  # gradient ~horizontal
    vert = ay > _TG67 * ax                    # gradient ~vertical
    diag_main = (gx * gy) >= 0                # 45° vs 135°
    n1 = torch.where(
        horiz, _shift(mag, 0, -1),
        torch.where(vert, _shift(mag, -1, 0),
                    torch.where(diag_main, _shift(mag, -1, -1),
                                _shift(mag, -1, 1))))
    n2 = torch.where(
        horiz, _shift(mag, 0, 1),
        torch.where(vert, _shift(mag, 1, 0),
                    torch.where(diag_main, _shift(mag, 1, 1),
                                _shift(mag, 1, -1))))
    # cv2 keeps a pixel when mag > n1 and mag >= n2 (the asymmetric tie
    # break that stops plateau double-edges).
    return (mag > n1) & (mag >= n2)


def _dilate8(s: torch.Tensor) -> torch.Tensor:
    """3×3 binary dilation of a (B, H, W) bool map, zero outside: an OR
    over rows, then over columns."""
    p = F.pad(s, (0, 0, 1, 1))
    s = p[:, :-2] | p[:, 1:-1] | p[:, 2:]
    p = F.pad(s, (1, 1))
    return p[:, :, :-2] | p[:, :, 1:-1] | p[:, :, 2:]


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor,
                max_iters: int = 256) -> torch.Tensor:
    """Fixpoint of s ← (dilate₈(s) ∧ weak) ∨ strong, batched, after at most
    ``max_iters`` rounds (edges farther than that along a weak chain from
    any strong seed stay unpromoted, as in the reference)."""
    s, done = strong, 0
    while done < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - done)):
            prev = s
            s = (_dilate8(s) & weak) | strong
            done += 1
        if not bool((s != prev).any()):
            break
    return s


@register_filter("canny")
def canny(threshold1: float = 100.0, threshold2: float = 200.0,
          l2_gradient: bool = True, max_iters: int = 256) -> Filter:
    """Canny edges on luma, broadcast to the channels (white on black).

    ``threshold1``/``threshold2`` follow cv2.Canny (swapped inputs are
    normalized like cv2 does); ``l2_gradient``: L2 magnitude (default) or
    cv2's L1. ``max_iters`` caps the hysteresis rounds, bounding the worst
    frame's latency.
    """
    lo, hi = sorted((float(threshold1), float(threshold2)))

    def fn(batch: torch.Tensor) -> torch.Tensor:
        gray = rgb_to_gray(batch) * 255.0     # cv2's gradient scale
        gx, gy = sobel_gradients(gray)
        gx, gy = gx[..., 0], gy[..., 0]
        if l2_gradient:
            mag = torch.sqrt(gx * gx + gy * gy)
        else:
            mag = gx.abs() + gy.abs()
        ridge = _nms(mag, gx, gy)
        strong = ridge & (mag > hi)
        weak = ridge & (mag > lo)
        edges = _hysteresis(strong, weak, max_iters=max_iters)
        return edges.to(batch.dtype)[..., None].expand(batch.shape)

    return stateless(f"canny({lo:g},{hi:g})", fn, halo=None)
