"""Work counts of the registry's filters on one batch: the operations a
filter's definition does and the least bytes it must move, whatever
lowering runs it (the port's counterpart of XLA's cost analysis, which
``dvf_tpu.runtime.engine.Engine.cost_analysis`` asks; there is no
compiled program here to ask).

One copy of these counters serves ``Engine.cost_analysis`` (and through
it the bench's roofline and MFU columns) and chip_smoke.py's kernel and
net bounds, so a later, faster kernel cannot leave one of them stale.

- **Operations** follow each filter's plain formula (the kernels fold
  some of them, which makes the count a floor of the work, not a
  measurement of it): ``ops_sep_blur`` / ``ops_bilateral`` /
  ``ops_sobel_bilateral`` / ``ops_warp`` count float32 operations per
  output element or pixel, ``ops_flow_warp`` the Farneback estimate and
  its final warp, and the nets 2 × their convs' multiply-adds
  (``models.analysis``, layer by layer).
- **Bytes** are the engine's business (it knows the compiled input and
  output): each input frame read once, each output frame written once,
  plus ``FilterCost.state_passes`` times the filter's device state — 1
  for a net (its parameters, read once per batch), 2 for a stateful
  window (read and written), 0 otherwise.

A filter is recognised by its name (the ``Filter`` contract carries no
other description of what it computes); one this module does not know
gets no count (``None``), as the reference gets none on a backend
without cost analysis.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# bytes/s, float32 FLOP/s on the CUDA cores, bf16 FLOP/s on the tensor
# cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12
H100_PEAKS = {"hbm_gbps": PEAK_BYTES_S / 1e9, "bf16_tflops": PEAK_BF16_S / 1e12,
              "f32_tflops": PEAK_F32_S / 1e12}


def ops_sep_blur(shape, kh: int, kw: int) -> int:
    # a multiply and an add per tap per axis, per output element
    return int(np.prod(shape)) * 2 * (kh + kw)


def ops_bilateral(shape, d: int) -> int:
    # per tap: C sub + C mul + (C-1) add (distance), mul by 1/2sc^2, exp,
    # mul by the spatial weight, C mul-adds (numerator), 1 add
    # (denominator); then C divisions per pixel
    b, h, w, c = shape
    return b * h * w * (d * d * (5 * c + 3) + c)


def ops_sobel_bilateral(shape, d: int) -> int:
    # per pixel: gray 5; Sobel 4 x (1 mul + 2 add) + 2 sub; magnitude
    # 2 mul + add + sqrt + scale + 2 clip; single-channel bilateral 8 per
    # tap (sub, square, scale, exp, spatial mul, mul-add, add); 1 division.
    # The kernel folds the scale and the spatial weight into one
    # multiply-add per tap; this counts the plain formula's operations.
    b, h, w, _ = shape
    return b * h * w * (5 + 14 + 7 + 8 * d * d + 1)


def ops_warp(shape) -> int:
    # per pixel: 2 flow clips (4), 2 adds, 2 coordinate clamps (4), 2
    # floors, 2 fractions, 2 complements = 16; per channel 6 mul + 3 add
    b, h, w, c = shape
    return b * h * w * (16 + 9 * c)


# Per-pixel operation counts of ops_flow_warp's stages (ops/flow.py).
_GRAY = 5               # 3 mul + 2 add
_RESIZE = 8             # bilinear: 4 taps x (mul + add), per channel
_SELECT = 1             # torch.where on the initialized flag, per element


def _poly_ops(poly_n: int) -> int:
    # 3 vertical + 6 horizontal (2n+1)-tap passes (mul + add per tap),
    # then the 6x6 normal-equation product (36 mul + 36 add)
    return 9 * 2 * (2 * poly_n + 1) + 72


def _iteration_ops(win: int) -> int:
    # one _flow_level iteration per pixel: the 5-channel poly warp, the
    # averaged A (6), db1/db2 (12), the structure tensor t11..h2 (14),
    # the Gaussian window over 5 channels (2 x 2·win per channel) and
    # the regularised 2x2 solve (18)
    return (16 + 9 * 5) + 6 + 12 + 14 + 5 * 2 * 2 * win + 18


def flow_level_shapes(h: int, w: int, levels: int, pyr_scale: float = 0.5):
    """The pyramid's (h, w) per level, finest first (ops/flow.py's
    ``_coarse_to_fine``)."""
    return [(max(8, int(round(h * pyr_scale ** lvl))),
             max(8, int(round(w * pyr_scale ** lvl)))) for lvl in range(levels)]


def ops_flow_warp(shape, levels: int = 3, win: int = 15, n_iters: int = 3,
                  flow_scale: int = 2, poly_n: int = 5) -> int:
    """Operations of one ``flow_warp`` batch of ``shape`` (B, H, W, C): the
    B+1 frames' gray and downscale, per pyramid level their resize and
    polynomial expansion and B pairs' ``n_iters`` iterations, the flow's
    upscale between levels and to full resolution, the final warp and
    the select of the first batch."""
    b, h, w, c = shape
    eh, ew = (h // flow_scale, w // flow_scale) if flow_scale > 1 else (h, w)
    frames = b + 1
    ops = frames * h * w * _GRAY
    if flow_scale > 1:
        ops += frames * eh * ew * _RESIZE
    shapes = flow_level_shapes(eh, ew, levels)
    for lvl, (lh, lw) in enumerate(shapes):
        px = lh * lw
        ops += frames * px * (_RESIZE + _poly_ops(poly_n))
        ops += b * px * n_iters * _iteration_ops(win)
        if lvl < levels - 1:           # the coarser flow upscaled to here
            ops += b * px * 2 * (_RESIZE + 1)
    if flow_scale > 1:
        ops += b * h * w * 2 * (_RESIZE + 1)
    return ops + ops_warp(shape) + b * h * w * c * _SELECT


def style_macs_per_pixel(c: int = 32, r: int = 5) -> int:
    """Multiply-adds of the style net per full-resolution pixel, from
    ``models.analysis``'s layers: 153,792 at c = 32, r = 5."""
    from dvf_tpu_torch.models.analysis import style_layer_costs

    return int(sum(l.flops for l in style_layer_costs(4, 4, c, r)) / 2 / 16)


def espcn_macs_per_pixel(c1: int = 64, c2: int = 32, scale: int = 2) -> int:
    """Multiply-adds of ESPCN per low-resolution pixel, from
    ``models.analysis``'s layers: 26,688 at the defaults."""
    from dvf_tpu_torch.models.analysis import espcn_layer_costs

    return int(sum(l.flops for l in espcn_layer_costs(1, 1, scale, c1, c2)) / 2)


@dataclasses.dataclass(frozen=True)
class FilterCost:
    flops: float            # operations per batch
    state_passes: int       # times the device state crosses HBM per batch
    peak_flops_s: float     # the card's peak for the filter's arithmetic


def filter_cost(filt, batch_shape: Sequence[int]) -> Optional[FilterCost]:
    """The count of ``filt`` on one (B, H, W, C) batch, or None for a
    filter this module does not know."""
    shape = tuple(int(v) for v in batch_shape)
    b, h, w, _ = shape
    name = filt.name
    if name == "invert":
        return FilterCost(float(np.prod(shape)), 0, PEAK_F32_S)
    m = re.fullmatch(r"gaussian_blur(?:_pallas)?\(k=(\d+),[^)]*\)", name)
    if m:
        k = int(m.group(1))
        return FilterCost(float(ops_sep_blur(shape, k, k)), 0, PEAK_F32_S)
    m = re.fullmatch(r"sobel_bilateral(?:_pallas)?\(d=(\d+)\)", name)
    if m:
        return FilterCost(float(ops_sobel_bilateral(shape, int(m.group(1)))),
                          0, PEAK_F32_S)
    m = re.fullmatch(r"bilateral(?:_pallas)?\(d=(\d+),[^)]*\)", name)
    if m:
        return FilterCost(float(ops_bilateral(shape, int(m.group(1)))), 0,
                          PEAK_F32_S)
    m = re.fullmatch(r"flow_warp\(levels=(\d+),win=(\d+),[^)]*\)", name)
    if m:
        # n_iters and flow_scale are not in the name: flow_warp's defaults
        return FilterCost(float(ops_flow_warp(shape, int(m.group(1)),
                                              int(m.group(2)))), 2, PEAK_F32_S)
    m = re.fullmatch(r"style_transfer\(c=(\d+),r=(\d+),\w+\)", name)
    if m:
        from dvf_tpu_torch.models.analysis import style_layer_costs

        layers = style_layer_costs(h, w, int(m.group(1)), int(m.group(2)))
        return FilterCost(b * sum(l.flops for l in layers), 1, PEAK_BF16_S)
    m = re.fullmatch(r"super_resolution\(x(\d+)\)", name)
    if m:
        from dvf_tpu_torch.models.analysis import espcn_layer_costs

        layers = espcn_layer_costs(h, w, int(m.group(1)))
        return FilterCost(b * sum(l.flops for l in layers), 1, PEAK_BF16_S)
    if filt.members and not filt.stateful:
        # a chain of geometry-preserving stateless filters: the members'
        # operations add up; its bytes are the chain's own in and out
        costs = [filter_cost(f, shape) for f in filt.members]
        if all(c is not None and c.state_passes == 0 for c in costs):
            return FilterCost(sum(c.flops for c in costs), 0,
                              max(c.peak_flops_s for c in costs))
    return None
