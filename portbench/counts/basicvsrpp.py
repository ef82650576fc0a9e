"""Counts of BasicVSR++ ×4 (``configs/basicvsrpp_x4.json``): the work of
one clip of ``config["clip"]`` frames at h×w, divided by its frames.

- ``frame(config, h, w)``: every conv of the clip ÷ T: SpyNet at the size
  it runs (h and w rounded up to a multiple of 32, six pyramid levels),
  T − 1 pairs in each of two directions; the feature extraction on every
  frame; each propagation pass's backbone at every step and its offset
  stack and deformable conv at every step but the first; the
  reconstruction and upsampler on every frame.
- ``dcn_ops(config, h, w)``: the deformable convs alone, ÷ T.

A deformable conv (:class:`DeformConv`) is an op of its own: 2·9·Cin·Cout
FLOPs an output pixel (the GEMM over its 9 taps), and bytes its input,
offsets and mask read once, its output written once and its weight once;
input, output and weight in the compute dtype, offsets and mask in
float32 (as the program holds them). The bilinear sampling, the mask
product, the warps, the offset epilogue, the resizes and the pixel
shuffles are counted inside the op they feed, with no bytes of their own.
"""

from dataclasses import dataclass
from typing import List

from portbench.counts import Conv

PASSES = 4
SPYNET_WIDTHS = (8, 32, 64, 32, 16, 2)
SPYNET_LEVELS = 6


@dataclass(frozen=True)
class DeformConv:
    cin: int
    cout: int
    groups: int
    h: int
    w: int

    @property
    def flops(self) -> float:
        return 2.0 * 9 * self.cin * self.cout * self.h * self.w

    def bytes(self, dtype_bytes: int) -> float:
        px = self.h * self.w
        return (dtype_bytes * (px * (self.cin + self.cout) + 9 * self.cin * self.cout)
                + 4 * px * 27 * self.groups)


@dataclass(frozen=True)
class Share:
    """An op counted ``share`` times (a clip's op ÷ its frames)."""
    op: object
    share: float

    @property
    def flops(self) -> float:
        return self.share * self.op.flops

    def bytes(self, dtype_bytes: int) -> float:
        return self.share * self.op.bytes(dtype_bytes)


def _res_blocks(cin: int, c: int, blocks: int, h: int, w: int) -> list:
    return [Conv(3, cin, c, h, w, h, w)] + [Conv(3, c, c, h, w, h, w)] * (2 * blocks)


def _dcn(net: dict, h: int, w: int) -> DeformConv:
    c = net["mid_channels"]
    return DeformConv(2 * c, c, net["deform_groups"], h, w)


def clip_ops(config: dict, h: int, w: int) -> List:
    """Every op of one clip of ``config["clip"]`` frames."""
    net, t = config["net"], config["clip"]
    c, g = net["mid_channels"], net["deform_groups"]
    ops: List = []
    hu, wu = -(-h // 32) * 32, -(-w // 32) * 32
    for lvl in range(SPYNET_LEVELS):
        s = 2 ** (SPYNET_LEVELS - 1 - lvl)
        lh, lw = hu // s, wu // s
        for ci, co in zip(SPYNET_WIDTHS[:-1], SPYNET_WIDTHS[1:]):
            ops += [Conv(7, ci, co, lh, lw, lh, lw)] * (2 * (t - 1))
    ops += _res_blocks(3, c, net["extract_blocks"], h, w) * t
    for k in range(PASSES):
        ops += _res_blocks((2 + k) * c, c, net["num_blocks"], h, w) * t
        ops += [Conv(3, 3 * c + 4, c, h, w, h, w), Conv(3, c, c, h, w, h, w),
                Conv(3, c, c, h, w, h, w), Conv(3, c, 27 * g, h, w, h, w),
                _dcn(net, h, w)] * (t - 1)
    per_frame = _res_blocks(5 * c, c, net["recon_blocks"], h, w)
    per_frame += [Conv(3, c, 4 * c, h, w, h, w),
                  Conv(3, c, 4 * 64, 2 * h, 2 * w, 2 * h, 2 * w),
                  Conv(3, 64, 64, 4 * h, 4 * w, 4 * h, 4 * w),
                  Conv(3, 64, 3, 4 * h, 4 * w, 4 * h, 4 * w)]
    return ops + per_frame * t


def frame(config: dict, h: int, w: int) -> List:
    t = config["clip"]
    return [Share(op, 1.0 / t) for op in clip_ops(config, h, w)]


def dcn_ops(config: dict, h: int, w: int) -> List:
    return [s for s in frame(config, h, w) if isinstance(s.op, DeformConv)]
