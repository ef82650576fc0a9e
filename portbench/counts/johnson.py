"""Counts of the Johnson transform net and of its VGG perceptual loss.

- ``frame(config, h, w)``: the net's convs for one h×w frame;
- ``train_step_flops(config, batch, size)``: one train step: the net
  forward and backward (3× forward), the encoder forward on the content
  batch, and forward plus input-backward on the net's output (2× forward;
  its weights are frozen). The Gram, loss and Adam terms are left out, so
  the count is a lower bound.
"""

from __future__ import annotations

from typing import List, Sequence

from portbench.counts import Conv, flops


def net_convs(c: int, n_res: int, h: int, w: int) -> List[Conv]:
    c1, c2, c3 = c, 2 * c, 4 * c
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    convs = [Conv(9, 3, c1, h, w, h, w),
             Conv(3, c1, c2, h, w, h2, w2),
             Conv(3, c2, c3, h2, w2, h4, w4)]
    convs += [Conv(3, c3, c3, h4, w4, h4, w4) for _ in range(2 * n_res)]
    convs += [Conv(3, c3, c2, h4, w4, h2, w2),      # upsample inside: reads h/4
              Conv(3, c2, c1, h2, w2, h, w),
              Conv(9, c1, 3, h, w, h, w)]
    return convs


def vgg_convs(blocks: Sequence[Sequence[int]], h: int, w: int) -> List[Conv]:
    convs = []
    cin = 3
    for n, c in blocks:
        for _ in range(n):
            convs.append(Conv(3, cin, c, h, w, h, w))
            cin = c
        h, w = h // 2, w // 2
    return convs


def frame(config: dict, h: int, w: int) -> List[Conv]:
    net = config["net"]
    return net_convs(net["base_channels"], net["n_residual"], h, w)


def train_step_flops(config: dict, batch: int, size: int) -> float:
    net = 3 * flops(frame(config, size, size))
    enc = 3 * flops(vgg_convs(config["vgg"]["blocks"], size, size))
    return batch * (net + enc)
