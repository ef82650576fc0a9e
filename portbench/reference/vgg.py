"""The VGG prefix in float32: per block, 3×3 zero-padded convs each with
bias and ReLU; the block's feature is taken after its last ReLU, and a
2×2 average pool (dropping an odd last row or column) leads to the next
block. The last block is not pooled."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import F32, Precision


def features(params: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor,
             blocks: Sequence[Sequence[int]], prec: Precision = F32) -> List[torch.Tensor]:
    """float NHWC → per-block NCHW features."""
    a = prec.act
    h = a(x.permute(0, 3, 1, 2).float())
    out = []
    for bi, (n, _) in enumerate(blocks):
        for ci in range(n):
            p = params[f"b{bi}c{ci}"]
            h = a(torch.relu(a(prec.conv2d(h, p["w"].permute(3, 2, 0, 1), p["b"],
                                           padding=1))))
        out.append(h)
        if bi + 1 < len(blocks):
            h = a(F.avg_pool2d(h, 2))
    return out


def gram(f: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C, C) / (H·W·C)."""
    b, c, h, w = f.shape
    v = f.reshape(b, c, h * w)
    return torch.bmm(v, v.transpose(1, 2)) / (h * w * c)


def style_grams(params, style_image: torch.Tensor, blocks, prec: Precision = F32
                ) -> List[torch.Tensor]:
    """The target Grams of one (1, H, W, 3) style image, each (C, C)."""
    return [gram(f)[0] for f in features(params, style_image, blocks, prec)]
