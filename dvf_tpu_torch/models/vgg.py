"""Small VGG encoder, the perceptual-feature extractor of style training
(port of ``dvf_tpu.models.vgg``).

BASELINE.json configs[4] names a "small VGG encoder": a compact
VGG-11-style stack (3 blocks, each conv(s) + ReLU then a 2×2 average pool)
whose per-block feature maps feed the content loss and the Gram-matrix
style loss. Its weights are random by design (nothing is downloaded);
``init_vgg`` draws them from a seed, and callers who bring pretrained
weights pass their own nested dict.

The forward rounds where the reference rounds: each conv in
``compute_dtype`` (bfloat16 by default), the bias added and the ReLU taken
in that dtype, and the 2×2 pool a sum of the window in that dtype times
0.25 (not ``F.avg_pool2d``, whose bfloat16 mean rounds once). The
tensor-parallel body and its specs wait for the sharded train state
(ROADMAP Queue 1 item 4c-iii).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple, Union

import torch

from dvf_tpu_torch.models.layers import (
    Params,
    conv2d_nb,
    conv_init,
    exact_f32_convs,
    generator,
)


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    # (convs_per_block, channels) per block — a VGG-11 prefix.
    blocks: Tuple[Tuple[int, int], ...] = ((1, 32), (1, 64), (2, 128))
    compute_dtype: Any = torch.bfloat16


def init_vgg(rng: Union[int, torch.Generator],
             config: VGGConfig = VGGConfig()) -> Params:
    """Seeded He-normal weights (float32, on the CPU), drawn conv by conv
    from ``layers.generator(rng)``."""
    gen = generator(rng)
    p: Dict[str, Params] = {}
    cin = 3
    for bi, (n, c) in enumerate(config.blocks):
        for ci in range(n):
            p[f"b{bi}c{ci}"] = conv_init(gen, 3, cin, c)
            cin = c
    return p


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 VALID average pool of an NHWC tensor as the reference takes it:
    the window's four values summed in ``x``'s dtype in row-major order,
    then × 0.25 (an odd last row or column is dropped)."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    s = x[:, 0:h:2, 0:w:2] + x[:, 0:h:2, 1:w:2]
    s = s + x[:, 1:h:2, 0:w:2]
    s = s + x[:, 1:h:2, 1:w:2]
    return s * 0.25


def vgg_features(
    params: Params,
    batch: torch.Tensor,
    config: VGGConfig = VGGConfig(),
) -> List[torch.Tensor]:
    """Per-block feature maps of a float NHWC batch, each after the
    block's last ReLU and before its pool, in ``compute_dtype``."""
    cd = config.compute_dtype
    x = batch.to(cd)
    feats: List[torch.Tensor] = []
    with exact_f32_convs(cd):
        for bi, (n, _) in enumerate(config.blocks):
            for ci in range(n):
                p = params[f"b{bi}c{ci}"]
                x = torch.relu(conv2d_nb(p, x, compute_dtype=cd) + p["b"].to(cd))
            feats.append(x)
            if bi + 1 < len(config.blocks):   # the last block's pool feeds nothing
                x = _pool2(x)
    return feats
