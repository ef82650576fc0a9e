"""ESPCN super-resolution (port of ``dvf_tpu.models.espcn``).

Efficient Sub-Pixel CNN (Shi et al. 2016): every conv runs at LOW (input)
resolution and a final subpixel rearrange (DCR order,
``layers.depth_to_space``, on float32 as in the reference) produces the
×r output. The tensor-parallel body waits for the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from dvf_tpu_torch.models.layers import (
    Params,
    conv2d_nb,
    conv2d_s2d,
    conv_init,
    depth_to_space,
    exact_f32_convs,
    generator,
)


@dataclasses.dataclass(frozen=True)
class EspcnConfig:
    scale: int = 2
    c1: int = 64                     # feature widths from the paper
    c2: int = 32
    compute_dtype: torch.dtype = torch.bfloat16
    # Space-to-depth conv rewrite (models.layers.conv2d_s2d) of every conv;
    # exact, off unless an A/B picks it (ops.registry).
    fast_convs: bool = False


def init_espcn(rng: Union[int, torch.Generator],
               config: EspcnConfig = EspcnConfig()) -> Params:
    """Seeded He-normal weights (float32, on the CPU) from
    ``layers.generator(rng)``."""
    gen = generator(rng)
    return {
        "feat": conv_init(gen, 5, 3, config.c1),
        "map": conv_init(gen, 3, config.c1, config.c2),
        "head": conv_init(gen, 3, config.c2, 3 * config.scale ** 2),
    }


def apply_espcn(params: Params, batch: torch.Tensor,
                config: EspcnConfig = EspcnConfig()) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] → (B, H·r, W·r, 3)."""
    cd = config.compute_dtype

    def cv(name, x):
        p = params[name]
        if config.fast_convs:
            y = conv2d_s2d(p, x, compute_dtype=cd)  # SAME zero-pad, exact
        else:
            y = conv2d_nb(p, x, compute_dtype=cd)
        return y + p["b"].to(cd)

    with exact_f32_convs(cd):
        x = batch.to(cd)
        x = torch.relu(cv("feat", x))
        x = torch.relu(cv("map", x))
        x = cv("head", x)
    y = depth_to_space(x.float(), config.scale)
    return torch.clamp(y, 0.0, 1.0).to(batch.dtype)
