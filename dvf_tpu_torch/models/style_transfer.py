"""Fast neural style transfer (port of ``dvf_tpu.models.style_transfer``).

BASELINE.json configs[4]: the Johnson et al. (2016) feed-forward
transformer net — 9×9 stem conv → two stride-2 downsampling convs → N
residual blocks at ¼ resolution → two ×2 resize-convs → 9×9 output conv,
instance norm + ReLU throughout, scaled-tanh output.

The forward rounds where the reference rounds: every conv result and its
bias add are in the compute dtype, each instance norm returns to it, and
the final tanh is float32. The tensor-parallel and pipelined (shard_map)
bodies wait for the multi-GPU slice; ``parallel="pp"``'s single-device
form (:func:`to_pp_params`, :func:`pp_sequential_apply`) is here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from dvf_tpu_torch.models.layers import (
    Params,
    conv2d_nb,
    conv2d_s2d,
    conv_init,
    exact_f32_convs,
    generator,
    instance_norm,
    instance_norm_init,
    upsample2_conv,
    upsample_nearest,
)


@dataclasses.dataclass(frozen=True)
class StyleNetConfig:
    base_channels: int = 32          # stem width; doubles at each downsample
    n_residual: int = 5
    compute_dtype: torch.dtype = torch.bfloat16
    # The exact conv rewrites (models.layers.conv2d_s2d / upsample2_conv):
    # the 9x9 stem/out convs run space-to-depth at half resolution, and the
    # decoder's upsample+conv pairs phase-collapse to low-res convs. Same
    # arithmetic; off unless an A/B picks it (ops.registry).
    fast_convs: bool = False

    @property
    def widths(self):
        c = self.base_channels
        return (c, c * 2, c * 4)     # stem, down1, down2/residual trunk


def init_style_net(rng: Union[int, torch.Generator],
                   config: StyleNetConfig = StyleNetConfig()) -> Params:
    """Seeded He-normal weights (float32, on the CPU), drawn layer by layer
    from ``layers.generator(rng)``."""
    gen = generator(rng)
    c1, c2, c3 = config.widths
    p: Dict[str, Params] = {
        "stem": conv_init(gen, 9, 3, c1),
        "stem_norm": instance_norm_init(c1),
        "down1": conv_init(gen, 3, c1, c2),
        "down1_norm": instance_norm_init(c2),
        "down2": conv_init(gen, 3, c2, c3),
        "down2_norm": instance_norm_init(c3),
    }
    for i in range(config.n_residual):
        p[f"res{i}_a"] = conv_init(gen, 3, c3, c3)
        p[f"res{i}_an"] = instance_norm_init(c3)
        p[f"res{i}_b"] = conv_init(gen, 3, c3, c3)
        p[f"res{i}_bn"] = instance_norm_init(c3)
    p["up1"] = conv_init(gen, 3, c3, c2)
    p["up1_norm"] = instance_norm_init(c2)
    p["up2"] = conv_init(gen, 3, c2, c1)
    p["up2_norm"] = instance_norm_init(c1)
    p["out"] = conv_init(gen, 9, c1, 3)
    return p


def apply_style_net(params: Params, batch: torch.Tensor,
                    config: StyleNetConfig = StyleNetConfig()) -> torch.Tensor:
    """Apply the transformer net to a float NHWC batch in [0, 1]."""
    return _forward(params, batch, config)


def _forward(params: Params, batch: torch.Tensor, config: StyleNetConfig,
             trunk_fn: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None
             ) -> torch.Tensor:
    """Shared forward body. ``trunk_fn(params, x)`` replaces the flat
    residual loop (the PP grouping passes its loop over stacked blocks):
    one copy of the stem/decoder wiring, however the trunk runs."""
    cd = config.compute_dtype

    def cv(name, x, stride=1, upsampled=False):
        p = params[name]
        if upsampled:
            # Decoder pair: nearest-x2 then conv. The fast path never
            # materializes the upsampled activation (exact for k=3).
            if config.fast_convs:
                y = upsample2_conv(p, x, compute_dtype=cd)
            else:
                y = conv2d_nb(p, upsample_nearest(x, 2), compute_dtype=cd,
                              reflect=True)
        elif config.fast_convs and stride == 1 and p["w"].shape[0] >= 5:
            # Full-resolution large-kernel convs (stem 9x9, out 9x9).
            y = conv2d_s2d(p, x, compute_dtype=cd, reflect=True)
        else:
            y = conv2d_nb(p, x, stride=stride, compute_dtype=cd, reflect=True)
        return y + p["b"].to(cd)

    def norm_relu(name, y):
        return torch.relu(instance_norm(params[name], y))

    with exact_f32_convs(cd):
        x = batch.to(cd)
        x = norm_relu("stem_norm", cv("stem", x))
        x = norm_relu("down1_norm", cv("down1", x, stride=2))
        x = norm_relu("down2_norm", cv("down2", x, stride=2))
        if trunk_fn is not None:
            x = trunk_fn(params, x)
        else:
            for i in range(config.n_residual):
                h = norm_relu(f"res{i}_an", cv(f"res{i}_a", x))
                h = instance_norm(params[f"res{i}_bn"], cv(f"res{i}_b", h))
                x = x + h
        x = norm_relu("up1_norm", cv("up1", x, upsampled=True))
        x = norm_relu("up2_norm", cv("up2", x, upsampled=True))
        x = cv("out", x)
    y = 0.5 * (torch.tanh(x.float()) + 1.0)
    return y.to(batch.dtype)


# ---------------------------------------------------------------------------
# The pipeline-parallel grouping, run on one device
# ---------------------------------------------------------------------------

def to_pp_params(flat: Params, config: StyleNetConfig) -> Params:
    """Regroup the flat param dict for pipelining: stem/down/up/out stay
    flat, the N homogeneous residual blocks stack into a 'trunk' tree with
    leading dim N (the axis a pipeline shards over stages)."""
    from dvf_tpu_torch.parallel.pp import stack_layer_params

    enc_dec = {k: v for k, v in flat.items() if not k.startswith("res")}
    blocks = [
        {"a": flat[f"res{i}_a"], "an": flat[f"res{i}_an"],
         "b": flat[f"res{i}_b"], "bn": flat[f"res{i}_bn"]}
        for i in range(config.n_residual)
    ]
    return {**enc_dec, "trunk": stack_layer_params(blocks)}


def _pp_res_block(config: StyleNetConfig):
    cd = config.compute_dtype

    def cv(p, x):
        return conv2d_nb(p, x, compute_dtype=cd, reflect=True) + p["b"].to(cd)

    def res_block(p, x):
        h = torch.relu(instance_norm(p["an"], cv(p["a"], x)))
        h = instance_norm(p["bn"], cv(p["b"], h))
        return x + h

    return res_block


def _layer(stacked: Any, i: int) -> Any:
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def pp_sequential_apply(config: StyleNetConfig) -> Callable[[Params, torch.Tensor],
                                                               torch.Tensor]:
    """Single-device apply over PP-grouped params: the trunk is a loop over
    the stacked blocks, numerically the same as :func:`apply_style_net`
    on the flat params."""
    block = _pp_res_block(config)

    def trunk(params, x):
        stacked = params["trunk"]
        for i in range(stacked["a"]["w"].shape[0]):
            x = block(_layer(stacked, i), x)
        return x

    return lambda params, batch: _forward(params, batch, config, trunk_fn=trunk)
