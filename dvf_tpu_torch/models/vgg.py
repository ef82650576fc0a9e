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
0.25 (not ``F.avg_pool2d``, whose bfloat16 mean rounds once).

Tensor parallelism over a mesh's ``model`` axis (the sharded train step,
``train.style``): the convs alternate column- and row-parallel
(:func:`_conv_modes`, :func:`vgg_param_pspecs`), each row conv's float32
partial summed across the ranks, and a block that ends on a column conv
gathered on C before the Gram and content terms
(:func:`tp_inner_features`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from dvf_tpu_torch.models.layers import (
    GATHER,
    Params,
    SUM,
    conv2d_nb,
    conv_init,
    exact_f32_convs,
    float32_partials,
    generator,
    run_steps,
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


def _conv_modes(config: VGGConfig) -> Dict[str, str]:
    """Alternating column/row parallelism, matching vgg_param_pspecs."""
    modes = {}
    col = True
    for bi, (n, _) in enumerate(config.blocks):
        for ci in range(n):
            modes[f"b{bi}c{ci}"] = "col" if col else "row"
            col = not col
    return modes


def _feature_steps(params: Params, batch: torch.Tensor, config: VGGConfig,
                   tp: bool):
    """The encoder as a rank program (``layers.run_steps``). Under TP each
    row conv yields its float32 partial (``SUM``, rounded to the compute
    dtype after the sum, as the unsharded conv rounds once), and at the
    end each block feature that ends on a column conv (a channel slice)
    yields a ``GATHER`` request; the trunk itself runs on local slices."""
    cd = config.compute_dtype
    modes = _conv_modes(config) if tp else {}
    x = batch.to(cd)
    feats: List[torch.Tensor] = []
    with exact_f32_convs(cd):
        for bi, (n, _) in enumerate(config.blocks):
            for ci in range(n):
                name = f"b{bi}c{ci}"
                p = params[name]
                if modes.get(name) == "row":
                    with float32_partials():
                        y = conv2d_nb(p, x, compute_dtype=cd)
                    y = (yield SUM, y).to(cd)
                else:
                    y = conv2d_nb(p, x, compute_dtype=cd)
                x = torch.relu(y + p["b"].to(cd))
            feats.append(x)
            if bi + 1 < len(config.blocks):   # the last block's pool feeds nothing
                x = _pool2(x)
    for bi, (n, _) in enumerate(config.blocks):
        if modes.get(f"b{bi}c{n - 1}") == "col":
            feats[bi] = yield GATHER, feats[bi]
    return feats


def vgg_features(
    params: Params,
    batch: torch.Tensor,
    config: VGGConfig = VGGConfig(),
) -> List[torch.Tensor]:
    """Per-block feature maps of a float NHWC batch, each after the
    block's last ReLU and before its pool, in ``compute_dtype``."""
    return run_steps(_feature_steps(params, batch, config, tp=False))


def tp_inner_features(config: VGGConfig) -> Callable[..., Any]:
    """Per-rank features under tensor parallelism, as a rank program
    ``program(params, batch)`` for ``parallel.sharded.lockstep``: this
    rank's weight blocks (:func:`vgg_param_pspecs`), the row convs summed
    across the ranks, and every returned block feature whole on C."""
    return lambda params, batch: _feature_steps(params, batch, config, tp=True)


def vgg_param_pspecs(config: VGGConfig = VGGConfig()) -> Dict[str, Any]:
    """TP specs for the encoder, derived from the same ``_conv_modes``
    alternation the forward's sums and gathers follow."""
    from dvf_tpu_torch.parallel.mesh import P

    specs: Dict[str, Any] = {}
    for name, mode in _conv_modes(config).items():
        if mode == "col":
            specs[name] = {"w": P(None, None, None, "model"), "b": P("model")}
        else:
            specs[name] = {"w": P(None, None, "model", None), "b": P()}
    return specs
