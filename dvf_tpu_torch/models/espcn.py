"""ESPCN super-resolution (port of ``dvf_tpu.models.espcn``).

Efficient Sub-Pixel CNN (Shi et al. 2016): every conv runs at LOW (input)
resolution and a final subpixel rearrange (DCR order,
``layers.depth_to_space``, on float32 as in the reference) produces the
×r output. Tensor parallelism over a mesh's ``model`` axis: feat is
column-parallel, map row-parallel with one sum across the ranks, head
replicated (:func:`param_pspecs`, :func:`tp_inner_apply`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from dvf_tpu_torch.models.layers import (
    Params,
    SUM,
    conv2d_nb,
    conv2d_s2d,
    conv_init,
    depth_to_space,
    exact_f32_convs,
    float32_partials,
    generator,
    run_steps,
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
    return _forward(params, batch, config, row_reduce=None)


def _forward(params: Params, batch: torch.Tensor, config: EspcnConfig,
             row_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]) -> torch.Tensor:
    """Shared body; ``row_reduce`` (the sum across the model ranks under
    TP, None unsharded) runs on map's pre-bias partial sums."""
    return run_steps(_forward_steps(params, batch, config, tp=row_reduce is not None),
                     lambda _kind, y: row_reduce(y))


def _forward_steps(params: Params, batch: torch.Tensor, config: EspcnConfig,
                   tp: bool):
    """The forward as a rank program (``layers.run_steps``): under TP map
    yields its float32 partial as a ``SUM`` request."""
    cd = config.compute_dtype

    def conv(name, x):
        p = params[name]
        if config.fast_convs:
            return conv2d_s2d(p, x, compute_dtype=cd)  # SAME zero-pad, exact
        return conv2d_nb(p, x, compute_dtype=cd)

    def cv(name, x, row=False):
        if row:
            # The rank's partial sum in float32, rounded once after the
            # sum across the ranks.
            with float32_partials():
                y = conv(name, x)
            y = yield SUM, y
            return y.to(cd) + params[name]["b"].to(cd)
        return conv(name, x) + params[name]["b"].to(cd)

    with exact_f32_convs(cd):
        x = batch.to(cd)
        x = torch.relu((yield from cv("feat", x)))
        x = torch.relu((yield from cv("map", x, row=tp)))
        x = yield from cv("head", x)
    y = depth_to_space(x.float(), config.scale)
    return torch.clamp(y, 0.0, 1.0).to(batch.dtype)


def tp_inner_apply(config: EspcnConfig) -> Callable[..., torch.Tensor]:
    """Per-rank apply under tensor parallelism: ``inner(params, batch,
    row_reduce)`` — feat column-parallel (activations leave C-sharded),
    map row-parallel reducing through ``row_reduce``, head replicated."""
    return lambda params, batch, row_reduce: _forward(
        params, batch, config, row_reduce=row_reduce)


def tp_inner_steps(config: EspcnConfig) -> Callable[..., Any]:
    """The same per-rank forward as a rank program, ``program(params,
    batch)``, for ``parallel.sharded.lockstep`` (the sharded train
    step)."""
    return lambda params, batch: _forward_steps(params, batch, config, tp=True)


def param_pspecs(config: EspcnConfig = EspcnConfig()) -> Dict[str, Any]:
    """PartitionSpec tree for TP over the ``model`` axis: feat=col
    (output channels sharded), map=row (input channels sharded, one sum),
    head replicated. Size-1 model axes degrade to replication, so this one
    tree serves every mesh."""
    from dvf_tpu_torch.parallel.mesh import P

    return {
        "feat": {"w": P(None, None, None, "model"), "b": P("model")},
        "map": {"w": P(None, None, "model", None), "b": P()},
        "head": {"w": P(), "b": P()},
    }
