"""Perceptual-loss training for the style-transfer net (port of
``dvf_tpu.train.style``).

Loss = content (VGG feature MSE against the input) + style (relative
Gram-matrix error against a fixed style image's Grams) + total-variation
smoothness: the Johnson et al. recipe, computed on the device.

The step runs on one device, the state's (``mesh=None``): forward, loss,
backward and ``torch.optim.Adam`` in PyTorch's eager idiom. It updates
the state in place, the port's analogue of the reference's donated
buffers; ``donate=False`` steps a copy and leaves its input untouched.
The reference's mesh-sharded form (``state_pspecs``,
``shard_train_state``, ``train_batch_sharding``) waits for ROADMAP Queue 1
item 4c-iii.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.models.layers import generator, gram_matrix, tree_to
from dvf_tpu_torch.models.style_transfer import (
    StyleNetConfig,
    apply_style_net,
    init_style_net,
)
from dvf_tpu_torch.models.vgg import VGGConfig, init_vgg, vgg_features
from dvf_tpu_torch.train import optim


@dataclasses.dataclass(frozen=True)
class StyleTrainConfig:
    net: StyleNetConfig = StyleNetConfig()
    vgg: VGGConfig = VGGConfig()
    content_weight: float = 1.0
    style_weight: float = 10.0
    tv_weight: float = 1e-4
    learning_rate: float = 1e-3


@dataclasses.dataclass
class TrainState:
    params: Any                      # leaf tensors that require grad
    opt_state: Any                   # torch.optim.Adam over params' leaves
    vgg_params: Any                  # frozen perceptual encoder
    style_grams: List[torch.Tensor]  # target Grams, one per VGG block
    step: torch.Tensor               # 0-d int32 on the state's device


def _tv_loss(img: torch.Tensor) -> torch.Tensor:
    dh = img[:, 1:, :, :] - img[:, :-1, :, :]
    dw = img[:, :, 1:, :] - img[:, :, :-1, :]
    return torch.mean(dh.float() ** 2) + torch.mean(dw.float() ** 2)


def style_loss_fn(
    params: Any,
    batch: torch.Tensor,
    vgg_params: Any,
    style_grams: List[torch.Tensor],
    config: StyleTrainConfig,
    apply_fn=None,
    features_fn=None,
) -> Tuple[torch.Tensor, dict]:
    """(loss, {"loss", "content", "style", "tv"}), every term a float32
    0-d tensor. ``apply_fn`` / ``features_fn`` default to the single-device
    model functions. The content batch's features carry no grad (nothing
    of them depends on ``params``), so the encoder runs forward only
    there."""
    apply_fn = apply_fn or (lambda p, b: apply_style_net(p, b, config.net))
    features_fn = features_fn or (lambda p, b: vgg_features(p, b, config.vgg))
    out = apply_fn(params, batch)
    out_feats = features_fn(vgg_params, out)
    with torch.no_grad():
        content_feats = features_fn(vgg_params, batch)
    content = sum(
        torch.mean((a.float() - b.float()) ** 2)
        for a, b in zip(out_feats, content_feats)
    ) / len(out_feats)
    # Per-layer RELATIVE Gram error: raw Gram MSE scales with 1/(H·W·C)²
    # and sits orders of magnitude below the content term; dividing by
    # the target Gram's energy makes every layer O(1) and resolution-free.
    style = sum(
        torch.mean((gram_matrix(f) - g[None]) ** 2)
        / (torch.mean(g.float() ** 2) + 1e-12)
        for f, g in zip(out_feats, style_grams)
    ) / len(out_feats)
    tv = _tv_loss(out)
    loss = (
        config.content_weight * content
        + config.style_weight * style
        + config.tv_weight * tv
    )
    return loss, {"loss": loss, "content": content, "style": style, "tv": tv}


def make_optimizer(config: StyleTrainConfig, params: Any) -> torch.optim.Adam:
    """``optax.adam(config.learning_rate)``'s counterpart over ``params``'
    leaves (``train.optim.adam``)."""
    return optim.adam(params, config.learning_rate)


def init_train_state(
    rng: Union[int, torch.Generator],
    style_image: Union[np.ndarray, torch.Tensor],
    config: StyleTrainConfig = StyleTrainConfig(),
    device=None,
) -> TrainState:
    """Params + optimizer state + the style target's Grams on ``device``
    (``cuda:0`` unless the caller names the CPU; raises without CUDA).

    ``rng``: a seed or a CPU generator; the net's weights are drawn first,
    then the encoder's. ``style_image``: (1, H, W, 3) float in [0, 1].
    """
    from dvf_tpu_torch.runtime.engine import resolve_device

    dev = resolve_device(device)
    gen = generator(rng)
    params = optim.trainable(init_style_net(gen, config.net), dev)
    vgg_params = tree_to(init_vgg(gen, config.vgg), dev)
    img = torch.as_tensor(style_image).float().to(dev)
    with torch.no_grad():
        grams = [gram_matrix(f)[0] for f in vgg_features(vgg_params, img, config.vgg)]
    return TrainState(
        params=params,
        opt_state=make_optimizer(config, params),
        vgg_params=vgg_params,
        style_grams=grams,
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def copy_state(state: TrainState) -> TrainState:
    """An independent copy: its own param leaves and optimizer moments
    (the frozen encoder and the Grams, which no step writes, are shared)."""
    params, opt = optim.clone(state.params, state.opt_state)
    return TrainState(params=params, opt_state=opt, vgg_params=state.vgg_params,
                      style_grams=state.style_grams, step=state.step.clone())


def make_train_step(
    mesh=None,
    config: StyleTrainConfig = StyleTrainConfig(),
    state_template: Optional[TrainState] = None,
    donate: bool = True,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, dict]]:
    """The step ``(state, batch) -> (state, metrics)`` on the state's
    device: the loss of a float NHWC batch in [0, 1], its gradient and one
    Adam update; metrics are 0-d tensors on the device (no sync). With
    ``donate`` the state is updated in place and returned; without it a
    copy is stepped. ``mesh`` must be None (one device)."""
    optim.single_device(mesh, "the style train step")
    if state_template is None:
        raise ValueError("make_train_step needs a state_template TrainState")
    dtypes = (config.net.compute_dtype, config.vgg.compute_dtype)

    def step(state: TrainState, batch: torch.Tensor):
        if not donate:
            state = copy_state(state)
        batch = torch.as_tensor(batch).to(state.step.device, non_blocking=True)
        metrics = optim.descend(state.opt_state, lambda: style_loss_fn(
            state.params, batch, state.vgg_params, state.style_grams, config), dtypes)
        state.step.add_(1)
        return state, metrics

    return step
