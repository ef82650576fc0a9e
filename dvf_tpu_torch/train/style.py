"""Perceptual-loss training for the style-transfer net (port of
``dvf_tpu.train.style``).

Loss = content (VGG feature MSE against the input) + style (relative
Gram-matrix error against a fixed style image's Grams) + total-variation
smoothness: the Johnson et al. recipe, computed on the device.

The step is forward, loss, backward and ``torch.optim.Adam`` in PyTorch's
eager idiom. It updates the state in place, the port's analogue of the
reference's donated buffers; ``donate=False`` steps a copy and leaves its
input untouched. ``mesh=None`` (or a one-position mesh) runs it on the
state's device.

Over a mesh (the reference's all-manual ``shard_map``), from one thread:

- batch: dim 0 split over ``data`` and ``space`` folded together
  (:func:`train_batch_sharding`); both axes act as data parallelism, and
  the loss is the mean of the groups' losses;
- net and encoder params, and Adam's moments: Megatron column/row specs
  over ``model`` (:func:`state_pspecs`), placed by
  :func:`shard_train_state` (``train.optim.MeshParams``). Each group's
  ranks run their rank programs in lockstep
  (``parallel.sharded.lockstep``), every collective a differentiable
  node, so the gradient is the one-device gradient;
- a block held on several devices gets the sum of its copies' gradients,
  Adam steps it once, and the result is copied back to every copy.

The reference's sharded step does not sum the input gradient of a
column-parallel conv across the ranks (its ``psum`` transposes to a
``psum``), so under ``model=2`` its gradients differ from its own
one-device step's; the port's do not (ROADMAP, "Differences of the
reference").
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.models.layers import generator, gram_matrix, tree_to
from dvf_tpu_torch.models.style_transfer import (
    StyleNetConfig,
    apply_style_net,
    init_style_net,
    param_pspecs,
    tp_inner_steps,
)
from dvf_tpu_torch.models.vgg import (
    VGGConfig,
    init_vgg,
    tp_inner_features,
    vgg_features,
    vgg_param_pspecs,
)
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
    params: Any                      # leaf tensors that require grad (a
    #   train.optim.MeshParams over a mesh)
    opt_state: Any                   # torch.optim.Adam over params' leaves
    #   (their blocks over a mesh)
    vgg_params: Any                  # frozen perceptual encoder
    style_grams: List[torch.Tensor]  # target Grams, one per VGG block
    step: torch.Tensor               # 0-d int32 on the state's (first) device


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
    return perceptual_loss(out, out_feats, content_feats, style_grams, config)


def perceptual_loss(out: torch.Tensor, out_feats: List[torch.Tensor],
                    content_feats: List[torch.Tensor],
                    style_grams: List[torch.Tensor],
                    config: StyleTrainConfig) -> Tuple[torch.Tensor, dict]:
    """The loss terms of :func:`style_loss_fn` from the net's output and
    the encoder's features of it and of the content batch."""
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
    """An independent copy: its own param leaves (blocks) and optimizer
    moments (the frozen encoder and the Grams, which no step writes, are
    shared)."""
    params, opt = optim.clone(state.params, state.opt_state)
    return TrainState(params=params, opt_state=opt, vgg_params=state.vgg_params,
                      style_grams=state.style_grams, step=state.step.clone())


def state_pspecs(state: TrainState, config: StyleTrainConfig) -> TrainState:
    """PartitionSpec tree mirroring a TrainState (TP over ``model``):
    Adam's moments (``mu``, ``nu``) take their param leaf's spec, the
    count and the step replicate (the reference's ``opt_spec`` rule)."""
    from dvf_tpu_torch.parallel.mesh import P

    p_specs = param_pspecs(config.net)
    return TrainState(
        params=p_specs,
        opt_state={"count": P(), "mu": p_specs, "nu": p_specs},
        vgg_params=vgg_param_pspecs(config.vgg),
        style_grams=[P() for _ in state.style_grams],
        step=P(),
    )


def shard_train_state(state: TrainState, mesh, config: StyleTrainConfig) -> TrainState:
    """Place a one-device TrainState onto ``mesh`` per ``state_pspecs``:
    params and the encoder as ``train.optim.MeshParams``, Adam over the
    param blocks with its moments cut likewise, the Grams and the step on
    the mesh's first device (the Grams are read by every group from
    there). A one-position mesh gives a one-device state on its device."""
    dev = mesh.first_device
    whole = optim.whole(state.params)
    count, mu, nu = optim.adam_state(state.opt_state, state.params)
    vgg = optim.whole(state.vgg_params)
    if mesh.size == 1:
        params = optim.trainable(whole, dev)
        vgg_params = tree_to(vgg, dev)
    else:
        specs = state_pspecs(state, config)
        params = optim.place(whole, mesh, specs.params)
        vgg_params = optim.MeshParams(vgg, mesh, specs.vgg_params, requires_grad=False)
    opt = optim.adam(params, state.opt_state.param_groups[0]["lr"])
    optim.set_adam_state(opt, params, count, mu, nu)
    return TrainState(params=params, opt_state=opt, vgg_params=vgg_params,
                      style_grams=[g.to(dev) for g in state.style_grams],
                      step=state.step.to(dev).clone())


def train_batch_sharding(mesh):
    """The batch layout of the sharded step: dim 0 over ``data`` and
    ``space`` folded together."""
    from dvf_tpu_torch.parallel.mesh import NamedSharding, P

    return NamedSharding(mesh, P(("data", "space")))


def make_train_step(
    mesh=None,
    config: StyleTrainConfig = StyleTrainConfig(),
    state_template: Optional[TrainState] = None,
    donate: bool = True,
    tracer=None,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, dict]]:
    """The step ``(state, batch) -> (state, metrics)``: the loss of a
    float NHWC batch in [0, 1], its gradient and one Adam update; metrics
    are 0-d tensors on the (first) device (no sync). With ``donate`` the
    state is updated in place and returned; without it a copy is
    stepped. ``mesh=None`` or a one-position mesh: the state's device.
    Over a mesh of more positions the state must be placed on it
    (:func:`shard_train_state`), and the batch (a whole tensor, or a
    ``ShardedBatch``) is cut per :func:`train_batch_sharding`. An enabled
    ``tracer`` (obs.trace.Tracer) gets each step's phases, numbered from
    0 by this step function (``optim.descend``)."""
    if state_template is None:
        raise ValueError("make_train_step needs a state_template TrainState")
    dtypes = (config.net.compute_dtype, config.vgg.compute_dtype)
    steps = itertools.count()
    if mesh is not None and mesh.size > 1:
        return _sharded_step(mesh, config, donate, dtypes, tracer, steps)

    def step(state: TrainState, batch: torch.Tensor):
        if not donate:
            state = copy_state(state)
        batch = torch.as_tensor(batch).to(state.step.device, non_blocking=True)
        metrics = optim.descend(state.opt_state, lambda: style_loss_fn(
            state.params, batch, state.vgg_params, state.style_grams, config), dtypes,
            tracer=tracer, step=next(steps))
        state.step.add_(1)
        return state, metrics

    return step


def _sharded_step(mesh, config: StyleTrainConfig, donate: bool, dtypes, tracer, steps):
    from dvf_tpu_torch.parallel.sharded import lockstep

    sharding = train_batch_sharding(mesh)
    net = tp_inner_steps(config.net)
    features = tp_inner_features(config.vgg)

    def rank_program(params, vgg_params, x):
        out = yield from net(params, x)
        feats = yield from features(vgg_params, out)
        return out, feats

    def step(state: TrainState, batch):
        optim.check_placed(state, mesh)
        if not donate:
            state = copy_state(state)

        def group_loss(ranks, x):
            devs = [mesh.devices[p] for p in ranks]
            xs = [x.to(d, non_blocking=True) for d in devs]
            vgg = [state.vgg_params.local(p) for p in ranks]
            with torch.no_grad():
                content = lockstep([features(v, xr) for v, xr in zip(vgg, xs)], devs)[0]
            out, feats = lockstep([rank_program(state.params.local(p), v, xr)
                                   for p, v, xr in zip(ranks, vgg, xs)], devs)[0]
            grams = [g.to(devs[0], non_blocking=True) for g in state.style_grams]
            return perceptual_loss(out, feats, content, grams, config)

        metrics = optim.descend(state.opt_state, lambda: optim.group_mean(
            mesh, sharding, batch, group_loss), dtypes, params=state.params,
            tracer=tracer, step=next(steps))
        state.step.add_(1)
        return state, metrics

    return step
