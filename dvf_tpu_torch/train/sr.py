"""Self-supervised training for the ESPCN super-resolution net (port of
``dvf_tpu.train.sr``).

No dataset: each HR frame is area-downscaled ×r on the device to make the
LR input, and the net learns to reconstruct the original. The loss is
Charbonnier (smooth L1). The step mirrors ``train.style``: forward +
backward + ``torch.optim.Adam``, the state updated in place
(``donate=False`` steps a copy), on the state's device (``mesh=None``) or
over a mesh (the batch over ``data`` × ``space``, feat column- and map
row-parallel over ``model``, head replicated; PSNR derived once, from the
groups' mean MSE).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.models.espcn import (
    EspcnConfig,
    apply_espcn,
    init_espcn,
    param_pspecs,
    tp_inner_steps,
)
from dvf_tpu_torch.train import optim


@dataclasses.dataclass(frozen=True)
class SrTrainConfig:
    net: EspcnConfig = EspcnConfig()
    learning_rate: float = 1e-3
    charbonnier_eps: float = 1e-3


@dataclasses.dataclass
class SrTrainState:
    params: Any                      # leaf tensors that require grad (a
    #   train.optim.MeshParams over a mesh)
    opt_state: Any                   # torch.optim.Adam over params' leaves
    step: torch.Tensor               # 0-d int32 on the state's (first) device


def synthesize_structured_batch(rng: np.random.Generator, batch: int,
                                size: int) -> np.ndarray:
    """Randomized structured HR frames (oriented gratings, rings around
    random centres, hard-edged checkers; a fresh draw per channel), the
    same bytes as the reference for the same generator state. Values
    uint8, shape (B, size, size, 3)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((batch, size, size, 3), np.uint8)
    for b in range(batch):
        chans = []
        for _ in range(3):
            kind = rng.integers(0, 3)
            if kind == 0:  # oriented grating
                freq = rng.uniform(6.0, 32.0)
                ang = rng.uniform(0.0, np.pi)
                ph = rng.uniform(0.0, 2 * np.pi)
                u = xx * np.cos(ang) + yy * np.sin(ang)
                ch = 127.5 + 127.5 * np.sin(2 * np.pi * u / freq + ph)
            elif kind == 1:  # rings around a random center
                cy, cx = rng.uniform(0, size, 2)
                rad = np.hypot(yy - cy, xx - cx)
                ch = 127.5 + 127.5 * np.sin(rad / rng.uniform(2.0, 8.0))
            else:  # hard-edged checker, random scale + offset
                s = rng.integers(5, 21)
                oy, ox = rng.integers(0, s, 2)
                ch = (((xx + ox) // s).astype(int)
                      + ((yy + oy) // s).astype(int)) % 2 * 255.0
            chans.append(ch)
        out[b] = np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)
    return out


def downscale_area(x: torch.Tensor, r: int) -> torch.Tensor:
    """Area (box) ×r downscale of an NHWC batch; H and W must be divisible
    by r."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"({h}, {w}) not divisible by scale {r}")
    xf = x.float()
    return xf.reshape(b, h // r, r, w // r, r, c).mean(dim=(2, 4)).to(x.dtype)


def sr_loss_fn(
    params: Any,
    hr_batch: torch.Tensor,
    config: SrTrainConfig,
    apply_fn=None,
) -> Tuple[torch.Tensor, dict]:
    """(Charbonnier loss, {"loss", "mse"}) of reconstructing a float NHWC
    HR batch from its ×r area downscale. The MSE (not PSNR) goes in the
    metrics, as in the reference: the step derives PSNR from it."""
    apply_fn = apply_fn or (lambda p, b: apply_espcn(p, b, config.net))
    out = apply_fn(params, downscale_area(hr_batch, config.net.scale))
    return charbonnier(out, hr_batch, config)


def charbonnier(out: torch.Tensor, hr_batch: torch.Tensor,
                config: SrTrainConfig) -> Tuple[torch.Tensor, dict]:
    """The loss terms of :func:`sr_loss_fn` from the net's output."""
    diff = out.float() - hr_batch.float()
    loss = torch.mean(torch.sqrt(diff * diff + config.charbonnier_eps ** 2))
    mse = torch.mean(diff * diff)
    return loss, {"loss": loss, "mse": mse}


def make_optimizer(config: SrTrainConfig, params: Any) -> torch.optim.Adam:
    """``optax.adam(config.learning_rate)``'s counterpart over ``params``'
    leaves (``train.optim.adam``)."""
    return optim.adam(params, config.learning_rate)


def init_train_state(rng: Union[int, torch.Generator],
                     config: SrTrainConfig = SrTrainConfig(),
                     device=None) -> SrTrainState:
    """Seeded params + optimizer state on ``device`` (``cuda:0`` unless
    the caller names the CPU; raises without CUDA)."""
    from dvf_tpu_torch.runtime.engine import resolve_device

    dev = resolve_device(device)
    params = optim.trainable(init_espcn(rng, config.net), dev)
    return SrTrainState(params=params, opt_state=make_optimizer(config, params),
                        step=torch.zeros((), dtype=torch.int32, device=dev))


def copy_state(state: SrTrainState) -> SrTrainState:
    """An independent copy: its own param leaves and optimizer moments."""
    params, opt = optim.clone(state.params, state.opt_state)
    return SrTrainState(params=params, opt_state=opt, step=state.step.clone())


def state_pspecs(state: SrTrainState, config: SrTrainConfig) -> SrTrainState:
    """Spec tree mirroring an SrTrainState: Adam's moments take each param
    leaf's TP spec, the count and the step replicate."""
    from dvf_tpu_torch.parallel.mesh import P

    p_specs = param_pspecs(config.net)
    return SrTrainState(params=p_specs,
                        opt_state={"count": P(), "mu": p_specs, "nu": p_specs},
                        step=P())


def shard_train_state(state: SrTrainState, mesh, config: SrTrainConfig) -> SrTrainState:
    """Place a one-device SrTrainState onto ``mesh`` per ``state_pspecs``
    (as ``train.style.shard_train_state``)."""
    dev = mesh.first_device
    whole = optim.whole(state.params)
    count, mu, nu = optim.adam_state(state.opt_state, state.params)
    params = (optim.trainable(whole, dev) if mesh.size == 1
              else optim.place(whole, mesh, state_pspecs(state, config).params))
    opt = optim.adam(params, state.opt_state.param_groups[0]["lr"])
    optim.set_adam_state(opt, params, count, mu, nu)
    return SrTrainState(params=params, opt_state=opt, step=state.step.to(dev).clone())


def train_batch_sharding(mesh):
    """The batch layout of the sharded step (``train.style``'s)."""
    from dvf_tpu_torch.train.style import train_batch_sharding as style_sharding

    return style_sharding(mesh)


def make_train_step(
    mesh=None,
    config: SrTrainConfig = SrTrainConfig(),
    state_template: Optional[SrTrainState] = None,
    donate: bool = True,
) -> Callable[[SrTrainState, torch.Tensor], Tuple[SrTrainState, dict]]:
    """The step ``(state, hr_batch) -> (state, {"loss", "psnr"})``;
    metrics are 0-d tensors (no sync). ``donate`` and ``mesh`` as in
    :func:`dvf_tpu_torch.train.style.make_train_step`."""
    if state_template is None:
        raise ValueError("make_train_step needs a state_template SrTrainState")
    dtypes = (config.net.compute_dtype,)
    if mesh is not None and mesh.size > 1:
        from dvf_tpu_torch.parallel.sharded import lockstep

        sharding = train_batch_sharding(mesh)
        net = tp_inner_steps(config.net)

        def loss_fn(state, hr_batch):
            def group_loss(ranks, hr):
                devs = [mesh.devices[p] for p in ranks]
                hrs = [hr.to(d, non_blocking=True) for d in devs]
                out = lockstep([net(state.params.local(p),
                                    downscale_area(h, config.net.scale))
                                for p, h in zip(ranks, hrs)], devs)[0]
                return charbonnier(out, hrs[0], config)

            optim.check_placed(state, mesh)
            return lambda: optim.group_mean(mesh, sharding, hr_batch, group_loss)
    else:
        def loss_fn(state, hr_batch):
            hr = torch.as_tensor(hr_batch).to(state.step.device, non_blocking=True)
            return lambda: sr_loss_fn(state.params, hr, config)

    def step(state: SrTrainState, hr_batch):
        if not donate:
            state = copy_state(state)
        metrics = optim.descend(state.opt_state, loss_fn(state, hr_batch), dtypes,
                                params=state.params)
        metrics["psnr"] = -10.0 * torch.log10(metrics.pop("mse") + 1e-12)
        state.step.add_(1)
        return state, metrics

    return step
