"""The port's style train step, driven from the seed.

Set-up builds one ``TrainState`` through ``init_train_state``, writes the
benchmark's seeded weights into its leaves (the port takes no weights
there) and recomputes the style Grams with the port's own encoder, then
drives that same state through three steps on the first three batches of
the pool (every row different), keeping Adam's first moment after step 1
and the parameters after step 3, and through ``warmup_steps`` more. The
window then dispatches steps ahead with no host sync inside it: each step
takes a seeded batch from a fixed pool in pinned memory and copies it
without blocking, as the port's training loop does. The losses are read
after the window.

Params: batch, size, pool, warmup_steps, trace_seconds.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs
from portbench.devtrace import DeviceWindow
from portbench.reference import F32, FP8, no_tf32
from portbench.reference import train as ref_train

BETA1 = 0.9


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: List[str]) -> Dict[str, float]:
    """Per leaf, |‖prog‖ − ‖ref‖| over the larger of ‖ref‖ and the median
    leaf's ‖ref‖."""
    refn = {k: _norm(ref[k]) for k in leaves}
    med = float(np.median(list(refn.values())))
    return {k: abs(_norm(prog[k]) - refn[k]) / max(refn[k], med, 1e-30) for k in leaves}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: List[str]) -> Dict[str, float]:
    """Per leaf, ‖prog − ref‖ over ‖ref‖: rounding that averages out of a
    norm stays in the difference."""
    return {k: _norm(prog[k].to(ref[k].device) - ref[k]) / max(_norm(ref[k]), 1e-30)
            for k in leaves}


def compare(losses_p, grad_p, change_p, losses_r, grad_r, change_r):
    """The numbers compared, and the detail behind them.

    - ``loss_gap``: the worst step's relative loss gap;
    - ``grad_gap``: the worst leaf's gap of first-gradient norms;
    - ``grad_gap_median``: the median leaf's gap of first-gradient norms,
      steady from seed to seed where the worst leaf is one small leaf's
      noise (the stem's norm affine);
    - ``change_gap``: the worst leaf's gap of three-step change norms;
    - ``grad_diff_median``: the median leaf's ‖g − g_ref‖ / ‖g_ref‖ of the
      first gradient. Rounding that is as likely up as down averages out of
      a norm and of a mean loss, so the gaps above part a lower precision
      from the configuration's only where its bias shows; the difference
      keeps every element's rounding.
    The leaf gaps leave out the leaves whose reference gradient is under a
    thousandth of the median leaf's: a conv bias or a norm bias whose every
    consumer is an instance norm has none, so its gradient is round-off and
    Adam moves it by round-off alone."""
    keys = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap", "grad_diff_median")
    if len(losses_p) != len(losses_r) or not all(map(math.isfinite, losses_p)):
        return dict.fromkeys(keys, math.inf), {}
    steps = [abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r)]
    gnorm = {k: _norm(grad_r[k]) for k in sorted(grad_r)}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k, n in gnorm.items() if n >= 1e-3 * med]
    g = leaf_gaps(grad_p, grad_r, moving)
    c = leaf_gaps(change_p, change_r, moving)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]  # noqa: E731
    detail = {"loss_gap_by_step": steps, "grad_worst": top(g), "change_worst": top(c),
              "left_out": [k for k in gnorm if k not in moving]}
    d = leaf_diffs(grad_p, grad_r, moving)
    values = (max(steps), max(g.values()), float(np.median(list(g.values()))),
              max(c.values()), float(np.median(list(d.values()))))
    return dict(zip(keys, values)), detail


class Setup:
    """The benchmark's inputs for one seed, on ``device``."""

    def __init__(self, ctx):
        p, cfg = ctx.params, ctx.config
        self.n_res = cfg["net"]["n_residual"]
        self.blocks = [tuple(b) for b in cfg["vgg"]["blocks"]]
        s = int(ctx.seed)
        self.net = inputs.make_params(
            inputs.johnson_layers(cfg["net"]["base_channels"], self.n_res), s, ctx.device)
        self.vgg = inputs.make_params(inputs.vgg_layers(self.blocks), s + 1, ctx.device)
        self.style = inputs.train_images(s + 2, 1, p["size"], ctx.device)
        pool = inputs.train_images(s + 3, p["pool"] * p["batch"], p["size"], ctx.device)
        self.pool = pool.view(p["pool"], p["batch"], p["size"], p["size"], 3)

    def reference(self, ctx, prec=F32):
        """Three reference steps on the pool's first three batches."""
        cfg = ctx.config
        with no_tf32():
            return ref_train.run_steps(self.net, self.vgg, self.style,
                                       [self.pool[i] for i in range(3)], self.blocks,
                                       self.n_res, cfg["loss"],
                                       cfg["optimizer"]["learning_rate"], prec)


def run(ctx):
    from dvf_tpu_torch.models.layers import gram_matrix
    from dvf_tpu_torch.models.style_transfer import StyleNetConfig
    from dvf_tpu_torch.models.vgg import VGGConfig, vgg_features
    from dvf_tpu_torch.train import optim
    from dvf_tpu_torch.train.style import (StyleTrainConfig, copy_state, init_train_state,
                                           make_train_step)

    p, cfg = ctx.params, ctx.config
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    su = Setup(ctx)
    ctx.mark("inputs")
    config = StyleTrainConfig(
        net=StyleNetConfig(base_channels=cfg["net"]["base_channels"],
                           n_residual=su.n_res, compute_dtype=dt),
        vgg=VGGConfig(blocks=tuple(su.blocks), compute_dtype=dt),
        learning_rate=cfg["optimizer"]["learning_rate"], **cfg["loss"])
    state = init_train_state(int(ctx.seed), su.style.cpu(), config, device=ctx.device)
    with torch.no_grad():
        for tree, src in ((state.params, su.net), (state.vgg_params, su.vgg)):
            for k, leaves in tree.items():
                for n, t in leaves.items():
                    t.copy_(src[k][n])
        state.style_grams = [gram_matrix(f)[0] for f in
                             vgg_features(state.vgg_params, su.style, config.vgg)]
    step = make_train_step(config=config, state_template=state)
    ctx.mark("program")
    if ctx.fault == "unchanged":          # the step hands its state back unchanged
        real = step

        def step(s, b):
            return s, real(copy_state(s), b)[1]
    elif ctx.fault == "half_batch":       # half of the batch left out
        real_half = step

        def step(s, b):
            return real_half(s, b[: b.shape[0] // 2])
    elif ctx.fault:
        raise ValueError(f"unknown fault {ctx.fault!r}")

    pin = ctx.device.type == "cuda"
    host = su.pool.cpu()
    host = host.pin_memory() if pin else host
    order = np.random.default_rng(ctx.seed).integers(0, p["pool"], size=1 << 16)

    def feed(i):
        return host[i].to(ctx.device, non_blocking=True)

    first_losses = []
    state, m = step(state, feed(0))
    first_losses.append(m["loss"])
    _, mu, _ = optim.adam_state(state.opt_state, state.params)
    grad_p = {k: v.detach().clone() / (1 - BETA1) for k, v in mu.items()}
    for i in (1, 2):
        state, m = step(state, feed(i))
        first_losses.append(m["loss"])
    after3 = {k: t.detach().clone() for k, t in optim.flatten(state.params).items()}
    ctx.mark("first_steps")
    for j in range(p["warmup_steps"]):
        state, m = step(state, feed(int(order[j])))
    if pin:
        torch.cuda.synchronize(ctx.device)

    losses, steps, j = [], 0, p["warmup_steps"]
    dw = None
    lead = max(0.0, (ctx.seconds - p["trace_seconds"]) / 2)
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= ctx.seconds:
            break
        if ctx.trace and pin:
            if dw is None and now - t0 >= lead:
                dw = DeviceWindow(ctx.device)
                dw.start()
            elif dw is not None and dw.t1 is None and now - t0 >= lead + p["trace_seconds"]:
                dw.stop()
        with ctx.spans.span("train.step"):
            state, m = step(state, feed(int(order[j % len(order)])))
        losses.append(m["loss"])
        steps += 1
        j += 1
    if dw is not None and dw.t1 is None:
        dw.stop()
    if pin:
        torch.cuda.synchronize(ctx.device)
    t1 = time.perf_counter()
    if dw is not None:
        dw.close()
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if pin else 0
    window_losses = torch.stack(losses).float().cpu() if losses else torch.zeros(0)
    losses_p = [float(x) for x in first_losses]
    del state, step, m, losses, first_losses
    gc.collect()
    if pin:
        torch.cuda.empty_cache()

    change_p = {k: after3[k] - su.net[k.split("/")[0]][k.split("/")[1]] for k in after3}
    t_ref = time.perf_counter()
    losses_r, grad_r, change_r = su.reference(ctx)
    reference_s = time.perf_counter() - t_ref
    got, detail = compare(losses_p, grad_p, change_p, losses_r, grad_r, change_r)
    limits = ctx.cell["limits"]
    trace = dw.reduce(ctx.spans.at) if dw is not None else None
    spans = ctx.spans.named("train.step", t0, t1)
    return {
        "t_start": t0, "t_end": t1, "window_s": t1 - t0,
        "attempted": steps, "failed": int((~torch.isfinite(window_losses)).sum()),
        "steps_in_window": steps,
        "dispatch_ms_per_step": (1000.0 * sum(e - s for _, s, e in spans) / len(spans)
                                 if spans else None),
        "train_geometry": (p["batch"], p["size"]),
        "memory_peak_bytes": memory_peak,
        "trace": trace,
        "losses": {"program": losses_p, "reference": losses_r},
        "detail": detail,
        "reference_s": reference_s,
        "checks": {k: (v, limits[k]) for k, v in got.items()},
    }


def control(ctx) -> dict:
    """The control's reading at the cell's size: the float8 reference in the
    program's place, held to the float32 reference."""
    su = Setup(ctx)
    losses_r, grad_r, change_r = su.reference(ctx)
    losses_c, grad_c, change_c = su.reference(ctx, prec=FP8)
    return compare(losses_c, grad_c, change_c, losses_r, grad_r, change_r)[0]
