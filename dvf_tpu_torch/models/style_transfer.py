"""Fast neural style transfer (port of ``dvf_tpu.models.style_transfer``).

BASELINE.json configs[4]: the Johnson et al. (2016) feed-forward
transformer net — 9×9 stem conv → two stride-2 downsampling convs → N
residual blocks at ¼ resolution → two ×2 resize-convs → 9×9 output conv,
instance norm + ReLU throughout, scaled-tanh output.

The forward rounds where the reference rounds: every conv result and its
bias add are in the compute dtype, each instance norm returns to it, and
the final tanh is float32. Each conv's bias add, the instance norm after
it, the ReLU and the residual add are one call (``layers.bias_norm_act``):
on a card outside autograd the hand-written kernels of ``csrc/norm.cu``,
elsewhere the plain ops. The out conv, its bias and the scaled tanh are
one call too (``layers.out_conv_tanh``): on a card outside autograd in
bf16 the kernel of ``csrc/outconv.cu``; under TP (a row-parallel partial
summed before the bias) and with ``fast_convs`` the plain ops.

Tensor parallelism over a mesh's ``model`` axis is explicit: Megatron
column/row alternation (:func:`param_pspecs`), each rank running the rank
program :func:`tp_inner_steps` on its weight blocks with one sum across
the ranks after each row-parallel conv. Layer pipelining
(:func:`pp_inner_apply`) stacks the residual trunk (:func:`to_pp_params`)
and runs it as a GPipe schedule over the model axis (``parallel.pp``); on
one device the same grouping runs as a loop (:func:`pp_sequential_apply`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from dvf_tpu_torch.models.layers import (
    Params,
    SUM,
    bias_norm_act,
    bias_tanh,
    conv2d_nb,
    conv2d_s2d,
    conv_init,
    exact_f32_convs,
    float32_partials,
    generator,
    instance_norm_init,
    out_conv_tanh,
    run_steps,
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


def _conv_modes(config: StyleNetConfig) -> Dict[str, str]:
    """Which convs are column- vs row-parallel (see param_pspecs)."""
    modes = {
        "stem": "col", "down1": "row", "down2": "col",
        "up1": "row", "up2": "col", "out": "row",
    }
    for i in range(config.n_residual):
        modes[f"res{i}_a"] = "row"
        modes[f"res{i}_b"] = "col"
    return modes


def _forward(params: Params, batch: torch.Tensor, config: StyleNetConfig,
             trunk_fn: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None,
             ) -> torch.Tensor:
    """Shared unsharded forward body. ``trunk_fn(params, x)`` replaces the
    flat residual loop (the PP grouping passes its loop over stacked
    blocks): one copy of the stem/decoder wiring, however the trunk
    runs."""
    return run_steps(_forward_steps(params, batch, config, trunk_fn))


def _forward_steps(params: Params, batch: torch.Tensor, config: StyleNetConfig,
                   trunk_fn=None, tp: bool = False):
    """The forward as a rank program (``layers.run_steps``): under TP
    (``tp``) each row-parallel conv yields its float32 partial as a
    ``SUM`` request and resumes with the sum across the ranks."""
    cd = config.compute_dtype
    modes = _conv_modes(config) if tp else {}

    def cv(name, x, stride=1, upsampled=False):
        """The conv's output before its bias, in the compute dtype."""
        if modes.get(name) == "row":
            # The rank's partial sum in float32; the sum across the
            # ranks rounds it to the compute dtype once.
            with float32_partials():
                y = conv(name, x, stride, upsampled)
            y = yield SUM, y
            return y.to(cd)
        return conv(name, x, stride, upsampled)

    def cv_norm(name, norm, x, relu=True, residual=None, **kw):
        """conv → bias → instance norm → [ReLU] → [+ residual], the last
        four as one call."""
        y = yield from cv(name, x, **kw)
        return bias_norm_act(params[norm], y, params[name]["b"], relu=relu,
                             residual=residual)

    def conv(name, x, stride, upsampled):
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
        return y

    with exact_f32_convs(cd):
        x = batch.to(cd)
        x = yield from cv_norm("stem", "stem_norm", x)
        x = yield from cv_norm("down1", "down1_norm", x, stride=2)
        x = yield from cv_norm("down2", "down2_norm", x, stride=2)
        if trunk_fn is not None:
            x = trunk_fn(params, x)
        else:
            for i in range(config.n_residual):
                h = yield from cv_norm(f"res{i}_a", f"res{i}_an", x)
                x = yield from cv_norm(f"res{i}_b", f"res{i}_bn", h, relu=False,
                                       residual=x)
        x = yield from cv_norm("up1", "up1_norm", x, upsampled=True)
        x = yield from cv_norm("up2", "up2_norm", x, upsampled=True)
        if modes.get("out") == "row" or config.fast_convs:
            # A row-parallel partial sums across the ranks before its
            # bias; fast_convs computes the conv space-to-depth.
            return bias_tanh((yield from cv("out", x)), params["out"]["b"], batch.dtype)
        return out_conv_tanh(params["out"], x, cd, batch.dtype)


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

    def cv_norm(p, norm, x, relu=True, residual=None):
        y = conv2d_nb(p, x, compute_dtype=cd, reflect=True)
        return bias_norm_act(norm, y, p["b"], relu=relu, residual=residual)

    def res_block(p, x):
        h = cv_norm(p["a"], p["an"], x)
        return cv_norm(p["b"], p["bn"], h, relu=False, residual=x)

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


def tp_inner_steps(config: StyleNetConfig) -> Callable[..., Any]:
    """The per-rank forward under tensor parallelism as a rank program,
    ``program(params, batch)``: this rank's weight blocks
    (:func:`param_pspecs`), each row-parallel conv's float32 partial
    yielded as a ``SUM`` request. ``parallel.sharded.lockstep`` drives
    one per rank, for the serving body (``parallel.sharded.tp_filter``)
    and the sharded train step alike."""
    return lambda params, batch: _forward_steps(params, batch, config, tp=True)


def param_pspecs(config: StyleNetConfig = StyleNetConfig()) -> Dict[str, Any]:
    """PartitionSpec tree for tensor parallelism over the ``model`` axis.

    Megatron-style alternation: **column-parallel** convs shard output
    channels (activations leave C-sharded), the following **row-parallel**
    conv shards input channels (each rank consumes the channels it owns,
    and one sum across the ranks forms the output). Collectives therefore
    appear once per col→row pair instead of per layer. Instance norms
    normalize over (H, W) per channel, so a norm after a column conv simply
    shards its scale/bias with the channels; after a row conv it replicates.

    Alternation map (activations C-sharded after stem, down2, res*_b, up2):
    stem=col → down1=row → down2=col → [res_a=row, res_b=col]* →
    up1=row → up2=col → out=row.
    """
    from dvf_tpu_torch.parallel.mesh import P

    def col():
        return {"w": P(None, None, None, "model"), "b": P("model")}

    def row():
        return {"w": P(None, None, "model", None), "b": P()}

    def norm_spec(sharded: bool):
        s = P("model") if sharded else P()
        return {"scale": s, "bias": s}

    specs: Dict[str, Any] = {
        "stem": col(),
        "stem_norm": norm_spec(True),
        "down1": row(),
        "down1_norm": norm_spec(False),
        "down2": col(),
        "down2_norm": norm_spec(True),
        "up1": row(),
        "up1_norm": norm_spec(False),
        "up2": col(),
        "up2_norm": norm_spec(True),
        "out": row(),
    }
    for i in range(config.n_residual):
        specs[f"res{i}_a"] = row()
        specs[f"res{i}_an"] = norm_spec(False)
        specs[f"res{i}_b"] = col()
        specs[f"res{i}_bn"] = norm_spec(True)
    return specs


def pp_param_pspecs(config: StyleNetConfig = StyleNetConfig(),
                    stage_axis: Optional[str] = "model") -> Dict[str, Any]:
    """PartitionSpecs for the PP grouping: trunk layer-dim on
    ``stage_axis`` (each device owns N/S contiguous blocks — the PP memory
    win), the non-repeated stem/decoder replicated. ``stage_axis=None``
    replicates the trunk too (the grouping run unpipelined)."""
    from dvf_tpu_torch.parallel.mesh import P

    conv_r = {"w": P(), "b": P()}
    norm_r = {"scale": P(), "bias": P()}
    specs: Dict[str, Any] = {
        "stem": conv_r, "stem_norm": norm_r,
        "down1": conv_r, "down1_norm": norm_r,
        "down2": conv_r, "down2_norm": norm_r,
        "up1": conv_r, "up1_norm": norm_r,
        "up2": conv_r, "up2_norm": norm_r,
        "out": conv_r,
    }
    # Stacked leaves: conv w (L,kh,kw,cin,cout) / b (L,c); norm (L,c).
    conv_s = {"w": P(stage_axis, None, None, None, None), "b": P(stage_axis, None)}
    norm_s = {"scale": P(stage_axis, None), "bias": P(stage_axis, None)}
    specs["trunk"] = {"a": conv_s, "an": norm_s, "b": conv_s, "bn": norm_s}
    return specs


def pp_inner_apply(config: StyleNetConfig, n_microbatches: int = 0
                   ) -> Callable[..., torch.Tensor]:
    """Apply for ``parallel='pp'`` over one model-axis group:
    ``inner(stage_params, batch, devices)`` with ``stage_params[s]`` the
    PP-grouped params held by ``devices[s]`` (stage s's slice of the
    trunk). Stem/down and up/out run on stage 0's device (the batch's);
    the residual trunk runs as a GPipe pipeline over the stages
    (``parallel.pp.pipeline_apply``), activations hopping devices."""
    from dvf_tpu_torch.parallel.pp import pipeline_apply

    block = _pp_res_block(config)

    def inner(stage_params, batch, devices):
        def trunk(_params, x):
            return pipeline_apply(block, [p["trunk"] for p in stage_params], x,
                                  devices, n_microbatches=n_microbatches)

        return _forward(stage_params[0], batch, config, trunk_fn=trunk)

    return inner
