"""BasicVSR++, ×4 video super-resolution over a clip of frames.

Chan, Zhou, Xu and Loy, "BasicVSR++: Improving Video Super-Resolution
with Enhanced Propagation and Alignment" (CVPR 2022, arXiv:2104.13371),
network ``BasicVSRPlusPlus`` of OpenMMLab's mmediting (``basicvsr_pp.py``),
configuration ``basicvsr_plusplus_c64n7_8x1_600k_reds4`` (the defaults of
:class:`BasicVsrConfig`: 64 channels, 7 blocks a propagation backbone,
residue magnitude 10, low-resolution input; 7.3 M parameters).

The forward, a clip of T ≥ 2 NHWC frames in [0, 1] (each at least 64×64)
→ T frames ×4:

- flow (SpyNet): both frames normalised by the ImageNet mean and std,
  resized bilinearly up to a multiple of 32, a 6-level average-pool
  pyramid; from coarse to fine, ``flow = up2(flow)·2 + basic(cat[ref,
  warp_border(supp, up2(flow)·2), up2(flow)·2])`` (``up2`` bilinear with
  aligned corners; the coarsest level starts from zero), ``basic`` five
  7×7 convs 8→32→64→32→16→2 with a ReLU after all but the last; the flow
  resized back and its components rescaled. Backward flows are
  SpyNet(x_i, x_{i+1}), forward flows SpyNet(x_{i+1}, x_i), all 2(T − 1)
  pairs in one batch;
- features: a 3×3 conv 3→64, LeakyReLU(0.1), 5 residual blocks
  (``x + conv(ReLU(conv(x)))``), every frame at once;
- propagation: passes ``backward_1``, ``forward_1``, ``backward_2``,
  ``forward_2``, each walking the clip in its direction. At step i > 0,
  with f₁ the flow to the previous step and f₂ = f₁ + warp(f_prev, f₁):
  cond = cat[warp(h_{i−1}, f₁), spatial_i, warp(h_{i−2}, f₂)] (h_{i−2}
  and f₂ zero at i = 1); the offset stack, four 3×3 convs 196→64→64→64→
  27·16 with LeakyReLU(0.1) between, on cat[cond, f₁, f₂], split o₁, o₂,
  m; offsets 10·tanh(cat[o₁, o₂]) plus f₁ (groups 0–7) or f₂ (groups
  8–15) as (y, x) at every tap, mask sigmoid(m); then the modulated
  deformable 3×3 conv (DCNv2, 16 groups) of cat[h_{i−1}, h_{i−2}] → 64
  channels (:func:`deform_conv`). Every step then adds its backbone:
  h_i = aligned + ResBlocks(cat[spatial_i, the earlier passes at i,
  aligned]), a 3×3 input conv (2 + k)·64 → 64, LeakyReLU and 7 residual
  blocks (``aligned`` is zero at the first step). ``warp`` is bilinear,
  zero padded, with aligned corners;
- reconstruction: cat[spatial, the four passes] (320 channels), a 3×3
  conv to 64, LeakyReLU, 5 residual blocks; two PixelShufflePacks (3×3
  conv 64→256, ``nn.PixelShuffle(2)``, LeakyReLU); ``conv_hr`` 3×3 and
  LeakyReLU, ``conv_last`` 3×3 to RGB; plus the input upsampled ×4
  bilinearly (half-pixel centres); clamped to [0, 1] as a sink shows it.

Params are float32 in PyTorch's layouts, one ``{"w": OIHW, "b"}`` per
conv (:func:`init_basicvsrpp`, :func:`conv_layers`); the deformable conv's
weight is ``(64, 128, 3, 3)``. :func:`prepare_basicvsrpp` turns them into
what a device runs: every conv weight in the compute dtype and
channels-last, the deformable conv's as a ``(1152, 64)`` GEMM operand.

Precision: the flows, the offsets and mask (the offset stack's output
widened before tanh, the flow add and the sigmoid), the sampling
positions and bilinear weights, and the warped and sampled values (the
features widened to float32 before they are sampled) are float32.
Everything else runs in ``compute_dtype``: every conv, SpyNet's
included, the deformable conv's GEMM (on the masked samples rounded to
it), the residual stream. The output is float32.

Nothing in the forward reads a device value on the host. The clip is one
stream's consecutive frames (``Filter.clip``); mmediting's check for a
mirror-extended clip is left out (stream clips are never mirrored).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from dvf_tpu_torch.models.layers import NoMarks, Params, generator, pixel_shuffle

# Span names (``Tracer.device_span`` on a card, ``Tracer.complete`` on the
# CPU), each tagged with the filter's clip number ``seq``, the propagation
# spans also with ``pass``. Together they cover the whole forward.
SPAN_FLOW = "vsr.flow"
SPAN_EXTRACT = "vsr.extract"
SPAN_WARP = "vsr.warp"
SPAN_OFFSET = "vsr.offset"
SPAN_DCN = "vsr.dcn"
SPAN_BACKBONE = "vsr.backbone"
SPAN_UPSAMPLE = "vsr.upsample"
SPANS = (SPAN_FLOW, SPAN_EXTRACT, SPAN_WARP, SPAN_OFFSET, SPAN_DCN, SPAN_BACKBONE,
         SPAN_UPSAMPLE)

PASSES = ("backward_1", "forward_1", "backward_2", "forward_2")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SPYNET_WIDTHS = (8, 32, 64, 32, 16, 2)


@dataclasses.dataclass(frozen=True)
class BasicVsrConfig:
    """BasicVSR++ ×4 as published (``basicvsr_plusplus_c64n7_8x1_600k_reds4``)."""
    mid_channels: int = 64
    num_blocks: int = 7              # residual blocks of each propagation backbone
    max_residue_magnitude: float = 10.0
    deform_groups: int = 16
    extract_blocks: int = 5
    recon_blocks: int = 5
    spynet_levels: int = 6
    upscale: int = 4
    compute_dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass
class VsrStats:
    """Counters of a traced BasicVSR++ filter (kept while its tracer is
    enabled): clips and frames stepped (the engine's compile calls
    included), padded frames (trailing frames equal to the one before
    them, as the pipeline pads a short clip: counted on the device and
    read when the filter's ``stats`` is read), deformable-conv calls and
    propagation steps."""
    clips: int = 0
    frames: int = 0
    padded_frames: int = 0
    dcn_calls: int = 0
    propagation_steps: int = 0


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

# A conv layer: (name, cout, cin, k, init). init "conv": PyTorch's default
# (weight and bias uniform in ±1/sqrt(fan_in)); "kaiming": Kaiming normal
# (fan_in, ReLU gain), zero bias (a PixelShufflePack's conv); "res": the
# same times 0.1 (a residual block's conv).
Layer = Tuple[str, int, int, int, str]


def _res_layers(prefix: str, cin: int, c: int, blocks: int) -> List[Layer]:
    out: List[Layer] = [(f"{prefix}.in", c, cin, 3, "conv")]
    for j in range(blocks):
        out += [(f"{prefix}.rb{j}.c1", c, c, 3, "res"), (f"{prefix}.rb{j}.c2", c, c, 3, "res")]
    return out


def conv_layers(config: BasicVsrConfig = BasicVsrConfig()) -> List[Layer]:
    """Every conv of the net, in the order :func:`init_basicvsrpp` draws
    them."""
    c, g = config.mid_channels, config.deform_groups
    out: List[Layer] = []
    for lvl in range(config.spynet_levels):
        for k, (ci, co) in enumerate(zip(SPYNET_WIDTHS[:-1], SPYNET_WIDTHS[1:])):
            out.append((f"spynet.l{lvl}.c{k}", co, ci, 7, "conv"))
    out += _res_layers("extract", 3, c, config.extract_blocks)
    for i, name in enumerate(PASSES):
        out += [(f"{name}.offset0", c, 3 * c + 4, 3, "conv"),
                (f"{name}.offset1", c, c, 3, "conv"),
                (f"{name}.offset2", c, c, 3, "conv"),
                (f"{name}.offset3", 27 * g, c, 3, "conv"),
                (f"{name}.dcn", c, 2 * c, 3, "conv")]
        out += _res_layers(f"{name}.backbone", (2 + i) * c, c, config.num_blocks)
    out += _res_layers("recon", 5 * c, c, config.recon_blocks)
    out += [("up1", 4 * c, c, 3, "kaiming"), ("up2", 4 * 64, c, 3, "kaiming"),
            ("conv_hr", 64, 64, 3, "conv"), ("conv_last", 3, 64, 3, "conv")]
    return out


def init_basicvsrpp(rng: Union[int, torch.Generator],
                    config: BasicVsrConfig = BasicVsrConfig()) -> Params:
    """Seeded float32 weights on the CPU, drawn as the published init
    draws them (:func:`conv_layers`), except the offset stack's last conv,
    which the published init zeroes (it would leave the offsets equal to
    the flow): it is drawn like the other convs."""
    gen = generator(rng)
    p: Params = {}
    for name, cout, cin, k, init in conv_layers(config):
        fan_in = cin * k * k
        if init in ("res", "kaiming"):
            gain = 0.1 if init == "res" else 1.0
            w = torch.randn((cout, cin, k, k), generator=gen) * (gain * math.sqrt(2.0 / fan_in))
            b = torch.zeros(cout)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            w = (torch.rand((cout, cin, k, k), generator=gen) * 2 - 1) * bound
            b = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
        p[name] = {"w": w, "b": b}
    return p


def prepare_basicvsrpp(params: Params, config: BasicVsrConfig, device) -> Dict[str, Any]:
    """The weights as the forward runs them (module docstring), on
    ``device``; sampling grids are added per frame size at the first call
    (``"geometry"``)."""
    cd, dev = config.compute_dtype, torch.device(device)
    prep: Dict[str, Any] = {
        "mean": torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1),
        "std": torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1),
        "geometry": {}}
    for name, *_ in conv_layers(config):
        w, b = params[name]["w"], params[name]["b"]
        if name.endswith(".dcn"):
            prep[name] = {"w": w.reshape(w.shape[0], -1).t().to(device=dev, dtype=cd).contiguous(),
                          "b": b.to(device=dev, dtype=cd)}
        else:
            prep[name] = {"w": w.to(device=dev, dtype=cd).contiguous(
                memory_format=torch.channels_last), "b": b.to(device=dev, dtype=cd)}
    return prep


# ---------------------------------------------------------------------------
# Warps and the deformable conv (float32 positions)
# ---------------------------------------------------------------------------


def _base(prep, h: int, w: int, device) -> Tuple[torch.Tensor, ...]:
    """(ys (h, 1), xs (1, w), the 3×3 taps' dy and dx (1, 9, 1, 1)), float32
    pixel offsets on ``device``, cached per size in ``prep``."""
    geom = prep["geometry"] if prep is not None else {}
    got = geom.get((h, w))
    if got is None:
        k = torch.arange(9, device=device)
        got = (torch.arange(h, dtype=torch.float32, device=device).view(h, 1),
               torch.arange(w, dtype=torch.float32, device=device).view(1, w),
               (k // 3 - 1).to(torch.float32).view(1, 9, 1, 1),
               (k % 3 - 1).to(torch.float32).view(1, 9, 1, 1))
        geom[(h, w)] = got
    return got


def _grid(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel positions → ``grid_sample``'s aligned-corner coordinates,
    (..., 2) as (x, y)."""
    return torch.stack((xs * (2.0 / max(w - 1, 1)) - 1.0,
                        ys * (2.0 / max(h - 1, 1)) - 1.0), dim=-1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding: str = "zeros",
              prep=None) -> torch.Tensor:
    """``x`` (N, C, H, W) float32 sampled at ``p + flow(p)`` (``flow``
    (N, 2, H, W) float32, x then y, in pixels): bilinear with aligned
    corners, ``padding`` ``"zeros"`` (each corner outside the frame reads
    0) or ``"border"`` (positions clamped to the frame, as
    ``ops.flow.warp_by_flow``)."""
    _, _, h, w = x.shape
    ys, xs, _, _ = _base(prep, h, w, x.device)
    grid = _grid(ys + flow[:, 1], xs + flow[:, 0], h, w)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode=padding, align_corners=True)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor, groups: int, prep=None) -> torch.Tensor:
    """The modulated deformable 3×3 conv (DCNv2, stride 1, padding 1) of
    one NHWC frame ``x`` (1, H, W, Cin), on ``offset`` (1, H, W, 2·9·groups)
    float32, its channels laid out (group, tap, (y, x)) as mmcv's, and
    ``mask`` (1, H, W, 9·groups) float32, laid out (group, tap); taps
    row-major. Tap k of group g samples the group's ``Cin / groups``
    channels bilinearly at ``(h + k // 3 − 1 + dy, w + k % 3 − 1 + dx)``,
    zero outside the frame, in float32; the samples, times the mask, are
    rounded to ``w``'s dtype and multiplied by ``w`` ((Cin·9, Cout), rows
    (channel, tap)) in one GEMM, plus ``b``. Returns NHWC (1, H, W, Cout)."""
    _, h, wd, cin = x.shape
    ys, xs, ky, kx = _base(prep, h, wd, x.device)
    off = offset.view(h, wd, groups, 9, 2).permute(2, 3, 0, 1, 4)       # (g, 9, H, W, 2)
    grid = _grid(off[..., 0] + (ys + ky), off[..., 1] + (xs + kx), h, wd)
    src = x.float().permute(0, 3, 1, 2).reshape(groups, cin // groups, h, wd)
    cols = F.grid_sample(src, grid.view(groups, 9 * h, wd, 2), mode="bilinear",
                         padding_mode="zeros", align_corners=True)       # (g, Cin/g, 9·H, W)
    m = mask.view(h, wd, groups, 9).permute(2, 3, 0, 1).unsqueeze(1)    # (g, 1, 9, H, W)
    cols = cols.view(groups, cin // groups, 9, h, wd).mul_(m).to(w.dtype)
    out = torch.addmm(b, cols.view(cin * 9, h * wd).t(), w)
    return out.view(1, h, wd, -1)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


def _conv(p, x: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` by an OIHW channels-last weight, SAME zero padding →
    NHWC (a view of a channels-last result)."""
    k = p["w"].shape[-1]
    return F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], padding=k // 2).permute(0, 2, 3, 1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _res_blocks(prep, prefix: str, blocks: int, x: torch.Tensor) -> torch.Tensor:
    """``ResidualBlocksWithInputConv``: conv, LeakyReLU, ``blocks`` times
    ``x + conv(ReLU(conv(x)))``."""
    x = _lrelu(_conv(prep[f"{prefix}.in"], x))
    for j in range(blocks):
        x = x + _conv(prep[f"{prefix}.rb{j}.c2"], torch.relu(_conv(prep[f"{prefix}.rb{j}.c1"], x)))
    return x


def spynet(prep, ref: torch.Tensor, supp: torch.Tensor, config: BasicVsrConfig) -> torch.Tensor:
    """Flow (N, 2, H, W) float32 that warps ``supp`` onto ``ref`` (both
    (N, 3, H, W) float32 in [0, 1]), as in the module docstring."""
    n, _, h, w = ref.shape
    hu, wu = -(-h // 32) * 32, -(-w // 32) * 32
    img = torch.cat([ref, supp])
    if (hu, wu) != (h, w):
        img = F.interpolate(img, size=(hu, wu), mode="bilinear", align_corners=False)
    pyramid = [(img - prep["mean"]) / prep["std"]]
    for _ in range(config.spynet_levels - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, 2))
    flow = None
    for lvl, level in enumerate(reversed(pyramid)):
        if flow is None:
            flow = level.new_zeros(n, 2, level.shape[2], level.shape[3])
        else:
            flow = F.interpolate(flow, scale_factor=2, mode="bilinear", align_corners=True) * 2.0
        x = torch.cat([level[:n], flow_warp(level[n:], flow, "border", prep), flow], 1)
        x = x.to(config.compute_dtype).permute(0, 2, 3, 1)
        last = len(SPYNET_WIDTHS) - 2
        for k in range(last + 1):
            x = _conv(prep[f"spynet.l{lvl}.c{k}"], x)
            if k < last:
                x = torch.relu(x)
        flow = flow + x.permute(0, 3, 1, 2).float()
    if (hu, wu) != (h, w):
        flow = F.interpolate(flow, size=(h, w), mode="bilinear", align_corners=False)
        flow[:, 0] *= w / wu
        flow[:, 1] *= h / hu
    return flow


def _align(prep, name: str, config: BasicVsrConfig, feat_cur, h1, h2, f1, f2, tag, marks,
           stats) -> torch.Tensor:
    """One step's second-order deformable alignment of ``h1`` (previous
    step) and ``h2`` (the one before, zero at the second step; then ``f2``
    is None) onto the current frame: the warps, the offset stack and its
    float32 epilogue, the deformable conv."""
    cd, g = config.compute_dtype, config.deform_groups
    _, h, w, _ = feat_cur.shape

    def nhwc(t):
        return t.permute(0, 2, 3, 1).to(cd)

    cond1 = flow_warp(h1.permute(0, 3, 1, 2).float(), f1, "zeros", prep)
    if f2 is None:
        f2 = torch.zeros_like(f1)
        cond2 = torch.zeros_like(cond1)
    else:
        cond2 = flow_warp(h2.permute(0, 3, 1, 2).float(), f2, "zeros", prep)
    x = torch.cat([nhwc(cond1), feat_cur, nhwc(cond2), nhwc(f1), nhwc(f2)], -1)
    marks.end(SPAN_WARP, **tag)
    for k in range(3):
        x = _lrelu(_conv(prep[f"{name}.offset{k}"], x))
    o = _conv(prep[f"{name}.offset3"], x).float()                      # (1, H, W, 27·g)
    n_off = 18 * g
    offset = config.max_residue_magnitude * torch.tanh(o[..., :n_off])
    # Groups 0..g/2-1 follow f1, the rest f2: each (y, x) pair plus the flip of its flow.
    flows = torch.stack([f1.flip(1), f2.flip(1)], 1).permute(0, 3, 4, 1, 2).unsqueeze(4)
    offset = (offset.reshape(1, h, w, 2, 9 * g // 2, 2) + flows).reshape(1, h, w, n_off)
    mask = torch.sigmoid(o[..., n_off:])
    marks.end(SPAN_OFFSET, **tag)
    aligned = deform_conv(torch.cat([h1, h2], -1), offset, mask, prep[f"{name}.dcn"]["w"],
                          prep[f"{name}.dcn"]["b"], g, prep)
    marks.end(SPAN_DCN, **tag)
    if stats is not None:
        stats.dcn_calls += 1
    return aligned


def _propagate(prep, feats: Dict[str, List[torch.Tensor]], flows: torch.Tensor, name: str,
               config: BasicVsrConfig, marks, stats) -> List[torch.Tensor]:
    """One pass over the clip; its features, in frame order. ``flows``
    (T − 1, 2, H, W): ``flows[j]`` brings frame j + 1 onto frame j
    (backward) or frame j onto frame j + 1 (forward)."""
    spatial = feats["spatial"]
    t = len(spatial)
    backward = name.startswith("backward")
    order = range(t - 1, -1, -1) if backward else range(t)
    earlier = [k for k in PASSES if k in feats]
    tag = {"pass": name}

    def flow_at(i):      # the flow from step i − 1's frame onto step i's
        j = t - 1 - i if backward else i - 1
        return flows[j:j + 1]

    out: List[torch.Tensor] = []
    zero = torch.zeros_like(spatial[0])
    for i, idx in enumerate(order):
        if i == 0:
            aligned = zero
        else:
            f1 = flow_at(i)
            f2 = None
            if i > 1:
                f2 = f1 + flow_warp(flow_at(i - 1), f1, "zeros", prep)
            aligned = _align(prep, name, config, spatial[idx], out[-1],
                             out[-2] if i > 1 else zero, f1, f2, tag, marks, stats)
        x = torch.cat([spatial[idx]] + [feats[k][idx] for k in earlier] + [aligned], -1)
        out.append(aligned + _res_blocks(prep, f"{name}.backbone", config.num_blocks, x))
        marks.end(SPAN_BACKBONE, **tag)
        if stats is not None:
            stats.propagation_steps += 1
    return out[::-1] if backward else out


def apply_prepared(prep: Dict[str, Any], clip: torch.Tensor, config: BasicVsrConfig,
                   stats: Optional[VsrStats] = None, marks=None) -> torch.Tensor:
    """(T, H, W, 3) float in [0, 1], one clip's consecutive frames → (T,
    4H, 4W, 3) float32 in [0, 1], on :func:`prepare_basicvsrpp`'s weights;
    ``marks`` (``layers.marks_for``) records the spans."""
    marks = marks or NoMarks()
    cd = config.compute_dtype
    t, h, w, _ = clip.shape
    if t < 2 or h < 64 or w < 64:
        raise ValueError(f"BasicVSR++ takes a clip of at least 2 frames of at least 64x64, "
                         f"got {tuple(clip.shape)}")
    x = clip.float().permute(0, 3, 1, 2)                                 # (T, 3, H, W)
    pair = spynet(prep, torch.cat([x[:-1], x[1:]]), torch.cat([x[1:], x[:-1]]), config)
    flows = {"backward": pair[:t - 1], "forward": pair[t - 1:]}
    marks.end(SPAN_FLOW)
    spatial = _res_blocks(prep, "extract", config.extract_blocks, clip.to(cd))
    feats: Dict[str, List[torch.Tensor]] = {"spatial": list(spatial.split(1))}
    marks.end(SPAN_EXTRACT)
    for name in PASSES:
        feats[name] = _propagate(prep, feats, flows[name.split("_")[0]], name, config,
                                 marks, stats)
    hr = torch.cat([torch.cat(feats[k]) for k in ("spatial",) + PASSES], -1)
    hr = _res_blocks(prep, "recon", config.recon_blocks, hr)
    hr = _lrelu(pixel_shuffle(_conv(prep["up1"], hr), 2))
    hr = _lrelu(pixel_shuffle(_conv(prep["up2"], hr), 2))
    hr = _conv(prep["conv_last"], _lrelu(_conv(prep["conv_hr"], hr)))
    s = config.upscale
    base = F.interpolate(x, size=(h * s, w * s), mode="bilinear", align_corners=False)
    y = torch.clamp(hr.float() + base.permute(0, 2, 3, 1), 0.0, 1.0)
    marks.end(SPAN_UPSAMPLE)
    return y


def apply_basicvsrpp(params: Params, clip: torch.Tensor,
                     config: BasicVsrConfig = BasicVsrConfig()) -> torch.Tensor:
    """(T, H, W, 3) in [0, 1] → (T, 4H, 4W, 3) float32 in [0, 1], from
    :func:`init_basicvsrpp`'s param tree (prepared on the clip's device at
    each call)."""
    with torch.no_grad():
        return apply_prepared(prepare_basicvsrpp(params, config, clip.device), clip, config)
