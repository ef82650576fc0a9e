"""BasicVSR++ ×4 in plain float32 PyTorch: the reference of ``basicvsrpp_x4``.

Written from the paper (Chan, Zhou, Xu, Loy, "BasicVSR++: Improving Video
Super-Resolution with Enhanced Propagation and Alignment", CVPR 2022,
arXiv:2104.13371) and the published network (OpenMMLab mmediting,
``BasicVSRPlusPlus`` in ``basicvsr_pp.py``, with its ``SPyNet``,
``SecondOrderDeformableAlignment``, ``ResidualBlocksWithInputConv`` and
``PixelShufflePack``; configuration ``basicvsr_plusplus_c64n7_8x1_600k_
reds4``), module by module in NCHW: ``flow_warp`` by ``F.grid_sample``
on float32 grids, the propagation's feature dict and its frame and flow
indices, mmcv's modulated deformable conv as its definition (each tap's
float32 bilinear samples of each deformable group, times the mask, by the
tap's weights, summed over the taps), the reconstruction frame by frame.
Weights are the benchmark's own (:func:`make_params`), in PyTorch's
layouts, one ``{"w", "b"}`` per conv.

Departures from the published code:
- the whole clip is one sequence: no CPU cache of features, and no check
  for a mirror-extended clip (a stream's clip is never mirrored), so the
  forward flows are always computed;
- the output is not clamped;
- the published init zeroes the offset stack's last conv; the weights
  here are drawn, three convs' scaled and two centred (:func:`make_params`);
- ``prec`` (:class:`VsrPrecision`) says where the reference rounds:
  ``F32`` nowhere; ``FP8``, the control, gives every conv and every
  deformable-conv product float8 e4m3 operands (per-tensor scale).

The caller sets ``no_tf32`` (``portbench.reference``) around it on a card.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference import _q8, fp8_conv2d

Params = Dict[str, Dict[str, torch.Tensor]]
MODULES = ["backward_1", "forward_1", "backward_2", "forward_2"]
DEFORM_GROUPS = 16           # hard-wired in BasicVSRPlusPlus
EXTRACT_BLOCKS = 5           # feat_extract: ResidualBlocksWithInputConv(3, c, 5)
RECON_BLOCKS = 5             # reconstruction: ResidualBlocksWithInputConv(5c, c, 5)


class VsrPrecision:
    def __init__(self, conv2d=F.conv2d, product=lambda w, x: (w, x)):
        self.conv2d, self.product = conv2d, product


F32 = VsrPrecision()
FP8 = VsrPrecision(conv2d=fp8_conv2d, product=lambda w, x: (_q8(w), _q8(x)))


# ---------------------------------------------------------------------------
# Weights from the seed
# ---------------------------------------------------------------------------


def leaf_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every conv: ``{name: (cout, cin, k, init)}``, init ``conv``
    (PyTorch's default: weight and bias uniform ±1/sqrt(fan_in)),
    ``kaiming`` (a PixelShufflePack's conv, ``default_init_weights(self,
    1)``: Kaiming normal, fan_in, ReLU gain, zero bias), ``res`` (a
    ResidualBlockNoBN conv: the same times 0.1), and ``spynet_last``,
    ``offset_last`` and ``conv_last`` (the default, which
    :func:`make_params` may scale)."""
    c = cfg["mid_channels"]
    out: Dict[str, tuple] = {}

    def res_blocks(prefix, cin, n):
        out[f"{prefix}.in"] = (c, cin, 3, "conv")
        for j in range(n):
            out[f"{prefix}.rb{j}.c1"] = (c, c, 3, "res")
            out[f"{prefix}.rb{j}.c2"] = (c, c, 3, "res")

    widths = [8, 32, 64, 32, 16, 2]
    for level in range(6):
        for k in range(5):
            out[f"spynet.l{level}.c{k}"] = (widths[k + 1], widths[k], 7,
                                            "spynet_last" if k == 4 else "conv")
    res_blocks("extract", 3, EXTRACT_BLOCKS)
    for i, module in enumerate(MODULES):
        out[f"{module}.offset0"] = (c, 3 * c + 4, 3, "conv")
        out[f"{module}.offset1"] = (c, c, 3, "conv")
        out[f"{module}.offset2"] = (c, c, 3, "conv")
        out[f"{module}.offset3"] = (27 * DEFORM_GROUPS, c, 3, "offset_last")
        out[f"{module}.dcn"] = (c, 2 * c, 3, "conv")
        res_blocks(f"{module}.backbone", (2 + i) * c, cfg["num_blocks"])
    res_blocks("recon", 5 * c, RECON_BLOCKS)
    out["up1"] = (4 * c, c, 3, "kaiming")
    out["up2"] = (4 * 64, c, 3, "kaiming")
    out["conv_hr"] = (64, 64, 3, "conv")
    out["conv_last"] = (3, 64, 3, "conv_last")
    return out


# Convs whose weight is centred per output channel (zero sum over inputs
# and taps), so a flat feature map adds no colour cast to the residual: with
# drawn weights the LeakyReLU features' positive mean reached the output as
# a shift of tens of levels on some seeds, and the reference then clipped up
# to 5 % of its outputs, where a trained net's residual carries detail.
CENTRED = ("conv_hr", "conv_last")


def make_params(cfg: dict, seed: int, device, gains=None) -> Params:
    """Float32 weights on ``device`` from one seeded generator: one flat
    uniform and one flat normal buffer, cut conv by conv; the weight of
    each conv whose init ``gains`` names (``spynet_last``, ``offset_last``,
    ``conv_last``) times its gain; the weights of :data:`CENTRED` less
    their mean over each output channel."""
    shapes = leaf_shapes(cfg)
    gains = {"conv": 1.0, "spynet_last": 1.0, "offset_last": 1.0, "conv_last": 1.0,
             **(gains or {})}
    normal = ("res", "kaiming")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_uni = sum(co * ci * k * k + co for co, ci, k, init in shapes.values()
                if init not in normal)
    n_nrm = sum(co * ci * k * k for co, ci, k, init in shapes.values() if init in normal)
    uni = torch.rand(n_uni, generator=gen, device=device) * 2 - 1
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    at = {"uni": 0, "nrm": 0}

    def cut(which, n):
        buf = uni if which == "uni" else nrm
        t = buf[at[which]:at[which] + n]
        at[which] += n
        return t

    params: Params = {}
    for name, (co, ci, k, init) in shapes.items():
        fan_in = ci * k * k
        n = co * fan_in
        if init in normal:
            gain = 0.1 if init == "res" else 1.0
            w = cut("nrm", n).view(co, ci, k, k) * (gain * math.sqrt(2.0 / fan_in))
            b = torch.zeros(co, device=device)
        else:
            w = cut("uni", n).view(co, ci, k, k) * (gains[init] / math.sqrt(fan_in))
            b = cut("uni", co) / math.sqrt(fan_in)
        if name in CENTRED:
            w = w - w.mean(dim=(1, 2, 3), keepdim=True)
        params[name] = {"w": w, "b": b}
    return params


# ---------------------------------------------------------------------------
# The network (basicvsr_pp.py, module by module)
# ---------------------------------------------------------------------------


def flow_warp(x, flow, padding_mode="zeros"):
    """mmediting's ``flow_warp``: ``flow`` (n, h, w, 2), x then y."""
    _, _, h, w = x.size()
    grid_y, grid_x = torch.meshgrid(torch.arange(0, h, device=x.device),
                                    torch.arange(0, w, device=x.device), indexing="ij")
    grid = torch.stack((grid_x, grid_y), 2).float()
    grid_flow = grid + flow
    grid_flow_x = 2.0 * grid_flow[:, :, :, 0] / max(w - 1, 1) - 1.0
    grid_flow_y = 2.0 * grid_flow[:, :, :, 1] / max(h - 1, 1) - 1.0
    grid_flow = torch.stack((grid_flow_x, grid_flow_y), dim=3)
    return F.grid_sample(x, grid_flow, mode="bilinear", padding_mode=padding_mode,
                         align_corners=True)


def conv(p, name, x, prec, padding=1):
    return prec.conv2d(x, p[name]["w"], p[name]["b"], padding=padding)


def residual_blocks(p, prefix, x, n, prec):
    """ResidualBlocksWithInputConv: conv, LeakyReLU(0.1), ``n``
    ResidualBlockNoBN (``x + conv2(relu(conv1(x)))``)."""
    x = F.leaky_relu(conv(p, f"{prefix}.in", x, prec), 0.1)
    for j in range(n):
        x = x + conv(p, f"{prefix}.rb{j}.c2", F.relu(conv(p, f"{prefix}.rb{j}.c1", x, prec)),
                     prec)
    return x


def spynet_basic(p, level, x, prec):
    for k in range(5):
        x = conv(p, f"spynet.l{level}.c{k}", x, prec, padding=3)
        if k < 4:
            x = F.relu(x)
    return x


def spynet_compute_flow(p, ref, supp, prec):
    n, _, h, w = ref.size()
    mean = torch.tensor([0.485, 0.456, 0.406], device=ref.device).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=ref.device).view(1, 3, 1, 1)
    ref = [(ref - mean) / std]
    supp = [(supp - mean) / std]
    for _ in range(5):
        ref.append(F.avg_pool2d(ref[-1], kernel_size=2, stride=2, count_include_pad=False))
        supp.append(F.avg_pool2d(supp[-1], kernel_size=2, stride=2, count_include_pad=False))
    ref, supp = ref[::-1], supp[::-1]
    flow = ref[0].new_zeros(n, 2, h // 32, w // 32)
    for level in range(len(ref)):
        if level == 0:
            flow_up = flow
        else:
            flow_up = F.interpolate(flow, scale_factor=2, mode="bilinear",
                                    align_corners=True) * 2.0
        flow = flow_up + spynet_basic(p, level, torch.cat(
            [ref[level], flow_warp(supp[level], flow_up.permute(0, 2, 3, 1), "border"),
             flow_up], 1), prec)
    return flow


def spynet(p, ref, supp, prec):
    h, w = ref.shape[2:4]
    w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
    h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
    ref = F.interpolate(ref, size=(h_up, w_up), mode="bilinear", align_corners=False)
    supp = F.interpolate(supp, size=(h_up, w_up), mode="bilinear", align_corners=False)
    flow = F.interpolate(spynet_compute_flow(p, ref, supp, prec), size=(h, w),
                         mode="bilinear", align_corners=False)
    flow[:, 0, :, :] *= float(w) / float(w_up)
    flow[:, 1, :, :] *= float(h) / float(h_up)
    return flow


def modulated_deform_conv(x, offset, mask, weight, bias, groups, prec):
    """mmcv's ``modulated_deform_conv2d`` (stride 1, padding 1, dilation 1,
    one conv group) by its definition: offset channel ``2·(g·9 + k)`` is
    tap k's dy in deformable group g, ``+ 1`` its dx; mask channel
    ``g·9 + k``; a tap samples at ``(y + k // 3 − 1 + dy, x + k % 3 − 1 +
    dx)``, bilinear, zero outside the frame."""
    n, cin, h, w = x.shape
    cg = cin // groups
    out = bias.view(1, -1, 1, 1).expand(n, -1, h, w).clone()
    xg = x.reshape(n * groups, cg, h, w)
    for k in range(9):
        ky, kx = k // 3 - 1, k % 3 - 1
        dy = offset[:, 0::2].reshape(n, groups, 9, h, w)[:, :, k]
        dx = offset[:, 1::2].reshape(n, groups, 9, h, w)[:, :, k]
        flow = torch.stack((dx + kx, dy + ky), dim=-1).reshape(n * groups, h, w, 2)
        sampled = flow_warp(xg, flow, "zeros").view(n, groups, cg, h, w)
        sampled = sampled * mask.view(n, groups, 9, h, w)[:, :, k].unsqueeze(2)
        wk, sk = prec.product(weight[:, :, k // 3, k % 3], sampled.reshape(n, cin, h, w))
        out = out + torch.einsum("oc,nchw->nohw", wk, sk)
    return out


def deform_align(p, module, x, extra_feat, flow_1, flow_2, cfg, prec):
    """SecondOrderDeformableAlignment.forward."""
    extra_feat = torch.cat([extra_feat, flow_1, flow_2], dim=1)
    out = extra_feat
    for k in range(3):
        out = F.leaky_relu(conv(p, f"{module}.offset{k}", out, prec), 0.1)
    out = conv(p, f"{module}.offset3", out, prec)
    o1, o2, mask = torch.chunk(out, 3, dim=1)
    offset = cfg["max_residue_magnitude"] * torch.tanh(torch.cat((o1, o2), dim=1))
    offset_1, offset_2 = torch.chunk(offset, 2, dim=1)
    offset_1 = offset_1 + flow_1.flip(1).repeat(1, offset_1.size(1) // 2, 1, 1)
    offset_2 = offset_2 + flow_2.flip(1).repeat(1, offset_2.size(1) // 2, 1, 1)
    offset = torch.cat([offset_1, offset_2], dim=1)
    mask = torch.sigmoid(mask)
    return modulated_deform_conv(x, offset, mask, p[f"{module}.dcn"]["w"],
                                 p[f"{module}.dcn"]["b"], DEFORM_GROUPS, prec)


def propagate(p, feats, flows, module_name, cfg, prec):
    n, t, _, h, w = flows.size()
    frame_idx = range(0, t + 1)
    flow_idx = range(-1, t)
    mapping_idx = list(range(0, len(feats["spatial"])))
    mapping_idx += mapping_idx[::-1]
    if "backward" in module_name:
        frame_idx = frame_idx[::-1]
        flow_idx = frame_idx
    feat_prop = flows.new_zeros(n, cfg["mid_channels"], h, w)
    for i, idx in enumerate(frame_idx):
        feat_current = feats["spatial"][mapping_idx[idx]]
        if i > 0:
            flow_n1 = flows[:, flow_idx[i], :, :, :]
            cond_n1 = flow_warp(feat_prop, flow_n1.permute(0, 2, 3, 1))
            feat_n2 = torch.zeros_like(feat_prop)
            flow_n2 = torch.zeros_like(flow_n1)
            cond_n2 = torch.zeros_like(cond_n1)
            if i > 1:
                feat_n2 = feats[module_name][-2]
                flow_n2 = flows[:, flow_idx[i - 1], :, :, :]
                flow_n2 = flow_n1 + flow_warp(flow_n2, flow_n1.permute(0, 2, 3, 1))
                cond_n2 = flow_warp(feat_n2, flow_n2.permute(0, 2, 3, 1))
            cond = torch.cat([cond_n1, feat_current, cond_n2], dim=1)
            feat_prop = torch.cat([feat_prop, feat_n2], dim=1)
            feat_prop = deform_align(p, module_name, feat_prop, cond, flow_n1, flow_n2, cfg, prec)
        feat = [feat_current] + [feats[k][idx] for k in feats
                                 if k not in ["spatial", module_name]] + [feat_prop]
        feat = torch.cat(feat, dim=1)
        feat_prop = feat_prop + residual_blocks(p, f"{module_name}.backbone", feat,
                                                cfg["num_blocks"], prec)
        feats[module_name].append(feat_prop)
    if "backward" in module_name:
        feats[module_name] = feats[module_name][::-1]
    return feats


def upsample(p, lqs, feats, prec, frames: List[int]):
    outputs = {}
    for i in frames:
        hr = [feats["spatial"][i]] + [feats[k][i] for k in MODULES]
        hr = torch.cat(hr, dim=1)
        hr = residual_blocks(p, "recon", hr, RECON_BLOCKS, prec)
        hr = F.leaky_relu(F.pixel_shuffle(conv(p, "up1", hr, prec), 2), 0.1)
        hr = F.leaky_relu(F.pixel_shuffle(conv(p, "up2", hr, prec), 2), 0.1)
        hr = F.leaky_relu(conv(p, "conv_hr", hr, prec), 0.1)
        hr = conv(p, "conv_last", hr, prec)
        hr = hr + F.interpolate(lqs[:, i], scale_factor=4, mode="bilinear", align_corners=False)
        outputs[i] = hr
    return outputs


def forward(params: Params, clip: torch.Tensor, cfg: dict, prec: VsrPrecision = F32,
            frames=None) -> torch.Tensor:
    """A clip, float NHWC (T, H, W, 3) in [0, 1], T ≥ 2, → float NHWC (T,
    4H, 4W, 3), unclamped; ``frames`` (default all) picks the outputs
    reconstructed, in that order."""
    p = params
    lqs = clip.permute(0, 3, 1, 2).float().unsqueeze(0)       # n = 1, t, c, h, w
    n, t, c, h, w = lqs.size()
    feats = {}
    feats_ = residual_blocks(p, "extract", lqs.view(-1, c, h, w), EXTRACT_BLOCKS, prec)
    feats_ = feats_.view(n, t, -1, h, w)
    feats["spatial"] = [feats_[:, i, :, :, :] for i in range(0, t)]
    lqs_1 = lqs[:, :-1, :, :, :].reshape(-1, c, h, w)
    lqs_2 = lqs[:, 1:, :, :, :].reshape(-1, c, h, w)
    flows_backward = spynet(p, lqs_1, lqs_2, prec).view(n, t - 1, 2, h, w)
    flows_forward = spynet(p, lqs_2, lqs_1, prec).view(n, t - 1, 2, h, w)
    for iter_ in [1, 2]:
        for direction in ["backward", "forward"]:
            module = f"{direction}_{iter_}"
            feats[module] = []
            flows = flows_backward if direction == "backward" else flows_forward
            feats = propagate(p, feats, flows, module, cfg, prec)
    frames = list(range(t)) if frames is None else list(frames)
    out = upsample(p, lqs, feats, prec, frames)
    return torch.cat([out[i] for i in frames]).permute(0, 2, 3, 1)
