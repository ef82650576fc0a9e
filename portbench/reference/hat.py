"""HAT-SRx4 in plain float32 PyTorch: the reference of ``hat_srx4``.

Written from the paper (Chen et al., "Activating More Pixels in Image
Super-Resolution Transformer", CVPR 2023, arXiv:2205.04437) and the
published network (github.com/XPixelGroup/HAT, ``hat/archs/hat_arch.py``,
``options/test/HAT_SRx4.yml``), module by module: tokens ``(b, h·w, c)``,
``window_partition`` / ``window_reverse``, ``torch.roll`` and the region
mask for the shifted windows, the relative position index of each
attention, explicit ``softmax(q·kᵀ·scale + bias [+ mask]) @ v``, ``F.unfold``
for the overlapping windows, ``F.pixel_shuffle``. Weights are the
benchmark's own (:func:`make_params`), in PyTorch's layouts.

Departures from the published code:
- the reflect padding to a multiple of the window and the crop back (the
  published test wrapper's ``pre_process`` / ``post_process``) are part of
  :func:`forward`, and the output is not clamped;
- attention runs over blocks of ``block`` windows at a time, so that the
  float32 scores fit on a card (the same arithmetic per window);
- the relative position index of the overlapping attention keeps the
  published offset, whose negative indices wrap into the table as
  PyTorch indexing wraps them;
- ``prec`` (:class:`HatPrecision`) says where the reference rounds:
  ``F32`` nowhere; ``FP8``, the control, gives every conv, linear and
  attention product float8 e4m3 operands (per-tensor scale).

The caller sets ``no_tf32`` (``portbench.reference``) around it on a card.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import _q8, fp8_conv2d

Params = Dict[str, Dict[str, torch.Tensor]]


class HatPrecision:
    def __init__(self, conv2d=F.conv2d, linear=F.linear, matmul=torch.matmul):
        self.conv2d, self.linear, self.matmul = conv2d, linear, matmul


F32 = HatPrecision()
FP8 = HatPrecision(conv2d=fp8_conv2d,
                   linear=lambda x, w, b=None: F.linear(_q8(x), _q8(w), b),
                   matmul=lambda a, b: torch.matmul(_q8(a), _q8(b)))


# ---------------------------------------------------------------------------
# Weights from the seed
# ---------------------------------------------------------------------------


def leaf_shapes(cfg: dict) -> Dict[str, Dict[str, Tuple[Tuple[int, ...], str]]]:
    """Every layer's leaves: ``{layer: {leaf: (shape, init)}}``, init one
    of ``conv`` (PyTorch's default conv weight, uniform ±1/sqrt(fan_in)),
    ``cab_conv`` (the same for the two 3×3 convs of a CAB, which
    :func:`make_params` may scale), ``conv_bias`` (uniform
    ±1/sqrt(fan_in)), ``trunc02`` (truncated normal, std 0.02: Linear
    weights and bias tables), ``zeros`` or ``ones``."""
    c, ws = cfg["embed_dim"], cfg["window_size"]
    wse = int(ws * cfg["overlap_ratio"]) + ws
    hid = int(c * cfg["mlp_ratio"])
    nf, cin = cfg["num_feat"], cfg["in_chans"]

    def conv(cout, ci, k, kind="conv"):
        return {"w": ((cout, ci, k, k), kind), "b": ((cout,), "conv_bias")}

    def lin(prefix, cout, ci):
        return {f"{prefix}.w": ((cout, ci), "trunc02"), f"{prefix}.b": ((cout,), "zeros")}

    def norm(prefix):
        dot = prefix + "." if prefix else ""
        return {f"{dot}w": ((c,), "ones"), f"{dot}b": ((c,), "zeros")}

    def sub(prefix, leaves):
        return {f"{prefix}.{k}": v for k, v in leaves.items()}

    out = {"conv_first": conv(c, cin, 3), "patch_norm": norm("")}
    for g, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            out[f"g{g}.hab{j}"] = {
                **norm("norm1"), **lin("qkv", 3 * c, c),
                "rpb": (((2 * ws - 1) ** 2, heads), "trunc02"), **lin("proj", c, c),
                **sub("cab1", conv(c // cfg["compress_ratio"], c, 3, "cab_conv")),
                **sub("cab2", conv(c, c // cfg["compress_ratio"], 3, "cab_conv")),
                **sub("ca1", conv(c // cfg["squeeze_factor"], c, 1)),
                **sub("ca2", conv(c, c // cfg["squeeze_factor"], 1)),
                **norm("norm2"), **lin("fc1", hid, c), **lin("fc2", c, hid)}
        out[f"g{g}.ocab"] = {
            **norm("norm1"), **lin("qkv", 3 * c, c),
            "rpb": (((ws + wse - 1) ** 2, heads), "trunc02"), **lin("proj", c, c),
            **norm("norm2"), **lin("fc1", hid, c), **lin("fc2", c, hid)}
        out[f"g{g}.conv"] = conv(c, c, 3)
    out["norm"] = norm("")
    out["conv_after_body"] = conv(c, c, 3)
    out["conv_before_upsample"] = conv(nf, c, 3)
    for i in range(int(math.log2(cfg["upscale"]))):
        out[f"up{i}"] = conv(4 * nf, nf, 3)
    out["conv_last"] = conv(cin, nf, 3)
    return out


def make_params(cfg: dict, seed: int, device, cab_conv_gain: float = 1.0) -> Params:
    """Float32 weights on ``device`` from one seeded generator, drawn as
    the published ``_init_weights`` draws them (:func:`leaf_shapes`), the
    CAB convs' weights times ``cab_conv_gain``: one flat uniform and one
    flat normal buffer, cut leaf by leaf."""
    shapes = leaf_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {kind: sum(math.prod(s) for leaves in shapes.values()
                       for s, k in leaves.values() if k == kind)
             for kind in ("conv", "cab_conv", "conv_bias", "trunc02")}
    n_uni = sizes["conv"] + sizes["cab_conv"] + sizes["conv_bias"]
    uni = torch.rand(n_uni, generator=gen, device=device) * 2 - 1
    nrm = torch.randn(sizes["trunc02"], generator=gen, device=device).clamp_(-100.0, 100.0)
    at = {"uni": 0, "nrm": 0}

    def cut(buf, n):
        t = (uni if buf == "uni" else nrm)[at[buf]:at[buf] + n]
        at[buf] += n
        return t

    params: Params = {}
    for layer, leaves in shapes.items():
        params[layer] = {}
        for leaf, (shape, kind) in leaves.items():
            n = math.prod(shape)
            if kind in ("conv", "cab_conv"):
                gain = cab_conv_gain if kind == "cab_conv" else 1.0
                t = cut("uni", n).view(shape) * (gain / math.sqrt(math.prod(shape[1:])))
            elif kind == "conv_bias":
                w_shape = leaves[leaf[:-1] + "w"][0]
                t = cut("uni", n).view(shape) / math.sqrt(math.prod(w_shape[1:]))
            elif kind == "trunc02":
                # timm's trunc_normal_(std=.02) cuts at ±2 absolute: ±100 std.
                t = cut("nrm", n).view(shape) * 0.02
            elif kind == "zeros":
                t = torch.zeros(shape, device=device)
            else:
                t = torch.ones(shape, device=device)
            params[layer][leaf] = t
    return params


# ---------------------------------------------------------------------------
# The network (hat_arch.py, module by module)
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index_sa(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def relative_position_index_oca(ws: int, wse: int) -> torch.Tensor:
    ori = torch.flatten(torch.stack(torch.meshgrid(
        [torch.arange(ws), torch.arange(ws)], indexing="ij")), 1)
    ext = torch.flatten(torch.stack(torch.meshgrid(
        [torch.arange(wse), torch.arange(wse)], indexing="ij")), 1)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - wse + 1
    rel[:, :, 1] += ws - wse + 1
    rel[:, :, 0] *= ws + wse - 1
    return rel.sum(-1)


def calculate_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def layer_norm(p, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[prefix + "w"], p[prefix + "b"], 1e-5)


def attention(q, k, v, bias, mask, prec: HatPrecision, block: int) -> torch.Tensor:
    """softmax(q·kᵀ + bias [+ mask]) @ v over (windows, heads, n, d), q
    already scaled, ``block`` windows at a time; ``mask`` (nw, n, m)
    repeats over the batch of windows."""
    out = q.new_empty(q.shape[:-1] + v.shape[-1:])
    for i in range(0, q.shape[0], block):
        a = prec.matmul(q[i:i + block], k[i:i + block].transpose(-2, -1)) + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            rows = torch.arange(i, min(i + block, q.shape[0]), device=q.device) % nw
            a = a + mask[rows].unsqueeze(1)
        out[i:i + block] = prec.matmul(torch.softmax(a, dim=-1), v[i:i + block])
    return out


def window_attention(p, x, rpi, mask, heads, ws, prec, block):
    b_, n, c = x.shape
    qkv = prec.linear(x, p["qkv.w"], p["qkv.b"]).reshape(b_, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q * (c // heads) ** -0.5
    bias = p["rpb"][rpi.view(-1)].view(ws * ws, ws * ws, -1).permute(2, 0, 1).contiguous()
    x = attention(q, k, v, bias, mask, prec, block).transpose(1, 2).reshape(b_, n, c)
    return prec.linear(x, p["proj.w"], p["proj.b"])


def cab(p, x, cfg, prec):
    """x NCHW: conv, GELU, conv, channel attention."""
    y = prec.conv2d(x, p["cab1.w"], p["cab1.b"], padding=1)
    y = prec.conv2d(F.gelu(y), p["cab2.w"], p["cab2.b"], padding=1)
    a = F.adaptive_avg_pool2d(y, 1)
    a = torch.relu(prec.conv2d(a, p["ca1.w"], p["ca1.b"]))
    a = torch.sigmoid(prec.conv2d(a, p["ca2.w"], p["ca2.b"]))
    return y * a


def mlp(p, x, prec):
    return prec.linear(F.gelu(prec.linear(x, p["fc1.w"], p["fc1.b"])), p["fc2.w"], p["fc2.b"])


def hab(p, x, x_size, rpi, attn_mask, shift, cfg, prec, block):
    h, w = x_size
    b, _, c = x.shape
    ws, heads = cfg["window_size"], p["rpb"].shape[1]
    shortcut = x
    x = layer_norm(p, "norm1.", x).view(b, h, w, c)
    conv_x = cab(p, x.permute(0, 3, 1, 2), cfg, prec)
    conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, h * w, c)
    if shift > 0:
        shifted_x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    else:
        shifted_x = x
        attn_mask = None
    x_windows = window_partition(shifted_x, ws).view(-1, ws * ws, c)
    attn_windows = window_attention(p, x_windows, rpi, attn_mask, heads, ws, prec, block)
    shifted_x = window_reverse(attn_windows.view(-1, ws, ws, c), ws, h, w)
    attn_x = torch.roll(shifted_x, shifts=(shift, shift), dims=(1, 2)) if shift > 0 else shifted_x
    x = shortcut + attn_x.view(b, h * w, c) + conv_x * cfg["conv_scale"]
    return x + mlp(p, layer_norm(p, "norm2.", x), prec)


def ocab(p, x, x_size, rpi, cfg, prec, block):
    h, w = x_size
    b, _, c = x.shape
    ws = cfg["window_size"]
    wse = int(ws * cfg["overlap_ratio"]) + ws
    heads = p["rpb"].shape[1]
    d = c // heads
    shortcut = x
    x = layer_norm(p, "norm1.", x).view(b, h, w, c)
    qkv = prec.linear(x, p["qkv.w"], p["qkv.b"]).reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
    q = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)
    q_windows = window_partition(q, ws).view(-1, ws * ws, c)
    kv_windows = F.unfold(kv, kernel_size=(wse, wse), stride=ws, padding=(wse - ws) // 2)
    nw = kv_windows.shape[-1]          # b, 2·c·wse·wse, nw → 2, b·nw, wse·wse, c
    kv_windows = kv_windows.view(b, 2, c, wse, wse, nw).permute(1, 0, 5, 3, 4, 2)
    kv_windows = kv_windows.reshape(2, b * nw, wse * wse, c)
    b_, nq, _ = q_windows.shape
    n = kv_windows.shape[2]
    q = q_windows.reshape(b_, nq, heads, d).permute(0, 2, 1, 3) * d ** -0.5
    k = kv_windows[0].reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    v = kv_windows[1].reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    bias = p["rpb"][rpi.view(-1)].view(ws * ws, wse * wse, -1).permute(2, 0, 1).contiguous()
    x = attention(q, k, v, bias, None, prec, block).transpose(1, 2).reshape(b_, nq, c)
    x = window_reverse(x.view(-1, ws, ws, c), ws, h, w).view(b, h * w, c)
    x = prec.linear(x, p["proj.w"], p["proj.b"]) + shortcut
    return x + mlp(p, layer_norm(p, "norm2.", x), prec)


def forward(params: Params, x: torch.Tensor, cfg: dict, prec: HatPrecision = F32,
            block: int = 64) -> torch.Tensor:
    """float NHWC in [0, 1] → float NHWC ×``upscale``, unclamped."""
    ws, scale, c = cfg["window_size"], cfg["upscale"], cfg["embed_dim"]
    wse = int(ws * cfg["overlap_ratio"]) + ws
    x = x.permute(0, 3, 1, 2).float()
    _, _, h0, w0 = x.shape
    pad_h, pad_w = (-h0) % ws, (-w0) % ws
    x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
    mean = torch.tensor(cfg["rgb_mean"], device=x.device).view(1, 3, 1, 1)
    x = (x - mean) * cfg["img_range"]
    p = params
    x = prec.conv2d(x, p["conv_first"]["w"], p["conv_first"]["b"], padding=1)
    b, _, h, w = x.shape
    attn_mask = calculate_mask(h, w, ws, ws // 2).to(x.device)
    rpi_sa = relative_position_index_sa(ws).to(x.device)
    rpi_oca = relative_position_index_oca(ws, wse).to(x.device)
    feat = layer_norm(p["patch_norm"], "", x.flatten(2).transpose(1, 2))
    for g, depth in enumerate(cfg["depths"]):
        res = feat
        for j in range(depth):
            res = hab(p[f"g{g}.hab{j}"], res, (h, w), rpi_sa, attn_mask,
                      0 if j % 2 == 0 else ws // 2, cfg, prec, block)
        res = ocab(p[f"g{g}.ocab"], res, (h, w), rpi_oca, cfg, prec, block)
        res = res.transpose(1, 2).view(b, c, h, w)
        res = prec.conv2d(res, p[f"g{g}.conv"]["w"], p[f"g{g}.conv"]["b"], padding=1)
        feat = res.flatten(2).transpose(1, 2) + feat
    feat = layer_norm(p["norm"], "", feat).transpose(1, 2).view(b, c, h, w)
    x = prec.conv2d(feat, p["conv_after_body"]["w"], p["conv_after_body"]["b"], padding=1) + x
    x = F.leaky_relu(prec.conv2d(x, p["conv_before_upsample"]["w"],
                                 p["conv_before_upsample"]["b"], padding=1), 0.01)
    for i in range(int(math.log2(scale))):
        x = F.pixel_shuffle(prec.conv2d(x, p[f"up{i}"]["w"], p[f"up{i}"]["b"], padding=1), 2)
    x = prec.conv2d(x, p["conv_last"]["w"], p["conv_last"]["b"], padding=1)
    x = x / cfg["img_range"] + mean
    return x[:, :, :h0 * scale, :w0 * scale].permute(0, 2, 3, 1)
