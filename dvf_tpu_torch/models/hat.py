"""HAT, the Hybrid Attention Transformer for image super-resolution.

Chen, Wang, Zhou, Qiao and Dong, "Activating More Pixels in Image
Super-Resolution Transformer" (CVPR 2023, arXiv:2205.04437), network
``hat/archs/hat_arch.py`` of github.com/XPixelGroup/HAT, configuration
``options/test/HAT_SRx4.yml`` (the defaults of :class:`HatConfig`).

The forward, NHWC frames in [0, 1] → ×4 NHWC frames:

- head: subtract the RGB mean, reflect-pad bottom and right to a multiple
  of the window (the published test wrapper), ``conv_first`` (3×3) and the
  patch embedding's LayerNorm;
- ``len(depths)`` residual hybrid attention groups (RHAG), each
  ``depths[i]`` hybrid attention blocks (HAB), one overlapping
  cross-attention block (OCAB), then a 3×3 conv, plus the group's input;
- HAB: ``x + WMSA(LN(x)) + conv_scale·CAB(LN(x))``, then ``+ MLP(LN(·))``.
  WMSA is self-attention in ``window_size``² windows with a relative
  position bias, the windows of every odd block shifted by half a window
  under the region mask (−100); CAB is conv, GELU, conv and channel
  attention (average pool, 1×1 conv, ReLU, 1×1 conv, sigmoid, scale);
- OCAB: queries from the windows, keys and values from overlapping
  windows ``(1 + overlap_ratio)·window_size`` wide around them (the
  published ``nn.Unfold`` of the projected k and v, zero padded), its own
  bias table, then proj, residual and the MLP;
- tail: LayerNorm, ``conv_after_body`` plus the shallow features,
  ``conv_before_upsample`` and LeakyReLU, log2(scale) stages of a 3×3 conv
  to 4× the channels and ``nn.PixelShuffle(2)`` (CRD order), ``conv_last``,
  the mean added back, the crop to the input's size ×4, and a clamp.

Params are float32 in PyTorch's layouts (Linear ``(out, in)``, conv OIHW),
one dict of leaves per layer (:func:`init_hat`). :func:`prepare_hat` turns
them into what a device runs: every weight in the compute dtype, convs
channels-last, each attention's bias table gathered into its dense
``(heads, queries, keys)`` bias, and q, k, v zero-padded from the head
size to a multiple of 8 (30 → 32) by zero rows in the qkv weight and zero
columns in proj, which changes nothing (the scale stays
``head_dim ** -0.5``) and lets the fused attention kernels take it.

Precision: LayerNorm statistics and the attention softmax are float32
(``F.layer_norm`` and ``F.scaled_dot_product_attention`` accumulate in
float32 for bfloat16 operands); everything else runs in
``compute_dtype``, the residual stream included; the output is float32.

Attention runs through ``F.scaled_dot_product_attention``. Windows are
gathered by one precomputed index per (batch, padded size), which also
carries the shift: unshifted blocks attend all windows under the bias
alone; shifted blocks attend the windows that meet no region edge under
the bias alone, and the last row and column of windows under the bias
plus the region mask (:class:`_Geometry`). On a card the fused backend
that accepts these shapes is found at the first call of a geometry
(``HatStats.sdpa_backend``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from dvf_tpu_torch.models.layers import NoMarks, Params, generator, pixel_shuffle

# Span names (``Tracer.device_span`` on a card, ``Tracer.complete`` on the
# CPU), each tagged with ``block`` and the filter's batch number ``seq``.
# Together they cover the whole forward.
SPAN_WINDOW_ATTN = "hat.window_attn"
SPAN_OCAB_ATTN = "hat.ocab_attn"
SPAN_CAB = "hat.cab"
SPAN_MLP = "hat.mlp"
SPAN_CONV = "hat.conv"
SPAN_UPSAMPLE = "hat.upsample"
SPANS = (SPAN_WINDOW_ATTN, SPAN_OCAB_ATTN, SPAN_CAB, SPAN_MLP, SPAN_CONV, SPAN_UPSAMPLE)


@dataclasses.dataclass(frozen=True)
class HatConfig:
    """HAT-SRx4 as published (``options/test/HAT_SRx4.yml``)."""
    upscale: int = 4
    in_chans: int = 3
    window_size: int = 16
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01
    overlap_ratio: float = 0.5
    img_range: float = 1.0
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    embed_dim: int = 180
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    mlp_ratio: float = 2.0
    num_feat: int = 64                       # the pixelshuffle upsampler's width
    rgb_mean: Tuple[float, float, float] = (0.4488, 0.4371, 0.4040)
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def overlap_win_size(self) -> int:
        return int(self.window_size * self.overlap_ratio) + self.window_size

    @property
    def up_stages(self) -> int:
        n = int(math.log2(self.upscale))
        if 2 ** n != self.upscale:
            raise ValueError(f"the pixelshuffle upsampler takes a power of 2, got {self.upscale}")
        return n


@dataclasses.dataclass
class HatStats:
    """Counters of a traced HAT filter (kept while its tracer is enabled):
    batches and frames stepped (the engine's compile calls included),
    windows a frame, the share of tokens that are padding, attention calls
    (one per ``scaled_dot_product_attention``) and the backend that ran."""
    batches: int = 0
    frames: int = 0
    windows_per_frame: int = 0
    padded_token_share: float = 0.0
    attention_calls: int = 0
    sdpa_backend: str = ""


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _conv_leaves(gen, cout: int, cin: int, k: int) -> Params:
    """PyTorch's default conv init: weight and bias uniform in
    ±1/sqrt(fan_in)."""
    bound = 1.0 / math.sqrt(cin * k * k)
    w = (torch.rand((cout, cin, k, k), generator=gen) * 2 - 1) * bound
    b = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
    return {"w": w, "b": b}


def _trunc02(gen, *shape) -> torch.Tensor:
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=0.02, generator=gen)


def _linear(gen, prefix: str, cout: int, cin: int) -> Params:
    return {f"{prefix}.w": _trunc02(gen, cout, cin), f"{prefix}.b": torch.zeros(cout)}


def _norm(prefix: str, c: int) -> Params:
    return {f"{prefix}.w": torch.ones(c), f"{prefix}.b": torch.zeros(c)}


def init_hat(rng: Union[int, torch.Generator], config: HatConfig = HatConfig()) -> Params:
    """Seeded float32 weights on the CPU, drawn as the published
    ``_init_weights`` draws them: Linears truncated normal (std 0.02) with
    zero bias, LayerNorms 1 and 0, bias tables truncated normal (std
    0.02), convs as PyTorch's default."""
    gen = generator(rng)
    c, ws, wse = config.embed_dim, config.window_size, config.overlap_win_size
    hid = int(c * config.mlp_ratio)
    p: Params = {"conv_first": _conv_leaves(gen, c, config.in_chans, 3),
                 "patch_norm": {"w": torch.ones(c), "b": torch.zeros(c)}}
    for g, (depth, heads) in enumerate(zip(config.depths, config.num_heads)):
        for j in range(depth):
            cab1 = _conv_leaves(gen, c // config.compress_ratio, c, 3)
            cab2 = _conv_leaves(gen, c, c // config.compress_ratio, 3)
            ca1 = _conv_leaves(gen, c // config.squeeze_factor, c, 1)
            ca2 = _conv_leaves(gen, c, c // config.squeeze_factor, 1)
            p[f"g{g}.hab{j}"] = {
                **_norm("norm1", c), **_linear(gen, "qkv", 3 * c, c),
                "rpb": _trunc02(gen, (2 * ws - 1) ** 2, heads),
                **_linear(gen, "proj", c, c),
                **{f"cab1.{k}": v for k, v in cab1.items()},
                **{f"cab2.{k}": v for k, v in cab2.items()},
                **{f"ca1.{k}": v for k, v in ca1.items()},
                **{f"ca2.{k}": v for k, v in ca2.items()},
                **_norm("norm2", c), **_linear(gen, "fc1", hid, c),
                **_linear(gen, "fc2", c, hid)}
        p[f"g{g}.ocab"] = {
            **_norm("norm1", c), **_linear(gen, "qkv", 3 * c, c),
            "rpb": _trunc02(gen, (ws + wse - 1) ** 2, heads),
            **_linear(gen, "proj", c, c),
            **_norm("norm2", c), **_linear(gen, "fc1", hid, c), **_linear(gen, "fc2", c, hid)}
        p[f"g{g}.conv"] = _conv_leaves(gen, c, c, 3)
    nf = config.num_feat
    p["norm"] = {"w": torch.ones(c), "b": torch.zeros(c)}
    p["conv_after_body"] = _conv_leaves(gen, c, c, 3)
    p["conv_before_upsample"] = _conv_leaves(gen, nf, c, 3)
    for i in range(config.up_stages):
        p[f"up{i}"] = _conv_leaves(gen, 4 * nf, nf, 3)
    p["conv_last"] = _conv_leaves(gen, config.in_chans, nf, 3)
    return p


# ---------------------------------------------------------------------------
# Relative positions and the shift mask (the published index arithmetic)
# ---------------------------------------------------------------------------


def _grid(n: int) -> torch.Tensor:
    """(2, n*n) row and column of each position of an n×n window."""
    ar = torch.arange(n)
    return torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)


def rpi_sa(ws: int) -> torch.Tensor:
    """(ws², ws²) index into a (2·ws − 1)² bias table, query by key."""
    c = _grid(ws)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def rpi_oca(ws: int, wse: int) -> torch.Tensor:
    """(ws², wse²) index into a (ws + wse − 1)² bias table, query by key,
    as the published ``calculate_rpi_oca`` computes it: its offset leaves
    some indices negative, and indexing wraps them (a one-to-one map onto
    the table all the same)."""
    ori, ext = _grid(ws), _grid(wse)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0) + (ws - wse + 1)
    idx = rel[..., 0] * (ws + wse - 1) + rel[..., 1]
    return idx % ((ws + wse - 1) ** 2)


def _region_labels(hp: int, wp: int, ws: int, shift: int) -> torch.Tensor:
    """(hp, wp) region of each position of the shifted canvas (the
    published ``calculate_mask``: slices ``:-ws``, ``-ws:-shift``,
    ``-shift:`` in each dim)."""
    def regions(n):
        r = torch.zeros(n, dtype=torch.long)
        r[n - ws:n - shift] = 1
        r[n - shift:] = 2
        return r
    return regions(hp)[:, None] * 3 + regions(wp)[None, :]


# ---------------------------------------------------------------------------
# Prepared weights and per-geometry tables
# ---------------------------------------------------------------------------


def _pad_heads(d: int) -> int:
    return -(-d // 8) * 8


def prepare_hat(params: Params, config: HatConfig, device) -> Dict[str, Any]:
    """The weights as the forward runs them (module docstring), on
    ``device``. Geometry tables are added per input size at the first call
    (``"geometry"``)."""
    cd, c, ws, wse = config.compute_dtype, config.embed_dim, config.window_size, \
        config.overlap_win_size
    dev = torch.device(device)

    def t(x):
        return x.to(device=dev, dtype=cd)

    def conv(leaves, prefix=""):
        w = leaves[prefix + "w"].to(device=dev, dtype=cd)
        return {"w": w.contiguous(memory_format=torch.channels_last), "b": t(leaves[prefix + "b"])}

    def attention(leaves, heads, index):
        d = c // heads
        dp = _pad_heads(d)
        qkv_w = torch.zeros(3, heads, dp, c)
        qkv_w[:, :, :d] = leaves["qkv.w"].view(3, heads, d, c)
        qkv_b = torch.zeros(3, heads, dp)
        qkv_b[:, :, :d] = leaves["qkv.b"].view(3, heads, d)
        proj_w = torch.zeros(c, heads, dp)
        proj_w[:, :, :d] = leaves["proj.w"].view(c, heads, d)
        table = leaves["rpb"]
        bias = table[index.reshape(-1)].view(*index.shape, heads).permute(2, 0, 1)
        return {"norm1.w": t(leaves["norm1.w"]), "norm1.b": t(leaves["norm1.b"]),
                "qkv.w": t(qkv_w.view(-1, c)), "qkv.b": t(qkv_b.view(-1)),
                "proj.w": t(proj_w.view(c, -1)), "proj.b": t(leaves["proj.b"]),
                "bias": t(bias).unsqueeze(0).contiguous(),
                "norm2.w": t(leaves["norm2.w"]), "norm2.b": t(leaves["norm2.b"]),
                "fc1.w": t(leaves["fc1.w"]), "fc1.b": t(leaves["fc1.b"]),
                "fc2.w": t(leaves["fc2.w"]), "fc2.b": t(leaves["fc2.b"]),
                "heads": heads, "dp": dp}

    sa, oca = rpi_sa(ws), rpi_oca(ws, wse)
    prep: Dict[str, Any] = {"mean": torch.tensor(config.rgb_mean, device=dev),
                            "conv_first": conv(params["conv_first"]),
                            "patch_norm": {k: t(v) for k, v in params["patch_norm"].items()},
                            "norm": {k: t(v) for k, v in params["norm"].items()},
                            "geometry": {}}
    for g, (depth, heads) in enumerate(zip(config.depths, config.num_heads)):
        for j in range(depth):
            leaves = params[f"g{g}.hab{j}"]
            blk = attention(leaves, heads, sa)
            for name in ("cab1", "cab2"):
                blk[name] = conv(leaves, name + ".")
            for name in ("ca1", "ca2"):
                w = leaves[name + ".w"]
                blk[name] = {"w": t(w.reshape(w.shape[0], -1)), "b": t(leaves[name + ".b"])}
            prep[f"g{g}.hab{j}"] = blk
        prep[f"g{g}.ocab"] = attention(params[f"g{g}.ocab"], heads, oca)
        prep[f"g{g}.conv"] = conv(params[f"g{g}.conv"])
    for name in ["conv_after_body", "conv_before_upsample", "conv_last"] + [
            f"up{i}" for i in range(config.up_stages)]:
        prep[name] = conv(params[name])
    return prep


class _Geometry:
    """Index tables of one (batch, padded height, padded width).

    ``order[shifted]``: the token gather that lays the (rolled) canvas out
    window by window, ``inverse[shifted]`` its inverse permutation; shifted,
    the windows that meet no region edge come first (``n_inner`` of them),
    the last window row and column of each frame after them.
    ``masks[name]``: each shifted block's bias plus the region mask over
    those edge windows, ``(batch · edge windows, heads, N, N)``."""

    def __init__(self, prep, config: HatConfig, b: int, hp: int, wp: int, device):
        ws, s = config.window_size, config.window_size // 2
        nh, nw = hp // ws, wp // ws
        self.n_windows = b * nh * nw
        pos = torch.arange(b * hp * wp).view(b, hp, wp)

        def windows(x):       # (n, hp, wp) → (n, nh, nw, ws·ws)
            n = x.shape[0]
            return x.view(n, nh, ws, nw, ws).permute(0, 1, 3, 2, 4).reshape(n, nh, nw, ws * ws)

        plain = windows(pos).reshape(-1)
        rolled = windows(torch.roll(pos, shifts=(-s, -s), dims=(1, 2)))
        edge = torch.zeros(nh, nw, dtype=torch.bool)
        edge[-1, :] = True
        edge[:, -1] = True
        shifted = torch.cat([rolled[:, ~edge].reshape(-1), rolled[:, edge].reshape(-1)])
        self.n_inner = b * int((~edge).sum())
        self.order = {False: plain.to(device), True: shifted.to(device)}
        self.inverse = {k: torch.argsort(v) for k, v in self.order.items()}

        labels = windows(_region_labels(hp, wp, ws, s)[None])[0][edge]      # (n_edge, N)
        region = torch.where(labels[:, :, None] == labels[:, None, :], 0.0, -100.0)
        region = region.repeat(b, 1, 1).unsqueeze(1).to(device)               # (b·n_edge, 1, N, N)
        self.masks = {}
        for g, depth in enumerate(config.depths):
            for j in range(1, depth, 2):
                name = f"g{g}.hab{j}"
                bias = prep[name]["bias"]
                self.masks[name] = (bias.float() + region).to(bias.dtype).contiguous()
        self.backend = None  # the SDPA backend picked on a card (first call)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

# Fastest first on an H100 at HAT-SRx4's shapes (cuDNN 2.0x the
# mem-efficient kernel); flash attention takes no bias, so it is not tried.
_CANDIDATES = ("CUDNN_ATTENTION", "EFFICIENT_ATTENTION", "MATH")


def _pick_backend(q, k, v, mask, scale) -> Optional[Any]:
    """The first fused SDPA backend (in ``_CANDIDATES`` order) that takes
    these operands on a card; None on the CPU (PyTorch's own choice)."""
    if q.device.type != "cuda":
        return None
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for name in _CANDIDATES:
        backend = getattr(SDPBackend, name)
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q[:1], k[:1], v[:1],
                                               attn_mask=None if mask is None else mask[:1],
                                               scale=scale)
        except RuntimeError:
            continue
        return backend
    raise RuntimeError("no scaled_dot_product_attention backend takes HAT's operands")


class _Attend:
    """``F.scaled_dot_product_attention`` under the geometry's backend,
    counting calls."""

    def __init__(self, geom: _Geometry, stats: Optional[HatStats]):
        self.geom, self.stats = geom, stats

    def __call__(self, q, k, v, mask, scale):
        geom = self.geom
        if geom.backend is None and q.device.type == "cuda":
            geom.backend = _pick_backend(q, k, v, mask, scale)
        if self.stats is not None:
            self.stats.attention_calls += 1
            self.stats.sdpa_backend = (geom.backend.name if geom.backend is not None
                                       else f"{q.device.type} default")
        if geom.backend is None:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
        from torch.nn.attention import sdpa_kernel

        with sdpa_kernel([geom.backend]):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _conv(p, x: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """NHWC ``x`` by an OIHW channels-last weight → NHWC (a view of a
    channels-last result)."""
    return F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], padding=padding).permute(0, 2, 3, 1)


def _ln(p, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over C (eps 1e-5), the leaves ``<prefix>w``, ``<prefix>b``."""
    return F.layer_norm(x, (x.shape[-1],), p[prefix + "w"], p[prefix + "b"], 1e-5)


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(F.linear(_ln(p, "norm2.", x), p["fc1.w"], p["fc1.b"]))
    return x + F.linear(h, p["fc2.w"], p["fc2.b"])


def _hab(p, x, config, geom, attend, shifted, name, marks):
    b, hp, wp, c = x.shape
    heads, dp, n = p["heads"], p["dp"], config.window_size ** 2
    scale = (c // heads) ** -0.5
    xn = _ln(p, "norm1.", x)
    win = xn.reshape(-1, c).index_select(0, geom.order[shifted]).view(-1, n, c)
    qkv = F.linear(win, p["qkv.w"], p["qkv.b"]).view(-1, n, 3, heads, dp)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if shifted:
        o = torch.empty(q.shape[0], n, heads, dp, dtype=q.dtype, device=q.device)
        m = geom.n_inner
        if m:
            o[:m] = attend(q[:m], k[:m], v[:m], p["bias"], scale).transpose(1, 2)
        o[m:] = attend(q[m:], k[m:], v[m:], geom.masks[name], scale).transpose(1, 2)
    else:
        o = attend(q, k, v, p["bias"], scale).transpose(1, 2)
    o = F.linear(o.reshape(-1, heads * dp), p["proj.w"], p["proj.b"])
    x = x + o.index_select(0, geom.inverse[shifted]).view(b, hp, wp, c)
    marks.end(SPAN_WINDOW_ATTN, block=name)
    y = _conv(p["cab2"], F.gelu(_conv(p["cab1"], xn)))
    a = torch.relu(F.linear(y.mean(dim=(1, 2)), p["ca1"]["w"], p["ca1"]["b"]))
    a = torch.sigmoid(F.linear(a, p["ca2"]["w"], p["ca2"]["b"]))
    x = x + (y * a[:, None, None, :]) * config.conv_scale
    marks.end(SPAN_CAB, block=name)
    x = _mlp(p, x)
    marks.end(SPAN_MLP, block=name)
    return x


def _ocab(p, x, config, attend, name, marks):
    b, hp, wp, c = x.shape
    heads, dp = p["heads"], p["dp"]
    ws, wse = config.window_size, config.overlap_win_size
    nh, nw, r = hp // ws, wp // ws, (wse - ws) // 2
    qkv = F.linear(_ln(p, "norm1.", x), p["qkv.w"], p["qkv.b"]).view(b, hp, wp, 3, heads, dp)
    q = qkv[:, :, :, 0].reshape(b, nh, ws, nw, ws, heads, dp).permute(0, 1, 3, 5, 2, 4, 6)
    q = q.reshape(b * nh * nw, heads, ws * ws, dp)
    # The published nn.Unfold of the projected k and v: zero padding r,
    # windows wse wide every ws.
    kv = F.pad(qkv[:, :, :, 1:], (0, 0, 0, 0, 0, 0, r, r, r, r))
    kv = kv.unfold(1, wse, ws).unfold(2, wse, ws)       # b, nh, nw, 2, heads, dp, wse, wse
    kv = kv.permute(3, 0, 1, 2, 4, 6, 7, 5).reshape(2, b * nh * nw, heads, wse * wse, dp)
    o = attend(q, kv[0], kv[1], p["bias"], (c // heads) ** -0.5)
    o = o.view(b, nh, nw, heads, ws, ws, dp).permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, -1)
    x = x + F.linear(o, p["proj.w"], p["proj.b"])
    marks.end(SPAN_OCAB_ATTN, block=name)
    x = _mlp(p, x)
    marks.end(SPAN_MLP, block=name)
    return x


def apply_prepared(prep: Dict[str, Any], batch: torch.Tensor, config: HatConfig,
                   stats: Optional[HatStats] = None, marks=None) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] → (B, H·s, W·s, 3) float32 in [0, 1],
    on :func:`prepare_hat`'s weights; ``marks`` (``layers.marks_for``)
    records the spans."""
    marks = marks or NoMarks()
    cd, ws, s = config.compute_dtype, config.window_size, config.upscale
    b, h, w, _ = batch.shape
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    key = f"{b}x{hp}x{wp}"
    geom = prep["geometry"].get(key)
    if geom is None:
        geom = prep["geometry"][key] = _Geometry(prep, config, b, hp, wp, batch.device)
    if stats is not None:
        stats.windows_per_frame = geom.n_windows // b
        stats.padded_token_share = 1.0 - (h * w) / (hp * wp)
    attend = _Attend(geom, stats)

    mean = prep["mean"]      # on the device already: a host tensor here would sync
    x = (batch.float() - mean) * config.img_range
    if hp != h or wp != w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h), mode="reflect").permute(0, 2, 3, 1)
    shallow = _conv(prep["conv_first"], x.to(cd))
    x = _ln(prep["patch_norm"], "", shallow)
    marks.end(SPAN_CONV, block="head")
    for g, depth in enumerate(config.depths):
        group_in = x
        for j in range(depth):
            name = f"g{g}.hab{j}"
            x = _hab(prep[name], x, config, geom, attend, j % 2 == 1, name, marks)
        name = f"g{g}.ocab"
        x = _ocab(prep[name], x, config, attend, name, marks)
        x = group_in + _conv(prep[f"g{g}.conv"], x)
        marks.end(SPAN_CONV, block=f"g{g}.conv")
    x = _ln(prep["norm"], "", x)
    x = _conv(prep["conv_after_body"], x) + shallow
    x = F.leaky_relu(_conv(prep["conv_before_upsample"], x), 0.01)
    marks.end(SPAN_CONV, block="tail")
    for i in range(config.up_stages):
        x = pixel_shuffle(_conv(prep[f"up{i}"], x), 2)
    y = _conv(prep["conv_last"], x)[:, :h * s, :w * s].float()
    y = torch.clamp(y / config.img_range + mean, 0.0, 1.0)
    marks.end(SPAN_UPSAMPLE, block="upsample")
    return y


def apply_hat(params: Params, batch: torch.Tensor,
              config: HatConfig = HatConfig()) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] → (B, H·s, W·s, 3) float32 in [0, 1], from
    :func:`init_hat`'s param tree (prepared on the batch's device at each
    call)."""
    with torch.no_grad():
        return apply_prepared(prepare_hat(params, config, batch.device), batch, config)
