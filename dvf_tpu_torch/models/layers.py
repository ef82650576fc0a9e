"""Building-block layers for the neural filter models (port of
``dvf_tpu.models.layers``).

Params keep the reference's layout, so ``convert.from_jax`` carries them
across unchanged: flat dicts of dicts of float32 tensors, conv weights
HWIO ``(k, k, Cin, Cout)``. Activations are NHWC at every function. A conv
permutes at the call: the NHWC activation viewed as NCHW (a contiguous
NHWC tensor permuted with ``.permute(0, 3, 1, 2)`` already has
channels-last strides, so cuDNN takes it without a copy) and the weight
as OIHW, and the NCHW result permuted back to NHWC.

The convs are ``F.conv2d`` (cuDNN on a card): the reference computes them
with ``lax.conv_general_dilated``, outside any Pallas kernel. They run in
``compute_dtype`` (bfloat16 by default) with a result in that dtype, as
``lax.conv`` does; instance-norm statistics are float32. A conv's bias,
the instance norm after it, its ReLU and a residual add run as one call,
:func:`bias_norm_act`: on a card outside autograd, the kernels of
``csrc/norm.cu`` (launched by ``ops.kernels.bias_norm_act_cuda``). The
style nets' out stage (9×9 conv, bias, scaled tanh) is one call too,
:func:`out_conv_tanh`: on a card outside autograd, in bf16, the kernel of
``csrc/outconv.cu`` (``ops.kernels.out_conv_tanh_cuda``).
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def generator(rng: Union[int, torch.Generator]) -> torch.Generator:
    """A CPU generator from a seed (or the generator itself): seeded
    weights are drawn on the CPU, so a seed gives the same weights on
    every device. They are not the JAX package's weights for that seed
    (another PRNG); carry those across with ``convert.from_jax``."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def conv_init(gen: torch.Generator, ksize: int, cin: int, cout: int) -> Params:
    """He-normal conv weight + zero bias, float32 on the CPU, drawn from
    ``gen`` (so one seed gives the same weights wherever they are used)."""
    fan_in = ksize * ksize * cin
    w = torch.randn((ksize, ksize, cin, cout), generator=gen) * math.sqrt(2.0 / fan_in)
    return {"w": w, "b": torch.zeros(cout)}


def pad_nhwc(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    """Pad H and W of an NHWC tensor by ``r``: ``constant`` (zeros),
    ``reflect`` (reflect-101, ``jnp.pad(mode="reflect")``) or ``edge``.
    The result is a contiguous NHWC tensor: one copy of ``x`` into it,
    then the border rows, then the border columns (corners included)
    copied from it, all by slicing (no index tensor crosses from the host,
    so nothing waits for the card)."""
    if r == 0:
        return x
    if mode == "constant":
        return F.pad(x, (0, 0, r, r, r, r))
    _, h, w, _ = x.shape
    out = x.new_empty((x.shape[0], h + 2 * r, w + 2 * r, x.shape[3]))
    out[:, r:r + h, r:r + w] = x
    if mode == "reflect":
        out[:, :r, r:r + w] = x[:, 1:r + 1].flip(1)
        out[:, r + h:, r:r + w] = x[:, h - 1 - r:h - 1].flip(1)
        out[:, :, :r] = out[:, :, r + 1:2 * r + 1].flip(2)
        out[:, :, r + w:] = out[:, :, w - 1:w + r - 1].flip(2)
    else:
        out[:, :r, r:r + w] = x[:, :1]
        out[:, r + h:, r:r + w] = x[:, h - 1:]
        out[:, :, :r] = out[:, :, r:r + 1]
        out[:, :, r + w:] = out[:, :, r + w - 1:r + w]
    return out


# ---------------------------------------------------------------------------
# Rank programs (tensor parallelism)
# ---------------------------------------------------------------------------
#
# A net's forward under tensor parallelism is written once, as a generator
# (a "rank program"): where it needs the ranks of the model axis together
# it yields a request ``(kind, tensor)`` and resumes with the collective's
# result. ``SUM``: the row-parallel partial sums, summed across the ranks.
# ``GATHER``: channel slices, joined on C. Unsharded, a program yields
# nothing, and :func:`run_steps` drives it to its end. Sharded, one driver
# runs every rank's program from the calling thread,
# ``parallel.sharded.lockstep``, each collective one autograd node: the
# serving body (``parallel.sharded.tp_filter``) and the train step alike.

SUM, GATHER = "sum", "gather"


def run_steps(program: Iterator) -> Any:
    """Drive an unsharded rank program to its end and return its value.
    Unsharded, a program requests no collective: one that does raises."""
    try:
        req = next(program)
    except StopIteration as stop:
        return stop.value
    program.close()
    raise RuntimeError(f"an unsharded rank program requested {req[0]!r}")


_PARTIALS = threading.local()


@contextlib.contextmanager
def float32_partials() -> Iterator[None]:
    """Within the block (this thread only), convolutions return float32:
    their operands, already rounded to the compute dtype, are widened, so
    the products are exact and the sums stay unrounded. A row-parallel
    conv's partial sum then rounds once, after the sum across the model
    ranks, as the unsharded conv rounds once."""
    prev = getattr(_PARTIALS, "on", False)
    _PARTIALS.on = True
    try:
        yield
    finally:
        _PARTIALS.on = prev


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    """NHWC ``x`` (already in the compute dtype) by an HWIO ``w`` → NHWC."""
    if getattr(_PARTIALS, "on", False):
        x, w = x.float(), w.float()
    w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv2d_nb(
    p: Params,
    x: torch.Tensor,
    stride: int = 1,
    padding: str = "SAME",
    compute_dtype: torch.dtype = torch.bfloat16,
    reflect: bool = False,
) -> torch.Tensor:
    """2-D conv WITHOUT the bias add, in ``compute_dtype``.

    ``reflect``: reflect-pad to SAME size, then VALID (the style nets).
    Otherwise ``padding`` is "SAME" (zero padding of k // 2, stride 1 as
    the models use it) or "VALID".
    """
    k = p["w"].shape[0]
    pad = 0
    if reflect:
        x = pad_nhwc(x, k // 2, "reflect")
    elif padding == "SAME":
        if stride != 1 or k % 2 != 1:
            raise ValueError("SAME padding is ported for stride 1 and odd kernels")
        pad = k // 2
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return _conv(x.to(compute_dtype), p["w"].to(compute_dtype), stride, pad)


def instance_norm_init(c: int) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def instance_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) normalization over H, W; stats in float32
    (the population variance, as ``jnp.var``), result in ``x``'s dtype.

    The reference's ``(x - mean) * rsqrt(var + eps) * scale + bias`` as one
    per-(sample, channel) affine map ``x * a + (bias - mean * a)`` with
    ``a = scale * rsqrt(var + eps)``: one pass over the activation in
    place of four (float32 rounding differs by a few ulps)."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 2), keepdim=True, correction=0)
    a = torch.rsqrt(var + eps) * p["scale"]
    return torch.addcmul(p["bias"] - mean * a, xf, a).to(x.dtype)


def bias_norm_act_plain(p: Params, y: torch.Tensor, b: torch.Tensor,
                        relu: bool = False, residual: Optional[torch.Tensor] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """The conv bias add, :func:`instance_norm`, ReLU and residual add as
    separate ops, each rounding to ``y``'s dtype: the numerics the kernels
    of :func:`bias_norm_act` are held to, and the differentiable path."""
    h = instance_norm(p, y + b.to(y.dtype), eps)
    if relu:
        h = torch.relu(h)
    return h if residual is None else residual + h


def bias_norm_act(p: Params, y: torch.Tensor, b: torch.Tensor, relu: bool = False,
                  residual: Optional[torch.Tensor] = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """``[residual +] [relu] instance_norm(p, y + b)`` for a conv's pre-bias
    output ``y`` (NHWC, in the compute dtype) and its bias ``b``.

    A CPU tensor takes :func:`bias_norm_act_plain`. A CUDA tensor takes it
    too where the call is differentiable (grad mode on and any operand
    requiring grad: the kernels have no backward; counted in
    ``ops.kernels.AUTOGRAD_CALLS``), and otherwise the kernels
    (``ops.kernels.bias_norm_act_cuda``), which raise rather than fall
    back."""
    if y.device.type == "cpu":
        return bias_norm_act_plain(p, y, b, relu, residual, eps)
    from dvf_tpu_torch.ops import kernels

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (y, b, p["scale"], p["bias"], residual)):
        kernels.count_autograd("instance_norm")
        return bias_norm_act_plain(p, y, b, relu, residual, eps)
    return kernels.bias_norm_act_cuda(p, y.contiguous(), b, relu,
                                      None if residual is None else residual.contiguous(),
                                      eps)


def bias_tanh(y: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``0.5 · (tanh(y + b) + 1)`` for a conv's pre-bias output ``y``: the
    bias added in ``y``'s dtype, tanh and the scale in float32, the result
    in ``out_dtype`` (a float image in [0, 1])."""
    return (0.5 * (torch.tanh((y + b.to(y.dtype)).float()) + 1.0)).to(out_dtype)


def out_conv_tanh_plain(p: Params, x: torch.Tensor, compute_dtype: torch.dtype,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """The style nets' out stage as separate ops: the reflect-padded conv
    in ``compute_dtype`` (:func:`conv2d_nb`), then :func:`bias_tanh`. The
    numerics the kernel of :func:`out_conv_tanh` is held to, and the
    differentiable path."""
    return bias_tanh(conv2d_nb(p, x, compute_dtype=compute_dtype, reflect=True),
                     p["b"], out_dtype)


def out_conv_tanh(p: Params, x: torch.Tensor, compute_dtype: torch.dtype,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The style nets' out stage, ``0.5 · (tanh(conv(x) + b) + 1)`` with a
    reflect-101 border, from an NHWC activation ``x`` and the conv's
    params ``p`` (HWIO weight, bias).

    A CPU tensor takes :func:`out_conv_tanh_plain`. A CUDA tensor takes it
    too where the call is differentiable (grad mode on and any operand
    requiring grad; counted in ``ops.kernels.AUTOGRAD_CALLS``), where the
    compute dtype is not bfloat16 (float32 stays on cuDNN, TF32 off) or
    the output not float32, and where the kernel does not take the shape
    (``ops.kernels.out_conv_takes``); otherwise the kernel
    (``ops.kernels.out_conv_tanh_cuda``), which raises rather than falls
    back."""
    if x.device.type == "cpu":
        return out_conv_tanh_plain(p, x, compute_dtype, out_dtype)
    from dvf_tpu_torch.ops import kernels

    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, p["w"], p["b"])):
        kernels.count_autograd("out_conv")
        return out_conv_tanh_plain(p, x, compute_dtype, out_dtype)
    if (compute_dtype != torch.bfloat16 or out_dtype != torch.float32
            or not kernels.out_conv_takes(x.shape, p["w"].shape)):
        return out_conv_tanh_plain(p, x, compute_dtype, out_dtype)
    return kernels.out_conv_tanh_cuda(p, x.to(compute_dtype).contiguous())


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample ×factor of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def depth_to_space(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Subpixel rearrange (B, H, W, C·r²) → (B, H·r, W·r, C), DCR order:
    ``y[b, h*r+i, w*r+j, c] = x[b, h, w, (i*r + j)*C + c]`` (not
    ``F.pixel_shuffle``'s CRD order)."""
    b, h, w, crr = x.shape
    c = crr // (factor * factor)
    if c * factor * factor != crr:
        raise ValueError(f"channels {crr} not divisible by r²={factor * factor}")
    x = x.reshape(b, h, w, factor, factor, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # b, h, i, w, j, c
    return x.reshape(b, h * factor, w * factor, c)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``nn.PixelShuffle(r)`` (CRD: input channel ``c·r² + i·r + j``) on
    NHWC: (B, H, W, C·r²) → (B, H·r, W·r, C). The SR nets' upsamplers."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """Batched Gram matrix of NHWC features: (B, C, C) / (H*W*C)."""
    b, h, w, c = feats.shape
    f = feats.reshape(b, h * w, c).float()
    return torch.einsum("bnc,bnd->bcd", f, f) / (h * w * c)


# ---------------------------------------------------------------------------
# Exact conv rewrites (the reference's fast_convs)
# ---------------------------------------------------------------------------
#
# - conv2d_s2d: a stride-1 kxk conv on (H, W, Cin) equals a
#   ceil((k+1)/2)-sized conv on the space-to-depth transform
#   (H/2, W/2, 4·Cin) producing all four output phases (4·Cout channels),
#   followed by depth_to_space.
# - upsample2_conv: nearest-×2 upsample then a kxk conv collapses to a
#   per-phase conv at LOW resolution whose taps are the sums of the
#   original taps that landed on the same source pixel.
# The reference built them to fill the TPU's 128-lane MXU; whether they
# help on a card is what an A/B measures (ops.registry MEASURED_DEFAULTS).


def space_to_depth(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, H, W, C) → (B, H/f, W/f, f²·C); inverse of depth_to_space
    (phase-major channel order: out[..., (a*f + b)*C + c] = x[h*f+a, w*f+b, c])."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // factor, w // factor, factor * factor * c)


def _s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """Rearrange a (k, k, Cin, Cout) stride-1 kernel into the equivalent
    (k2, k2, 4·Cin, 4·Cout) kernel over space-to-depth phases (factor 2),
    by two stacks of its rows and columns (indices from k alone)."""
    k = w.shape[0]
    k2 = (k + 1) // 2
    # The padded k-th row/col is the zero tap for out-of-range phases.
    wpad = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))
    # idy[p, a, i] = dy = 2p + a - i when 0 <= dy < k, else k (zero row).
    idy = [2 * p + a - i if 0 <= 2 * p + a - i < k else k
           for p in range(k2) for a in range(2) for i in range(2)]
    rows = torch.stack([wpad[d] for d in idy])             # (p a i), col, ci, co
    g = torch.stack([rows[:, d] for d in idy], dim=1)      # (p a i), (q b j), ci, co
    g = g.reshape(k2, 2, 2, k2, 2, 2, *w.shape[2:])
    # g[p, a, i, q, b, j, ci, co] → (p, q, a, b, ci, i, j, co)
    g = g.permute(0, 3, 1, 4, 6, 2, 5, 7)
    cin, cout = w.shape[2], w.shape[3]
    return g.reshape(k2, k2, 4 * cin, 4 * cout)


def conv2d_s2d(
    p: Params,
    x: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    reflect: bool = False,
) -> torch.Tensor:
    """Stride-1 SAME conv (without bias) computed at half resolution via
    space-to-depth: the same taps as :func:`conv2d_nb`. Needs even H and W;
    other geometries take :func:`conv2d_nb`."""
    k = p["w"].shape[0]
    r = k // 2
    _, h, w_, _ = x.shape
    if h % 2 or w_ % 2:
        return conv2d_nb(p, x, compute_dtype=compute_dtype, reflect=reflect)
    xp = pad_nhwc(x, r, "reflect" if reflect else "constant")
    x2 = space_to_depth(xp.to(compute_dtype), 2)
    k5 = _s2d_kernel(p["w"]).to(compute_dtype)
    return depth_to_space(_conv(x2, k5), 2)


def _upsample2_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Phase-collapse a (k, k, Cin, Cout) kernel across a preceding
    nearest-×2 upsample: taps of the full-res conv that read the same
    low-res source pixel sum into one tap, in the reference's order.
    Returns the (kl, kl, Cin, 4·Cout) kernel for a VALID conv on the
    low-res input and the edge-pad radius that input needs."""
    k = w.shape[0]
    r = k // 2
    # Low-res tap offset e = floor((i + dy - r) / 2) for dy in [0, k).
    offs = sorted({(i + dy - r) // 2 for dy in range(k) for i in range(2)})
    e0, kl = offs[0], offs[-1] - offs[0] + 1
    cin, cout = w.shape[2], w.shape[3]
    kl_w = torch.zeros((kl, kl, 2, 2, cin, cout), dtype=w.dtype, device=w.device)
    for i in range(2):
        for j in range(2):
            for dy in range(k):
                for dx in range(k):
                    e = (i + dy - r) // 2 - e0
                    f = (j + dx - r) // 2 - e0
                    kl_w[e, f, i, j] += w[dy, dx]
    # (e, f, i, j, ci, co) → (e, f, ci, (i·2+j)·Cout + co)
    kl_w = kl_w.permute(0, 1, 4, 2, 3, 5).reshape(kl, kl, cin, 4 * cout)
    return kl_w, -e0


def upsample2_conv(
    p: Params,
    x: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Nearest-×2 upsample + reflect-SAME conv (without bias), computed at
    LOW resolution: exact for k = 3, where edge padding of the low-res
    input reproduces reflect-101 of the upsampled input. Other kernel
    sizes take the materialized upsample."""
    if p["w"].shape[0] != 3:
        return conv2d_nb(p, upsample_nearest(x, 2),
                         compute_dtype=compute_dtype, reflect=True)
    klw, pad = _upsample2_kernel(p["w"])
    xp = pad_nhwc(x, pad, "edge")
    return depth_to_space(_conv(xp.to(compute_dtype), klw.to(compute_dtype)), 2)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_of(dtype: Optional[str]) -> torch.dtype:
    """The model compute dtype named by a filter factory's ``dtype``
    argument (None: bfloat16)."""
    if dtype is None:
        dtype = "bfloat16"
    if dtype not in _DTYPES:
        raise ValueError(
            f"dtype must be 'bfloat16' or 'float32', got {dtype!r}")
    return _DTYPES[dtype]


@contextlib.contextmanager
def exact_f32_convs(compute_dtype: torch.dtype) -> Iterator[None]:
    """For a float32 compute dtype, run cuDNN's convolutions in float32
    within the block: cuDNN computes them as TF32 by default, and the
    reference's float32 means float32. A process-wide flag, restored on
    exit; other dtypes leave it alone."""
    if compute_dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def tree_to(params: Any, device: Optional[torch.device] = None) -> Any:
    """A nested dict of tensors (or numpy arrays) moved to ``device``."""
    if isinstance(params, dict):
        return {k: tree_to(v, device) for k, v in params.items()}
    return torch.as_tensor(params).to(device)


# ---------------------------------------------------------------------------
# Spans of a traced forward (the SR nets)
# ---------------------------------------------------------------------------


class Marks:
    """Phase boundaries of one traced batch: on a card a timing event on
    the current stream at each, emitted as ``Tracer.device_span``; on the
    CPU (where the ops have run when they return) a host stamp, emitted
    as ``Tracer.complete``. Each span runs from the previous boundary (or
    the recorder's creation) to this one, tagged with the batch's ``seq``
    and the caller's tags."""

    def __init__(self, tracer, device: torch.device, seq: int):
        self.tracer, self.seq = tracer, seq
        self.cuda = device.type == "cuda"
        self.last = self._stamp()

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def end(self, name: str, **tags) -> None:
        now = self._stamp()
        if self.cuda:
            self.tracer.device_span(name, self.last, now, seq=self.seq, **tags)
        else:
            self.tracer.complete(name, self.last, now, seq=self.seq, **tags)
        self.last = now


class NoMarks:
    def end(self, name: str, **tags) -> None:
        pass


def marks_for(tracer, device: torch.device, seq: int):
    """The span recorder of one batch: a no-op unless ``tracer`` is
    enabled."""
    if tracer is None or not tracer.enabled:
        return None
    return Marks(tracer, torch.device(device), seq)
