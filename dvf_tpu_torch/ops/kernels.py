"""Hand-written Hopper kernels for the stencil ops, the bounded warp and
the delta wire's codec assist, their wrappers and their registered
filters (port of ``dvf_tpu/ops/pallas_kernels.py``), and the launchers of
the style nets' bias + instance norm + ReLU + residual kernels
(``csrc/norm.cu``) and of their out stage's conv + bias + tanh kernel
(``csrc/outconv.cu``), which replace no TPU kernel.

The names keep the reference's: ``*_pallas`` here denotes the CUDA C++
kernel in ``dvf_tpu_torch/csrc/`` (``stencils.cu``, ``warp.cu``,
``codec.cu``) that replaces the TPU's Pallas kernel of the same name.
Each wrapper dispatches on the tensor's device:

- a CUDA tensor launches the kernel on the current stream (no
  synchronisation) or raises — there is no fallback;
- a CPU tensor runs the kernel's plain torch version (the numerics
  reference the kernel is held to).

``LAUNCHES`` counts kernel launches per kernel, so a run can show that
its main path went through the kernels (``instance_norm`` counts one a
call of :func:`bias_norm_act_cuda`, which launches three; ``out_conv``
one a call of :func:`out_conv_tanh_cuda`); CPU calls
never count. ``AUTOGRAD_CALLS`` counts the calls on a card that took an
op's plain version because they are differentiable (the kernels have no
backward).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.ops import _build
from dvf_tpu_torch.ops.bilateral import bilateral_nhwc
from dvf_tpu_torch.ops.conv import Taps, gaussian_kernel_1d, sep_conv2d, taps_f32
from dvf_tpu_torch.ops.flow import warp_by_flow
from dvf_tpu_torch.ops.registry import get_filter, register_filter

LAUNCHES: Dict[str, int] = {"sep_blur": 0, "bilateral": 0, "sobel_bilateral": 0,
                            "warp_bounded": 0, "tile_maxdiff": 0,
                            "dct8x8_quant": 0, "instance_norm": 0, "out_conv": 0}
AUTOGRAD_CALLS: Dict[str, int] = {"instance_norm": 0, "out_conv": 0}
_launch_lock = threading.Lock()

# Limits compiled into csrc/stencils.cu.
MAX_TAPS = 31
MAX_WIN = 15
MAX_C = 4
# Sizes csrc/stencils.cu compiles with constant taps / window (the main
# path's k = 9 and d = 5, and the sizes the card tests use); every other
# size up to the limits runs the runtime-size instantiation. The bilateral
# and the fused Sobel+bilateral share the radii.
SEP_BLUR_TAPS = ((9, 9), (3, 9), (5, 1))
BILATERAL_RADII = (1, 2, 3)
# Channels csrc/warp.cu takes (the inner warp runs on 5-channel stacks).
MAX_WARP_C = 8
# csrc/warp.cu's designs: "auto" takes the shared-memory window where it
# fits 48 KB of shared memory and its grid gives every SM two blocks, else
# the direct gather; "window" and "gather" force one (a window that does not
# fit is refused), so the card tests and chip_smoke.py hold both to the
# plain version at every shape.
WARP_DESIGNS = ("auto", "window", "gather")
# csrc/codec.cu's DCT kernel takes at most this many planes per launch (the
# wire's Y, Cb, Cr).
DCT_MAX_PLANES = 3

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)  # host float arrays (taps, weights)
_IP = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
# C entry points of each csrc/<source>.cu.
_SIGNATURES = {
    "stencils": {
        "dvf_sep_blur": [_P, _P, _I, _I, _I, _I, _FP, _I, _FP, _I, _I, _I, _P],
        "dvf_bilateral": [_P, _P, _I, _I, _I, _I, _I, _I, _FP, _F, _P],
        "dvf_sobel_bilateral": [_P, _P, _I, _I, _I, _I, _I, _I, _FP, _F, _F, _P],
    },
    "warp": {
        "dvf_warp_bounded": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "codec": {
        "dvf_tile_maxdiff": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "dvf_dct8x8_quant_planes": [_PP, _PP, _IP, _I, _I, _FP, _FP, _P],
    },
    "norm": {
        "dvf_instance_norm": [_P] * 7 + [_I] * 6 + [_F, _P],
    },
    "outconv": {
        "dvf_out_conv": [_P] * 5 + [_I] * 4 + [_P],
    },
}
# Sources one caller needs together, built together at the first use of
# either: the style nets' norms and out stage.
_BUILT_TOGETHER = {"norm": ("norm", "outconv"), "outconv": ("norm", "outconv")}
_lib_objs: Dict[str, ctypes.CDLL] = {}


def _lib(source: str = "stencils") -> ctypes.CDLL:
    lib = _lib_objs.get(source)
    if lib is None:
        _build.build_all(_BUILT_TOGETHER.get(source, (source,)))
        lib = _build.load(source)
        for fn, argtypes in _SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.dvf_error_string.argtypes = [ctypes.c_int]
        lib.dvf_error_string.restype = ctypes.c_char_p
        _lib_objs[source] = lib
    return lib


def reset_launches() -> None:
    """Set every launch counter and every ``AUTOGRAD_CALLS`` count to 0."""
    with _launch_lock:
        for counts in (LAUNCHES, AUTOGRAD_CALLS):
            for k in counts:
                counts[k] = 0


def count_autograd(op: str) -> None:
    """Count a call on a card that ran ``op``'s plain version because it
    is differentiable."""
    with _launch_lock:
        AUTOGRAD_CALLS[op] += 1


def _floats(vals: List[float]):
    return (ctypes.c_float * len(vals))(*vals)


def sep_blur_instance(kh: int, kw: int, c: int) -> Tuple[int, int, int]:
    """The template arguments ``(C, KH, KW)`` of the ``sep_blur_kernel``
    a (kh, kw)-tap blur over c channels runs: the tap pair itself where it
    is compiled as constants, else KH = KW = 0 (tap counts at run time)."""
    fixed = (kh, kw) in SEP_BLUR_TAPS
    return (c, kh if fixed else 0, kw if fixed else 0)


def bilateral_instance(d: int, c: int) -> Tuple[int, int]:
    """The template arguments ``(C, R)`` of the ``bilateral_kernel`` a
    d×d window over c channels runs: its radius where that is compiled as
    a constant, else R = 0 (radius at run time)."""
    r = d // 2
    return (c, r if r in BILATERAL_RADII else 0)


def bilateral_constants(d: int, sigma_color: float,
                        sigma_space: float) -> Tuple[List[float], float]:
    """What the bilateral kernel folds its weights from: log2 of the
    (2r+1)² spatial weights, row-major, and nk = −log2(e)/(2σc²), both
    computed in double and rounded to float32. Per tap the kernel takes
    w = 2^(dist2·nk + log2 sw) (one FFMA, one ex2.approx); the plain
    version's sw·exp(−dist2/(2σc²)) is the same value."""
    r = d // 2
    log2e = 1.0 / math.log(2.0)
    log2w = [float(np.float32(-(dy * dy + dx * dx) / (2.0 * sigma_space * sigma_space)
                              * log2e))
             for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    return log2w, float(np.float32(-log2e / (2.0 * sigma_color * sigma_color)))


def sobel_bilateral_instance(d: int, c: int) -> Tuple[int, int]:
    """The template arguments ``(C, R)`` of the ``sobel_bilateral_kernel`` a
    d×d window over c channels runs: as :func:`bilateral_instance`."""
    return bilateral_instance(d, c)


def sobel_bilateral_constants(d: int, sigma_color: float, sigma_space: float,
                              c: int) -> Tuple[List[float], float]:
    """What the fused Sobel+bilateral kernel folds its weights from: log2
    of the spatial weights (as :func:`bilateral_constants`) and
    nk = −c·log2(e)/(2σc²), computed in double and rounded to float32.
    The chain's bilateral sees the edge map broadcast to c channels, so its
    range distance is c·Δ² of the single channel; per tap the kernel takes
    w = 2^(Δ²·nk + log2 sw)."""
    log2w, _ = bilateral_constants(d, sigma_color, sigma_space)
    log2e = 1.0 / math.log(2.0)
    return log2w, float(np.float32(-c * log2e / (2.0 * sigma_color * sigma_color)))


def _check_cuda(batch: torch.Tensor, what: str, halo_h: int, halo_w: int,
                min_c: int = 1) -> None:
    if batch.device.type != "cuda":
        raise ValueError(f"{what}: takes a CUDA or CPU tensor, got {batch.device}")
    if batch.dtype != torch.float32:
        raise TypeError(f"{what}: needs float32, got {batch.dtype}")
    if batch.dim() != 4:
        raise ValueError(f"{what}: needs an NHWC batch, got shape {tuple(batch.shape)}")
    if not batch.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous NHWC tensor")
    _, h, w, c = batch.shape
    if not min_c <= c <= MAX_C:
        raise ValueError(f"{what}: takes {min_c}..{MAX_C} channels, got {c}")
    if h <= halo_h or w <= halo_w:
        raise ValueError(
            f"{what}: frame {h}x{w} is too small for a reflect-101 halo of "
            f"{halo_h} rows / {halo_w} cols")


def _launch(fn: str, counter: str, batch: torch.Tensor, *args) -> torch.Tensor:
    """Launch ``fn`` on (batch, out, B, H, W, C, *args, stream). ``args``
    holds the ctypes arrays it passes, so they outlive the call."""
    out = torch.empty_like(batch)
    if batch.numel() == 0:
        return out
    b, h, w, c = batch.shape
    lib = _lib()
    with torch.cuda.device(batch.device):
        stream = torch.cuda.current_stream(batch.device).cuda_stream
        rc = getattr(lib, fn)(batch.data_ptr(), out.data_ptr(), b, h, w, c,
                              *args, stream)
    _count(lib, fn, counter, rc)
    return out


def _count(lib: ctypes.CDLL, fn: str, counter: str, rc: int) -> None:
    """Raise on a refused launch, else count it."""
    if rc != 0:
        raise RuntimeError(
            f"{fn} launch failed: {lib.dvf_error_string(rc).decode()} ({rc})")
    with _launch_lock:
        LAUNCHES[counter] += 1


def sep_blur_nhwc_pallas(batch: torch.Tensor, kh: Taps, kw: Taps) -> torch.Tensor:
    """Separable conv over float NHWC, both 1-D passes in one kernel (the
    H pass in registers down each column of a 64×64 tile, the H-blurred
    tile in shared memory for the W pass; see :func:`sep_blur_instance`).
    Plain version: ``sep_conv2d(impl="shift")`` — same reflect-101
    borders, same tap order."""
    th, tw = taps_f32(kh), taps_f32(kw)
    if len(th) % 2 != 1 or len(tw) % 2 != 1:
        raise ValueError(f"tap counts must be odd, got {len(th)} and {len(tw)}")
    if batch.device.type == "cpu":
        return sep_conv2d(batch, th, tw, impl="shift")
    if len(th) > MAX_TAPS or len(tw) > MAX_TAPS:
        raise ValueError(f"at most {MAX_TAPS} taps per axis, got {len(th)}, {len(tw)}")
    _check_cuda(batch, "sep_blur_nhwc_pallas", len(th) // 2, len(tw) // 2)
    _, fixed_kh, fixed_kw = sep_blur_instance(len(th), len(tw), batch.shape[-1])
    return _launch("dvf_sep_blur", "sep_blur", batch, _floats(th), len(th),
                   _floats(tw), len(tw), fixed_kh, fixed_kw)


def bilateral_nhwc_pallas(batch: torch.Tensor, d: int = 5,
                          sigma_color: float = 0.1,
                          sigma_space: float = 2.0) -> torch.Tensor:
    """Bilateral over float NHWC in [0,1]: four vertically adjacent
    outputs per thread from an RGB0 tile in shared memory, the spatial
    weight folded into the range weight's exponent
    (:func:`bilateral_constants`, :func:`bilateral_instance`). Plain
    version: ``ops.bilateral.bilateral_nhwc``."""
    if d % 2 != 1:
        raise ValueError(f"window d must be odd, got {d}")
    if batch.device.type == "cpu":
        return bilateral_nhwc(batch, d=d, sigma_color=sigma_color,
                              sigma_space=sigma_space)
    if d > MAX_WIN:
        raise ValueError(f"window d must be at most {MAX_WIN}, got {d}")
    r = d // 2
    _check_cuda(batch, "bilateral_nhwc_pallas", r, r)
    _, fixed_r = bilateral_instance(d, batch.shape[-1])
    log2w, nk = bilateral_constants(d, sigma_color, sigma_space)
    return _launch("dvf_bilateral", "bilateral", batch, r, fixed_r,
                   _floats(log2w), nk)


def sobel_bilateral_nhwc_pallas(batch: torch.Tensor, d: int = 5,
                                sigma_color: float = 0.1,
                                sigma_space: float = 2.0,
                                magnitude_scale: float = 1.0) -> torch.Tensor:
    """Fused Sobel→bilateral over float NHWC in [0,1]: Rec.601 gray →
    Sobel magnitude × scale clipped to [0,1] → single-channel bilateral,
    broadcast to C channels; gray and magnitude never leave shared
    memory. Four vertically adjacent outputs per thread, the spatial
    weight folded into the range weight's exponent
    (:func:`sobel_bilateral_constants`, :func:`sobel_bilateral_instance`).
    Plain version: ``sobel_bilateral(impl="chain")``."""
    if d % 2 != 1:
        raise ValueError(f"window d must be odd, got {d}")
    if batch.device.type == "cpu":
        chain = get_filter("sobel_bilateral", d=d, sigma_color=sigma_color,
                           sigma_space=sigma_space,
                           magnitude_scale=magnitude_scale, impl="chain")
        return chain.fn(batch, None)[0]
    if d > MAX_WIN:
        raise ValueError(f"window d must be at most {MAX_WIN}, got {d}")
    r = d // 2
    _check_cuda(batch, "sobel_bilateral_nhwc_pallas", r + 1, r + 1, min_c=3)
    # C·Δ² range distance, as the unfused chain (the TPU kernel hard-codes
    # C = 3).
    log2w, nk = sobel_bilateral_constants(d, sigma_color, sigma_space,
                                          batch.shape[-1])
    _, fixed_r = sobel_bilateral_instance(d, batch.shape[-1])
    return _launch("dvf_sobel_bilateral", "sobel_bilateral", batch, r, fixed_r,
                   _floats(log2w), nk, magnitude_scale)


def warp_bounded_pallas(img: torch.Tensor, flow: torch.Tensor,
                        max_disp: int = 4, design: str = "auto") -> torch.Tensor:
    """Backward-warp ``img`` (B,H,W,C) by ``flow`` (B,H,W,2; [...,0]=dx)
    with displacements clipped to ±``max_disp`` px and the sample point
    clamped to the frame (``csrc/warp.cu``): each block gathers from its
    bounded source window in shared memory, or one thread per pixel
    gathers straight from global memory where the window does not fit or
    the frame is too small to fill the card (``design``, see
    :data:`WARP_DESIGNS`).
    Plain version: ``warp_by_flow(img, flow.clamp(-max_disp, max_disp))``,
    which the kernels reproduce operation for operation."""
    r = int(max_disp)
    if r < 1:
        raise ValueError("max_disp must be >= 1")
    if design not in WARP_DESIGNS:
        raise ValueError(f"design must be one of {WARP_DESIGNS}, got {design!r}")
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warp_by_flow(img, flow.clamp(-r, r))
    what = "warp_bounded_pallas"
    if img.device.type != "cuda" or flow.device != img.device:
        raise ValueError(f"{what}: takes img and flow both on one CUDA device "
                         f"or both on the CPU, got {img.device} and {flow.device}")
    if img.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"{what}: needs float32, got {img.dtype} and {flow.dtype}")
    if img.dim() != 4 or not 1 <= img.shape[-1] <= MAX_WARP_C:
        raise ValueError(f"{what}: needs an NHWC batch of 1..{MAX_WARP_C} "
                         f"channels, got shape {tuple(img.shape)}")
    b, h, w, c = img.shape
    if tuple(flow.shape) != (b, h, w, 2):
        raise ValueError(f"{what}: flow must be {(b, h, w, 2)}, got "
                         f"{tuple(flow.shape)}")
    if not (img.is_contiguous() and flow.is_contiguous()) or flow.data_ptr() % 8:
        raise ValueError(f"{what}: needs contiguous NHWC tensors (flow "
                         f"8-byte aligned)")
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    lib = _lib("warp")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.dvf_warp_bounded(img.data_ptr(), flow.data_ptr(), out.data_ptr(),
                                  b, h, w, c, r, WARP_DESIGNS.index(design), stream)
    _count(lib, "dvf_warp_bounded", "warp_bounded", rc)
    return out


# -- the style nets' bias + instance norm + ReLU + residual (csrc/norm.cu) --


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _norm_slices(batch: int, hw: int, device: torch.device) -> int:
    """The slices of H·W each sample's statistics split into: about four
    blocks a multiprocessor over the batch, fewer on a small frame."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return max(1, min(-(-4 * _sm_count(index) // batch), -(-hw // 16), 65535))


def bias_norm_act_cuda(p: Dict[str, torch.Tensor], y: torch.Tensor, b: torch.Tensor,
                       relu: bool = False, residual: Optional[torch.Tensor] = None,
                       eps: float = 1e-5) -> torch.Tensor:
    """``models.layers.bias_norm_act_plain`` through csrc/norm.cu: the
    statistics, their merge and the apply pass, three launches on the
    current stream, no synchronisation, counted once as
    ``instance_norm``. Takes a contiguous NHWC ``y`` (and ``residual``)
    of bf16 or float32 on a CUDA device; raises on anything else."""
    what = "bias_norm_act_cuda"
    if y.device.type != "cuda":
        raise ValueError(f"{what}: takes a CUDA tensor, got {y.device}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: needs bfloat16 or float32, got {y.dtype}")
    if y.dim() != 4 or not y.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous NHWC tensor, got shape "
                         f"{tuple(y.shape)}")
    bsz, h, w, c = y.shape
    vecs = [t.float().contiguous() for t in (b, p["scale"], p["bias"])]
    if any(v.shape != (c,) or v.device != y.device for v in vecs):
        raise ValueError(f"{what}: the conv bias and the norm's scale and bias must "
                         f"be ({c},) on {y.device}")
    if residual is not None and (residual.shape != y.shape or residual.dtype != y.dtype
                                 or residual.device != y.device
                                 or not residual.is_contiguous()):
        raise ValueError(f"{what}: the residual must be a contiguous "
                         f"{tuple(y.shape)} {y.dtype} tensor on {y.device}")
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    slices = _norm_slices(bsz, h * w, y.device)
    scratch = torch.empty(3 * bsz * slices * c + 2 * bsz * c, dtype=torch.float32,
                          device=y.device)
    lib = _lib("norm")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.dvf_instance_norm(
            y.data_ptr(), *(v.data_ptr() for v in vecs),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), bsz, h * w, c, slices, int(y.dtype == torch.bfloat16),
            int(relu), eps, stream)
    _count(lib, "dvf_instance_norm", "instance_norm", rc)
    return out


# -- the style nets' out stage: 9×9 conv, bias, tanh (csrc/outconv.cu) --

# The kernel's taps a side and output channels; the input channels it
# is compiled for: multiples of 16 up to the most whose halo tile fits a
# block's shared memory.
OUT_CONV_K, OUT_CONV_COUT = 9, 3
OUT_CONV_MAX_CIN = 64


def out_conv_takes(x_shape, w_shape) -> bool:
    """Whether csrc/outconv.cu computes the out stage of an NHWC input of
    ``x_shape`` by an HWIO weight of ``w_shape``: a 9×9 conv to 3 channels
    of 16·k ≤ OUT_CONV_MAX_CIN input channels, H and W at least 5 (the
    reflect-101 border of radius 4)."""
    if len(x_shape) != 4:
        return False
    _, h, w, c = x_shape
    return (tuple(w_shape) == (OUT_CONV_K, OUT_CONV_K, c, OUT_CONV_COUT)
            and c % 16 == 0 and 16 <= c <= OUT_CONV_MAX_CIN
            and h > OUT_CONV_K // 2 and w > OUT_CONV_K // 2)


def out_conv_tanh_cuda(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``models.layers.out_conv_tanh_plain`` in bf16 through
    csrc/outconv.cu: two launches (the weight packed, the conv) on the
    current stream, no synchronisation, counted once as ``out_conv``.
    Takes a contiguous, 16-byte aligned NHWC bf16 ``x`` on a CUDA device
    and ``p``'s HWIO weight (9, 9, Cin, 3) and bias (3,) (the kernel
    rounds both to bf16, as the plain ops do); returns (B, H, W, 3)
    float32. Raises on anything else (:func:`out_conv_takes`)."""
    what = "out_conv_tanh_cuda"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: takes a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: needs bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: needs a contiguous, 16-byte aligned NHWC tensor, got "
                         f"shape {tuple(x.shape)}")
    if not out_conv_takes(x.shape, p["w"].shape):
        raise ValueError(
            f"{what}: takes a (9, 9, Cin, 3) weight, Cin a multiple of 16 up to "
            f"{OUT_CONV_MAX_CIN}, and H, W >= 5; got {tuple(x.shape)} by "
            f"{tuple(p['w'].shape)}")
    bsz, h, w_, c = x.shape
    if bsz > 65535:
        raise ValueError(f"{what}: takes at most 65535 frames a launch, got {bsz}")
    wt = p["w"].to(device=x.device, dtype=torch.float32).contiguous()
    b = p["b"].to(device=x.device, dtype=torch.float32).contiguous()
    if b.shape != (OUT_CONV_COUT,):
        raise ValueError(f"{what}: the bias must be ({OUT_CONV_COUT},), got "
                         f"{tuple(b.shape)}")
    out = torch.empty((bsz, h, w_, OUT_CONV_COUT), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    # The weight packed as the MMAs' B fragments: 9 taps x Cin / 16 steps
    # x 5 tap pairs x 32 lanes x 8 bytes.
    frag = torch.empty(OUT_CONV_K * (c // 16) * 5 * 32 * 2, dtype=torch.int32,
                       device=x.device)
    lib = _lib("outconv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dvf_out_conv(x.data_ptr(), wt.data_ptr(), b.data_ptr(), frag.data_ptr(),
                              out.data_ptr(), bsz, h, w_, c, stream)
    _count(lib, "dvf_out_conv", "out_conv", rc)
    return out


# -- temporal-delta change detection (K5) -------------------------------


def tile_maxdiff_ref(a: torch.Tensor, b: torch.Tensor, tile: int = 32) -> torch.Tensor:
    """Plain version: per-tile max |a − b| of two uint8 NHWC batches,
    ``(B, H, W, C) × (B, H, W, C) → (B, ⌈H/tile⌉, ⌈W/tile⌉)`` uint8 (a 3-D
    frame pair gives one 2-D map). max − min keeps everything uint8;
    unaligned H/W are zero-padded, which can never mark a tile dirty."""
    if a.dim() == 3:
        return tile_maxdiff_ref(a[None], b[None], tile)[0]
    bsz, h, w, c = a.shape
    d = torch.maximum(a, b) - torch.minimum(a, b)
    nty, ntx = -(-h // tile), -(-w // tile)
    ph, pw = nty * tile - h, ntx * tile - w
    if ph or pw:
        d = F.pad(d, (0, 0, 0, pw, 0, ph))
    return d.reshape(bsz, nty, tile, ntx, tile, c).amax(dim=(2, 4, 5))


def tile_maxdiff_pallas(a: torch.Tensor, b: torch.Tensor, tile: int = 32) -> torch.Tensor:
    """Per-tile max |a − b| through ``csrc/codec.cu``'s kernel: one warp
    per tile, 16/4/1-byte chunks, every geometry and channel
    count (a ragged edge tile covers the pixels that exist, which is the
    plain version's zero pad). Bit-exact to :func:`tile_maxdiff_ref`."""
    tile = int(tile)
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tile_maxdiff_ref(a, b, tile)
    what = "tile_maxdiff_pallas"
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{what}: takes a and b both on one CUDA device or "
                         f"both on the CPU, got {a.device} and {b.device}")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError(f"{what}: needs uint8, got {a.dtype} and {b.dtype}")
    if a.shape != b.shape or a.dim() not in (3, 4):
        raise ValueError(f"{what}: needs two (B,H,W,C) or (H,W,C) batches of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: needs contiguous NHWC tensors")
    squeeze = a.dim() == 3
    a4, b4 = (a[None], b[None]) if squeeze else (a, b)
    bsz, h, w, c = a4.shape
    nty, ntx = -(-h // tile), -(-w // tile)
    out = torch.empty((bsz, nty, ntx), dtype=torch.uint8, device=a.device)
    if a4.numel():
        lib = _lib("codec")
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = lib.dvf_tile_maxdiff(a4.data_ptr(), b4.data_ptr(), out.data_ptr(),
                                      bsz, h, w, c, tile, stream)
        _count(lib, "dvf_tile_maxdiff", "tile_maxdiff", rc)
    return out[0] if squeeze else out


def tile_maxdiff(a: torch.Tensor, b: torch.Tensor, tile: int = 32) -> torch.Tensor:
    """Dispatch (the reference's name): the kernel takes every geometry,
    so a CUDA tensor always launches it; a CPU tensor runs the plain
    version."""
    return tile_maxdiff_pallas(a, b, tile)


# -- JPEG forward DCT + quantization (K6) -------------------------------

# Annex-K base tables (the ones libjpeg scales in jpeg_set_quality).
_JPEG_LUMA_BASE = (
    (16, 11, 10, 16, 24, 40, 51, 61),
    (12, 12, 14, 19, 26, 58, 60, 55),
    (14, 13, 16, 24, 40, 57, 69, 56),
    (14, 17, 22, 29, 51, 87, 80, 62),
    (18, 22, 37, 56, 68, 109, 103, 77),
    (24, 35, 55, 64, 81, 104, 113, 92),
    (49, 64, 78, 87, 103, 121, 120, 101),
    (72, 92, 95, 98, 112, 100, 103, 99),
)
_JPEG_CHROMA_BASE = (
    (17, 18, 24, 47, 99, 99, 99, 99),
    (18, 21, 26, 66, 99, 99, 99, 99),
    (24, 26, 56, 99, 99, 99, 99, 99),
    (47, 66, 99, 99, 99, 99, 99, 99),
) + ((99,) * 8,) * 4


def jpeg_quant_table(quality: int, chroma: bool = False) -> np.ndarray:
    """The (8, 8) table ``jpeg_set_quality(quality, force_baseline=TRUE)``
    installs (IJG scaling of the Annex-K base tables), int32, natural
    order. Quantizing with it lets the JPEG shim's entropy-only encode
    tell the decoder to multiply by the same table."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    base = np.asarray(_JPEG_CHROMA_BASE if chroma else _JPEG_LUMA_BASE, np.int64)
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)


def _dct8_matrix() -> np.ndarray:
    """D[u, x] = C(u)/2 · cos((2x+1)uπ/16), the orthonormal 8-point DCT-II
    (built in float64, kept as float32 constants)."""
    d = np.zeros((8, 8), np.float64)
    for u in range(8):
        cu = (1.0 / math.sqrt(2.0)) if u == 0 else 1.0
        for x in range(8):
            d[u, x] = 0.5 * cu * math.cos((2 * x + 1) * u * math.pi / 16.0)
    return d.astype(np.float32)


_DCT8 = _dct8_matrix()


def _qrecip(qtable) -> np.ndarray:
    """1/q in float64, rounded to float32, natural order (8, 8)."""
    return (1.0 / np.asarray(qtable, np.float64).reshape(8, 8)).astype(np.float32)


def dct8x8_quant_ref(plane: torch.Tensor, qtable) -> torch.Tensor:
    """Plain version: per-8×8-block forward DCT + quantization of a sample
    plane, ``(B, H, W) → (B, ⌈H/8⌉, ⌈W/8⌉, 8, 8)`` int16 (a 2-D plane
    gives one grid), natural order: level shift −128, D·X·Dᵀ, × the
    float32 reciprocal of ``qtable``, round half to even. Unaligned H/W
    are edge-padded (libjpeg's edge replication).

    Every product and sum is its own elementwise float32 operation, in the
    reference golden's order (``acc = D[u,0]·x0``, then ``acc + D[u,k]·xk``
    for k = 1..7; vertical pass, then horizontal), so no multiply-add is
    ever fused and the result is bit-identical to it — and to the kernel,
    which repeats the same sequence with ``__fmul_rn``/``__fadd_rn``."""
    if plane.dim() == 2:
        return dct8x8_quant_ref(plane[None], qtable)[0]
    b, h, w = plane.shape
    x = plane.to(torch.float32)
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        x = F.pad(x[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
    nby, nbx = (h + ph) // 8, (w + pw) // 8
    blocks = x.reshape(b, nby, 8, nbx, 8).permute(0, 1, 3, 2, 4)  # (b,by,bx,y,x)
    d = [[torch.tensor(float(_DCT8[u, k]), dtype=torch.float32, device=x.device)
          for k in range(8)] for u in range(8)]
    rows = [blocks[..., y, :] - 128.0 for y in range(8)]      # each (..., x)
    vert = []
    for u in range(8):
        acc = d[u][0] * rows[0]
        for y in range(1, 8):
            acc = acc + d[u][y] * rows[y]
        vert.append(acc)
    v = torch.stack(vert, dim=-2)                               # (..., v, x)
    horiz = []
    for u in range(8):
        acc = d[u][0] * v[..., 0]
        for k in range(1, 8):
            acc = acc + d[u][k] * v[..., k]
        horiz.append(acc)
    t = torch.stack(horiz, dim=-1)                              # (..., v, u)
    recip = torch.from_numpy(_qrecip(qtable)).to(x.device)
    return torch.round(t * recip).to(torch.int16)


def dct8x8_quant_planes_ref(planes, qtables) -> List[torch.Tensor]:
    """Plain version of :func:`dct8x8_quant_planes`: each plane through
    :func:`dct8x8_quant_ref` with its own table."""
    return [dct8x8_quant_ref(p, q) for p, q in zip(planes, qtables, strict=True)]


def dct8x8_quant_planes(planes, qtables) -> List[torch.Tensor]:
    """Per-8×8-block DCT + quantization of 1–3 planes (the wire's Y, Cb,
    Cr), each with its own table, in ONE launch of ``csrc/codec.cu``'s
    kernel: one lane per 8×8 block, both passes in registers in the
    golden's operation order without FMA, the planes' tasks in one list so
    the small planes fill the large one's tail. Reads uint8 or float32
    planes of any geometry (a partial block clamps its reads: the plain
    version's edge pad). All planes share a dtype and a batch size.
    Returns one ``(B, ⌈H/8⌉, ⌈W/8⌉, 8, 8)`` int16 tensor per plane,
    bit-exact to :func:`dct8x8_quant_planes_ref`."""
    planes, qtables = list(planes), list(qtables)
    what = "dct8x8_quant_planes"
    if not 1 <= len(planes) <= DCT_MAX_PLANES or len(qtables) != len(planes):
        raise ValueError(f"{what}: takes 1..{DCT_MAX_PLANES} planes and one table "
                         f"each, got {len(planes)} and {len(qtables)}")
    if all(p.device.type == "cpu" for p in planes):
        return dct8x8_quant_planes_ref(planes, qtables)
    dev = planes[0].device
    if dev.type != "cuda" or any(p.device != dev for p in planes):
        raise ValueError(f"{what}: takes planes all on one CUDA device or all on "
                         f"the CPU, got {[str(p.device) for p in planes]}")
    dtype = planes[0].dtype
    if dtype not in (torch.uint8, torch.float32) or any(p.dtype != dtype for p in planes):
        raise TypeError(f"{what}: needs uint8 or float32 planes of one dtype, got "
                        f"{[p.dtype for p in planes]}")
    dim = planes[0].dim()
    if dim not in (2, 3) or any(p.dim() != dim for p in planes):
        raise ValueError(f"{what}: needs (B,H,W) or (H,W) planes, got shapes "
                         f"{[tuple(p.shape) for p in planes]}")
    if dim == 3 and any(p.shape[0] != planes[0].shape[0] for p in planes):
        raise ValueError(f"{what}: needs planes of one batch size, got shapes "
                         f"{[tuple(p.shape) for p in planes]}")
    if not all(p.is_contiguous() for p in planes):
        raise ValueError(f"{what}: needs contiguous planes")
    p3 = [p[None] if dim == 2 else p for p in planes]
    outs = [torch.empty((p.shape[0], -(-p.shape[1] // 8), -(-p.shape[2] // 8), 8, 8),
                        dtype=torch.int16, device=dev) for p in p3]
    live = [i for i, p in enumerate(p3) if p.numel()]
    if live:
        lib = _lib("codec")
        n = len(live)
        src = (ctypes.c_void_p * n)(*[p3[i].data_ptr() for i in live])
        dst = (ctypes.c_void_p * n)(*[outs[i].data_ptr() for i in live])
        dims = (ctypes.c_int * (3 * n))(*[d for i in live for d in p3[i].shape])
        recip = _floats(np.concatenate([_qrecip(qtables[i]).reshape(-1)
                                        for i in live]).tolist())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.dvf_dct8x8_quant_planes(
                src, dst, dims, n, int(dtype == torch.uint8),
                _floats(_DCT8.reshape(-1).tolist()), recip, stream)
        _count(lib, "dvf_dct8x8_quant_planes", "dct8x8_quant", rc)
    return [o[0] for o in outs] if dim == 2 else outs


def dct8x8_quant_pallas(plane: torch.Tensor, qtable) -> torch.Tensor:
    """Per-8×8-block DCT + quantization of one plane through
    ``csrc/codec.cu``'s kernel (:func:`dct8x8_quant_planes` with one
    plane). Bit-exact to :func:`dct8x8_quant_ref`."""
    return dct8x8_quant_planes([plane], [qtable])[0]


def dct8x8_quant(plane: torch.Tensor, qtable) -> torch.Tensor:
    """Dispatch (the reference's name): the kernel takes every geometry,
    so a CUDA tensor always launches it; a CPU tensor runs the plain
    version."""
    return dct8x8_quant_pallas(plane, qtable)


@register_filter("gaussian_blur_pallas")
def gaussian_blur_pallas(ksize: int = 9, sigma: float = 0.0) -> Filter:
    """Separable Gaussian through the hand-written separable-blur kernel."""
    kern = gaussian_kernel_1d(ksize, sigma)

    def fn(batch: torch.Tensor) -> torch.Tensor:
        return sep_blur_nhwc_pallas(batch.contiguous(), kern, kern)

    return stateless(f"gaussian_blur_pallas(k={ksize},s={sigma})", fn,
                     halo=ksize // 2)


@register_filter("sobel_bilateral_pallas")
def sobel_bilateral_pallas(d: int = 5, sigma_color: float = 0.1,
                           sigma_space: float = 2.0,
                           magnitude_scale: float = 1.0) -> Filter:
    """BASELINE configs[2] in one hand-written kernel."""

    def fn(batch: torch.Tensor) -> torch.Tensor:
        return sobel_bilateral_nhwc_pallas(
            batch.contiguous(), d=d, sigma_color=sigma_color,
            sigma_space=sigma_space, magnitude_scale=magnitude_scale)

    return stateless(f"sobel_bilateral_pallas(d={d})", fn, halo=d // 2 + 1)


@register_filter("bilateral_pallas")
def bilateral_pallas(d: int = 5, sigma_color: float = 0.1,
                     sigma_space: float = 2.0) -> Filter:
    """Bilateral through the hand-written kernel."""

    def fn(batch: torch.Tensor) -> torch.Tensor:
        return bilateral_nhwc_pallas(batch.contiguous(), d=d,
                                     sigma_color=sigma_color,
                                     sigma_space=sigma_space)

    return stateless(
        f"bilateral_pallas(d={d},sc={sigma_color},ss={sigma_space})", fn,
        halo=d // 2)
