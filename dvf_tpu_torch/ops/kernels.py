"""Hand-written Hopper kernels for the stencil ops, the bounded warp and
the delta wire's codec assist, their wrappers and their registered
filters (port of ``dvf_tpu/ops/pallas_kernels.py``).

The names keep the reference's: ``*_pallas`` here denotes the CUDA C++
kernel in ``dvf_tpu_torch/csrc/`` (``stencils.cu``, ``warp.cu``,
``codec.cu``) that replaces the TPU's Pallas kernel of the same name.
Each wrapper dispatches on the tensor's device:

- a CUDA tensor launches the kernel on the current stream (no
  synchronisation) or raises — there is no fallback;
- a CPU tensor runs the kernel's plain torch version (the numerics
  reference the kernel is held to).

``LAUNCHES`` counts kernel launches per kernel, so a run can show that
its main path went through the kernels; CPU calls never count.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, List

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
                            "dct8x8_quant": 0}
_launch_lock = threading.Lock()

# Limits compiled into csrc/stencils.cu.
MAX_TAPS = 31
MAX_WIN = 15
MAX_C = 4
# Channels csrc/warp.cu takes (the inner warp runs on 5-channel stacks).
MAX_WARP_C = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)  # host float arrays (taps, weights)
# C entry points of each csrc/<source>.cu.
_SIGNATURES = {
    "stencils": {
        "dvf_sep_blur": [_P, _P, _I, _I, _I, _I, _FP, _I, _FP, _I, _P],
        "dvf_bilateral": [_P, _P, _I, _I, _I, _I, _I, _FP, _F, _P],
        "dvf_sobel_bilateral": [_P, _P, _I, _I, _I, _I, _I, _FP, _F, _F, _P],
    },
    "warp": {
        "dvf_warp_bounded": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "codec": {
        "dvf_tile_maxdiff": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "dvf_dct8x8_quant_u8": [_P, _P, _I, _I, _I, _FP, _FP, _P],
        "dvf_dct8x8_quant_f32": [_P, _P, _I, _I, _I, _FP, _FP, _P],
    },
}
_lib_objs: Dict[str, ctypes.CDLL] = {}


def _lib(source: str = "stencils") -> ctypes.CDLL:
    lib = _lib_objs.get(source)
    if lib is None:
        lib = _build.load(source)
        for fn, argtypes in _SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.dvf_error_string.argtypes = [ctypes.c_int]
        lib.dvf_error_string.restype = ctypes.c_char_p
        _lib_objs[source] = lib
    return lib


def reset_launches() -> None:
    """Set every launch counter to 0."""
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _floats(vals: List[float]):
    return (ctypes.c_float * len(vals))(*vals)


def _spatial_weights(r: int, sigma_space: float) -> List[float]:
    """The (2r+1)² spatial Gaussian, row-major, computed in double as the
    plain version does (the kernel receives the float32 roundings)."""
    return [math.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space * sigma_space))
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


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
    H-blurred intermediate stays in shared memory). Plain version:
    ``sep_conv2d(impl="shift")`` — same reflect-101 borders, same tap
    order."""
    th, tw = taps_f32(kh), taps_f32(kw)
    if len(th) % 2 != 1 or len(tw) % 2 != 1:
        raise ValueError(f"tap counts must be odd, got {len(th)} and {len(tw)}")
    if batch.device.type == "cpu":
        return sep_conv2d(batch, th, tw, impl="shift")
    if len(th) > MAX_TAPS or len(tw) > MAX_TAPS:
        raise ValueError(f"at most {MAX_TAPS} taps per axis, got {len(th)}, {len(tw)}")
    _check_cuda(batch, "sep_blur_nhwc_pallas", len(th) // 2, len(tw) // 2)
    return _launch("dvf_sep_blur", "sep_blur", batch,
                   _floats(th), len(th), _floats(tw), len(tw))


def bilateral_nhwc_pallas(batch: torch.Tensor, d: int = 5,
                          sigma_color: float = 0.1,
                          sigma_space: float = 2.0) -> torch.Tensor:
    """Bilateral over float NHWC in [0,1], the whole d×d window per thread
    from shared memory. Plain version: ``ops.bilateral.bilateral_nhwc``."""
    if d % 2 != 1:
        raise ValueError(f"window d must be odd, got {d}")
    if batch.device.type == "cpu":
        return bilateral_nhwc(batch, d=d, sigma_color=sigma_color,
                              sigma_space=sigma_space)
    if d > MAX_WIN:
        raise ValueError(f"window d must be at most {MAX_WIN}, got {d}")
    r = d // 2
    _check_cuda(batch, "bilateral_nhwc_pallas", r, r)
    return _launch("dvf_bilateral", "bilateral", batch, r,
                   _floats(_spatial_weights(r, sigma_space)),
                   1.0 / (2.0 * sigma_color * sigma_color))


def sobel_bilateral_nhwc_pallas(batch: torch.Tensor, d: int = 5,
                                sigma_color: float = 0.1,
                                sigma_space: float = 2.0,
                                magnitude_scale: float = 1.0) -> torch.Tensor:
    """Fused Sobel→bilateral over float NHWC in [0,1]: Rec.601 gray →
    Sobel magnitude × scale clipped to [0,1] → single-channel bilateral,
    broadcast to C channels; gray and magnitude never leave shared
    memory. Plain version: ``sobel_bilateral(impl="chain")``."""
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
    # The chain's bilateral sees the edge map broadcast to C channels, so
    # its range distance is C·Δ² of the single channel (the TPU kernel
    # hard-codes C = 3).
    c = batch.shape[-1]
    return _launch("dvf_sobel_bilateral", "sobel_bilateral", batch, r,
                   _floats(_spatial_weights(r, sigma_space)),
                   c / (2.0 * sigma_color * sigma_color), magnitude_scale)


def warp_bounded_pallas(img: torch.Tensor, flow: torch.Tensor,
                        max_disp: int = 4) -> torch.Tensor:
    """Backward-warp ``img`` (B,H,W,C) by ``flow`` (B,H,W,2; [...,0]=dx)
    with displacements clipped to ±``max_disp`` px and the sample point
    clamped to the frame: one gathering thread per output pixel
    (``csrc/warp.cu``). Plain version: ``warp_by_flow(img,
    flow.clamp(-max_disp, max_disp))``, which the kernel reproduces
    operation for operation."""
    r = int(max_disp)
    if r < 1:
        raise ValueError("max_disp must be >= 1")
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
                                  b, h, w, c, r, stream)
    _count(lib, "dvf_warp_bounded", "warp_bounded", rc)
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


def dct8x8_quant_pallas(plane: torch.Tensor, qtable) -> torch.Tensor:
    """Per-8×8-block DCT + quantization through ``csrc/codec.cu``'s kernel:
    a strip of 32 blocks per 256-thread block, one pixel column per thread
    in the vertical pass and one block row in the horizontal pass, the
    golden's operation order without FMA. Reads uint8 or float32 planes
    of any geometry (a partial block clamps its reads: the plain
    version's edge pad). Bit-exact to :func:`dct8x8_quant_ref`."""
    if plane.device.type == "cpu":
        return dct8x8_quant_ref(plane, qtable)
    what = "dct8x8_quant_pallas"
    if plane.device.type != "cuda":
        raise ValueError(f"{what}: takes a CUDA or CPU tensor, got {plane.device}")
    if plane.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"{what}: needs a uint8 or float32 plane, got {plane.dtype}")
    if plane.dim() not in (2, 3):
        raise ValueError(f"{what}: needs a (B,H,W) or (H,W) plane, got shape "
                         f"{tuple(plane.shape)}")
    if not plane.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous plane")
    squeeze = plane.dim() == 2
    p3 = plane[None] if squeeze else plane
    b, h, w = p3.shape
    out = torch.empty((b, -(-h // 8), -(-w // 8), 8, 8), dtype=torch.int16,
                      device=plane.device)
    if p3.numel():
        lib = _lib("codec")
        fn = ("dvf_dct8x8_quant_u8" if plane.dtype == torch.uint8
              else "dvf_dct8x8_quant_f32")
        dct = _floats(_DCT8.reshape(-1).tolist())
        recip = _floats(_qrecip(qtable).reshape(-1).tolist())
        with torch.cuda.device(plane.device):
            stream = torch.cuda.current_stream(plane.device).cuda_stream
            rc = getattr(lib, fn)(p3.data_ptr(), out.data_ptr(), b, h, w, dct,
                                  recip, stream)
        _count(lib, fn, "dct8x8_quant", rc)
    return out[0] if squeeze else out


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
