"""Hand-written Hopper kernels for the stencil ops and the bounded warp,
their wrappers and their registered filters (port of
``dvf_tpu/ops/pallas_kernels.py``'s stencil and warp kernels).

The names keep the reference's: ``*_pallas`` here denotes the CUDA C++
kernel in ``dvf_tpu_torch/csrc/`` (``stencils.cu``, ``warp.cu``) that
replaces the TPU's Pallas kernel of the same name. Each wrapper
dispatches on the tensor's device:

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

import torch

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.ops import _build
from dvf_tpu_torch.ops.bilateral import bilateral_nhwc
from dvf_tpu_torch.ops.conv import Taps, gaussian_kernel_1d, sep_conv2d, taps_f32
from dvf_tpu_torch.ops.flow import warp_by_flow
from dvf_tpu_torch.ops.registry import get_filter, register_filter

LAUNCHES: Dict[str, int] = {"sep_blur": 0, "bilateral": 0, "sobel_bilateral": 0,
                            "warp_bounded": 0}
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
