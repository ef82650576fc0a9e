"""JPEG codec shims and the temporal-delta wire (port of the parts of
``dvf_tpu/transport/codec.py`` the delta-wire worker uses).

- :class:`NativeJpegCodec` — the port's copy of ``jpeg_shim.cpp`` over
  libjpeg, bound with ``ctypes.CDLL`` so the GIL is released for the
  milliseconds each frame spends in C. Decode writes scanlines straight
  into rows of the caller's staging array.
- :class:`DeltaCodec` — the framed temporal-delta wire over an inner
  full-frame codec, with the coefficient path (device-quantized DCT
  blocks, entropy-coded on the host) that the full codec assist feeds.
- :class:`RawCodec` — the raw full-frame inner codec.
- :class:`JpegCodec` — the cv2 codec (its imencode/imdecode release the
  GIL inside libjpeg), for callers that ask for it by name.

:func:`make_codec` builds only the native codec and raises where the
shim cannot be built: it never falls back to cv2 on its own, so a failed
native build cannot quietly change the codec under the port's wire. The
wire bytes are the JAX package's, byte for byte.
:func:`measure_codec_fps` and :func:`jpeg_wire_budget` size a wire at one
geometry from this host's codec rates.
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch


class JpegGeometryError(ValueError):
    """The JPEG's dims differ from the caller's staging geometry — a
    re-stageable condition (the stream changed size), distinct from a
    corrupt stream, so callers can retry exactly this case."""


class JpegCodec:
    """The cv2 codec (copy of the JAX package's): the same interface as
    :class:`NativeJpegCodec`; batch decode copies into the staging
    array. cv2 is imported when the codec is built, not with the module."""

    def __init__(self, quality: int = 90, threads: int = 4,
                 assist: str = "none"):
        try:
            import cv2
        except ImportError as e:
            raise ImportError("JpegCodec needs cv2") from e
        self._cv2 = cv2
        self.quality = int(quality)
        self.assist = str(assist)
        self.pool = ThreadPoolExecutor(max_workers=threads, thread_name_prefix="dvf-jpeg")

    def encode(self, frame_rgb: np.ndarray) -> bytes:
        cv2 = self._cv2
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, self.quality])
        if not ok:
            raise ValueError("JPEG encode failed")
        return buf.tobytes()

    def decode(self, data: bytes) -> np.ndarray:
        cv2 = self._cv2
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("JPEG decode failed")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def probe(self, data: bytes):
        """(height, width) of a JPEG blob. cv2 has no header-only path,
        so this decodes."""
        h, w = self.decode(data).shape[:2]
        return h, w

    def encode_batch(self, frames: Sequence[np.ndarray]) -> List[bytes]:
        return list(self.pool.map(self.encode, frames))

    def encode_batch_async(self, frames: Sequence[np.ndarray]) -> list:
        """``[Future[bytes], …]`` in frame order (the codec plane's entry)."""
        return [self.pool.submit(self.encode, f) for f in frames]

    def decode_batch(self, blobs: Sequence[bytes],
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode into a stacked (N, H, W, 3) uint8 array (``out`` if
        given: the staging buffer)."""
        frames = list(self.pool.map(self.decode, blobs))
        if out is None:
            return np.stack(frames)
        for i, f in enumerate(frames):
            if f.shape != out[i].shape:
                raise JpegGeometryError(
                    f"JPEG is {f.shape[0]}x{f.shape[1]}, staging row is "
                    f"{out[i].shape[0]}x{out[i].shape[1]}")
            out[i] = f
        return out

    def config(self) -> dict:
        return {"backend": "cv2", "wire": "jpeg", "quality": self.quality,
                "threads": self.pool._max_workers, "assist": self.assist}

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


# -- native (jpeg_shim.cpp) ---------------------------------------------

_SHIM_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "jpeg_shim.cpp")
_shim_lock = threading.Lock()
_shim: Optional[ctypes.CDLL] = None
_shim_error: Optional[str] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_c_int, _c_long, _c_ulong = ctypes.c_int, ctypes.c_long, ctypes.c_ulong
_SHIM_SIGNATURES = {
    "dvf_jpeg_probe": (_c_int, [ctypes.c_char_p, _c_ulong,
                                ctypes.POINTER(_c_int), ctypes.POINTER(_c_int)]),
    "dvf_jpeg_decode": (_c_int, [ctypes.c_char_p, _c_ulong, _u8p, _c_int, _c_int,
                                 ctypes.POINTER(_c_int), ctypes.POINTER(_c_int)]),
    "dvf_jpeg_encode": (_c_long, [_u8p, _c_int, _c_int, _c_int, _u8p, _c_ulong]),
    # entropy path from YCbCr 4:2:0 planes converted on the device
    "dvf_jpeg_encode_ycbcr420": (_c_long, [_u8p, _u8p, _u8p, _c_int, _c_int,
                                           _c_int, _u8p, _c_ulong]),
    # entropy coding only, from device-quantized DCT coefficient blocks
    "dvf_jpeg_encode_coefficients": (_c_long, [_i16p, _i16p, _i16p, _c_int,
                                               _c_int, _c_int, _u8p, _c_ulong]),
    # N same-geometry tiles in one call (the delta wire's dirty tiles)
    "dvf_jpeg_encode_coefficients_batch": (
        _c_long, [_i16p, _i16p, _i16p, _c_int, _c_int, _c_int, _c_int, _u8p,
                  _c_ulong, ctypes.POINTER(ctypes.c_uint32)]),
}


def _load_shim() -> ctypes.CDLL:
    """Build (g++, ``-ljpeg``, into ``dvf_tpu_torch/_build/``) and load the
    shim at first use. Raises on failure; the failure is sticky so every
    caller gets the same fast answer."""
    global _shim, _shim_error
    if _shim is not None:
        return _shim
    with _shim_lock:
        if _shim is not None:
            return _shim
        if _shim_error is not None:
            raise RuntimeError(_shim_error)
        from dvf_tpu_torch.transport._native import load_native

        try:
            # CDLL (GIL released): each call is milliseconds of libjpeg
            # work that the thread pool should truly run in parallel.
            lib = load_native(_SHIM_SRC, extra_flags=["-ljpeg"])
        except (RuntimeError, OSError) as e:  # toolchain or libjpeg missing
            _shim_error = f"jpeg_shim build failed: {e}"
            raise RuntimeError(_shim_error) from e
        for name, (restype, argtypes) in _SHIM_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _shim = lib
    return _shim


class NativeJpegCodec:
    """C++ libjpeg codec (SURVEY.md §2b): zero-copy decode into the
    host staging array the engine copies to the card."""

    def __init__(self, quality: int = 90, threads: int = 4,
                 assist: str = "none"):
        self._lib = _load_shim()
        self.quality = int(quality)
        self.assist = str(assist)
        self.pool = ThreadPoolExecutor(max_workers=threads, thread_name_prefix="dvf-jpeg")
        self._tls = threading.local()  # per-thread encode scratch

    # -- single frame ---------------------------------------------------

    def encode(self, frame_rgb: np.ndarray) -> bytes:
        frame_rgb = np.ascontiguousarray(frame_rgb, dtype=np.uint8)
        h, w = frame_rgb.shape[:2]
        cap = h * w * 3 + 4096  # raw size + header slack: never reallocs
        scratch = getattr(self._tls, "scratch", None)
        if scratch is None or len(scratch) < cap:
            scratch = (ctypes.c_uint8 * cap)()
            self._tls.scratch = scratch
        n = self._lib.dvf_jpeg_encode(
            frame_rgb.ctypes.data_as(_u8p), h, w, self.quality, scratch, len(scratch)
        )
        if n < 0:
            # Shim reports -needed: a pathological high-entropy frame beat
            # the raw-size+slack estimate. Grow once and retry.
            scratch = (ctypes.c_uint8 * (-int(n)))()
            self._tls.scratch = scratch
            n = self._lib.dvf_jpeg_encode(
                frame_rgb.ctypes.data_as(_u8p), h, w, self.quality, scratch, len(scratch)
            )
        if n <= 0:
            raise ValueError(f"JPEG encode failed (rc={n})")
        return bytes(memoryview(scratch)[: int(n)])

    def decode_into(self, data: bytes, out: np.ndarray) -> None:
        """Decode straight into ``out`` (H, W, 3) uint8, typically one row
        of the staging batch. Raises on dims mismatch — the wire contract
        is fixed-geometry frames (reference inverter.py:34 hardcodes its
        raw geometry the same way)."""
        if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
            # The C shim writes h*w*3 contiguous bytes from the base
            # pointer — a strided view would be silently corrupted.
            raise ValueError("decode_into needs a C-contiguous uint8 buffer")
        h, w = out.shape[:2]
        gh, gw = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.dvf_jpeg_decode(
            data, len(data), out.ctypes.data_as(_u8p), h, w,
            ctypes.byref(gh), ctypes.byref(gw),
        )
        if rc == 1:
            raise JpegGeometryError(
                f"JPEG is {gh.value}x{gw.value}, staging row is {h}x{w}"
            )
        if rc != 0:
            raise ValueError("JPEG decode failed (corrupt stream)")

    def probe(self, data: bytes):
        """(height, width) from the JPEG header — no pixel decode."""
        h, w = ctypes.c_int(), ctypes.c_int()
        if self._lib.dvf_jpeg_probe(data, len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
            raise ValueError("JPEG decode failed (bad header)")
        return h.value, w.value

    def decode(self, data: bytes) -> np.ndarray:
        h, w = self.probe(data)
        out = np.empty((h, w, 3), np.uint8)
        self.decode_into(data, out)
        return out

    # -- batched (thread-parallel, GIL released per C call) -------------

    def encode_batch(self, frames: Sequence[np.ndarray]) -> List[bytes]:
        return list(self.pool.map(self.encode, frames))

    def encode_batch_async(self, frames: Sequence[np.ndarray]) -> list:
        """Submit each frame to the pool; returns ``[Future[bytes], …]``
        in frame order — the asynchronous codec plane's entry point
        (runtime/egress.py)."""
        return [self.pool.submit(self.encode, f) for f in frames]

    def decode_batch(
        self, blobs: Sequence[bytes], out: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Decode into a stacked (N, H, W, 3) uint8 array. With ``out``
        (the staging buffer the engine copies to the card) every frame is written
        in place by the C shim — the zero-copy path."""
        if out is None:
            h, w = self.probe(blobs[0])
            out = np.empty((len(blobs), h, w, 3), np.uint8)
        list(self.pool.map(self.decode_into, blobs, [out[i] for i in range(len(blobs))]))
        return out

    def config(self) -> dict:
        """Codec provenance for bench JSON (backend/wire/quality/threads/
        assist — ``assist`` names which device stage fed this codec:
        ``none`` / ``ycbcr`` / ``full-transform``, so bench rows are
        attributable to the path that produced them)."""
        return {"backend": "native", "wire": "jpeg", "quality": self.quality,
                "threads": self.pool._max_workers, "assist": self.assist}

    # -- codec assist (device-converted YCbCr 4:2:0 planes) -------------

    def encode_ycbcr420(self, y: np.ndarray, cb: np.ndarray,
                        cr: np.ndarray) -> bytes:
        """Entropy-path encode from PRE-CONVERTED planes: the device
        already did RGB→YCbCr and the 2×2 chroma subsample
        (runtime/codec_assist.py), so the host skips libjpeg's color
        convert + downsample passes and starts from half the bytes —
        DCT + quantization + Huffman only (jpeg_write_raw_data).

        ``y`` is (H, W) uint8, ``cb``/``cr`` are (H//2, W//2) uint8 (H
        and W even — the device stage pads). Decodes with the ordinary
        JPEG decoder on any peer.
        """
        y = np.ascontiguousarray(y, dtype=np.uint8)
        cb = np.ascontiguousarray(cb, dtype=np.uint8)
        cr = np.ascontiguousarray(cr, dtype=np.uint8)
        h, w = y.shape
        if h % 2 or w % 2 or cb.shape != (h // 2, w // 2) \
                or cr.shape != (h // 2, w // 2):
            raise ValueError(
                f"ycbcr420 planes inconsistent: y {y.shape}, cb {cb.shape}, "
                f"cr {cr.shape} (H and W must be even)")
        cap = h * w * 3 + 4096
        scratch = getattr(self._tls, "scratch", None)
        if scratch is None or len(scratch) < cap:
            scratch = (ctypes.c_uint8 * cap)()
            self._tls.scratch = scratch
        n = self._lib.dvf_jpeg_encode_ycbcr420(
            y.ctypes.data_as(_u8p), cb.ctypes.data_as(_u8p),
            cr.ctypes.data_as(_u8p), h, w, self.quality, scratch,
            len(scratch))
        if n <= 0:
            raise ValueError(f"JPEG ycbcr420 encode failed (rc={n})")
        return bytes(memoryview(scratch)[: int(n)])

    def encode_coefficients(self, yq: np.ndarray, cbq: np.ndarray,
                            crq: np.ndarray, h: int, w: int) -> bytes:
        """Entropy-only encode from PRE-QUANTIZED DCT coefficient blocks
        (the full-transform assist: the device already ran level shift,
        8×8 forward DCT, and quantization — ops.kernels.dct8x8_quant
        with jpeg_quant_table(self.quality)): the host does Huffman
        coding and nothing else (jpeg_write_coefficients).

        ``yq`` is (⌈h/8⌉, ⌈w/8⌉, 8, 8) int16, ``cbq``/``crq`` are
        (⌈h/16⌉, ⌈w/16⌉, 8, 8) int16 (4:2:0), blocks in natural
        (row-major frequency) order. H and W must be even. The device
        MUST have quantized with the same quality's IJG tables —
        jpeg_quant_table mirrors jpeg_set_quality exactly, and the
        decoded result is held against the host libjpeg path by the
        tests."""
        yq = np.ascontiguousarray(yq, dtype=np.int16)
        cbq = np.ascontiguousarray(cbq, dtype=np.int16)
        crq = np.ascontiguousarray(crq, dtype=np.int16)
        if h % 2 or w % 2 or h <= 0 or w <= 0:
            raise ValueError(f"coefficient encode needs even dims, got {h}x{w}")
        nby, nbx = -(-h // 8), -(-w // 8)
        ncy, ncx = -(-h // 16), -(-w // 16)
        if (yq.shape != (nby, nbx, 8, 8) or cbq.shape != (ncy, ncx, 8, 8)
                or crq.shape != (ncy, ncx, 8, 8)):
            raise ValueError(
                f"coefficient grids inconsistent with {h}x{w}: y {yq.shape} "
                f"(want {(nby, nbx, 8, 8)}), cb {cbq.shape} / cr {crq.shape} "
                f"(want {(ncy, ncx, 8, 8)})")
        cap = h * w * 3 + 4096
        scratch = getattr(self._tls, "scratch", None)
        if scratch is None or len(scratch) < cap:
            scratch = (ctypes.c_uint8 * cap)()
            self._tls.scratch = scratch
        n = self._lib.dvf_jpeg_encode_coefficients(
            yq.ctypes.data_as(_i16p), cbq.ctypes.data_as(_i16p),
            crq.ctypes.data_as(_i16p), h, w, self.quality, scratch,
            len(scratch))
        if n < 0 and n != -1:
            scratch = (ctypes.c_uint8 * (-int(n)))()
            self._tls.scratch = scratch
            n = self._lib.dvf_jpeg_encode_coefficients(
                yq.ctypes.data_as(_i16p), cbq.ctypes.data_as(_i16p),
                crq.ctypes.data_as(_i16p), h, w, self.quality, scratch,
                len(scratch))
        if n <= 0:
            raise ValueError(f"JPEG coefficient encode failed (rc={n})")
        return bytes(memoryview(scratch)[: int(n)])

    def encode_coefficients_batch(self, yqs: np.ndarray, cbqs: np.ndarray,
                                  crqs: np.ndarray, h: int,
                                  w: int) -> list:
        """Entropy-only encode of N same-geometry coefficient images in
        ONE native call — the delta wire's dirty-tile hot path: per-call
        setup outweighs the Huffman work of one small tile, so batching a
        frame's dirty tiles makes the host's entropy stage scale with
        dirty BLOCKS, not dirty TILES. ``yqs`` is (N, ⌈h/8⌉, ⌈w/8⌉, 8, 8) int16,
        ``cbqs``/``crqs`` (N, ⌈h/16⌉, ⌈w/16⌉, 8, 8); returns N payload
        ``bytes``, each decodable exactly like the single entry's."""
        yqs = np.ascontiguousarray(yqs, dtype=np.int16)
        cbqs = np.ascontiguousarray(cbqs, dtype=np.int16)
        crqs = np.ascontiguousarray(crqs, dtype=np.int16)
        if h % 2 or w % 2 or h <= 0 or w <= 0:
            raise ValueError(f"coefficient encode needs even dims, "
                             f"got {h}x{w}")
        n = yqs.shape[0]
        if n == 0:
            return []
        nby, nbx = -(-h // 8), -(-w // 8)
        ncy, ncx = -(-h // 16), -(-w // 16)
        if (yqs.shape != (n, nby, nbx, 8, 8)
                or cbqs.shape != (n, ncy, ncx, 8, 8)
                or crqs.shape != (n, ncy, ncx, 8, 8)):
            raise ValueError(
                f"coefficient grids inconsistent with {n}x{h}x{w}: "
                f"y {yqs.shape} (want {(n, nby, nbx, 8, 8)}), "
                f"cb {cbqs.shape} / cr {crqs.shape} "
                f"(want {(n, ncy, ncx, 8, 8)})")
        cap = n * (h * w * 3 + 4096)
        scratch = getattr(self._tls, "batch_scratch", None)
        if scratch is None or len(scratch) < cap:
            scratch = (ctypes.c_uint8 * cap)()
            self._tls.batch_scratch = scratch
        sizes = (ctypes.c_uint32 * n)()
        total = self._lib.dvf_jpeg_encode_coefficients_batch(
            yqs.ctypes.data_as(_i16p), cbqs.ctypes.data_as(_i16p),
            crqs.ctypes.data_as(_i16p), n, h, w, self.quality, scratch,
            len(scratch), sizes)
        if total < -1:
            scratch = (ctypes.c_uint8 * (-int(total)))()
            self._tls.batch_scratch = scratch
            total = self._lib.dvf_jpeg_encode_coefficients_batch(
                yqs.ctypes.data_as(_i16p), cbqs.ctypes.data_as(_i16p),
                crqs.ctypes.data_as(_i16p), n, h, w, self.quality,
                scratch, len(scratch), sizes)
        if total <= 0:
            raise ValueError(
                f"batched JPEG coefficient encode failed (rc={total})")
        view = memoryview(scratch)
        out, off = [], 0
        for i in range(n):
            sz = int(sizes[i])
            out.append(bytes(view[off: off + sz]))
            off += sz
        return out

    def close(self) -> None:
        # Join the pool: leaked codec threads accumulate across codec
        # churn; cancel_futures keeps the join bounded.
        self.pool.shutdown(wait=True, cancel_futures=True)


def make_codec(quality: int = 90, threads: int = 4, assist: str = "none"):
    """The production constructor: the native C++ codec. Raises when the
    shim cannot be built (no g++ or no libjpeg): the port has no cv2
    fallback."""
    return NativeJpegCodec(quality=quality, threads=threads, assist=assist)


def measure_codec_fps(height: int, width: int, samples: int = 8,
                      quality: int = 90, mode: str = "cycle",
                      threads: int = 4):
    """Host codec throughput at this geometry (~0.1–0.3 s): ``(encode_fps,
    decode_fps)`` on a noise frame (worst-case entropy).

    - ``mode="cycle"``: one encode (or decode) start to finish on one
      thread — what a latency model adds to a frame's path, and what the
      wire budget multiplies by usable cores.
    - ``mode="pool"``: aggregate throughput of a ``threads``-wide pool
      driven with a full batch — what a pool-sizing decision compares.

    The codec is :func:`make_codec`'s native one, which raises where the
    shim cannot be built."""
    if mode not in ("cycle", "pool"):
        raise ValueError(f"mode must be 'cycle' or 'pool', got {mode!r}")
    codec = make_codec(quality=quality,
                       threads=1 if mode == "cycle" else threads)
    try:
        rng = np.random.default_rng(0)
        frame = rng.integers(0, 255, size=(height, width, 3), dtype=np.uint8)
        blob = codec.encode(frame)  # warm
        if mode == "pool":
            nb = max(2, threads)
            frames = [frame] * nb
            blobs = [blob] * nb
            staging = np.empty((nb, height, width, 3), np.uint8)
            codec.encode_batch(frames)
            codec.decode_batch(blobs, out=staging)
            t0 = time.perf_counter()
            for _ in range(samples):
                codec.encode_batch(frames)
            enc_s = (time.perf_counter() - t0) / (samples * nb)
            t0 = time.perf_counter()
            for _ in range(samples):
                codec.decode_batch(blobs, out=staging)
            dec_s = (time.perf_counter() - t0) / (samples * nb)
            return 1.0 / max(enc_s, 1e-9), 1.0 / max(dec_s, 1e-9)
        out = np.empty((height, width, 3), np.uint8)
        codec.decode_into(blob, out)  # warm
        t0 = time.perf_counter()
        for _ in range(samples):
            codec.encode(frame)
        enc_s = (time.perf_counter() - t0) / samples
        t0 = time.perf_counter()
        for _ in range(samples):
            codec.decode_into(blob, out)
        dec_s = (time.perf_counter() - t0) / samples
        return 1.0 / max(enc_s, 1e-9), 1.0 / max(dec_s, 1e-9)
    finally:
        codec.close()


def jpeg_wire_budget(height: int, width: int, quality: int = 90,
                     threads: Optional[int] = None,
                     overlap_depth: int = 1,
                     expected_dirty_ratio: Optional[float] = None,
                     keyframe_interval: int = 16) -> dict:
    """Host-codec budget for the wire at one frame geometry (the JAX
    package's model). With both legs on this host the sustainable rate is
    ``workers / (encode_s + decode_s)``, ``workers = min(cores, threads)``:
    ``capacity_fps``; ``decode_only_capacity_fps`` when only decode is
    local. Per-core rates are :func:`measure_codec_fps` ``"cycle"``
    numbers.

    ``overlap_depth`` ≥ 1 (the egress codec plane's in-flight window)
    hides encode under the next batch's decode on a host with two or more
    cores: ``overlapped_capacity_fps = workers / max(enc_s, dec_s)``.
    ``expected_dirty_ratio`` (the delta wire) prices a delta frame at the
    dirty share of a full cycle, plus a change-detection pass modelled as
    10 % of a decode, plus one full cycle per ``keyframe_interval``:
    ``delta_capacity_fps``. ``wire_mode`` recommends ``"delta"`` when that
    beats full-frame JPEG by more than 1.2×, else ``"jpeg"``."""
    enc_fps, dec_fps = measure_codec_fps(height, width, quality=quality,
                                         mode="cycle")
    cores = os.cpu_count() or 1
    workers = min(cores, threads) if threads else cores
    enc_s, dec_s = 1.0 / enc_fps, 1.0 / dec_fps
    per_frame_s = enc_s + dec_s
    capacity = workers / per_frame_s
    out = {
        "per_core_encode_fps": round(enc_fps, 1),
        "per_core_decode_fps": round(dec_fps, 1),
        "cores": cores,
        "codec_workers": workers,
        "capacity_fps": round(capacity, 1),
        "decode_only_capacity_fps": round(workers * dec_fps, 1),
        "overlap_depth": overlap_depth,
    }
    if overlap_depth >= 1 and cores >= 2:
        out["overlapped_capacity_fps"] = round(workers / max(enc_s, dec_s), 1)
    else:
        out["overlapped_capacity_fps"] = out["capacity_fps"]
    wire_mode = "jpeg"
    if expected_dirty_ratio is not None:
        r = min(1.0, max(0.0, float(expected_dirty_ratio)))
        delta_s = (r * per_frame_s + 0.1 * dec_s
                   + per_frame_s / max(1, keyframe_interval))
        out["expected_dirty_ratio"] = r
        out["delta_capacity_fps"] = round(workers / delta_s, 1)
        if out["delta_capacity_fps"] > 1.2 * out["capacity_fps"]:
            wire_mode = "delta"
    out["wire_mode"] = wire_mode
    return out


# -- temporal-delta wire ------------------------------------------------
#
# Every full-frame delivery pays the whole host JPEG cycle per frame even
# when almost nothing in the frame changed. DeltaCodec shrinks the work
# the host codec does: encode only the tiles
# whose pixels changed since the last shipped state, composite on the
# decoder's cached previous frame. For webcam-like streams (a moving
# subject on a static scene) this cuts encode bytes and host-codec CPU
# by roughly the dirty ratio — an order of magnitude at typical motion.

WIRE_MODES = ("raw", "jpeg", "delta")

DELTA_MAGIC = b"\xd6W"
DELTA_VERSION = 1
_DELTA_FLAG_KEY = 0x01
_DELTA_FLAG_LOSSLESS = 0x02
# <magic(2) ver(1) flags(1) seq(u32) h(u16) w(u16) tile(u16) pad(2)>
_DELTA_HEADER = struct.Struct("<2sBBIHHHxx")


class DeltaWireError(ValueError):
    """Framing violation on the delta wire (truncated tile payload, bad
    header, inconsistent lengths) — a WIRE fault, not a pixel-decode
    fault, so transports classify it under the ``transport`` kind and
    the error budget degrades the delta path back to full-frame mode."""


class DeltaResyncError(DeltaWireError):
    """The decoder cannot reconstruct this delta frame (reference lost:
    sequence gap from a dropped frame, or no keyframe seen yet). The
    caller's recovery is a keyframe: in-process pairs call the encoder's
    :meth:`DeltaCodec.force_keyframe`; one-way wires drop until the next
    scheduled keyframe lands (bounded by ``keyframe_interval``)."""


def tile_grid(height: int, width: int, tile: int):
    """((n_tiles_y, n_tiles_x), bitmap_bytes) for one geometry."""
    nty = -(-height // tile)
    ntx = -(-width // tile)
    return (nty, ntx), (nty * ntx + 7) // 8


def host_tile_maxdiff(a: np.ndarray, b: np.ndarray, tile: int,
                      scratch: Optional[tuple] = None) -> np.ndarray:
    """Per-tile max-abs-diff of two (H, W, 3) uint8 frames — the host
    mirror of the device-side reduction (ops.kernels.tile_maxdiff
    / runtime.codec_assist.DeviceDeltaProbe). Pure uint8 arithmetic
    (max − min), no float casts; ``scratch`` is an optional pair of
    preallocated (H, W, 3) uint8 buffers so the steady-state encode loop
    allocates nothing frame-sized."""
    h, w = a.shape[:2]
    (nty, ntx), _ = tile_grid(h, w, tile)
    if scratch is None:
        s1 = np.empty_like(a)
        s2 = np.empty_like(a)
    else:
        s1, s2 = scratch
    np.maximum(a, b, out=s1)
    np.minimum(a, b, out=s2)
    np.subtract(s1, s2, out=s1)  # |a - b| without leaving uint8
    out = np.zeros((nty, ntx), np.uint8)
    ha, wa = (h // tile) * tile, (w // tile) * tile
    if ha and wa:  # aligned interior: one vectorized reshape-reduce
        # (tile·3) folded into one axis: same reduction, one fewer numpy
        # reduce axis — measurably faster at 1080p.
        out[: h // tile, : w // tile] = (
            s1[:ha, :wa].reshape(h // tile, tile, w // tile, tile * 3)
            .max(axis=(1, 3)))
    if wa < w:  # right edge strip
        out[: h // tile, -1] = np.maximum(
            out[: h // tile, -1],
            s1[:ha, wa:].reshape(h // tile, tile, -1).max(axis=(1, 2)))
    if ha < h:  # bottom edge strip (includes the corner tile)
        rows = s1[ha:]
        for j in range(ntx):
            out[-1, j] = rows[:, j * tile: (j + 1) * tile].max(initial=0)
    return out


def host_tile_changed(a: np.ndarray, b: np.ndarray, tile: int,
                      scratch: Optional[tuple] = None) -> np.ndarray:
    """Per-tile CHANGED bitmap (bool) for the ``delta_threshold=0`` case:
    pure equality, so the bytes can be compared eight at a time as
    uint64 words — 2× the max-abs-diff reduction, and the common
    (lossless) path pays it every frame. Falls back to the magnitude
    reduction when the geometry doesn't word-align; ``scratch`` (the
    encoder's preallocated frame-sized pair) keeps that fallback — e.g.
    1080p at tile 32, where H doesn't tile — off the allocator on the
    per-frame hot path."""
    h, w = a.shape[:2]
    if (h % tile == 0 and w % tile == 0 and (tile * 3) % 8 == 0
            and a.flags["C_CONTIGUOUS"] and b.flags["C_CONTIGUOUS"]):
        nty, ntx, k = h // tile, w // tile, tile * 3 // 8
        av = a.reshape(h, w * 3).view(np.uint64).reshape(nty, tile, ntx, k)
        bv = b.reshape(h, w * 3).view(np.uint64).reshape(nty, tile, ntx, k)
        return (av != bv).any(axis=(1, 3))
    return host_tile_maxdiff(a, b, tile, scratch=scratch) > 0


class CoefficientFrame:
    """Quantized DCT coefficients for ONE frame, left where the fused
    device pass wrote them — the lazy D2H handle the full-transform assist
    hands to :class:`DeltaCodec`.

    Layout is grouped by DELTA tile (not by 8×8 block row), so one dirty
    tile is one contiguous slice and the only coefficients that ever cross
    D2H are the dirty tiles'::

        yq        (nty, ntx, t/8,  t/8,  8, 8) int16
        cbq, crq  (nty, ntx, t/16, t/16, 8, 8) int16   (4:2:0)

    where ``t`` is the delta tile (a multiple of 16 so chroma blocks never
    straddle a tile). The planes are torch tensors (on the card in
    production, on the CPU in tests) or numpy arrays. ``stream`` is the
    CUDA stream that produced them: the gathers run on it, so the encode
    thread that calls :meth:`fetch_dirty` reads them only after that
    stream's earlier work. Nothing is fetched until :meth:`fetch_dirty` /
    :meth:`frame_blocks`, and ``d2h_bytes`` counts exactly what was."""

    def __init__(self, yq, cbq, crq, h: int, w: int, tile: int,
                 quality: int, stream=None):
        if tile % 16 or h % tile or w % tile:
            raise ValueError(
                f"coefficient frames need tile % 16 == 0 and H, W "
                f"multiples of the tile; got {h}x{w} at tile {tile}")
        self.yq, self.cbq, self.crq = yq, cbq, crq
        self.h, self.w, self.tile = int(h), int(w), int(tile)
        self.quality = int(quality)
        self.stream = stream
        self.d2h_bytes = 0
        nty, ntx = h // tile, w // tile
        bt, ct = tile // 8, tile // 16
        want_y = (nty, ntx, bt, bt, 8, 8)
        want_c = (nty, ntx, ct, ct, 8, 8)
        if (tuple(yq.shape) != want_y or tuple(cbq.shape) != want_c
                or tuple(crq.shape) != want_c):
            raise ValueError(
                f"coefficient grids inconsistent: y {tuple(yq.shape)} "
                f"(want {want_y}), cb {tuple(cbq.shape)} / cr "
                f"{tuple(crq.shape)} (want {want_c})")

    def grid(self):
        """(n_tiles_y, n_tiles_x) — the delta bitmap geometry."""
        return self.h // self.tile, self.w // self.tile

    def _on_host(self) -> bool:
        return isinstance(self.yq, np.ndarray) or self.yq.device.type == "cpu"

    def _fetch(self, fn):
        """``fn`` applied to each plane, on the producing stream, each
        result copied to a host numpy array."""
        if self._on_host():
            planes = [p if isinstance(p, np.ndarray) else p.numpy()
                      for p in (self.yq, self.cbq, self.crq)]
            return [np.ascontiguousarray(fn(p)) for p in planes]
        with torch.cuda.stream(self.stream or torch.cuda.current_stream(self.yq.device)):
            return [fn(p).cpu().numpy() for p in (self.yq, self.cbq, self.crq)]

    def fetch_dirty(self, dirty: np.ndarray):
        """One gather per plane of JUST the dirty tiles' blocks, on the
        planes' device, then one copy to the host: ``(ys, cbs, crs)`` packed
        in bitmap row-major order (the delta wire's tile order), ys[k]
        being the (t/8, t/8, 8, 8) block grid of the k-th dirty tile —
        exactly what ``encode_coefficients`` wants for a t×t tile image.
        ``d2h_bytes`` counts only the dirty tiles' bytes."""
        idx = np.flatnonzero(np.ascontiguousarray(dirty, dtype=bool))
        n = len(idx)
        if self._on_host():
            def gather(p):
                return p.reshape((-1,) + p.shape[2:])[idx]
        else:
            sel = torch.from_numpy(idx).to(self.yq.device)

            def gather(p):
                return p.reshape((-1,) + tuple(p.shape[2:])).index_select(0, sel)
        ys, cbs, crs = self._fetch(gather) if n else [
            np.zeros((0,) + tuple(p.shape[2:]), np.int16)
            for p in (self.yq, self.cbq, self.crq)]
        self.d2h_bytes += ys.nbytes + cbs.nbytes + crs.nbytes
        return ys, cbs, crs

    def frame_blocks(self):
        """Full-frame block grids for a keyframe: ``(y, cb, cr)`` with
        y (h/8, w/8, 8, 8) and cb/cr (h/16, w/16, 8, 8) — the per-tile
        grouping unfolded back to raster block order (host-side, after
        one whole-plane D2H per component)."""
        y, cb, cr = self._fetch(lambda p: p)
        self.d2h_bytes += y.nbytes + cb.nbytes + cr.nbytes

        def unfold(a):
            nty, ntx, bt = a.shape[0], a.shape[1], a.shape[2]
            return (a.transpose(0, 2, 1, 3, 4, 5)
                    .reshape(nty * bt, ntx * bt, 8, 8))

        return unfold(y), unfold(cb), unfold(cr)


ENTROPY_SHARE = 0.5


def entropy_pool_size(cores: Optional[int] = None) -> int:
    """Entropy-pool width: ``ENTROPY_SHARE`` of the host's cores. The JAX
    package reads that share from its own codec benchmark's table; the
    port has no such table yet, so it takes the same default share (half
    the cores) until a measurement of its own replaces it."""
    cores = cores or os.cpu_count() or 1
    return max(1, min(cores, math.ceil(cores * ENTROPY_SHARE)))


class EntropyPool:
    """Host-wide entropy-coding pool for the full-transform assist — ONE
    shared ThreadPoolExecutor that interleaves every stream's dirty-tile
    coefficient blocks across the host cores (N worker streams sharing
    cores beats N private pools fighting over them; each DeltaCodec
    already serializes its own frames on its ordered worker, so the
    shared pool only ever sees independent per-tile jobs). Acquired
    refcounted via :func:`acquire_entropy_pool` and released on codec
    close — the conftest leak guard watches the ``dvf-jpeg-entropy``
    thread prefix the same way it watches the codec pools."""

    def __init__(self, workers: Optional[int] = None):
        self.workers = int(workers) if workers else entropy_pool_size()
        self._ex = ThreadPoolExecutor(max_workers=self.workers,
                                      thread_name_prefix="dvf-jpeg-entropy")

    def map(self, fn, *iterables):
        return list(self._ex.map(fn, *iterables))

    def shutdown(self) -> None:
        self._ex.shutdown(wait=True, cancel_futures=True)


_entropy_lock = threading.Lock()
_entropy_pool: Optional[EntropyPool] = None
_entropy_refs = 0


def acquire_entropy_pool() -> EntropyPool:
    global _entropy_pool, _entropy_refs
    with _entropy_lock:
        if _entropy_pool is None:
            _entropy_pool = EntropyPool()
        _entropy_refs += 1
        return _entropy_pool


def release_entropy_pool() -> None:
    global _entropy_pool, _entropy_refs
    with _entropy_lock:
        _entropy_refs -= 1
        if _entropy_refs <= 0 and _entropy_pool is not None:
            _entropy_pool.shutdown()
            _entropy_pool = None
            _entropy_refs = 0


class DeltaCodec:
    """Temporal-delta wire over an inner full-frame codec.

    Frame format (little-endian header, see ``_DELTA_HEADER``)::

        magic "\\xd6W" | ver | flags | seq | h | w | tile
        keyframe (flags & KEY):   inner-codec payload (full frame)
        delta frame:              packed tile bitmap, then dirty tiles in
                                  bitmap (row-major) order — raw pixel
                                  bytes when LOSSLESS, else u32-length-
                                  prefixed inner-codec payloads per tile

    Closed-loop reference semantics: the encoder's reference is the last
    state it SHIPPED per tile — the keyframe's input pixels, then each
    dirty tile's input pixels as it is sent — so sub-threshold drift can
    never accumulate (a tile is re-sent the moment its pixels diverge
    more than ``delta_threshold`` from what the decoder composites).
    Equivalence guarantees, in decreasing strength:

    - keyframes are always bit-identical to the full-frame wire (same
      inner payload);
    - ``delta_threshold=0`` with a raw inner wire is bit-identical to
      the full-frame raw wire for ARBITRARY motion (lossless tiles);
    - ``delta_threshold=0`` over JPEG: every delivered tile is either
      bit-identical to the most recent keyframe's full-frame-JPEG
      delivery (tile unchanged since it) or bit-identical to the SOURCE
      pixels (tile re-sent losslessly — strictly closer to the truth
      than the JPEG wire); on a static stream this collapses to
      bit-identity with the full-frame JPEG wire.

    Keyframe cadence: every ``keyframe_interval`` frames, plus forced
    keyframes on scene cut (dirty ratio ≥ ``scene_cut_ratio`` — cheaper
    AND resets any drift), geometry change, and :meth:`force_keyframe`
    (decoder resync request / ring eviction). ``full_frames=True`` (the
    fault-budget degradation target) forces EVERY frame to be a keyframe
    — the wire stays framed and decodable by the same peer while the
    codec does exactly the full-frame JPEG work.

    Encoder and decoder state are independent, so one instance can serve
    both directions of a bridge. ``encode_batch_async`` preserves the
    inter-frame encode order on a dedicated single worker (delta frames
    are cheap by construction; the inner pool still parallelizes nothing
    it shouldn't).
    """

    def __init__(self, inner=None, tile: int = 32,
                 keyframe_interval: int = 16,
                 delta_threshold: int = 0,
                 lossless_tiles: Optional[bool] = None,
                 scene_cut_ratio: float = 0.5,
                 on_gap: str = "raise",
                 quality: int = 90, threads: int = 4):
        if tile < 8:
            raise ValueError("tile must be >= 8")
        if keyframe_interval < 1:
            raise ValueError("keyframe_interval must be >= 1")
        if on_gap not in ("raise", "composite"):
            raise ValueError("on_gap must be 'raise' or 'composite'")
        self.inner = inner if inner is not None else make_codec(
            quality=quality, threads=threads)
        self.tile = int(tile)
        self.keyframe_interval = int(keyframe_interval)
        self.delta_threshold = int(delta_threshold)
        self.lossless = (delta_threshold == 0 if lossless_tiles is None
                         else bool(lossless_tiles))
        self.scene_cut_ratio = float(scene_cut_ratio)
        self.on_gap = on_gap
        self.full_frames = False  # degradation target: every frame a key
        # Ordered async encode: delta encoding is stateful (each frame's
        # reference is the previous shipped state), so batches must run
        # in submission order — one dedicated worker, not the inner pool.
        self._seq_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dvf-jpeg-delta")
        self._async_pending: list = []  # unresolved per-row futures
        self._enc_lock = threading.Lock()
        self._dec_lock = threading.Lock()
        # encoder state (geometry-pinned at first encode)
        self._enc_ref: Optional[np.ndarray] = None
        self._enc_scratch: Optional[tuple] = None
        self._enc_seq = 0
        self._since_key = 0
        self._force_key = True
        # full-transform assist state (coefficient wire): provenance,
        # geometry pin, shared entropy pool handle, stage accounting.
        # Inherit the inner codec's pre-stamped provenance (make_wire_codec
        # assist=); flips to "full-transform" on the first coeff encode.
        self.assist = getattr(self.inner, "assist", "none")
        self._coef_geom: Optional[tuple] = None
        self._entropy: Optional[EntropyPool] = None
        self.entropy_ms = 0.0          # lifetime total (stats())
        self._entropy_ms_pending = 0.0  # drained by take_entropy_ms()
        self.d2h_coef_bytes = 0
        self.coef_frames = 0
        # decoder state
        self._dec_ref: Optional[np.ndarray] = None
        self._dec_seq: Optional[int] = None
        self._dec_valid = False
        # counters (stats())
        self.frames = 0
        self.keyframes = 0
        self.forced_keyframes = 0
        self.scene_cuts = 0
        self.dirty_tiles = 0
        self.total_tiles = 0
        self.payload_bytes = 0
        self.decode_frames = 0
        self.resyncs = 0

    # -- encoder --------------------------------------------------------

    def force_keyframe(self) -> None:
        """Make the next encode a keyframe — the decoder's resync
        request (in-process pairs), and the ring transport's recovery
        after drop-oldest evicted frames the decoder never saw."""
        with self._enc_lock:
            self._force_key = True
            self.forced_keyframes += 1

    def _tiles(self, h: int, w: int):
        (nty, ntx), nbytes = tile_grid(h, w, self.tile)
        return nty, ntx, nbytes

    def _encode_keyframe(self, frame: np.ndarray, h: int, w: int) -> bytes:
        payload = (self.inner.encode(frame) if self._inner_is_jpeg()
                   else frame.tobytes())
        header = _DELTA_HEADER.pack(
            DELTA_MAGIC, DELTA_VERSION,
            _DELTA_FLAG_KEY | (_DELTA_FLAG_LOSSLESS if self.lossless else 0),
            self._enc_seq & 0xFFFFFFFF, h, w, self.tile)
        if self._enc_ref is None or self._enc_ref.shape != frame.shape:
            self._enc_ref = np.empty_like(frame)
            self._enc_scratch = (np.empty_like(frame), np.empty_like(frame))
        np.copyto(self._enc_ref, frame)
        # A pixel keyframe invalidates any coefficient-wire geometry pin
        # (and vice versa): switching paths mid-stream must re-key.
        self._coef_geom = None
        self._since_key = 0
        self._force_key = False
        self.keyframes += 1
        return header + payload

    def _inner_is_jpeg(self) -> bool:
        return hasattr(self.inner, "encode_batch_async") and not isinstance(
            self.inner, RawCodec)

    def encode(self, frame: Optional[np.ndarray],
               bitmap: Optional[np.ndarray] = None,
               coeffs: Optional[CoefficientFrame] = None) -> bytes:
        """One frame → one framed wire payload. ``bitmap`` is an optional
        device-computed (n_tiles_y, n_tiles_x) max-abs-diff reduction
        (runtime.codec_assist.DeviceDeltaProbe) — when given, the host
        skips its own change-detection pass entirely.

        With ``coeffs`` (a :class:`CoefficientFrame` from the fused
        probe→convert→DCT→quant device pass), ``frame`` may be None: the
        host never sees pixels at all. The bitmap is then REQUIRED (it
        came out of the same fused dispatch), dirty tiles ship as
        u32-length-prefixed JPEGs entropy-coded from the device-quantized
        blocks, and keyframes as one full-frame coefficient JPEG — the
        wire framing, flags, and decoder are unchanged, so any delta
        peer decodes it."""
        if coeffs is not None:
            return self._encode_coeffs(coeffs, bitmap)
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"delta wire carries (H, W, 3) uint8 frames, "
                             f"got {frame.shape}")
        h, w = frame.shape[:2]
        with self._enc_lock:
            self.frames += 1
            geometry_changed = (self._enc_ref is None
                                or self._enc_ref.shape != frame.shape)
            if (self.full_frames or self._force_key or geometry_changed
                    or self._since_key >= self.keyframe_interval):
                blob = self._encode_keyframe(frame, h, w)
                self._enc_seq += 1
                self.payload_bytes += len(blob)
                return blob
            nty, ntx, nbytes = self._tiles(h, w)
            if bitmap is not None:
                diff = np.asarray(bitmap, dtype=np.uint8)
                if diff.shape != (nty, ntx):
                    raise ValueError(
                        f"bitmap is {diff.shape}, geometry wants "
                        f"({nty}, {ntx}) at tile {self.tile}")
                dirty = diff > self.delta_threshold
            elif self.delta_threshold == 0:
                dirty = host_tile_changed(frame, self._enc_ref, self.tile,
                                          scratch=self._enc_scratch)
            else:
                diff = host_tile_maxdiff(frame, self._enc_ref, self.tile,
                                         scratch=self._enc_scratch)
                dirty = diff > self.delta_threshold
            n_dirty = int(dirty.sum())
            if n_dirty >= self.scene_cut_ratio * nty * ntx:
                # Scene cut: a full re-encode is cheaper than shipping
                # most tiles individually, and it resets any drift.
                # Counted as a keyframe, NOT in the dirty ratio — the
                # ratio describes DELTA frames only, so a full-motion
                # stream (every frame a scene cut) must not read as
                # dirty_ratio ≈ 0 when its true per-frame change is ≈ 1
                # (the keyframes/scene_cuts counters carry that story).
                self.scene_cuts += 1
                blob = self._encode_keyframe(frame, h, w)
                self._enc_seq += 1
                self.payload_bytes += len(blob)
                return blob
            self.total_tiles += nty * ntx
            self.dirty_tiles += n_dirty
            parts = [
                _DELTA_HEADER.pack(
                    DELTA_MAGIC, DELTA_VERSION,
                    _DELTA_FLAG_LOSSLESS if self.lossless else 0,
                    self._enc_seq & 0xFFFFFFFF, h, w, self.tile),
                np.packbits(dirty).tobytes(),
            ]
            t = self.tile
            if self.lossless and h % t == 0 and w % t == 0:
                # Aligned lossless fast path: gather every dirty tile in
                # ONE fancy-index over a strided (nty, ntx, t, t, 3)
                # view, and scatter the same selection into the encoder
                # reference — 20-30× the per-tile python loop (closed
                # loop: the reference tracks what was SHIPPED).
                fview = frame.reshape(nty, t, ntx, t, 3).swapaxes(1, 2)
                rview = self._enc_ref.reshape(
                    nty, t, ntx, t, 3).swapaxes(1, 2)
                tiles = fview[dirty]
                parts.append(tiles.tobytes())
                rview[dirty] = tiles
            else:
                for i, j in zip(*np.nonzero(dirty)):
                    tile_px = frame[i * t: (i + 1) * t, j * t: (j + 1) * t]
                    if self.lossless:
                        parts.append(tile_px.tobytes())
                    else:
                        enc = self.inner.encode(np.ascontiguousarray(tile_px))
                        parts.append(struct.pack("<I", len(enc)))
                        parts.append(enc)
                    # Closed loop: the reference tracks what was SHIPPED.
                    self._enc_ref[i * t: (i + 1) * t,
                                  j * t: (j + 1) * t] = tile_px
            self._since_key += 1
            self._enc_seq += 1
            blob = b"".join(parts)
            self.payload_bytes += len(blob)
            return blob

    # -- full-transform assist (coefficient wire) -----------------------

    def _encode_coeff_keyframe(self, cf: CoefficientFrame,
                               h: int, w: int) -> bytes:
        y, cb, cr = cf.frame_blocks()
        t0 = time.perf_counter()
        payload = self.inner.encode_coefficients(y, cb, cr, h, w)
        self._note_entropy((time.perf_counter() - t0) * 1e3)
        header = _DELTA_HEADER.pack(
            DELTA_MAGIC, DELTA_VERSION, _DELTA_FLAG_KEY,
            self._enc_seq & 0xFFFFFFFF, h, w, self.tile)
        # Coefficient keyframes carry no pixels: drop the pixel-path
        # reference so a later pixel encode re-keys instead of diffing
        # against a stale frame.
        self._enc_ref = None
        self._coef_geom = (h, w)
        self._since_key = 0
        self._force_key = False
        self.keyframes += 1
        return header + payload

    def _note_entropy(self, ms: float) -> None:
        self.entropy_ms += ms
        self._entropy_ms_pending += ms

    def take_entropy_ms(self) -> float:
        """Drain entropy-stage wall time accumulated since the last call
        — the AsyncCodecPlane's hook for EgressStats ``entropy_ms`` (the
        number that replaces ``encode_ms`` as the host-cost story on the
        full-transform wire)."""
        with self._enc_lock:
            v = self._entropy_ms_pending
            self._entropy_ms_pending = 0.0
            return v

    def _entropy_encode(self, ys, cbs, crs, t: int, n_dirty: int) -> list:
        """Per-tile JPEG payloads for a frame's dirty tiles, in bitmap
        order: contiguous chunks, one batched native call each (per-call
        setup outweighs the Huffman work of one small tile), fanned across
        the shared entropy pool."""
        batch = self.inner.encode_coefficients_batch
        workers = min(self._entropy.workers, n_dirty)
        if workers <= 1:
            return batch(ys, cbs, crs, t, t)
        bounds = [(k * n_dirty) // workers for k in range(workers + 1)]
        chunks = self._entropy.map(
            lambda k: batch(ys[bounds[k]:bounds[k + 1]],
                            cbs[bounds[k]:bounds[k + 1]],
                            crs[bounds[k]:bounds[k + 1]], t, t),
            range(workers))
        return [enc for chunk in chunks for enc in chunk]

    def _encode_coeffs(self, cf: CoefficientFrame,
                       bitmap: Optional[np.ndarray]) -> bytes:
        if not hasattr(self.inner, "encode_coefficients_batch"):
            raise RuntimeError(
                "full-transform assist needs the native JPEG codec's "
                "coefficient entry (the raw inner codec has none)")
        if cf.tile != self.tile:
            raise ValueError(f"coefficient frame tile {cf.tile} != codec "
                             f"tile {self.tile}")
        if cf.quality != getattr(self.inner, "quality", cf.quality):
            raise ValueError(
                f"coefficient frame quantized at quality {cf.quality}, "
                f"inner codec entropy-codes for "
                f"{getattr(self.inner, 'quality', None)} — the tables "
                f"must match or every peer decodes garbage")
        h, w = cf.h, cf.w
        with self._enc_lock:
            if self._entropy is None:
                self._entropy = acquire_entropy_pool()
            self.assist = "full-transform"
            self.frames += 1
            self.coef_frames += 1
            geometry_changed = self._coef_geom != (h, w)
            if (self.full_frames or self._force_key or geometry_changed
                    or self._since_key >= self.keyframe_interval):
                blob = self._encode_coeff_keyframe(cf, h, w)
                self._enc_seq += 1
                self.payload_bytes += len(blob)
                self.d2h_coef_bytes += cf.d2h_bytes
                return blob
            nty, ntx, nbytes = self._tiles(h, w)
            if bitmap is None:
                raise ValueError(
                    "coefficient encode needs the device-probe bitmap "
                    "(the host has no pixels to diff)")
            diff = np.asarray(bitmap, dtype=np.uint8)
            if diff.shape != (nty, ntx):
                raise ValueError(
                    f"bitmap is {diff.shape}, geometry wants "
                    f"({nty}, {ntx}) at tile {self.tile}")
            dirty = diff > self.delta_threshold
            n_dirty = int(dirty.sum())
            if n_dirty >= self.scene_cut_ratio * nty * ntx:
                self.scene_cuts += 1
                blob = self._encode_coeff_keyframe(cf, h, w)
                self._enc_seq += 1
                self.payload_bytes += len(blob)
                self.d2h_coef_bytes += cf.d2h_bytes
                return blob
            self.total_tiles += nty * ntx
            self.dirty_tiles += n_dirty
            # Delta frames on the coefficient wire are never LOSSLESS
            # (tiles are JPEGs from quantized blocks); the header flag
            # says so and the unchanged decoder composites accordingly.
            parts = [
                _DELTA_HEADER.pack(
                    DELTA_MAGIC, DELTA_VERSION, 0,
                    self._enc_seq & 0xFFFFFFFF, h, w, self.tile),
                np.packbits(dirty).tobytes(),
            ]
            if n_dirty:
                ys, cbs, crs = cf.fetch_dirty(dirty)
                t = self.tile
                t0 = time.perf_counter()
                encs = self._entropy_encode(ys, cbs, crs, t, n_dirty)
                self._note_entropy((time.perf_counter() - t0) * 1e3)
                for enc in encs:
                    parts.append(struct.pack("<I", len(enc)))
                    parts.append(enc)
            self._since_key += 1
            self._enc_seq += 1
            blob = b"".join(parts)
            self.payload_bytes += len(blob)
            self.d2h_coef_bytes += cf.d2h_bytes
            return blob

    # -- decoder --------------------------------------------------------

    def probe(self, data: bytes):
        """(height, width) — from the delta header, or the inner codec's
        probe for an unframed (plain full-frame) payload."""
        if data[:2] == DELTA_MAGIC and len(data) >= _DELTA_HEADER.size:
            _m, _v, _f, _s, h, w, _t = _DELTA_HEADER.unpack_from(data)
            return h, w
        return self.inner.probe(data)

    def _inner_decode_into(self, payload: bytes, out: np.ndarray) -> None:
        if self._inner_is_jpeg():
            if hasattr(self.inner, "decode_into"):
                self.inner.decode_into(payload, out)
            else:
                decoded = self.inner.decode(payload)
                if decoded.shape != out.shape:
                    raise JpegGeometryError(
                        f"payload is {decoded.shape[0]}x{decoded.shape[1]}, "
                        f"staging row is {out.shape[0]}x{out.shape[1]}")
                out[:] = decoded
        else:
            expect = out.shape[0] * out.shape[1] * 3
            if len(payload) != expect:
                raise DeltaWireError(
                    f"raw keyframe payload is {len(payload)} B, geometry "
                    f"wants {expect}")
            out[:] = np.frombuffer(payload, np.uint8).reshape(out.shape)

    def decode_into(self, data: bytes, out: np.ndarray) -> None:
        """Decode one wire payload into ``out`` (H, W, 3) uint8 —
        keyframes through the inner codec, delta frames composited onto
        the cached previous frame. Plain (unframed) JPEG payloads fall
        through to the inner decoder, so a peer that degraded to
        full-frame mode — or never spoke delta — stays decodable."""
        if data[:2] != DELTA_MAGIC:
            self._inner_decode_into(data, out)
            with self._dec_lock:
                # An unframed full frame is a complete state: adopt it
                # (a delta peer that degraded mid-stream keeps working),
                # but it carries no seq — treat like a keyframe.
                self._adopt_ref(out)
                self._dec_seq = None
            return
        if len(data) < _DELTA_HEADER.size:
            raise DeltaWireError(f"delta frame shorter than its header "
                                 f"({len(data)} B)")
        magic, ver, flags, seq, h, w, tile = _DELTA_HEADER.unpack_from(data)
        if ver != DELTA_VERSION:
            raise DeltaWireError(f"unknown delta wire version {ver}")
        if (h, w) != out.shape[:2]:
            raise JpegGeometryError(
                f"delta frame is {h}x{w}, staging row is "
                f"{out.shape[0]}x{out.shape[1]}")
        body = memoryview(data)[_DELTA_HEADER.size:]
        with self._dec_lock:
            self.decode_frames += 1
            if flags & _DELTA_FLAG_KEY:
                self._inner_decode_into(bytes(body), out)
                self._adopt_ref(out)
                self._dec_seq = seq
                return
            if tile != self.tile:
                raise DeltaWireError(
                    f"delta frame tile {tile} != codec tile {self.tile}")
            have_ref = (self._dec_valid and self._dec_ref is not None
                        and self._dec_ref.shape == out.shape)
            contiguous = (have_ref and self._dec_seq is not None
                          and seq == self._dec_seq + 1)
            if not contiguous:
                if self.on_gap == "raise":
                    self._dec_valid = False
                    raise DeltaResyncError(
                        f"delta frame seq {seq} without reference "
                        f"(last decoded: {self._dec_seq}) — keyframe needed")
                # Tolerant mode (ring transport): compositing absolute
                # tiles onto the stale reference keeps the stream moving
                # with bounded staleness; the encode side already forced
                # a keyframe when it observed the eviction. With no
                # reference at all (the keyframe itself was evicted),
                # composite onto zeros — visibly wrong for at most one
                # keyframe interval, which is the drop-oldest contract
                # (freshness over completeness), not a stream death.
                if not have_ref:
                    if (self._dec_ref is None
                            or self._dec_ref.shape != out.shape):
                        self._dec_ref = np.zeros_like(out)
                    else:
                        self._dec_ref.fill(0)
                    self._dec_valid = True
                self.resyncs += 1
            # The header says how this frame's tiles are encoded — the
            # wire is self-describing so a lossless-tiles encoder pairs
            # with any decoder configuration (the decoder's own
            # `lossless` only governs what IT would encode).
            self._composite(body, out, h, w,
                            lossless=bool(flags & _DELTA_FLAG_LOSSLESS))
            self._dec_seq = seq

    def _adopt_ref(self, out: np.ndarray) -> None:
        if self._dec_ref is None or self._dec_ref.shape != out.shape:
            self._dec_ref = np.empty_like(out)
        np.copyto(self._dec_ref, out)
        self._dec_valid = True

    def _composite(self, body: memoryview, out: np.ndarray,
                   h: int, w: int, lossless: bool) -> None:
        nty, ntx, nbytes = self._tiles(h, w)
        if len(body) < nbytes:
            raise DeltaWireError(
                f"delta frame bitmap truncated ({len(body)} < {nbytes} B)")
        bits = np.unpackbits(
            np.frombuffer(body[:nbytes], np.uint8))[: nty * ntx]
        dirty = bits.reshape(nty, ntx).astype(bool)
        off = nbytes
        t = self.tile
        ref = self._dec_ref
        if lossless and h % t == 0 and w % t == 0:
            # Aligned lossless fast path: one fancy-index scatter of the
            # contiguous tile block (mirror of the encoder's gather).
            n_dirty = int(dirty.sum())
            need = n_dirty * t * t * 3
            if off + need != len(body):
                raise DeltaWireError(
                    f"delta frame carries {len(body) - off} tile bytes, "
                    f"bitmap wants {need}")
            if n_dirty:
                ref.reshape(nty, t, ntx, t, 3).swapaxes(1, 2)[dirty] = (
                    np.frombuffer(body[off:], np.uint8)
                    .reshape(n_dirty, t, t, 3))
            np.copyto(out, ref)
            return
        for i, j in zip(*np.nonzero(dirty)):
            y0, x0 = i * t, j * t
            th, tw = min(t, h - y0), min(t, w - x0)
            if lossless:
                n = th * tw * 3
                if off + n > len(body):
                    raise DeltaWireError(
                        f"delta tile ({i},{j}) truncated at byte {off}")
                ref[y0: y0 + th, x0: x0 + tw] = np.frombuffer(
                    body[off: off + n], np.uint8).reshape(th, tw, 3)
                off += n
            else:
                if off + 4 > len(body):
                    raise DeltaWireError(
                        f"delta tile ({i},{j}) length prefix truncated")
                (n,) = struct.unpack_from("<I", body, off)
                off += 4
                if off + n > len(body):
                    raise DeltaWireError(
                        f"delta tile ({i},{j}) payload truncated "
                        f"({len(body) - off} < {n} B)")
                tile_out = np.empty((th, tw, 3), np.uint8)
                self._inner_decode_into(bytes(body[off: off + n]), tile_out)
                ref[y0: y0 + th, x0: x0 + tw] = tile_out
                off += n
        if off != len(body):
            raise DeltaWireError(
                f"delta frame has {len(body) - off} trailing bytes")
        np.copyto(out, ref)

    def decode(self, data: bytes) -> np.ndarray:
        h, w = self.probe(data)
        out = np.empty((h, w, 3), np.uint8)
        self.decode_into(data, out)
        return out

    @staticmethod
    def seek_keyframe(blobs: Sequence[bytes]) -> Optional[int]:
        """Index of the first payload a reference-less decoder can start
        from — a framed keyframe or a plain (unframed) full-frame JPEG —
        or None. The ZMQ worker's resync recovery: after a wire fault
        poisons a batch's delta prefix, drop exactly up to the next
        keyframe instead of the whole batch (and instead of cascading
        gap errors across every following batch until a keyframe happens
        to land first)."""
        for k, b in enumerate(blobs):
            if b[:2] == DELTA_MAGIC:
                if (len(b) >= _DELTA_HEADER.size
                        and _DELTA_HEADER.unpack_from(b)[2]
                        & _DELTA_FLAG_KEY):
                    return k
            elif b[:2] == b"\xff\xd8":  # plain JPEG: a complete state
                return k
        return None

    # -- batched (order-preserving) -------------------------------------

    def encode_batch(self, frames: Sequence[np.ndarray],
                     bitmaps: Optional[Sequence[np.ndarray]] = None,
                     coeffs: Optional[Sequence[CoefficientFrame]] = None
                     ) -> List[bytes]:
        return [self.encode(f, None if bitmaps is None else bitmaps[i],
                            None if coeffs is None else coeffs[i])
                for i, f in enumerate(frames)]

    def encode_batch_async(self, frames: Sequence[np.ndarray],
                           bitmaps: Optional[Sequence[np.ndarray]] = None,
                           coeffs: Optional[Sequence[CoefficientFrame]]
                           = None) -> list:
        """Per-frame futures in frame order (the AsyncCodecPlane entry
        point), resolved by ONE ordered worker: delta encoding is
        stateful, so two batches must never interleave — the plane's
        submission order IS the wire order. On the full-transform wire
        ``frames`` is a row of Nones and ``coeffs`` carries the device
        handles; the ordered worker still serializes frames while the
        shared entropy pool parallelizes tiles WITHIN each frame."""
        from concurrent.futures import Future

        futs = [Future() for _ in frames]
        rows = list(frames)

        def work():
            for i, f in enumerate(rows):
                fut = futs[i]
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(self.encode(
                        f, None if bitmaps is None else bitmaps[i],
                        None if coeffs is None else coeffs[i]))
                except BaseException as e:  # noqa: BLE001 — per-row error
                    fut.set_exception(e)

        self._async_pending = [f for f in self._async_pending
                               if not f.done()] + futs
        self._seq_pool.submit(work)
        return futs

    def decode_batch(self, blobs: Sequence[bytes],
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        if out is None:
            h, w = self.probe(blobs[0])
            out = np.empty((len(blobs), h, w, 3), np.uint8)
        for i, b in enumerate(blobs):
            try:
                self.decode_into(b, out[i])
            except DeltaWireError as e:
                # Which row failed matters to the transport's recovery
                # (drop exactly through the fault to the next keyframe,
                # not from the batch head) — decode_into can't know it.
                e.row = i
                raise
        return out

    # -- provenance / lifecycle -----------------------------------------

    def config(self) -> dict:
        cfg = dict(self.inner.config())
        cfg.update(
            wire="delta" if not self.full_frames else "delta(full-frame)",
            tile=self.tile,
            keyframe_interval=self.keyframe_interval,
            delta_threshold=self.delta_threshold,
            lossless_tiles=self.lossless,
            scene_cut_ratio=self.scene_cut_ratio,
            # Assist provenance (none / ycbcr / full-transform): which
            # device stage fed this codec — flips to full-transform the
            # moment a CoefficientFrame is encoded, so bench rows and
            # worker stats are attributable to the path that actually ran.
            assist=self.assist,
        )
        if self._entropy is not None:
            cfg["entropy_workers"] = self._entropy.workers
        return cfg

    def stats(self) -> dict:
        """Wire-side accounting: the dirty ratio is the fraction of tiles
        actually re-encoded across delta frames (keyframes excluded) —
        the number LATENCY.md's delta reading guide starts from."""
        return {
            "frames": self.frames,
            "keyframes": self.keyframes,
            "forced_keyframes": self.forced_keyframes,
            "scene_cuts": self.scene_cuts,
            "dirty_ratio": (round(self.dirty_tiles / self.total_tiles, 4)
                            if self.total_tiles else None),
            "payload_bytes": self.payload_bytes,
            "decode_frames": self.decode_frames,
            "resyncs": self.resyncs,
            "full_frames": self.full_frames,
            "assist": self.assist,
            "coef_frames": self.coef_frames,
            "entropy_ms": round(self.entropy_ms, 3),
            "d2h_coef_bytes": self.d2h_coef_bytes,
        }

    def close(self) -> None:
        self._seq_pool.shutdown(wait=True, cancel_futures=True)
        # cancel_futures can stop a queued ordered-worker task from ever
        # running; resolve its per-row futures so a draining codec plane
        # blocked on them unwinds instead of hanging forever.
        for f in self._async_pending:
            if not f.done():
                try:
                    f.set_exception(RuntimeError("delta codec closed"))
                except Exception:  # noqa: BLE001 — racing completion
                    pass
        self._async_pending = []
        if self._entropy is not None:
            # Refcounted: the shared entropy pool joins when the LAST
            # coefficient-wire codec closes (conftest leak guard).
            self._entropy = None
            release_entropy_pool()
        self.inner.close()


class RawCodec:
    """Raw full-frame 'codec' — the no-op inner for a delta wire whose
    keyframes should carry raw bytes (the shm/raw wire's delta mode).
    Geometry is pinned at construction: raw payloads carry no header."""

    def __init__(self, height: int, width: int):
        self.shape = (int(height), int(width), 3)

    def encode(self, frame_rgb: np.ndarray) -> bytes:
        return np.ascontiguousarray(frame_rgb, dtype=np.uint8).tobytes()

    def decode(self, data: bytes) -> np.ndarray:
        return np.frombuffer(data, np.uint8).reshape(self.shape).copy()

    def probe(self, data: bytes):
        return self.shape[0], self.shape[1]

    def decode_into(self, data: bytes, out: np.ndarray) -> None:
        expect = out.shape[0] * out.shape[1] * 3
        if len(data) != expect:
            raise DeltaWireError(
                f"raw payload is {len(data)} B, staging row wants {expect}")
        out[:] = np.frombuffer(data, np.uint8).reshape(out.shape)

    def config(self) -> dict:
        return {"backend": "raw", "wire": "raw", "quality": None,
                "threads": 0, "assist": "none"}

    def close(self) -> None:
        pass


def make_wire_codec(wire: str, quality: int = 90, threads: int = 4,
                    raw_shape=None, assist: str = "none", **delta_kw):
    """One constructor for every wire mode: ``"jpeg"`` → the plain
    full-frame codec, ``"delta"`` → :class:`DeltaCodec` over it,
    ``"raw"`` → :class:`RawCodec` (needs ``raw_shape``). ``assist``
    pre-stamps the inner codec's provenance (none / ycbcr /
    full-transform) so config() rows are attributable even before the
    first assisted encode lands."""
    if wire == "jpeg":
        return make_codec(quality=quality, threads=threads, assist=assist)
    if wire == "delta":
        return DeltaCodec(make_codec(quality=quality, threads=threads,
                                     assist=assist),
                          **delta_kw)
    if wire == "raw":
        if raw_shape is None:
            raise ValueError("raw wire codec needs raw_shape=(H, W, ...)")
        return RawCodec(raw_shape[0], raw_shape[1])
    raise ValueError(f"wire must be 'raw', 'jpeg', or 'delta', got {wire!r}")
