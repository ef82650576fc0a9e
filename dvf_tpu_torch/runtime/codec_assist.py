"""On-device codec assist: the transform half of the host JPEG cycle on the
card (port of ``dvf_tpu/runtime/codec_assist.py``).

Three device stages, appended after the filter on the engine's device
output, queued on the same CUDA stream (no host sync in between):

- :class:`DeviceDeltaProbe` — the temporal-delta wire's change detection:
  per-tile max-abs-diff of each output frame against the previous one
  (``ops.kernels.tile_maxdiff``, K5). Within a batch frame *i*'s
  predecessor is row *i−1*; across batches the probe keeps the last row
  on the card. The host fetches a few-hundred-byte bitmap instead of
  running its own frame-sized reduction.
- :class:`DeviceCodecAssist` — RGB→YCbCr (BT.601 full range, libjpeg's
  matrix) plus the 2×2 chroma subsample on the card, so the host codec
  starts from half the bytes (``NativeJpegCodec.encode_ycbcr420``).
- :class:`FusedDeltaTransform` — probe, convert, per-8×8-block forward
  DCT and quantization of the three planes in one launch
  (``ops.kernels.dct8x8_quant_planes``, K6) for one batch:
  only dirty tiles' int16 coefficient blocks and the bitmap cross D2H;
  the host runs entropy coding and nothing else
  (``NativeJpegCodec.encode_coefficients_batch``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dvf_tpu_torch.ops.kernels import dct8x8_quant_planes, jpeg_quant_table, tile_maxdiff


def _stream_of(t: torch.Tensor):
    return torch.cuda.current_stream(t.device) if t.device.type == "cuda" else None


class DeviceDeltaProbe:
    """Device-side dirty-tile bitmaps for a SEQUENTIAL frame stream.

    ``bitmaps(batch)`` returns a host ``(B, ⌈H/tile⌉, ⌈W/tile⌉)`` uint8
    array of per-tile max-abs-diffs against each frame's predecessor. Only
    valid for streams whose batch rows are consecutive frames of ONE stream
    (pipeline, ZMQ worker).

    The probe diffs each frame against its PREDECESSOR, not against the
    encoder's last-shipped state: at ``delta_threshold=0`` the two select
    the same tiles; at thresholds > 0 sub-threshold drift is bounded only by
    the keyframe cadence. The first call's row 0 has no predecessor and is
    marked all-dirty (the delta codec keyframes it anyway).
    """

    def __init__(self, tile: int = 32):
        self.tile = int(tile)
        self._prev: Optional[torch.Tensor] = None  # (1, H, W, C) last row
        self._shape: Optional[Tuple[int, ...]] = None

    def _step(self, batch: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        chain = torch.cat([prev, batch[:-1]], dim=0)
        # A view of batch[-1] would alias the engine's next output buffer.
        self._prev = batch[-1:].clone()
        return tile_maxdiff(batch, chain, self.tile)

    def bitmaps(self, batch: torch.Tensor) -> np.ndarray:
        """One device reduction and a tiny host fetch; ``batch`` is the
        engine's (B, H, W, C) uint8 device output."""
        shape = tuple(batch.shape)
        if self._prev is None or self._shape != shape:
            self._shape = shape
            out = self._step(batch, batch[:1]).cpu().numpy()
            out[0] = 255
            return out
        return self._step(batch, self._prev).cpu().numpy()

    def reset(self) -> None:
        """Drop the device state (geometry change, engine rebuild)."""
        self._prev = None
        self._shape = None


# -- YCbCr 4:2:0 device stages ------------------------------------------

# BT.601 full-range (JFIF) — the matrix libjpeg applies on the host path
# this stage replaces.
_RGB2Y = (0.299, 0.587, 0.114)
_RGB2CB = (-0.168735892, -0.331264108, 0.5)
_RGB2CR = (0.5, -0.418687589, -0.081312411)


def _f32(v: float, dev: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev)


def rgb_to_ycbcr420(batch: torch.Tensor):
    """(B, H, W, 3) uint8 RGB → (y, cb, cr) uint8 planes ((B, H, W),
    (B, H/2, W/2), (B, H/2, W/2)). Odd H/W are edge-padded to even first
    (libjpeg's own edge replication); the chroma subsample is the 2×2 mean
    (libjpeg's h2v2 downsampler). Plain torch: no hand kernel."""
    b, h, w, _ = batch.shape
    x = batch.to(torch.float32)
    if h % 2 or w % 2:
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, w % 2, 0, h % 2),
                                    mode="replicate").permute(0, 2, 3, 1)
        h, w = h + h % 2, w + w % 2
    dev = x.device
    r, g, bl = x[..., 0], x[..., 1], x[..., 2]
    # float32 constants, the reference's order of operations
    ky, kb, kr = ([_f32(v, dev) for v in m] for m in (_RGB2Y, _RGB2CB, _RGB2CR))
    half = _f32(128.0, dev)
    y = ky[0] * r + ky[1] * g + ky[2] * bl
    cb = half + kb[0] * r + kb[1] * g + kb[2] * bl
    cr = half + kr[0] * r + kr[1] * g + kr[2] * bl
    cb = cb.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    cr = cr.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def to_u8(p):
        return torch.round(p).clamp(0, 255).to(torch.uint8)

    return to_u8(y), to_u8(cb), to_u8(cr)


def ycbcr420_to_rgb_host(y: np.ndarray, cb: np.ndarray,
                         cr: np.ndarray) -> np.ndarray:
    """Host inverse (tests and any raw-assist wire consumer): nearest
    chroma upsample + BT.601 inverse, back to (…, H, W, 3) uint8."""
    yf = y.astype(np.float32)
    cbf = np.repeat(np.repeat(cb.astype(np.float32) - 128.0, 2, axis=-2),
                    2, axis=-1)
    crf = np.repeat(np.repeat(cr.astype(np.float32) - 128.0, 2, axis=-2),
                    2, axis=-1)
    r = yf + 1.402 * crf
    g = yf - 0.344136286 * cbf - 0.714136286 * crf
    b = yf + 1.772 * cbf
    return np.clip(np.round(np.stack([r, g, b], axis=-1)), 0,
                   255).astype(np.uint8)


class DeviceCodecAssist:
    """RGB→YCbCr420 on the card + host plane fetch (1.5 bytes/px instead
    of 3) for ``NativeJpegCodec.encode_ycbcr420``."""

    def planes(self, batch: torch.Tensor):
        y, cb, cr = rgb_to_ycbcr420(batch)
        return y.cpu().numpy(), cb.cpu().numpy(), cr.cpu().numpy()


# -- full-transform assist: probe + convert + DCT + quant ---------------


class FusedDeltaTransform:
    """The codec endgame's device stage for one batch: dirty-tile probe
    (K5, one launch), RGB→YCbCr 4:2:0 (plain torch), per-8×8-block DCT +
    quantization (K6, one launch for Y, Cb and Cr), all queued on the
    batch's CUDA stream. ``calls`` counts :meth:`process` calls, one per
    batch. The host never sees pixels: only dirty tiles' int16 coefficient
    blocks and the bitmap cross D2H (``transport.codec.CoefficientFrame``
    gathers lazily on the producing stream).

    Coefficients come out GROUPED BY DELTA TILE — y (B, nty, ntx, t/8,
    t/8, 8, 8), cb/cr (B, nty, ntx, t/16, t/16, 8, 8) — so one dirty tile
    is one contiguous slice. That needs ``tile % 16 == 0`` and H, W
    multiples of the tile: gate with :meth:`supports` and use
    :class:`DeviceDeltaProbe` + host encode elsewhere.

    Probe semantics are :class:`DeviceDeltaProbe`'s (same predecessor
    chain, same all-dirty first row).
    """

    def __init__(self, tile: int = 32, quality: int = 90):
        if tile % 16:
            raise ValueError(f"fused transform needs tile % 16 == 0 "
                             f"(chroma blocks must tile), got {tile}")
        self.tile = int(tile)
        self.quality = int(quality)
        self.calls = 0
        self._prev: Optional[torch.Tensor] = None
        self._shape: Optional[Tuple[int, ...]] = None
        self._ql = jpeg_quant_table(quality)
        self._qc = jpeg_quant_table(quality, chroma=True)

    @staticmethod
    def supports(shape, tile: int) -> bool:
        """Whether this batch geometry can take the fused path: (B, H, W, 3)
        with H and W multiples of a tile that is itself a multiple of 16."""
        if len(shape) != 4 or shape[3] != 3:
            return False
        h, w = shape[1], shape[2]
        return tile % 16 == 0 and h % tile == 0 and w % tile == 0

    def _group(self, q: torch.Tensor, bt: int) -> torch.Tensor:
        # raster blocks (B, nby, nbx, 8, 8) → per-delta-tile
        # (B, nty, ntx, bt, bt, 8, 8)
        b, nby, nbx = q.shape[0], q.shape[1], q.shape[2]
        return (q.reshape(b, nby // bt, bt, nbx // bt, bt, 8, 8)
                .permute(0, 1, 3, 2, 4, 5, 6).contiguous())

    def process(self, batch: torch.Tensor):
        """One batch → ``(bitmaps, coefficient_frames)``: a host (B, nty,
        ntx) uint8 bitmap array and one lazy
        :class:`~dvf_tpu_torch.transport.codec.CoefficientFrame` per row."""
        from dvf_tpu_torch.transport.codec import CoefficientFrame

        shape = tuple(batch.shape)
        if not self.supports(shape, self.tile):
            raise ValueError(f"geometry {shape} unsupported at tile "
                             f"{self.tile} (use supports() to gate)")
        first = self._prev is None or self._shape != shape
        prev = batch[:1] if first else self._prev
        self._shape = shape
        t = self.tile
        tiles = tile_maxdiff(batch, torch.cat([prev, batch[:-1]], dim=0), t)
        self._prev = batch[-1:].clone()
        y, cb, cr = rgb_to_ycbcr420(batch)
        yq, cbq, crq = dct8x8_quant_planes((y, cb, cr), (self._ql, self._qc, self._qc))
        yq = self._group(yq, t // 8)
        cbq, crq = self._group(cbq, t // 16), self._group(crq, t // 16)
        self.calls += 1
        bm = tiles.cpu().numpy()
        if first:
            bm[0] = 255
        stream = _stream_of(batch)
        h, w = shape[1], shape[2]
        frames = [CoefficientFrame(yq[i], cbq[i], crq[i], h, w, t,
                                   self.quality, stream=stream)
                  for i in range(shape[0])]
        return bm, frames

    def reset(self) -> None:
        """Drop the device state (geometry change, engine rebuild)."""
        self._prev = None
        self._shape = None
