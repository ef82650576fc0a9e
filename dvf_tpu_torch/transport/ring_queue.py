"""RingFrameQueue — the native ring as the pipeline's ingest queue (port of
``dvf_tpu/transport/ring_queue.py``).

The reference app's hot path sends every frame through libzmq between
the capture thread and the workers (distributor.py:27-35, worker.py:17-25).
The pipeline's equivalent is source → ingest queue → batch staging, and
this adapter puts the native SPSC ring (``ring.cpp``) there, with the
surface of :class:`~dvf_tpu_torch.sched.queues.DropOldestQueue` that the
:class:`~dvf_tpu_torch.runtime.pipeline.Pipeline` uses (``put`` /
``pop_up_to`` / ``__len__`` / ``dropped`` / ``put_total``).

Three wires, the same bytes as the JAX package's:

- **raw** — ``frame.tobytes()``; no codec; the ring holds whole frames.
- **jpeg** — encoded at ``put`` by the full-frame codec, decoded on the
  staging side by ``decode_batch(out=staging)`` straight into the rows the
  engine copies to the card.
- **delta** — :class:`~dvf_tpu_torch.transport.codec.DeltaCodec` over the
  JPEG codec: ``put`` encodes only the tiles that changed since the last
  shipped frame, the staging side composites onto its previous frame.

Delta resync under drop-oldest: an evicted record is a delta frame the
decoder never sees. The producer sees every eviction (``push`` returns the
count) and forces the next encode to be a keyframe; the decoder runs in
``on_gap="composite"`` mode, compositing absolute tiles onto the stale
reference (counted in ``resyncs``) until that keyframe lands.

Differences from the Python queue, by design: the bound is bytes
(``capacity_frames`` raw frames); ``pop_up_to`` returns ``(index,
payload_bytes, timestamp)``; the pipeline finds :meth:`decode_into` and
decodes payloads into its staging slab instead of copying arrays.
``audit_wire`` wraps every payload in the digest envelope of
``obs/audit.py`` at ``put`` and verifies and strips it in
:meth:`decode_into` (a mismatch raises ``WireIntegrityError`` attributed
to the ``ring`` hop); ``chaos`` arms that envelope's ``corrupt_wire``
site on the stamp side.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from dvf_tpu_torch.transport.codec import WIRE_MODES, make_wire_codec
from dvf_tpu_torch.transport.ring import FrameRing

# Native per-record overhead: RecordHeader (24 B) rounded up to 8-byte
# alignment, as ring.cpp's align_up(sizeof(RecordHeader) + len).
_RECORD_OVERHEAD = 32


class RingFrameQueue:
    """Drop-oldest ingest queue backed by the native (optionally shared
    memory) ring."""

    def __init__(
        self,
        frame_shape: Tuple[int, int, int],
        capacity_frames: int = 10,
        jpeg: bool = False,
        jpeg_quality: int = 90,
        codec_threads: int = 4,
        shm_name: Optional[str] = None,
        create: bool = True,
        wire: Optional[str] = None,
        delta_tile: int = 32,
        delta_keyframe_interval: int = 48,
        delta_threshold: int = 0,
        codec_assist: str = "none",
        audit_wire: bool = False,
        chaos=None,
    ):
        if wire is None:
            wire = "jpeg" if jpeg else "raw"
        if wire not in WIRE_MODES:
            raise ValueError(f"wire must be one of {WIRE_MODES}, got {wire!r}")
        self.frame_shape = tuple(frame_shape)
        self.frame_dtype = np.dtype(np.uint8)
        self._frame_bytes = int(np.prod(self.frame_shape))
        self.wire = wire
        # Exposed so serve's wire-budget check budgets against the pool
        # the pipeline actually runs, not the host's total core count.
        self.codec_pool_threads = codec_threads
        self.codec = None
        self._dec_codec = None
        # codec_assist is provenance here, not behaviour: this ring is an
        # ingest-side host wire, which the device transform cannot feed.
        if wire == "jpeg":
            self.codec = make_wire_codec("jpeg", quality=jpeg_quality,
                                         threads=codec_threads,
                                         assist=codec_assist)
            self._dec_codec = self.codec  # stateless: one instance, both ends
        elif wire == "delta":
            # Separate encoder and decoder: producer and consumer run on
            # different threads (or, over shm, processes).
            def _delta():
                return make_wire_codec(
                    "delta", quality=jpeg_quality, threads=codec_threads,
                    assist=codec_assist, tile=delta_tile,
                    keyframe_interval=delta_keyframe_interval,
                    delta_threshold=delta_threshold, on_gap="composite")

            self.codec = _delta()
            self._dec_codec = _delta()
        # Wire-integrity audit (obs.audit): every payload is wrapped in
        # a digest-stamped envelope at put and verified+stripped at
        # decode_into — a flipped bit between the two (the native ring,
        # shm) raises WireIntegrityError into the pipeline's containment
        # as an ``integrity`` fault instead of delivering wrong pixels.
        # ``chaos`` arms the post-encode ``corrupt_wire`` flip on the
        # stamp side. Off by default.
        self._wire_audit = None
        if audit_wire:
            from dvf_tpu_torch.obs.audit import WireAudit

            self._wire_audit = WireAudit("ring", chaos=chaos)
        # The first eviction re-keys at once; the cooldown only limits
        # re-keying under sustained overload.
        self._force_cooldown = max(4, delta_keyframe_interval // 2)
        self._puts_since_forced = self._force_cooldown
        # Sized for capacity_frames raw frames (a JPEG ring then holds
        # more). The per-record cap leaves 2× slack: JPEG is larger than
        # raw for noise-like content (~1.5× at worst), and an oversized
        # record must fail at push, never at pop.
        cap = max(1, capacity_frames) * (self._frame_bytes + _RECORD_OVERHEAD)
        self.ring = FrameRing(
            capacity_bytes=cap, shm_name=shm_name, create=create,
            max_frame_bytes=2 * self._frame_bytes + _RECORD_OVERHEAD + 8192)

    # -- producer side (the pipeline's ingest thread) --------------------

    def put(self, item: Tuple[int, np.ndarray, float]) -> Optional[int]:
        """Enqueue; returns the eviction count if frames were displaced,
        else None (the pipeline's pacing checks only ``is not None``)."""
        idx, frame, ts = item
        if isinstance(frame, np.ndarray) and frame.shape != self.frame_shape:
            raise ValueError(
                f"ring transport carries fixed {self.frame_shape} frames; "
                f"source yielded {frame.shape} (pass the source's real "
                f"geometry when constructing RingFrameQueue)")
        if self.wire == "raw":
            payload = frame.tobytes() if isinstance(frame, np.ndarray) else frame
        else:
            payload = self.codec.encode(frame)
        if self._wire_audit is not None:
            payload = self._wire_audit.stamp(payload)
        evicted = self.ring.push(payload, idx, ts)
        self._puts_since_forced += 1
        if (evicted > 0 and self.wire == "delta"
                and self._puts_since_forced >= self._force_cooldown):
            # The evicted records are delta frames the consumer will never
            # composite; only the producer sees that, so it re-keys. At
            # most one forced key per half keyframe interval: re-keying on
            # every eviction under sustained overload would fill the ring
            # with keyframes, the largest payloads.
            self.codec.force_keyframe()
            self._puts_since_forced = 0
        return evicted if evicted > 0 else None

    # -- consumer side (the pipeline's dispatch thread) ------------------

    def pop_up_to(self, n: int) -> List[Tuple[int, bytes, float]]:
        return [(idx, payload, ts)
                for payload, idx, ts in self.ring.pop_up_to(n)]

    def decode_into(self, items: List[Tuple[int, bytes, float]],
                    staging: np.ndarray) -> None:
        """Decode popped payloads into rows [0, len(items)) of a staging
        array (JPEG through the threaded codec; delta sequentially, each
        frame's cost scaled by its dirty share)."""
        k = len(items)
        if self._wire_audit is not None:
            # Verify + strip every envelope BEFORE any pixel decode: a
            # digest mismatch raises here (integrity fault) instead of
            # compositing corrupt bytes into the staging batch.
            items = [(idx, self._wire_audit.verify(payload), ts)
                     for idx, payload, ts in items]
        if self.wire == "raw":
            for row, (_, payload, _) in enumerate(items):
                staging[row] = np.frombuffer(
                    payload, np.uint8).reshape(self.frame_shape)
        else:
            self._dec_codec.decode_batch([p for _, p, _ in items],
                                         out=staging[:k])

    # -- stats / lifecycle ----------------------------------------------

    _closed_counts: Optional[Tuple[int, int]] = None

    @property
    def dropped(self) -> int:
        if self._closed_counts is not None:
            return self._closed_counts[0]
        return self.ring.dropped

    @property
    def put_total(self) -> int:
        if self._closed_counts is not None:
            return self._closed_counts[1]
        return self.ring.pushed

    def wire_stats(self) -> dict:
        """Wire provenance and delta accounting (``DeltaCodec.stats``:
        dirty ratio, keyframes, resyncs)."""
        out = {"wire": self.wire}
        if self.wire == "delta":
            out["encode"] = self.codec.stats()
            out["decode"] = self._dec_codec.stats()
            out["codec"] = self.codec.config()
        elif self.codec is not None:
            out["codec"] = self.codec.config()
        if self._wire_audit is not None:
            out["audit"] = self._wire_audit.stats()
        return out

    def __len__(self) -> int:
        return 0 if self._closed_counts is not None else len(self.ring)

    def close(self) -> None:
        if self._closed_counts is not None:
            return
        # Snapshot the native counters first: stats are read after the
        # pipeline shuts the transport down, and reading a destroyed ring
        # is a use after free.
        self._closed_counts = (self.ring.dropped, self.ring.pushed)
        if self.codec is not None:
            self.codec.close()
        if self._dec_codec is not None and self._dec_codec is not self.codec:
            self._dec_codec.close()
        self.ring.close()
