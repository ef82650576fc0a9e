"""Streamed batch ingest: overlap host staging, H2D and compute (port of
``dvf_tpu.runtime.ingest`` for one device).

The monolithic path stages the whole batch on the host and then ships it
as one host→device copy before compute can start. Here frames are staged
into a pinned host slab, and each row chunk is copied to the device the
moment its rows fill, so the copy of chunk *i* overlaps the staging of
chunk *i+1* and the device compute of batch *k−1*:

    monolithic   stage ████████████ → H2D ████████ → compute ████
    streamed     stage ███░███░███░███░
                 H2D       ████ ████ ████ ████          (per chunk,
                 compute ░░░░ batch k−1 ░░░░░░░         overlapped)

One device is the reference's single-device mesh: the batch is cut into
``min(depth, B)`` contiguous row chunks. Each staging slot owns a pinned
host slab and a preallocated device batch; chunk *i* is copied with
``non_blocking=True`` into its rows of that device batch on the engine's
H2D stream, and an event is recorded after each chunk. Writing into one
device batch replaces the reference's on-device concatenation of the
parts: there is no extra device copy. ``finish`` records the event after
the last chunk; ``Engine.submit_resident(batch, ready=...)`` makes the
compute stream wait for it.

``depth`` bounds the chunk copies in flight: beyond it the builder waits
for the oldest chunk's event, and that wait is ``wait_ms``. On the CPU the
"H2D" is a real copy into the slot's device batch.

Fallbacks, recorded in the ingest stats either way: ``mode="monolithic"``
(the escape hatch: one whole-batch host buffer per slot, pinned on a
card, handed to the engine's classic ``submit``), and a calibrated
blocking put (``Engine.h2d_block_ms``) below ``MIN_STREAM_H2D_MS``
(``"cheap_transfer"``).

Slot discipline is the pipeline's staging-pool contract: the caller gives
a monotonically increasing slot id per batch and guarantees (by its
in-flight bound) that a slot is revisited only after its batch has been
collected — by then the device step has read the slot's device batch and
the copies have read its host slab, so rewriting both is safe.
"""

from __future__ import annotations

import time
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from dvf_tpu_torch.obs.metrics import IngestStats
from dvf_tpu_torch.obs.trace import INGEST_H2D, INGEST_OVERLAP, INGEST_STAGE
from dvf_tpu_torch.resilience.faults import FaultError, FaultKind
from dvf_tpu_torch.runtime.engine import _torch_dtype, host_array, record_event

INGEST_MODES = ("streamed", "monolithic")

# Below this calibrated blocking-put cost (Engine.h2d_block_ms, measured
# at compile), the fixed per-batch streaming overhead exceeds anything
# overlap can hide, so the assembler stays monolithic (the reference's
# threshold). Tests that exercise the streaming machinery at tiny sizes
# monkeypatch this to 0.
MIN_STREAM_H2D_MS = 2.0

# Host-slab accounting registry: every live assembler is weakly tracked
# so the slab gauges can walk host staging memory.
_LIVE_ASSEMBLERS: "weakref.WeakSet" = weakref.WeakSet()


def live_assemblers() -> List["ShardedBatchAssembler"]:
    """Every assembler still referenced anywhere in the process (a
    released one stays listed but reports 0 ``slab_bytes``)."""
    return list(_LIVE_ASSEMBLERS)


def occupied_slab_bytes() -> int:
    """Total host staging bytes currently held by live assemblers."""
    return sum(a.slab_bytes() for a in live_assemblers())


class ShardedBatchAssembler:
    """Stages batches into pinned slabs and streams them to the device.

    One assembler per batch signature; ``begin(slot)`` yields a
    :class:`BatchBuilder` for one batch. ``device`` is the engine's device
    (None: monolithic, as the reference with no sharding); ``stream`` the
    engine's H2D stream (``Engine.h2d_stream``; None on the CPU).
    """

    def __init__(
        self,
        batch_shape: Tuple[int, ...],
        dtype,
        device: Optional[torch.device] = None,
        mode: str = "streamed",
        depth: int = 4,
        slots: int = 5,
        tracer=None,
        track: int = 0,
        stats: Optional[IngestStats] = None,
        chaos=None,
        stream: Optional[torch.cuda.Stream] = None,
    ):
        if mode not in INGEST_MODES:
            raise ValueError(f"ingest mode must be one of {INGEST_MODES}, "
                             f"got {mode!r}")
        if depth < 1:
            raise ValueError("ingest depth must be >= 1")
        self.batch_shape = tuple(batch_shape)
        self.dtype = np.dtype(dtype)
        self.device = None if device is None else torch.device(device)
        self.mode = mode
        self.depth = depth
        self.slots = max(1, slots)
        self.tracer = tracer
        self.track = track
        self.chaos = chaos  # resilience.chaos.FaultPlan — the "h2d" site
        #   fires per chunk copy when armed
        self.stream = stream
        self.stats = stats if stats is not None else IngestStats(
            requested_mode=mode, depth=depth)
        self._chunks: List[Tuple[int, int]] = []   # row ranges
        self._chunk_of_row: List[int] = []
        self._host: Optional[List[torch.Tensor]] = None   # per slot
        self._views: Optional[List[np.ndarray]] = None    # their numpy views
        self._dev: Optional[List[torch.Tensor]] = None    # per slot
        self.effective_mode = self._plan()
        self.stats.effective_mode = self.effective_mode
        self.stats.pool_allocs += 1
        _LIVE_ASSEMBLERS.add(self)

    @property
    def _pin(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def slab_bytes(self) -> int:
        """Host staging memory this assembler currently holds — 0 after
        :meth:`release`."""
        if self._host is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self._host)

    def _plan(self) -> str:
        tdt = _torch_dtype(self.dtype)
        self._host = [torch.empty(self.batch_shape, dtype=tdt, pin_memory=self._pin)
                      for _ in range(self.slots)]
        self._views = [host_array(t) for t in self._host]
        if self.mode == "monolithic" or self.device is None:
            return "monolithic"
        cal = self.stats.h2d_block_ms
        if cal is not None and cal < MIN_STREAM_H2D_MS:
            self.stats.fallback_reason = "cheap_transfer"
            return "monolithic"
        b = self.batch_shape[0]
        n = min(self.depth, b)
        bounds = [(b * i) // n for i in range(n)] + [b]
        self._chunks = list(zip(bounds, bounds[1:]))
        self._chunk_of_row = [0] * b
        for i, (s, e) in enumerate(self._chunks):
            for r in range(s, e):
                self._chunk_of_row[r] = i
        self._dev = [torch.empty(self.batch_shape, dtype=tdt, device=self.device)
                     for _ in range(self.slots)]
        if self.stream is not None:
            # The H2D stream writes these: when they are freed, the
            # allocator waits for its work before it reuses the memory.
            for t in self._dev:
                t.record_stream(self.stream)
        return "streamed"

    def begin(self, slot: int) -> "BatchBuilder":
        """Start staging one batch into the given staging-pool slot."""
        if self._host is None:
            raise RuntimeError("assembler was released")
        return BatchBuilder(self, slot % self.slots)

    def release(self) -> None:
        """Drop every staging buffer reference eagerly (a geometry
        re-probe or a degradation abandons this assembler). A copy still
        in flight keeps its own reference to the tensors it reads, and the
        step recorded its use of the device batch on its stream. The
        assembler is unusable afterwards."""
        self._host = None
        self._views = None
        self._dev = None
        self._chunks = []
        self._chunk_of_row = []


class BatchBuilder:
    """Mutable per-batch staging state; produced by ``begin``, consumed by
    ``finish``. Rows are written in increasing order. ``ready`` is the
    event after the last chunk's copy once ``finish`` returned a device
    batch (None on the CPU and on the monolithic path)."""

    def __init__(self, asm: ShardedBatchAssembler, slot: int):
        self.asm = asm
        self.slot = slot
        self.ready: Optional[torch.cuda.Event] = None
        self._streamed = asm.effective_mode == "streamed"
        self._host = asm._host[slot]
        self._view = asm._views[slot]
        self._filled = [0] * len(asm._chunks) if self._streamed else [0]
        self._inflight: List[Optional[torch.cuda.Event]] = []
        self._stage_s = 0.0
        self._put_s = 0.0
        self._wait_s = 0.0
        self._first_put_t: Optional[float] = None
        self._t_begin = time.perf_counter()

    # -- row staging -----------------------------------------------------

    def write_row(self, row: int, frame: np.ndarray) -> None:
        """Copy one frame into its slab row; launches the chunk's copy the
        moment its last row lands."""
        t0 = time.perf_counter()
        np.copyto(self._view[row], frame)
        self._stage_s += time.perf_counter() - t0
        if self._streamed:
            ci = self.asm._chunk_of_row[row]
            self._filled[ci] += 1
            if self._filled[ci] == self._rows(ci):
                self._launch(ci)

    def windows(self, k: int) -> List[Tuple[int, int]]:
        """Contiguous row windows covering [0, k) for bulk decode — each
        window is one chunk (clipped at k), so committing a window
        launches its copy while the next window decodes."""
        if not self._streamed:
            return [(0, k)] if k else []
        return [(s, min(e, k)) for s, e in self.asm._chunks if s < k]

    def window_view(self, start: int, stop: int) -> np.ndarray:
        """The (rows, H, W, C) slab rows [start, stop): a zero-copy decode
        target."""
        return self._view[start:stop]

    def commit_window(self, start: int, stop: int) -> None:
        """Mark rows [start, stop) staged; launches the chunk's copy when
        it fills."""
        if not self._streamed:
            self._filled[0] = stop
            return
        ci = self.asm._chunk_of_row[start]
        self._filled[ci] += stop - start
        if self._filled[ci] == self._rows(ci):
            self._launch(ci)

    def _rows(self, ci: int) -> int:
        s, e = self.asm._chunks[ci]
        return e - s

    # -- transfers -------------------------------------------------------

    def _launch(self, ci: int) -> None:
        asm = self.asm
        s, stop = asm._chunks[ci]
        if asm.chaos is not None:
            # Injection site "h2d": a delay rule stalls this copy (a
            # congested link), a raise rule denies it.
            asm.chaos.fire("h2d")
        t0 = time.perf_counter()
        if self._first_put_t is None:
            self._first_put_t = t0
        dst = asm._dev[self.slot][s:stop]
        try:
            if asm.stream is not None:
                with torch.cuda.stream(asm.stream):
                    dst.copy_(self._host[s:stop], non_blocking=True)
            else:
                dst.copy_(self._host[s:stop])
            ev = record_event(asm.stream)
        except Exception as e:  # noqa: BLE001 — carry the fault kind so
            # containment classifies this as h2d (and can escalate to the
            # streamed→monolithic fallback) instead of guessing from site.
            raise FaultError(
                FaultKind.H2D,
                f"chunk host→device copy failed for rows {s}:{stop}: "
                f"{e!r}") from e
        t1 = time.perf_counter()
        self._put_s += t1 - t0
        tracer = asm.tracer
        if tracer is not None and tracer.enabled:
            nbytes = dst.numel() * dst.element_size()
            off = time.time() - time.perf_counter()  # monotonic → wall
            tracer.complete(INGEST_H2D, t0 + off, t1 + off, asm.track,
                            rows=f"{s}:{stop}", bytes=nbytes)
        self._inflight.append(ev)
        if len(self._inflight) > asm.depth:
            oldest = self._inflight.pop(0)
            tw = time.perf_counter()
            if oldest is not None:
                oldest.synchronize()
            self._wait_s += time.perf_counter() - tw

    # -- completion ------------------------------------------------------

    def finish(self, valid: int):
        """Pad rows [valid, B) by repeating the last valid row, flush the
        remaining chunk copies, and hand the batch over.

        Returns ``(batch, resident)``: the slot's device batch with
        ``resident=True`` on the streamed path (feed
        ``Engine.submit_resident(batch, ready=builder.ready)``), or the
        slot's host buffer with ``resident=False`` on the monolithic path
        (feed ``Engine.submit``, which owns the copy).
        """
        b = self.asm.batch_shape[0]
        if not (0 < valid <= b):
            raise ValueError(f"valid={valid} out of range for batch {b}")
        t0 = time.perf_counter()
        if not self._streamed:
            self._view[valid:] = self._view[valid - 1]
            self._stage_s += time.perf_counter() - t0
            self._record(time.perf_counter())
            return self._host, False
        # The source row's chunk may already be launched (its slab rows
        # are only read); the destination rows are in chunks not launched.
        for row in range(valid, b):
            np.copyto(self._view[row], self._view[valid - 1])
            ci = self.asm._chunk_of_row[row]
            self._filled[ci] += 1
            if self._filled[ci] == self._rows(ci):
                self._stage_s += time.perf_counter() - t0
                self._launch(ci)
                t0 = time.perf_counter()
        self._stage_s += time.perf_counter() - t0
        self.ready = record_event(self.asm.stream)
        t_end = time.perf_counter()
        tracer = self.asm.tracer
        if tracer is not None and tracer.enabled and self._first_put_t:
            off = time.time() - time.perf_counter()  # monotonic → wall
            tracer.complete(INGEST_OVERLAP, self._first_put_t + off,
                            t_end + off, self.asm.track, valid=valid)
            tracer.complete(INGEST_STAGE, self._t_begin + off, t_end + off,
                            self.asm.track,
                            stage_ms=round(self._stage_s * 1e3, 3))
        self._record(t_end)
        return self.asm._dev[self.slot], True

    def _record(self, t_end: float) -> None:
        self.asm.stats.record_batch(
            stage_ms=self._stage_s * 1e3,
            put_ms=self._put_s * 1e3,
            wait_ms=self._wait_s * 1e3,
            span_ms=(t_end - self._t_begin) * 1e3,
        )
