"""Streamed batch ingest: overlap host staging, H2D and compute (port of
``dvf_tpu.runtime.ingest``).

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

On a mesh the assembler takes the engine's input sharding in place of a
device (``Engine.placement``) and plans from its blocks, as the
reference plans from ``devices_indices_map``: each block owns a
contiguous device buffer per slot, the rows of each data block are cut
into ``min(depth, rows)`` chunks, and a chunk's copy sends its rows of
every block of that data block to the block's device on that device's
H2D stream (``stream`` is then ``Engine.h2d_stream_for``). A block that
splits H is gathered into its own pinned slab first (one host copy), so
every host→device copy reads contiguous pinned memory. ``finish`` hands
over a ``ShardedBatch`` and an ``EventGroup``.

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
from dvf_tpu_torch.parallel.mesh import NamedSharding
from dvf_tpu_torch.parallel.sharded import EventGroup, ShardedBatch
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
    :class:`BatchBuilder` for one batch. ``device`` is the engine's device,
    or its input sharding on a mesh (``Engine.placement``; None:
    monolithic, as the reference with no sharding); ``stream`` the
    engine's H2D stream (``Engine.h2d_stream``; None on the CPU), or a
    function of the device on a mesh (``Engine.h2d_stream_for``).
    """

    def __init__(
        self,
        batch_shape: Tuple[int, ...],
        dtype,
        device=None,
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
        self.sharding = device if isinstance(device, NamedSharding) else None
        if self.sharding is not None:
            device = self.sharding.mesh.first_device
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
        self._chunk_blocks: List[List[int]] = []   # blocks each chunk feeds
        self._host: Optional[List[torch.Tensor]] = None   # per slot
        self._views: Optional[List[np.ndarray]] = None    # their numpy views
        self._dev: Optional[List[List[torch.Tensor]]] = None  # per slot,
        #   one device buffer per block (one block off a mesh)
        self._gather: Optional[List[List[Optional[torch.Tensor]]]] = None
        #   per slot and block: the pinned slab an H-splitting block is
        #   gathered into before its copy (None: its rows are contiguous)
        self._blocks = []  # the layout's blocks: (device, index)
        self.effective_mode = self._plan()
        self.stats.effective_mode = self.effective_mode
        self.stats.pool_allocs += 1
        _LIVE_ASSEMBLERS.add(self)

    @property
    def _pin(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def stream_for(self, device: torch.device):
        if device.type != "cuda" or self.stream is None:
            return None
        return self.stream(device) if callable(self.stream) else self.stream

    def slab_bytes(self) -> int:
        """Host staging memory this assembler currently holds — 0 after
        :meth:`release`."""
        if self._host is None:
            return 0
        extra = [t for slot in (self._gather or []) for t in slot if t is not None]
        return sum(t.numel() * t.element_size() for t in list(self._host) + extra)

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
        full = tuple(slice(0, n) for n in self.batch_shape)
        if self.sharding is None:
            self._blocks = [(self.device, full)]
        else:
            self._blocks = [(blk.device, blk.index)
                            for blk in self.sharding.shards(self.batch_shape)]
        # The data blocks' row ranges, each cut into up to `depth` chunks.
        ranges = sorted({(idx[0].start, idx[0].stop) for _, idx in self._blocks})
        self._chunks, self._chunk_blocks = [], []
        for b0, b1 in ranges:
            rows = b1 - b0
            n = min(self.depth, rows)
            bounds = [b0 + (rows * i) // n for i in range(n)] + [b1]
            feeds = [k for k, (_, idx) in enumerate(self._blocks)
                     if idx[0].start == b0]
            for s, e in zip(bounds, bounds[1:]):
                self._chunks.append((s, e))
                self._chunk_blocks.append(feeds)
        self._chunk_of_row = [0] * b
        for i, (s, e) in enumerate(self._chunks):
            for r in range(s, e):
                self._chunk_of_row[r] = i
        self._dev = [[torch.empty(_extent(idx), dtype=tdt, device=dev)
                      for dev, idx in self._blocks]
                     for _ in range(self.slots)]
        self._gather = [[None if _rows_contiguous(idx, self.batch_shape)
                         else torch.empty(_extent(idx), dtype=tdt,
                                          pin_memory=dev.type == "cuda")
                         for dev, idx in self._blocks]
                        for _ in range(self.slots)]
        for slot in self._dev:
            for (dev, _), t in zip(self._blocks, slot):
                st = self.stream_for(dev)
                if st is not None:
                    # The H2D stream writes these: when they are freed, the
                    # allocator waits for its work before it reuses them.
                    t.record_stream(st)
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
        self._gather = None
        self._chunks = []
        self._chunk_of_row = []
        self._chunk_blocks = []


def _extent(idx) -> Tuple[int, ...]:
    return tuple(i.stop - i.start for i in idx)


def _rows_contiguous(idx, shape) -> bool:
    """Whether a block's rows are contiguous in a C-order batch: every
    dimension after the batch axis is whole."""
    return all(i.start == 0 and i.stop == n for i, n in zip(idx[1:], shape[1:]))


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
        nbytes = 0
        try:
            used = []
            for k in asm._chunk_blocks[ci]:
                dev, idx = asm._blocks[k]
                b0 = idx[0].start
                dst = asm._dev[self.slot][k][s - b0:stop - b0]
                staged = asm._gather[self.slot][k]
                if staged is None:
                    src = self._host[s:stop]
                else:
                    src = staged[s - b0:stop - b0]
                    src.copy_(self._host[(slice(s, stop),) + tuple(idx[1:])])
                st = asm.stream_for(dev)
                if st is not None:
                    with torch.cuda.stream(st):
                        dst.copy_(src, non_blocking=True)
                    used.append(dev)
                else:
                    dst.copy_(src)
                nbytes += dst.numel() * dst.element_size()
            if asm.sharding is None:
                ev = record_event(asm.stream_for(asm.device))
            else:
                ev = EventGroup.record(used, asm.stream_for)
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
            tracer.complete(INGEST_H2D, t0, t1, asm.track,
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
            t_end = time.perf_counter()
            self._stage_s += t_end - t0
            tracer = self.asm.tracer
            if tracer is not None and tracer.enabled:
                tracer.complete(INGEST_STAGE, self._t_begin, t_end, self.asm.track,
                                stage_ms=round(self._stage_s * 1e3, 3))
            self._record(t_end)
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
        asm = self.asm
        if asm.sharding is None:
            self.ready = record_event(asm.stream_for(asm.device))
        else:
            self.ready = EventGroup.record([d for d, _ in asm._blocks],
                                           asm.stream_for)
        t_end = time.perf_counter()
        tracer = self.asm.tracer
        if tracer is not None and tracer.enabled and self._first_put_t:
            tracer.complete(INGEST_OVERLAP, self._first_put_t,
                            t_end, self.asm.track, valid=valid)
            tracer.complete(INGEST_STAGE, self._t_begin, t_end,
                            self.asm.track,
                            stage_ms=round(self._stage_s * 1e3, 3))
        self._record(t_end)
        if asm.sharding is None:
            return asm._dev[self.slot][0], True
        return ShardedBatch(asm._dev[self.slot], asm.sharding, asm.batch_shape), True

    def _record(self, t_end: float) -> None:
        self.asm.stats.record_batch(
            stage_ms=self._stage_s * 1e3,
            put_ms=self._put_s * 1e3,
            wait_ms=self._wait_s * 1e3,
            span_ms=(t_end - self._t_begin) * 1e3,
        )
