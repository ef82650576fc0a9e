"""Streamed egress and the asynchronous codec plane (port of
``ShardedBatchFetcher``, ``AsyncCodecPlane`` and ``_EncodeEntry`` from
``dvf_tpu/runtime/egress.py``).

:class:`ShardedBatchFetcher` — ``prefetch(result, slot)`` right after the
engine's submit makes the engine's D2H stream wait for the batch's compute
event, copies the output into the slot's preallocated pinned slab there
and records a D2H event, so the copy runs under the tail of compute and
the next batch's staging. ``fetch(result, slot)`` in the collect path
first waits for the compute event (that wait is device time, not D2H),
then for the D2H event (timed as ``wait_ms``), and returns the slab's
numpy view; ``owns(out)`` is then True, and rows that outlive the collect
step must be copied. No pinned allocation happens per batch. The
monolithic fetch times its blocking device→host copy as ``wait_ms`` too.
With an enabled tracer each fetch is an ``egress.fetch`` span holding an
``egress.wait_compute`` and an ``egress_d2h`` span, all tagged with the
batch's slot id (``seq``).

On a mesh the fetcher takes the engine's output sharding in place of a
device and makes one device→host copy per output block, on the block's
device's D2H stream after that device's compute event, into the block's
rows of the slot's slab. A block that splits H (its rows are not
contiguous in the slab) lands in its own pinned staging slab and reaches
the host slab in ``fetch``.

Fallbacks mirror the ingest assembler, recorded in the stats either way:

- ``mode="monolithic"`` (the escape hatch) keeps the classic fetch: a
  fresh host array per batch, its rows handed out as views;
- a CPU engine's output is already in host memory, so a slab copy is pure
  added work (``fallback_reason="zero_copy_backend"``; tests monkeypatch
  ``STREAM_ON_CPU`` to run the machinery);
- a calibrated blocking fetch (``Engine.d2h_block_ms``) below
  ``MIN_STREAM_D2H_MS`` stays monolithic (``"cheap_transfer"``);
- a result at another geometry than the pool's falls back per batch;
- repeated d2h faults degrade streamed → monolithic through the error
  budget (``"d2h_fault_budget"``, wired in the pipeline and the worker).

:class:`AsyncCodecPlane` — the delivery loop submits a batch's rows to the
codec's thread pool and returns to decoding and computing the NEXT batch
while the pool encodes; completed batches drain in submission order.

Slot discipline is the staging-pool contract: the caller gives a
monotonically increasing slot id per batch and guarantees (by its
in-flight bound or encode window) that a slab is revisited only after its
rows have been copied onward or sent.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dvf_tpu_torch.obs.metrics import EgressStats
from dvf_tpu_torch.obs.trace import (
    EGRESS_D2H,
    EGRESS_ENCODE,
    EGRESS_FETCH,
    EGRESS_WAIT_COMPUTE,
)
from dvf_tpu_torch.parallel.mesh import NamedSharding
from dvf_tpu_torch.parallel.sharded import EventGroup, ShardedBatch
from dvf_tpu_torch.runtime.engine import (
    _torch_dtype,
    host_array,
    record_event,
    wait_compute,
)

EGRESS_MODES = ("streamed", "monolithic")

# Below this calibrated blocking-fetch cost (Engine.d2h_block_ms, measured
# at compile) the fetcher stays monolithic — the mirror of
# ingest.MIN_STREAM_H2D_MS; tests at tiny sizes monkeypatch it to 0.
MIN_STREAM_D2H_MS = 2.0

# A CPU engine's output already lies in host memory: the monolithic fetch
# is a zero-copy view, and a slab copy would be a pure regression. Tests
# monkeypatch True to run the streamed machinery on the CPU.
STREAM_ON_CPU = False

# Host-slab accounting registry, the egress mirror of
# runtime.ingest._LIVE_ASSEMBLERS; a released fetcher reports 0.
_LIVE_FETCHERS: "weakref.WeakSet" = weakref.WeakSet()


def live_fetchers() -> List["ShardedBatchFetcher"]:
    return list(_LIVE_FETCHERS)


def occupied_slab_bytes() -> int:
    """Total host delivery-slab bytes currently held by live fetchers."""
    return sum(f.slab_bytes() for f in live_fetchers())


class ShardedBatchFetcher:
    """Fetches engine results into preallocated host slabs.

    One fetcher per output signature. ``device`` is the engine's device,
    or its output sharding on a mesh (``Engine.placement``; None:
    monolithic); ``stream`` the engine's D2H stream (``Engine.d2h_stream``;
    None on the CPU), or a function of the device on a mesh
    (``Engine.d2h_stream_for``). ``prefetch`` belongs right after the
    engine's submit, ``fetch`` in the collect path.
    """

    def __init__(
        self,
        out_shape: Tuple[int, ...],
        dtype,
        device=None,
        mode: str = "streamed",
        slots: int = 5,
        stats: Optional[EgressStats] = None,
        tracer=None,
        track: int = 0,
        chaos=None,
        stream: Optional[torch.cuda.Stream] = None,
    ):
        if mode not in EGRESS_MODES:
            raise ValueError(f"egress mode must be one of {EGRESS_MODES}, "
                             f"got {mode!r}")
        self.out_shape = tuple(out_shape)
        self.dtype = np.dtype(dtype)
        self.sharding = device if isinstance(device, NamedSharding) else None
        if self.sharding is not None:
            device = self.sharding.mesh.first_device
        self.device = None if device is None else torch.device(device)
        self.mode = mode
        self.slots = max(1, slots)
        self.tracer = tracer
        self.track = track
        self.chaos = chaos  # resilience.chaos.FaultPlan — the "d2h" site
        #   fires per batch fetch when armed
        self._streams = stream  # a stream, or a function of the device
        self.stream = (None if self.device is None
                       else self.stream_for(self.device))  # the first
        #   device's D2H stream (None on the CPU)
        self.stats = stats if stats is not None else EgressStats(
            requested_mode=mode)
        self._pool: Optional[List[torch.Tensor]] = None
        self._views: List[np.ndarray] = []
        self._staging: List[List[Optional[torch.Tensor]]] = []  # per slot
        #   and output block: the pinned slab an H-splitting block lands in
        self.effective_mode = self._plan()
        self.stats.effective_mode = self.effective_mode
        _LIVE_FETCHERS.add(self)

    def slab_bytes(self) -> int:
        """Host delivery-slab memory this fetcher currently holds — 0
        after :meth:`release` and on the monolithic path."""
        if self._pool is None:
            return 0
        extra = [t for slot in self._staging for t in slot if t is not None]
        return sum(t.numel() * t.element_size() for t in self._pool + extra)

    def stream_for(self, device: torch.device):
        if device.type != "cuda" or self._streams is None:
            return None
        return self._streams(device) if callable(self._streams) else self._streams

    def _plan(self) -> str:
        if self.mode == "monolithic" or self.device is None:
            return "monolithic"
        if self.device.type == "cpu" and not STREAM_ON_CPU:
            self.stats.fallback_reason = "zero_copy_backend"
            return "monolithic"
        cal = self.stats.d2h_block_ms
        if cal is not None and cal < MIN_STREAM_D2H_MS:
            self.stats.fallback_reason = "cheap_transfer"
            return "monolithic"
        tdt = _torch_dtype(self.dtype)
        pin = self.device.type == "cuda"
        self._pool = [torch.empty(self.out_shape, dtype=tdt, pin_memory=pin)
                      for _ in range(self.slots)]
        self._views = [host_array(t) for t in self._pool]
        if self.sharding is not None:
            self._staging = [
                [None if self._pool[0][blk.index].is_contiguous()
                 else torch.empty(self._pool[0][blk.index].shape, dtype=tdt,
                                  pin_memory=pin)
                 for blk in self.sharding.shards(self.out_shape)]
                for _ in range(self.slots)]
        self.stats.pool_allocs += 1
        return "streamed"

    def _streamable(self, result: Any) -> bool:
        y = getattr(result, "device", None)
        if self.sharding is not None and not (
                isinstance(y, ShardedBatch) and y.sharding == self.sharding):
            return False
        return (self._pool is not None  # released mid-flight (degradation):
                #   fall back per batch, never write into freed slabs
                and y is not None
                and tuple(y.shape) == self.out_shape
                and y.device == self.device
                and y.dtype == self._pool[0].dtype)

    # -- submit side ----------------------------------------------------

    def prefetch(self, result: Any, slot: int) -> None:
        """Start the D2H of a streamable result into slot ``slot``'s slab
        now, on the D2H stream after the compute event; ``fetch`` then
        only waits. The slab and the D2H event are kept on the result
        (``result.host`` and its event). Nothing to do on the monolithic
        path or on the CPU (the copy is made in ``fetch``)."""
        if self.stream is None or not self._streamable(result):
            return
        y = result.device
        slab = self._pool[slot % self.slots]
        if self.sharding is not None:
            self._prefetch_blocks(result, y, slot % self.slots)
            return
        self.stream.wait_event(result.compute_event)
        y.record_stream(self.stream)  # the allocator must not hand y's
        #   memory to the next batch while this copy still reads it
        with torch.cuda.stream(self.stream):
            slab.copy_(y, non_blocking=True)
        result.host, result._event = slab, record_event(self.stream)

    def _prefetch_blocks(self, result: Any, y: ShardedBatch, i: int) -> None:
        slab = self._pool[i]
        scatter, used = [], []
        for k, (blk, t) in enumerate(zip(y.blocks, y.shards)):
            view = slab[blk.index]
            staged = self._staging[i][k]
            dst = view if staged is None else staged
            st = self.stream_for(t.device)
            if st is None:
                dst.copy_(t)
            else:
                st.wait_event(result.compute_event.on(t.device))
                t.record_stream(st)  # see prefetch
                with torch.cuda.stream(st):
                    dst.copy_(t, non_blocking=True)
                used.append(t.device)
            if staged is not None:
                scatter.append((view, staged))
        result.host, result._event = slab, EventGroup.record(used, self.stream_for)
        result._scatter = scatter

    # -- collect side ---------------------------------------------------

    def fetch(self, result: Any, slot: int) -> np.ndarray:
        """One batch's output on the host; blocks until the device is done
        (the compute wait is not counted as D2H). Streamed: the slot's
        slab (valid until the slot is revisited). Monolithic or a result
        the pool cannot take: a fresh host array."""
        t_begin = time.perf_counter()
        tracer = self.tracer
        if tracer is not None and not tracer.enabled:
            tracer = None
        if not self._streamable(result):
            wait_compute(result)
            t0 = time.perf_counter()
            y = result.device
            if self.stream is not None and self.sharding is None:
                with torch.cuda.stream(self.stream):
                    out = host_array(y.cpu())
            else:
                out = host_array(y.cpu())
            t2 = time.perf_counter()
            if tracer is not None:
                self._trace(tracer, slot, t_begin, t0, t0, t2, out.nbytes)
            self.stats.record_fetch(wait_ms=(t2 - t0) * 1e3, copy_ms=0.0,
                                    span_ms=(t2 - t_begin) * 1e3)
            return out
        wait_compute(result)
        t_computed = time.perf_counter() if tracer is not None else 0.0
        if self.chaos is not None:
            # Injection site "d2h": a delay rule stalls this fetch (a
            # congested link), a raise rule denies it.
            self.chaos.fire("d2h")
        i = slot % self.slots
        t0 = time.perf_counter()
        if self.stream is not None:
            if result.host is not self._pool[i]:
                # Not prefetched here (the fetcher was rebuilt between the
                # batch's submit and its collect): start the copy now.
                self.prefetch(result, slot)
            result.wait_host()
            t1 = time.perf_counter()
        else:
            t1 = time.perf_counter()
            if self.sharding is not None:  # CPU: the copies themselves
                self._prefetch_blocks(result, result.device, i)
                result.wait_host()
            else:
                self._pool[i].copy_(result.device)
        t2 = time.perf_counter()
        if tracer is not None:
            self._trace(tracer, slot, t_begin, t_computed, t0, t2, self._views[i].nbytes)
        self.stats.record_fetch(
            wait_ms=(t1 - t0) * 1e3, copy_ms=(t2 - t1) * 1e3,
            span_ms=(t2 - t_begin) * 1e3)
        return self._views[i]

    def _trace(self, tracer, seq: int, t_begin: float, t_computed: float,
               t_copy: float, t_end: float, nbytes: int) -> None:
        tracer.complete(EGRESS_FETCH, t_begin, t_end, self.track, seq=seq)
        tracer.complete(EGRESS_WAIT_COMPUTE, t_begin, t_computed, self.track, seq=seq)
        tracer.complete(EGRESS_D2H, t_copy, t_end, self.track, seq=seq,
                        rows=f"0:{self.out_shape[0]}", bytes=nbytes)

    def owns(self, out: np.ndarray) -> bool:
        """True when ``out`` is one of this fetcher's pooled slabs — it is
        rewritten once the slot cycles, so rows that outlive the caller's
        collect step must be copied. The monolithic and per-batch
        fallback paths return fresh arrays and stay False."""
        return self._pool is not None and any(out is v for v in self._views)

    def release(self) -> None:
        """Drop the slab pool eagerly (geometry re-probe / degradation).
        A copy in flight keeps its own reference to its slab."""
        self._pool = None
        self._views = []
        self._staging = []


class _EncodeEntry:
    __slots__ = ("metas", "futures", "payloads", "t_submit", "t_done",
                 "_remaining", "_lock")

    def __init__(self, metas, futures, payloads, t_submit):
        self.metas = metas
        self.futures = futures      # None on the raw (no-encode) path
        self.payloads = payloads    # raw path: zero-copy memoryviews
        self.t_submit = t_submit
        self.t_done = t_submit
        self._remaining = len(futures) if futures else 0
        self._lock = threading.Lock()

    def mark_done(self) -> None:
        """Done-callback (pool thread): stamps the batch's encode span
        end when its last future completes."""
        with self._lock:
            self._remaining -= 1
            if self._remaining == 0:
                self.t_done = time.perf_counter()

    def done(self) -> bool:
        if self.futures is None:
            return True
        return all(f.done() for f in self.futures)

    def collect(self) -> List[Tuple[Any, Any, Optional[BaseException]]]:
        """(meta, payload, error) per row, in submission order; a failed
        encode surfaces as its row's error instead of poisoning the
        batch."""
        if self.futures is None:
            return [(m, p, None) for m, p in zip(self.metas, self.payloads)]
        out = []
        for meta, fut in zip(self.metas, self.futures):
            try:
                out.append((meta, fut.result(), None))
            except Exception as e:  # noqa: BLE001 — per-row containment
                out.append((meta, None, e))
        return out


class AsyncCodecPlane:
    """Bounded-window, order-preserving async encode over a codec pool.

    ``submit(rows, metas)`` hands one batch's rows to the codec's thread
    pool (``encode_batch_async``) and returns immediately; ``ready()``
    drains *completed head* batches — delivery order is submission order,
    never completion order. ``ready(block=True)`` (or ``flush``) waits
    for the head, which is how callers enforce the in-flight window:

        plane.submit(rows, metas)
        for batch in plane.ready(block=len(plane) > plane.depth):
            for meta, payload, err in batch: …send…

    The raw (``jpeg=False``) path skips the pool entirely and carries
    each row as a zero-copy memoryview over the caller's slab — valid
    until the slab slot is reused, which the window bound guarantees
    happens only after the send (zmq copies at send time).

    Thread contract: ``submit``/``ready``/``flush`` are called from one
    delivery thread; only the future done-callbacks run in pool threads.
    """

    def __init__(self, codec, jpeg: bool = True, depth: int = 2,
                 stats: Optional[EgressStats] = None, tracer=None,
                 track: int = 0):
        if depth < 1:
            raise ValueError("encode depth must be >= 1")
        self.codec = codec
        self.jpeg = jpeg
        self.depth = depth
        self.stats = stats
        self.tracer = tracer  # obs.trace.Tracer: one egress_encode span
        #   per encoded batch on ``track`` when enabled
        self.track = track
        self._pending: "deque[_EncodeEntry]" = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, rows: Sequence[np.ndarray], metas: Sequence[Any],
               bitmaps: Optional[Sequence[np.ndarray]] = None,
               coeffs: Optional[Sequence[Any]] = None) -> None:
        """``bitmaps`` (delta wire only): per-row device-computed dirty-
        tile reductions (runtime.codec_assist.DeviceDeltaProbe), handed
        through to ``DeltaCodec.encode_batch_async`` so the host skips
        its own change-detection pass. Ignored by full-frame codecs.

        ``coeffs`` (full-transform assist): per-row
        ``transport.codec.CoefficientFrame`` handles from the fused
        device pass — the codec entropy-codes device-quantized blocks
        and never touches pixels, so ``rows`` may be ``[None, ...]``."""
        t0 = time.perf_counter()
        if self.jpeg:
            if coeffs is not None:
                futures = self.codec.encode_batch_async(
                    rows, bitmaps=bitmaps, coeffs=coeffs)
            elif bitmaps is not None:
                futures = self.codec.encode_batch_async(rows,
                                                        bitmaps=bitmaps)
            else:
                futures = self.codec.encode_batch_async(rows)
            entry = _EncodeEntry(list(metas), futures, None, t0)
            for f in futures:
                f.add_done_callback(lambda _f, e=entry: e.mark_done())
        else:
            # Raw wire: zero-copy memoryviews over the staged slab rows
            # (flattened — the wire carries bytes, not shapes).
            payloads = [row.reshape(-1).data for row in rows]
            entry = _EncodeEntry(list(metas), None, payloads, t0)
        self._pending.append(entry)

    def ready(self, block: bool = False) -> List[list]:
        """Completed head batches, each a list of (meta, payload, error)
        rows. ``block=True`` waits for at least the head batch (the
        window-bound path); completed non-head batches always wait their
        turn — ordered delivery is the contract."""
        out = []
        while self._pending:
            entry = self._pending[0]
            if not entry.done():
                if not block:
                    break
                tw = time.perf_counter()
                if entry.futures is not None:
                    for f in entry.futures:
                        try:
                            f.exception()  # waits; result errors surface
                        except Exception:  # noqa: BLE001 — in collect()
                            pass
                wait_ms = (time.perf_counter() - tw) * 1e3
            else:
                wait_ms = 0.0
            self._pending.popleft()
            block = False  # only the head is owed a wait
            # Future.done() flips before done-callbacks run, so the batch
            # can be observed complete with t_done not yet stamped by
            # mark_done — stamp it here rather than record a 0 ms span.
            t_done = entry.t_done
            if entry.futures is not None and t_done <= entry.t_submit:
                entry.t_done = t_done = time.perf_counter()
            if self.stats is not None:
                self.stats.record_encode(
                    encode_ms=(t_done - entry.t_submit) * 1e3,
                    wait_ms=wait_ms)
                # Full-transform assist: drain the host entropy-coding
                # time the codec accumulated for this batch — on that
                # path it is the entire host codec cost (encode_ms wall
                # span still includes pool queueing / drain overlap).
                take = getattr(self.codec, "take_entropy_ms", None)
                if take is not None:
                    ms = take()
                    if ms > 0.0:
                        self.stats.record_entropy(ms)
            tracer = self.tracer
            if tracer is not None and tracer.enabled and entry.futures:
                tracer.complete(EGRESS_ENCODE, entry.t_submit,
                                max(entry.t_done, entry.t_submit),
                                self.track, rows=len(entry.metas))
            out.append(entry.collect())
        return out

    def flush(self) -> List[list]:
        """Drain everything, blocking until the pool finishes."""
        out = []
        while self._pending:
            out.extend(self.ready(block=True))
        return out
