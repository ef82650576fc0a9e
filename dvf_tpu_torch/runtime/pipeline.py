"""The end-to-end pipeline: source → batch staging → device → ordered sink
(port of the single-stream path of ``dvf_tpu.runtime.pipeline``).

Three threads around the engine's CUDA streams:

  ingest    — pulls frames from the source, indexes them, enqueues with
              drop-oldest backpressure;
  dispatch  — drains the queue into a fixed-size batch, stages it through
              the ingest assembler (runtime/ingest.py: streamed row chunks
              copied on the engine's H2D stream as they fill, or the
              monolithic whole-batch buffer), pads a short batch by
              repeating its last frame, submits it to the Engine and starts
              its device→host copy (runtime/egress.py); the in-flight depth
              is bounded to cap latency;
  collect   — waits for results in submission order, feeds the reorder
              buffer, advances the display cursor, emits to the sink
              (``collect_mode="inline"`` folds this into dispatch).

Staging discipline: the assembler and the fetcher each own
``max_inflight + 1`` slots, slot = batch sequence number mod the slot
count. At most ``max_inflight`` batches are outstanding, so a slot being
rewritten always belongs to a batch already collected. Delivered rows are
copied only out of a slab the fetcher owns (it is rewritten when its slot
cycles); the monolithic fetch's fresh per-batch array hands out views.

Fault planes (``resilient``, ``fault_budget``, ``stall_timeout_s``,
``chaos``, ``trace``): per-iteration containment classified by
resilience.faults and bounded by the per-kind error budget (repeated h2d
faults degrade streamed → monolithic ingest, repeated d2h faults the
egress), a stall watchdog whose recovery rebuilds the engine, the
deterministic chaos sites, and the frame-lifecycle tracer. The tracer
(the pipeline's own under ``trace``, or a caller's ``tracer=``, which the
caller reads and which writes no file) also times the dispatch thread
(``pipeline.assemble``, ``pipeline.window_wait``, ``engine.launch``) and
the collect thread (``egress.fetch``, ``pipeline.deliver``), each on a
lane of its own, every span tagged with the batch's ``seq``, and has the
engine time each step on the device (``EngineStats.device_ms``).

The ingest queue is injectable: the default is the Python drop-oldest
queue; ``queue=RingFrameQueue(...)`` (transport/ring_queue.py) puts the
native ring on the path. Frames then cross ingest → dispatch as payloads,
which the queue decodes window by window straight into the staging slab
(``decode_into``), so a decoded window's copy overlaps the next window's
decode; the queue is closed when the run ends.

Observability planes: ``registry`` (obs.registry) carries ``signals()``
and the capture/deliver rates for a scrape endpoint; ``flight_dir`` arms
the flight recorder (a watchdog trip or a hard failure dumps the trace
window and stats); ``device_trace_dir`` runs a ``torch.profiler`` session
(CPU and CUDA activity) around the whole run, exports its Chrome trace
there and, with ``trace=True``, merges it with the host trace into
``dvf_merged_timing.pftrace`` in the same directory.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Optional, Union

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.obs.export import (
    DEVICE_TRACE_FILE,
    FlightRecorder,
    attach_signal_provider,
    start_device_profiler,
)
from dvf_tpu_torch.obs.metrics import EgressStats, IngestStats, LatencyStats, RateLogger
from dvf_tpu_torch.obs.registry import MetricsRegistry
from dvf_tpu_torch.obs.trace import (
    MERGED_TRACE_NAME,
    PIPELINE_ASSEMBLE,
    PIPELINE_DELIVER,
    PIPELINE_WINDOW_WAIT,
    Tracer,
    merge_with_device_trace,
)
from dvf_tpu_torch.resilience.budget import ErrorBudget, escalate
from dvf_tpu_torch.resilience.faults import FaultError, FaultKind, FaultStats, classify
from dvf_tpu_torch.resilience.supervisor import Supervisor
from dvf_tpu_torch.runtime.egress import EGRESS_MODES, ShardedBatchFetcher
from dvf_tpu_torch.runtime.engine import Engine, host_array, resolve_device
from dvf_tpu_torch.runtime.ingest import INGEST_MODES, ShardedBatchAssembler
from dvf_tpu_torch.sched.queues import DropOldestQueue
from dvf_tpu_torch.sched.reorder import ReorderBuffer

# Trace track ids (the reference's): stages, plus the ingest transfer
# lane (ingest_* spans, made on the dispatch thread); then the dispatch
# thread's lane and the collect thread's (egress_* spans included).
TRACK_INGEST, TRACK_DEVICE, TRACK_SINK, TRACK_H2D = 0, 1, 2, 3
TRACK_DISPATCH, TRACK_COLLECT = 5, 6


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int = 8
    frame_delay: int = 5          # display-cursor lag (webcam_app.py:17)
    queue_size: int = 10          # ingest queue bound (distributor.py:11)
    reorder_capacity: int = 50    # reorder cap (distributor.py:23)
    max_inflight: int = 4         # batches in flight; bounds latency
    assemble_timeout_s: float = 0.01  # wait for a short batch to fill
    trace: bool = False           # frame-lifecycle trace (obs.trace),
    #   exported to dvf_frame_timing.pftrace in the working directory
    resilient: bool = False       # per-iteration error containment: one bad
    #   frame/batch is dropped and counted, the loops keep running. Off by
    #   default so tests and benches fail fast.
    telemetry_interval_s: float = 0.0  # >0: print capture/deliver fps every N s
    collect_mode: str = "thread"  # "thread": a collect thread; "inline":
    #   dispatch retires the oldest in-flight batch itself once the window
    #   fills. Batches retire oldest-first either way.
    ingest: str = "streamed"      # "streamed": row chunks copied on the
    #   engine's H2D stream as they fill (runtime/ingest.py); "monolithic":
    #   stage the whole batch, then one copy inside Engine.submit
    ingest_depth: int = 4         # chunk copies in flight before the
    #   assembler waits on the oldest (also the number of chunks)
    egress: str = "streamed"      # "streamed": the D2H starts at submit on
    #   the engine's D2H stream into a pooled pinned slab
    #   (runtime/egress.py); "monolithic": a fresh host array per batch
    fault_budget: int = 16        # contained faults per kind inside
    #   fault_window_s before containment escalates (drop → degrade →
    #   fail); resilient mode only
    fault_window_s: float = 30.0
    stall_timeout_s: float = 0.0  # >0: arm the stall watchdog — an
    #   in-flight batch older than this trips recovery (resilient + thread
    #   collect: shed the window, rebuild the engine; otherwise: abort with
    #   a stall FaultError). 0 = off.
    chaos: Any = None             # resilience.chaos.FaultPlan — arms the
    #   fault-injection sites in the engine, assembler, fetcher and collect
    #   loop; None = zero overhead
    device_trace_dir: Optional[str] = None  # capture a torch.profiler
    #   trace (CPU + CUDA activity) for the whole run into this dir as a
    #   Chrome trace; with trace=True the merged host+device export
    #   (dvf_merged_timing.pftrace) also lands in this dir
    flight_dir: Optional[str] = None  # flight recorder (obs.export): a
    #   watchdog trip or hard pipeline failure dumps the bounded
    #   post-mortem (trace window + stats) here. None = off.
    flight_min_interval_s: float = 10.0  # dump rate limit


class Pipeline:
    def __init__(
        self,
        source: Any,
        filt: Filter,
        sink: Any,
        config: Optional[PipelineConfig] = None,
        engine: Optional[Engine] = None,
        device: Union[None, str, torch.device] = None,
        queue: Optional[Any] = None,
        tracer: Optional[Tracer] = None,
    ):
        if filt.stateful and not filt.pad_safe:
            raise ValueError(
                f"filter {filt.name!r} is stateful and not pad-safe; the "
                f"pipeline pads short batches and cannot run it")
        self.source = source
        self.sink = sink
        self.config = config or PipelineConfig()
        if self.config.collect_mode not in ("thread", "inline"):
            raise ValueError(
                f"collect_mode must be 'thread' or 'inline', got "
                f"{self.config.collect_mode!r}")
        if self.config.ingest not in INGEST_MODES:
            raise ValueError(
                f"ingest must be one of {INGEST_MODES}, got "
                f"{self.config.ingest!r}")
        if self.config.egress not in EGRESS_MODES:
            raise ValueError(
                f"egress must be one of {EGRESS_MODES}, got "
                f"{self.config.egress!r}")
        if engine is None:
            engine = Engine(filt, device=device, chaos=self.config.chaos)
        elif device is not None and resolve_device(device) != engine.device:
            raise ValueError(
                f"engine runs on {engine.device}, pipeline asked for {device}")
        if self.config.chaos is not None and engine.chaos is None:
            engine.chaos = self.config.chaos  # arm a caller-built engine
        self.engine = engine
        self._own_tracer = tracer is None  # only the pipeline's own exports
        self.tracer = Tracer(enabled=self.config.trace) if tracer is None else tracer
        engine.tracer, engine.trace_track = self.tracer, TRACK_DISPATCH
        self.queue = queue if queue is not None else DropOldestQueue(
            maxsize=self.config.queue_size)
        self.reorder = ReorderBuffer(frame_delay=self.config.frame_delay,
                                     capacity=self.config.reorder_capacity)
        self.latency = LatencyStats()
        self.frame_counter = 0
        self.errors = 0
        self.faults = FaultStats()      # per-kind counters + last errors
        self.recoveries = 0             # supervisor engine rebuilds
        self._budget = ErrorBudget(limit=self.config.fault_budget,
                                   window_s=self.config.fault_window_s)
        # Stall escalation is consecutive, not time-windowed: recoveries
        # with no delivered batch in between fail hard.
        self._stalls_since_progress = 0
        self._stall_fail_after = max(2, self.config.fault_budget // 4)
        self._ingest_mode = self.config.ingest  # may degrade to monolithic
        self._degrade_reason: Optional[str] = None
        self._egress_mode = self.config.egress
        self._egress_degrade_reason: Optional[str] = None
        self._assembler: Optional[ShardedBatchAssembler] = None
        self._ingest_stats: Optional[IngestStats] = None
        self._fetcher: Optional[ShardedBatchFetcher] = None
        self._egress_stats: Optional[EgressStats] = None
        self._supervisor: Optional[Supervisor] = None
        self._recovering = threading.Event()  # dispatch parks while the
        #   supervisor swaps the engine (see _on_stall)
        # Metrics registry (obs.registry): the scrape endpoint's source
        # for this pipeline. The RateLoggers land their rates as the
        # rate_fps gauge on the ticks they print; the provider adapts
        # signals() at scrape.
        self.registry = MetricsRegistry()
        attach_signal_provider(self.registry, "pipeline", self.signals)
        self.flight: Optional[FlightRecorder] = None
        if self.config.flight_dir:
            self.flight = FlightRecorder(
                self.config.flight_dir, label="pipeline",
                min_interval_s=self.config.flight_min_interval_s,
                trace_fn=lambda: [self.tracer.snapshot()],
                stats_fn=self.stats)
        _ti = self.config.telemetry_interval_s
        self._capture_rate = RateLogger("capture", _ti if _ti > 0 else 5.0,
                                        quiet=_ti <= 0,
                                        registry=self.registry)
        self._deliver_rate = RateLogger("deliver", _ti if _ti > 0 else 5.0,
                                        quiet=_ti <= 0,
                                        registry=self.registry)
        self._on_idle = None  # inline collect: drain-ready hook (_assemble)
        self._inflight = DropOldestQueue(maxsize=1_000_000)
        self._inflight_sem = threading.Semaphore(self.config.max_inflight)
        self._eof = threading.Event()
        self._dispatch_done = threading.Event()
        self._abort = threading.Event()
        self._stop_requested = threading.Event()
        self._error: Optional[BaseException] = None

    def stop(self) -> None:
        """Graceful shutdown: stop ingesting, drain what is in flight,
        deliver the tail; run() then returns normally."""
        self._stop_requested.set()

    def abort(self) -> None:
        """Hard stop: drop everything in flight and unwind now."""
        self._stop_requested.set()
        self._abort.set()

    # ------------------------------------------------------------------

    def _fail(self, e: BaseException) -> None:
        first = self._error is None
        if first:
            self._error = e
        self._abort.set()
        if first and self.flight is not None:
            # Hard failure: the post-mortem moment (off-thread,
            # rate-limited in the recorder).
            self.flight.trigger_async(f"pipeline failed: {e!r}")

    def _flight_trip(self, reason: str) -> None:
        """Supervisor on_trip tap: dump the black box before recovery
        tears the evidence down (off-thread — a disk write must not
        extend the stall it records)."""
        if self.flight is not None:
            self.flight.trigger_async(reason)

    def _contain(self, e: BaseException, where: str) -> bool:
        """Resilient mode: drop, count, continue — classified
        (resilience.faults) and bounded by the per-kind error budget: the
        first overflow degrades (h2d: streamed → monolithic ingest; d2h:
        the egress), the second fails hard. Fail-fast mode: abort the
        pipeline. Returns True to continue."""
        kind = classify(e, site=where)
        self.faults.record(kind, e)
        if not (self.config.resilient and isinstance(e, Exception)):
            self._fail(e)
            return False
        self.errors += 1
        if escalate(self._budget, kind, self._degrade) == ErrorBudget.CONTAIN:
            print(f"[pipeline:{where}] {kind} fault (continuing): {e!r}",
                  file=sys.stderr, flush=True)
            return True
        self._fail(FaultError(
            kind,
            f"error budget exhausted for {kind!r} faults "
            f"(> {self.config.fault_budget} in "
            f"{self.config.fault_window_s:g}s, no degradation left); "
            f"last: {e!r}"))
        return False

    def _degrade(self, kind: str) -> bool:
        """Apply this kind's degradation, if one exists (reason recorded in
        the ingest / egress stats). Returns True if one was applied."""
        if kind == FaultKind.H2D and self._ingest_mode == "streamed":
            self._ingest_mode = "monolithic"
            self._degrade_reason = "h2d_fault_budget"
            self._assembler = None  # rebuilt monolithic on the next batch
            print("[pipeline] repeated h2d faults: degrading ingest "
                  "streamed → monolithic", file=sys.stderr, flush=True)
            return True
        if kind == FaultKind.D2H and self._egress_mode == "streamed":
            self._egress_mode = "monolithic"
            self._egress_degrade_reason = "d2h_fault_budget"
            old, self._fetcher = self._fetcher, None
            if old is not None:
                old.release()
            print("[pipeline] repeated d2h faults: degrading egress "
                  "streamed → monolithic", file=sys.stderr, flush=True)
            return True
        return False

    def _on_stall(self, reason: str) -> None:
        """Watchdog callback (supervisor thread): a submitted batch aged
        past stall_timeout_s. Resilient + thread collect: shed the
        in-flight window and rebuild the engine (recompile, re-warm,
        re-calibrate). Inline collect or fail-fast: abort with a stall
        fault."""
        e = FaultError(FaultKind.STALL, f"pipeline stalled: {reason}")
        self.faults.record(FaultKind.STALL, e)
        self._stalls_since_progress += 1
        recoverable = (self.config.resilient
                       and self.config.collect_mode == "thread"
                       and self._stalls_since_progress <= self._stall_fail_after)
        if not recoverable:
            self._fail(e)
            return
        self.errors += 1
        print(f"[pipeline] {reason}: shedding in-flight window and "
              f"rebuilding engine", file=sys.stderr, flush=True)
        self._recovering.set()
        try:
            shed = self._inflight.pop_up_to(len(self._inflight))
            for item in shed:
                self._supervisor.window.remove(item[0])
            # Rebuild BEFORE releasing the shed permits, so a dispatch
            # blocked on the semaphore wakes to the fresh engine.
            self.engine = self.engine.rebuild()
            self._assembler = None
            self._fetcher = None  # rebuilt against the fresh engine's
            #   streams and re-calibrated d2h_block_ms
            for _ in shed:
                self._inflight_sem.release()
            self._supervisor.window.drain()
            self.recoveries += 1
        finally:
            self._recovering.clear()

    def _ingest(self) -> None:
        it = iter(self.source)
        try:
            while not self._abort.is_set() and not self._stop_requested.is_set():
                try:
                    frame, ts = next(it)
                except StopIteration:
                    break
                except Exception as e:  # noqa: BLE001 — bad read, maybe next works
                    if not self._contain(e, "ingest"):
                        return
                    continue
                if frame is None:
                    break
                idx = self.frame_counter
                self.frame_counter += 1
                if self.queue.put((idx, frame, ts)) is not None:
                    # The source outruns the pipeline (drop-oldest evicted
                    # a frame): yield, so an unthrottled source spinning
                    # here does not starve dispatch/collect of the GIL.
                    time.sleep(0.0002)
                self._capture_rate.tick()
                if self.tracer.enabled:
                    self.tracer.instant("frame_captured", self.tracer.perf_of_wall(ts),
                                        TRACK_INGEST, frame=idx)
        except BaseException as e:  # noqa: BLE001 — surfaces from run()
            self._fail(e)
        finally:
            self._eof.set()
            if hasattr(it, "close"):
                it.close()

    def _assemble(self) -> Optional[list]:
        """Collect up to batch_size fresh frames; None = stream finished."""
        b = self.config.batch_size
        items: list = self.queue.pop_up_to(b)
        deadline = None  # started at the first frame, not at call time
        while len(items) < b and not self._abort.is_set():
            if items:
                if deadline is None:
                    deadline = time.perf_counter() + self.config.assemble_timeout_s
                elif time.perf_counter() > deadline:
                    break
            if self._eof.is_set() and len(self.queue) == 0:
                break
            got = self.queue.pop_up_to(b - len(items))
            if got:
                items.extend(got)
            else:
                if self._on_idle is not None:
                    # Inline collect: deliver batches the device already
                    # finished while waiting for frames.
                    self._on_idle()
                time.sleep(0.0005)
        if not items and (self._eof.is_set() or self._abort.is_set()):
            return None
        return items

    def _builder_for(self, frame_shape, dtype, slot: int):
        """One staged batch via the assembler (runtime/ingest.py), which
        owns ``max_inflight + 1`` slots. Rebuilt when the frame signature
        changes, after a degradation and after an engine rebuild."""
        shape = (self.config.batch_size, *frame_shape)
        dtype = np.dtype(dtype)
        asm = self._assembler
        if asm is None or asm.batch_shape != shape or asm.dtype != dtype:
            # The engine's warm-up put calibrates the un-overlapped H2D
            # cost the overlap_efficiency metric is judged against.
            self.engine.ensure_compiled(shape, dtype)
            self._ingest_stats = IngestStats(
                requested_mode=self.config.ingest,
                depth=self.config.ingest_depth,
                h2d_block_ms=self.engine.h2d_block_ms)
            self._assembler = asm = ShardedBatchAssembler(
                shape, dtype, self.engine.placement,
                mode=self._ingest_mode, depth=self.config.ingest_depth,
                slots=self.config.max_inflight + 1,
                tracer=self.tracer, track=TRACK_H2D,
                stats=self._ingest_stats, chaos=self.config.chaos,
                stream=self.engine.h2d_stream_for)
            if self._degrade_reason is not None:
                self._ingest_stats.fallback_reason = self._degrade_reason
        return asm.begin(slot)

    def _fetcher_for(self) -> ShardedBatchFetcher:
        """The egress fetcher for the engine's compiled output signature
        (runtime/egress.py), ``max_inflight + 1`` slabs. Rebuilt when the
        output signature changes or the engine was rebuilt."""
        shape, dtype = self.engine.out_shape, self.engine.out_dtype
        f = self._fetcher
        if f is None or f.out_shape != tuple(shape) or f.dtype != dtype:
            self._egress_stats = EgressStats(
                requested_mode=self.config.egress,
                d2h_block_ms=self.engine.d2h_block_ms)
            self._fetcher = f = ShardedBatchFetcher(
                shape, dtype, self.engine.placement,
                mode=self._egress_mode,
                slots=self.config.max_inflight + 1,
                stats=self._egress_stats,
                tracer=self.tracer, track=TRACK_COLLECT,
                chaos=self.config.chaos, stream=self.engine.d2h_stream_for)
            if self._egress_degrade_reason is not None:
                self._egress_stats.fallback_reason = \
                    self._egress_degrade_reason
        return f

    def _drain_ready(self, pending: deque) -> bool:
        """Inline collect: retire the oldest batch while the window is
        full, plus any results already complete (oldest-first). Returns
        False only when an error escaped containment."""
        while pending:
            if (len(pending) < self.config.max_inflight
                    and not pending[0][3].is_ready()):
                break
            if not self._collect_one(*pending.popleft(), release=False):
                return False
        return True

    def _dispatch(self) -> None:
        seq = 0
        inline = self.config.collect_mode == "inline"
        pending: deque = deque()  # inline mode's in-flight window
        if inline:
            self._on_idle = lambda: self._drain_ready(pending)
        tracer = self.tracer if self.tracer.enabled else None
        t0 = 0.0  # batch_complete's start, stamped when traced
        try:
            while not self._abort.is_set():
                if tracer is not None:
                    ta = time.perf_counter()
                items = self._assemble()
                if tracer is not None:
                    tracer.complete(PIPELINE_ASSEMBLE, ta, time.perf_counter(),
                                    TRACK_DISPATCH, seq=seq)
                if items is None:
                    break
                if not items:
                    continue
                while self._recovering.is_set() and not self._abort.is_set():
                    # Stall recovery is swapping the engine: park with the
                    # assembled frames in hand.
                    time.sleep(0.001)
                valid = len(items)
                if inline:
                    if not self._drain_ready(pending):
                        return
                else:
                    # Acquired BEFORE touching the staging slot: the permit
                    # is what makes slot reuse safe. Polled, so a dead
                    # collect thread cannot wedge dispatch.
                    if tracer is not None:
                        tw = time.perf_counter()
                    while not self._inflight_sem.acquire(timeout=0.1):
                        if self._abort.is_set():
                            return
                    if tracer is not None:
                        tracer.complete(PIPELINE_WINDOW_WAIT, tw, time.perf_counter(),
                                        TRACK_DISPATCH, seq=seq)
                try:
                    decode = getattr(self.queue, "decode_into", None)
                    if decode is not None:
                        # Ring transport: items carry payloads; the queue
                        # decodes them into the staging slab one chunk
                        # window at a time, and committing a window starts
                        # its copy under the next window's decode.
                        builder = self._builder_for(
                            self.queue.frame_shape, self.queue.frame_dtype, seq)
                        for start, stop in builder.windows(valid):
                            decode(items[start:stop],
                                   builder.window_view(start, stop))
                            builder.commit_window(start, stop)
                    else:
                        f0 = items[0][1]
                        builder = self._builder_for(f0.shape, f0.dtype, seq)
                        for row, (_, frame, _) in enumerate(items):
                            builder.write_row(row, frame)
                    # finish() pads a short batch by repeating the last
                    # frame (one signature; the padded outputs are
                    # dropped) and flushes the remaining chunk copies.
                    batch, resident = builder.finish(valid)
                    tag = {}  # the traced launch's seq
                    if tracer is not None:
                        t0 = time.perf_counter()
                        tag["seq"] = seq
                    result = (self.engine.submit_resident(batch, ready=builder.ready, **tag)
                              if resident else self.engine.submit(batch, fetch=False, **tag))
                    # Start the D2H now, under the next batch's staging and
                    # this batch's compute; collect then only waits.
                    self._fetcher_for().prefetch(result, seq)
                except Exception as e:  # noqa: BLE001 — drop this batch
                    if not inline:
                        self._inflight_sem.release()
                    if not self._contain(e, "dispatch"):
                        return
                    continue
                if self._supervisor is not None:
                    self._supervisor.window.add(seq)
                meta = [(idx, ts) for idx, _, ts in items]
                if inline:
                    pending.append((seq, meta, valid, result, t0))
                else:
                    self._inflight.put((seq, meta, valid, result, t0))
                seq += 1
            # Inline mode drains its window at end of stream or graceful
            # stop; a hard abort drops it, like the collect thread.
            while pending and not self._abort.is_set():
                if not self._collect_one(*pending.popleft(), release=False):
                    return
        except BaseException as e:  # noqa: BLE001 — surfaces from run()
            self._fail(e)
        finally:
            self._dispatch_done.set()

    def _collect_one(self, seq, meta, valid, result, t0, release=True) -> bool:
        """Wait for one batch and hand its valid rows to the reorder buffer
        and the sink; returns False only when an error escaped
        containment."""
        fetcher = self._fetcher
        try:
            if fetcher is None:
                # Degraded mid-flight (the fetcher was released): the
                # classic fetch, after the batch's compute.
                if result.compute_event is not None:
                    result.compute_event.synchronize()
                out = host_array(result.device.cpu())
            else:
                out = fetcher.fetch(result, seq)
        except Exception as e:  # noqa: BLE001 — device error: drop batch
            if self._supervisor is not None:
                self._supervisor.window.remove(seq)
            if release:
                self._inflight_sem.release()
            return self._contain(e, "collect")
        if self._supervisor is not None:
            self._supervisor.window.remove(seq)
            self._stalls_since_progress = 0  # the engine made progress
        if release:
            self._inflight_sem.release()
        tracer = self.tracer if self.tracer.enabled else None
        if tracer is not None:
            if getattr(result, "timing_start", None) is not None:
                self.engine.settle_timing(result)
            td = time.perf_counter()
            tracer.complete("batch_complete", t0, td, TRACK_DEVICE,
                            frames=[i for i, _ in meta])
        # A pooled slab is rewritten max_inflight + 1 batches later; rows
        # the reorder buffer keeps across frame_delay must own their
        # bytes. The monolithic fetch's fresh array keeps handing out views.
        copy_rows = fetcher is not None and fetcher.owns(out)
        for row, (idx, ts) in enumerate(meta[:valid]):
            frame = out[row].copy() if copy_rows else out[row]
            self.reorder.complete(idx, (frame, ts))
        self._deliver()
        if tracer is not None:
            tracer.complete(PIPELINE_DELIVER, td, time.perf_counter(), TRACK_COLLECT,
                            seq=seq)
        return True

    def _collect(self) -> None:
        chaos = self.config.chaos
        try:
            while not self._abort.is_set():
                if chaos is not None:
                    chaos.fire("freeze")  # injection site: a delay rule
                    #   wedges this consumer so the stall watchdog has a
                    #   deterministic stall to catch
                try:
                    item = self._inflight.get(timeout=0.05)
                except TimeoutError:
                    if self._dispatch_done.is_set() and len(self._inflight) == 0:
                        break
                    continue
                if not self._collect_one(*item):
                    return
        except BaseException as e:  # noqa: BLE001 — surfaces from run()
            self._fail(e)

    def _deliver(self, flush: bool = False) -> None:
        if flush:
            # End of stream: let the cursor reach the newest frame so the
            # tail (< frame_delay deep) is delivered too.
            self.reorder.flush()
        self.reorder.advance()
        for idx, (frame, ts) in self.reorder.pop_ready():
            self.latency.record(time.time() - ts)
            self._deliver_rate.tick()
            if self.tracer.enabled:
                self.tracer.instant("frame_delivered", track=TRACK_SINK, frame=idx)
            try:
                self.sink.emit(idx, frame, ts)
            except Exception as e:  # noqa: BLE001 — a display hiccup must
                if not self._contain(e, "sink"):  # not kill the stream
                    return

    # ------------------------------------------------------------------

    def run(self) -> dict:
        """Run to the end of the stream (or Ctrl-C); returns stats()."""
        prof = None
        if self.config.device_trace_dir:
            os.makedirs(self.config.device_trace_dir, exist_ok=True)
            prof = start_device_profiler()
            # Host-clock epoch of the profiler session: the fallback
            # alignment of the merged export when the device trace
            # carries no base time of its own.
            self._device_trace_epoch = time.time()
        threads = [
            threading.Thread(target=self._ingest, name="dvf-ingest", daemon=True),
            threading.Thread(target=self._dispatch, name="dvf-dispatch", daemon=True),
        ]
        if self.config.collect_mode != "inline":
            threads.append(threading.Thread(target=self._collect,
                                            name="dvf-collect", daemon=True))
        if self.config.stall_timeout_s > 0:
            self._supervisor = Supervisor(
                self.config.stall_timeout_s, on_stall=self._on_stall,
                name="dvf-pipeline-supervisor",
                on_trip=self._flight_trip).start()
        try:
            for t in threads:
                t.start()
            while any(t.is_alive() for t in threads):
                try:
                    for t in threads:
                        t.join(timeout=0.2)
                except KeyboardInterrupt:
                    # First Ctrl-C: graceful stop; second: abort.
                    if self._stop_requested.is_set():
                        self.abort()
                    else:
                        print("\n[pipeline] stopping (Ctrl-C again to abort)…",
                              file=sys.stderr, flush=True)
                        self.stop()
        finally:
            if self._supervisor is not None:
                self._supervisor.stop()
            # Always stop the profiler — the abort path is exactly the
            # run someone inspects.
            if prof is not None:
                self._stop_device_trace(prof)
        if self._error is not None:
            raise self._error
        if not self._abort.is_set():
            self._deliver(flush=True)
        self.sink.close()
        if hasattr(self.queue, "close"):
            self.queue.close()  # ring transport: the ring and its codecs
        if self.tracer.enabled and self._own_tracer:
            host_trace = self.tracer.export()
            if host_trace and prof is not None:
                # One file with the host frame-lifecycle lanes above the
                # profiler's lanes, beside the device trace it merges.
                try:
                    d = self.config.device_trace_dir
                    merge_with_device_trace(
                        host_trace, d, os.path.join(d, MERGED_TRACE_NAME),
                        int((self._device_trace_epoch
                             - self.tracer.start_time) * 1e6),
                        host_start_s=self.tracer.start_time)
                except Exception as e:  # noqa: BLE001 — teardown garnish:
                    # a merge failure must not fail a run that delivered.
                    print(f"[trace] merged export failed: {e!r}",
                          file=sys.stderr)
        return self.stats()

    def _stop_device_trace(self, prof) -> None:
        """Stop the run's profiler and export its Chrome trace into
        ``device_trace_dir`` (best-effort: an export failure is printed,
        never raised over the run's own outcome)."""
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                self.config.device_trace_dir, DEVICE_TRACE_FILE))
        except Exception as e:  # noqa: BLE001
            print(f"[trace] device trace export failed: {e!r}",
                  file=sys.stderr)

    def health(self) -> dict:
        """Cheap liveness export: no percentile work. ``ok`` flips False
        once the pipeline has failed."""
        err = self._error
        return {
            "ok": err is None,
            "error": repr(err) if err is not None else None,
            "delivered": self.latency.count,
            "errors": self.errors,
            "recoveries": self.recoveries,
        }

    def signals(self) -> dict:
        """Flat load-control signal row (the reference's registry-conformant
        keys)."""
        agg = self.latency.summary()
        out = {
            "fps": agg.get("fps"),
            "p50_ms": agg.get("p50_ms"),
            "p90_ms": agg.get("p90_ms"),
            "p99_ms": agg.get("p99_ms"),
            "queue_depth": float(len(self.queue)),
            "inflight_batches": float(len(self._inflight)),
            "produced_total": float(self.frame_counter),
            "delivered_total": float(self.latency.count),
            "dropped_at_ingest_total": float(self.queue.dropped),
            "errors_total": float(self.errors),
            "recoveries_total": float(self.recoveries),
            "engine_batches_total": float(self.engine.stats.batches),
            "trace_dropped_total": float(self.tracer.dropped),
        }
        ing, egr = self._ingest_stats, self._egress_stats
        if ing is not None:
            out["ingest_overlap_efficiency"] = ing.overlap_efficiency()
        if egr is not None:
            out["egress_overlap_efficiency"] = egr.overlap_efficiency()
        for kind, n in self.faults.summary()["by_kind"].items():
            out[f"fault_{kind}_total"] = float(n)
        return out

    def stats(self) -> dict:
        out = {
            **self.reorder.stats(),
            "frames_produced_total": self.frame_counter,
            "dropped_at_ingest": self.queue.dropped,
            "transport": type(self.queue).__name__,
            "errors": self.errors,
            "delivered": self.latency.count,
            "engine_batches": self.engine.stats.batches,
            "faults": self.faults.summary(),
            "recoveries": self.recoveries,
            **self.latency.summary(),
        }
        es = self.engine.stats
        if es.timed_batches:  # a traced run on a card
            out["engine_device_ms"] = round(es.device_ms / es.timed_batches, 4)
        if self._ingest_stats is not None:
            out["ingest"] = self._ingest_stats.summary()
        if self._egress_stats is not None:
            out["egress"] = self._egress_stats.summary()
        if self.config.chaos is not None:
            out["chaos"] = self.config.chaos.summary()
        return out
