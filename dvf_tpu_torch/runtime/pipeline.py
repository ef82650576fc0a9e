"""The end-to-end pipeline: source → batch staging → device → ordered sink
(port of the single-stream path of ``dvf_tpu.runtime.pipeline``).

Three threads around the engine's asynchronous CUDA stream:

  ingest    — pulls frames from the source, indexes them, enqueues with
              drop-oldest backpressure;
  dispatch  — drains the queue into a fixed-size batch, writes it into a
              pinned staging slot (padding a short batch by repeating its
              last frame), submits it to the Engine; the in-flight depth is
              bounded to cap latency;
  collect   — waits for results in submission order, feeds the reorder
              buffer, advances the display cursor, emits to the sink
              (``collect_mode="inline"`` folds this into dispatch).

Staging discipline: ``max_inflight + 1`` pinned input slots and as many
pinned output slots, slot = batch sequence number mod the slot count. At
most ``max_inflight`` batches are outstanding, so the slot being rewritten
always belongs to a batch already collected; delivered rows are copied out
of the reused output slab before the reorder buffer holds them.

Not in this slice: streamed ingest/egress, the tracer, fault containment
and supervision, chaos injection, the flight recorder and device traces.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from collections import deque
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.obs.metrics import LatencyStats, RateLogger
from dvf_tpu_torch.runtime.engine import Engine, _torch_dtype, resolve_device
from dvf_tpu_torch.sched.queues import DropOldestQueue
from dvf_tpu_torch.sched.reorder import ReorderBuffer


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int = 8
    frame_delay: int = 5          # display-cursor lag (webcam_app.py:17)
    queue_size: int = 10          # ingest queue bound (distributor.py:11)
    reorder_capacity: int = 50    # reorder cap (distributor.py:23)
    max_inflight: int = 4         # batches in flight; bounds latency
    assemble_timeout_s: float = 0.01  # wait for a short batch to fill
    telemetry_interval_s: float = 0.0  # >0: print capture/deliver fps every N s
    collect_mode: str = "thread"  # "thread": a collect thread; "inline":
    #   dispatch retires the oldest in-flight batch itself once the window
    #   fills. Batches retire oldest-first either way.


class Pipeline:
    def __init__(
        self,
        source: Any,
        filt: Filter,
        sink: Any,
        config: Optional[PipelineConfig] = None,
        engine: Optional[Engine] = None,
        device: Union[None, str, torch.device] = None,
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
        if engine is None:
            engine = Engine(filt, device=device)
        elif device is not None and resolve_device(device) != engine.device:
            raise ValueError(
                f"engine runs on {engine.device}, pipeline asked for {device}")
        self.engine = engine
        self.queue = DropOldestQueue(maxsize=self.config.queue_size)
        self.reorder = ReorderBuffer(frame_delay=self.config.frame_delay,
                                     capacity=self.config.reorder_capacity)
        self.latency = LatencyStats()
        self.frame_counter = 0
        _ti = self.config.telemetry_interval_s
        self._capture_rate = RateLogger("capture", _ti if _ti > 0 else 5.0,
                                        quiet=_ti <= 0)
        self._deliver_rate = RateLogger("deliver", _ti if _ti > 0 else 5.0,
                                        quiet=_ti <= 0)
        self._slots: Optional[List[Tuple[torch.Tensor, np.ndarray, torch.Tensor]]] = None
        self._slot_sig: Optional[Tuple] = None
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
        if self._error is None:
            self._error = e
        self._abort.set()

    def _ingest(self) -> None:
        it = iter(self.source)
        try:
            while not self._abort.is_set() and not self._stop_requested.is_set():
                try:
                    frame, ts = next(it)
                except StopIteration:
                    break
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

    def _slot(self, frame_shape, dtype, seq: int):
        """The (input tensor, its numpy view, output tensor) of the staging
        slot for batch ``seq``. The slots are allocated once per frame
        signature, pinned when the engine is on CUDA."""
        shape = (self.config.batch_size, *frame_shape)
        sig = (shape, np.dtype(dtype))
        if self._slot_sig != sig:
            self.engine.ensure_compiled(shape, dtype)
            pin = self.engine.on_cuda
            out_dtype = _torch_dtype(self.engine.out_dtype)
            self._slots = []
            for _ in range(self.config.max_inflight + 1):
                inp = torch.empty(shape, dtype=_torch_dtype(dtype), pin_memory=pin)
                out = torch.empty(self.engine.out_shape, dtype=out_dtype,
                                  pin_memory=pin)
                self._slots.append((inp, inp.numpy(), out))
            self._slot_sig = sig
        return self._slots[seq % len(self._slots)]

    def _drain_ready(self, pending: deque) -> None:
        """Inline collect: retire the oldest batch while the window is
        full, plus any results already complete (oldest-first)."""
        while pending:
            if (len(pending) < self.config.max_inflight
                    and not pending[0][2].is_ready()):
                break
            self._collect_one(*pending.popleft(), release=False)

    def _dispatch(self) -> None:
        seq = 0
        inline = self.config.collect_mode == "inline"
        pending: deque = deque()  # inline mode's in-flight window
        if inline:
            self._on_idle = lambda: self._drain_ready(pending)
        try:
            while not self._abort.is_set():
                items = self._assemble()
                if items is None:
                    break
                if not items:
                    continue
                valid = len(items)
                if inline:
                    self._drain_ready(pending)
                else:
                    # Acquired BEFORE touching the staging slot: the permit
                    # is what makes slot reuse safe. Polled, so a dead
                    # collect thread cannot wedge dispatch.
                    while not self._inflight_sem.acquire(timeout=0.1):
                        if self._abort.is_set():
                            return
                f0 = items[0][1]
                inp, view, out = self._slot(f0.shape, f0.dtype, seq)
                for row, (_, frame, _) in enumerate(items):
                    view[row] = frame
                # Pad a short batch by repeating the last frame: one
                # signature, and the padded outputs are dropped.
                view[valid:] = view[valid - 1]
                result = self.engine.submit(inp, out=out)
                meta = [(idx, ts) for idx, _, ts in items]
                if inline:
                    pending.append((meta, valid, result))
                else:
                    self._inflight.put((meta, valid, result))
                seq += 1
            # Inline mode drains its window at end of stream or graceful
            # stop; a hard abort drops it, like the collect thread.
            while pending and not self._abort.is_set():
                self._collect_one(*pending.popleft(), release=False)
        except BaseException as e:  # noqa: BLE001 — surfaces from run()
            self._fail(e)
        finally:
            self._dispatch_done.set()

    def _collect_one(self, meta, valid, result, release=True) -> None:
        """Wait for one batch and hand its valid rows to the reorder
        buffer and the sink."""
        try:
            out = result.fetch()
        finally:
            if release:
                self._inflight_sem.release()
        # The output slab is rewritten max_inflight + 1 batches later; rows
        # the reorder buffer keeps across frame_delay must own their bytes.
        for row, (idx, ts) in enumerate(meta[:valid]):
            self.reorder.complete(idx, (out[row].copy(), ts))
        self._deliver()

    def _collect(self) -> None:
        try:
            while not self._abort.is_set():
                try:
                    item = self._inflight.get(timeout=0.05)
                except TimeoutError:
                    if self._dispatch_done.is_set() and len(self._inflight) == 0:
                        break
                    continue
                self._collect_one(*item)
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
            self.sink.emit(idx, frame, ts)

    # ------------------------------------------------------------------

    def run(self) -> dict:
        """Run to the end of the stream (or Ctrl-C); returns stats()."""
        threads = [
            threading.Thread(target=self._ingest, name="dvf-ingest", daemon=True),
            threading.Thread(target=self._dispatch, name="dvf-dispatch", daemon=True),
        ]
        if self.config.collect_mode != "inline":
            threads.append(threading.Thread(target=self._collect,
                                            name="dvf-collect", daemon=True))
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
        if self._error is not None:
            raise self._error
        if not self._abort.is_set():
            self._deliver(flush=True)
        self.sink.close()
        return self.stats()

    def stats(self) -> dict:
        return {
            **self.reorder.stats(),
            "frames_produced_total": self.frame_counter,
            "dropped_at_ingest": self.queue.dropped,
            "delivered": self.latency.count,
            "engine_batches": self.engine.stats.batches,
            **self.latency.summary(),
        }
