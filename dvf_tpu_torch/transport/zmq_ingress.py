"""ZMQ ingress: a card-backed worker that speaks the reference's wire
protocol (port of ``dvf_tpu/transport/zmq_ingress.py``), so the reference
app can drive the port unmodified.

Wire protocol (SURVEY.md §2 "Wire protocol"):

- distribute channel: DEALER connects to the app's ROUTER (default :5555)
  and requests work with ``[b"READY"]`` (worker.py:39); the app replies
  ``[frame_index_ascii, frame_bytes]`` (distributor.py:236-238), at most
  one frame per READY;
- collect channel: PUSH connects to the app's PULL (default :5556) and
  sends ``[frame_index, pid, start_time, end_time, payload]``, metadata
  stringified (worker.py:63-67).

One process keeps ``batch_size`` READY credits outstanding, assembles the
arriving frames into a batch, runs the filter once on the card and pushes
each result back on its own. On the temporal-delta wire the card also
finds the dirty tiles (K5) and, with ``codec_assist="full"``, runs the
JPEG transform (K6), so the host entropy-codes only the dirty tiles'
coefficient blocks.

The batch step (:meth:`ZmqWorker.process_batch`: decode → engine → assist
→ codec plane → send) takes a ``send`` callable, so it runs with or
without sockets. Frames are staged through the streamed ingest
assembler (runtime/ingest.py, one slot: the step waits for each batch
before the next is staged) and fetched through the egress fetcher
(runtime/egress.py, ``egress_depth + 1`` slabs: the codec plane holds at
most ``egress_depth`` batches' rows). Wire faults (a delta frame that
cannot be decoded, a corrupt JPEG, a malformed reply) are contained in
the step; in the socket loop every other per-batch failure is contained
too. Each is classified (resilience.faults) and bounded by the per-kind
error budget: repeated h2d faults degrade ingest streamed → monolithic,
repeated d2h faults the egress, repeated delta wire faults the delta wire
to keyframes only; the next overflow fails. ``chaos`` arms the decode,
transport, h2d, d2h, compute and oom sites.

``transport="ring"`` stages arriving payloads in a private native
:class:`~dvf_tpu_torch.transport.ring.FrameRing` between the socket
receive and the batch step (drop-oldest if the app ever outruns
assembly). The worker's tracer lane carries ``batch_complete``,
``egress_encode`` and ``egress_send`` spans; its ledger records each
engine compile; an armed ``heartbeat`` turns DEALER silence beyond its
timeout into a budgeted partition fault answered by a jittered-backoff
socket rebuild; ``signals()`` is its flat metrics row. Every batch
stamps its assemble_h2d / device / d2h hops into a bounded attribution
window (obs/lineage.py; the device hop ends at a wait on the batch's own
compute event), and ``audit_wire`` wraps the wire in the audit envelope
(obs/audit.py): incoming payloads are verified before decode (a mismatch
raises ``WireIntegrityError`` attributed to the ``zmq_ingress`` hop),
results stamped after encode (the ``zmq_egress`` hop, where the
``corrupt_wire`` chaos site flips a bit).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.obs.export import attach_signal_provider
from dvf_tpu_torch.obs.metrics import EgressStats, IngestStats
from dvf_tpu_torch.obs.registry import MetricsRegistry
from dvf_tpu_torch.obs.trace import EGRESS_SEND, Tracer
from dvf_tpu_torch.resilience.budget import ErrorBudget, escalate
from dvf_tpu_torch.resilience.faults import FaultError, FaultKind, FaultStats, classify
from dvf_tpu_torch.runtime.egress import EGRESS_MODES, AsyncCodecPlane, ShardedBatchFetcher
from dvf_tpu_torch.runtime.engine import Engine, wait_compute
from dvf_tpu_torch.runtime.ingest import INGEST_MODES, ShardedBatchAssembler
from dvf_tpu_torch.transport.codec import (
    WIRE_MODES,
    DeltaCodec,
    DeltaWireError,
    JpegGeometryError,
    make_wire_codec,
)

READY = b"READY"  # work-request token (worker.py:39)

# send(frame_index, start_time, end_time, payload)
SendFn = Callable[[int, float, float, bytes], None]


def parse_frame_reply(parts: list) -> Optional[tuple]:
    """App → worker frame reply ``[frame_index_ascii, frame_bytes]``
    (distributor.py:236-238) → ``(index, payload)``; None if malformed
    (wrong part count, non-integer index)."""
    if len(parts) != 2:
        return None
    try:
        return int(parts[0].decode()), parts[1]
    except ValueError:
        return None


def result_msg(index: int, pid: bytes, t0: float, t1: float,
               payload: bytes) -> list:
    """Worker → app result ``[frame_index, pid, start_time, end_time,
    payload]``, metadata stringified (worker.py:63-67)."""
    return [str(index).encode(), pid, str(t0).encode(), str(t1).encode(),
            payload]


class ZmqWorker:
    """Card-backed worker endpoint for the reference's socket pair (the
    port's ``TpuZmqWorker``).

    ``wire`` is ``"raw"`` (uint8 RGB frames of ``raw_size``², the
    reference's non-JPEG path), ``"jpeg"`` or ``"delta"`` (the
    temporal-delta wire in both directions); None takes the legacy
    ``use_jpeg`` flag (True: ``"jpeg"``, False: ``"raw"``). On the delta wire
    ``codec_assist`` picks the device stage: ``"none"`` (host change
    detection), ``"probe"`` (dirty-tile bitmaps on the card, K5) or
    ``"full"`` (bitmaps, YCbCr 4:2:0, DCT and quantization on the card, K5
    + K6; the host entropy-codes coefficient blocks and fetches no pixels).
    ``codec`` replaces the wire codec the worker would build (for example
    a ``DeltaCodec`` over a ``RawCodec``: a delta wire without JPEG).
    ``connect=False`` opens no sockets and needs no ``zmq``: the caller
    then calls :meth:`process_batch` itself. ``ingest``/``ingest_depth``
    and ``egress``/``egress_depth`` are the reference's staging and fetch
    knobs; ``fault_budget``/``fault_window_s`` bound containment per fault
    kind; ``chaos`` is a ``resilience.chaos.FaultPlan``. ``delay_s`` sleeps
    before each batch's submit (a slow worker, as the reference's
    ``--delay``); ``transport`` is ``"list"`` or ``"ring"``; ``tracer`` /
    ``trace``, ``ledger`` and ``heartbeat`` (a
    ``resilience.continuity.HeartbeatConfig``) arm the planes described in
    the module docstring.
    """

    def __init__(
        self,
        filt: Filter,
        host: str = "localhost",
        distribute_port: int = 5555,
        collect_port: int = 5556,
        batch_size: int = 8,
        assemble_timeout_s: float = 0.01,
        use_jpeg: bool = True,
        raw_size: int = 512,
        jpeg_quality: int = 90,
        codec_threads: int = 4,
        delay_s: float = 0.0,
        transport: str = "list",
        ingest: str = "streamed",
        ingest_depth: int = 4,
        egress: str = "streamed",
        egress_depth: int = 2,
        fault_budget: int = 16,
        fault_window_s: float = 30.0,
        chaos=None,
        tracer=None,
        trace: bool = False,
        wire: Optional[str] = None,
        delta_tile: int = 32,
        delta_keyframe_interval: int = 16,
        delta_threshold: int = 0,
        delta_device: bool = False,
        codec_assist: str = "none",
        audit_wire: bool = False,
        ledger: bool = True,
        heartbeat=None,
        engine: Optional[Engine] = None,
        device: Union[None, str, torch.device] = None,
        poll_ms: int = 10,
        codec=None,
        connect: bool = True,
    ):
        if not isinstance(use_jpeg, bool):
            # A wire name passed in this positional slot would read as True.
            raise TypeError(f"use_jpeg must be a bool, got {use_jpeg!r}; "
                            f"pass a wire name as wire=")
        if wire is None:
            wire = "jpeg" if use_jpeg else "raw"  # legacy flag spelling
        if transport not in ("list", "ring"):
            raise ValueError(f"transport must be 'list' or 'ring', "
                             f"got {transport!r}")
        if wire not in WIRE_MODES:
            raise ValueError(f"wire must be one of {WIRE_MODES}, got {wire!r}")
        if codec_assist not in ("none", "probe", "full"):
            raise ValueError(f"codec_assist must be one of "
                             f"('none', 'probe', 'full'), got {codec_assist!r}")
        if ingest not in INGEST_MODES:
            raise ValueError(f"ingest must be one of {INGEST_MODES}, "
                             f"got {ingest!r}")
        if egress not in EGRESS_MODES:
            raise ValueError(f"egress must be one of {EGRESS_MODES}, "
                             f"got {egress!r}")
        if egress_depth < 1:
            raise ValueError("egress depth must be >= 1")
        if filt.stateful and not filt.pad_safe:
            raise ValueError(
                f"filter {filt.name!r} is stateful and not pad-safe; "
                f"the ZMQ worker pads short batches and cannot serve it")
        self.filt = filt
        self.chaos = chaos  # resilience.chaos.FaultPlan ("decode" and
        #   "transport" sites live here; "h2d", "d2h", "compute" and "oom"
        #   ride on the assembler, the fetcher and the engine)
        self.engine = engine or Engine(filt, device=device, chaos=chaos)
        if chaos is not None and self.engine.chaos is None:
            self.engine.chaos = chaos
        self.wire = wire
        self._wire_degrade_reason: Optional[str] = None
        if codec is not None:
            self.codec = codec
        elif wire == "delta":
            # Incoming delta frames composite onto the cached previous
            # frame (a sequence gap raises DeltaResyncError into the
            # batch's wire-fault containment, recovered at the peer's
            # next keyframe); results are delta-encoded on the plane.
            self.codec = make_wire_codec(
                "delta", quality=jpeg_quality, threads=codec_threads,
                tile=delta_tile, keyframe_interval=delta_keyframe_interval,
                delta_threshold=delta_threshold, on_gap="raise")
        elif wire == "jpeg":
            self.codec = make_wire_codec("jpeg", quality=jpeg_quality,
                                         threads=codec_threads)
        else:
            self.codec = None
        self.codec_assist = codec_assist
        self._probe = None
        self._fused = None
        self._fused_geom_warned = False
        if wire != "delta" and codec_assist != "none":
            print(f"[ZmqWorker] codec_assist={codec_assist} ignored: assist "
                  f"rides the delta wire (wire={wire})", file=sys.stderr)
        elif wire == "delta":
            from dvf_tpu_torch.runtime.codec_assist import (DeviceDeltaProbe,
                                                            FusedDeltaTransform)

            if codec_assist == "full":
                self._fused = FusedDeltaTransform(tile=delta_tile,
                                                  quality=jpeg_quality)
            if codec_assist != "none" or delta_device:
                if delta_threshold > 0:
                    print(f"[ZmqWorker] device probe with delta_threshold="
                          f"{delta_threshold}: sub-threshold drift is bounded "
                          f"by the keyframe cadence only", file=sys.stderr)
                # full falls back to the probe on a geometry that does
                # not tile (FusedDeltaTransform.supports)
                self._probe = DeviceDeltaProbe(tile=delta_tile)
        self.batch_size = int(batch_size)
        self.assemble_timeout_s = assemble_timeout_s
        self.raw_size = int(raw_size)
        self.ingest = ingest
        self.ingest_depth = ingest_depth
        self.egress = egress
        self.egress_depth = int(egress_depth)
        self.poll_ms = poll_ms
        self.delay_s = float(delay_s)
        # The worker's trace lane (a bounded ring): batch spans and the
        # egress encode/send spans on track 0; a caller's tracer wins.
        self.tracer = (tracer if tracer is not None
                       else Tracer(enabled=trace, process_name="worker"))
        self.registry = MetricsRegistry()
        attach_signal_provider(self.registry, "worker", self.signals)
        # Batch-level latency attribution (obs.lineage): one stream, a
        # batch-synchronous loop, so no per-frame lineage — every batch
        # stamps its assemble_h2d/device/d2h hops into a bounded window
        # (stats()['attribution'] + attr_* signals). Always on: a few
        # clock reads per BATCH.
        from dvf_tpu_torch.obs.lineage import AttributionAggregate

        self.attribution = AttributionAggregate(1024)
        # Wire-integrity audit (obs.audit): incoming payloads must carry
        # (and pass) the digest envelope; outgoing results are stamped
        # post-encode. Strict on ingress. Off by default: the reference
        # app does not speak the envelope.
        self._wire_in = None
        self._wire_out = None
        if audit_wire:
            from dvf_tpu_torch.obs.audit import WireAudit

            self._wire_in = WireAudit("zmq_ingress")
            self._wire_out = WireAudit("zmq_egress", chaos=chaos)
        # The worker's only reconfigurations are engine compiles on a
        # geometry change: each lands as one compile event.
        self.ledger = None
        if ledger:
            from dvf_tpu_torch.obs.ledger import ReconfigLedger

            self.ledger = ReconfigLedger(tracer=self.tracer, track=2)
        # Continuity plane: an armed HeartbeatConfig turns DEALER silence
        # beyond timeout_s into a budgeted partition fault, answered by a
        # jittered-backoff socket rebuild. None: credit decay alone.
        from dvf_tpu_torch.resilience.continuity import (ContinuityStats,
                                                         ReconnectPolicy)

        self.heartbeat = heartbeat.validate() if heartbeat else None
        self.continuity = ContinuityStats()
        self._reconnect = (ReconnectPolicy(self.heartbeat)
                           if self.heartbeat else None)
        self.frames_processed = 0
        self.batches = 0
        self.errors = 0
        self.faults = FaultStats()
        self.fault_budget = fault_budget
        self.fault_window_s = fault_window_s
        self._budget = ErrorBudget(limit=fault_budget, window_s=fault_window_s)
        # Host wall ms per stage; on a card also the stream time (CUDA
        # events) from the engine's submit to its end and through the assist.
        self.split = {"decode_ms": 0.0, "engine_stream_ms": 0.0,
                      "assist_stream_ms": 0.0, "assist_host_ms": 0.0,
                      "fetch_ms": 0.0, "step_ms": 0.0}
        self._asm: Optional[ShardedBatchAssembler] = None  # per geometry
        self._ingest_stats: Optional[IngestStats] = None
        self._degrade_reason: Optional[str] = None
        self._fetcher: Optional[ShardedBatchFetcher] = None
        self._egress_stats = EgressStats(requested_mode=egress,
                                         depth=self.egress_depth)
        self._egress_seq = 0
        self._egress_degrade_reason: Optional[str] = None
        self._plane: Optional[AsyncCodecPlane] = None
        self._send: Optional[SendFn] = None
        self._stop = threading.Event()
        self._run_lock = threading.Lock()
        # transport="ring": arriving payloads wait in the native ring, not
        # a Python list — the component the pipeline's ring queue uses,
        # here between the socket receive and the batch step. Sized for 4
        # batches of records of twice the raw frame (JPEG of noise-like
        # content is larger than raw), so drop-oldest applies only under
        # a pathological backlog.
        self._ring = None
        if transport == "ring":
            from dvf_tpu_torch.transport.ring import FrameRing

            rec_bytes = 2 * (self.raw_size * self.raw_size * 3) + 4096
            self._ring = FrameRing(capacity_bytes=4 * self.batch_size * rec_bytes,
                                   max_frame_bytes=rec_bytes)
        self.transport = transport
        self._pending: List[Tuple[int, bytes]] = []  # the list transport
        self.ctx = None
        self._dealer_endpoint = f"tcp://{host}:{distribute_port}"
        if connect:
            import zmq

            self._zmq = zmq
            self.ctx = zmq.Context()
            self.dealer = self.ctx.socket(zmq.DEALER)
            self.dealer.connect(self._dealer_endpoint)
            self.push = self.ctx.socket(zmq.PUSH)
            # A PUSH with no live peer blocks send() forever; bound it.
            self.push.setsockopt(zmq.SNDTIMEO, 1000)
            self.push.connect(f"tcp://{host}:{collect_port}")

    # ------------------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()

    def _fault(self, kind: str, err: BaseException, what: str,
               degrade=None, error: bool = True) -> None:
        """Count one contained fault and escalate it through the budget:
        within budget it is dropped (``what`` says how much), on the first
        overflow ``degrade(kind)`` may buy a fresh window, otherwise a
        fatal FaultError raises out of the worker. ``error=False``: a
        fault the worker recovers from whole (a geometry re-probe), so
        not an error, as in the reference."""
        self.errors += error
        self.faults.record(kind, err)
        if escalate(self._budget, kind, degrade) == ErrorBudget.FAIL:
            raise FaultError(
                kind,
                f"{kind} fault budget exhausted (> {self.fault_budget} in "
                f"{self.fault_window_s:g}s); last: {err!r}",
                fatal=True) from err
        print(f"[ZmqWorker] {kind} fault ({what}): {err!r}", file=sys.stderr)

    def _release_asm(self) -> None:
        old, self._asm = self._asm, None
        if old is not None:
            old.release()

    def _builder(self, h: int, w: int):
        """The per-geometry ingest assembler (runtime/ingest.py), one slot:
        the batch step waits for each batch (its fetch or the assist's
        bitmap read) before the next is staged, so the slot's buffers are
        never still in use when rewritten. Compiles the engine for the
        geometry first (its calibration gates streaming)."""
        shape = (self.batch_size, h, w, 3)
        if self._asm is None or self._asm.batch_shape != shape:
            self._release_asm()
            before = self.engine.stats.compile_count
            self.engine.ensure_compiled(shape, np.uint8)
            if (self.ledger is not None
                    and self.engine.stats.compile_count != before):
                from dvf_tpu_torch.obs import ledger as ledger_mod

                compile_ms = self.engine.last_compile_ms
                sig_key = self.engine.signature_key
                self.ledger.record(
                    ledger_mod.COMPILE, cause=ledger_mod.CAUSE_ADMISSION,
                    signature=sig_key.render() if sig_key is not None else None,
                    wall_ms=compile_ms,
                    compile_ms=(round(float(compile_ms), 3)
                                if compile_ms is not None else None),
                    cache="miss")
            self._ingest_stats = IngestStats(
                requested_mode=self.ingest, depth=self.ingest_depth,
                h2d_block_ms=self.engine.h2d_block_ms)
            self._asm = ShardedBatchAssembler(
                shape, np.uint8, self.engine.placement, mode=self.ingest,
                depth=self.ingest_depth, slots=1, stats=self._ingest_stats,
                chaos=self.chaos, stream=self.engine.h2d_stream_for)
            if self._degrade_reason is not None:
                self._ingest_stats.fallback_reason = self._degrade_reason
        return self._asm.begin(0)

    def _fetcher_for(self) -> ShardedBatchFetcher:
        """The per-output-signature egress fetcher (runtime/egress.py),
        ``egress_depth + 1`` slabs: the codec plane holds at most
        ``egress_depth`` batches' rows, so the slab being rewritten belongs
        to a batch whose sends completed. Rebuilt on a geometry change."""
        shape = tuple(self.engine.out_shape)
        f = self._fetcher
        if f is None or f.out_shape != shape:
            self._egress_stats = EgressStats(
                requested_mode=self.egress, depth=self.egress_depth,
                d2h_block_ms=self.engine.d2h_block_ms)
            if f is not None:
                f.release()
            self._fetcher = f = ShardedBatchFetcher(
                shape, self.engine.out_dtype, self.engine.placement,
                mode=self.egress, slots=self.egress_depth + 1,
                stats=self._egress_stats, chaos=self.chaos,
                stream=self.engine.d2h_stream_for)
            if self._egress_degrade_reason is not None:
                self._egress_stats.fallback_reason = self._egress_degrade_reason
            if self._plane is not None:
                self._plane.stats = self._egress_stats
        return f

    def _decode(self, blobs: list, valid: int):
        """Decode a codec-wire batch window by window into the
        assembler's slab (each decoded chunk's copy streams out under the
        decode of the next); returns the finished builder and its
        ``(batch, resident)``."""
        if self._asm is None:
            h, w = self.codec.probe(blobs[0])
        else:
            h, w = self._asm.batch_shape[1:3]
        builder = self._builder(h, w)
        for start, stop in builder.windows(valid):
            self.codec.decode_batch(blobs[start:stop],
                                    out=builder.window_view(start, stop))
            builder.commit_window(start, stop)
        return builder, builder.finish(valid)

    def _decode_wire(self, blobs, indices):
        """Decode one codec-wire batch with delta resync recovery: a delta
        wire fault drops the batch up to its next keyframe after the
        failing row (a gap heals only at a keyframe) and decodes the rest;
        a stream whose geometry changed is re-staged once; a corrupt JPEG
        drops the batch. Each is counted and bounded by the budget.
        Returns ``(builder, (batch, resident), indices)``, builder None
        when the faults consumed the batch."""
        while True:
            try:
                try:
                    return (*self._decode(blobs, len(blobs)), indices)
                except JpegGeometryError as ge:
                    # The re-probe IS the containment: the degrade tier
                    # keeps re-probing, only the second overflow fails.
                    self._fault(FaultKind.GEOMETRY, ge, "re-staging",
                                degrade=lambda _k: True, error=False)
                    self._release_asm()
                    return (*self._decode(blobs, len(blobs)), indices)
            except DeltaWireError as de:
                self._release_asm()
                r = getattr(de, "row", None)
                search_from = (r + 1) if r is not None else 1
                nxt = DeltaCodec.seek_keyframe(blobs[search_from:])
                if nxt is None:
                    self._fault(FaultKind.TRANSPORT, de, "dropping the batch",
                                degrade=self._degrade_delta)
                    return None, None, []
                start = search_from + nxt
                self._fault(FaultKind.TRANSPORT, de,
                            f"dropping {start} frame(s) to the next keyframe",
                            degrade=self._degrade_delta)
                indices, blobs = indices[start:], blobs[start:]
            except JpegGeometryError:
                raise  # changed again on the re-staged decode
            except ValueError as e:        # corrupt JPEG stream
                self._fault(FaultKind.DECODE, e, "dropping the batch",
                            degrade=self._degrade)
                return None, None, []

    def process_batch(self, pending: List[Tuple[int, bytes]], send: SendFn) -> None:
        """Decode → engine → assist → codec plane → send, for one batch of
        ``(frame_index, payload)`` pairs. ``send(index, t0, t1, payload)``
        delivers one result; encoded results go out in order as the plane
        finishes them (the tail at :meth:`drain_egress`). Transfer and
        compute faults raise (the socket loop contains them), and so does
        a payload that fails its audit envelope (``audit_wire``)."""
        self._send = send
        t0 = time.time()
        tp = time.perf_counter()
        indices = [i for i, _ in pending]
        blobs = [b for _, b in pending]
        if self._wire_in is not None:
            # Verify + strip the audit envelope on every payload BEFORE
            # any decode: a digest mismatch (a bit flip that would still
            # decode) raises WireIntegrityError — the batch drops
            # at-most-once under the integrity budget, attributed to the
            # zmq_ingress hop.
            blobs = [self._wire_in.verify(b) for b in blobs]
        if self.wire == "raw":
            h = w = self.raw_size
            builder = self._builder(h, w)
            for row, b in enumerate(blobs):
                try:
                    frame = np.frombuffer(b, np.uint8).reshape(h, w, 3)
                except ValueError as e:    # wrong byte count
                    self._fault(FaultKind.DECODE, e, "dropping the batch",
                                degrade=self._degrade)
                    return
                builder.write_row(row, frame)
            batch, resident = builder.finish(len(blobs))
        else:
            if self.chaos is not None:
                # Injection site "decode": one event per blob; a firing
                # rule mangles that blob so the codec rejects it.
                blobs = [self.chaos.corrupt("decode", b) for b in blobs]
            builder, staged, indices = self._decode_wire(blobs, indices)
            if builder is None:
                return
            batch, resident = staged
        valid = len(indices)
        tdec = time.perf_counter()
        self.split["decode_ms"] += (tdec - tp) * 1e3
        if self.delay_s > 0:
            # A slow worker, to exercise the app's drop and reorder logic
            # (the reference's --delay, inverter.py:37-38,55-56).
            time.sleep(self.delay_s)
        shape = tuple(batch.shape)
        fused = self._fused is not None and self._fused.supports(shape, self._fused.tile)
        if self._fused is not None and not fused and not self._fused_geom_warned:
            self._fused_geom_warned = True
            print(f"[ZmqWorker] codec_assist=full: geometry {shape} not "
                  f"tile-aligned (tile={self._fused.tile}); probe assist only",
                  file=sys.stderr)
        cuda = self.engine.on_cuda
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        result = (self.engine.submit_resident(batch, ready=builder.ready)
                  if resident else self.engine.submit(batch, fetch=False))
        t_sub = time.time()  # decode+assemble+H2D end / device start
        if cuda:
            ev[1].record()
        fetcher = None if fused else self._fetcher_for()
        if fetcher is not None:
            fetcher.prefetch(result, self._egress_seq)
        ta = time.perf_counter()
        bitmaps = coeffs = None
        if fused:
            bitmaps, coeffs = self._fused.process(result.device)
        elif self._probe is not None:
            bitmaps = self._probe.bitmaps(result.device)
        tb = time.perf_counter()
        if cuda:
            ev[2].record()
        # Device/D2H attribution split: the batch's own compute event
        # (the fetch below would wait for it anyway) marks where the
        # compute ended.
        wait_compute(result)
        t_ready = time.time()
        rows = [None] * valid
        if fetcher is not None:
            rows = fetcher.fetch(result, self._egress_seq)[:valid]
        self._egress_seq += 1
        tc = time.perf_counter()
        if cuda:
            ev[2].synchronize()
            self.split["engine_stream_ms"] += ev[0].elapsed_time(ev[1])
            self.split["assist_stream_ms"] += ev[1].elapsed_time(ev[2])
        self.split["assist_host_ms"] += (tb - ta) * 1e3
        self.split["fetch_ms"] += (tc - tb) * 1e3
        t1 = time.time()
        self.attribution.observe((t1 - t0) * 1e3, {
            "assemble_h2d": (t_sub - t0) * 1e3,
            "device": (t_ready - t_sub) * 1e3,
            "d2h": (t1 - t_ready) * 1e3})
        if self.tracer.enabled:
            self.tracer.complete("batch_complete", self.tracer.perf_of_wall(t0),
                                 self.tracer.perf_of_wall(t1), 0,
                                 frames=valid, batch=self.batches)
        plane = self._plane_for()
        plane.submit([rows[i] for i in range(valid)],
                     [(idx, t0, t1) for idx in indices],
                     bitmaps=None if bitmaps is None else [bitmaps[i] for i in range(valid)],
                     coeffs=None if coeffs is None else [coeffs[i] for i in range(valid)])
        self.frames_processed += valid
        self.batches += 1
        self._pump_egress(send, block=len(plane) > plane.depth)
        self.split["step_ms"] += (time.perf_counter() - tp) * 1e3

    def _plane_for(self) -> AsyncCodecPlane:
        if self._plane is None:
            self._plane = AsyncCodecPlane(
                self.codec, jpeg=self.wire != "raw", depth=self.egress_depth,
                stats=self._egress_stats, tracer=self.tracer)
        return self._plane

    def _pump_egress(self, send: SendFn, block: bool = False) -> None:
        """Send the plane's finished batches, in order. A failed encode
        drops its row, a failed send the batch's remainder; both count as
        transport faults under the budget, whose overflow fails."""
        if self._plane is None:
            return
        for batch in self._plane.ready(block=block):
            t_send = time.perf_counter()
            for (idx, t0, t1), payload, err in batch:
                if err is not None:
                    self._fault(FaultKind.TRANSPORT, err,
                                f"encode failed, dropping frame {idx}",
                                degrade=self._degrade)
                    continue
                if self._wire_out is not None:
                    # Post-encode stamp (and the corrupt_wire chaos
                    # site): the digest covers exactly the bytes that
                    # ride the wire.
                    payload = self._wire_out.stamp(payload)
                try:
                    send(idx, t0, t1, payload)
                except Exception as e:  # noqa: BLE001 — dead/stalled peer
                    self._fault(FaultKind.TRANSPORT, e,
                                "send failed, dropping the batch remainder",
                                degrade=self._degrade)
                    break  # at-most-once: drop this batch's tail
            t_done = time.perf_counter()
            self._egress_stats.record_send((t_done - t_send) * 1e3)
            if self.tracer.enabled:
                self.tracer.complete(EGRESS_SEND, t_send, t_done,
                                     0, rows=len(batch))

    def drain_egress(self, send: Optional[SendFn] = None) -> None:
        """Block until every pending encode has completed and been sent."""
        send = send or self._send
        if self._plane is None or send is None:
            return
        while len(self._plane):
            self._pump_egress(send, block=True)

    # -- the socket loop ------------------------------------------------

    def _socket_send(self, pid: bytes) -> SendFn:
        def send(idx: int, t0: float, t1: float, payload: bytes) -> None:
            self.push.send_multipart(result_msg(idx, pid, t0, t1, payload))
        return send

    def run(self, max_frames: Optional[int] = None) -> None:
        """Serve until :meth:`stop` (or until ``max_frames`` processed).
        Any per-iteration failure — malformed message, codec error, engine
        or transfer error — drops that message or batch, is counted and
        classified, and the worker keeps serving until its kind's budget
        fails."""
        if self.ctx is None:
            raise RuntimeError("worker built with connect=False has no sockets")
        with self._run_lock:
            self._run_loop(self._socket_send(str(os.getpid()).encode()),
                           max_frames)

    def _repartition_dealer(self) -> float:
        """Declare the ingress link partitioned (liveness timeout): count,
        classify and budget the event, ledger it, rebuild the DEALER
        socket (the stale identity and queued credits die with it), and
        return the jittered backoff to wait before pumping again. A budget
        overflow fails like any other kind: a worker partitioned for good
        must not spin silently."""
        self.continuity.inc("partitions")
        err = TimeoutError(f"no traffic on {self._dealer_endpoint} for "
                           f"{self.heartbeat.timeout_s:.1f}s")
        self.faults.record(FaultKind.PARTITION, err)
        if self.ledger is not None:
            from dvf_tpu_torch.obs import ledger as ledger_mod

            self.ledger.record(ledger_mod.PARTITION,
                               cause=ledger_mod.CAUSE_RECOVERY,
                               peer=self._dealer_endpoint, plane="worker",
                               attempt=self._reconnect.attempt)
        if escalate(self._budget, FaultKind.PARTITION,
                    lambda _k: True) == ErrorBudget.FAIL:
            raise FaultError(
                FaultKind.PARTITION,
                f"partition fault budget exhausted (> {self.fault_budget} "
                f"liveness timeouts in {self.fault_window_s:g}s); last: "
                f"{err}", fatal=True)
        self.dealer.close(0)
        self.dealer = self.ctx.socket(self._zmq.DEALER)
        self.dealer.connect(self._dealer_endpoint)
        return self._reconnect.next_delay()

    # -- staging between the socket receive and the batch step ----------

    def receive(self, index: int, payload: bytes) -> None:
        """Stage one arriving frame for the next batch: into the native
        ring (``transport="ring"``, drop-oldest) or the list. The socket
        loop calls it per frame reply; a caller without sockets may too."""
        if self._ring is not None:
            self._ring.push(payload, index, time.time())
        else:
            self._pending.append((index, payload))

    def backlog(self) -> int:
        """Frames staged and not yet taken into a batch."""
        return len(self._ring) if self._ring is not None else len(self._pending)

    def next_batch(self) -> List[Tuple[int, bytes]]:
        """Take up to ``batch_size`` staged frames, oldest first, as the
        ``(index, payload)`` pairs :meth:`process_batch` takes."""
        if self._ring is not None:
            return [(idx, payload) for payload, idx, _ts
                    in self._ring.pop_up_to(self.batch_size)]
        batch = self._pending[:self.batch_size]
        del self._pending[:self.batch_size]
        return batch

    def _run_loop(self, send: SendFn, max_frames: Optional[int]) -> None:
        zmq = self._zmq
        credits = 0
        first_recv_t: Optional[float] = None
        last_rx = time.monotonic()  # liveness clock (any DEALER traffic)
        partitioned = False         # a reconnect awaiting confirmation
        while not self._stop.is_set():
            try:
                self._pump_egress(send, block=False)
                # Keep batch_size READYs outstanding (the reference worker
                # holds one, worker.py:39-46). Non-blocking: with the app
                # down a full DEALER buffer must not wedge stop().
                while credits < self.batch_size:
                    try:
                        self.dealer.send(READY, flags=zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    credits += 1
                if self.dealer.poll(self.poll_ms):
                    parts = self.dealer.recv_multipart()
                    last_rx = time.monotonic()
                    if partitioned:  # traffic after a partition: it healed
                        partitioned = False
                        self._reconnect.reset()
                        self.continuity.inc("reconnects")
                    if self.chaos is not None:
                        # Injection site "transport": a firing rule
                        # truncates the multipart → malformed reply below.
                        parts = self.chaos.truncate("transport", parts)
                    # Any reply consumes a credit, even a malformed one.
                    credits = max(0, credits - 1)
                    parsed = parse_frame_reply(parts)
                    if parsed is None:
                        self._fault(FaultKind.TRANSPORT, ValueError(
                            f"malformed frame reply ({len(parts)} parts)"),
                            "dropped", degrade=lambda _k: True)
                    else:
                        self.receive(*parsed)
                        if first_recv_t is None:
                            first_recv_t = time.perf_counter()
                else:
                    # Credits decay on every quiet poll: the reference
                    # distributor silently forgets READYs when it has no
                    # fresh frame (distributor.py:226-244), so send them
                    # again at that cadence (worker.py:38).
                    credits = max(0, credits - 1)
                    if (self.heartbeat is not None
                            and time.monotonic() - last_rx > self.heartbeat.timeout_s):
                        delay = self._repartition_dealer()
                        partitioned = True
                        credits = 0  # they died with the old socket
                        # The next liveness window opens after the backoff:
                        # the reconnect ladder paces a dead peer.
                        last_rx = time.monotonic() + delay
                        self._stop.wait(delay)
                n_pending = self.backlog()
                flush = n_pending >= self.batch_size or (
                    n_pending and first_recv_t is not None
                    and time.perf_counter() - first_recv_t > self.assemble_timeout_s)
                if not flush:
                    continue
                batch = self.next_batch()
                # Leftovers beyond one batch restart the flush clock, or a
                # short remainder would wait for the next arrival.
                first_recv_t = time.perf_counter() if self.backlog() else None
                self.process_batch(batch, send)
                if max_frames is not None and self.frames_processed >= max_frames:
                    break
            except Exception as e:  # noqa: BLE001 — per-iteration containment
                if isinstance(e, FaultError) and e.fatal:
                    raise  # a budget-exhaustion error escaping containment
                self._fault(classify(e, site="worker"), e,
                            "dropping the batch", degrade=self._degrade)
                self._pending.clear()
                first_recv_t = None
        self.drain_egress(send)

    def _degrade_delta(self, kind: str) -> bool:
        """Delta-wire degradation, reachable only from delta wire faults:
        fall back to full-frame results (every frame a keyframe, framed
        identically, so the peer decodes it unchanged). The worker has no
        lever over what the peer sends, so a peer that stays corrupt
        through a second window still fails."""
        if self.wire == "delta" and not self.codec.full_frames:
            self.codec.full_frames = True
            self._wire_degrade_reason = "delta_fault_budget"
            print("[ZmqWorker] repeated delta wire faults: degrading to "
                  "full-frame results (keyframe-only)", file=sys.stderr, flush=True)
            return True
        return False

    def _degrade(self, kind: str) -> bool:
        """First-overflow degradation: repeated h2d faults fall back from
        streamed to monolithic ingest, repeated d2h faults the egress
        (reason recorded in the stats). Other kinds have no degraded mode
        here: the budget fails them."""
        if kind == FaultKind.H2D and self.ingest == "streamed":
            self.ingest = "monolithic"
            self._degrade_reason = "h2d_fault_budget"
            self._release_asm()
            print("[ZmqWorker] repeated h2d faults: degrading ingest "
                  "streamed → monolithic", file=sys.stderr, flush=True)
            return True
        if kind == FaultKind.D2H and self.egress == "streamed":
            self.egress = "monolithic"
            self._egress_degrade_reason = "d2h_fault_budget"
            old, self._fetcher = self._fetcher, None
            if old is not None:
                old.release()
            print("[ZmqWorker] repeated d2h faults: degrading egress "
                  "streamed → monolithic", file=sys.stderr, flush=True)
            return True
        return False

    # -- accounting / lifecycle -----------------------------------------

    def signals(self) -> dict:
        """Flat load-control signal row (the reference's registry-conformant
        keys): what the registry's ``worker`` provider scrapes."""
        out = {
            "frames_total": float(self.frames_processed),
            "batches_total": float(self.batches),
            "errors_total": float(self.errors),
            # The ring's backlog only, as the reference reports it: the
            # list never holds more than one batch before it is taken.
            "queue_depth": (float(len(self._ring))
                            if self._ring is not None else None),
            "trace_dropped_total": float(self.tracer.dropped),
        }
        if self._ingest_stats is not None:
            out["ingest_overlap_efficiency"] = self._ingest_stats.overlap_efficiency()
        if self._egress_stats is not None:
            out["egress_overlap_efficiency"] = self._egress_stats.overlap_efficiency()
        attr = self.attribution.summary()
        for comp, row in (attr.get("components") or {}).items():
            out[f"attr_{comp}_p99_ms"] = row["p99_ms"]
        if self._wire_in is not None:
            out["audit_wire_verified_total"] = float(
                self._wire_in.verified)
            out["audit_wire_mismatches_total"] = float(
                self._wire_in.mismatches)
            out["audit_wire_stamped_total"] = float(
                self._wire_out.stamped)
        if self.ledger is not None:
            out.update(self.ledger.signals())
        out.update(self.continuity.signals())
        for kind, n in self.faults.summary()["by_kind"].items():
            out[f"fault_{kind}_total"] = float(n)
        return out

    def audit_document(self) -> dict:
        """The worker's ``/audit`` endpoint body: wire-integrity
        counters per hop (the worker runs no shadow replay — its loop
        is batch-synchronous; wire digests are its audit surface)."""
        hops = []
        if self._wire_in is not None:
            hops = [self._wire_in.stats(), self._wire_out.stats()]
        return {
            "label": "worker",
            "wire_enabled": self._wire_in is not None,
            "wire_hops": hops,
            "wire_mismatches_total": sum(h["mismatches_total"]
                                         for h in hops),
        }

    def stats(self) -> dict:
        """Counters for tests and operators."""
        out = {
            "frames_processed": self.frames_processed,
            "batches": self.batches,
            "errors": self.errors,
            "wire": self.wire,
            "faults": self.faults.summary(),
            "continuity": self.continuity.summary(),
            "transport": self.transport,
            **({"ring_dropped": self._ring.dropped}
               if self._ring is not None and self._ring._ptr else {}),
            **({"ingest": self._ingest_stats.summary()}
               if self._ingest_stats is not None else {}),
            "egress": self._egress_stats.summary(),
            "split_ms_per_batch": {k: v / max(1, self.batches)
                                   for k, v in self.split.items()},
            # Batch-level hop attribution (encode/send costs live in
            # "egress": they run asynchronously on the codec plane).
            "attribution": {
                **self.attribution.summary(),
                **({"explain": self.attribution.explain()}
                   if self.attribution.count else {}),
            },
            **({"audit": self.audit_document()}
               if self._wire_in is not None else {}),
        }
        if self.wire == "delta":
            out["delta"] = {**self.codec.stats(),
                            "fallback_reason": self._wire_degrade_reason,
                            "device_probe": self._probe is not None,
                            "fused_transform": self._fused is not None,
                            **({"fused_dispatches": self._fused.calls}
                               if self._fused is not None else {})}
        if self.ledger is not None:
            out["ledger"] = self.ledger.summary()
        if self.chaos is not None:
            out["chaos"] = self.chaos.summary()
        return out

    def close(self) -> None:
        self._stop.set()
        # Wait for run() to exit before freeing native resources:
        # destroying the ring under a live loop is a use after free. A
        # wedged loop leaks the ring instead.
        got = self._run_lock.acquire(timeout=10.0)
        try:
            if got:
                self.drain_egress()
                # Release the staging and delivery slabs now, as a
                # frontend's stop() does: a closed worker that is still
                # referenced (a caller's frame, a failed test's traceback)
                # must not hold its host slabs until it is collected.
                self._release_asm()
                f, self._fetcher = self._fetcher, None
                if f is not None:
                    f.release()
            if self._ring is not None:
                if got:
                    self._ring.close()
                else:
                    print("[ZmqWorker] close(): run loop still live after "
                          "10s; leaking the ring instead of freeing it under "
                          "the loop", file=sys.stderr)
            if self.codec is not None:
                self.codec.close()
        finally:
            if got:
                self._run_lock.release()
        if self.ctx is not None:
            self.dealer.close(0)
            self.push.close(0)
            self.ctx.term()
