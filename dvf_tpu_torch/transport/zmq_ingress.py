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
without sockets. Wire faults (a delta frame that cannot be decoded, a
corrupt JPEG, a malformed reply) are contained per batch; every other
failure raises out of the worker. Not ported: the ring transport,
streamed ingest, chaos, tracer/registry/lineage, audit envelope, ledger,
heartbeat/continuity, and the fault budget with its degrade ladders.
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
from dvf_tpu_torch.obs.metrics import EgressStats
from dvf_tpu_torch.runtime.egress import AsyncCodecPlane
from dvf_tpu_torch.runtime.engine import Engine
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
    temporal-delta wire in both directions). On the delta wire
    ``codec_assist`` picks the device stage: ``"none"`` (host change
    detection), ``"probe"`` (dirty-tile bitmaps on the card, K5) or
    ``"full"`` (bitmaps, YCbCr 4:2:0, DCT and quantization on the card, K5
    + K6; the host entropy-codes coefficient blocks and fetches no pixels).
    ``codec`` replaces the wire codec the worker would build (for example
    a ``DeltaCodec`` over a ``RawCodec``: a delta wire without JPEG).
    ``connect=False`` opens no sockets and needs no ``zmq``: the caller
    then calls :meth:`process_batch` itself.
    """

    def __init__(
        self,
        filt: Filter,
        host: str = "localhost",
        distribute_port: int = 5555,
        collect_port: int = 5556,
        batch_size: int = 8,
        assemble_timeout_s: float = 0.01,
        wire: str = "jpeg",
        raw_size: int = 512,
        jpeg_quality: int = 90,
        codec_threads: int = 4,
        egress_depth: int = 2,
        delta_tile: int = 32,
        delta_keyframe_interval: int = 16,
        delta_threshold: int = 0,
        delta_device: bool = False,
        codec_assist: str = "none",
        engine: Optional[Engine] = None,
        device: Union[None, str, torch.device] = None,
        poll_ms: int = 10,
        codec=None,
        connect: bool = True,
    ):
        if wire not in WIRE_MODES:
            raise ValueError(f"wire must be one of {WIRE_MODES}, got {wire!r}")
        if codec_assist not in ("none", "probe", "full"):
            raise ValueError(f"codec_assist must be one of "
                             f"('none', 'probe', 'full'), got {codec_assist!r}")
        if egress_depth < 1:
            raise ValueError("egress depth must be >= 1")
        if filt.stateful and not filt.pad_safe:
            raise ValueError(
                f"filter {filt.name!r} is stateful and not pad-safe; "
                f"the ZMQ worker pads short batches and cannot serve it")
        self.filt = filt
        self.engine = engine or Engine(filt, device=device)
        self.wire = wire
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
        self.egress_depth = int(egress_depth)
        self.poll_ms = poll_ms
        self.frames_processed = 0
        self.batches = 0
        self.errors = 0
        self.faults = {}                 # kind -> contained wire faults
        # Host wall ms per stage; on a card also the stream time (CUDA
        # events) from the engine's submit to its end and through the assist.
        self.split = {"decode_ms": 0.0, "engine_stream_ms": 0.0,
                      "assist_stream_ms": 0.0, "assist_host_ms": 0.0,
                      "fetch_ms": 0.0, "step_ms": 0.0}
        self._staging: Optional[torch.Tensor] = None
        self._egress_stats = EgressStats(depth=self.egress_depth)
        self._plane: Optional[AsyncCodecPlane] = None
        self._send: Optional[SendFn] = None
        self._stop = threading.Event()
        self._run_lock = threading.Lock()
        self.ctx = None
        if connect:
            import zmq

            self._zmq = zmq
            self.ctx = zmq.Context()
            self.dealer = self.ctx.socket(zmq.DEALER)
            self.dealer.connect(f"tcp://{host}:{distribute_port}")
            self.push = self.ctx.socket(zmq.PUSH)
            # A PUSH with no live peer blocks send() forever; bound it.
            self.push.setsockopt(zmq.SNDTIMEO, 1000)
            self.push.connect(f"tcp://{host}:{collect_port}")

    # ------------------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()

    def _fault(self, kind: str, err: BaseException, what: str) -> None:
        self.errors += 1
        self.faults[kind] = self.faults.get(kind, 0) + 1
        print(f"[ZmqWorker] {kind} fault ({what}): {err!r}", file=sys.stderr)

    def _stage(self, h: int, w: int) -> np.ndarray:
        """The (batch_size, H, W, 3) uint8 staging batch (pinned on a card),
        rebuilt when the geometry changes; compiles the engine for it."""
        shape = (self.batch_size, h, w, 3)
        if self._staging is None or tuple(self._staging.shape) != shape:
            self.engine.ensure_compiled(shape, np.uint8)
            self._staging = torch.empty(shape, dtype=torch.uint8,
                                        pin_memory=self.engine.on_cuda)
        return self._staging.numpy()

    def _decode(self, blobs: list) -> np.ndarray:
        """Decode a codec-wire batch into the staging rows."""
        if self._staging is None:
            h, w = self.codec.probe(blobs[0])
        else:
            h, w = self._staging.shape[1:3]
        out = self._stage(h, w)
        self.codec.decode_batch(blobs, out=out[:len(blobs)])
        return out

    def _decode_wire(self, blobs, indices):
        """Decode one codec-wire batch with delta resync recovery: a delta
        wire fault drops the batch up to its next keyframe after the
        failing row (a gap heals only at a keyframe) and decodes the rest;
        a stream whose geometry changed is re-staged once; a corrupt JPEG
        drops the batch. Returns ``(staging, indices)``, staging None when
        the faults consumed the batch."""
        while True:
            try:
                try:
                    return self._decode(blobs), indices
                except JpegGeometryError as ge:
                    self.faults["geometry"] = self.faults.get("geometry", 0) + 1
                    print(f"[ZmqWorker] stream geometry changed, re-staging: "
                          f"{ge!r}", file=sys.stderr)
                    self._staging = None
                    return self._decode(blobs), indices
            except DeltaWireError as de:
                r = getattr(de, "row", None)
                search_from = (r + 1) if r is not None else 1
                nxt = DeltaCodec.seek_keyframe(blobs[search_from:])
                if nxt is None:
                    self._fault("transport", de, "dropping the batch")
                    return None, []
                start = search_from + nxt
                self._fault("transport", de,
                            f"dropping {start} frame(s) to the next keyframe")
                indices, blobs = indices[start:], blobs[start:]
            except ValueError as e:        # corrupt JPEG stream
                self._fault("decode", e, "dropping the batch")
                return None, []

    def process_batch(self, pending: List[Tuple[int, bytes]], send: SendFn) -> None:
        """Decode → engine → assist → codec plane → send, for one batch of
        ``(frame_index, payload)`` pairs. ``send(index, t0, t1, payload)``
        delivers one result; encoded results go out in order as the plane
        finishes them (the tail at :meth:`drain_egress`)."""
        self._send = send
        t0 = time.time()
        tp = time.perf_counter()
        indices = [i for i, _ in pending]
        blobs = [b for _, b in pending]
        if self.wire == "raw":
            h = w = self.raw_size
            staging = self._stage(h, w)
            try:
                for row, b in enumerate(blobs):
                    staging[row] = np.frombuffer(b, np.uint8).reshape(h, w, 3)
            except ValueError as e:        # wrong byte count
                self._fault("decode", e, "dropping the batch")
                return
        else:
            staging, indices = self._decode_wire(blobs, indices)
            if staging is None:
                return
        valid = len(indices)
        # Pad to the compiled batch by repeating the last frame (stateful
        # temporal windows stay right; see Filter.pad_safe).
        staging[valid:] = staging[valid - 1]
        tdec = time.perf_counter()
        self.split["decode_ms"] += (tdec - tp) * 1e3
        shape = tuple(self._staging.shape)
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
        result = self.engine.submit(self._staging, fetch=not fused)
        if cuda:
            ev[1].record()
        ta = time.perf_counter()
        bitmaps = coeffs = None
        if fused:
            bitmaps, coeffs = self._fused.process(result.device)
        elif self._probe is not None:
            bitmaps = self._probe.bitmaps(result.device)
        tb = time.perf_counter()
        if cuda:
            ev[2].record()
        rows = [None] * valid
        if not fused:
            rows = result.fetch()[:valid]
        tc = time.perf_counter()
        if cuda:
            ev[2].synchronize()
            self.split["engine_stream_ms"] += ev[0].elapsed_time(ev[1])
            self.split["assist_stream_ms"] += ev[1].elapsed_time(ev[2])
        self.split["assist_host_ms"] += (tb - ta) * 1e3
        self.split["fetch_ms"] += (tc - tb) * 1e3
        if not fused:
            self._egress_stats.record_fetch((tc - tb) * 1e3)
        t1 = time.time()
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
                stats=self._egress_stats)
        return self._plane

    def _pump_egress(self, send: SendFn, block: bool = False) -> None:
        """Send the plane's finished batches, in order. An encode that
        failed raises: it is no wire fault."""
        if self._plane is None:
            return
        for batch in self._plane.ready(block=block):
            t_send = time.perf_counter()
            for (idx, t0, t1), payload, err in batch:
                if err is not None:
                    raise RuntimeError(f"encoding frame {idx} failed") from err
                send(idx, t0, t1, payload)
            self._egress_stats.record_send((time.perf_counter() - t_send) * 1e3)

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
        """Serve until :meth:`stop` (or until ``max_frames`` processed)."""
        if self.ctx is None:
            raise RuntimeError("worker built with connect=False has no sockets")
        with self._run_lock:
            self._run_loop(self._socket_send(str(os.getpid()).encode()),
                           max_frames)

    def _run_loop(self, send: SendFn, max_frames: Optional[int]) -> None:
        zmq = self._zmq
        credits = 0
        pending: List[Tuple[int, bytes]] = []
        first_recv_t: Optional[float] = None
        while not self._stop.is_set():
            self._pump_egress(send, block=False)
            # Keep batch_size READYs outstanding (the reference worker
            # holds one, worker.py:39-46). Non-blocking: with the app down
            # a full DEALER buffer must not wedge stop().
            while credits < self.batch_size:
                try:
                    self.dealer.send(READY, flags=zmq.NOBLOCK)
                except zmq.Again:
                    break
                credits += 1
            if self.dealer.poll(self.poll_ms):
                parts = self.dealer.recv_multipart()
                # Any reply consumes a credit, even a malformed one.
                credits = max(0, credits - 1)
                parsed = parse_frame_reply(parts)
                if parsed is None:
                    self._fault("transport", ValueError(
                        f"malformed frame reply ({len(parts)} parts)"), "dropped")
                else:
                    pending.append(parsed)
                    if first_recv_t is None:
                        first_recv_t = time.perf_counter()
            else:
                # Credits decay on every quiet poll: the reference
                # distributor silently forgets READYs when it has no fresh
                # frame (distributor.py:226-244), so send them again at that
                # cadence (worker.py:38).
                credits = max(0, credits - 1)
            flush = len(pending) >= self.batch_size or (
                pending and first_recv_t is not None
                and time.perf_counter() - first_recv_t > self.assemble_timeout_s)
            if not flush:
                continue
            batch, pending = pending[:self.batch_size], pending[self.batch_size:]
            first_recv_t = time.perf_counter() if pending else None
            self.process_batch(batch, send)
            if max_frames is not None and self.frames_processed >= max_frames:
                break
        self.drain_egress(send)

    # -- accounting / lifecycle -----------------------------------------

    def stats(self) -> dict:
        """Counters for tests and operators."""
        out = {
            "frames_processed": self.frames_processed,
            "batches": self.batches,
            "errors": self.errors,
            "wire": self.wire,
            "faults": {"by_kind": dict(self.faults)},
            "egress": self._egress_stats.summary(),
            "split_ms_per_batch": {k: v / max(1, self.batches)
                                   for k, v in self.split.items()},
        }
        if self.wire == "delta":
            out["delta"] = {**self.codec.stats(),
                            "device_probe": self._probe is not None,
                            "fused_transform": self._fused is not None,
                            **({"fused_dispatches": self._fused.calls}
                               if self._fused is not None else {})}
        return out

    def close(self) -> None:
        self._stop.set()
        got = self._run_lock.acquire(timeout=10.0)
        try:
            if got:
                self.drain_egress()
            if self.codec is not None:
                self.codec.close()
        finally:
            if got:
                self._run_lock.release()
        if self.ctx is not None:
            self.dealer.close(0)
            self.push.close(0)
            self.ctx.term()
