"""Perfetto / Chrome-trace-event frame-lifecycle tracing (port of
``dvf_tpu.obs.trace``: the same event names, span arguments, ring and
export format).

Instant events at capture ('i', ``frame_captured``), complete events
('X') spanning processing with a *track id* mapped to the trace ``pid``
field so each stage gets its own lane. Callers stamp events with
``time.perf_counter()``, the one monotonic clock the benchmark's device
trace is aligned to; the export writes µs past the tracer's wall-clock
``start_time`` through one ``(wall, perf)`` anchor taken at construction.
Event names follow the frame lifecycle: frame_captured → batch_complete →
frame_delivered; the ingest (runtime/ingest.py) adds a transfer lane:

- ``ingest_h2d`` — one span per row chunk's host→device copy launch (args:
  the batch-row range and bytes shipped), streamed path;
- ``ingest_stage`` — the whole host-staging window of one batch (args:
  the cumulative host-copy time inside it), either path;
- ``ingest_overlap`` — first chunk copy launched → batch assembly complete:
  the window in which copies ran under the staging of later chunks and
  the device compute of the previous batch.

The egress (runtime/egress.py) mirrors it on the delivery side:

- ``egress_d2h`` — one span per batch's host copy wait, on the streamed
  and the monolithic path (args: the batch-row range and bytes fetched);
- ``egress_encode`` / ``egress_send`` — the codec plane's spans (names
  kept for the reference's consumers).

Inside the port's own threads, each span carrying the batch's ``seq`` (or
the train step's ``step``):

- ``pipeline.assemble`` (waiting for frames), ``pipeline.window_wait``
  (blocked on the in-flight window) and ``engine.launch`` (the step's
  launch, ``runtime/engine.py``) on the pipeline's dispatch lane;
- ``egress.fetch``, with ``egress.wait_compute`` and ``egress_d2h``
  inside it, and ``pipeline.deliver`` (reorder, row copies, sink) on its
  collect lane;
- ``train.step`` with ``train.optim`` (``zero_grad``), ``train.forward``,
  ``train.backward`` and ``train.optim`` (Adam's update) inside it
  (``train/optim.py``), each phase also timed on the device by a pair of
  CUDA events (:meth:`Tracer.device_span`).

:func:`merge_with_device_trace` fuses the host trace with a
``torch.profiler`` (Kineto) Chrome trace into one file; it is the
counterpart of the reference's merge of ``jax.profiler`` output.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# Streamed-ingest span names (runtime/ingest.py emits these; one place
# owns the strings so trace consumers can match on them).
INGEST_H2D = "ingest_h2d"
INGEST_STAGE = "ingest_stage"
INGEST_OVERLAP = "ingest_overlap"

# Streamed-egress span names (runtime/egress.py — the delivery-side
# mirror): one ``egress_d2h`` span per output-shard host copy, one
# ``egress_encode`` span per batch's in-pool encode window (submit →
# last future done), one ``egress_send`` span per batch's wire sends.
EGRESS_D2H = "egress_d2h"
EGRESS_ENCODE = "egress_encode"
EGRESS_SEND = "egress_send"

# The reconfiguration ledger (obs/ledger.py) stamps every recorded
# event onto its own dedicated lane as ``reconfig:<kind>`` spans (plus
# ``reconfig_stall_closed`` instants when a bucket's measured stall
# window closes) — so a merged Perfetto session shows compiles,
# resizes, rebuilds, and scale actions INLINE with the dispatch/device
# lanes they stalled. One place owns the prefix for consumers to match.
RECONFIG_PREFIX = "reconfig:"
RECONFIG_STALL_CLOSED = "reconfig_stall_closed"

# Spans of the port's dispatch, collect and train-step threads.
PIPELINE_ASSEMBLE = "pipeline.assemble"
PIPELINE_WINDOW_WAIT = "pipeline.window_wait"
PIPELINE_DELIVER = "pipeline.deliver"
ENGINE_LAUNCH = "engine.launch"
EGRESS_FETCH = "egress.fetch"
EGRESS_WAIT_COMPUTE = "egress.wait_compute"
TRAIN_STEP = "train.step"
TRAIN_FORWARD = "train.forward"
TRAIN_BACKWARD = "train.backward"
TRAIN_OPTIM = "train.optim"


class Tracer:
    """Frame-lifecycle tracer with a BOUNDED event ring.

    ``max_events`` caps the buffer: an enabled tracer on an
    indefinitely-running serve process keeps the most recent window and
    counts what it sheds (``dropped``) — the same leak guard
    ``LatencyStats`` decimation applies to samples. The retained window
    doubles as the flight recorder's always-on black box: at the default
    bound it covers the last ~10⁵ events, minutes of serving at frame
    rates, for a few tens of MB worst case.

    Stamps are ``time.perf_counter()`` seconds. ``start_time`` is the
    WALL-CLOCK epoch (``time.time()``) read beside ``perf_start`` at
    construction: event timestamps are µs past it, so snapshots from
    different processes merge onto one clock by offsetting each tracer's
    events by its epoch delta (:func:`merge_tracer_snapshots`). A wall
    time (a frame's capture stamp) enters through :meth:`perf_of_wall`.
    """

    def __init__(self, enabled: bool = False, process_name: str = "dvf_tpu",
                 max_events: int = 100_000):
        self.enabled = enabled
        self.process_name = process_name
        self.start_time = time.time()
        self.perf_start = time.perf_counter()
        self.max_events = max_events
        self.dropped = 0
        self._events: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=max_events))
        self._device: "collections.deque[tuple]" = collections.deque(
            maxlen=max_events)  # (name, start event, end event, track,
        #   args) not yet resolved to ms
        self._device_ms: "collections.deque[tuple]" = collections.deque(
            maxlen=max_events)  # (name, ms, track, args), resolved
        self._lock = threading.Lock()

    def _us(self, t: float) -> int:
        return int((t - self.perf_start) * 1e6)

    def perf_of_wall(self, wall: float) -> float:
        """A ``time.time()`` stamp on the tracer's ``perf_counter`` clock."""
        return wall - self.start_time + self.perf_start

    def instant(self, name: str, ts: Optional[float] = None, track: int = 0, **args) -> None:
        """'i' event — e.g. frame_captured at enqueue (distributor.py:63-73)."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "i",
            "ts": self._us(ts if ts is not None else time.perf_counter()),
            "pid": track,
            "tid": 0,
            "s": "g",
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def complete(self, name: str, t0: float, t1: float, track: int = 0, **args) -> None:
        """'X' event spanning [t0, t1] (distributor.py:75-88)."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": self._us(t0),
            "dur": max(0, int((t1 - t0) * 1e6)),
            "pid": track,
            "tid": 0,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                # The deque sheds the oldest on append; count the loss so
                # a bounded export says "window, not whole run" honestly.
                self.dropped += 1
            self._events.append(ev)

    def device_span(self, name: str, start, end, track: int = 0, **args) -> None:
        """Device time between two CUDA events recorded with
        ``enable_timing=True`` on one stream; kept unresolved, so the
        caller never waits here (:meth:`device_spans` reads them)."""
        if not self.enabled:
            return
        with self._lock:
            self._device.append((name, start, end, track, args))

    # ------------------------------------------------------------------

    def spans(self) -> List[Tuple[str, float, float, int, Dict[str, Any]]]:
        """The retained 'X' events as ``(name, t0, t1, track, args)``,
        ``t0`` and ``t1`` in ``perf_counter`` seconds (to the µs)."""
        with self._lock:
            events = list(self._events)
        base = self.perf_start
        return [(e["name"], base + e["ts"] * 1e-6, base + (e["ts"] + e["dur"]) * 1e-6,
                 e["pid"], e.get("args", {})) for e in events if e["ph"] == "X"]

    def device_spans(self) -> List[Tuple[str, float, int, Dict[str, Any]]]:
        """``(name, ms, track, args)`` of each retained :meth:`device_span`
        whose end event has completed: read after the caller's own
        synchronise, every one. Resolving waits for nothing; a span still
        running is resolved by a later read."""
        with self._lock:
            while self._device and self._device[0][2].query():
                name, start, end, track, args = self._device.popleft()
                self._device_ms.append((name, start.elapsed_time(end), track, args))
            return list(self._device_ms)

    def snapshot(self, max_events: Optional[int] = None) -> Dict[str, Any]:
        """This tracer's mergeable export: the retained event window plus
        the wall-clock epoch and identity needed to place it on a shared
        timeline — plain JSON/pickle-safe values, the form that crosses a
        fleet replica's RPC boundary (``merge_tracer_snapshots`` on the
        other side). The event list is copied under the lock; emitters
        keep appending concurrently.

        ``max_events`` keeps only the most RECENT k events (the extra
        shed counts as ``dropped``): the cap a transfer-cost-sensitive
        exporter applies — the fleet's ``trace`` RPC serializes the
        snapshot while holding the replica's serial channel lock, where
        a full 100k-event ring would stall the submit hot path for the
        whole transfer."""
        import os

        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        if max_events is not None and len(events) > max_events:
            dropped += len(events) - max_events
            events = events[-max_events:]
        return {
            "process_name": self.process_name,
            "start_time": self.start_time,
            "pid": os.getpid(),
            "dropped": dropped,
            "events": events,
        }

    def export(self, path: str = "dvf_frame_timing.pftrace") -> Optional[str]:
        """Write Chrome-trace JSON (the reference hand-serializes the same
        format to webcam_frame_timing.pftrace, distributor.py:90-148)."""
        if not self.enabled or not self._events:
            return None
        with self._lock:
            events = list(self._events)
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": f"{self.process_name}/{pid}" if pid else self.process_name},
            }
            for pid in sorted({e["pid"] for e in events})
        ]
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        # The reference prints capture/processing FPS stats on every export
        # (distributor.py:152-171); match that so a traced run ends with
        # the numbers, not just a file path.
        stats = self.summarize()
        if stats:
            pretty = ", ".join(f"{k}={v:.2f}" for k, v in stats.items())
            print(f"[trace] exported {len(events)} events to {path} ({pretty})",
                  file=sys.stderr)
        return path

    def summarize(self) -> Dict[str, float]:
        """FPS statistics from the trace, like distributor.py:152-171."""
        with self._lock:
            events = list(self._events)
        out: Dict[str, float] = {}
        captures = sorted(e["ts"] for e in events if e["name"] == "frame_captured")
        if len(captures) > 1:
            ivals = [b - a for a, b in zip(captures, captures[1:])]
            mean_us = sum(ivals) / len(ivals)
            if mean_us > 0:
                out["capture_fps"] = 1e6 / mean_us
        durs = [e["dur"] for e in events
                if e["name"] == "batch_complete" and e.get("dur", 0) > 0]
        if durs:
            out["mean_process_ms"] = sum(durs) / len(durs) / 1e3
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# ---------------------------------------------------------------------------
# Host + device trace merging (one UI, one FILE)
# ---------------------------------------------------------------------------

# Device lanes are offset by this so they never collide with the host's
# small track ids (the reference's offset).
DEVICE_PID_OFFSET = 10000
MERGED_TRACE_NAME = "dvf_merged_timing.pftrace"


def merge_with_device_trace(
    host_path: str,
    device_trace_dir: str,
    out_path: str,
    device_epoch_us: int,
    max_events: int = 20000,
    host_start_s: Optional[float] = None,
) -> Optional[str]:
    """Fuse the host frame-lifecycle trace with a ``torch.profiler``
    Chrome trace (the newest ``*.json`` that ``export_chrome_trace``
    wrote into ``device_trace_dir``) into ONE Chrome-trace file that
    opens as a single Perfetto session — host lanes (capture → dispatch
    → deliver) above the profiler's CPU-op and CUDA-kernel lanes, on one
    aligned clock.

    Clock alignment: a Kineto trace carries ``baseTimeNanoseconds`` at
    its top level, and each event's ``ts`` is wall-clock µs minus
    ``baseTimeNanoseconds / 1000``; the host tracer's ``ts`` is µs past
    its ``start_time``. With ``host_start_s`` (the tracer's
    ``start_time``) and a base in the file, each device event moves by
    ``base/1e3 − host_start_s·1e6``. Without either, by
    ``device_epoch_us`` (the reference's contract: device timestamps
    relative to the profiler's start, which the caller places on the
    host clock).

    Filtering: 'M' metadata and 'X' spans are kept ('i' instants, flow
    and counter events are not); the Python tracer's events
    (``cat == "python_function"``) are dropped; if the remainder still
    exceeds ``max_events``, the longest-duration events win. Device pids
    (the OS pid for CPU events, the device index for kernels) are offset
    by +10000. Returns None when there is no device trace or it (or the
    host trace) cannot be read — the merge is best-effort teardown
    garnish."""
    candidates = sorted(glob.glob(os.path.join(device_trace_dir, "*.json")),
                        key=os.path.getmtime)
    if not candidates:
        return None
    try:
        with open(host_path) as f:
            host = json.load(f)
        with open(candidates[-1]) as f:
            dev = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        # A truncated trace (profiler killed mid-write) — the merge must
        # never fail a run whose frames were all delivered.
        return None
    if not isinstance(dev, dict):
        return None
    base_ns = dev.get("baseTimeNanoseconds")
    if base_ns is not None and host_start_s is not None:
        offset_us = base_ns / 1e3 - host_start_s * 1e6
    else:
        offset_us = device_epoch_us

    meta, events = [], []
    for e in dev.get("traceEvents", []):
        ph = e.get("ph")
        if ph == "M":
            e = dict(e, pid=_dev_pid(e))
            if e.get("name") == "process_name":
                nm = (e.get("args") or {}).get("name", "")
                e["args"] = {"name": f"device{nm}"}
            meta.append(e)
        elif ph == "X" and e.get("cat") != "python_function":
            events.append(e)
    if len(events) > max_events:
        events.sort(key=lambda e: e.get("dur", 0), reverse=True)
        events = events[:max_events]
    for e in events:
        e["pid"] = _dev_pid(e)
        e["ts"] = e.get("ts", 0) + offset_us

    doc = {
        "traceEvents": host.get("traceEvents", []) + meta + events,
        "displayTimeUnit": "ms",
    }
    with open(out_path, "w") as f:
        json.dump(doc, f)
    print(f"[trace] merged host+device trace → {out_path} "
          f"({len(events)} device events kept)", file=sys.stderr)
    return out_path


def _dev_pid(e: dict) -> int:
    """A device event's lane: its pid (an int, or Kineto's string form
    of one) past the offset; a non-numeric pid maps to the offset."""
    try:
        pid = int(e.get("pid", 0))
    except (TypeError, ValueError):
        pid = 0
    return pid + DEVICE_PID_OFFSET


# ---------------------------------------------------------------------------
# Cross-process trace merging (fleet tier: one Perfetto session, N tracers)
# ---------------------------------------------------------------------------

# Each snapshot's tracks are offset into their own pid block so lanes from
# different processes can never collide — the same trick
# merge_with_device_trace uses (+10000) for the device lanes, which
# therefore stay clear of any realistic fleet (100 lanes × 100 replicas).
LANE_STRIDE = 100


def merge_tracer_snapshots(
    snaps: "List[dict]",
    out_path: Optional[str] = None,
    max_events: int = 100_000,
) -> Optional[dict]:
    """Fuse N :meth:`Tracer.snapshot` exports — serve frontends, fleet
    replicas (in-process or across the RPC boundary), the ZMQ worker —
    into ONE Chrome-trace document that opens as a single Perfetto
    session, every lane on one aligned clock.

    Clock alignment: each tracer's timestamps are µs relative to its own
    wall-clock ``start_time``; the merge re-bases every event onto the
    EARLIEST epoch among the snapshots (``ts += (start_time_i − epoch0)
    in µs``), which is exact up to wall-clock skew between processes —
    on one host (the fleet's process replicas) that is NTP-free and
    effectively zero.

    Lanes: snapshot *i*'s tracks land in pid block ``i * LANE_STRIDE``,
    named ``{process_name}/{track}`` so the Perfetto UI groups one
    process per replica. If the union exceeds ``max_events`` the
    longest-duration events win, mirroring the device-trace merge's cut.

    Returns the document (and writes it to ``out_path`` when given);
    None when no snapshot carried any events.
    """
    snaps = [s for s in snaps if s and s.get("events")]
    if not snaps:
        return None
    epoch0 = min(float(s["start_time"]) for s in snaps)
    meta: List[dict] = []
    events: List[dict] = []
    lanes: List[dict] = []
    for i, s in enumerate(snaps):
        base = i * LANE_STRIDE
        off_us = int((float(s["start_time"]) - epoch0) * 1e6)
        name = s.get("process_name") or f"tracer{i}"
        # Track ids are arbitrary ints (pipeline stage ids, but also
        # device ids / profiler pids from merged device traces): an id
        # outside [0, LANE_STRIDE) would land in ANOTHER snapshot's pid
        # block and interleave two processes' lanes in the Perfetto UI
        # — so out-of-range tracks CLAMP into this snapshot's last lane
        # (LANE_STRIDE − 1; negatives to 0). Within-process folding
        # loses lane separation for the oversized ids only; the
        # cross-process block invariant — the thing the merge exists
        # for — always holds. Folds are counted in the provenance.
        lane_tracks: Dict[int, set] = {}
        folded = 0
        for e in s["events"]:
            e = dict(e)
            track = int(e.get("pid", 0))
            lane = min(max(track, 0), LANE_STRIDE - 1)
            if lane != track:
                folded += 1
            lane_tracks.setdefault(lane, set()).add(track)
            e["pid"] = base + lane
            e["ts"] = int(e.get("ts", 0)) + off_us
            events.append(e)
        for lane in sorted(lane_tracks):
            raw = sorted(lane_tracks[lane])
            label = (f"{name}/{raw[0]}" if len(raw) == 1 and raw[0]
                     else name if len(raw) == 1
                     else f"{name}/{'+'.join(map(str, raw))}")
            meta.append({
                "name": "process_name", "ph": "M", "pid": base + lane,
                "args": {"name": label},
            })
        lanes.append({
            "process_name": name,
            "pid_base": base,
            "pid": s.get("pid"),
            "epoch_offset_us": off_us,
            "events": len(s["events"]),
            "folded_tracks": folded,
            "dropped": int(s.get("dropped", 0)),
        })
    if len(events) > max_events:
        # Instants survive the cut: they are rare and they are the
        # incident markers (replica_lost, replica_stall, frame_captured)
        # a post-mortem reads first — a duration sort alone would cull
        # every one of them (no ``dur`` ranks as 0) before any span.
        instants = [e for e in events if e.get("ph") != "X"][:max_events]
        spans = [e for e in events if e.get("ph") == "X"]
        spans.sort(key=lambda e: e.get("dur", 0), reverse=True)
        events = instants + spans[:max(0, max_events - len(instants))]
    events.sort(key=lambda e: e.get("ts", 0))
    doc = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        # Provenance for post-mortem readers: which lane is which
        # process, and how far its clock was re-based (Perfetto ignores
        # unknown top-level keys).
        "dvfTraceLanes": lanes,
        "dvfEpoch": epoch0,
    }
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(doc, f)
        print(f"[trace] merged {len(snaps)} tracer snapshots "
              f"({len(events)} events) → {out_path}", file=sys.stderr)
    return doc
