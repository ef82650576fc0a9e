"""Compile & reconfiguration ledger: every program change, accounted
(port of ``dvf_tpu.obs.ledger``; host code only).

The third observability plane beside the stage metrics and the frame
lineage. Those answer "how fast is the steady state" and
"where did one frame's latency go"; this module answers the question
between them — **what did every reconfiguration cost, and whom did it
stall?** Stall-free reconfiguration (compile-aside + atomic hot swap,
``Engine.prepare_swap`` / ``commit_swap``) is judged against exactly
these records: "dwell≈0, zero stall events in the ledger" is an
acceptance bar only if a ledger exists to read.

Every compile, recompile, program-pool acquire/evict, batch resize,
quality rebind, engine rebuild, bucket create/retire, and replica
spawn/retire lands as ONE structured event in a bounded ring:

    {t, kind, cause, signature, bucket, wall_ms, stall_ms,
     thread, cache, reason, ...}

- ``wall_ms`` is the event's own wall duration (the compile, the drain,
  the spawn) — what the thread that ran it paid;
- ``thread`` names that thread — who was blocked while it ran (an
  admission compile on a client thread vs a resize compile on its
  off-dispatch worker are very different incidents);
- ``stall_ms`` is the MEASURED bucket stall: the gap in the affected
  bucket's dispatch ticks around the event (last dispatch before the
  event began → first dispatch after it completed), closed by the
  owner's dispatch loop via :meth:`ReconfigLedger.note_dispatch`. It is
  an honest upper bound on what the bucket's tenants actually lost —
  idle buckets show the gap to their next natural tick, busy buckets
  show the quiesce the reconfiguration forced;
- ``cache`` is the compile-cache story ("hit"/"miss") where one applies.

Export surfaces: ``stats()["ledger"]`` (summary + recent-event tail),
the ``/ledger`` endpoint (`obs.export.MetricsExporter`), a dedicated
Perfetto lane (events stamped through the owner's Tracer at record
time, so a merged trace shows reconfigurations inline with the
dispatch/device lanes), and FlightRecorder dumps (``ledger.json``) —
a post-mortem names the reconfiguration that holed the p99.

Cost discipline: reconfigurations are RARE (admissions, controller
actions, recoveries — not per-frame), so recording is a lock + dict
append. The only hot-path touch is :meth:`note_dispatch`, one
attribute check per dispatch tick while no stall window is open.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

# Event kinds (one vocabulary across serve and fleet tiers).
COMPILE = "compile"                  # a program trace/compile ran
POOL_ACQUIRE = "pool_acquire"        # warm pool hit (no compile)
POOL_EVICT = "pool_evict"            # LRU eviction freed a program
BATCH_RESIZE = "batch_resize"        # per-bucket batch-size recompile+swap
QUALITY_REBIND = "quality_rebind"    # session moved across quality buckets
ENGINE_REBUILD = "engine_rebuild"    # supervised recovery rebuilt a program
BUCKET_CREATE = "bucket_create"
BUCKET_RETIRE = "bucket_retire"
REPLICA_SPAWN = "replica_spawn"      # fleet scale-out (warm or cold)
REPLICA_RETIRE = "replica_retire"    # fleet scale-in (drain → terminate)
REPLICA_RESTART = "replica_restart"  # loss-path respawn
RELAY_SPAWN = "relay_spawn"          # broadcast relay-out (third axis)
RELAY_RETIRE = "relay_retire"        # broadcast relay-in
SWAP = "swap"                        # compile-aside + atomic hot swap: the
#   stall-free substitution path. Carries compile_aside_ms (background
#   compile, nobody blocked), migrate_ms (device-to-device state move),
#   and stall_ms — here the MEASURED commit duration on the dispatch
#   thread (the pointer swing), recorded directly rather than via a
#   stall window: a hot swap never quiesces the bucket, so there is no
#   dispatch gap to measure, only the tick-boundary commit cost (~0).
#   Aborted swaps ledger with aborted=True and the old program serving.
RESUME = "resume"                    # continuity plane: a session (or the
#   whole front door) resumed from a token/snapshot — replayed tail,
#   re-adopted replicas, rebuilt registry. Carries sid/replica ids and
#   replay counts so "zero session loss" is auditable after the fact.
PARTITION = "partition"              # continuity plane: a liveness timeout
#   declared a link partitioned; carries the peer and the reconnect
#   outcome. Budgeted like any fault, ledgered because a partition is a
#   reconfiguration of the wire, not a per-frame error.
PLAN = "plan"                        # auto-plan plane: a plan decision —
#   cache hit, live search, or analytic fallback. Carries the chosen
#   plan doc, its source, the measured search cost (wall_ms) and the
#   candidate counts (legs live-profiled / grid size), so "the warm
#   restart's plan step cost < 50 ms and ran no search" is auditable
#   from the ledger alone.

# Causes (why the reconfiguration happened) — data, not an enum; these
# are the spellings the runtime emits.
CAUSE_ADMISSION = "admission"
CAUSE_RESIZE = "resize"
CAUSE_QUALITY = "quality"
CAUSE_RECOVERY = "recovery"
CAUSE_PRECOMPILE = "precompile"
CAUSE_CAPACITY = "capacity"
CAUSE_AUTOSCALE = "autoscale"
CAUSE_MANUAL = "manual"
CAUSE_MORPH = "morph"        # live session filter-chain swap (morph_stream)
CAUSE_ROLLOUT = "rollout"    # fleet rolling config/version rollout
CAUSE_AUTOPLAN = "autoplan"  # auto-plan plane decision (search/cache hit)

# The dedicated trace lane reconfiguration events land on (serve's
# stage lanes are 0..4; lineage uses none; 6 keeps clear of all).
TRACK_LEDGER = 6


class ReconfigLedger:
    """Bounded ring of reconfiguration events + open stall windows.

    Thread contract: ``record``/``note_dispatch``/``snapshot`` are safe
    from any thread (one internal lock). ``tracer`` (optional,
    duck-typed ``obs.trace.Tracer``) gets each event stamped as a
    complete span on ``track`` at record time — zero cost when the
    tracer is disabled.
    """

    def __init__(self, capacity: int = 2048, tracer=None,
                 track: int = TRACK_LEDGER):
        self.capacity = capacity
        self.tracer = tracer
        self.track = track
        self._lock = threading.Lock()
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._by_kind: Dict[str, int] = {}
        self._by_cause: Dict[str, int] = {}
        self.events_total = 0
        self.dropped = 0
        self.stall_ms_total = 0.0
        self.stall_events_total = 0   # events whose stall window CLOSED
        #   with a positive gap — what "zero stall events" will count
        # label -> [event dict, ...] with an open stall window; the
        # hot-path guard below keeps note_dispatch at one attribute
        # read while this is empty.
        self._pending_stalls: Dict[str, List[dict]] = {}
        self.has_pending_stalls = False

    # -- recording -------------------------------------------------------

    def record(
        self,
        kind: str,
        cause: Optional[str] = None,
        signature: Optional[str] = None,
        bucket: Optional[str] = None,
        wall_ms: Optional[float] = None,
        cache: Optional[str] = None,
        reason: Optional[str] = None,
        stall_from: Optional[float] = None,
        t0: Optional[float] = None,
        **extra: Any,
    ) -> dict:
        """Append one event; returns the (live, still-mutable) event
        dict so the owner can close its stall window later.

        ``stall_from`` opens a stall window on ``bucket``: the wall
        time the gap is measured FROM (the bucket's last dispatch tick
        before the event began; falls back to the event start). The
        window closes at the bucket's next dispatch
        (:meth:`note_dispatch`), writing ``stall_ms``.
        ``t0`` back-dates the event start (wall clock) for events
        recorded at completion; the trace span uses it.
        """
        now = time.time()
        start = t0 if t0 is not None else (
            now - (wall_ms or 0.0) / 1e3)
        ev: Dict[str, Any] = {"t": start, "kind": kind}
        if cause is not None:
            ev["cause"] = cause
        if signature is not None:
            ev["signature"] = signature
        if bucket is not None:
            ev["bucket"] = bucket
        if wall_ms is not None:
            ev["wall_ms"] = round(float(wall_ms), 3)
        if cache is not None:
            ev["cache"] = cache
        if reason is not None:
            ev["reason"] = reason
        ev["thread"] = threading.current_thread().name
        for k, v in extra.items():
            if v is not None:
                ev[k] = v
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
            self.events_total += 1
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            if cause is not None:
                self._by_cause[cause] = self._by_cause.get(cause, 0) + 1
            if stall_from is not None and bucket is not None:
                ev["stall_from"] = float(stall_from)
                self._pending_stalls.setdefault(bucket, []).append(ev)
                self.has_pending_stalls = True
        tracer = self.tracer
        if tracer is not None and getattr(tracer, "enabled", False):
            args = {k: v for k, v in ev.items()
                    if k not in ("t", "kind") and isinstance(
                        v, (str, int, float, bool))}
            tracer.complete(f"reconfig:{kind}", tracer.perf_of_wall(start),
                            tracer.perf_of_wall(now), self.track, **args)
        return ev

    def note_dispatch(self, bucket_label: str,
                      t: Optional[float] = None) -> None:
        """Close any open stall windows for ``bucket_label``: the gap
        from each window's ``stall_from`` to this dispatch tick is that
        event's measured bucket stall. Call from the owner's dispatch
        loop right as a batch for the bucket is submitted. One
        attribute read when nothing is pending."""
        if not self.has_pending_stalls:
            return
        t = t if t is not None else time.time()
        closed: List[dict] = []
        with self._lock:
            pending = self._pending_stalls.pop(bucket_label, None)
            if not self._pending_stalls:
                self.has_pending_stalls = False
            if not pending:
                return
            for ev in pending:
                stall_ms = max(0.0, (t - ev.pop("stall_from")) * 1e3)
                ev["stall_ms"] = round(stall_ms, 3)
                self.stall_ms_total += stall_ms
                if stall_ms > 0:
                    self.stall_events_total += 1
                closed.append(ev)
        tracer = self.tracer
        if tracer is not None and getattr(tracer, "enabled", False):
            for ev in closed:
                tracer.instant("reconfig_stall_closed", ts=tracer.perf_of_wall(t),
                               track=self.track, bucket=bucket_label,
                               stall_ms=ev["stall_ms"])

    def abandon_stalls(self, bucket_label: str) -> None:
        """Drop open windows for a bucket that will never dispatch again
        (retirement): an unclosed window must not pin ``stall_from``
        forever or report a fake week-long stall at shutdown."""
        with self._lock:
            pending = self._pending_stalls.pop(bucket_label, None)
            if not self._pending_stalls:
                self.has_pending_stalls = False
            for ev in pending or ():
                ev.pop("stall_from", None)

    # -- export ----------------------------------------------------------

    def snapshot(self, last: Optional[int] = None) -> List[dict]:
        """The retained event window (oldest first), copied. Events with
        a still-open stall window export without ``stall_ms`` (the
        internal ``stall_from`` mark never leaves the process). The
        per-event copies are built UNDER the lock: note_dispatch
        mutates open-window events under it, and ``dict(ev)`` over a
        concurrently-resized dict raises."""
        out = []
        with self._lock:
            events = list(self._events)
            for ev in events if last is None else events[-last:]:
                ev = dict(ev)
                ev.pop("stall_from", None)
                out.append(ev)
        return out

    def summary(self, tail: int = 32) -> dict:
        """The ``stats()["ledger"]`` document: counters + recent tail."""
        with self._lock:
            by_kind = dict(self._by_kind)
            by_cause = dict(self._by_cause)
            total = self.events_total
            dropped = self.dropped
            stall_ms = self.stall_ms_total
            stall_events = self.stall_events_total
            open_stalls = sum(len(v) for v in self._pending_stalls.values())
        return {
            "events_total": total,
            "dropped_total": dropped,
            "by_kind": by_kind,
            "by_cause": by_cause,
            "stall_ms_total": round(stall_ms, 3),
            "stall_events_total": stall_events,
            "open_stall_windows": open_stalls,
            "events": self.snapshot(last=tail) if tail else [],
        }

    def document(self) -> dict:
        """The ``/ledger`` endpoint / flight-dump ``ledger.json`` body:
        the full retained window plus the counters."""
        doc = self.summary(tail=0)
        doc["events"] = self.snapshot()
        doc["capacity"] = self.capacity
        return doc

    def signals(self) -> Dict[str, float]:
        """Flat counters for an owner's ``signals()`` export."""
        with self._lock:
            return {
                "ledger_events_total": float(self.events_total),
                "ledger_stall_events_total": float(self.stall_events_total),
                "ledger_stall_ms_total": round(self.stall_ms_total, 3),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
