"""Frame-lineage tracing & latency attribution (port of
``dvf_tpu.obs.lineage``: host code only, the same documents).

"Where did my p99 go" needs more than stage-centric lanes: the Perfetto
tracks (obs.trace) say the dispatch thread was busy, not why session 7's
p99 doubled. This module is the frame-granular answer — a lightweight
span context threaded through every hop a frame takes, so each delivered
frame carries an **additive latency decomposition** whose components sum
to its end-to-end latency BY CONSTRUCTION (telescoping timestamps), plus
the aggregation/exemplar machinery that makes it cheap at serving rates:

:class:`FrameLineage`
    One frame's hop record: ``(session_id, frame_index, capture ts)``
    plus an ordered list of ``(component, wall_ts)`` marks. Component
    *i* covers the interval ending at mark *i* (starting at the
    previous mark, or the capture ts for the first) — so the components
    always sum to ``last_mark − ts`` exactly, whatever the stamps are.
    Cross-process hops carry a clock re-base (:meth:`rebase`, the
    ``merge_tracer_snapshots`` epoch discipline): a replica's marks are
    shifted onto the front door's clock before the fleet appends its
    own components, keeping the telescoping sum honest across the RPC.

:class:`AttributionAggregate`
    Normal frames fold into bounded counters at near-zero cost: a
    sliding window of (total, components) rows from which per-component
    p50/p99 and the ``explain`` decomposition ("p99 = 62% queue_bucket,
    21% encode, …") are computed at scrape time, never on the hot path.

:class:`AttributionPlane`
    The per-frontend owner: frontend-wide + per-bucket + per-session
    aggregates, tail-based exemplar capture (frames breaching their
    session SLO — or the slowest K per window — retain FULL lineage and
    land in FlightRecorder dumps), and the flat ``attr_*`` signal row.

:func:`save_stage_profile` / :func:`load_stage_profile`
    The persisted per-signature stage-cost profile (sibling of the
    compile cache): measured per-component costs written at shutdown /
    bucket retirement, loaded at bucket creation — what the controllers
    annotate their decisions with and a topology-aware planner seeds
    from. Keyed per backend: a profile the reference package wrote for
    the same signature is a different file.

Serve-path components (in hop order; the glossary LATENCY.md documents):

==============  ============================================================
queue_ingress   capture/submit → drained into the scheduler's pending
                staging (session ingress queue wait, incl. the client's
                capture→submit gap)
queue_bucket    pending → chosen for a device batch (bucket queue wait —
                the EDF/cost scheduling delay, where an overloaded
                bucket's p99 usually went)
assemble_h2d    staging start → ``Engine.submit`` returned (batch
                assembly + host-to-device transfer)
device          submit → device result ready (device queue + compute —
                the per-bucket tick)
d2h             device ready → materialized into host memory
deliver         materialized → handed to the client (router demux +
                reorder wait + emit)
==============  ============================================================

Extended components appended past delivery: ``encode``/``send`` (the
wire bridge's codec plane + socket), ``rpc`` (the ProcessReplica hop:
replica delivery → fleet front door, clock-rebased).
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# Canonical hop order for rendering (components not listed sort last, in
# first-seen order). One place owns the strings; consumers match on them.
SERVE_COMPONENTS = ("queue_ingress", "queue_bucket", "assemble_h2d",
                    "device", "d2h", "deliver")
WIRE_COMPONENTS = ("encode", "send")
RPC_COMPONENT = "rpc"
# Broadcast fan-out hops (the reference's dvf_tpu.broadcast): the tier
# encode reuses "encode"; "fanout" is queue distribution inside a lane,
# "relay" the egress-replica hop — a watcher's p99 through a relay still
# decomposes additively (encode + fanout + relay + deliver).
BROADCAST_COMPONENTS = ("fanout", "relay")
_ORDER = {name: i for i, name in enumerate(
    SERVE_COMPONENTS + (RPC_COMPONENT,) + WIRE_COMPONENTS
    + BROADCAST_COMPONENTS)}


def component_order(name: str) -> Tuple[int, str]:
    """Sort key rendering components in hop order."""
    return (_ORDER.get(name, len(_ORDER)), name)


class FrameLineage:
    """One frame's hop trail (module docstring). Mutable and cheap:
    creation is one object + one list; each hop is one append. The
    object rides the serve Slot → reorder payload → Delivery, and
    pickles across the ProcessReplica RPC as plain attributes."""

    __slots__ = ("session_id", "frame_index", "ts", "marks")

    def __init__(self, session_id: str, frame_index: int, ts: float):
        self.session_id = session_id
        self.frame_index = frame_index
        self.ts = ts            # capture/submit epoch (wall clock)
        self.marks: List[Tuple[str, float]] = []

    def mark(self, component: str, t: Optional[float] = None) -> None:
        """End component ``component`` now (or at ``t``)."""
        self.marks.append((component, time.time() if t is None else t))

    def rebase(self, offset_s: float) -> None:
        """Shift this lineage's clock by ``offset_s`` — the cross-process
        re-base: a replica's marks are wall-clock stamps on ITS clock;
        the fleet front door measures the replica↔parent clock offset
        (RPC midpoint estimate) and shifts ts + every mark onto its own
        clock before appending parent-side components, so the
        telescoping additivity survives the hop (same discipline as
        ``merge_tracer_snapshots``'s epoch alignment)."""
        if not offset_s:
            return
        self.ts += offset_s
        self.marks = [(name, t + offset_s) for name, t in self.marks]

    # -- decomposition ---------------------------------------------------

    def components_ms(self) -> Dict[str, float]:
        """The additive decomposition: consecutive mark deltas, first
        from the capture ts. Repeated component names accumulate. Sums
        to :meth:`total_ms` exactly (float addition aside) — the
        invariant the golden test pins."""
        out: Dict[str, float] = {}
        prev = self.ts
        for name, t in self.marks:
            out[name] = out.get(name, 0.0) + (t - prev) * 1e3
            prev = t
        return out

    def total_ms(self) -> float:
        """End-to-end latency: last mark − capture ts."""
        if not self.marks:
            return 0.0
        return (self.marks[-1][1] - self.ts) * 1e3

    def to_dict(self) -> dict:
        """JSON-safe exemplar form (flight dumps, trace-view)."""
        return {
            "session": self.session_id,
            "index": self.frame_index,
            "t": self.ts,
            "total_ms": round(self.total_ms(), 3),
            "components": {k: round(v, 3)
                           for k, v in self.components_ms().items()},
        }

    def __repr__(self) -> str:  # debugging aid
        comps = ", ".join(f"{k}={v:.1f}ms" for k, v in sorted(
            self.components_ms().items(), key=lambda kv: component_order(
                kv[0])))
        return (f"FrameLineage({self.session_id!r}#{self.frame_index} "
                f"total={self.total_ms():.1f}ms: {comps})")


class AttributionAggregate:
    """Bounded sliding window of per-frame decompositions.

    ``observe`` is the hot-path cost of an attributed frame once its
    lineage closes: one dict of floats appended to a deque — no
    percentile work, which happens at :meth:`summary`/:meth:`explain`
    time (scrape/export), mirroring the registry's pull model."""

    def __init__(self, capacity: int = 2048):
        self.capacity = capacity
        self.count = 0
        self._rows: "collections.deque[Tuple[float, Dict[str, float]]]" = \
            collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        # Scrape results cached by fold version (self.count): the
        # percentile math over a full window costs milliseconds, and
        # pollers (bench drain loops, tight scrapers) re-ask when
        # nothing new folded — those calls must cost a dict read.
        self._summary_cache: Optional[Tuple[int, dict]] = None
        self._explain_cache: Optional[Tuple[int, float, Optional[dict]]] = \
            None

    def observe(self, total_ms: float,
                components: Dict[str, float]) -> None:
        with self._lock:
            self.count += 1
            self._rows.append((total_ms, components))

    def observe_many(
            self, rows: List[Tuple[float, Dict[str, float]]]) -> None:
        """Batch fold: ONE lock round for a whole routed batch — the
        delivery thread's per-frame cost is an append, nothing else."""
        with self._lock:
            self.count += len(rows)
            self._rows.extend(rows)

    def rows(self) -> List[Tuple[float, Dict[str, float]]]:
        with self._lock:
            return list(self._rows)

    def summary(self) -> dict:
        """Per-component p50/p99/mean over the window + the window's
        end-to-end percentiles. Empty window → counts only (gaps, not
        NaN — the strict-JSON surfaces sanitize anyway). Cached by fold
        version — treat the returned dict as read-only."""
        with self._lock:
            count = self.count
            cached = self._summary_cache
        if cached is not None and cached[0] == count:
            return cached[1]
        rows = self.rows()
        out: dict = {"count": count, "window_frames": len(rows)}
        if not rows:
            with self._lock:
                self._summary_cache = (count, out)
            return out
        totals = np.asarray([t for t, _ in rows])
        out["p50_ms"] = float(np.percentile(totals, 50))
        out["p99_ms"] = float(np.percentile(totals, 99))
        comps: Dict[str, list] = {}
        for _, c in rows:
            for k, v in c.items():
                comps.setdefault(k, []).append(v)
        by_comp = {}
        for k in sorted(comps, key=component_order):
            arr = np.asarray(comps[k])
            by_comp[k] = {
                "mean_ms": float(arr.mean()),
                "p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
            }
        out["components"] = by_comp
        with self._lock:
            self._summary_cache = (count, out)
        return out

    def explain(self, q: float = 99.0) -> Optional[dict]:
        """The headline decomposition: which components the SLOWEST
        frames actually spent their time in. Takes the window's tail at
        the ``q``-th end-to-end percentile, averages each component over
        those tail frames, and renders the fractions — "p99 = 62%
        queue_bucket, 21% encode, …". Tail-based on purpose: averaging
        over ALL frames describes the median experience and hides
        exactly the queueing spikes a p99 post-mortem is after. Cached
        by fold version (summary()'s discipline)."""
        with self._lock:
            count = self.count
            cached = self._explain_cache
        if cached is not None and cached[0] == count and cached[1] == q:
            return cached[2]
        rows = self.rows()
        if not rows:
            with self._lock:
                self._explain_cache = (count, q, None)
            return None
        totals = np.asarray([t for t, _ in rows])
        cut = float(np.percentile(totals, q))
        tail = [(t, c) for t, c in rows if t >= cut] or rows
        mean_total = sum(t for t, _ in tail) / len(tail)
        comp_mean: Dict[str, float] = {}
        for _, c in tail:
            for k, v in c.items():
                comp_mean[k] = comp_mean.get(k, 0.0) + v
        for k in comp_mean:
            comp_mean[k] /= len(tail)
        denom = mean_total if mean_total > 0 else 1.0
        fractions = {k: comp_mean[k] / denom
                     for k in sorted(comp_mean, key=component_order)}
        ranked = sorted(fractions.items(), key=lambda kv: -kv[1])
        text = f"p{q:g} = " + ", ".join(
            f"{frac:.0%} {name}" for name, frac in ranked
            if frac >= 0.005) if ranked else "no data"
        doc = {
            "quantile": q,
            "p_ms": cut,
            "tail_frames": len(tail),
            "tail_mean_ms": mean_total,
            "fractions": {k: round(v, 4) for k, v in fractions.items()},
            "text": text,
        }
        with self._lock:
            self._explain_cache = (count, q, doc)
        return doc


class ExemplarBuffer:
    """Tail-based exemplar capture: frames breaching their session SLO
    always retain full lineage (bounded deque); independently, the
    slowest ``slow_k`` frames of each ``window_frames``-frame window are
    folded in, so a run that never breaches still leaves evidence of
    where its worst latency went. What FlightRecorder dumps read."""

    def __init__(self, capacity: int = 64, window_frames: int = 512,
                 slow_k: int = 4):
        self.capacity = capacity
        self.window_frames = window_frames
        self.slow_k = slow_k
        self.breaches_total = 0
        self._kept: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._window: List[Tuple[float, dict]] = []  # (total, record)
        self._seen = 0
        self._lock = threading.Lock()

    def observe_many(self, items, slo_ms: Optional[float]) -> None:
        """Batch form of :meth:`observe`: one lock round for a routed
        batch's ``(lineage, total_ms)`` pairs."""
        with self._lock:
            for lineage, total_ms in items:
                self._observe_locked(lineage, total_ms, slo_ms)

    def observe(self, lineage: "FrameLineage", total_ms: float,
                slo_ms: Optional[float]) -> None:
        with self._lock:
            self._observe_locked(lineage, total_ms, slo_ms)

    def _observe_locked(self, lineage: "FrameLineage", total_ms: float,
                        slo_ms: Optional[float]) -> None:
        self._seen += 1
        if slo_ms is not None and total_ms > slo_ms:
            self.breaches_total += 1
            rec = dict(lineage.to_dict(), slo_ms=slo_ms, breach=True)
            self._kept.append(rec)
        elif self.slow_k > 0 and (
                len(self._window) < self.slow_k
                or total_ms > self._window[-1][0]):
            # Candidate for the window's slowest-K fold. The record
            # dict is built ONLY when the frame actually beats the
            # current K-th slowest — the common fast frame costs one
            # comparison, keeping "normal frames fold into counters
            # at near-zero cost" honest.
            rec = dict(lineage.to_dict(), slo_ms=slo_ms, breach=False)
            self._window.append((total_ms, rec))
            self._window.sort(key=lambda tr: -tr[0])
            del self._window[self.slow_k:]
        if self._seen >= self.window_frames:
            self._fold_window_locked()

    def _fold_window_locked(self) -> None:
        for _, rec in sorted(self._window, key=lambda tr: tr[0]):
            self._kept.append(rec)
        self._window = []
        self._seen = 0

    def snapshot(self) -> List[dict]:
        """Exemplars, most recent last; the current (unfolded) window's
        slowest candidates are included so a dump fired mid-window still
        carries its evidence."""
        with self._lock:
            out = list(self._kept)
            out.extend(rec for _, rec in
                       sorted(self._window, key=lambda tr: tr[0]))
        return out


class AttributionPlane:
    """The per-frontend lineage owner (module docstring).

    ``observe`` runs once per delivered frame on the delivery thread;
    everything else (summaries, explain, signals, snapshots) is
    pull-model scrape-time work."""

    # Per-session/per-bucket aggregates are bounded: a churning server
    # must not grow one window per dead tenant (or retired signature)
    # forever. Least-recently-delivering evicted.
    MAX_SESSIONS = 64
    MAX_BUCKETS = 64

    def __init__(self, exemplar_capacity: int = 64,
                 window_frames: int = 512, slow_k: int = 4,
                 agg_capacity: int = 2048):
        self.frames_total = 0
        self._agg_capacity = agg_capacity
        self.aggregate = AttributionAggregate(agg_capacity)
        self.by_bucket: Dict[str, AttributionAggregate] = {}
        self.by_session: Dict[str, AttributionAggregate] = {}
        # Post-delivery wire components (encode/send) live in their own
        # window: they close AFTER the frame's e2e lineage (whose total
        # the additivity invariant pins at delivery), so folding them
        # into the same rows would break the "components sum to e2e"
        # contract the aggregate promises.
        self.wire = AttributionAggregate(agg_capacity)
        self.exemplars = ExemplarBuffer(exemplar_capacity, window_frames,
                                        slow_k)
        self._lock = threading.Lock()

    def observe(self, lineage: "FrameLineage", total_ms: float,
                slo_ms: Optional[float],
                bucket_label: Optional[str] = None) -> None:
        self.observe_batch([(lineage, total_ms)], slo_ms, bucket_label)

    def observe_batch(self, items, slo_ms: Optional[float],
                      bucket_label: Optional[str] = None) -> None:
        """Fold a routed batch's closed lineages — ``(lineage,
        total_ms)`` pairs sharing one session's SLO and bucket — in ONE
        pass: one lock round per aggregate per BATCH, not per frame.
        This is the delivery thread's entire per-batch attribution
        cost; everything percentile-shaped happens at scrape time."""
        if not items:
            return
        rows = [(total_ms, lin.components_ms()) for lin, total_ms in items]
        with self._lock:
            self.frames_total += len(items)
            agg_b = None
            if bucket_label is not None:
                # Same LRU discipline as by_session below: bounded by
                # distinct recently-serving signatures, not by lifetime
                # signature churn.
                agg_b = self.by_bucket.pop(bucket_label, None)
                if agg_b is None:
                    agg_b = AttributionAggregate(self._agg_capacity)
                self.by_bucket[bucket_label] = agg_b
                while len(self.by_bucket) > self.MAX_BUCKETS:
                    self.by_bucket.pop(next(iter(self.by_bucket)))
            sid = items[0][0].session_id
            # LRU, not insertion order: each delivering session's entry
            # moves to the back, so the bound evicts the session that
            # has DELIVERED least recently (retired/idle tenants), not
            # whichever active session happened to be admitted first —
            # insertion-order eviction would thrash every still-active
            # window the moment live sessions exceed the cap.
            agg_s = self.by_session.pop(sid, None)
            if agg_s is None:
                agg_s = AttributionAggregate(self._agg_capacity)
            self.by_session[sid] = agg_s
            while len(self.by_session) > self.MAX_SESSIONS:
                self.by_session.pop(next(iter(self.by_session)))
        self.aggregate.observe_many(rows)
        if agg_b is not None:
            agg_b.observe_many(rows)
        agg_s.observe_many(rows)
        self.exemplars.observe_many(items, slo_ms)

    def observe_wire(self, lineage: "FrameLineage") -> None:
        """Fold a lineage EXTENDED past delivery (the bridge's
        encode/send marks) into the wire-component window. The e2e
        aggregates already saw this frame at delivery; only the
        post-delivery components are new."""
        comps = {k: v for k, v in lineage.components_ms().items()
                 if k in WIRE_COMPONENTS}
        if comps:
            self.wire.observe(sum(comps.values()), comps)

    # -- exports ---------------------------------------------------------

    def summary(self) -> dict:
        """The stats() document: frontend-wide components + explain,
        per-bucket and per-session windows, wire components, exemplar
        accounting."""
        with self._lock:
            buckets = dict(self.by_bucket)
            sessions = dict(self.by_session)
        doc = {
            "frames_total": self.frames_total,
            "breaches_total": self.exemplars.breaches_total,
            "exemplars": len(self.exemplars.snapshot()),
            **self.aggregate.summary(),
        }
        expl = self.aggregate.explain()
        if expl is not None:
            doc["explain"] = expl
        wire = self.wire.summary()
        if wire.get("components"):
            doc["wire"] = wire
        if buckets:
            doc["by_bucket"] = {k: v.summary() for k, v in buckets.items()}
        if sessions:
            doc["by_session"] = {k: v.summary()
                                 for k, v in sessions.items()}
        return doc

    def explain(self, q: float = 99.0) -> dict:
        """The ``explain`` surface: frontend-wide + per-bucket tail
        decompositions, human line first."""
        with self._lock:
            buckets = dict(self.by_bucket)
        doc: dict = {"frames_total": self.frames_total}
        top = self.aggregate.explain(q)
        if top is not None:
            doc.update(top)
        by_bucket = {}
        for label, agg in buckets.items():
            e = agg.explain(q)
            if e is not None:
                by_bucket[label] = e
        if by_bucket:
            doc["by_bucket"] = by_bucket
        return doc

    def snapshot(self) -> dict:
        """The flight-dump artifact (``lineage.json``): aggregates +
        explain + FULL exemplar lineages."""
        return {
            "summary": self.summary(),
            "explain": self.explain(),
            "exemplars": self.exemplars.snapshot(),
        }

    def signals(self) -> Dict[str, float]:
        """Flat registry-conformant attr_* row for signals()/metrics:
        per-component p99 over the window plus the lineage counters."""
        out = {
            "lineage_frames_total": float(self.frames_total),
            "lineage_breaches_total": float(
                self.exemplars.breaches_total),
        }
        s = self.aggregate.summary()
        for comp, row in (s.get("components") or {}).items():
            out[f"attr_{comp}_p99_ms"] = row["p99_ms"]
        w = self.wire.summary()
        for comp, row in (w.get("components") or {}).items():
            out[f"attr_{comp}_p99_ms"] = row["p99_ms"]
        return out

    def bucket_stage_cost_ms(self, label: str) -> Optional[Dict[str, float]]:
        """Per-bucket measured MEAN component costs — the control-plane
        annotation, cheap on purpose (one pass over the window, no
        percentile work: this runs per control sample). None before any
        attributed frame for that bucket."""
        with self._lock:
            agg = self.by_bucket.get(label)
        if agg is None:
            return None
        rows = agg.rows()
        if not rows:
            return None
        sums: Dict[str, float] = {}
        for _, c in rows:
            for k, v in c.items():
                sums[k] = sums.get(k, 0.0) + v
        return {k: round(v / len(rows), 4) for k, v in sums.items()}

    def bucket_profile_doc(self, label: str) -> Optional[dict]:
        """Full per-component statistics for one bucket, in the shape
        :func:`save_stage_profile` persists. None before any attributed
        frame."""
        with self._lock:
            agg = self.by_bucket.get(label)
        if agg is None:
            return None
        s = agg.summary()
        comps = s.get("components")
        if not comps:
            return None
        return {"components": comps, "count": s["window_frames"]}


# ---------------------------------------------------------------------------
# Persisted per-signature stage-cost profiles (sibling of the compile cache)
# ---------------------------------------------------------------------------


PROFILE_VERSION = 1

# Merge-weight ceiling: the previous profile's accumulated count is
# clamped to this when merging, so a fresh run's window (≤ a few
# thousand frames) always keeps a meaningful weight — without it the
# stored count grows without bound and after enough runs a real cost
# change (code change, different host) would move the merged means by
# well under 1% per run, seeding controllers with stale numbers forever.
PROFILE_MERGE_MAX = 16_384


# Profiles are measured stage costs of THIS backend: the hash that names
# a profile's file is taken over the signature with this tag in front, so
# a profile directory shared with the reference package never seeds a
# CUDA bucket from costs measured on another device (the two packages
# render a signature identically).
PROFILE_BACKEND = "torch-cuda"


def _profile_path(profile_dir: str, signature: str) -> str:
    """One JSON file per canonical signature, named by a stable hash
    (signature renders contain ``|``/``x`` — not filename-safe) of the
    backend tag and the render."""
    h = hashlib.sha256(
        f"{PROFILE_BACKEND}|{signature}".encode()).hexdigest()[:16]
    return os.path.join(profile_dir, f"stage-profile-{h}.json")


def save_stage_profile(profile_dir: str, signature: str,
                       components_ms: Dict[str, dict],
                       tick_cost_ms: Optional[float] = None,
                       count: int = 0) -> Optional[str]:
    """Persist one signature's measured stage costs (atomic write:
    tmp + rename, so a concurrent reader never sees a torn file). An
    existing profile is count-weighted-merged rather than overwritten —
    a short run must not clobber a long run's statistics. Best-effort:
    returns the path, or None when the write failed (profiles are
    optimization state, never worth failing a shutdown over)."""
    lock_f = None
    try:
        os.makedirs(profile_dir, exist_ok=True)
        path = _profile_path(profile_dir, signature)
        # Serialize the read-merge-write against concurrent writers
        # (N fleet replicas stopping at once share one profile dir):
        # os.replace alone prevents torn files, not lost updates — the
        # last writer would silently discard the others' merges. ONE
        # lock file per directory (never unlinked — removing it would
        # reopen the lost-update race between a holder of the old inode
        # and an opener of a fresh one; one bounded file beats
        # per-signature litter).
        try:
            import fcntl

            lock_f = open(os.path.join(profile_dir,
                                       ".stage-profiles.lock"), "w")
            fcntl.flock(lock_f, fcntl.LOCK_EX)
        except (ImportError, OSError):
            lock_f = None  # no flock (or lockfile unwritable): fall
            #   back to the unserialized best-effort write
        prev = load_stage_profile(profile_dir, signature)
        merged = {k: dict(v) for k, v in components_ms.items()}
        total = count
        if prev and prev.get("components_ms") and prev.get("count"):
            pc = prev["components_ms"]
            pn = min(int(prev["count"]), PROFILE_MERGE_MAX)
            total = count + pn
            if total > 0:
                for k in set(merged) | set(pc):
                    a = merged.get(k)
                    b = pc.get(k)
                    if a is None:
                        merged[k] = dict(b)
                    elif b is not None:
                        merged[k] = {
                            kk: (a.get(kk, 0.0) * count
                                 + b.get(kk, 0.0) * pn) / total
                            for kk in set(a) | set(b)}
            if tick_cost_ms is None:
                tick_cost_ms = prev.get("tick_cost_ms")
            elif prev.get("tick_cost_ms") is not None:
                # A lineage-off run has count=0 but a REAL measured tick
                # (the live EWMA): weighting it by 0 would freeze the
                # stored tick at the first lineage-on run's value
                # forever. Give a windowless measurement equal weight to
                # the accumulated history (a 50/50 blend per run —
                # geometric convergence to the current truth).
                wn = count if count > 0 else max(pn, 1)
                tick_cost_ms = (tick_cost_ms * wn
                                + prev["tick_cost_ms"] * pn) / (wn + pn)
        doc = {
            "version": PROFILE_VERSION,
            "signature": signature,
            "components_ms": merged,
            "tick_cost_ms": tick_cost_ms,
            "count": total,
            "updated": time.time(),
        }
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None
    finally:
        if lock_f is not None:
            try:
                lock_f.close()  # releases the flock
            except OSError:
                pass


def load_stage_profile(profile_dir: Optional[str],
                       signature: str) -> Optional[dict]:
    """Read one signature's persisted profile; None when absent,
    unreadable, or a foreign version (best-effort, like the compile
    cache: a missing profile only means the first window re-measures)."""
    if not profile_dir:
        return None
    try:
        with open(_profile_path(profile_dir, signature)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict) or doc.get("version") != PROFILE_VERSION:
        return None
    return doc
