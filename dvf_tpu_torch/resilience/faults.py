"""Structured fault taxonomy for every containment site (port of
``dvf_tpu.resilience.faults``; the same kinds, site defaults and
messages).

Every contained error is classified into one :class:`FaultKind`, counted
per kind in a :class:`FaultStats` (exported through the pipeline's and
the worker's ``stats()``) and fed to the per-kind
:class:`~dvf_tpu_torch.resilience.budget.ErrorBudget` that decides drop →
degrade → fail escalation.

Classification is two-layered: code that knows what failed raises (or
wraps into) a :class:`FaultError` carrying its kind — the streamed
ingest's host→device copy wraps as ``h2d``, chaos injections carry their
configured kind — and everything else is classified by :func:`classify`
from the exception type and message plus the containment site. PyTorch's
``torch.cuda.OutOfMemoryError`` ("CUDA out of memory. Tried to allocate
…") carries an out-of-memory marker, so it classifies as ``oom``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class FaultKind:
    """The error taxonomy (string constants, not an Enum — the values ride
    through JSON stats payloads and log lines as-is)."""

    DECODE = "decode"        # frame/JPEG decode, source read
    GEOMETRY = "geometry"    # stream geometry changed mid-flight (re-probe)
    TRANSPORT = "transport"  # malformed/truncated wire messages, socket
    #                          errors, result encode/send failures (the
    #                          egress codec plane's wire-prep domain)
    H2D = "h2d"              # host→device transfer failures
    D2H = "d2h"              # device→host transfer (streamed result fetch)
    COMPUTE = "compute"      # the filter step / result materialization
    OOM = "oom"              # device memory exhaustion
    STALL = "stall"          # watchdog: in-flight work older than the timeout
    REPLICA = "replica"      # a fleet engine replica was lost (process died,
    #                          RPC channel broke, health check failed) —
    #                          the fleet tier's drain/migrate/restart domain
    INTEGRITY = "integrity"  # the audit plane's domain (obs.audit):
    #                          content-digest mismatch on a framed wire
    #                          payload, a shadow-replay or swap-guard
    #                          divergence from the golden path — the
    #                          pixels are WRONG even though everything
    #                          parsed and delivered
    PARTITION = "partition"  # the continuity plane's domain
    #                          (resilience.continuity): a peer went
    #                          silent past its liveness timeout — the
    #                          link is partitioned, not merely slow.
    #                          Distinct from TRANSPORT (the bytes were
    #                          wrong) and STALL (our own work wedged):
    #                          nothing arrived at all, and the response
    #                          is a budgeted reconnect, not a drop.
    INTERNAL = "internal"    # everything else (bookkeeping bugs, sinks)


ALL_KINDS = (
    FaultKind.DECODE, FaultKind.GEOMETRY, FaultKind.TRANSPORT,
    FaultKind.H2D, FaultKind.D2H, FaultKind.COMPUTE, FaultKind.OOM,
    FaultKind.STALL, FaultKind.REPLICA, FaultKind.INTEGRITY,
    FaultKind.PARTITION, FaultKind.INTERNAL,
)

# Default classification for exceptions that carry no kind of their own,
# keyed by the containment site that caught them (the site string each
# `_contain(e, where)` call already passes).
_SITE_DEFAULT = {
    # single-stream pipeline sites
    "ingest": FaultKind.DECODE,      # source read/decode domain
    "dispatch": FaultKind.COMPUTE,   # staging + engine submit
    "collect": FaultKind.COMPUTE,    # result materialization
    "sink": FaultKind.INTERNAL,
    # zmq worker / serving sites
    "decode": FaultKind.DECODE,
    "transport": FaultKind.TRANSPORT,
    "h2d": FaultKind.H2D,
    "d2h": FaultKind.D2H,
    "encode": FaultKind.TRANSPORT,   # egress codec plane: wire-prep domain
    "compute": FaultKind.COMPUTE,
    "worker": FaultKind.COMPUTE,     # worker loop: engine is the main residue
}

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM", "Resource exhausted")


class FaultError(RuntimeError):
    """An error with a known :class:`FaultKind` attached.

    Raised directly by chaos injections and by containment sites that
    escalate ("error budget exhausted"), and used to wrap exceptions at
    the few points that know exactly which fault domain failed (the
    streamed ingest's host→device copy, the worker's decode path).
    """

    def __init__(self, kind: str, message: str, fatal: bool = False):
        super().__init__(message)
        self.kind = kind
        self.fatal = fatal  # budget-exhaustion errors set this so generic
        #   per-iteration containment re-raises instead of re-containing


def classify(exc: BaseException, site: Optional[str] = None) -> str:
    """Map one contained exception to its :class:`FaultKind`."""
    if isinstance(exc, FaultError):
        return exc.kind
    try:  # lazy: transport.codec is optional-dependency-adjacent
        from dvf_tpu_torch.transport.codec import JpegGeometryError

        if isinstance(exc, JpegGeometryError):
            return FaultKind.GEOMETRY
    except Exception:  # noqa: BLE001 — classification must never raise
        pass
    msg = f"{type(exc).__name__}: {exc}"
    if any(m in msg for m in _OOM_MARKERS):
        return FaultKind.OOM
    if isinstance(exc, (TimeoutError,)):
        return FaultKind.STALL
    return _SITE_DEFAULT.get(site or "", FaultKind.INTERNAL)


class FaultStats:
    """Per-kind fault counters + last-error records (thread-safe).

    One instance per pipeline/frontend/worker; ``summary()`` is embedded
    in their ``stats()`` exports and the bench JSON so a BENCH round can
    assert exact per-kind counts (zero, for a clean run).

    ``replica``: the fleet tier runs one frontend (and so one FaultStats)
    per engine replica; labeling the recorder attributes every fault —
    and every fault record — to the replica that absorbed it, so the
    merged fleet export (and a fleet bench round's ``faults`` JSON) can
    say *which* replica ate what instead of anonymous per-kind counters.
    Single-engine paths leave it None and the summary shape is unchanged.
    """

    def __init__(self, replica: Optional[str] = None):
        self._lock = threading.Lock()
        self.replica = replica
        self.counts: Dict[str, int] = {}
        self.last: Dict[str, dict] = {}
        self.by_replica: Dict[str, Dict[str, int]] = {}

    def record(self, kind: str, exc: Optional[BaseException] = None,
               replica: Optional[str] = None) -> None:
        rep = replica if replica is not None else self.replica
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            rec = {
                "error": repr(exc) if exc is not None else None,
                "ts": time.time(),
            }
            if rep is not None:
                rec["replica"] = rep
                per = self.by_replica.setdefault(rep, {})
                per[kind] = per.get(kind, 0) + 1
            self.last[kind] = rec

    def count(self, kind: str) -> int:
        with self._lock:
            return self.counts.get(kind, 0)

    def total(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def summary(self) -> dict:
        with self._lock:
            out = {
                "total": sum(self.counts.values()),
                "by_kind": dict(self.counts),
                "last": {k: dict(v) for k, v in self.last.items()},
            }
            if self.by_replica:
                out["by_replica"] = {r: dict(kinds)
                                     for r, kinds in self.by_replica.items()}
            return out

    def absorb_summary(self, summary: dict,
                       replica: Optional[str] = None) -> None:
        """Fold another recorder's exported ``summary()`` into this one —
        the fleet front door merging per-replica exports that arrived
        over an RPC (the recorder object itself never crosses the
        process boundary). ``replica`` attributes the absorbed counts
        when the source summary carries no ``by_replica`` of its own."""
        by_kind = summary.get("by_kind", {}) or {}
        by_replica = summary.get("by_replica") or (
            {replica: by_kind} if replica is not None and by_kind else {})
        with self._lock:
            for kind, n in by_kind.items():
                self.counts[kind] = self.counts.get(kind, 0) + int(n)
            for rep, kinds in by_replica.items():
                per = self.by_replica.setdefault(rep, {})
                for kind, n in kinds.items():
                    per[kind] = per.get(kind, 0) + int(n)
            for kind, rec in (summary.get("last", {}) or {}).items():
                rec = dict(rec)
                if replica is not None and "replica" not in rec:
                    rec["replica"] = replica
                mine = self.last.get(kind)
                if mine is None or (rec.get("ts") or 0) >= (mine.get("ts") or 0):
                    self.last[kind] = rec
