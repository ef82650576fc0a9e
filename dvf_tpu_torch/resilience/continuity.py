"""Session continuity plane: liveness, reconnect, replay, and resume
(port of ``dvf_tpu.resilience.continuity``; host code only).

Everything below the serve tier treats a dead peer as an *error*; this
module is the shared vocabulary that turns it into an operating regime.
Four small, independently testable pieces compose into the continuity
guarantees the wire planes and the fleet front door build on:

``LivenessMonitor`` + ``HeartbeatConfig``
    Bounded-timeout last-seen tracking. A peer that has not produced a
    message (or an explicit heartbeat) within ``timeout_s`` is declared
    *partitioned* — a measured, classified event
    (:data:`~dvf_tpu_torch.resilience.faults.FaultKind.PARTITION`), not a
    silent stall. The monitor never does I/O; each wire plane feeds it
    from its own poll loop.

``ReconnectPolicy``
    Seeded jittered exponential backoff for the reconnect that follows a
    partition. Jitter is deterministic per (seed, attempt) so chaos runs
    replay exactly; the cap bounds the worst-case dark window.

``ReplayRing``
    A bounded delivered-tail ring keyed by frame index. Sessions record
    every delivery into their ring; a resuming client replays the tail
    from its last-seen index and dedups by index, which upgrades the
    at-most-once delivery of the base planes to effectively-exactly-once
    *within the replay window*. The ring stores references (frames are
    already owned by the delivery path), so the cost is one dict slot
    per delivered frame.

Resume tokens (:func:`make_resume_token` / :func:`check_resume_token`)
    A keyed-BLAKE2 MAC over ``(session id, epoch)``. ``open_stream``
    hands one out; a reconnecting client (or a front door restarted from
    a snapshot) presents it to prove the resume targets the session it
    was issued for. The secret never leaves the issuing process except
    via the crash snapshot, which is what lets a *restarted* front door
    honor tokens issued by its previous incarnation.

``ResumableStream``
    The client half of exactly-once: tracks submitted source frames,
    absorbs deliveries with dedup-by-index, names the gaps so the caller
    can resubmit them, and reassembles the stream in source order. Under
    ``net_dup``/``net_reorder``/``net_partition`` chaos plus replica
    SIGKILL, ``assembled()`` is byte-identical to a fault-free run —
    that is the invariant ``benchmarks/continuity_bench.py`` soaks.

Crash-consistent state (:func:`atomic_write_json` / :func:`load_json`)
    tmp-file + ``os.replace`` snapshot discipline for the fleet router's
    session registry. A snapshot is either the old document or the new
    one, never a torn write — ``kill -9`` at any instant leaves a
    loadable file.

All counters roll up into :class:`ContinuityStats`, exported as flat
``dvf_continuity_*`` gauges through each owner's ``signals()``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import hmac
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dvf_tpu_torch.resilience.faults import FaultError, FaultKind


class PartitionError(FaultError):
    """A liveness timeout declared the link dead (kind ``partition``)."""

    def __init__(self, message: str):
        super().__init__(FaultKind.PARTITION, message)


@dataclasses.dataclass
class HeartbeatConfig:
    """Liveness + reconnect tuning shared by the three wire planes.

    ``timeout_s`` must comfortably exceed ``interval_s`` (a single lost
    heartbeat is noise, not a partition); the default 4× ratio follows
    the usual phi-accrual rule of thumb without the machinery."""

    interval_s: float = 0.5      # how often a quiet peer emits a beat
    timeout_s: float = 2.0       # silence beyond this = partitioned
    backoff_base_s: float = 0.05  # first reconnect delay
    backoff_max_s: float = 2.0    # cap on the exponential
    backoff_jitter: float = 0.25  # ±fraction of the delay, seeded
    replay_window: int = 64       # delivered-tail frames kept for resume

    def validate(self) -> "HeartbeatConfig":
        if self.timeout_s <= self.interval_s:
            raise ValueError(
                f"heartbeat timeout_s ({self.timeout_s}) must exceed "
                f"interval_s ({self.interval_s}): one lost beat is not "
                f"a partition")
        return self


class ReconnectPolicy:
    """Jittered exponential backoff, deterministic per (seed, attempt).

    ``next_delay()`` advances the attempt counter and returns the delay
    to sleep before the next connect attempt; ``reset()`` on success.
    Jitter is drawn from a Random seeded once, so a seeded chaos run
    reproduces its exact reconnect timeline."""

    def __init__(self, config: Optional[HeartbeatConfig] = None,
                 seed: int = 0):
        self.config = config or HeartbeatConfig()
        self._rng = random.Random(seed)
        self.attempt = 0
        self.reconnects = 0   # lifetime successful resets

    def next_delay(self) -> float:
        c = self.config
        base = min(c.backoff_max_s,
                   c.backoff_base_s * (2.0 ** self.attempt))
        self.attempt += 1
        if c.backoff_jitter <= 0:
            return base
        # uniform in [1-j, 1+j]; never negative, never zero
        return base * (1.0 + c.backoff_jitter
                       * (2.0 * self._rng.random() - 1.0))

    def reset(self) -> None:
        if self.attempt:
            self.reconnects += 1
        self.attempt = 0


class LivenessMonitor:
    """Last-seen tracking for a set of peers (thread-safe, no I/O).

    Owners call :meth:`beat` on every message (data counts as liveness —
    explicit heartbeats only matter on quiet links) and poll
    :meth:`dead` from their loop to reap partitioned peers."""

    def __init__(self, timeout_s: float = 2.0):
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._last: Dict[Any, float] = {}

    def beat(self, peer: Any, now: Optional[float] = None) -> None:
        with self._lock:
            self._last[peer] = time.monotonic() if now is None else now

    def alive(self, peer: Any, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self._last.get(peer)
        return last is not None and (now - last) <= self.timeout_s

    def silence_s(self, peer: Any,
                  now: Optional[float] = None) -> Optional[float]:
        """Seconds since the peer's last beat (None = never seen)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self._last.get(peer)
        return None if last is None else max(0.0, now - last)

    def dead(self, now: Optional[float] = None) -> List[Any]:
        """Peers silent beyond the timeout (still tracked until
        :meth:`forget` — the caller owns the reap action)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return [p for p, last in self._last.items()
                    if (now - last) > self.timeout_s]

    def forget(self, peer: Any) -> None:
        with self._lock:
            self._last.pop(peer, None)

    def peers(self) -> List[Any]:
        with self._lock:
            return list(self._last)


class ReplayRing:
    """Bounded delivered-tail ring keyed by frame index (thread-safe).

    ``push`` evicts the oldest entry beyond ``capacity``;
    ``replay_from(index)`` returns every retained entry with
    ``index >= from_index`` in index order — the resume path's tail.
    Indices may arrive out of order (``net_reorder``): the ring keys by
    index, not arrival, so replay order is always correct."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._items: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()
        self.pushed = 0
        self.evicted = 0

    def push(self, index: int, item: Any) -> None:
        with self._lock:
            if index in self._items:   # duplicate delivery: keep first
                return
            self._items[index] = item
            self.pushed += 1
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)
                self.evicted += 1

    def replay_from(self, from_index: int) -> List[Tuple[int, Any]]:
        with self._lock:
            return sorted(
                ((i, v) for i, v in self._items.items()
                 if i >= from_index),
                key=lambda pair: pair[0])

    def oldest(self) -> Optional[int]:
        with self._lock:
            return min(self._items) if self._items else None

    def latest(self) -> Optional[int]:
        with self._lock:
            return max(self._items) if self._items else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


# -- resume tokens -------------------------------------------------------

_TOKEN_VERSION = "ct1"


def new_secret() -> bytes:
    """A per-frontend token-signing key (16 random bytes)."""
    return os.urandom(16)


def make_resume_token(session_id: str, epoch: int, secret: bytes) -> str:
    """MAC ``(session_id, epoch)`` under ``secret``.

    The epoch is the issuing incarnation's marker (the fleet uses its
    session generation); it rides in the clear so the verifier can
    recompute the MAC without a lookup. Format:
    ``ct1.<epoch>.<hex mac>`` — session id deliberately NOT embedded
    (the client already names the session it resumes; embedding it
    would only add a parsing surface)."""
    mac = hashlib.blake2b(
        f"{session_id}:{int(epoch)}".encode(), key=secret,
        digest_size=16).hexdigest()
    return f"{_TOKEN_VERSION}.{int(epoch)}.{mac}"


def check_resume_token(token: str, session_id: str,
                       secret: bytes) -> Optional[int]:
    """Verify ``token`` against ``session_id``; return its epoch, or
    None on any mismatch (wrong session, wrong key, malformed, wrong
    version). Constant-time MAC comparison; never raises."""
    try:
        version, epoch_s, mac = str(token).split(".", 2)
        if version != _TOKEN_VERSION:
            return None
        epoch = int(epoch_s)
        want = hashlib.blake2b(
            f"{session_id}:{epoch}".encode(), key=secret,
            digest_size=16).hexdigest()
        return epoch if hmac.compare_digest(mac, want) else None
    except Exception:  # noqa: BLE001 — verification must never raise
        return None


# -- crash-consistent snapshots ------------------------------------------

def atomic_write_json(path: str, doc: dict) -> None:
    """Write ``doc`` so a crash at ANY instant leaves either the old
    snapshot or the new one on disk: serialize to a sibling tmp file,
    fsync it, then ``os.replace`` (atomic within a filesystem)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    data = json.dumps(doc, sort_keys=True).encode()
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def load_json(path: str) -> Optional[dict]:
    """Load a snapshot; None when missing or unparsable (a torn write
    cannot happen under :func:`atomic_write_json`, but a half-written
    foreign file should degrade to 'no snapshot', not a crash)."""
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode())
        return doc if isinstance(doc, dict) else None
    except Exception:  # noqa: BLE001
        return None


# -- shared counters ------------------------------------------------------

class ContinuityStats:
    """Thread-safe counters for the continuity plane, exported as flat
    ``dvf_continuity_*`` gauges. One instance per owner (bridge, worker,
    gate, fleet front door); the owner merges ``signals()`` into its
    own scrape export."""

    FIELDS = ("partitions", "reconnects", "reconnect_failures",
              "heartbeats", "replays", "replayed_frames", "dup_drops",
              "resumes", "resume_rejected", "snapshots",
              "adopted_replicas", "adopted_sessions")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {f: 0 for f in self.FIELDS}

    def inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] = self._counts.get(field, 0) + n

    def get(self, field: str) -> int:
        with self._lock:
            return self._counts.get(field, 0)

    def summary(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def signals(self) -> Dict[str, float]:
        with self._lock:
            return {f"dvf_continuity_{k}": float(v)
                    for k, v in self._counts.items()}


# -- client-side exactly-once assembly ------------------------------------

class ResumableStream:
    """The client half of replay-window exactly-once delivery.

    The fleet assigns delivery indices itself (a resubmitted source
    frame gets a NEW index), so naive dedup-by-index alone cannot
    reassemble a stream across retries. This helper keeps the two maps
    that make it work:

    - :meth:`note_submit` records ``delivery index -> source frame n``
      at each submit (including resubmits of a lost frame);
    - :meth:`absorb` dedups incoming deliveries by delivery index
      (``net_dup`` noise and replay overlap both collapse here) and
      slots each surviving frame by its source n;
    - :meth:`missing` names the source frames still undelivered, so the
      caller can resubmit exactly those after a partition or replica
      loss;
    - :meth:`assembled` returns the frames in source order — the thing
      chaos acceptance compares byte-for-byte against a fault-free run.

    Single-client-thread object (matches submit/poll ownership); the
    dedup set is bounded (``seen_capacity``) with FIFO eviction, safe
    because duplicates only ever arrive within the replay window."""

    def __init__(self, seen_capacity: int = 4096):
        self._source_of: Dict[int, int] = {}   # delivery idx -> source n
        self._frames: Dict[int, Any] = {}      # source n -> delivery
        self._seen: set = set()
        self._seen_fifo: "collections.deque[int]" = collections.deque()
        self._seen_capacity = max(16, int(seen_capacity))
        self.submitted = 0
        self.resubmitted = 0
        self.dup_drops = 0
        self.unknown_drops = 0   # delivery index we never submitted

    def note_submit(self, index: int, source_n: int) -> None:
        if source_n in self._frames:
            return   # already delivered: a racing resubmit is moot
        if index in self._source_of:
            return
        prior = source_n in set(self._source_of.values())
        self._source_of[index] = source_n
        self.submitted += 1
        if prior:
            self.resubmitted += 1

    def absorb(self, deliveries: List[Any]) -> List[Tuple[int, Any]]:
        """Fold a poll batch in; returns the NEW ``(source_n,
        delivery)`` pairs in arrival order (duplicates and unknowns
        dropped and counted)."""
        fresh: List[Tuple[int, Any]] = []
        for d in deliveries:
            idx = d.index
            if idx in self._seen:
                self.dup_drops += 1
                continue
            self._seen.add(idx)
            self._seen_fifo.append(idx)
            while len(self._seen_fifo) > self._seen_capacity:
                self._seen.discard(self._seen_fifo.popleft())
            n = self._source_of.pop(idx, None)
            if n is None:
                self.unknown_drops += 1
                continue
            if n in self._frames:
                # an older retry of the same source frame landed first;
                # content is identical (deterministic filter), keep it
                self.dup_drops += 1
                continue
            self._frames[n] = d
            fresh.append((n, d))
        return fresh

    def missing(self, upto_n: int) -> List[int]:
        """Source frames ``0..upto_n-1`` not yet delivered — the exact
        resubmission list after a loss event."""
        return [n for n in range(upto_n) if n not in self._frames]

    def delivered_count(self) -> int:
        return len(self._frames)

    def assembled(self) -> List[Any]:
        """Deliveries in source order (gaps omitted — run
        :meth:`missing` to zero first for the gap-free guarantee)."""
        return [self._frames[n] for n in sorted(self._frames)]
