"""Per-stream sessions for the multi-tenant serving frontend (port of
``dvf_tpu.serve.session``; host code only).

A ``StreamSession`` is one client stream's slice of the shared frontend:
its own frame index space, its own drop-oldest ingress queue (the same
``sched.queues.DropOldestQueue`` the single-stream pipeline uses — the
reference's distributor.py:188-203 backpressure, now per tenant), its own
sink-side reorder cursor, and its own latency SLO budget. Nothing here
touches the device — sessions are pure host bookkeeping that the
continuous batcher (serve.batcher) and result router (serve.router)
operate over.

Frame lifecycle through a session:

  submit → ingress (drop-oldest bound) → pending (scheduler-owned, EDF
  order) → device slot tagged (session_id, frame_index) → reorder buffer
  → out queue / sink

Freshness is enforced twice: at the ingress bound (drop-oldest, exactly
like the single-stream pipeline) and at the SLO deadline (a frame whose
latency budget has expired before it reaches a device slot is shed by the
batcher — processing it would spend device time on a result the client
has already given up on).
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import time
from typing import Any, NamedTuple, Optional

import numpy as np

from dvf_tpu_torch.obs.lineage import FrameLineage
from dvf_tpu_torch.obs.metrics import LatencyStats
from dvf_tpu_torch.resilience.continuity import ReplayRing
from dvf_tpu_torch.sched.queues import DropOldestQueue
from dvf_tpu_torch.sched.reorder import ReorderBuffer

# Session lifecycle: OPEN accepts submits; CLOSING serves what's queued /
# in flight but rejects new frames; CLOSED is fully retired (tail
# delivered, sink closed) and only poll() still works.
OPEN, CLOSING, CLOSED = "open", "closing", "closed"


class ServeError(RuntimeError):
    """Base class for serving-frontend errors."""


class AdmissionError(ServeError):
    """The frontend refused to admit a new session (max_sessions)."""


class SessionClosedError(ServeError):
    """submit() on a session that is closing or closed."""


@dataclasses.dataclass
class SessionConfig:
    queue_size: int = 10          # ingress bound, drop-oldest beyond
    slo_ms: float = 1000.0        # per-frame latency budget (submit → deliver)
    frame_delay: int = 0          # reorder cursor lag; 0 = deliver ASAP
    reorder_capacity: int = 50
    out_queue_size: int = 64      # poll()-side bound, drop-oldest beyond
    tier: int = 1                 # priority tier (control.controllers:
    #   0 interactive, 1 standard, 2 batch — lower sheds LAST): breaks
    #   EDF ties in the batcher's slot pick, orders the quality
    #   controller's downshift victims, and is what the admission floor
    #   refuses by under sustained overload
    replay_window: int = 64       # delivered-tail frames retained for
    #   the continuity plane's resume replay (resilience.continuity):
    #   a reconnecting client replays from its last-seen index and
    #   dedups, upgrading delivery to effectively-exactly-once within
    #   this window. 0 disables the ring (no frame references pinned).


@dataclasses.dataclass
class Slot:
    """One frame's claim on a device batch slot: the (session, index) tag
    that demultiplexes the shared batch back to its stream."""

    session: "StreamSession"
    index: int
    ts: float           # capture/submit timestamp (latency clock)
    deadline: float     # ts + slo; the batcher sheds past-deadline slots
    frame: Optional[np.ndarray]  # cleared once staged into the batch
    tag: Any = None     # opaque client cookie (e.g. the ZMQ bridge's
    #   remote frame index), threaded through to the Delivery
    lin: Any = None     # obs.lineage.FrameLineage when the frontend's
    #   attribution plane is armed: the frame's hop trail, marked at
    #   each queue/stage boundary and closed at delivery — None (zero
    #   cost) otherwise


class Delivery(NamedTuple):
    """One processed frame handed back to the client."""

    index: int
    frame: np.ndarray
    capture_ts: float
    latency_ms: float
    tag: Any
    lineage: Any = None  # FrameLineage (lineage-armed frontends): the
    #   additive latency decomposition behind latency_ms; rides the
    #   ProcessReplica RPC so the fleet front door can re-base and
    #   extend it


class StreamSession:
    """One tenant stream multiplexed onto the shared engine.

    Thread contract: ``submit``/``poll``/``close`` may be called from any
    client thread; ``drain_ingress``/``shed_expired``/``pending`` are
    owned by the frontend's dispatch thread; delivery methods are owned
    by the frontend's collect thread. Cross-thread state (lifecycle,
    counters) is lock-protected.
    """

    def __init__(
        self,
        session_id: str,
        config: Optional[SessionConfig] = None,
        sink: Any = None,
    ):
        self.id = session_id
        self.config = config or SessionConfig()
        self.sink = sink
        self.attribution: Any = None  # obs.lineage.AttributionPlane when
        #   the owning frontend armed frame-lineage attribution (set at
        #   registration): submit then opens a FrameLineage per frame
        #   and deliver_ready closes + folds it. None = lineage off,
        #   zero per-frame cost.
        self.bucket: Any = None  # the signature bucket this session is
        #   bound to (serve.server._Bucket, set at admission): which
        #   compiled program serves it, which geometry its frames must
        #   match, and where its faults/budget overflow attribute
        # -- quality state (the reference's control plane sets it) ------
        self.quality_level = 0   # 0 = full quality; level L frames are
        #   decimated ×2^L per axis at submit and served by a bucket
        #   whose op chain ends in upscale(scale=2^L), so DELIVERIES are
        #   always full resolution (bit-exactness waived while > 0)
        self.base_sig: Any = None    # (frame_shape, np_dtype) of the
        #   full-quality signature, captured at the first downshift so
        #   recovery can route home even if the base bucket retired
        self.base_chain: Any = None  # the full-quality canonical chain
        self.quality_shifts = 0      # lifetime level changes (stats)
        self.ingress = DropOldestQueue(maxsize=self.config.queue_size)
        # Scheduler-owned staging between ingress and the device: the
        # EDF/shed scan needs to see every queued frame, which the
        # drop-oldest queue doesn't expose. Only the dispatch thread
        # touches it.
        self.pending: "collections.deque[Slot]" = collections.deque()
        self.reorder = ReorderBuffer(
            frame_delay=self.config.frame_delay,
            capacity=self.config.reorder_capacity,
        )
        # poll() path when no sink is attached. DropOldestQueue again: a
        # client that stops polling bounds memory and keeps freshness.
        self.out = DropOldestQueue(maxsize=self.config.out_queue_size)
        # Delivered-tail replay ring (resilience.continuity): every
        # delivered frame is ALSO recorded here (by index) so a resumed
        # client can replay the tail it may have missed across a
        # disconnect. References only — the ring pins at most
        # replay_window frames beyond what the out queue already holds.
        self.replay = (ReplayRing(self.config.replay_window)
                       if self.config.replay_window > 0 else None)
        self.latency = LatencyStats()
        self._lock = threading.Lock()
        # Serializes delivery (advance → pop_ready → emit): finalize
        # (dispatch thread) and route (collect thread) may both call
        # deliver_ready on a closing session; unserialized, the later
        # indices could reach the out queue before the earlier ones.
        self._deliver_lock = threading.Lock()
        self.state = OPEN
        self._discard = False   # close(drain=False): shed queued frames
        self.next_index = 0     # this stream's private frame index space
        self.inflight = 0       # slots currently inside a device batch
        self.submitted = 0
        self.delivered = 0
        self.shed = 0           # frames dropped for a blown SLO deadline
        self.slo_miss = 0       # delivered, but past the SLO budget
        self.failed = 0         # frames lost to a failed device batch
        self.faults: dict = {}  # the same losses, classified by FaultKind
        #   (resilience.faults) — per-tenant fault attribution, poll-able
        #   through stats() beside the aggregate counters
        self.sink_errors = 0    # contained per-frame sink failures
        self.tap = None         # broadcast publish hook (set by the
        #   frontend when this session publishes a channel): called per
        #   delivered frame AFTER the session's own sink/out delivery —
        #   the publisher's interactive path is never behind fan-out,
        #   and the tap itself only does one frame copy + one bounded
        #   enqueue (broadcast.channel.Channel.offer)
        self.tap_errors = 0     # contained tap failures (same policy
        #   as sink_errors: drop the fan-out frame, keep serving)
        self._last_deadline = float("-inf")

    # -- client side (any thread) --------------------------------------

    def submit(self, frame: np.ndarray, ts: Optional[float] = None,
               tag: Any = None) -> int:
        """Enqueue one frame; returns its index in this stream's space.

        Never blocks: a full ingress queue evicts the oldest frame
        (drop-oldest, distributor.py:193-203 semantics). The frame array
        is referenced, not copied, until the batcher stages it — callers
        that reuse their capture buffer must pass a copy.
        """
        ts = time.time() if ts is None else ts
        lin = None
        if self.attribution is not None:
            # The lineage clock starts at the CLIENT's capture ts, so
            # the decomposition telescopes to exactly the latency_ms the
            # delivery reports (capture→deliver).
            lin = FrameLineage(self.id, -1, ts)
        # ONE atomic section for state check, index, deadline clamp, AND
        # the enqueue: concurrent submits that clamped in one order but
        # enqueued in the other would put a later deadline ahead of an
        # earlier one, breaking the EDF prefix invariant the batcher's
        # popleft relies on; and a put outside the state check could land
        # in the ingress of a session close() just finalized, stranding
        # the frame forever.
        with self._lock:
            if self.state != OPEN:
                raise SessionClosedError(
                    f"session {self.id!r} is {self.state}")
            idx = self.next_index
            self.next_index += 1
            self.submitted += 1
            # Deadlines must be monotonic within a stream — clients pass
            # arbitrary capture timestamps (jitter, clock steps), so
            # clamp rather than trust.
            deadline = max(self._last_deadline, ts + self.config.slo_ms / 1e3)
            self._last_deadline = deadline
            if lin is not None:
                lin.frame_index = idx
            self.ingress.put(Slot(
                session=self, index=idx, ts=ts,
                deadline=deadline, frame=frame, tag=tag, lin=lin))
        return idx

    def poll(self, max_items: Optional[int] = None) -> list:
        """Pop up to ``max_items`` completed ``Delivery`` records (all
        ready ones when None). Empty list = nothing ready. Valid on
        closed sessions until the tail is drained."""
        if self.sink is not None:
            raise ServeError(
                f"session {self.id!r} delivers through its sink; poll() "
                f"only applies to sink-less sessions")
        n = max_items if max_items is not None else len(self.out)
        return self.out.pop_up_to(n)

    # -- scheduler side (dispatch thread only) -------------------------

    def drain_ingress(self) -> None:
        """Move every queued frame from the ingress bound into the
        scheduler's pending staging (or shed everything queued, if the
        session was closed with ``drain=False``)."""
        if self._discard:
            n = len(self.pending) + len(
                self.ingress.pop_up_to(len(self.ingress)))
            self.pending.clear()
            if n:
                with self._lock:
                    self.shed += n
            return
        got = self.ingress.pop_up_to(len(self.ingress))
        if got and self.attribution is not None:
            # One stamp per drain, shared across the drained slots: the
            # end of each frame's session-ingress-queue component.
            now = time.time()
            for slot in got:
                if slot.lin is not None:
                    slot.lin.mark("queue_ingress", now)
        self.pending.extend(got)

    def flush_queued(self, count_shed: bool = True) -> int:
        """Drop everything queued (pending + ingress) — the
        quality-rebind flush: frames queued at the OLD geometry cannot
        be staged into the new bucket's program. Dispatch-thread only
        (owns ``pending``). ``count_shed=False`` keeps the loss out of
        ``shed`` — the control plane's pressure predicate watches
        ``shed_total``, and a flush caused by the controller's OWN
        quality move must not read back as fresh overload evidence (the
        frontend counts these separately)."""
        n = len(self.pending) + len(
            self.ingress.pop_up_to(len(self.ingress)))
        self.pending.clear()
        if n and count_shed:
            with self._lock:
                self.shed += n
        return n

    def shed_expired(self, now: float) -> int:
        """Drop pending frames whose SLO deadline has passed. Deadlines
        are monotonic within a stream (fixed slo, monotonic submit ts),
        so expired frames are always a prefix."""
        n = 0
        while self.pending and self.pending[0].deadline < now:
            self.pending.popleft()
            n += 1
        if n:
            with self._lock:
                self.shed += n
        return n

    # -- delivery side (collect thread only) ---------------------------

    def claim_inflight(self, n: int) -> None:
        """The batcher moved n of this stream's frames into a device
        batch (dispatch thread)."""
        with self._lock:
            self.inflight += n

    def complete(self, slot: Slot, frame: np.ndarray) -> None:
        """One processed frame arrived from the device.

        The reorder insert and the in-flight decrement are one atomic
        step w.r.t. ``drained()``: decrementing first and inserting
        after the lock would let the dispatch thread observe
        inflight == 0, finalize, and flush the reorder buffer *between*
        the two — permanently losing the final frame of a gracefully
        closing session.
        """
        with self._lock:
            self.inflight -= 1
            if self.state != CLOSED:  # late result after hard close: dropped
                self.reorder.complete(
                    slot.index, (frame, slot.ts, slot.tag, slot.lin))

    def discard_inflight(self, n: int = 1, kind: str = None) -> None:
        """A device batch failed; its slots never produced results.
        Counted (``failed``, and per fault ``kind`` when one is given —
        shutdown discards pass None) so the per-session accounting
        identity submitted == delivered + shed + failed +
        dropped_at_ingress still reconciles after contained errors."""
        with self._lock:
            self.inflight -= n
            self.failed += n
            if kind is not None:
                self.faults[kind] = self.faults.get(kind, 0) + n

    def deliver_ready(self) -> int:
        """Advance the reorder cursor and emit everything ready; returns
        the number of frames delivered. Serialized by _deliver_lock so
        concurrent callers (collect thread vs finalize) cannot interleave
        out of index order."""
        n = 0
        closed = None
        with self._deliver_lock:
            self.reorder.advance()
            for idx, (frame, ts, tag, lin) in self.reorder.pop_ready():
                now = time.time()
                lat_s = now - ts
                self.latency.record(lat_s)
                with self._lock:
                    self.delivered += 1
                    if lat_s * 1e3 > self.config.slo_ms:
                        self.slo_miss += 1
                if lin is not None and self.attribution is not None:
                    # Close the lineage on the SAME clock read latency
                    # is computed from, so the additive decomposition
                    # sums to latency_ms exactly (the invariant the
                    # golden tests pin); the fold happens once per
                    # delivery round below, not per frame.
                    lin.mark("deliver", now)
                    if closed is None:
                        closed = []
                    closed.append((lin, lat_s * 1e3))
                d = Delivery(idx, frame, ts, lat_s * 1e3, tag, lin)
                if self.replay is not None:
                    # Record BEFORE the sink/out handoff: a frame the
                    # client's side of the wire lost is still resumable.
                    self.replay.push(idx, d)
                if self.sink is not None:
                    try:
                        self.sink.emit(idx, frame, ts)
                    except Exception as e:  # noqa: BLE001 — one tenant's
                        # sink hiccup must never kill the shared frontend
                        # (Pipeline._contain's 'sink' semantics, per
                        # session): drop the frame, count, keep serving.
                        with self._lock:
                            self.sink_errors += 1
                        print(f"[serve:sink:{self.id}] error (continuing): "
                              f"{e!r}", file=sys.stderr, flush=True)
                else:
                    self.out.put(d)
                if self.tap is not None:
                    try:
                        self.tap(idx, frame, ts)
                    except Exception as e:  # noqa: BLE001 — broadcast
                        # fan-out trouble must never kill the
                        # publisher's own delivery (sink containment
                        # policy, applied to the tap)
                        with self._lock:
                            self.tap_errors += 1
                        print(f"[serve:tap:{self.id}] error (continuing): "
                              f"{e!r}", file=sys.stderr, flush=True)
                n += 1
            if closed is not None:
                bucket = self.bucket
                self.attribution.observe_batch(
                    closed, self.config.slo_ms,
                    bucket.label() if bucket is not None else None)
        return n

    # -- lifecycle ------------------------------------------------------

    def close(self, drain: bool = True) -> None:
        """Stop accepting frames. ``drain=True`` lets queued and
        in-flight frames flow through (the frontend finalizes the session
        once they have); ``drain=False`` discards the queue too."""
        with self._lock:
            if self.state != OPEN:
                return
            self.state = CLOSING
            # pending/ingress are dispatch-thread-owned; flag them for
            # shedding there (drain_ingress) rather than racing the
            # batcher from a client thread.
            self._discard = not drain

    def drained(self) -> bool:
        """True when nothing of this stream remains queued or in flight
        (the frontend's finalize condition for a closing session)."""
        with self._lock:
            return (self.state == CLOSING and self.inflight == 0
                    and not self.pending and len(self.ingress) == 0)

    def finalize(self) -> None:
        """Deliver the reorder tail, close the sink, mark CLOSED.
        Called by the frontend once ``drained()`` (or at shutdown, where
        frames may still be queued — they are counted as shed here so
        the accounting identity survives an early stop())."""
        with self._lock:
            if self.state == CLOSED:
                return
            leftover = len(self.pending) + len(
                self.ingress.pop_up_to(len(self.ingress)))
            self.pending.clear()
            self.shed += leftover  # no-op on the drained() path
        self.reorder.flush()
        self.deliver_ready()
        with self._lock:
            self.state = CLOSED
        if self.sink is not None and hasattr(self.sink, "close"):
            self.sink.close()

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "submitted": self.submitted,
                "delivered": self.delivered,
                "shed": self.shed,
                "slo_miss": self.slo_miss,
                "failed": self.failed,
                "faults": dict(self.faults),
                "sink_errors": self.sink_errors,
                "tap_errors": self.tap_errors,
                "dropped_at_ingress": self.ingress.dropped,
                "dropped_unpolled": self.out.dropped,  # delivered but
                #   evicted from the poll queue before the client read it
                "inflight": self.inflight,
                "slo_ms": self.config.slo_ms,
                "tier": self.config.tier,
                "quality_level": self.quality_level,
                "quality_shifts": self.quality_shifts,
                **self.latency.summary(),
            }

    def __repr__(self) -> str:  # debugging aid
        return (f"StreamSession({self.id!r}, {self.state}, "
                f"submitted={self.submitted}, delivered={self.delivered})")
