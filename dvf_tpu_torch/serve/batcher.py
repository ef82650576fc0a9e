"""Continuous cross-session batcher (port of ``dvf_tpu.serve.batcher``;
host code only).

The single-stream pipeline fills each device batch from ONE queue
(`runtime.pipeline._assemble`); when that stream is slow, the batch pads
and device utilization collapses. This batcher generalizes the assembler
across tenants: every tick it drains ready frames from *all* sessions and
packs them into one fixed-signature device batch — slots tagged
``(session_id, frame_index)``, short batches padded with a repeat of the
last valid row exactly like the single-stream assembler (static shapes →
one compilation; the ``valid`` count drops padded outputs on the way
back).

Scheduling policy (the genuinely new multi-tenant part):

- **EDF across sessions.** Candidate slots are ordered by SLO deadline
  (submit ts + the session's latency budget) and the earliest deadlines
  win the batch. With equal SLOs this degrades to global FIFO by arrival
  — fair by construction; a tighter-SLO stream gets priority exactly
  proportional to how much less slack it has. Deadlines are monotonic
  within a stream, so EDF always picks a per-session *prefix* and
  per-session ordering is preserved end to end.
- **Shed by SLO headroom when oversubscribed.** Losing slots stay queued
  and age; once a frame's deadline passes before it reaches a device
  slot it is shed (counted per session) rather than processed — device
  time is never spent on a result the client's latency budget has
  already written off. Undersubscribed systems never shed: every frame
  makes the next batch.
- **EDF/cost across buckets.** A multi-signature frontend groups
  sessions into signature buckets, each with its own compiled program;
  one tick serves ONE bucket (one program launch). ``select_bucket``
  scores every bucket with pending work by *deadline headroom ÷
  measured per-bucket tick cost* and serves the lowest score: a bucket
  whose earliest deadline is closest relative to how long its program
  takes to run is the one most at risk of shedding. Costs are
  MEASURED, never guessed (TVM's measured-stage discipline): the
  compile-time ``Engine.step_block_ms`` calibration seeds the estimate
  and an EWMA over observed batch wall times keeps it current — a
  starved small bucket's headroom shrinks every tick while the big
  bucket's stays refreshed, so the small bucket always wins before its
  deadline passes (fairness pinned in tests/test_multitenant.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from dvf_tpu_torch.serve.session import Slot, StreamSession


@dataclasses.dataclass
class BatchPlan:
    """One tick's device batch: how many rows are real, the
    (session, frame_index) tag per valid row, and — on the monolithic
    staging path only — the staged host array (the streamed ingest path
    stages straight into per-shard slabs, so ``batch`` is None there and
    the router never needs it)."""

    batch: Optional[np.ndarray]
    valid: int
    slots: List[Slot]
    dead: bool = False  # set by supervisor recovery (or a discard) when
    #   the plan's claims were already released — a late result/second
    #   discard for a dead plan must not double-account the sessions
    bucket: Any = None  # the signature bucket this batch belongs to
    #   (serve.server._Bucket): the collect side fetches through that
    #   bucket's egress fetcher and attributes tick cost / faults to it;
    #   None on the legacy single-signature paths (tests, ad-hoc plans)
    cost_sample: bool = True  # False when other batches were in flight
    #   at submit: the submit→materialize wall then includes queue wait
    #   behind THEIR device time, which would contaminate the bucket's
    #   per-program tick-cost EWMA (the EDF/cost denominator) toward the
    #   shared pipeline latency instead of this program's cost
    lin_marks: Any = None  # lineage-armed frontends: the BATCH-level
    #   (component, wall_ts) marks shared by every slot in this batch —
    #   assemble_h2d at dispatch, device/d2h at collect; the router
    #   extends each slot's FrameLineage with them before demux (one
    #   stamp per batch, not per frame). None = lineage off.
    audit_rows: Any = None  # audit-armed frontends (obs.audit): rows
    #   the shadow-replay sampler picked this tick — [(row, input-copy,
    #   session_id, frame_index, lineage), ...]; the collect side pairs
    #   each with its DELIVERED output and hands the pair to the replay
    #   worker. None = audit off or nothing sampled (zero cost).
    fetcher: Any = None  # the egress fetcher THIS batch was prefetched
    #   into, pinned at dispatch: a hot program swap may replace
    #   ``bucket.fetcher`` (new output signature) while this batch is
    #   still in flight, and the collect side must fetch from the one
    #   the D2H was actually issued on.


class ContinuousBatcher:
    """Drains ready frames across sessions into fixed-signature batches."""

    def __init__(self, batch_size: int, staging_pool: int = 2):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        # Bounded internal staging ring for plan() callers that pass no
        # buffer: a fresh multi-MB np.empty per tick put the allocator on
        # the serving hot path. Cycled like the pipeline's per-slot pool;
        # callers that hold a plan across more than ``staging_pool``
        # ticks must pass their own staging (the frontend does).
        self._staging_pool = max(1, staging_pool)
        self._staging: Optional[List[np.ndarray]] = None
        self._staging_seq = 0

    def select(self, sessions: Sequence[StreamSession],
               now: float, pre_drained: bool = False,
               limit: Optional[int] = None) -> Optional[List[Slot]]:
        """Tier-then-EDF slot selection for one batch; None = nothing
        to do.

        Drains every session's ingress, sheds blown deadlines, picks the
        ``batch_size`` earliest-deadline slots, and claims them in-flight
        — everything plan() does except touching frame bytes, so the
        streamed assembler can stage the chosen frames straight into its
        per-shard slabs. Dispatch-thread only: touches the sessions'
        scheduler-owned ``pending`` staging. ``pre_drained`` skips the
        drain/shed pass (select_bucket already ran it this tick);
        ``limit`` overrides ``batch_size`` for this pick (the control
        plane's per-bucket batch sizing).
        """
        candidates: List[Slot] = []
        for s in sessions:
            if not pre_drained:
                s.drain_ingress()
                s.shed_expired(now)  # counted on the session (stats() sums)
            candidates.extend(s.pending)
        if not candidates:
            return None
        # Priority tier first, then EDF within a tier: with spare slots
        # every queued frame makes the batch regardless of tier, so this
        # only bites when OVERSUBSCRIBED — then lower-priority (higher
        # tier value) frames lose the slot race, age, and shed first;
        # paid/interactive sessions shed last by construction. Stable
        # sort + per-session monotonic deadlines (a hard guarantee —
        # submit clamps each deadline to at least the previous one,
        # whatever client ts says) + per-session constant tier ⇒ the
        # chosen set is a prefix of each session's pending deque, so
        # popleft below removes exactly the chosen slots.
        candidates.sort(
            key=lambda slot: (slot.session.config.tier, slot.deadline))
        chosen = candidates[: (limit if limit is not None
                               else self.batch_size)]
        taken_per_session: dict = {}
        for slot in chosen:
            taken_per_session[slot.session] = (
                taken_per_session.get(slot.session, 0) + 1)
        for s, n in taken_per_session.items():
            for _ in range(n):
                s.pending.popleft()
            s.claim_inflight(n)
        return chosen

    def select_bucket(
        self,
        bucket_sessions: Sequence[Tuple[Any, Sequence[StreamSession]]],
        now: float,
    ) -> Tuple[Any, Optional[List[Slot]]]:
        """EDF/cost-aware bucket pick for one tick; ``(None, None)`` =
        nothing to do anywhere.

        ``bucket_sessions``: ``[(bucket, sessions)]`` where ``bucket``
        exposes ``tick_cost_estimate() -> ms`` (a MEASURED per-batch
        cost — Engine.step_block_ms seed + live EWMA). Every bucket's
        ingress is drained and its blown deadlines shed each tick (a
        losing bucket must still age and shed); then buckets with
        pending work are picked by ``(best pending tier, (earliest
        deadline − now) ÷ tick cost)``: priority tier first — a bucket
        holding a tier-0 frame beats any bucket whose best is tier 1+,
        else the within-bucket tier-EDF guarantee silently dissolves
        the moment sessions span buckets (exactly what the quality
        controller's downshift buckets create: under a re-admission
        flood, cost-weighted EDF alone serves interactive only once its
        frames have burned down to the flood's headroom-per-cost) —
        then lowest score wins within a tier: least headroom per unit
        of program time is the bucket most at risk. The winner's slots
        are then claimed by the ordinary within-bucket EDF
        :meth:`select`.
        """
        best = None
        best_key = None
        best_sessions: Optional[Sequence[StreamSession]] = None
        for bucket, sessions in bucket_sessions:
            earliest = None
            tier = None
            for s in sessions:
                s.drain_ingress()
                s.shed_expired(now)
                if s.pending:
                    d = s.pending[0].deadline
                    earliest = d if earliest is None else min(earliest, d)
                    t = s.config.tier
                    tier = t if tier is None else min(tier, t)
            if earliest is None:
                continue
            cost_ms = max(float(bucket.tick_cost_estimate()), 1e-3)
            key = (tier, (earliest - now) * 1e3 / cost_ms)
            if best_key is None or key < best_key:
                best, best_key, best_sessions = bucket, key, sessions
        if best is None:
            return None, None
        # Per-bucket batch size (control plane autotune): a small bucket
        # runs small batches instead of inheriting the frontend-wide
        # batch_size and padding the difference with repeated rows.
        limit = getattr(best, "batch_size", None)
        return best, self.select(best_sessions, now, pre_drained=True,
                                 limit=limit)

    def _pool_staging(self, frame: np.ndarray) -> np.ndarray:
        shape = (self.batch_size, *frame.shape)
        if self._staging is None or self._staging[0].shape != shape \
                or self._staging[0].dtype != frame.dtype:
            self._staging = [np.empty(shape, dtype=frame.dtype)
                             for _ in range(self._staging_pool)]
        self._staging_seq += 1
        return self._staging[self._staging_seq % len(self._staging)]

    def plan(
        self,
        sessions: Sequence[StreamSession],
        now: float,
        staging: Optional[np.ndarray] = None,
    ) -> Optional[BatchPlan]:
        """Assemble one monolithic batch from everything ready; None =
        nothing to do.

        ``staging``: preallocated (batch_size, H, W, C) buffer to fill
        (the frontend's per-inflight-slot pool); the batcher's own
        bounded ring is used when omitted (tests, ad-hoc callers).
        """
        chosen = self.select(sessions, now)
        if chosen is None:
            return None
        valid = len(chosen)
        if staging is None:
            staging = self._pool_staging(chosen[0].frame)
        for row, slot in enumerate(chosen):
            np.copyto(staging[row], slot.frame)
            slot.frame = None  # drop the client's buffer reference
        for row in range(valid, self.batch_size):
            np.copyto(staging[row], staging[valid - 1])
        return BatchPlan(batch=staging, valid=valid, slots=chosen)
