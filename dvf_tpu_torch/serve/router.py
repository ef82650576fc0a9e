"""Result router: demultiplex shared-engine batches back to sessions
(port of ``dvf_tpu.serve.router``; host code only).

The collect side of the serving frontend. A completed device batch
carries frames from several tenants interleaved in slot order; the
router walks the plan's ``(session, frame_index)`` tags, feeds each valid
row to its session's reorder buffer, advances that session's display
cursor, and emits whatever became ready to the session's out queue or
sink. The padded tail rows (``row >= valid``) are dropped exactly like
the single-stream collect path.

Observability stays session-local here: every delivered frame is
recorded in its session's ``LatencyStats``; the frontend-wide p50/p99
export merges those per-stream samples on demand
(``LatencyStats.merged``), so nothing is recorded twice.
"""

from __future__ import annotations

import threading

import numpy as np

from dvf_tpu_torch.serve.batcher import BatchPlan


class ResultRouter:
    """Collect-thread component: batches in, per-session deliveries out."""

    def __init__(self):
        self.batches = 0
        self.frames = 0
        self.late_after_close = 0  # results for hard-closed sessions
        self.late_after_recovery = 0  # results for plans the supervisor
        #   already wrote off (their sessions' claims were released at
        #   recovery; routing them now would double-account)
        self._dead_lock = threading.Lock()  # makes the plan.dead
        #   check-then-set atomic: recovery (supervisor thread) and a
        #   waking superseded collect thread may discard the same plan
        #   concurrently, and a double discard_inflight would drive
        #   session.inflight negative

    def route(self, plan: BatchPlan, out: np.ndarray) -> int:
        """Demux one completed batch; returns frames delivered.

        Rows are copied out of the batch array: a view would keep the
        whole (batch_size, H, W, C) result alive for as long as ONE
        delivery sits unpolled — a slow-polling client could pin
        out_queue_size full batches (batch_size× amplification) instead
        of out_queue_size frames.
        """
        with self._dead_lock:
            if plan.dead:
                self.late_after_recovery += 1
                return 0
            plan.dead = True  # consumed — a recovery discard racing this
            #   route (the plan was still in the supervisor window) must
            #   become a no-op, not a second release of the same claims
        touched = []
        marks = plan.lin_marks
        for row, slot in enumerate(plan.slots[: plan.valid]):
            s = slot.session
            if slot.lin is not None and marks:
                # Batch-level hop stamps (assemble_h2d / device / d2h)
                # fan out to every slot's lineage here — the one place
                # each routed row already passes.
                slot.lin.marks.extend(marks)
            s.complete(slot, out[row].copy())
            if s.state == "closed":
                self.late_after_close += 1
            elif s not in touched:
                touched.append(s)
        delivered = 0
        for s in touched:
            delivered += s.deliver_ready()
        self.batches += 1
        self.frames += plan.valid
        if plan.bucket is not None:
            # Lifetime per-bucket row counter, maintained HERE (the one
            # place every routed row passes) so the bucket's export
            # stays monotone across session retirement — a per-session
            # sum would shrink when a tenant retires, which a counter
            # consumer reads as a reset.
            plan.bucket.routed_frames += plan.valid
        return delivered

    def discard(self, plan: BatchPlan, kind: str = None) -> None:
        """A device batch failed; release its sessions' in-flight claims
        so a closing session can still finalize. ``kind`` (a FaultKind)
        attributes the loss in each session's per-kind fault counters;
        None for non-fault discards (shutdown). Idempotent: a plan
        already written off (supervisor recovery) is skipped."""
        with self._dead_lock:
            if plan.dead:
                return
            plan.dead = True
        per_session = {}
        for slot in plan.slots[: plan.valid]:
            per_session[slot.session] = per_session.get(slot.session, 0) + 1
        for s, n in per_session.items():
            s.discard_inflight(n, kind=kind)

    def stats(self) -> dict:
        return {
            "batches": self.batches,
            "frames": self.frames,
            "late_after_close": self.late_after_close,
            "late_after_recovery": self.late_after_recovery,
        }
