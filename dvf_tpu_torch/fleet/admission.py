"""Fleet admission: signature-aware least-loaded placement + spillover
(port of ``dvf_tpu.fleet.admission``).

The profiling-driven adaptive distributed-inference pattern (PAPERS.md,
arXiv:2605.25682) at the serving layer: new sessions open on the
least-loaded healthy replica; when that replica's own admission gate is
full (``serve``-level ``max_sessions``/``max_buckets``), the open
*spills over* to the next candidate instead of failing; only when EVERY
healthy replica has refused does the fleet reject. Load is the router's
count of sessions it has bound to each replica — a placement heuristic
only; the replica's own gate stays the source of truth, so a stale
count can cost one extra spillover hop, never a wrong admission.

Placement is SIGNATURE-AWARE: a declared ``(op_chain, geometry, dtype)``
open prefers a replica whose program pool is already warm for that
canonical key (its admission is a pool hit — milliseconds, vs a full
trace+compile on a cold one). Warmth is a BOUNDED bias, not an
absolute rank: a warm replica tolerates one session of extra load
(and wins ties) before losing to a colder, emptier candidate —
unbounded warm-first would funnel every session of a uniform-signature
fleet onto one replica and defeat the scaling the fleet exists for,
while zero bias would never route a follow-up open to the replica
that just paid the compile. Cold admits and undeclared opens place
least-loaded-first exactly as before.

Affinity is the other half of placement and is deliberately NOT here:
once a session is bound, every one of its frames goes to that replica
(per-session index monotonicity needs one reorder buffer), so placement
decisions happen only at open and at migration — both route through
:meth:`SpilloverAdmission.candidates`.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence


class SpilloverAdmission:
    """Candidate ordering + admission counters for the fleet router."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spillovers = 0   # opens that fell past their first choice
        self.rejections = 0   # opens refused by every healthy replica
        self.warm_placements = 0  # opens routed by signature warmth
        self.tier_rejections = 0  # low-tier opens refused by the fleet
        #   capacity guard (graceful shed, not a failure)
        self.rejections_by_tier: Dict[int, int] = {}  # every fleet-level
        #   refusal keyed by the refused open's tier — the elasticity
        #   controller's key input was previously visible only in
        #   rejection STRINGS; these counters put it on the telemetry
        #   ring (fleet signals() flattens them per tier name)

    def candidates(
        self,
        replicas: Sequence,                  # ReplicaHandle, .state/.id
        load: Dict[str, int],                # router's sessions-per-replica
        exclude: Optional[Iterable[str]] = None,
        warm: Optional[Dict[str, Iterable[str]]] = None,
        key: Optional[str] = None,
        prefer_packed: bool = False,
    ) -> List:
        """Healthy replicas ranked by warm-biased load (see module
        docstring): effective load = load − 1 for a replica warm for
        ``key``, warmth breaks ties, id makes equal ranks
        deterministic. ``warm`` maps replica id → canonical signature
        renders its pool serves without a compile (from each replica's
        ``health()`` export); ``key`` is the open's canonical signature
        render (None = undeclared → pure least-loaded). ``exclude``
        drops specific ids — migration must not re-place a session on
        the replica it is fleeing.

        ``prefer_packed`` inverts the load rank (bin-packing): batch-
        tier sessions fill the FULLEST replica that still admits them,
        keeping the emptiest replicas' headroom for interactive opens —
        the placement half of "paid sessions shed last". Warmth is an
        attraction in BOTH modes: spillover subtracts the bias from the
        load (a warm replica looks emptier), packing adds it (a warm
        replica looks fuller) — negating the spillover rank wholesale
        would turn the warm bonus into a cold preference."""
        from dvf_tpu_torch.fleet.replica import HEALTHY

        banned = set(exclude or ())
        ok = [r for r in replicas
              if r.state == HEALTHY and r.id not in banned]

        def rank(r):
            cold = 1
            if key is not None and warm:
                cold = 0 if key in set(warm.get(r.id) or ()) else 1
            bias = 1 - cold   # bounded +1 attraction for a warm pool
            if prefer_packed:
                return (-(load.get(r.id, 0) + bias), cold, r.id)
            return (load.get(r.id, 0) - bias, cold, r.id)

        return sorted(ok, key=rank)

    def record_tier_rejection(self) -> None:
        with self._lock:
            self.tier_rejections += 1

    def record_warm_placement(self) -> None:
        with self._lock:
            self.warm_placements += 1

    def record_spillover(self, n: int = 1) -> None:
        with self._lock:
            self.spillovers += n

    def record_rejection(self, tier: Optional[int] = None) -> None:
        with self._lock:
            self.rejections += 1
            if tier is not None:
                t = int(tier)
                self.rejections_by_tier[t] = (
                    self.rejections_by_tier.get(t, 0) + 1)

    def stats(self) -> dict:
        with self._lock:
            return {"spillovers": self.spillovers,
                    "rejections": self.rejections,
                    "warm_placements": self.warm_placements,
                    "tier_rejections": self.tier_rejections,
                    "rejections_by_tier": dict(self.rejections_by_tier)}
