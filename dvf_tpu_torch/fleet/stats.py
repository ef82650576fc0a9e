"""Fleet-level stats: merge per-replica exports into one view (port of
``dvf_tpu.fleet.stats``).

Every replica already computes its own half — ``ServeFrontend.stats()``
(per-session rows + per-replica aggregate), ``latency_snapshot()``
(mergeable weighted samples), ``faults.summary()`` (per-kind counters,
replica-attributed via ``ServeConfig.replica_label``). This module does
the other half: the front door pulls those exports (in-process reads or
one ``stats`` RPC per process replica) and folds them into fleet-wide
latency percentiles (``LatencyStats.merge_snapshots`` — weighted raw
samples, never averaged percentiles) and a fleet fault table with
``by_replica`` attribution.
"""

from __future__ import annotations

from typing import Dict, Optional

from dvf_tpu_torch.obs.metrics import LatencyStats
from dvf_tpu_torch.resilience.faults import FaultStats


def merge_fault_summaries(
    fleet_own: dict,
    per_replica: Dict[str, Optional[dict]],
) -> dict:
    """The fleet fault table: the router's own faults (``replica``
    losses it observed, attributed to the replica that died) plus every
    reachable replica's summary. Unreachable replicas contribute nothing
    — their loss is already counted on the fleet side."""
    merged = FaultStats()
    merged.absorb_summary(fleet_own)
    for rid, summary in per_replica.items():
        if summary:
            merged.absorb_summary(summary, replica=rid)
    return merged.summary()


def merge_latency_snapshots(per_replica: Dict[str, Optional[dict]]) -> dict:
    """Fleet p50/p99/fps over replicas' weighted sample snapshots."""
    return LatencyStats.merge_snapshots(
        [s for s in per_replica.values() if s])


def replica_row(handle, export: Optional[dict], sessions: int) -> dict:
    """One replica's row in the fleet stats table: lifecycle + the
    headline numbers from its export (None when unreachable)."""
    row = {
        "state": handle.state,
        "restarts": handle.restarts,
        "sessions": sessions,
    }
    if export is not None:
        st = export.get("stats", {})
        row.update(
            engine_batches=st.get("engine_batches"),
            engine_frames=st.get("engine_frames"),
            open_sessions=st.get("open_sessions"),
            queue_depth=st.get("queue_depth"),
            # The replica's MONOTONE lifetime counter (signals() carries
            # the evicted-session floor) — the scrape's counter source;
            # the windowed aggregate.count beside it is NOT monotone.
            delivered_total=(export.get("signals") or {}).get(
                "delivered_total"),
            errors=st.get("errors"),
            recoveries=st.get("recoveries"),
            faults=st.get("faults", {}).get("by_kind", {}),
            aggregate=st.get("aggregate"),
        )
        attr = st.get("attribution")
        if attr is not None:
            # Lineage-armed replicas: the per-replica latency
            # attribution rides the same stats RPC — the fleet-wide
            # half of "where did my p99 go" (explain() fans this out).
            row["attribution"] = attr
    return row
