"""Auto-plan plane — measured-profile plan search
(port of ``dvf_tpu.control.planner``).

Every performance knob the runtime exposes — batch ladder, dispatch tick,
ingest/egress mode and depth, wire mode, codec thread split — was
hand-set until this module. The planner closes the loop the way a
measured-stage search does: for a given (op chain, geometry, device
topology) it

1. builds the full candidate grid (`candidate_grid`),
2. scores every candidate ANALYTICALLY from the compile-time
   calibration triple (``h2d_block_ms`` / ``d2h_block_ms`` /
   ``step_block_ms``) and any persisted stage-cost profile
   (`analytic_frame_ms`) — cheap arithmetic, no device time,
3. live-profiles only the analytic shortlist (≤ 1/3 of the grid, the
   acceptance bound) through the REAL frontend — each leg a short paced
   burst, ranked by `ab_comparison` (`control._ab`, the port's copy of the
   repo-root `benchtools.ab_comparison`), the same leg machinery
   the reference's bench table's A/B phase runs on (one paced-measurement path, not
   a third copy),
4. returns the winning :class:`Plan`, which the caller persists in the
   on-disk plan cache (`dvf_tpu_torch.control.plan_cache`) so repeat startups
   skip the search entirely.

The chosen plan is not just applied once: `Plan.envelope()` hands the
load controllers their operating envelope — the batch ladder bounded
at the planned batch, the planned tick as the busy tick, the predicted
per-tick budget — so the reactive loops adapt WITHIN a measured plan
instead of around hard-coded defaults. `predicted_tick_cost_ms` is the
feed-forward half for admission: price an incoming tenant from its
signature's stage-cost profile before it runs, not after it hurts.

Determinism discipline: the planner itself is a pure function of its
inputs (grid, calibrations, profile, measurement results). All wall
clock lives in the caller's measurement runner and the ledger stamps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

from dvf_tpu_torch.control._ab import ab_comparison
from dvf_tpu_torch.control.plan_cache import (
    PLANNER_VERSION,
    load_plan,
    save_plan,
    topology_fingerprint,
)

__all__ = [
    "PLANNER_VERSION",
    "Plan",
    "DEFAULT_PLAN",
    "candidate_grid",
    "analytic_frame_ms",
    "shortlist",
    "plan_search",
    "predicted_tick_cost_ms",
    "topology_fingerprint",
]

# Plan provenance: where did this plan's numbers come from?
PLAN_SOURCE_DEFAULT = "default"    # hand-set ServeConfig defaults
PLAN_SOURCE_ANALYTIC = "analytic"  # scored from calibrations, never run
PLAN_SOURCE_MEASURED = "measured"  # won a live paced-burst comparison
PLAN_SOURCE_CACHE = "cache"        # loaded from the on-disk plan cache

# Fraction of a small batch's device step that is fixed dispatch/launch
# overhead rather than per-frame compute — what makes a bigger batch
# worth anything in the analytic model. Deliberately coarse: the model
# only has to RANK candidates well enough that the live shortlist
# contains the true winner; the measurement decides.
_DISPATCH_FRAC = 0.35

# Streamed ingest overlaps H2D with compute up to this many slots deep;
# deeper queues only add latency, not throughput (mirrors the runtime's
# double-buffered staging).
_OVERLAP_CAP = 4.0


@dataclasses.dataclass(frozen=True)
class Plan:
    """One operating point for a serve frontend — every knob the search
    ranges over, plus provenance. Frozen: a plan is a value; applying
    it never mutates it."""

    batch_size: int = 8
    tick_s: float = 0.002
    ingest_depth: int = 4
    ingest: str = "streamed"
    egress: str = "streamed"
    wire: str = "raw"
    codec_threads: int = 4
    # Provenance (not part of the operating point):
    source: str = PLAN_SOURCE_DEFAULT
    predicted_frame_ms: Optional[float] = None
    measured_fps: Optional[float] = None
    searched: int = 0   # candidates live-profiled to pick this plan
    grid: int = 0       # full candidate-grid size they were drawn from

    def label(self) -> str:
        """Stable leg label for the A/B comparison and the ledger."""
        return (f"b{self.batch_size}"
                f"-t{self.tick_s * 1e3:g}ms"
                f"-d{self.ingest_depth}"
                f"-{self.ingest[:4]}/{self.egress[:4]}"
                f"-{self.wire}c{self.codec_threads}")

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: Any) -> Optional["Plan"]:
        """A Plan from a cache/ledger dict, or None when the dict is not
        a plausible plan (corrupt cache entries degrade to a re-plan,
        never to a crash or a nonsense operating point)."""
        if not isinstance(doc, dict):
            return None
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in doc.items() if k in fields}
        try:
            plan = cls(**kw)
        except (TypeError, ValueError):
            return None
        if (not isinstance(plan.batch_size, int) or plan.batch_size < 1
                or not isinstance(plan.tick_s, (int, float))
                or not plan.tick_s > 0
                or not isinstance(plan.ingest_depth, int)
                or plan.ingest_depth < 1
                or plan.ingest not in ("streamed", "monolithic")
                or plan.egress not in ("streamed", "monolithic")
                or plan.wire not in ("raw", "jpeg", "delta")
                or not isinstance(plan.codec_threads, int)
                or plan.codec_threads < 1):
            return None
        return plan

    def envelope(self) -> dict:
        """The operating envelope handed to the reactive controllers:
        the batch/tick loop adapts WITHIN these bounds (ladder
        capped at the planned batch, planned tick as the busy tick)
        instead of around hard-coded defaults. ``tick_budget_ms`` is
        the planner's predicted per-frame cost — advisory, for pricing
        and ledger context."""
        ladder = tuple(b for b in (1, 2, 4, 8, 16, 32, 64)
                       if b <= self.batch_size)
        if self.batch_size not in ladder:
            ladder = tuple(sorted(set(ladder) | {self.batch_size}))
        return {
            "batch_ladder": ladder,
            "batch_max": self.batch_size,
            "tick_busy_s": float(self.tick_s),
            "tick_budget_ms": self.predicted_frame_ms,
        }


DEFAULT_PLAN = Plan()


def candidate_grid(batch_cap: int = 32,
                   ticks: Sequence[float] = (0.001, 0.002, 0.005),
                   depths: Sequence[int] = (2, 4, 8),
                   modes: Sequence[Tuple[str, str]] = (
                       ("streamed", "streamed"),),
                   wires: Sequence[str] = ("raw",),
                   codec_threads: Sequence[int] = (4,)) -> List[Plan]:
    """The full candidate grid: batch ladder (doubling to ``batch_cap``)
    × tick interval × ingest depth × ingest/egress mode × wire mode ×
    codec thread split. The defaults collapse the wire/codec dimensions
    to the serve defaults — an in-process serve plan search gets no
    signal from them; a wire-bridge deployment passes its own axes."""
    batches = []
    b = 1
    while b <= max(1, int(batch_cap)):
        batches.append(b)
        b *= 2
    out = []
    for bs in batches:
        for tick in ticks:
            for depth in depths:
                for ingest, egress in modes:
                    for wire in wires:
                        for ct in codec_threads:
                            out.append(Plan(
                                batch_size=bs, tick_s=float(tick),
                                ingest_depth=int(depth), ingest=ingest,
                                egress=egress, wire=wire,
                                codec_threads=int(ct),
                                source=PLAN_SOURCE_ANALYTIC))
    return out


def analytic_frame_ms(plan: Plan, cal: Optional[dict],
                      cal_batch: int = 8,
                      stage_profile: Optional[dict] = None) -> float:
    """Predicted steady-state wall ms PER FRAME for one candidate, from
    the compile-time calibration triple (measured at ``cal_batch``) and
    optionally a persisted stage-cost profile.

    Model: a tick fires every ``max(tick interval, device work)`` and
    serves one batch. Device work = step (a fixed dispatch floor plus a
    batch-linear part) + transfers, with streamed ingest overlapping H2D
    behind compute up to the staging depth and streamed egress
    overlapping half the D2H. Coarse on purpose — it only has to RANK
    candidates so the live shortlist contains the true winner."""
    cal = cal or {}
    cal_batch = max(1, int(cal_batch))
    scale = plan.batch_size / float(cal_batch)

    step = cal.get("step_block_ms")
    if not isinstance(step, (int, float)) or not step > 0:
        # No calibration at all: fall back to the stage profile's
        # device component, else a 1 ms placeholder (ranking then
        # reduces to the tick/depth structure, which is still honest).
        step = _profile_mean_ms(stage_profile, "device",
                                default=1.0) * cal_batch
    step_ms = float(step) * (_DISPATCH_FRAC + (1.0 - _DISPATCH_FRAC) * scale)

    h2d = cal.get("h2d_block_ms")
    h2d = float(h2d) * scale if isinstance(h2d, (int, float)) else 0.0
    d2h = cal.get("d2h_block_ms")
    d2h = float(d2h) * scale if isinstance(d2h, (int, float)) else h2d
    if plan.ingest == "streamed":
        h2d /= max(1.0, min(float(plan.ingest_depth), _OVERLAP_CAP))
    if plan.egress == "streamed":
        d2h /= 2.0

    # Host-side codec cost rides on the egress path only when the wire
    # re-encodes; the thread split divides it.
    encode = 0.0
    if plan.wire in ("jpeg", "delta"):
        encode = (_profile_mean_ms(stage_profile, "encode", default=0.5)
                  * plan.batch_size / max(1, plan.codec_threads))

    work_ms = step_ms + h2d + d2h + encode
    tick_ms = plan.tick_s * 1e3
    return max(tick_ms, work_ms) / plan.batch_size


def _profile_mean_ms(stage_profile: Optional[dict], component: str,
                     default: float = 0.0) -> float:
    if isinstance(stage_profile, dict):
        row = (stage_profile.get("components_ms") or {}).get(component)
        if isinstance(row, dict) and isinstance(row.get("mean_ms"),
                                                (int, float)):
            return float(row["mean_ms"])
    return default


def shortlist(grid: Sequence[Plan], cal: Optional[dict],
              cal_batch: int = 8, stage_profile: Optional[dict] = None,
              live_budget: Optional[int] = None) -> List[Plan]:
    """The analytic prune: score the whole grid, keep the best ≤ 1/3
    for live profiling (the acceptance bound — a planner that profiles
    more than a third of the grid is not pruning). Candidates carry
    their predicted cost so the measured winner keeps both numbers.
    Deterministic: stable sort, ties broken by the plan's field order
    (smaller batch first — cheaper to be wrong about)."""
    grid = list(grid)
    limit = max(1, len(grid) // 3)
    budget = min(int(live_budget), limit) if live_budget else limit
    budget = max(1, budget)
    scored = [
        dataclasses.replace(
            p, predicted_frame_ms=round(
                analytic_frame_ms(p, cal, cal_batch, stage_profile), 4),
            source=PLAN_SOURCE_ANALYTIC)
        for p in grid
    ]
    scored.sort(key=lambda p: (
        p.predicted_frame_ms, p.batch_size, p.tick_s, p.ingest_depth))
    return scored[:budget]


def plan_search(grid: Sequence[Plan],
                measure: Optional[Callable[[Plan], dict]] = None,
                *,
                cal: Optional[dict] = None,
                cal_batch: int = 8,
                stage_profile: Optional[dict] = None,
                live_budget: Optional[int] = None,
                log: Optional[Callable[[str], None]] = None
                ) -> Tuple[Plan, dict]:
    """The search: analytic prune to the shortlist, then live-profile
    each shortlisted candidate with ``measure(plan) ->
    {"fps": ...} | {"error": ...}`` (a short paced burst through the
    real frontend), ranked by `ab_comparison` (`control._ab`), the
    reference bench table's A/B leg machinery. Returns ``(winning Plan, comparison
    dict)`` — the comparison is what the caller ledgers (per-leg fps,
    winner, search cost).

    With no ``measure`` (or when every leg errors) the analytic best
    wins with ``source="analytic"`` — degraded but deterministic; the
    caller should NOT cache an analytic plan as if it were measured."""
    short = shortlist(grid, cal, cal_batch, stage_profile, live_budget)
    if measure is None:
        best = dataclasses.replace(short[0], searched=0, grid=len(grid))
        return best, {"winner": best.label(), "legs": 0,
                      "grid": len(grid), "analytic_only": True}

    by_label = {p.label(): p for p in short}
    comp, _completed = ab_comparison(
        [(p.label(), p) for p in short],
        lambda _label, p: measure(p),
        log=log,
    )
    winner = comp.get("winner")
    if winner in by_label:
        leg = comp[winner]
        best = dataclasses.replace(
            by_label[winner],
            source=PLAN_SOURCE_MEASURED,
            measured_fps=float(leg["fps"]) if isinstance(
                leg.get("fps"), (int, float)) else None,
            searched=len(short), grid=len(grid))
    else:
        # Every live leg errored: the analytic front-runner, honestly
        # labeled, beats crashing the serve over an optimization.
        best = dataclasses.replace(
            short[0], source=PLAN_SOURCE_ANALYTIC,
            searched=len(short), grid=len(grid))
    comp["legs"] = len(short)
    comp["grid"] = len(grid)
    return best, comp


def predicted_tick_cost_ms(stage_profile: Optional[dict],
                           batch_size: int = 1) -> Optional[float]:
    """The feed-forward admission price: predicted per-tick device cost
    for a signature from its persisted stage-cost profile, BEFORE the
    tenant has run a single frame. Prefers the profile's measured
    ``tick_cost_ms`` EWMA; falls back to the per-frame device-path
    component means × batch. None when the profile has nothing usable —
    the caller admits reactively, exactly as before this plane."""
    if not isinstance(stage_profile, dict):
        return None
    t = stage_profile.get("tick_cost_ms")
    if isinstance(t, (int, float)) and t > 0:
        return float(t)
    per_frame = sum(
        _profile_mean_ms(stage_profile, c)
        for c in ("assemble_h2d", "device", "d2h"))
    if per_frame > 0:
        return per_frame * max(1, int(batch_size))
    return None


def plan_from_cache(cache_dir: Optional[str], signature: str, geometry,
                    topology: str) -> Optional[Plan]:
    """A cached plan for this exact key as a Plan (source re-stamped
    ``"cache"``), or None on any miss — the thin typed wrapper over
    `plan_cache.load_plan` that serve and fleet share."""
    doc = load_plan(cache_dir, signature, geometry, topology)
    plan = Plan.from_doc(doc)
    if plan is None:
        return None
    return dataclasses.replace(plan, source=PLAN_SOURCE_CACHE)


def plan_to_cache(cache_dir: Optional[str], signature: str, geometry,
                  topology: str, plan: Plan) -> Optional[str]:
    """Persist a MEASURED winner (analytic/default plans are never
    cached — a cache hit must mean "this was measured on this
    hardware", or warm restarts would trust a guess forever)."""
    if not cache_dir or plan.source != PLAN_SOURCE_MEASURED:
        return None
    return save_plan(cache_dir, signature, geometry, topology,
                     plan.to_doc())
