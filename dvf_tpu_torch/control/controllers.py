"""Closed-loop controllers: telemetry rows in, actuation decisions out
(port of ``dvf_tpu.control.controllers``).

Each controller is a DETERMINISTIC transducer: ``step(row)`` consumes one
telemetry row (a flat signal dict plus the ``buckets``/``sessions`` view
the control plane attaches) and returns a list of :class:`Action`
records. No wall-clock reads, no randomness — replaying the same row
sequence through a fresh controller yields byte-identical action
sequences (pinned in tests/test_control.py), which is what makes an
overload incident reproducible from its flight-recorder window.

The three controllers map to the three knobs the serving runtime
already exposes:

:class:`BatchTickController`
    Per-bucket batch size from measured batch OCCUPANCY (mean valid
    rows per tick — a small bucket stops inheriting the big bucket's
    batch size: a per-bucket autotune), growing under
    standing queue pressure; plus the dispatch tick interval (the tick
    budget: tighten while work is queued, relax when idle). Resizes
    actuate through the compile-aside HOT SWAP (the successor program
    compiles in the background, the commit is one pointer swing between
    ticks), so the hysteresis is safety-only: a short hold debounces
    the occupancy EWMA, a short flip dwell keeps the ladder from
    chattering, and SHRINKS are refused only during an overload episode
    (pressure OR a raised admission floor: floor-up calm is fake calm,
    and the shrink it invites is un-shrunk seconds later by the
    re-admission flood).

:class:`QualityController`
    Per-session resolution downshift under sustained pressure, lowest
    tier first; the session's op chain gains an ``upscale`` stage so
    clients still receive full-resolution frames (ops/sr.py). Recovery
    steps back up highest tier first. Hysteresis is explicit:
    ``down_after`` consecutive pressured samples per downshift,
    ``up_after`` recovered samples per upshift, a per-session
    ``min_dwell`` between OPPOSITE-direction moves — a session can
    never oscillate within one dwell window — and no upshift at all
    while the admission floor is raised (floor-up calm is fake calm:
    the system keeps up only because load is refused at the door).

:class:`TierAdmissionController`
    The admission floor: sustained overload first refuses new
    batch-tier sessions, then standard — paid/interactive tenants are
    shed last, at the door, before anyone's frames are. Release is
    STEPWISE (one tier per calm run): dropping the whole floor at once
    would re-admit the entire refused backlog as a flood that
    immediately re-trips the overload it was shed for.

The pattern is the profiling-driven adaptive-inference loop
(arXiv:2605.25682) with TVM's measured-stage discipline
(arXiv:1802.04799): every decision divides by a MEASURED signal
(occupancy EWMAs, measured tick costs, the telemetry ring's observed
queue depth and SLO headroom), never a guess.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# Priority tiers: lower value = higher priority = shed last.
TIER_INTERACTIVE, TIER_STANDARD, TIER_BATCH = 0, 1, 2
TIER_NAMES = {TIER_INTERACTIVE: "interactive", TIER_STANDARD: "standard",
              TIER_BATCH: "batch"}


@dataclasses.dataclass(frozen=True)
class Action:
    """One actuation decision. ``kind``: resize | tick | downshift |
    upshift | tier_floor | flight. ``target``: bucket label / session id
    / None. ``value``: the new setting. ``reason`` is human-readable and
    lands in the decision log the flight recorder dumps."""

    kind: str
    target: Optional[str]
    value: object
    reason: str


@dataclasses.dataclass
class ControlConfig:
    """Knobs for the whole control plane (CLI: ``--control``)."""

    interval_s: float = 1.0        # telemetry sampling cadence the plane
    #   arms the ring at (when nothing else armed it already)
    # -- pressure predicate (shared by all three controllers) ------------
    queue_high_per_session: float = 3.0   # standing queue_depth per open
    #   session that reads as overload (above one batch's worth of
    #   backlog per tenant, the system is not keeping up)
    headroom_low_ms: float = 0.0   # slo_headroom_ms below this = pressure
    # -- batch/tick controller ------------------------------------------
    batch_ladder: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    batch_max: int = 0             # 0 = the frontend's configured
    #   batch_size (set by the plane at attach)
    occupancy_headroom: float = 1.3   # size to EWMA occupancy × this
    # The resize hysteresis below was sized for the QUIESCE era, when
    # every resize paused its bucket for a recompile and a wrong
    # decision cost two visible stalls. Resizes now ride the
    # compile-aside hot swap (runtime.engine.prepare_swap/commit_swap):
    # the successor compiles on a background thread while the bucket
    # keeps serving, and the commit is one pointer swing between ticks
    # (~0 ms). The dwell values therefore shrink to safety-only floors —
    # enough to debounce a noisy occupancy EWMA, not to amortize a
    # stall that no longer exists.
    resize_hold: int = 2           # consecutive samples agreeing on the
    #   same target before a resize is issued (debounce only)
    resize_cooldown: int = 4       # min samples between resizes/bucket
    resize_flip_dwell: int = 8     # min samples before a bucket may
    #   resize in the OPPOSITE direction of its last resize (a
    #   flip now wastes only background compile, not serving time —
    #   this floor just keeps the ladder from chattering)
    tick_busy_s: float = 0.002     # dispatch tick while work is queued
    tick_idle_s: float = 0.01      # relaxed tick after idle_after
    idle_after: int = 5            # samples with zero queue before relax
    # -- quality controller ---------------------------------------------
    max_level: int = 1             # downshift steps (each is ×2 per axis)
    down_after: int = 3            # pressured samples per downshift step
    up_after: int = 8              # recovered samples per upshift step
    min_dwell: int = 16            # min samples between opposite-
    #   direction moves for ONE session (the no-oscillation bound)
    # -- tier admission controller --------------------------------------
    tier_floor_enabled: bool = True
    overload_after: int = 5        # pressured samples before the floor
    #   drops to refuse batch tier; 2× that refuses standard too
    # -- saturation ------------------------------------------------------
    saturate_after: int = 10       # pressured samples with every
    #   downshiftable session already at max_level → flight dump


def is_pressure(row: dict, prev: Optional[dict],
                config: ControlConfig) -> bool:
    """THE overload predicate, stated once: standing queue beyond
    ``queue_high_per_session`` per open session, OR negative SLO
    headroom, OR sheds/drops advancing since the previous row."""
    open_sessions = max(1.0, float(row.get("open_sessions") or 0.0))
    qd = float(row.get("queue_depth") or 0.0)
    if qd >= config.queue_high_per_session * open_sessions:
        return True
    headroom = row.get("slo_headroom_ms")
    if headroom is not None and float(headroom) < config.headroom_low_ms:
        # slo_headroom_ms is derived from LIFETIME percentiles (the
        # decimated latency reservoir never windows), so after a severe
        # burst it can stay negative long after the overload ended —
        # taken alone it would latch pressure and block recovery
        # indefinitely. When the row carries the delivery counters,
        # negative headroom reads as CURRENT pressure only while this
        # window's deliveries are still missing their SLO.
        cur_m = row.get("slo_miss_total")
        prev_m = None if prev is None else prev.get("slo_miss_total")
        if cur_m is None or prev_m is None:
            return True
        if float(cur_m) > float(prev_m):
            return True
    if prev is not None:
        for k in ("shed_total", "dropped_at_ingress_total"):
            cur_v, prev_v = row.get(k), prev.get(k)
            if cur_v is not None and prev_v is not None \
                    and float(cur_v) > float(prev_v):
                return True
    return False


class BatchTickController:
    """Per-bucket batch size from occupancy + the dispatch tick budget
    (class docstring in the module header)."""

    def __init__(self, config: ControlConfig):
        self.config = config
        self._i = 0                                   # sample index (the
        #   flip-dwell clock)
        self._want: Dict[str, Tuple[int, int]] = {}   # label -> (target,
        #   consecutive samples agreeing) — the resize_hold debounce
        self._cooldown: Dict[str, int] = {}           # label -> samples
        #   remaining before this bucket may resize again
        self._last_resize: Dict[str, Tuple[int, int]] = {}  # label ->
        #   (sample idx, direction): +1 grow, -1 shrink — the flip-dwell
        #   bookkeeping
        self._idle_streak = 0
        self._tick: Optional[float] = None            # last issued tick

    def _ladder_fit(self, occupancy: float, cap: int) -> int:
        want = occupancy * self.config.occupancy_headroom
        for n in self.config.batch_ladder:
            if n >= want:
                return min(n, cap)
        return cap

    def step(self, row: dict, prev: Optional[dict],
             floor: Optional[int] = None) -> List[Action]:
        """``floor``: the admission floor in force for this sample — a
        raised floor marks an overload episode even when the window
        itself reads calm (load is being refused at the door), and no
        bucket shrinks during an episode."""
        self._i += 1
        out: List[Action] = []
        cfg = self.config
        pressure = is_pressure(row, prev, cfg)
        seen = set()
        for b in row.get("buckets") or ():
            label = b.get("label")
            cur = b.get("batch_size")
            occ = b.get("mean_valid_rows")
            if label is None or cur is None:
                continue
            seen.add(label)
            cd = self._cooldown.get(label, 0)
            if cd > 0:
                self._cooldown[label] = cd - 1
            if occ is None:
                continue  # no measured ticks yet — never act on a guess
            cap = cfg.batch_max if cfg.batch_max > 0 else int(cur)
            target = self._ladder_fit(float(occ), cap)
            if float(b.get("queue_depth") or 0.0) > 2.0 * cur:
                # Standing backlog beyond two batches: throughput mode —
                # grow toward the cap regardless of what occupancy
                # (bounded by the CURRENT size) says.
                target = max(target, min(int(cur) * 2, cap))
            if target < cur and (pressure or floor is not None):
                # Never shrink during an overload episode (the calm a
                # raised floor buys is fake calm). Interactive tenants
                # no longer block a shrink: a hot-swapped resize costs
                # the bucket ~0 serving time, so reclaiming padded-row
                # compute is safe even under a tier-0 session.
                target = int(cur)
            if target == cur:
                self._want.pop(label, None)
                continue
            direction = 1 if target > cur else -1
            last = self._last_resize.get(label)
            if last is not None and last[1] != direction \
                    and (self._i - last[0]) < cfg.resize_flip_dwell:
                self._want.pop(label, None)   # opposite move too soon —
                continue                      # wait out the flip dwell
            prev_want, streak = self._want.get(label, (None, 0))
            streak = streak + 1 if prev_want == target else 1
            self._want[label] = (target, streak)
            if streak >= cfg.resize_hold and self._cooldown.get(label, 0) <= 0:
                out.append(Action(
                    "resize", label, target,
                    f"occupancy {float(occ):.1f} rows, queue "
                    f"{b.get('queue_depth')}, batch {cur} -> {target}"))
                self._cooldown[label] = cfg.resize_cooldown
                self._last_resize[label] = (self._i, direction)
                self._want.pop(label, None)
        for label in list(self._want):
            if label not in seen:
                del self._want[label]    # bucket retired
        for label in list(self._cooldown):
            if label not in seen:
                del self._cooldown[label]
        for label in list(self._last_resize):
            if label not in seen:
                del self._last_resize[label]
        # Tick budget: tighten the dispatch tick the moment work is
        # standing; relax only after a sustained idle run.
        qd = float(row.get("queue_depth") or 0.0)
        self._idle_streak = self._idle_streak + 1 if qd == 0 else 0
        tick = (cfg.tick_idle_s if self._idle_streak >= cfg.idle_after
                else cfg.tick_busy_s)
        if tick != self._tick:
            self._tick = tick
            out.append(Action("tick", None, tick,
                              f"queue_depth {qd:g}, idle_streak "
                              f"{self._idle_streak}"))
        return out


class QualityController:
    """Per-session resolution downshift/upshift with explicit
    hysteresis (module docstring)."""

    def __init__(self, config: ControlConfig):
        self.config = config
        self._i = 0                      # sample index (the dwell clock)
        self._pressure_streak = 0
        self._recover_streak = 0
        self._last_move: Dict[str, Tuple[int, int]] = {}  # sid -> (idx,
        #   direction): +1 downshift, -1 upshift — the dwell bookkeeping
        self.saturated_streak = 0        # read by the plane's
        #   saturation watch

    def _may_move(self, sid: str, direction: int) -> bool:
        last = self._last_move.get(sid)
        if last is None:
            return True
        idx, d = last
        if d == direction:
            return True   # same direction: the streak gates already
        return (self._i - idx) >= self.config.min_dwell

    def step(self, row: dict, prev: Optional[dict],
             floor: Optional[int] = None) -> List[Action]:
        """``floor``: the admission floor in force when this sample was
        taken (None = all tiers admitted). While a floor is raised, the
        calm the window shows is FAKE calm — the system is keeping up
        only because load is being refused at the door — so quality
        recovery must not begin: upshifting (interactive first, to its
        most expensive configuration) in the same breath as the floor
        releasing re-admits the flood straight onto freshly full-price
        sessions, the worst phase of the admission limit cycle. Release
        order is therefore: floor first, then — only if the window
        stays calm with every tier admitted — quality."""
        self._i += 1
        cfg = self.config
        sessions = list(row.get("sessions") or ())
        live = {s["sid"] for s in sessions}
        for sid in list(self._last_move):
            if sid not in live:
                del self._last_move[sid]
        pressure = is_pressure(row, prev, cfg)
        if pressure:
            self._pressure_streak += 1
            self._recover_streak = 0
        else:
            self._recover_streak += 1
            self._pressure_streak = 0
        out: List[Action] = []
        if pressure and self._pressure_streak >= cfg.down_after:
            # Downshift the LOWEST-priority tier (highest value) that
            # still has headroom, one step, all its eligible sessions at
            # once — gradual per-session trickles would take minutes to
            # bend a fleet-wide overload.
            movable = [s for s in sessions
                       if s.get("downshiftable")
                       and int(s.get("level") or 0) < cfg.max_level
                       and self._may_move(s["sid"], +1)]
            if movable:
                tier = max(int(s.get("tier") or 0) for s in movable)
                victims = sorted(
                    (s for s in movable if int(s.get("tier") or 0) == tier),
                    key=lambda s: s["sid"])
                for s in victims:
                    lvl = int(s.get("level") or 0) + 1
                    out.append(Action(
                        "downshift", s["sid"], lvl,
                        f"sustained pressure x{self._pressure_streak}, "
                        f"tier {TIER_NAMES.get(tier, tier)} -> level {lvl}"))
                    self._last_move[s["sid"]] = (self._i, +1)
                # Next round needs a fresh pressure run — EXCEPT under
                # severe pressure (standing queue at 2× the overload
                # threshold: a step overload's onset), where waiting out
                # a full streak per tier-by-tier round stretches the
                # bend across seconds of queue growth; severe rounds run
                # on consecutive pressured samples instead. Per-session
                # dwell still rules out oscillation — successive rounds
                # move DIFFERENT tiers.
                open_n = max(1.0, float(row.get("open_sessions") or 0.0))
                severe = float(row.get("queue_depth") or 0.0) \
                    >= 2.0 * cfg.queue_high_per_session * open_n
                self._pressure_streak = cfg.down_after - 1 if severe else 0
            else:
                # Nothing left to give: every downshiftable session is
                # at max level (or dwell-locked) while pressure holds —
                # the saturation signal the plane turns into a flight
                # dump past saturate_after.
                self.saturated_streak += 1
        else:
            if not pressure:
                self.saturated_streak = 0
        if not pressure and self._recover_streak >= cfg.up_after \
                and floor is None:
            down = [s for s in sessions if int(s.get("level") or 0) > 0
                    and self._may_move(s["sid"], -1)]
            if down:
                # Recover the HIGHEST-priority tier first (LIFO of the
                # downshift order: interactive gets its pixels back
                # before batch does).
                tier = min(int(s.get("tier") or 0) for s in down)
                winners = sorted(
                    (s for s in down if int(s.get("tier") or 0) == tier),
                    key=lambda s: s["sid"])
                for s in winners:
                    lvl = int(s.get("level") or 0) - 1
                    out.append(Action(
                        "upshift", s["sid"], lvl,
                        f"recovered x{self._recover_streak}, tier "
                        f"{TIER_NAMES.get(tier, tier)} -> level {lvl}"))
                    self._last_move[s["sid"]] = (self._i, -1)
                self._recover_streak = 0
        return out


class TierAdmissionController:
    """The admission floor under sustained overload (module docstring).
    Floor semantics: sessions with tier > floor are refused at
    open_stream; ``None`` admits every tier."""

    def __init__(self, config: ControlConfig):
        self.config = config
        self._pressure_streak = 0
        self._recover_streak = 0
        self._floor: Optional[int] = None

    @property
    def floor(self) -> Optional[int]:
        """The admission floor currently in force (None = open)."""
        return self._floor

    def step(self, row: dict, prev: Optional[dict]) -> List[Action]:
        cfg = self.config
        if not cfg.tier_floor_enabled:
            return []
        if is_pressure(row, prev, cfg):
            self._pressure_streak += 1
            self._recover_streak = 0
        else:
            self._recover_streak += 1
            self._pressure_streak = 0
        floor = self._floor
        if self._pressure_streak >= 2 * cfg.overload_after:
            floor = TIER_INTERACTIVE      # only interactive admits
        elif self._pressure_streak >= cfg.overload_after:
            floor = TIER_STANDARD         # batch tier refused
        elif self._recover_streak >= cfg.up_after and floor is not None:
            # STEPWISE release, one tier per calm run: dropping the
            # whole floor at once re-admits the entire refused backlog
            # as a flood that immediately re-trips the overload it was
            # shed for (the classic admission limit cycle) — re-admit
            # standard first, and only open batch after the window
            # stays calm WITH standard traffic back.
            floor = None if floor >= TIER_STANDARD else floor + 1
            self._recover_streak = 0   # each step judged on fresh calm
        if floor != self._floor:
            self._floor = floor
            return [Action(
                "tier_floor", None, floor,
                f"pressure_streak {self._pressure_streak}, "
                f"recover_streak {self._recover_streak}")]
        return []
