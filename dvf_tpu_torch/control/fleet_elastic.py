"""Fleet elasticity: the controller that grows and shrinks the fleet
(port of ``dvf_tpu.control.fleet_elastic``).

The serving controllers bend a single replica's overload — downshift
quality, refuse low tiers at the door. What they cannot do is ADD
capacity: the tier admission floor *refuses* load the fleet could serve
by spawning one more replica, and scale-out is a human typing
``--replicas N``. :class:`FleetElasticityController` closes that outer
loop: a deterministic transducer over the fleet's merged telemetry rows
(`fleet.router.FleetFrontend.signals` composed with its
``elastic_view``) that emits ``scale_out`` / ``scale_in`` actions the
elastic plane (`fleet.elastic.ElasticFleetPlane`) applies through the
fleet's actuator seams — ``spawn_replica()`` (warm standby pool: the
spawn is a session-rebind, not a cold compile) and ``retire_replica()``
(the fleet's drain → migrate machinery, session affinity preserved).

Same discipline as `control.controllers`: ``step(row, prev)`` reads one
telemetry row, no wall-clock, no randomness — replaying a recorded
window through a fresh controller yields a byte-identical action list
(pinned in tests/test_elastic.py, and asserted by the committed
``ELASTIC_BENCH.json`` run), so a scale incident is reproducible from
its flight dump.

The decision inputs, in the order they matter:

- **admission-refusal rate** (``admission_refusals_total`` advancing):
  the leading indicator — the fleet is refusing sessions it could serve
  by growing, *before* any queue or percentile has moved;
- **per-replica occupancy** (bound sessions vs fleet session capacity):
  the second leading indicator — a fleet near its admission gates will
  start refusing next tick;
- **queue depth / shed / SLO-miss counters and fleet p99 vs SLO**: the
  lagging confirmation that the fleet is genuinely past capacity.

Scaling has TWO axes: *more replicas* (another single-host replica —
the default) and a *bigger replica* (a ``MultiHostEngine`` process
group: one program across every host's devices, ``fleet.multihost``).
The controller picks per the measured signature cost profiles
(``--profile-dir``):
when the dominant signature's measured device-stage cost alone exceeds
``bigger_replica_device_ms``, adding small replicas multiplies queueing
without ever bringing one frame's device time down — only a replica
with more devices can — so the scale-out action targets the
``multihost`` flavor; otherwise more (cheap, independently
schedulable) single-host replicas win. The profiling-driven
adaptive-partition discipline of arXiv:2605.25682, applied to the
fleet's outermost knob.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from dvf_tpu_torch.control.controllers import Action

# Replica flavors a scale-out action may target (``Action.target``).
FLAVOR_DEFAULT = "default"      # whatever FleetConfig.mode spawns
FLAVOR_MULTIHOST = "multihost"  # MultiHostEngine process group
FLAVOR_RELAY = "relay"          # broadcast egress relay (no filter
#   compute — a RelayNode fanning an already-encoded tier out to its
#   own subscribers; the THIRD scaling axis, broadcast plane)


@dataclasses.dataclass
class ElasticConfig:
    """Knobs for the fleet elasticity loop (CLI: ``--autoscale``)."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 0.25       # fleet telemetry cadence the elastic
    #   plane arms the ring at (when nothing armed it already)
    # -- pressure predicate ----------------------------------------------
    sessions_high_frac: float = 0.85   # bound sessions / fleet session
    #   capacity beyond which the fleet reads as near-saturated (the
    #   tier guard refuses batch tier at the same watermark: growing
    #   HERE is what turns that refusal back into served load)
    queue_high_per_session: float = 3.0  # standing fleet queue_depth per
    #   open session that reads as overload (the serving predicate, one
    #   tier up)
    # -- scale-out -------------------------------------------------------
    out_after: int = 2             # consecutive pressured samples before
    #   a scale-out (short on purpose: refusals are the leading signal
    #   and every refused open is load the fleet turned away)
    out_cooldown: int = 6          # min samples between scale-outs — one
    #   spawn must be observable in the window before the next is judged
    # -- scale-in --------------------------------------------------------
    in_after: int = 24             # consecutive calm samples before a
    #   scale-in (long: a retire costs migrations, and the burst that
    #   scaled us out tends to come back — the serving soak posture)
    in_cooldown: int = 8
    in_occupancy_frac: float = 0.6  # a retire must leave the SURVIVORS
    #   at most this occupied (projected bound-sessions / post-retire
    #   capacity) — never shrink into immediate re-pressure, the
    #   admission limit cycle one tier up
    # -- two-axis choice -------------------------------------------------
    bigger_replica_device_ms: float = 0.0  # 0 disables the multihost
    #   axis. >0: when the dominant signature's measured per-tick device
    #   cost (stage profiles) exceeds this, scale-out targets the
    #   multihost flavor — more single-host replicas cannot shrink ONE
    #   frame's device time, only more devices under one program can
    # -- saturation ------------------------------------------------------
    saturate_after: int = 10       # pressured samples at max_replicas
    #   with nothing left to spawn → flight dump (one per episode)
    # -- relay axis (broadcast fan-out) ----------------------------------
    relay_subscribers_high: int = 0  # 0 disables the relay axis (the
    #   default: recorded pre-broadcast replay windows stay byte-
    #   identical, and a fleet that never publishes has nothing to
    #   relay). >0: once direct subscribers per egress point (origin +
    #   live relays) reach this, fan-out — not filter compute — is the
    #   bottleneck, and the right spawn is a relay-only egress replica,
    #   never another filter replica
    relay_out_after: int = 2       # consecutive fan-out-pressured
    #   samples before a relay spawn (short, like out_after: every
    #   sample over the watermark is subscriber-visible egress drop)
    relay_in_after: int = 24       # consecutive fan-out-calm samples
    #   before a relay retire (soak posture, like in_after)
    relay_cooldown: int = 6        # min samples between relay actions
    max_relays: int = 4            # relay-replica ceiling
    # -- feed-forward (predictive) axis -----------------------------------
    predictive: bool = False       # step the fleet with
    #   PredictiveElasticityController: project queue/occupancy growth
    #   from the telemetry window's slope and spawn BEFORE the reactive
    #   predicate fires (auto-plan plane; CLI --autoplan arms it)
    predict_slope_window: int = 3  # rows the slope is fit over (first
    #   vs last — robust to one noisy sample, still just arithmetic)
    predict_horizon: int = 4       # samples ahead the projection looks:
    #   roughly the spawn lead time (standby rebind + first window) in
    #   ring samples, so capacity lands when the projection said the
    #   watermark would be crossed


def fleet_pressure(row: dict, prev: Optional[dict],
                   config: ElasticConfig) -> Optional[str]:
    """THE fleet-tier overload predicate, stated once. Returns the
    triggering reason (a human-readable tag for the decision log), or
    None when calm. Counter inputs compare against ``prev`` so a burst
    shows as *advancing* refusals/sheds, not as a latched lifetime
    total."""
    def advancing(key: str) -> bool:
        if prev is None:
            return False
        cur_v, prev_v = row.get(key), prev.get(key)
        return (cur_v is not None and prev_v is not None
                and float(cur_v) > float(prev_v))

    if advancing("admission_refusals_total"):
        return "admission refusals advancing"
    cap = float(row.get("capacity_sessions") or 0.0)
    bound = float(row.get("bound_sessions") or 0.0)
    if cap > 0 and bound >= config.sessions_high_frac * cap:
        return (f"occupancy {bound:g}/{cap:g} >= "
                f"{config.sessions_high_frac:g}")
    open_sessions = max(1.0, float(row.get("open_sessions") or 0.0))
    qd = float(row.get("fleet_queue_depth") or 0.0)
    if qd >= config.queue_high_per_session * open_sessions:
        return f"standing queue {qd:g} over {open_sessions:g} sessions"
    if advancing("fleet_shed_total"):
        return "sheds advancing"
    if advancing("fleet_slo_miss_total"):
        return "SLO misses advancing"
    p99 = row.get("fleet_p99_ms")
    slo = row.get("slo_ms")
    if p99 is not None and slo is not None and float(p99) > float(slo):
        # Worst replica's p99 over the SLO: lagging, but decisive —
        # WHEN the miss counter cannot arbitrate. With counters
        # present, advancing misses already returned above and a
        # non-advancing window means the overload ENDED (the serving
        # controllers' lesson: lifetime percentiles latch long after a burst), so
        # p99 alone must not re-latch pressure; it decides only on the
        # first sample or when the row carries no miss counter.
        if prev is None or row.get("fleet_slo_miss_total") is None:
            return f"fleet p99 {float(p99):.0f}ms > SLO {float(slo):.0f}ms"
    return None


def relay_pressure(row: dict, prev: Optional[dict],
                   config: ElasticConfig) -> Optional[str]:
    """The fan-out overload predicate — the broadcast analogue of
    :func:`fleet_pressure`, stated once. Fan-out pressure is NOT filter
    pressure: every queue/p99/refusal signal above can be calm while
    tens of thousands of subscribers drain one origin's egress, so the
    relay axis reads only the broadcast row — subscribers per egress
    point (origin + live relays) against the watermark, and advancing
    egress drops as the lagging confirmation."""
    if config.relay_subscribers_high <= 0:
        return None
    subs = float(row.get("broadcast_subscribers") or 0.0)
    if subs <= 0:
        return None
    egress = 1.0 + float(row.get("relays_live") or 0.0)
    if subs / egress >= config.relay_subscribers_high:
        return (f"fan-out {subs:g} subscribers over {egress:g} egress "
                f"point(s) >= {config.relay_subscribers_high}/point")
    if prev is not None:
        cur_v = row.get("broadcast_dropped_total")
        prev_v = prev.get("broadcast_dropped_total")
        if (cur_v is not None and prev_v is not None
                and float(cur_v) > float(prev_v)):
            return "broadcast egress drops advancing"
    return None


class FleetElasticityController:
    """Deterministic scale-out/scale-in transducer (module docstring).

    ``step(row, prev)`` expects the composed fleet control row: the
    flat ring sample plus ``FleetFrontend.elastic_view()`` —
    ``replicas_live``/``replicas_desired``/``replicas_max_flavor``
    gauges, ``replica_rows`` (per-replica ``{rid, sessions,
    queue_depth}``), capacity, and the startup-loaded signature cost
    profile. Emits at most one scale action per step: elasticity is a
    slow loop by design (every action is observable in the window
    before the next is judged)."""

    def __init__(self, config: Optional[ElasticConfig] = None):
        self.config = config or ElasticConfig()
        if self.config.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.config.max_replicas < self.config.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.config.in_occupancy_frac >= self.config.sessions_high_frac:
            # A retire that leaves the survivors above the scale-OUT
            # occupancy watermark re-trips pressure on the next sample:
            # scale-in → scale-out → scale-in, every leg paying a spawn
            # or a drain+migration. Refuse the config rather than run
            # the limit cycle.
            raise ValueError(
                f"in_occupancy_frac ({self.config.in_occupancy_frac}) "
                f"must be < sessions_high_frac "
                f"({self.config.sessions_high_frac}): a shrink must not "
                f"land the survivors straight back at the scale-out "
                f"watermark")
        self._i = 0
        self._pressure_streak = 0
        self._calm_streak = 0
        self._cooldown = 0
        self._saturation_open = False
        # Relay axis: independent streaks/cooldown — fan-out pressure
        # and filter pressure are different bottlenecks and must never
        # share a hysteresis state (a compute burst would reset the
        # relay calm clock and pin surplus relays alive).
        self._relay_pressure_streak = 0
        self._relay_calm_streak = 0
        self._relay_cooldown = 0

    # -- the decision step ------------------------------------------------

    def step(self, row: dict, prev: Optional[dict]) -> List[Action]:
        cfg = self.config
        self._i += 1
        if self._cooldown > 0:
            self._cooldown -= 1
        reason = self._pressure(row, prev)
        if reason is not None:
            self._pressure_streak += 1
            self._calm_streak = 0
        else:
            self._calm_streak += 1
            self._pressure_streak = 0
        desired = int(row.get("replicas_desired") or 0)
        out: List[Action] = []
        if reason is not None and self._pressure_streak >= cfg.out_after:
            if desired < cfg.max_replicas and self._cooldown <= 0:
                flavor = self._flavor(row)
                out.append(Action(
                    "scale_out", flavor, desired + 1,
                    f"{reason} (pressure x{self._pressure_streak}), "
                    f"replicas {desired} -> {desired + 1}"))
                self._cooldown = cfg.out_cooldown
                self._saturation_open = False
            elif desired >= cfg.max_replicas:
                # Nothing left to spawn while pressure holds: the
                # saturation signal the plane turns into a flight dump
                # (one per episode — "the fleet gave everything").
                if (self._pressure_streak >= cfg.saturate_after
                        and not self._saturation_open):
                    self._saturation_open = True
                    out.append(Action(
                        "flight", None, None,
                        f"fleet saturated: {reason} with every replica "
                        f"spawned ({desired}/{cfg.max_replicas}), "
                        f"pressure sustained x{self._pressure_streak}"))
        elif reason is None:
            self._saturation_open = False
            if (self._calm_streak >= cfg.in_after
                    and desired > cfg.min_replicas
                    and self._cooldown <= 0):
                victim = self._victim(row, desired)
                if victim is not None:
                    out.append(Action(
                        "scale_in", victim, desired - 1,
                        f"calm x{self._calm_streak}, replicas "
                        f"{desired} -> {desired - 1} (retiring {victim})"))
                    self._cooldown = cfg.in_cooldown
                    # Each further step down is judged on fresh calm:
                    # releasing the whole surplus at once would dump
                    # every retiring replica's migrations into one
                    # window.
                    self._calm_streak = 0
        out.extend(self._relay_step(row, prev))
        return out

    def _pressure(self, row: dict, prev: Optional[dict]) -> Optional[str]:
        """The pressure-predicate seam. The base controller is purely
        reactive (`fleet_pressure`); the predictive subclass widens this
        to ALSO read projected pressure — everything downstream
        (streaks, cooldowns, flavor choice, victim selection) is shared,
        so the two controllers differ ONLY in when pressure is first
        seen."""
        return fleet_pressure(row, prev, self.config)

    def _relay_step(self, row: dict, prev: Optional[dict]) -> List[Action]:
        """The relay axis, stepped on the same row (at most one relay
        action per step, independent of any scale action the same
        step emitted — they move different resources)."""
        cfg = self.config
        if cfg.relay_subscribers_high <= 0:
            return []
        if self._relay_cooldown > 0:
            self._relay_cooldown -= 1
        reason = relay_pressure(row, prev, cfg)
        relays = int(float(row.get("relays_live") or 0.0))
        out: List[Action] = []
        if reason is not None:
            self._relay_pressure_streak += 1
            self._relay_calm_streak = 0
            if (self._relay_pressure_streak >= cfg.relay_out_after
                    and relays < cfg.max_relays
                    and self._relay_cooldown <= 0):
                out.append(Action(
                    "relay_out", FLAVOR_RELAY, relays + 1,
                    f"{reason} (pressure x{self._relay_pressure_streak}), "
                    f"relays {relays} -> {relays + 1}"))
                self._relay_cooldown = cfg.relay_cooldown
        else:
            self._relay_calm_streak += 1
            self._relay_pressure_streak = 0
            if (self._relay_calm_streak >= cfg.relay_in_after
                    and relays > 0 and self._relay_cooldown <= 0):
                out.append(Action(
                    "relay_in", None, relays - 1,
                    f"broadcast calm x{self._relay_calm_streak}, "
                    f"relays {relays} -> {relays - 1}"))
                self._relay_cooldown = cfg.relay_cooldown
                # Fresh calm per further step down (scale-in's rule).
                self._relay_calm_streak = 0
        return out

    # -- helpers ----------------------------------------------------------

    def _flavor(self, row: dict) -> str:
        """More-replicas vs bigger-replica (module docstring): the
        multihost flavor only when it is configured, available
        (``multihost_available`` — the fleet knows a signature to pin
        the group to), and the measured device cost says one host is
        the bottleneck."""
        cfg = self.config
        if cfg.bigger_replica_device_ms <= 0:
            return FLAVOR_DEFAULT
        if not row.get("multihost_available"):
            return FLAVOR_DEFAULT
        device_ms = row.get("profile_device_ms")
        if device_ms is None:
            return FLAVOR_DEFAULT
        if float(device_ms) > cfg.bigger_replica_device_ms:
            return FLAVOR_MULTIHOST
        return FLAVOR_DEFAULT

    def _victim(self, row: dict, desired: int) -> Optional[str]:
        """Deterministic scale-in victim: the least-loaded replica
        (fewest bound sessions, queue depth then id breaking ties —
        fewest migrations when it drains), and only when the survivors
        can absorb the whole bound-session load below
        ``in_occupancy_frac`` — a shrink must never re-create the
        pressure it took ``in_after`` calm samples to rule out."""
        cfg = self.config
        rows = [r for r in (row.get("replica_rows") or ())
                if isinstance(r, dict) and r.get("rid") is not None]
        if len(rows) < 2:
            return None
        per_replica_cap = float(row.get("capacity_sessions") or 0.0) / max(
            1, int(row.get("replicas_live") or desired))
        if per_replica_cap <= 0:
            return None
        bound = float(row.get("bound_sessions") or 0.0)
        survivors_cap = per_replica_cap * (desired - 1)
        if survivors_cap <= 0 or bound > cfg.in_occupancy_frac * survivors_cap:
            return None
        return min(
            rows,
            key=lambda r: (float(r.get("sessions") or 0.0),
                           float(r.get("queue_depth") or 0.0),
                           str(r.get("rid"))),
        )["rid"]


class PredictiveElasticityController(FleetElasticityController):
    """Feed-forward elasticity (auto-plan plane): project where
    the fleet is GOING from the telemetry window's slope and read
    pressure before the reactive predicate fires — a standby rebind
    takes samples to land, and a spawn triggered by advancing refusals
    has, by definition, already turned sessions away.

    Two projections, both plain first-vs-last slopes over
    ``predict_slope_window`` rows extrapolated ``predict_horizon``
    samples ahead, judged against the SAME watermarks the reactive
    predicate uses:

    - **occupancy**: projected bound sessions crossing
      ``sessions_high_frac`` × capacity — the refusal precursor (a
      fleet saturates its session slots, then refuses);
    - **queue depth**: projected standing queue crossing
      ``queue_high_per_session`` × open sessions — the latency
      precursor.

    Either projection only counts once the CURRENT value is at least
    halfway to its watermark: a slope fit near zero load (one tenant
    opening on an idle fleet) extrapolates to anything, and a spawn
    it triggers is noise, not feed-forward — prediction accelerates a
    trend already approaching the watermark, it does not invent one.

    The reactive predicate still runs first and wins when it fires
    (measured overload is ground truth; prediction only ADDS pressure,
    never masks it), so the predictive controller is a strict widening:
    every window the reactive controller scales on, this one does too,
    no later. Same determinism discipline as the base class — the
    slope history is rebuilt from the rows alone, no wall clock, so a
    recorded window replays byte-identically (pinned by
    tests/test_planner.py and the committed PLAN_BENCH.json)."""

    def __init__(self, config: Optional[ElasticConfig] = None):
        super().__init__(config)
        if self.config.predict_slope_window < 2:
            raise ValueError("predict_slope_window must be >= 2")
        if self.config.predict_horizon < 1:
            raise ValueError("predict_horizon must be >= 1")
        # (queue_depth, bound_sessions) per step, bounded at the slope
        # window — state derived from rows only (replay determinism).
        self._history: List[tuple] = []

    def _pressure(self, row: dict, prev: Optional[dict]) -> Optional[str]:
        cfg = self.config
        qd = float(row.get("fleet_queue_depth") or 0.0)
        bound = float(row.get("bound_sessions") or 0.0)
        self._history.append((qd, bound))
        if len(self._history) > cfg.predict_slope_window:
            self._history.pop(0)
        reactive = fleet_pressure(row, prev, cfg)
        if reactive is not None:
            return reactive
        if len(self._history) < cfg.predict_slope_window:
            return None
        n = len(self._history) - 1
        q_slope = (self._history[-1][0] - self._history[0][0]) / n
        b_slope = (self._history[-1][1] - self._history[0][1]) / n
        cap = float(row.get("capacity_sessions") or 0.0)
        if b_slope > 0 and cap > 0:
            high = cfg.sessions_high_frac * cap
            proj_bound = bound + b_slope * cfg.predict_horizon
            if proj_bound >= high and bound >= 0.5 * high:
                return (f"projected occupancy {proj_bound:g}/{cap:g} in "
                        f"{cfg.predict_horizon} samples (slope "
                        f"{b_slope:+g}/sample) >= "
                        f"{cfg.sessions_high_frac:g}")
        if q_slope > 0:
            open_sessions = max(1.0, float(row.get("open_sessions") or 0.0))
            q_high = cfg.queue_high_per_session * open_sessions
            proj_q = qd + q_slope * cfg.predict_horizon
            if proj_q >= q_high and qd >= 0.5 * q_high:
                return (f"projected queue {proj_q:g} in "
                        f"{cfg.predict_horizon} samples (slope "
                        f"{q_slope:+g}/sample) over {open_sessions:g} "
                        f"sessions")
        return None


def make_elasticity_controller(
        config: Optional[ElasticConfig] = None) -> FleetElasticityController:
    """The one construction seam: predictive when the config says so
    (``--autoplan`` arms it at the fleet tier), reactive otherwise —
    so the elastic plane, the bench harness, and the replay tests can
    never disagree about which controller a config builds."""
    config = config or ElasticConfig()
    if config.predictive:
        return PredictiveElasticityController(config)
    return FleetElasticityController(config)
