"""The control plane: telemetry in, actuation out, observable always
(port of ``dvf_tpu.control.plane``).

``ControlPlane`` closes the telemetry plane's loop: the serving frontend's
``TimeSeriesRing`` already samples the load-control signals (fps,
p50/p99, queue depth, SLO headroom, per-kind fault rates) at a fixed
cadence — this module hangs the controllers (`control.controllers`) off
that ring's ``on_sample`` seam, composes each flat row with the
frontend's per-bucket/per-session control view, runs the DETERMINISTIC
decision step inline in the sampler, and applies the resulting actions
on a dedicated apply thread (an actuation that recompiles a program —
a per-bucket batch resize, a quality-bucket creation — must not stall
the sampling cadence the next decision depends on).

Dataflow (one arrow per thread boundary)::

  TimeSeriesRing (1/interval_s)
      └─ on_sample(prev, row) ──► ControlPlane.observe
             row + actuator.control_view()            [sampler thread]
             controllers.step(row) -> [Action]        (deterministic)
             decision log (bounded ring, flight-dumpable)
      └────── apply queue ──────► _apply_loop         [apply thread]
                  actuator.request_batch_size / set_tick_interval /
                  request_session_quality / set_admission_tier_floor

The actuator is duck-typed (ServeFrontend implements it) so the
controllers can be driven from recorded windows in tests without a
frontend — replaying the same rows twice yields the identical action
sequence, pinned by the tier-1 ``control`` marker tests.

Saturation: when the quality controller has nothing left to shed
(every downshiftable session at max level) while pressure persists
``saturate_after`` samples, the plane triggers the flight recorder —
"the controller gave everything it had and it wasn't enough" is
exactly when a post-mortem window is worth a dump.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Any, List, Optional

from dvf_tpu_torch.control.controllers import (
    Action,
    BatchTickController,
    ControlConfig,
    QualityController,
    TierAdmissionController,
    is_pressure,
)


class ControlPlane:
    """Owns the controllers and the apply thread (module docstring)."""

    def __init__(self, actuator: Any,
                 config: Optional[ControlConfig] = None,
                 decision_log: int = 256):
        self.actuator = actuator
        self.config = config or ControlConfig()
        self.batch = BatchTickController(self.config)
        self.quality = QualityController(self.config)
        self.tiers = TierAdmissionController(self.config)
        self._prev_row: Optional[dict] = None
        self._lock = threading.Lock()
        # Counters (exported through the owner's signals()/stats()).
        self.actions_total = 0
        self.downshifts_total = 0
        self.upshifts_total = 0
        self.batch_resizes_total = 0
        self.tick_changes_total = 0
        self.tier_floor_changes_total = 0
        self.saturations_total = 0
        self.apply_errors_total = 0
        self.rejected_quality_total = 0   # quality requests the actuator
        #   could not satisfy (bucket cap, odd geometry, session gone)
        self.tier_floor: Optional[int] = None
        self.tick_s: Optional[float] = None
        self._saturation_open = False     # one dump per episode
        # Bounded decision log: what the flight dump carries so "why did
        # the controller do that at 14:02" has an artifact.
        self.decisions: "collections.deque" = collections.deque(
            maxlen=decision_log)
        self._apply_q: "queue.Queue[Optional[Action]]" = queue.Queue()
        self._apply_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Auto-plan quiescence: while the planner drives the actuators
        # through its own measured search, the reactive loops must not
        # fight it (a batch controller sizing to the measurement
        # session's occupancy would undo every candidate's hot swap).
        self.paused = False

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ControlPlane":
        if self._apply_thread is not None:
            raise RuntimeError("control plane already started")
        self._stop.clear()
        self._apply_thread = threading.Thread(
            target=self._apply_loop, name="dvf-control-apply", daemon=True)
        self._apply_thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._apply_q.put(None)
        if self._apply_thread is not None:
            self._apply_thread.join(timeout=timeout)
            self._apply_thread = None

    # -- the operating envelope (auto-plan plane) ------------------------

    def apply_envelope(self, envelope: dict,
                       reason: Optional[str] = None) -> None:
        """Adopt a planner-chosen operating envelope
        (``control.planner.Plan.envelope()``): the batch ladder bounded
        at the planned batch, the planned tick as the busy tick. The
        controllers keep their closed-loop roles — sizing batch to
        measured occupancy, shedding under pressure — but now adapt
        WITHIN the measured-optimal envelope instead of rediscovering
        it from hard-coded defaults every run. Rebuilds the controllers
        against the new config; meant for startup (before traffic) — a
        concurrent decision step sees either the old or the new
        controller set, both total."""
        kw = {}
        ladder = envelope.get("batch_ladder")
        if ladder:
            kw["batch_ladder"] = tuple(int(b) for b in ladder)
        if envelope.get("batch_max"):
            kw["batch_max"] = int(envelope["batch_max"])
        if envelope.get("tick_busy_s"):
            kw["tick_busy_s"] = float(envelope["tick_busy_s"])
        if not kw:
            return
        cfg = dataclasses.replace(self.config, **kw)
        self.config = cfg
        self.batch = BatchTickController(cfg)
        self.quality = QualityController(cfg)
        self.tiers = TierAdmissionController(cfg)
        with self._lock:
            self.decisions.append({"kind": "envelope", "target": None,
                                   "value": dict(kw), "reason": reason})

    # -- the ring seam ---------------------------------------------------

    def on_sample(self, prev: Optional[dict], cur: dict) -> None:
        """TimeSeriesRing hook: compose the control row, decide, queue
        the actions. Exceptions are contained by the ring
        (``hook_errors_total``) — a broken controller must not kill the
        sampler — but decide() is total by construction."""
        if self.paused:
            return
        row = dict(cur)
        row.update(self.actuator.control_view())
        for a in self.decide(row):
            self._apply_q.put(a)

    def decide(self, row: dict) -> List[Action]:
        """One deterministic decision step over a composed row. Safe to
        call directly with recorded rows (the determinism tests do)."""
        prev = self._prev_row
        actions: List[Action] = []
        # Batch sees the floor too: a raised floor marks an overload
        # episode, and no bucket shrink-resizes during an episode (the
        # recompile stall would land on the very tenants being
        # protected).
        actions.extend(self.batch.step(row, prev,
                                       floor=self.tiers.floor))
        # Quality sees the floor as of ENTERING this step (tiers runs
        # after): a floor releasing this very sample still gates the
        # upshift, so quality recovery starts at least one full sample
        # after admission reopens — never into the re-admission flood.
        actions.extend(self.quality.step(row, prev,
                                         floor=self.tiers.floor))
        actions.extend(self.tiers.step(row, prev))
        # Saturation watch: quality has nothing left while pressure
        # holds. One flight action per episode (reset on recovery).
        if self.quality.saturated_streak >= self.config.saturate_after:
            if not self._saturation_open:
                self._saturation_open = True
                actions.append(Action(
                    "flight", None, None,
                    f"controller saturated: every downshiftable session "
                    f"at max level {self.config.max_level} with pressure "
                    f"sustained {self.quality.saturated_streak} samples"))
        elif self.quality.saturated_streak == 0 \
                and not is_pressure(row, prev, self.config):
            self._saturation_open = False
        self._prev_row = row
        if actions:
            # Measured stage-cost annotation (obs.lineage via the
            # actuator's control_view): a bucket-targeted decision
            # records WHERE that bucket's latency was going when the
            # controller acted — the decision log's half of "why did
            # the controller do that at 14:02".
            cost_by_label = {b.get("label"): b.get("stage_cost_ms")
                             for b in row.get("buckets") or []
                             if isinstance(b, dict)}
            with self._lock:
                self.actions_total += len(actions)
                for a in actions:
                    entry = {"kind": a.kind, "target": a.target,
                             "value": a.value, "reason": a.reason}
                    cost = cost_by_label.get(a.target)
                    if cost:
                        entry["stage_cost_ms"] = cost
                    self.decisions.append(entry)
        return actions

    # -- apply side ------------------------------------------------------

    def _apply_loop(self) -> None:
        while not self._stop.is_set():
            a = self._apply_q.get()
            if a is None:
                continue
            try:
                self._apply(a)
            except Exception:  # noqa: BLE001 — one failed actuation must
                with self._lock:   # not kill the loop; counted, loud in
                    self.apply_errors_total += 1   # stats, never raised
                    #   into the serving path

    def _apply(self, a: Action) -> None:
        act = self.actuator
        if a.kind == "resize":
            # The decision rationale rides into the actuator so the
            # reconfiguration ledger's batch_resize event records WHY
            # ("why did the controller do that at 14:02" — one artifact).
            act.request_batch_size(a.target, int(a.value), reason=a.reason)
            with self._lock:
                self.batch_resizes_total += 1
        elif a.kind == "tick":
            act.set_tick_interval(float(a.value))
            with self._lock:
                self.tick_changes_total += 1
                self.tick_s = float(a.value)
        elif a.kind in ("downshift", "upshift"):
            ok = act.request_session_quality(a.target, int(a.value),
                                             reason=a.reason)
            with self._lock:
                if not ok:
                    self.rejected_quality_total += 1
                elif a.kind == "downshift":
                    self.downshifts_total += 1
                else:
                    self.upshifts_total += 1
        elif a.kind == "tier_floor":
            act.set_admission_tier_floor(
                None if a.value is None else int(a.value))
            with self._lock:
                self.tier_floor_changes_total += 1
                self.tier_floor = a.value
        elif a.kind == "flight":
            with self._lock:
                self.saturations_total += 1
            act.flight_trip(a.reason)

    # -- observability ---------------------------------------------------

    def signals(self) -> dict:
        """Flat counters for the owner's ``signals()`` export (prefixed
        ``control_`` there)."""
        with self._lock:
            out = {
                "actions_total": float(self.actions_total),
                "downshifts_total": float(self.downshifts_total),
                "upshifts_total": float(self.upshifts_total),
                "batch_resizes_total": float(self.batch_resizes_total),
                "tick_changes_total": float(self.tick_changes_total),
                "tier_floor_changes_total":
                    float(self.tier_floor_changes_total),
                "saturations_total": float(self.saturations_total),
                "rejected_quality_total": float(self.rejected_quality_total),
                "apply_errors_total": float(self.apply_errors_total),
            }
            if self.tier_floor is not None:
                out["tier_floor"] = float(self.tier_floor)
        return out

    def stats(self) -> dict:
        sig = self.signals()   # takes the lock itself — don't hold it
        with self._lock:
            return {
                **{k: int(v) for k, v in sig.items()
                   if k.endswith("_total")},
                "tier_floor": self.tier_floor,
                "tick_s": self.tick_s,
                "pending_applies": self._apply_q.qsize(),
                "decisions": list(self.decisions)[-32:],
            }
