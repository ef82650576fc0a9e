"""Elastic fleet machinery: warm standby pool + the elasticity plane
(port of ``dvf_tpu.fleet.elastic``).

Two pieces, both owned by :class:`~dvf_tpu_torch.fleet.router.FleetFrontend`
when ``FleetConfig.autoscale`` is armed:

:class:`StandbyPool`
    What makes ``spawn_replica()`` cheap enough to be a control action.
    A cold replica spawn is seconds of work — process spawn, torch
    import and CUDA context, then a compile per signature — which is
    exactly the window an overload burst needs to blow p99. The pool
    keeps ``warm_target`` replicas PRE-SPAWNED and PRECOMPILED (the
    ``--precompile`` manifest) but not yet serving; adopting one into
    the fleet is a dictionary insert plus session placement. A
    background refill thread replaces taken standbys, so the pool is
    warm again before the controller's cooldown expires.

:class:`ElasticFleetPlane`
    The loop wiring (the `control.plane.ControlPlane` discipline one
    tier up): hangs the deterministic
    `control.fleet_elastic.FleetElasticityController` off the fleet
    telemetry ring's ``on_sample`` seam, composes each flat row with
    the fleet's RPC-free ``elastic_view()``, decides inline on the
    sampler, and applies on a dedicated thread — a spawn that does end
    up cold-compiling (pool empty, multihost group bring-up) must
    never stall the sampling cadence the next decision reads. Keeps a
    bounded decision log AND the composed-row window, so the whole
    scaling episode replays deterministically from the recorded rows
    (the bench's ``replay.match`` acceptance).

Leak discipline: standby replicas are REAL worker processes (or live
frontends in local mode) that exist before any session does, so a pool
that outlives its fleet is a leaked child. ``live_standby_handles()``
is the conftest session-end guard's registry, the
``live_worker_processes`` pattern extended to standbys.
"""

from __future__ import annotations

import collections
import queue
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional

from dvf_tpu_torch.control.controllers import Action
from dvf_tpu_torch.control.fleet_elastic import (
    FLAVOR_DEFAULT,
    ElasticConfig,
    make_elasticity_controller,
)
from dvf_tpu_torch.fleet.replica import ReplicaHandle

# Live pools, for the conftest leak guard (weak: a collected pool's
# standbys were stopped by its owner or are already counted as leaked
# worker processes).
_LIVE_POOLS: "weakref.WeakSet[StandbyPool]" = weakref.WeakSet()


def live_standby_handles() -> List[ReplicaHandle]:
    """Warm standby replicas still held by un-stopped pools — the
    conftest session-end leak guard's registry (a standby outliving
    ``FleetFrontend.stop()`` is a leaked child)."""
    out: List[ReplicaHandle] = []
    for pool in list(_LIVE_POOLS):
        if not pool.closed:
            out.extend(pool.peek())
    return out


class StandbyPool:
    """Pre-spawned, AOT-warm replicas awaiting adoption (module
    docstring). ``spawn_fn()`` allocates a replica id, builds the
    handle, and must return it UNSTARTED — the pool pays the start
    (process spawn + torch import + precompile) on its own refill thread so
    neither the caller nor the elastic apply thread ever does."""

    def __init__(self, spawn_fn: Callable[[], ReplicaHandle],
                 warm_target: int = 1):
        if warm_target < 1:
            raise ValueError("warm_target must be >= 1")
        self._spawn = spawn_fn
        self.warm_target = warm_target
        self.spawned_total = 0
        self.taken_total = 0
        self.spawn_errors_total = 0
        self._ready: "collections.deque[ReplicaHandle]" = collections.deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.closed = False
        _LIVE_POOLS.add(self)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "StandbyPool":
        if self._thread is not None:
            raise RuntimeError("standby pool already started")
        self._thread = threading.Thread(
            target=self._refill_loop, name="dvf-fleet-standby", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 15.0) -> None:
        self.closed = True
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        while True:
            with self._lock:
                if not self._ready:
                    break
                h = self._ready.popleft()
            try:
                h.stop(timeout=timeout)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    # -- the pool ---------------------------------------------------------

    def take(self) -> Optional[ReplicaHandle]:
        """Pop one warm, already-started replica (None when the pool is
        momentarily dry — the caller falls back to a cold spawn) and
        wake the refill so the next take finds the pool warm again."""
        with self._lock:
            h = self._ready.popleft() if self._ready else None
            if h is not None:
                self.taken_total += 1
        self._wake.set()
        return h

    def peek(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._ready)

    @property
    def warm_count(self) -> int:
        with self._lock:
            return len(self._ready)

    def stats(self) -> dict:
        with self._lock:
            return {
                "warm": len(self._ready),
                "warm_target": self.warm_target,
                "spawned_total": self.spawned_total,
                "taken_total": self.taken_total,
                "spawn_errors_total": self.spawn_errors_total,
            }

    # -- refill thread ----------------------------------------------------

    def _refill_loop(self) -> None:
        backoff = 0.5
        while not self._stop.is_set():
            if self.warm_count >= self.warm_target:
                self._wake.wait(0.25)
                self._wake.clear()
                continue
            try:
                h = self._spawn()
                h.start()
            except Exception:  # noqa: BLE001 — a failed warm spawn is
                # retried with backoff; the fleet still works, spawns
                # are just cold until the pool recovers
                self.spawn_errors_total += 1
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 8.0)
                continue
            backoff = 0.5
            adopted = False
            with self._lock:
                if not self.closed:
                    self._ready.append(h)
                    self.spawned_total += 1
                    adopted = True
            if not adopted:
                # stop() raced the start: this standby would leak past
                # the sweep above — tear it down here instead.
                try:
                    h.stop(timeout=10.0)
                except Exception:  # noqa: BLE001
                    pass


class ElasticFleetPlane:
    """Controller wiring for one fleet (module docstring)."""

    def __init__(self, fleet: Any, config: Optional[ElasticConfig] = None,
                 decision_log: int = 256, record_window: int = 4096):
        self.fleet = fleet
        self.config = config or ElasticConfig()
        # Predictive (feed-forward) vs reactive is a config bit, decided
        # in ONE place so replay tooling rebuilds the same controller.
        self.controller = make_elasticity_controller(self.config)
        self._prev_row: Optional[dict] = None
        self._lock = threading.Lock()
        self.scale_out_total = 0
        self.scale_in_total = 0
        self.scale_errors_total = 0
        self.saturations_total = 0
        self.relay_out_total = 0
        self.relay_in_total = 0
        self.decisions: "collections.deque" = collections.deque(
            maxlen=decision_log)
        # The composed-row window + emitted actions: the deterministic
        # replay substrate (bench acceptance — a fresh controller over
        # ``window`` must reproduce ``actions`` byte-identically).
        self.window: "collections.deque[dict]" = collections.deque(
            maxlen=record_window)
        self.actions: "collections.deque[tuple]" = collections.deque(
            maxlen=record_window)
        self._apply_q: "queue.Queue[Optional[Action]]" = queue.Queue()
        self._apply_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ElasticFleetPlane":
        if self._apply_thread is not None:
            raise RuntimeError("elastic plane already started")
        self._stop.clear()
        self._apply_thread = threading.Thread(
            target=self._apply_loop, name="dvf-fleet-elastic-apply",
            daemon=True)
        self._apply_thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._apply_q.put(None)
        if self._apply_thread is not None:
            self._apply_thread.join(timeout=timeout)
            self._apply_thread = None

    # -- the ring seam ----------------------------------------------------

    def on_sample(self, prev: Optional[dict], cur: dict) -> None:
        """TimeSeriesRing hook: compose the fleet control row, decide,
        queue. The ring contains hook exceptions (``hook_errors_total``)
        but decide() is total by construction. ``desired`` moves at
        ENQUEUE time, not at apply completion: a spawn takes real wall
        time even warm, and the controller must see its own intent in
        the next row rather than double-firing into the gap."""
        del prev  # the controller tracks its own prev (replay parity)
        row = dict(cur)
        row.update(self.fleet.elastic_view())
        for a in self.decide(row):
            if a.kind in ("scale_out", "scale_in"):
                self.fleet.set_desired_replicas(int(a.value))
            self._apply_q.put(a)

    def decide(self, row: dict) -> List[Action]:
        """One deterministic decision step over a composed row; records
        the row and any actions for replay. Safe to call directly with
        recorded rows — the bench's replay harness does, through a
        FRESH controller."""
        prev = self._prev_row
        actions = self.controller.step(row, prev)
        self._prev_row = row
        with self._lock:
            self.window.append(dict(row))
            for a in actions:
                self.actions.append((a.kind, a.target, a.value, a.reason))
                self.decisions.append({"kind": a.kind, "target": a.target,
                                       "value": a.value, "reason": a.reason})
        return actions

    def replay_window(self) -> dict:
        """The recorded (composed rows, emitted actions) pair — what
        the bench replays through a fresh controller to prove the run
        is reproducible from its telemetry window."""
        with self._lock:
            return {"rows": [dict(r) for r in self.window],
                    "actions": list(self.actions)}

    # -- apply side -------------------------------------------------------

    def _apply_loop(self) -> None:
        while not self._stop.is_set():
            a = self._apply_q.get()
            if a is None:
                continue
            try:
                self._apply(a)
            except Exception:  # noqa: BLE001 — one failed scale action
                # must not kill the loop; counted, visible in stats
                with self._lock:
                    self.scale_errors_total += 1

    def _apply(self, a: Action) -> None:
        fleet = self.fleet
        if a.kind == "scale_out":
            flavor = None if a.target in (None, FLAVOR_DEFAULT) else a.target
            try:
                fleet.spawn_replica(flavor=flavor, cause="autoscale",
                                    reason=a.reason)
            except Exception:
                with self._lock:
                    self.scale_errors_total += 1
                fleet.rollback_desired(-1)
                return
            with self._lock:
                self.scale_out_total += 1
        elif a.kind == "scale_in":
            ok = False
            try:
                ok = fleet.retire_replica(a.target, cause="autoscale",
                                          reason=a.reason)
            finally:
                if not ok:
                    fleet.rollback_desired(+1)
            if ok:
                with self._lock:
                    self.scale_in_total += 1
        elif a.kind == "relay_out":
            # Third axis: a relay-only egress replica — no desired-
            # replicas bookkeeping to roll back (relays never count
            # against the filter-replica bounds).
            try:
                fleet.spawn_broadcast_relay(cause="autoscale",
                                            reason=a.reason)
            except Exception:
                with self._lock:
                    self.scale_errors_total += 1
                return
            with self._lock:
                self.relay_out_total += 1
        elif a.kind == "relay_in":
            if fleet.retire_broadcast_relay(a.target, cause="autoscale",
                                            reason=a.reason):
                with self._lock:
                    self.relay_in_total += 1
        elif a.kind == "flight":
            with self._lock:
                self.saturations_total += 1
            fleet.flight_trip(a.reason)

    # -- observability ----------------------------------------------------

    def signals(self) -> Dict[str, float]:
        """Flat counters for the fleet's ``signals()`` export."""
        with self._lock:
            return {
                "scale_out_total": float(self.scale_out_total),
                "scale_in_total": float(self.scale_in_total),
                "scale_errors_total": float(self.scale_errors_total),
                "scale_saturations_total": float(self.saturations_total),
                "relay_out_total": float(self.relay_out_total),
                "relay_in_total": float(self.relay_in_total),
            }

    def stats(self) -> dict:
        sig = self.signals()
        with self._lock:
            return {
                **{k: int(v) for k, v in sig.items()},
                "pending_applies": self._apply_q.qsize(),
                "window_rows": len(self.window),
                "decisions": list(self.decisions)[-32:],
            }
