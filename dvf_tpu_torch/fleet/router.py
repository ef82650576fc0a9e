"""The fleet front door: N engine replicas behind one serving API (port
of ``dvf_tpu.fleet.router``).

``FleetFrontend`` is the scale-out tier ABOVE ``serve.ServeFrontend``:
the same open/submit/poll/close/stats surface, but backed by N complete
replicas (each a frontend + engine, in-process on one device or in its
own process — `fleet.replica`). What the fleet adds over one
frontend:

**Session affinity.** A session is bound to one replica at open and every
one of its frames goes there — per-session index monotonicity needs one
reorder buffer, so affinity is correctness, not just cache-friendliness.
The fleet owns the *client-visible* index space (submit assigns fleet
indices, carried through the replica as the slot ``tag`` exactly like the
ZMQ bridge carries remote indices), so a session keeps its index space
across a replica migration.

**Spillover admission.** Opens place on the least-loaded healthy replica
and spill to the next when a replica's own gate refuses; the fleet
rejects only when every healthy replica has (`fleet.admission`).

**Replica health + supervised replacement.** A monitor thread polls
liveness and each replica's ``health()`` export (fed by the serving
supervisor: a frontend that exhausted a fault budget or declared its
engine unrecoverable reads ``ok: False``). A lost or unhealthy replica is
DRAINED — no new sessions, bound sessions migrate to surviving replicas
(their delivered tail is salvaged when the replica is still reachable;
frames in flight on a dead one are gone: the reference's at-most-once
semantics, now one level up) — then restarted and rejoined, bounded by
``max_restarts``. Losses are classified as ``replica`` faults,
attributed per replica (`resilience.faults`), and injectable via the
``replica`` chaos site (`resilience.chaos`).

**Fleet stats.** Per-replica exports merge into one view: weighted
latency snapshots → fleet p50/p99 (``LatencyStats.merge_snapshots``),
fault summaries → one table with ``by_replica`` attribution
(`fleet.stats`).

**The device.** ``FleetFrontend(..., device=None)`` runs every replica on
the card (``cuda:0`` unless the caller names the CPU) and raises without
CUDA, as ``ServeFrontend`` does. Local replicas partition the local cards
(``_replica_devices``: ``devices_per_replica`` each, else an equal share
of at least one) and each runs its engines over a mesh of its slice, so
on one card every local replica shares it, each with its own engines,
streams and slabs; process replicas run on one device each, named in
their wire config. The multi-host flavor (``multihost_hosts >= 2``) is
a process group of that many members behind one replica
(``fleet.multihost``), member *i* on ``cuda:{i % device_count}``, or on
the CPU when the fleet runs there.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dvf_tpu_torch.control.controllers import TIER_BATCH, TIER_NAMES
from dvf_tpu_torch.fleet.admission import SpilloverAdmission
from dvf_tpu_torch.fleet.replica import (
    DEAD,
    DRAINING,
    HEALTHY,
    RESTARTING,
    LocalReplica,
    ProcessReplica,
    ReplicaHandle,
    ReplicaLostError,
)
from dvf_tpu_torch.fleet.stats import (
    merge_fault_summaries,
    merge_latency_snapshots,
    replica_row,
)
from dvf_tpu_torch.obs.audit import DivergenceDetector
from dvf_tpu_torch.obs.export import FlightRecorder, attach_fleet_provider
from dvf_tpu_torch.obs import ledger as ledger_mod
from dvf_tpu_torch.obs.ledger import ReconfigLedger
from dvf_tpu_torch.obs.registry import MetricsRegistry, TimeSeriesRing
from dvf_tpu_torch.obs.trace import Tracer, merge_tracer_snapshots
from dvf_tpu_torch.resilience.continuity import (
    ContinuityStats,
    ReplayRing,
    atomic_write_json,
    check_resume_token,
    load_json,
    make_resume_token,
    new_secret,
)
from dvf_tpu_torch.resilience.faults import FaultError, FaultKind, FaultStats
from dvf_tpu_torch.runtime.engine import resolve_device
from dvf_tpu_torch.serve import ServeConfig
from dvf_tpu_torch.serve.session import (
    AdmissionError,
    Delivery,
    ServeError,
    SessionClosedError,
)

FLEET_MODES = ("local", "process")


@dataclasses.dataclass
class FleetConfig:
    replicas: int = 2
    mode: str = "local"           # "local": in-process frontends (one
    #   torch runtime, replica i on device i % device_count); "process":
    #   one child process per replica (own torch runtime and CUDA
    #   context, own GIL — the scale-out shape)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    #   per-replica frontend template (replica_label is stamped per
    #   replica; chaos stays fleet-level — see chaos/chaos_spec below)
    filter_spec: Optional[Tuple[str, dict]] = None  # (name, kwargs) for
    #   process replicas, which rebuild the filter from the registry
    #   (closures don't pickle); optional sugar for local mode too
    health_poll_s: float = 0.25   # monitor cadence (liveness + health())
    max_restarts: int = 2         # per replica, before it stays DEAD
    migrate: bool = True          # move a lost replica's sessions to
    #   survivors (False: they close; the client sees SessionClosedError)
    devices_per_replica: int = 0  # local mode: devices per replica
    #   (its engines span a mesh over them); 0 = an equal share of the
    #   local cards, at least one
    replica_env: Dict[str, str] = dataclasses.field(default_factory=dict)
    #   process mode: extra env for workers (CUDA_VISIBLE_DEVICES is
    #   how a deployment gives each process replica its own card)
    pin_replicas_to_cores: bool = False  # process mode: pin replica i to
    #   CPU core i (round-robin over this process's affinity mask) — the
    #   CPU stand-in for "each replica owns its device": without it one
    #   replica's intra-op thread pool spreads over every core and an
    #   N-replica fleet has nothing left to scale into
    startup_timeout_s: float = 120.0
    rpc_timeout_s: float = 60.0
    rpc_op_timeout_s: float = 5.0   # bounded control-plane RPCs (health
    #   probe, begin_drain): the socket deadline for ops the monitor
    #   must never sit behind (previously a hardcoded constant inside
    #   ProcessReplica — promoted so a deployment with slow replicas can
    #   widen it; exported in stats()["fleet"] provenance)
    rpc_lock_timeout_s: float = 5.0  # channel-lock bound for the same
    #   ops: how long a probe/stats pull may queue behind a busy submit
    #   before degrading to "try next tick" instead of wedging
    drain_timeout_s: float = 10.0
    max_retired: int = 64         # closed sessions kept poll-able; the
    #   oldest (and its salvaged tail frames) evicted beyond this —
    #   serve's retention discipline, mirrored: a churning fleet must
    #   not pin every dead session's tail forever
    chaos: Any = None             # fleet-level FaultPlan: the "replica"
    #   site fires in the health monitor (one event per replica per
    #   tick); per-replica serve-level chaos rides chaos_spec instead so
    #   each replica owns a deterministic plan of its own
    chaos_spec: Optional[str] = None
    chaos_seed: int = 0
    telemetry_sample_s: float = 0.0  # >0: fleet-level TimeSeriesRing of
    #   RPC-free front-door signals (placements, losses, healthy count)
    #   behind the /timeseries endpoint; per-replica signal windows live
    #   in each replica's own ring (serve.telemetry_sample_s)
    flight_dir: Optional[str] = None  # fleet flight recorder: a replica
    #   loss or a replica-side watchdog trip (stalls delta in health())
    #   dumps merged per-replica traces + fleet stats here. None = off.
    flight_min_interval_s: float = 10.0
    flight_max_total_bytes: Optional[int] = 256 * 1024 * 1024  # on-disk
    #   bound across dumps (oldest evicted; None = count cap only)
    tier_guard_frac: float = 0.85  # fleet-level tier-aware admission:
    #   batch-tier (tier >= 2) opens are refused once fleet-wide bound
    #   sessions reach this fraction of total healthy capacity
    #   (healthy replicas × serve.max_sessions) — the remaining slots
    #   are headroom reserved for interactive/standard tenants. 0
    #   disables the guard. Batch-tier opens also BIN-PACK (fullest
    #   admitting replica first) so empty replicas stay empty for
    #   high-priority arrivals; replica-local admission floors (the
    #   serve control plane) additionally push refused low-tier opens
    #   to replicas with headroom via ordinary spillover.
    precompile: Optional[list] = None  # --precompile manifest entries
    #   (runtime.signature.parse_manifest input): every replica AOT-
    #   compiles these at start — and again at RESPAWN, where the
    #   persistent compilation cache turns it into deserializes — so
    #   each signature's first real admission fleet-wide is a pool hit
    autoscale: Optional[Tuple[int, int]] = None  # (min, max) replicas:
    #   arms the elasticity loop (CLI --autoscale min:max) — a
    #   FleetElasticityController over the fleet telemetry ring drives
    #   spawn_replica()/retire_replica() between these bounds. The
    #   initial replica count is ``replicas`` clamped into the bounds.
    #   None = the fleet stays at ``replicas`` unless told otherwise.
    elastic: Any = None           # control.fleet_elastic.ElasticConfig
    #   overriding the controller knobs (min/max still come from
    #   ``autoscale`` when both are set); None = defaults
    standby_warm: int = 0         # warm standby pool size: replicas
    #   pre-spawned and AOT-precompiled (fleet.elastic.StandbyPool) so
    #   a scale-out is session-rebind time, not a cold spawn. Works
    #   with or without autoscale (manual spawn_replica() takes from
    #   the pool too). 0 = no pool, spawns are cold.
    audit_interval_s: float = 0.0  # > 0: the cross-replica divergence
    #   detector (obs.audit) runs on the monitor thread at this cadence
    #   — an identical deterministic probe frame through every healthy
    #   replica warm on a shared signature, output digests compared; a
    #   diverging replica is flagged (audit events + a flight dump) and
    #   — with audit_quarantine — retired through the retire_replica
    #   seam. 0 = manual only (audit_divergence_check()).
    audit_quarantine: bool = False  # flagged divergent replicas are
    #   drained and retired (the existing scale-in machinery) instead
    #   of just flagged — a replica provably computing WRONG pixels
    #   has no business taking traffic
    state_path: Optional[str] = None  # continuity plane: the
    #   front door periodically snapshots its session registry,
    #   placement map, and each process replica's incarnation (pid +
    #   reattach port) to this file — crash-consistent (atomic tmp +
    #   rename), so a kill -9 at any instant leaves a loadable
    #   document. None = the continuity snapshot plane is off.
    snapshot_interval_s: float = 1.0  # snapshot cadence (state_path set)
    resume_state: bool = False    # start() re-adopts still-live process
    #   replicas (and their open sessions) from state_path instead of
    #   spawning cold — the recovery half of the snapshot plane. A
    #   replica whose worker died (or whose reattach grace expired)
    #   falls back to a cold start; its sessions are gone with it.
    reattach_grace_s: float = 30.0  # how long an orphaned worker waits
    #   on its reattach listener for a restarted front door before
    #   shutting itself down (armed only when state_path is set —
    #   without a snapshot nobody can ever adopt it)
    autoplan: bool = False        # auto-plan plane at the front door:
    #   apply the CACHED plan for the dominant signature (the first
    #   --precompile manifest entry — same convention as the multihost
    #   pin) to the serve template before any replica spawns, so every
    #   replica inherits the measured operating point; a cache miss
    #   falls back to the analytic plan (never a live search — a fleet
    #   start must not hold N replicas hostage to a measurement run,
    #   and an analytic guess is never cached). Also arms the
    #   PREDICTIVE elasticity controller (slope-projected scale-out)
    #   when autoscale is on. Plan/calibration cache dir rides
    #   serve.plan_cache_dir.
    multihost_hosts: int = 0      # >= 2 arms the BIGGER-replica axis:
    #   a spawn_replica(flavor="multihost") builds one replica whose
    #   worker is a MultiHostEngine process group of this many members
    #   (torch.distributed over gloo, one program over the group's rows),
    #   pinned to the first --precompile manifest signature (the group
    #   compiles ONE program — the manifest names it). 0 = the
    #   controller's two-axis choice always picks more-replicas.


class _FleetSession:
    """Fleet-side record of one client session: its replica binding, the
    client-visible index space, and the migration bookkeeping."""

    __slots__ = ("sid", "replica_id", "replica_sid", "generation",
                 "next_index", "last_index", "slo_ms", "frame_shape",
                 "frame_dtype", "op_chain", "tier", "lock", "tail",
                 "migrations", "lost", "polled", "closed", "orphaned",
                 "load_counted", "replay")

    def __init__(self, sid: str, replica_id: str, slo_ms, frame_shape,
                 frame_dtype, op_chain=None, tier=None,
                 replay_window: int = 0):
        self.sid = sid
        self.replica_id = replica_id
        self.replica_sid = sid           # sid@gN after migrations
        self.generation = 0
        self.next_index = 0              # fleet-owned index space
        self.last_index = -1             # monotonicity watermark (poll)
        self.slo_ms = slo_ms
        self.frame_shape = frame_shape   # declared at open (may be None)
        self.frame_dtype = frame_dtype
        self.op_chain = op_chain         # declared chain — a migration
        #   re-declares it so the survivor routes to the same bucket
        self.tier = tier                 # priority tier — controller
        #   state that SURVIVES migration: re-declared at the migration
        #   open, so the survivor's control plane sheds this session in
        #   the same order the lost replica's would have
        self.lock = threading.Lock()
        self.tail: List[Delivery] = []   # salvaged pre-migration deliveries
        self.migrations = 0
        self.lost = 0                    # submits dropped on a lost replica
        self.polled = 0                  # deliveries handed to the client
        self.closed = False
        self.orphaned = False            # no replica could take it
        self.load_counted = True         # guards double-decrement
        self.replay = (ReplayRing(replay_window) if replay_window > 0
                       else None)        # delivered-tail ring, FLEET
        #   index space — lives in the fleet session record, so it
        #   survives replica migration (the replica-side ring dies with
        #   the replica) and serves resume_stream() replays


class FleetFrontend:
    """N-replica serving tier behind one front door (module docstring)."""

    def __init__(self, filt=None, config: Optional[FleetConfig] = None,
                 device=None):
        """``device`` is where every replica runs: ``cuda:0`` unless
        the caller names the CPU (``device="cpu"``: the tests); it
        raises where there is no CUDA, as ``ServeFrontend`` does."""
        self.config = config or FleetConfig()
        self.device = resolve_device(device)
        if self.config.mode not in FLEET_MODES:
            raise ValueError(
                f"mode must be one of {FLEET_MODES}, got "
                f"{self.config.mode!r}")
        if self.config.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.config.mode == "process" and self.config.filter_spec is None:
            raise ValueError(
                "process mode needs filter_spec=(name, kwargs): a filter "
                "object's closures cannot cross the process boundary")
        if filt is None:
            if self.config.filter_spec is None:
                raise ValueError("need a filter or config.filter_spec")
            from dvf_tpu_torch.ops import get_filter

            name, kwargs = self.config.filter_spec
            filt = get_filter(name, **(kwargs or {}))
        self.filter = filt
        self.faults = FaultStats()        # fleet-observed faults (replica
        #   losses), attributed per replica via record(..., replica=)
        self.admission = SpilloverAdmission()
        self.replica_losses = 0
        self.migrated_sessions = 0
        self.orphaned_sessions = 0
        self.order_violations = 0         # should stay 0: the affinity +
        #   migration protocol guarantees per-session index monotonicity
        self.scale_outs = 0               # applied spawn_replica calls
        self.scale_ins = 0                # applied retire_replica calls
        self.standby_adoptions = 0        # scale-outs served warm (the
        #   standby pool had a pre-spawned replica ready)
        self.rollouts = 0                 # completed rolling_rollout calls
        self.rollout_swaps = 0            # replicas replaced across them
        # -- continuity plane: resume tokens + crash recovery.
        # The signing secret rides the state snapshot, so tokens issued
        # by a previous front-door incarnation still verify after a
        # --resume-state restart.
        self.continuity = ContinuityStats()
        self._token_secret = new_secret()
        self._snapshot_thread: Optional[threading.Thread] = None
        self._snapshot_stop = threading.Event()
        self._replicas: "Dict[str, ReplicaHandle]" = {}
        self._load: Dict[str, int] = {}
        self._replica_load: Dict[str, dict] = {}  # per-replica load rows
        #   (ServeFrontend.load_row via the health RPC), cached by the
        #   monitor so signals()/elastic_view() stay RPC-free
        self._retiring: set = set()       # replica ids mid-retire (the
        #   scale-in path owns their lifecycle; the loss monitor must
        #   not race a second drain/restart onto them)
        self._sessions: Dict[str, _FleetSession] = {}
        self._retired: Dict[str, _FleetSession] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()       # session/load registries
        self._open_lock = threading.Lock()  # serializes placements
        self._loss_lock = threading.Lock()  # serializes loss handling
        self._scale_lock = threading.Lock()  # serializes spawn/retire
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._started = False
        # -- telemetry plane: front-door tracer (lifecycle instants — the
        # replica lanes come from the replicas' own tracers via
        # trace_snapshots), metrics registry, signal window, flight
        # recorder, and the per-replica stall watermark the monitor uses
        # to turn a replica-side watchdog trip into a fleet-level dump.
        self.tracer = Tracer(enabled=self.config.serve.trace,
                             process_name="fleet")
        self.registry = MetricsRegistry()
        attach_fleet_provider(self.registry, self)
        # Fleet-tier reconfiguration ledger (obs.ledger): replica
        # spawn/retire/restart land here with their causes and measured
        # wall costs (the per-replica compile/resize events live in
        # each replica's OWN ledger, which rides its stats_full RPC).
        self.ledger: Optional[ReconfigLedger] = None
        if self.config.serve.ledger:
            self.ledger = ReconfigLedger(tracer=self.tracer, track=1)
        # -- audit plane, fleet detector (obs.audit): cross-replica
        # divergence — probe-digest comparison over the healthy
        # replicas, flagged replicas optionally retired through the
        # scale-in seam. Always constructed (cheap counters; the /audit
        # endpoint and the manual check work without a cadence);
        # audit_interval_s > 0 runs it from the monitor thread.
        self.divergence = DivergenceDetector(
            tracer=self.tracer, ledger=self.ledger,
            flight_cb=self._dump_async,
            quarantine_cb=lambda rid: self.retire_replica(
                rid, cause="audit",
                reason="cross-replica divergence quarantine"))
        self._last_audit_check = 0.0
        # -- elasticity plane: controller + standby pool. The
        # plane must exist before the ring so the ring's on_sample hook
        # can point at it; an armed autoscale implies the ring (the
        # controller is blind without a window), at the elastic cadence
        # unless something armed a faster one already.
        self.desired = self.config.replicas
        self.elastic = None
        elastic_cfg = None
        if self.config.autoscale is not None:
            from dvf_tpu_torch.control.fleet_elastic import ElasticConfig
            from dvf_tpu_torch.fleet.elastic import ElasticFleetPlane

            lo, hi = (int(self.config.autoscale[0]),
                      int(self.config.autoscale[1]))
            if not 1 <= lo <= hi:
                raise ValueError(
                    f"autoscale bounds must satisfy 1 <= min <= max, "
                    f"got {self.config.autoscale!r}")
            base = self.config.elastic or ElasticConfig()
            if self.config.autoplan and not base.predictive:
                # Feed-forward elasticity is the auto-plan plane's
                # fleet leg: project queue/occupancy growth from the
                # telemetry slope and spawn BEFORE refusals advance
                # (reactive pressure still wins whenever it fires
                # first — control.fleet_elastic).
                base = dataclasses.replace(base, predictive=True)
            elastic_cfg = dataclasses.replace(
                base, min_replicas=lo, max_replicas=hi)
            self.desired = min(max(self.config.replicas, lo), hi)
            self.elastic = ElasticFleetPlane(self, elastic_cfg)
        self.telemetry: Optional[TimeSeriesRing] = None
        sample_s = self.config.telemetry_sample_s or (
            1.0 if self.config.flight_dir else 0.0)  # serve's rule: an
        #   armed flight recorder implies the window it dumps
        if elastic_cfg is not None:
            # The controller's sample-count knobs (out_after, in_after,
            # cooldowns) assume its cadence: a slower ring (the flight
            # recorder's 1 Hz default) would silently rescale them all,
            # so the elastic interval puts a CEILING on the period. An
            # explicitly faster telemetry_sample_s stays (documented on
            # ElasticConfig.interval_s — one ring, fastest consumer
            # wins).
            sample_s = (elastic_cfg.interval_s if sample_s <= 0
                        else min(sample_s, elastic_cfg.interval_s))
        if sample_s > 0:
            self.telemetry = TimeSeriesRing(
                self.signals,
                interval_s=sample_s,
                name="dvf-fleet-telemetry",
                on_sample=(self.elastic.on_sample
                           if self.elastic is not None else None))
        self.flight: Optional[FlightRecorder] = None
        if self.config.flight_dir:
            self.flight = FlightRecorder(
                self.config.flight_dir, label="fleet",
                min_interval_s=self.config.flight_min_interval_s,
                max_total_bytes=self.config.flight_max_total_bytes,
                trace_fn=self.trace_snapshots,
                stats_fn=self.stats,
                ring=self.telemetry,
                ledger_fn=(self.ledger.document
                           if self.ledger is not None else None),
                audit_fn=self.audit_document)
        self._stalls_seen: Dict[str, int] = {}
        # Per-replica warm-signature sets (canonical renders), fed by
        # the health monitor from each replica's health() export and
        # updated optimistically at successful declared opens — what
        # makes spillover admission SIGNATURE-AWARE: a declared open
        # prefers a replica whose pool already holds the program.
        self._warm: Dict[str, List[str]] = {}
        from dvf_tpu_torch.runtime.signature import canonical_op_chain_or_verbatim

        self._default_chain = canonical_op_chain_or_verbatim(self.filter.name)
        # Last-seen per-replica delivered_total: a transiently missing
        # export (busy channel → stats lock_timeout, replica mid-drain)
        # must not dip the fleet's delivered counter for one scrape —
        # rate() would read the dip+recovery as a reset+spike. A replica
        # RESTART still resets its share: that is the idiomatic counter
        # reset consumers already handle.
        self._delivered_seen: Dict[str, float] = {}
        # explain() freshness cache (see its docstring): one stats
        # fan-out per second however hard /explain is polled.
        self._explain_cache: dict = {
            "lineage": bool(self.config.serve.lineage), "replicas": {}}
        self._explain_cache_t = float("-inf")
        self._explain_cache_lock = threading.Lock()
        self._explain_refresh_lock = threading.Lock()
        # -- broadcast plane: fleet-level encode-once
        # fan-out. Built lazily at the first publish_stream(); pump
        # threads (one per published channel) own polling the
        # published session and tee its deliveries into the channel.
        self.broadcast: Any = None
        self._publish_pumps: Dict[str, dict] = {}
        self._pump_errors = 0
        self.relay_spawns = 0     # applied spawn_broadcast_relay calls
        self.relay_retires = 0    # applied retire_broadcast_relay calls
        # -- auto-plan plane: the front door applies a
        # cached (or analytic) plan BEFORE any replica exists, so every
        # replica — initial, respawn, standby, elastic spawn — inherits
        # the planned operating point through the serve template.
        self.applied_plan: Optional[dict] = None
        if self.config.autoplan:
            self._front_door_plan()
        for i in range(self.desired):
            rid = f"r{i}"
            self._replicas[rid] = self._make_replica(rid, i)
            self._load[rid] = 0
        self._rid_counter = itertools.count(self.desired)
        # Warm standby pool: pre-spawned AOT-warm replicas so a
        # scale-out is adoption, not a cold spawn (fleet.elastic).
        self.standby = None
        if self.config.standby_warm > 0:
            from dvf_tpu_torch.fleet.elastic import StandbyPool

            self.standby = StandbyPool(self._spawn_standby,
                                       warm_target=self.config.standby_warm)
        # Two-axis inputs, loaded ONCE at construction (the controller
        # is deterministic — no file reads inside the decision loop):
        # the dominant signature the multihost flavor would pin to (the
        # first --precompile manifest entry) and its measured device
        # cost from the stage profiles (--profile-dir).
        self._multihost_key = None
        self._profile_device_ms: Optional[float] = None
        if self.config.precompile:
            try:
                from dvf_tpu_torch.runtime.signature import parse_manifest

                entries = parse_manifest(self.config.precompile)
            except (ValueError, TypeError):
                entries = []
            if entries and self.config.multihost_hosts >= 2:
                self._multihost_key = entries[0]["key"]
            if entries and self.config.serve.profile_dir:
                from dvf_tpu_torch.obs.lineage import load_stage_profile

                device_ms = []
                for e in entries:
                    prof = load_stage_profile(
                        self.config.serve.profile_dir, e["key"].render())
                    comp = ((prof or {}).get("components_ms")
                            or {}).get("device") or {}
                    if comp.get("mean_ms") is not None:
                        device_ms.append(float(comp["mean_ms"]))
                if device_ms:
                    self._profile_device_ms = max(device_ms)

    def _front_door_plan(self) -> None:
        """Apply a cache-or-analytic plan to the serve TEMPLATE (config
        docstring: no live search at this tier, analytic guesses never
        cached). Plans the first --precompile manifest signature; with
        no manifest there is nothing to plan for and the hand-set
        template stands."""
        from dvf_tpu_torch.control import plan_cache as _pc
        from dvf_tpu_torch.control import planner as _planner

        entries = []
        if self.config.precompile:
            try:
                from dvf_tpu_torch.runtime.signature import parse_manifest

                entries = parse_manifest(self.config.precompile)
            except (ValueError, TypeError):
                entries = []
        if not entries:
            return
        key = entries[0]["key"]
        signature = key.render()
        geometry = tuple(key.geometry)
        topo = _pc.topology_fingerprint()
        scfg = self.config.serve
        t0 = time.perf_counter()
        plan = _planner.plan_from_cache(scfg.plan_cache_dir, signature,
                                        geometry, topo)
        cache = "hit"
        if plan is None:
            cache = "miss"
            cal = _pc.load_calibrations(
                scfg.plan_cache_dir, topo,
                f"b{scfg.batch_size}|{signature}")
            prof = None
            if scfg.profile_dir:
                from dvf_tpu_torch.obs.lineage import load_stage_profile

                prof = load_stage_profile(scfg.profile_dir, signature)
            grid = _planner.candidate_grid(batch_cap=scfg.batch_size)
            plan, _comp = _planner.plan_search(
                grid, None, cal=cal, cal_batch=scfg.batch_size,
                stage_profile=prof)
        # Replicas inherit by template mutation: every replica built
        # from here on compiles at the planned point. autoplan itself
        # stays OFF on replicas (_make_replica/_local_factory strip
        # it) — the front door planned; a replica re-searching under
        # live tenants would fight the plan it was handed.
        scfg.batch_size = plan.batch_size
        scfg.tick_s = plan.tick_s
        scfg.ingest_depth = plan.ingest_depth
        scfg.ingest = plan.ingest
        scfg.egress = plan.egress
        self.applied_plan = plan.to_doc()
        wall = (time.perf_counter() - t0) * 1e3
        if self.ledger is not None:
            self.ledger.record(
                ledger_mod.PLAN, cause=ledger_mod.CAUSE_AUTOPLAN,
                signature=signature, cache=cache,
                wall_ms=round(wall, 3), plan=plan.to_doc(),
                topology=topo, legs=0, grid=plan.grid)

    def _next_rid(self) -> str:
        return f"r{next(self._rid_counter)}"

    def _spawn_standby(self) -> ReplicaHandle:
        """StandbyPool's spawn hook: allocate the next replica id and
        build an UNSTARTED default-flavor handle (the pool's refill
        thread pays the start + precompile)."""
        rid = self._next_rid()
        return self._make_replica(rid, int(rid[1:]))

    # -- replica construction -------------------------------------------

    def _make_replica(self, rid: str, index: int) -> ReplicaHandle:
        if self.config.mode == "process":
            serve_fields = {
                f.name: getattr(self.config.serve, f.name)
                for f in dataclasses.fields(ServeConfig)
                if f.name not in ("chaos", "replica_label")
            }
            # The front door plans; a replica re-searching under live
            # tenants would fight it. plan_cache_dir stays — replicas
            # still seed their compile calibrations from it.
            serve_fields["autoplan"] = False
            affinity = None
            if self.config.pin_replicas_to_cores:
                if hasattr(os, "sched_getaffinity"):
                    cores = sorted(os.sched_getaffinity(0))
                    affinity = [cores[index % len(cores)]]
            return ProcessReplica(
                rid,
                wire_config={
                    "filter": self.config.filter_spec,
                    "serve": serve_fields,
                    "chaos_spec": self.config.chaos_spec,
                    "chaos_seed": self.config.chaos_seed + index,
                    "cpu_affinity": affinity,
                    "precompile": self.config.precompile,
                    # A replica_env that names the card leaves the child
                    # one visible device.
                    "device": ("cuda:0" if self.device.type == "cuda"
                               and "CUDA_VISIBLE_DEVICES"
                               in self.config.replica_env
                               else str(self._replica_device(index))),
                    # Orphaned-worker grace: armed only when the
                    # snapshot plane is on (without a snapshot nobody
                    # can ever come back to adopt this worker).
                    "reattach_grace_s": (self.config.reattach_grace_s
                                         if self.config.state_path
                                         else 0.0),
                },
                env=self.config.replica_env,
                startup_timeout_s=self.config.startup_timeout_s,
                rpc_timeout_s=self.config.rpc_timeout_s,
                rpc_op_timeout_s=self.config.rpc_op_timeout_s,
                rpc_lock_timeout_s=self.config.rpc_lock_timeout_s,
            )
        return LocalReplica(rid, self._local_factory(rid, index))

    def _replica_devices(self, index: int) -> List[torch.device]:
        """Replica ``index``'s slice of the local cards: N local replicas
        partition them, ``per = devices_per_replica or max(1, cards //
        replicas)`` each from a start index that wraps (one card: every
        replica shares ``cuda:0``). On the CPU the slice repeats the CPU
        ``per`` times (a virtual mesh). Raises when a replica asks for
        more cards than there are: a replica never spans fewer devices
        than it was configured for."""
        want = self.config.devices_per_replica
        if self.device.type != "cuda":
            return [self.device] * max(1, want)
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if want > len(devs):
            raise ValueError(
                f"devices_per_replica={want} needs {want} devices, have "
                f"{len(devs)}")
        per = want or max(1, len(devs) // self.config.replicas)
        start = (index * per) % len(devs)
        return [devs[(start + j) % len(devs)] for j in range(per)]

    def _replica_device(self, index: int) -> torch.device:
        """Process replica ``index``'s one device: the fleet's own on the
        CPU, else ``cuda:{index % device_count}`` (one card: every replica
        shares ``cuda:0``)."""
        if self.device.type != "cuda":
            return self.device
        return torch.device("cuda", index % torch.cuda.device_count())

    def _local_factory(self, rid: str, index: int):
        """Factory for one in-process replica: a frontend whose engines
        span this replica's slice of the local devices
        (``_replica_devices``), as a mesh of ``auto_mesh_config`` axes."""
        config = self.config

        def make():
            from dvf_tpu_torch.parallel.mesh import auto_mesh_config, make_mesh
            from dvf_tpu_torch.runtime.engine import Engine
            from dvf_tpu_torch.serve import ServeFrontend

            chaos = None
            if config.chaos_spec:
                from dvf_tpu_torch.resilience import FaultPlan

                chaos = FaultPlan.parse(config.chaos_spec,
                                        seed=config.chaos_seed + index)
            scfg = dataclasses.replace(config.serve, replica_label=rid,
                                       chaos=chaos, autoplan=False)
            chunk = self._replica_devices(index)
            engine = Engine(self.filter, chaos=chaos,
                            mesh=make_mesh(auto_mesh_config(len(chunk)),
                                           devices=chunk))
            fe = ServeFrontend(self.filter, scfg, engine=engine).start()
            if config.precompile:
                fe.precompile(config.precompile)
            return fe

        return make

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "FleetFrontend":
        if self._started:
            raise ServeError("fleet already started")
        self._started = True
        errors: List[BaseException] = []
        # Front-door crash recovery: a --resume-state start
        # loads the previous incarnation's snapshot, re-keys its token
        # secret, and re-ADOPTS every process replica whose worker is
        # still alive on its reattach listener — instead of spawning
        # cold over the top of it. Replicas the snapshot doesn't cover
        # (or whose worker died / grace expired) start cold as usual.
        state: Optional[dict] = None
        adoptable: Dict[str, dict] = {}
        if self.config.resume_state and self.config.state_path:
            state = load_json(self.config.state_path)
        if state is not None:
            secret = state.get("secret")
            if secret:
                try:
                    self._token_secret = bytes.fromhex(secret)
                except ValueError:
                    pass  # foreign snapshot: keep the fresh secret
            if self.config.mode == "process":
                from dvf_tpu_torch.fleet.replica import pid_alive

                for rid, row in (state.get("replicas") or {}).items():
                    if (rid in self._replicas and row.get("pid")
                            and row.get("reattach_port")
                            and pid_alive(int(row["pid"]))):
                        adoptable[rid] = row

        adopted: set = set()

        def boot(r: ReplicaHandle) -> None:
            row = adoptable.get(r.id)
            if row is not None:
                try:
                    r.adopt(int(row["pid"]), int(row["reattach_port"]))
                    adopted.add(r.id)
                    self.continuity.inc("adopted_replicas")
                    return
                except Exception:  # noqa: BLE001 — the worker died (or
                    pass           # its grace expired): cold start below
            try:
                r.start()
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=boot, args=(r,),
                                    name=f"dvf-fleet-boot-{r.id}")
                   for r in self._replicas.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self.stop()
            raise ServeError(f"fleet start failed: {errors[0]!r}") from errors[0]
        if state is not None:
            self._resume_sessions(state, adopted)
        if self.config.state_path:
            self._snapshot_stop.clear()
            self._snapshot_thread = threading.Thread(
                target=self._snapshot_loop, name="dvf-fleet-snapshot",
                daemon=True)
            self._snapshot_thread.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="dvf-fleet-health", daemon=True)
        self._monitor.start()
        if self.standby is not None:
            self.standby.start()
        if self.elastic is not None:
            self.elastic.start()
        if self.telemetry is not None:
            self.telemetry.start()
        return self

    def stop(self, timeout: float = 15.0) -> None:
        self._stop.set()
        self._wake.set()
        self._snapshot_stop.set()
        if self._snapshot_thread is not None:
            self._snapshot_thread.join(timeout=timeout)
            self._snapshot_thread = None
        if self.telemetry is not None:
            self.telemetry.stop()
        if self.elastic is not None:
            self.elastic.stop()
        # Broadcast before the replicas: the pumps poll sessions THROUGH
        # the front door, and relays/fan-out workers must be joined
        # before the conftest guard's sweep (dvf-fleet-bcast*,
        # dvf-bcast*).
        with self._lock:
            pumps = list(self._publish_pumps.values())
            self._publish_pumps.clear()
        for p in pumps:
            p["stop"].set()
        for p in pumps:
            p["thread"].join(timeout=timeout)
        if self.broadcast is not None:
            self.broadcast.stop(timeout=timeout)
        if self._monitor is not None:
            self._monitor.join(timeout=timeout)
            self._monitor = None
        if self.standby is not None:
            # Before the serving replicas: a standby outliving the
            # fleet is a leaked child (the conftest guard's contract).
            self.standby.stop(timeout=timeout)
        with self._scale_lock:
            # Exclude an in-flight spawn/retire: spawn_replica holds
            # this lock across its stop-check + insert, so by the time
            # we snapshot, the spawn either aborted on _stop or its
            # replica is in the dict for the sweep — no worker can
            # slip in between snapshot and join and outlive shutdown.
            threads = [threading.Thread(target=r.stop, args=(timeout,),
                                        name=f"dvf-fleet-stop-{r.id}")
                       for r in list(self._replicas.values())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)

    def __enter__(self) -> "FleetFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def crash(self) -> None:
        """Chaos/bench-only: die like ``kill -9`` on the FRONT DOOR.
        Every front-door thread stops, each process replica's RPC
        channel is dropped WITHOUT a stop op, and the child processes
        are abandoned ALIVE — exactly the wreckage a restarted
        ``FleetFrontend(resume_state=True)`` must re-adopt from the
        state snapshot. Local-mode replicas have no existence outside
        this process, so they degrade to a plain stop."""
        self._stop.set()
        self._wake.set()
        self._snapshot_stop.set()
        if self._snapshot_thread is not None:
            self._snapshot_thread.join(timeout=5.0)
            self._snapshot_thread = None
        if self.telemetry is not None:
            self.telemetry.stop()
        if self.elastic is not None:
            self.elastic.stop()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        with self._lock:
            pumps = list(self._publish_pumps.values())
            self._publish_pumps.clear()
        for p in pumps:
            p["stop"].set()
        if self.standby is not None:
            self.standby.stop(timeout=5.0)
        for r in list(self._replicas.values()):
            if isinstance(r, ProcessReplica):
                r.abandon()
            else:
                try:
                    r.stop(timeout=2.0)
                except Exception:  # noqa: BLE001 — crash teardown
                    pass

    # -- client API -----------------------------------------------------

    def open_stream(
        self,
        session_id: Optional[str] = None,
        slo_ms: Optional[float] = None,
        frame_shape: Optional[tuple] = None,
        frame_dtype: Any = None,
        op_chain: Optional[str] = None,
        tier: Optional[int] = None,
    ) -> str:
        """Admit one stream, signature-aware: a declared
        ``(op_chain, frame_shape, frame_dtype)`` prefers a replica whose
        program pool is already WARM for that canonical key (admission
        is a pool hit, not a compile), then least-loaded; cold admits
        and undeclared opens place least-loaded-first exactly as
        before. Spills over when a replica's own gate refuses; raises
        ``AdmissionError`` only when every healthy replica has — and
        the rejection enumerates the signatures the fleet CAN serve
        cheaply."""
        key_render = self._signature_render(op_chain, frame_shape,
                                            frame_dtype)
        low_tier = tier is not None and int(tier) >= TIER_BATCH
        with self._open_lock:
            sid = (session_id if session_id is not None
                   else f"fs{next(self._ids)}")
            with self._lock:
                if sid in self._sessions or sid in self._retired:
                    raise ServeError(f"session id {sid!r} already exists")
                load = dict(self._load)
                warm = {rid: list(v) for rid, v in self._warm.items()}
            if low_tier and self.config.tier_guard_frac > 0:
                # Tier-aware capacity guard: refuse batch tier while the
                # fleet is near capacity — the remaining slots are
                # reserved headroom for higher-priority arrivals.
                # list() snapshot: the elastic apply thread inserts/pops
                # replicas concurrently (one C-level call, GIL-atomic —
                # a bare generator over .values() would raise mid-scan).
                healthy = sum(1 for r in list(self._replicas.values())
                              if r.state == HEALTHY)
                cap = healthy * self.config.serve.max_sessions
                if cap and sum(load.values()) >= \
                        self.config.tier_guard_frac * cap:
                    self.admission.record_tier_rejection()
                    self.admission.record_rejection(
                        tier=tier if tier is not None
                        else self.config.serve.default_tier)
                    raise AdmissionError(
                        f"tier {tier} not admitted: fleet at "
                        f"{sum(load.values())}/{cap} bound sessions "
                        f"(>= {self.config.tier_guard_frac:g} guard) — "
                        f"remaining capacity is reserved for "
                        f"interactive/standard tiers")
            cands = self.admission.candidates(
                list(self._replicas.values()), load,
                warm=warm, key=key_render, prefer_packed=low_tier)
            if not cands:
                self.admission.record_rejection(
                    tier=tier if tier is not None
                    else self.config.serve.default_tier)
                raise AdmissionError("no healthy replicas in the fleet")
            hops = 0
            last_refusal: Optional[AdmissionError] = None
            for r in cands:
                born = r.started_at  # incarnation marker, see below
                try:
                    r.open_stream(sid, slo_ms=slo_ms,
                                  frame_shape=frame_shape,
                                  frame_dtype=frame_dtype,
                                  op_chain=op_chain, tier=tier)
                except AdmissionError as e:
                    last_refusal = e
                    hops += 1
                    continue
                except ReplicaLostError as e:
                    self._note_loss(r, e)
                    hops += 1
                    continue
                if hops:
                    self.admission.record_spillover(hops)
                if key_render is not None:
                    if key_render in set(warm.get(r.id) or ()):
                        self.admission.record_warm_placement()
                    with self._lock:
                        # Optimistic warm update: the replica compiled
                        # (or pool-hit) this signature just now — don't
                        # wait one health-poll period to route follow-up
                        # opens of the same key here.
                        kn = self._warm.setdefault(r.id, [])
                        if key_render not in kn:
                            kn.append(key_render)
                s = _FleetSession(sid, r.id, slo_ms, frame_shape,
                                  frame_dtype, op_chain=op_chain,
                                  tier=tier,
                                  replay_window=self.config.serve
                                  .replay_window)
                with self._lock:
                    self._sessions[sid] = s
                    self._load[r.id] = self._load.get(r.id, 0) + 1
                if r.state != HEALTHY or r.started_at != born:
                    # The replica was lost (or already replaced — fresh
                    # started_at) between the replica-side open and our
                    # registration, so the monitor's session snapshot
                    # missed this one: migrate it ourselves instead of
                    # handing the client a permanently stranded sid.
                    self._migrate(s, r, reachable=False)
                return sid
            self.admission.record_rejection(
                tier=tier if tier is not None
                else self.config.serve.default_tier)
            raise AdmissionError(
                f"every healthy replica refused this stream "
                f"({len(cands)} tried; last refusal: {last_refusal}); "
                f"warm signatures across the fleet: "
                f"{self._fleet_warm_signatures()}")

    def _signature_render(self, op_chain, frame_shape, frame_dtype
                          ) -> Optional[str]:
        """Canonical render of a declared signature (the warm-set match
        key); None when undeclared or unparseable (placement falls back
        to pure least-loaded — never a refusal from here)."""
        if frame_shape is None:
            return None
        try:
            from dvf_tpu_torch.runtime.signature import make_key

            return make_key(
                op_chain if op_chain is not None else self._default_chain,
                frame_shape, frame_dtype).render()
        except (ValueError, TypeError):
            return None

    def _fleet_warm_signatures(self) -> List[str]:
        with self._lock:
            out = set()
            for keys in self._warm.values():
                out.update(keys)
        return sorted(out)

    def submit(self, session_id: str, frame: np.ndarray,
               ts: Optional[float] = None, tag: Any = None) -> int:
        """Enqueue one frame; returns its FLEET index — the session's
        client-visible index space, owned here so it survives replica
        migration. A frame submitted while the session's replica is lost
        (pre-migration window) is dropped and counted (``lost``):
        freshness-first at-most-once, the same contract as every other
        drop bound in the system."""
        s = self._session(session_id)
        with s.lock:
            if s.closed or s.orphaned:
                raise SessionClosedError(
                    f"session {session_id!r} is closed"
                    + (" (orphaned by replica loss)" if s.orphaned else ""))
            idx = s.next_index
            s.next_index += 1
            if s.frame_shape is None:
                # Learn the geometry from the first frame: a later
                # migration re-declares it, so a survivor pinned to a
                # different signature refuses at the migration open
                # (clean orphan) instead of silently eating mismatched
                # frames forever.
                s.frame_shape = tuple(frame.shape)
                s.frame_dtype = frame.dtype
            r = self._replicas.get(s.replica_id)
            if r is None:
                # Binding raced a replica removal (scale-in edge): the
                # frame is dropped at-most-once; the next submit sees
                # the migrated binding.
                s.lost += 1
                return idx
            try:
                r.submit(s.replica_sid, frame, ts=ts, tag=(idx, tag))
            except ReplicaLostError as e:
                s.lost += 1
                self._note_loss(r, e)
            except (SessionClosedError, KeyError):
                # Replica-side close/forget raced a migration or replica
                # replacement; the frame is gone but the session lives
                # on its (re)bound replica.
                s.lost += 1
        return idx

    def poll(self, session_id: str,
             max_items: Optional[int] = None,
             meta_only: bool = False) -> list:
        """Pop completed deliveries (fleet index space). Salvaged
        pre-migration tail first, then the live replica. ``meta_only``
        drops the frame payloads — the fleet bench's counting mode, so
        measuring N replicas doesn't serialize N replicas' pixels
        through the front door."""
        s = self._session(session_id)
        # Continuity chaos sites model the CLIENT-facing wire, so they
        # wrap the fleet's bookkeeping: a net_partition costs this poll
        # its delivery opportunity (frames stay queued replica-side —
        # delay, never loss), while net_dup/net_reorder below mutate
        # only what the client sees (the replay ring and the
        # monotonicity watermark saw the clean stream).
        chaos = self.config.chaos
        if chaos is not None:
            try:
                chaos.fire("net_partition")
            except FaultError as e:
                self.continuity.inc("partitions")
                self.faults.record(FaultKind.PARTITION, e)
                if self.ledger is not None:
                    self.ledger.record(
                        ledger_mod.PARTITION,
                        cause=ledger_mod.CAUSE_RECOVERY,
                        sid=session_id, plane="fleet")
                return []
            try:
                chaos.fire("net_delay")   # delay_s rules sleep in fire()
            except FaultError:
                pass  # a raising net_delay rule degrades to a no-op —
                #   the site's contract is latency, not loss
        out: List[Delivery] = []
        with s.lock:
            if s.tail:
                take = (len(s.tail) if max_items is None
                        else min(max_items, len(s.tail)))
                out.extend(s.tail[:take])
                del s.tail[:take]
            want = None if max_items is None else max_items - len(out)
            if want is None or want > 0:
                if not s.orphaned:
                    # .get: a retired session may outlive its replica
                    # (scale-in removed it) — its salvaged tail above is
                    # all there is.
                    r = self._replicas.get(s.replica_id)
                    got = []
                    if r is not None:
                        try:
                            got = r.poll(s.replica_sid, want,
                                         meta_only=meta_only)
                        except (ReplicaLostError, KeyError) as e:
                            if isinstance(e, ReplicaLostError):
                                self._note_loss(r, e)
                            got = []
                    out.extend(self._map_deliveries(s, got, replica=r))
            if s.replay is not None:
                for d in out:
                    s.replay.push(d.index, d)
            for d in out:
                if d.index <= s.last_index:
                    self.order_violations += 1
                else:
                    s.last_index = d.index
            s.polled += len(out)
        if chaos is not None and out:
            out = chaos.dup("net_dup", out)
            out = chaos.reorder("net_reorder", out)
        return out

    def _map_deliveries(self, s: _FleetSession, got: list,
                        replica: Optional[ReplicaHandle] = None) -> list:
        """Replica deliveries → fleet deliveries: the fleet index rides
        the slot tag (ZMQ-bridge style); the user's tag comes back out.

        Frame lineage crossing the hop is RE-BASED onto the front
        door's clock (the replica's marks are wall-clock stamps on ITS
        clock; ``clock_offset_s`` is the health-RPC midpoint estimate —
        0 for in-process replicas) and then extended with the ``rpc``
        component: replica delivery → this poll's pickup, so the
        telescoping additivity (components sum to end-to-end latency)
        survives a ProcessReplica boundary."""
        offset = (replica.clock_offset_s if replica is not None else 0.0)
        now = None
        mapped = []
        for d in got:
            if isinstance(d.tag, tuple) and len(d.tag) == 2:
                fleet_idx, user_tag = d.tag
            else:  # untagged (shouldn't happen): fall back to replica idx
                fleet_idx, user_tag = d.index, d.tag
            lin = d.lineage
            if lin is not None:
                if offset:
                    lin.rebase(-offset)
                if now is None:
                    now = time.time()
                lin.mark("rpc", now)
            mapped.append(d._replace(index=fleet_idx, tag=user_tag))
        return mapped

    def close(self, session_id: str, drain: bool = True) -> None:
        s = self._session(session_id)
        with s.lock:
            s.closed = True
            self._uncount_load(s)
            if not s.orphaned:
                r = self._replicas.get(s.replica_id)
                if r is not None:
                    try:
                        r.close(s.replica_sid, drain=drain)
                    except (ReplicaLostError, KeyError) as e:
                        if isinstance(e, ReplicaLostError):
                            self._note_loss(r, e)
        self._retire(session_id, s)

    def _retire(self, session_id: str, s: _FleetSession) -> None:
        """Move a closed session to the bounded retired map (still
        poll-able for its tail until evicted or released)."""
        with self._lock:
            if self._sessions.pop(session_id, None) is not None:
                self._retired[session_id] = s
                while len(self._retired) > self.config.max_retired:
                    self._retired.pop(next(iter(self._retired)))

    def release(self, session_id: str) -> None:
        """Forget a session: drop its binding and its replica-side
        retained tail."""
        with self._lock:
            s = self._sessions.pop(session_id, None)
            if s is None:
                s = self._retired.pop(session_id, None)
        if s is None:
            return
        with s.lock:
            if not s.closed:
                raise ServeError(
                    f"session {session_id!r} is still open; close() first")
            s.tail.clear()
            if not s.orphaned:
                r = self._replicas.get(s.replica_id)
                if r is not None:
                    try:
                        r.release(s.replica_sid)
                    except (ReplicaLostError, KeyError, ServeError):
                        pass

    # -- continuity plane: resume tokens + delivered-tail replay ---------

    def resume_token(self, session_id: str) -> str:
        """Opaque resume credential for one session. The epoch is the
        session's migration generation at issue time (informational —
        verification keys on the MAC, so a token issued before a
        migration still resumes the session after it). Because the
        signing secret rides the state snapshot, tokens also survive a
        front-door crash + ``resume_state`` restart."""
        s = self._session(session_id)
        return make_resume_token(session_id, s.generation,
                                 self._token_secret)

    def resume_stream(self, session_id: str, token: str,
                      from_index: int = 0) -> list:
        """Replay the session's delivered tail from ``from_index``
        (fleet index space). A reconnecting client hands back its token
        plus the first index it has NOT seen; everything retained in
        the replay window comes back in index order — the client dedups
        by index, which upgrades at-most-once to effectively-exactly-
        once within the window. Raises ``ServeError`` on a bad token
        (wrong session, wrong incarnation without a snapshot, forged)."""
        s = self._session(session_id)
        epoch = check_resume_token(token, session_id, self._token_secret)
        if epoch is None:
            self.continuity.inc("resume_rejected")
            raise ServeError(
                f"resume rejected for session {session_id!r}: token "
                f"did not verify")
        replayed = ([] if s.replay is None
                    else [d for _, d in s.replay.replay_from(from_index)])
        self.continuity.inc("resumes")
        self.continuity.inc("replays")
        self.continuity.inc("replayed_frames", len(replayed))
        if self.ledger is not None:
            self.ledger.record(
                ledger_mod.RESUME, cause=ledger_mod.CAUSE_RECOVERY,
                sid=session_id, epoch=epoch, from_index=from_index,
                replayed=len(replayed))
        return replayed

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._sessions.values() if not s.closed)

    def _session(self, session_id: str) -> _FleetSession:
        with self._lock:
            s = (self._sessions.get(session_id)
                 or self._retired.get(session_id))
        if s is None:
            raise KeyError(f"unknown session {session_id!r}")
        return s

    def _uncount_load(self, s: _FleetSession) -> None:
        """Placement-load decrement, exactly once per session."""
        if s.load_counted:
            s.load_counted = False
            with self._lock:
                if self._load.get(s.replica_id, 0) > 0:
                    self._load[s.replica_id] -= 1

    # -- replica health + replacement -----------------------------------

    def _note_loss(self, r: ReplicaHandle, exc: BaseException) -> None:
        """Any thread observed a replica failure: wake the monitor,
        which owns the drain/migrate/restart procedure (and records the
        loss exactly once — a thousand failed submits against one dead
        replica is ONE replica fault, not a thousand)."""
        del exc
        self._wake.set()

    def _monitor_loop(self) -> None:
        chaos = self.config.chaos
        while not self._stop.is_set():
            self._wake.wait(self.config.health_poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            for r in list(self._replicas.values()):
                if self._stop.is_set():
                    return
                if r.state in (RESTARTING, DEAD) or r.id in self._retiring:
                    continue  # a mid-retire replica's lifecycle belongs
                    #   to retire_replica (its death there is at-most-
                    #   once salvage, not a loss to re-handle)
                if chaos is not None:
                    try:
                        chaos.fire("replica")
                    except Exception as e:  # noqa: BLE001 — ChaosFault
                        # Injected replica loss: make it REAL (a process
                        # replica dies for good) so recovery is exercised
                        # against an actually-unreachable peer.
                        r.kill()
                        self._handle_loss(r, e)
                        continue
                if not r.alive():
                    self._handle_loss(r, ReplicaLostError(
                        f"replica {r.id}: process/frontend died"))
                    continue
                try:
                    h = r.health()
                except ReplicaLostError as e:
                    self._handle_loss(r, e)
                    continue
                except Exception:  # noqa: BLE001 — transient RPC noise:
                    continue       # liveness will catch a real death
                if not h.get("ok", False):
                    self._handle_loss(
                        r, ServeError(f"replica {r.id} unhealthy: "
                                      f"{h.get('error')}"),
                        reachable=True)
                    continue
                # Replica-side truth about warm signatures (its program
                # pool + live buckets) refreshes the fleet's placement
                # map — the optimistic per-open updates converge to this.
                warm = h.get("warm_signatures")
                if warm is not None:
                    with self._lock:
                        self._warm[r.id] = list(warm)
                # Cache the replica's cheap load row: what keeps the
                # fleet signals()/elastic_view() RPC-free — the
                # elasticity controller reads THIS, one health poll old.
                load_row = h.get("load")
                if isinstance(load_row, dict):
                    with self._lock:
                        self._replica_load[r.id] = load_row
                # Replica-side watchdog trips surface in the health
                # export's stalls counter; a rising watermark is the
                # fleet-level flight trigger — the replica recovered on
                # its own (PR-4 supervision), but "p99 was blown at
                # 14:02" now has a merged-trace artifact.
                stalls = int(h.get("stalls") or 0)
                if stalls > self._stalls_seen.get(r.id, 0):
                    self._stalls_seen[r.id] = stalls
                    self.tracer.instant("replica_stall", track=0,
                                        replica=r.id, stalls=stalls)
                    self._dump_async(f"replica {r.id} watchdog stall "
                                     f"(stalls={stalls})")
            # Cross-replica divergence cadence (obs.audit): one probe
            # fan-out per audit_interval_s from this thread — the same
            # bounded per-replica RPC discipline as the health poll
            # (busy channel → that replica is unprobeable this round).
            if self.config.audit_interval_s > 0:
                now = time.monotonic()
                if now - self._last_audit_check \
                        >= self.config.audit_interval_s:
                    self._last_audit_check = now
                    try:
                        self.audit_divergence_check()
                    except Exception:  # noqa: BLE001 — the auditor
                        pass           # never takes down supervision

    def _handle_loss(self, r: ReplicaHandle, exc: BaseException,
                     reachable: bool = False) -> None:
        """The supervised replacement procedure (monitor thread; also
        safe from stop paths): drain (no new sessions — state flips out
        of HEALTHY, so admission skips it), migrate or close its
        sessions, then restart and rejoin within the restart budget."""
        with self._loss_lock:
            if r.id in self._retiring:
                return  # scale-in owns this replica's teardown
            if r.state not in (HEALTHY, DRAINING):
                return  # already handled (or permanently dead)
            r.state = DRAINING
            self.replica_losses += 1
            with self._lock:
                self._warm.pop(r.id, None)  # its pool is gone with it
            self.faults.record(FaultKind.REPLICA, exc, replica=r.id)
            self.tracer.instant("replica_lost", track=0, replica=r.id,
                                error=repr(exc))
            self._dump_async(f"replica {r.id} lost: {exc!r}")
            bound = [s for s in self._snapshot_sessions()
                     if s.replica_id == r.id and not s.orphaned]
            for s in bound:
                self._migrate(s, r, reachable=reachable)
            if reachable:
                # Live-but-broken (tripped budget / unrecoverable
                # engine): tear the old frontend down before respawning.
                try:
                    r.stop(timeout=2.0)
                except Exception:  # noqa: BLE001 — already broken
                    pass
            if r.restarts < self.config.max_restarts:
                r.state = RESTARTING
                t_restart = time.time()
                last: Optional[BaseException] = None
                for _ in range(2):  # one retry: a respawn that failed
                    # transiently (loaded host, slow accept) gets a
                    # second chance before the replica is written off
                    try:
                        r.restart()  # start() flips state to HEALTHY
                        with self._lock:
                            self._load[r.id] = 0
                        # Fresh frontend, fresh counters: both
                        # watermarks must reset with it — or the first
                        # post-restart watchdog trips go unnoticed and
                        # the delivered floor pins the dead counter's
                        # high-water mark forever (an idiomatic counter
                        # reset, which consumers handle).
                        self._stalls_seen.pop(r.id, None)
                        with self._lock:
                            self._delivered_seen.pop(r.id, None)
                            self._replica_load.pop(r.id, None)
                            # Fresh frontend, empty pool: nothing is
                            # warm there until health says otherwise.
                            self._warm.pop(r.id, None)
                        last = None
                        if self.ledger is not None:
                            self.ledger.record(
                                ledger_mod.REPLICA_RESTART,
                                cause=ledger_mod.CAUSE_RECOVERY,
                                replica=r.id,
                                migrated_sessions=len(bound),
                                wall_ms=(time.time() - t_restart) * 1e3,
                                reason=repr(exc), t0=t_restart)
                        break
                    except Exception as e:  # noqa: BLE001 — judged below
                        last = e
                        time.sleep(0.5)
                if last is not None:
                    r.state = DEAD
                    self.faults.record(FaultKind.REPLICA, last,
                                       replica=r.id)
                    print(f"[fleet] replica {r.id} restart failed "
                          f"(now dead): {last!r}",
                          file=sys.stderr, flush=True)
            else:
                r.state = DEAD

    def _dump_async(self, reason: str) -> None:
        """Flight dump OFF the monitor thread (FlightRecorder.
        trigger_async): the dump pulls per-replica stats/trace RPCs, and
        both trigger paths run in the thread that owns loss detection /
        migration / restart — supervision must never wait behind a dump
        mid-incident."""
        if self.flight is not None:
            self.flight.trigger_async(reason)

    def _snapshot_sessions(self) -> List[_FleetSession]:
        with self._lock:
            return list(self._sessions.values())

    # -- continuity plane: crash-consistent state snapshots --------------

    def snapshot_now(self) -> Optional[str]:
        """Write one crash-consistent continuity snapshot (atomic tmp +
        rename — either the old document or the new one is on disk, at
        every instant): the session registry, the placement map, each
        process replica's incarnation (pid + reattach port), and the
        token secret. Everything a restarted front door needs to
        re-adopt still-live replicas and their sessions without killing
        them. Returns the path, or None when the plane is unarmed."""
        path = self.config.state_path
        if not path:
            return None
        sessions = {}
        for s in self._snapshot_sessions():
            with s.lock:
                sessions[s.sid] = {
                    "replica_id": s.replica_id,
                    "replica_sid": s.replica_sid,
                    "generation": s.generation,
                    "next_index": s.next_index,
                    "last_index": s.last_index,
                    "slo_ms": s.slo_ms,
                    "frame_shape": (list(s.frame_shape)
                                    if s.frame_shape is not None
                                    else None),
                    "frame_dtype": (str(s.frame_dtype)
                                    if s.frame_dtype is not None
                                    else None),
                    "op_chain": s.op_chain,
                    "tier": s.tier,
                    "migrations": s.migrations,
                    "closed": s.closed,
                    "orphaned": s.orphaned,
                }
        replicas = {}
        for rid, r in list(self._replicas.items()):
            replicas[rid] = {
                "state": r.state,
                "pid": getattr(r, "pid", None),
                "reattach_port": getattr(r, "reattach_port", None),
                "restarts": r.restarts,
            }
        atomic_write_json(path, {
            "version": 1,
            "secret": self._token_secret.hex(),
            "mode": self.config.mode,
            "wall_time_s": time.time(),
            "sessions": sessions,
            "replicas": replicas,
        })
        self.continuity.inc("snapshots")
        return path

    def _snapshot_loop(self) -> None:
        interval = max(0.05, self.config.snapshot_interval_s)
        while not self._snapshot_stop.wait(interval):
            if self._stop.is_set():
                return
            try:
                self.snapshot_now()
            except Exception:  # noqa: BLE001 — the snapshot plane must
                pass           # never take down serving

    def _resume_sessions(self, state: dict, adopted: set) -> None:
        """Rebuild the fleet-side session registry from the previous
        incarnation's snapshot. Only sessions bound to a replica we
        actually RE-ADOPTED come back: their replica-side halves (the
        worker's own sessions, queued deliveries included) survived the
        front-door death, so open frames keep flowing under the same
        fleet indices. A session on a cold-started replica died with
        its worker — nothing to resume."""
        t0 = time.time()
        for sid, row in (state.get("sessions") or {}).items():
            if row.get("closed") or row.get("orphaned"):
                continue
            rid = row.get("replica_id")
            if rid not in adopted:
                continue
            shape = row.get("frame_shape")
            s = _FleetSession(
                sid, rid, row.get("slo_ms"),
                tuple(shape) if shape is not None else None,
                row.get("frame_dtype"), op_chain=row.get("op_chain"),
                tier=row.get("tier"),
                replay_window=self.config.serve.replay_window)
            s.replica_sid = row.get("replica_sid") or sid
            s.generation = int(row.get("generation") or 0)
            # The snapshot may lag real submits by one interval: a too-
            # low next_index re-assigns indices already in flight, which
            # the client-side dedup-by-index absorbs (the filter is
            # deterministic, so colliding frames are identical) — delay
            # or duplication, never divergence.
            s.next_index = int(row.get("next_index") or 0)
            s.last_index = int(row.get("last_index")
                               if row.get("last_index") is not None
                               else -1)
            s.migrations = int(row.get("migrations") or 0)
            with self._lock:
                if sid in self._sessions or sid in self._retired:
                    continue
                self._sessions[sid] = s
                self._load[rid] = self._load.get(rid, 0) + 1
            self.continuity.inc("adopted_sessions")
            if self.ledger is not None:
                self.ledger.record(
                    ledger_mod.RESUME, cause=ledger_mod.CAUSE_RECOVERY,
                    sid=sid, replica=rid, from_index=s.next_index,
                    t0=t0)

    def _migrate(self, s: _FleetSession, old: ReplicaHandle,
                 reachable: bool, graceful: bool = False) -> None:
        """Move one session off a lost/draining replica. Monotonicity
        argument: the binding swaps under ``s.lock``, the same lock every
        submit/poll holds for its whole replica round-trip — so the tail
        salvage below sees everything the old replica will ever deliver
        for this session, and every frame submitted after the swap
        carries a fleet index larger than anything salvaged.

        ``graceful`` is the scale-in variant (retire_replica): the
        replica is HEALTHY and draining by choice, so the session
        closes with ``drain=True`` (queued + in-flight frames still
        serve) and the salvage POLLS UNTIL THE SESSION HAS DRAINED
        instead of one shot — zero frame loss on the happy path. The client's submit blocks
        on ``s.lock`` for the drain window (backpressure, not loss); a
        replica that dies mid-drain degrades to the loss path's
        at-most-once salvage (the SIGKILL-during-scale-in chaos test
        pins exactly this)."""
        with s.lock:
            if s.closed or s.orphaned or s.replica_id != old.id:
                return
            # Salvage what the old replica already completed: its router
            # delivered into the session out-queue; in-flight frames
            # beyond that are written off (at-most-once). Best-effort
            # and attempted even when liveness said dead — an in-process
            # replica whose ENGINE failed still serves its out-queues
            # (a dead process replica just raises immediately here).
            try:
                old.close(s.replica_sid, drain=graceful)
            except Exception:  # noqa: BLE001 — salvage best-effort
                pass
            if graceful:
                # Drain to the end: keep polling while the retiring
                # replica serves the session's queued tail, until the
                # replica says the session delivered everything it ever
                # will (its close finalized) or the drain budget runs
                # out. A quiet window instead (the reference stops after
                # five empty polls, ~100 ms) writes off frames whose
                # batch is merely slow — a first batch that compiles, a
                # loaded host. All under s.lock — the survivor's
                # deliveries cannot interleave ahead of the tail, so
                # per-session index monotonicity is preserved by
                # construction; the poll after this loop picks up what
                # the finalize delivered last.
                deadline = time.monotonic() + self.config.drain_timeout_s
                while time.monotonic() < deadline:
                    try:
                        got = old.poll(s.replica_sid, None)
                        done = not got and old.session_drained(
                            s.replica_sid)
                    except Exception:  # noqa: BLE001 — died mid-drain:
                        break          # at-most-once from here on
                    if got:
                        s.tail.extend(self._map_deliveries(
                            s, got, replica=old))
                    elif done:
                        break
                    else:
                        time.sleep(0.02)
            try:
                s.tail.extend(self._map_deliveries(
                    s, old.poll(s.replica_sid, None), replica=old))
            except Exception:  # noqa: BLE001
                pass
            orphan = not self.config.migrate
            if not orphan:
                with self._lock:
                    load = dict(self._load)
                    warm = {rid: list(v) for rid, v in self._warm.items()}
                for target in self.admission.candidates(
                        list(self._replicas.values()), load,
                        exclude={old.id}, warm=warm,
                        key=self._signature_render(
                            s.op_chain, s.frame_shape, s.frame_dtype)):
                    new_sid = f"{s.sid}@g{s.generation + 1}"
                    try:
                        # Controller-relevant state survives migration:
                        # the tier is re-declared, so the survivor's
                        # control plane sheds this session in the same
                        # order (its quality level re-converges from the
                        # survivor's own telemetry).
                        target.open_stream(new_sid, slo_ms=s.slo_ms,
                                           frame_shape=s.frame_shape,
                                           frame_dtype=s.frame_dtype,
                                           op_chain=s.op_chain,
                                           tier=s.tier)
                    except (AdmissionError, ReplicaLostError):
                        continue
                    self._uncount_load(s)
                    s.generation += 1
                    s.replica_id = target.id
                    s.replica_sid = new_sid
                    s.migrations += 1
                    s.load_counted = True
                    with self._lock:
                        self._load[target.id] = (
                            self._load.get(target.id, 0) + 1)
                    self.migrated_sessions += 1
                    return
                # Nobody could take it: it closes under the client.
                orphan = True
            s.orphaned = True
            s.closed = True
            self.orphaned_sessions += 1
            self._uncount_load(s)
        if orphan:
            self._retire(s.sid, s)

    # -- elasticity actuator seams (control.fleet_elastic) ----------------
    # The ElasticFleetPlane's apply thread calls these; manual callers
    # (benches, an operator REPL) get the same semantics. Spawn/retire
    # serialize on _scale_lock — elasticity is a slow loop by design and
    # two concurrent scale actions would race the registries.

    def set_desired_replicas(self, n: int) -> None:
        """Record scale INTENT (the elastic plane calls this at action
        enqueue, before the spawn/retire lands): the controller reads
        ``replicas_desired`` next sample and must see its own pending
        action instead of double-firing into the apply gap."""
        with self._lock:
            self.desired = max(1, int(n))

    def rollback_desired(self, delta: int) -> None:
        """Undo intent after a failed apply (spawn raised / retire
        refused), so the controller may re-decide on a later window."""
        with self._lock:
            self.desired = max(1, self.desired + delta)

    def spawn_replica(self, flavor: Optional[str] = None,
                      cause: str = ledger_mod.CAUSE_MANUAL,
                      reason: Optional[str] = None) -> str:
        """Scale out by one replica; returns its id. Default flavor
        takes a WARM STANDBY when the pool has one (adoption: a dict
        insert — the spawn-to-first-served-frame time the elastic bench
        measures) and cold-spawns otherwise (seconds: spawn + torch import
        + CUDA context + precompile; this call blocks for it, which is
        why the elastic plane applies off-thread). ``flavor="multihost"``
        builds the BIGGER-replica shape instead: a MultiHostEngine
        process group (``FleetConfig.multihost_hosts`` members, one
        program) pinned to the first precompile-manifest signature —
        falls back to the default flavor when the multihost leg is not
        configured."""
        t_spawn = time.time()
        with self._scale_lock:
            if self._stop.is_set():
                raise ServeError("fleet is stopping: no scale-out")
            warm = False
            if flavor == "multihost" and self._multihost_key is not None:
                rid = self._next_rid()
                h = self._make_multihost_replica(rid)
                h.start()
            else:
                h = self.standby.take() if self.standby is not None else None
                if h is not None:
                    rid = h.id
                    warm = True
                else:
                    rid = self._next_rid()
                    h = self._make_replica(rid, int(rid[1:]))
                    h.start()
            if self._stop.is_set():
                # stop() ran while the (seconds-long cold) spawn was in
                # flight: its replica sweep snapshotted _replicas before
                # this insert, so adopting now would leak a live worker
                # past shutdown — tear it down here instead.
                try:
                    h.stop(timeout=10.0)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                raise ServeError("fleet stopped during spawn")
            with self._lock:
                self._replicas[rid] = h
                self._load.setdefault(rid, 0)
            # Seed the placement map NOW (one health probe at adoption):
            # a precompiled standby is warm for the manifest signatures,
            # and the very next open should route onto the fresh replica
            # instead of waiting a health-poll period to learn that.
            try:
                warm_sigs = (h.health() or {}).get("warm_signatures")
                if warm_sigs:
                    with self._lock:
                        self._warm[rid] = list(warm_sigs)
            except Exception:  # noqa: BLE001 — the monitor converges it
                pass
            self.scale_outs += 1
            if warm:
                self.standby_adoptions += 1
            with self._lock:
                self.desired = max(self.desired, self._live_count_locked())
            self.tracer.instant("scale_out", track=0, replica=rid,
                                warm=warm, flavor=flavor or "default")
            if self.ledger is not None:
                self.ledger.record(
                    ledger_mod.REPLICA_SPAWN, cause=cause,
                    replica=rid, warm=warm, flavor=flavor or "default",
                    wall_ms=(time.time() - t_spawn) * 1e3,
                    cache="hit" if warm else "miss", reason=reason,
                    t0=t_spawn)
            self._wake.set()  # monitor: learn its warm signatures now
            return rid

    def _live_count_locked(self) -> int:
        return sum(1 for r in self._replicas.values() if r.state != DEAD)

    def _make_multihost_replica(self, rid: str):
        from dvf_tpu_torch.fleet.multihost import MultiHostReplica

        key = self._multihost_key
        if key is None:
            raise ServeError(
                "multihost flavor needs multihost_hosts >= 2 and a "
                "--precompile manifest naming the signature the group "
                "compiles")
        return MultiHostReplica(
            rid,
            op_chain=key.op_chain,
            frame_shape=tuple(key.geometry),
            frame_dtype=str(key.np_dtype),
            hosts=self.config.multihost_hosts,
            batch_size=self.config.serve.batch_size,
            slo_ms=self.config.serve.slo_ms,
            queue_size=self.config.serve.queue_size,
            out_queue_size=self.config.serve.out_queue_size,
            env=self.config.replica_env,
            startup_timeout_s=self.config.startup_timeout_s,
            rpc_timeout_s=self.config.rpc_timeout_s,
            device=self.device.type,
        )

    def retire_replica(self, rid: str,
                       cause: str = ledger_mod.CAUSE_MANUAL,
                       reason: Optional[str] = None) -> bool:
        """Scale in by draining one replica: admission off (state flips
        to DRAINING + replica-side ``begin_drain``), every bound session
        gracefully migrated to a survivor (drain-to-the-end salvage, then
        rebind — affinity and the fleet index space survive, exactly
        the loss path's machinery minus the loss), then terminate and
        forget the replica. False = no such healthy replica (it died,
        retired, or was never there — the controller re-decides on a
        later window)."""
        t_retire = time.time()
        with self._scale_lock:
            with self._loss_lock:
                r = self._replicas.get(rid)
                if r is None or r.state != HEALTHY:
                    return False
                self._retiring.add(rid)
                r.state = DRAINING
            try:
                try:
                    r.begin_drain()
                except Exception:  # noqa: BLE001 — a dead/busy replica
                    pass           # drains via migration regardless
                with self._open_lock:
                    # Placement barrier: an open holds this lock from
                    # candidate pick through fleet-side registration,
                    # so once we pass it, every open that chose this
                    # (then-HEALTHY) replica is registered and lands in
                    # the snapshot below; later opens see DRAINING and
                    # place elsewhere. (The post-registration
                    # incarnation check in open_stream covers the same
                    # window for the LOSS path — this makes the retire
                    # argument local.)
                    pass
                bound = [s for s in self._snapshot_sessions()
                         if s.replica_id == rid and not s.orphaned]
                for s in bound:
                    self._migrate(s, r, reachable=True, graceful=True)
                try:
                    r.stop(timeout=self.config.drain_timeout_s)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                with self._lock:
                    self._replicas.pop(rid, None)
                    self._load.pop(rid, None)
                    self._warm.pop(rid, None)
                    self._delivered_seen.pop(rid, None)
                    self._replica_load.pop(rid, None)
                self._stalls_seen.pop(rid, None)
                self.scale_ins += 1
                with self._lock:
                    self.desired = min(self.desired,
                                       max(1, self._live_count_locked()))
                self.tracer.instant("scale_in", track=0, replica=rid,
                                    migrated=len(bound))
                if self.ledger is not None:
                    self.ledger.record(
                        ledger_mod.REPLICA_RETIRE, cause=cause,
                        replica=rid, migrated_sessions=len(bound),
                        wall_ms=(time.time() - t_retire) * 1e3,
                        reason=reason, t0=t_retire)
                return True
            finally:
                self._retiring.discard(rid)

    def rolling_rollout(self, flavor: Optional[str] = None,
                        reason: Optional[str] = None) -> dict:
        """Zero-downtime config/version rollout: replace every live
        replica one at a time, spawn-before-retire, behind the warm
        standby pool.

        Per replica the sequence is the serve tier's hot swap lifted a
        level: ``spawn_replica`` brings a successor up (adopting a warm
        standby when one is ready — the fleet-scale analogue of
        compiling aside) while the incumbent keeps serving; only once
        the successor is HEALTHY does ``retire_replica`` drain the
        incumbent, migrating its bound sessions gracefully. Capacity
        never dips below N, so sessions observe a migration (already a
        no-stall path) rather than an outage.

        A replica that fails to spawn a successor aborts the rollout
        for the REMAINING incumbents (the fleet never trades a known-
        good replica for nothing); a retire that returns False (the
        incumbent died or started draining mid-rollout) is skipped —
        the loss path owns it. Both outcomes land in the summary
        ``swap`` ledger event, cause ``rollout``."""
        t0 = time.time()
        with self._lock:
            targets = [rid for rid, r in sorted(self._replicas.items())
                       if r.state == HEALTHY]
        swapped: List[dict] = []
        aborted: Optional[str] = None
        for rid in targets:
            try:
                new_rid = self.spawn_replica(
                    flavor=flavor, cause=ledger_mod.CAUSE_ROLLOUT,
                    reason=reason)
            except Exception as e:  # noqa: BLE001 — spawn failed: keep
                aborted = f"spawn failed at {rid}: {e!r}"  # the incumbent
                break
            retired = self.retire_replica(
                rid, cause=ledger_mod.CAUSE_ROLLOUT, reason=reason)
            swapped.append({"old": rid, "new": new_rid,
                            "retired": retired})
            self.rollout_swaps += 1
        self.rollouts += 1
        record = {
            "targets": len(targets),
            "swapped": [s for s in swapped if s["retired"]],
            "skipped": [s for s in swapped if not s["retired"]],
            "aborted": aborted,
            "wall_ms": round((time.time() - t0) * 1e3, 3),
        }
        self.tracer.instant("rolling_rollout", track=0,
                            targets=len(targets),
                            swapped=len(record["swapped"]),
                            aborted=aborted)
        if self.ledger is not None:
            self.ledger.record(
                ledger_mod.SWAP, cause=ledger_mod.CAUSE_ROLLOUT,
                targets=len(targets), swapped=len(record["swapped"]),
                skipped=len(record["skipped"]), flavor=flavor,
                aborted=True if aborted else None,
                wall_ms=record["wall_ms"], reason=reason or aborted,
                t0=t0)
        return record

    def flight_trip(self, reason: str) -> None:
        """Elastic-plane observability tap (scale saturation: pressure
        with every replica spawned): same off-thread fleet flight dump
        as the loss/stall paths."""
        self.tracer.instant("scale_saturated", track=0, reason=reason)
        self._dump_async(reason)

    # -- broadcast plane: publish / subscribe / relay ---------------------

    def _ensure_broadcast(self):
        with self._lock:
            if self.broadcast is None:
                from dvf_tpu_torch.broadcast import BroadcastPlane

                sc = self.config.serve
                self.broadcast = BroadcastPlane(
                    audit_wire=sc.broadcast_audit_wire,
                    chaos=self.config.chaos,
                    ingest_depth=sc.broadcast_ingest_depth,
                    sub_queue=sc.broadcast_sub_queue,
                    evict_after=sc.broadcast_evict_after,
                    keyframe_interval=sc.broadcast_keyframe_interval)
            return self.broadcast

    def publish_stream(self, session_id: str, channel: str,
                       tiers=None, poll_interval_s: float = 0.005) -> None:
        """Register a fleet session's output as broadcast channel
        ``channel``. Unlike the serve tier (an in-process tap on the
        delivery loop), the fleet front door only sees frames when
        someone polls — so publishing hands the session's polling to a
        dedicated pump thread that drains ``poll(session_id)`` into
        the channel. The publisher stops polling this session itself;
        watchers attach with :meth:`subscribe`."""
        plane = self._ensure_broadcast()
        self._session(session_id)  # raises on unknown sid, before publish
        plane.publish(channel, publisher=session_id, tiers=tiers or ())
        tap = plane.tap(channel)
        stop_evt = threading.Event()
        t = threading.Thread(
            target=self._pump_loop,
            args=(channel, session_id, stop_evt, tap),
            name=f"dvf-fleet-bcast-{channel}", daemon=True)
        with self._lock:
            self._publish_pumps[channel] = {
                "thread": t, "stop": stop_evt, "session": session_id}
        t.start()

    def _pump_loop(self, channel: str, session_id: str,
                   stop_evt: threading.Event, tap) -> None:
        while not stop_evt.is_set() and not self._stop.is_set():
            try:
                got = self.poll(session_id)
            except Exception:  # noqa: BLE001 — session released/lost:
                # the channel stays subscribable (no new frames), the
                # pump just ends; counted for stats.
                with self._lock:
                    self._pump_errors += 1
                return
            if not got:
                stop_evt.wait(0.005)
                continue
            for d in got:
                tap(d.index, d.frame, d.capture_ts)

    def unpublish_stream(self, channel: str) -> None:
        """Stop the pump and retire the channel (subscribers detach)."""
        with self._lock:
            pump = self._publish_pumps.pop(channel, None)
        if pump is not None:
            pump["stop"].set()
            pump["thread"].join(timeout=5.0)
        if self.broadcast is not None:
            self.broadcast.unpublish(channel)

    def subscribe(self, channel: str, tier=None,
                  queue_size: Optional[int] = None, abr: bool = False):
        """Attach a watcher to a published channel (serve-tier
        semantics: tier spec string or Tier, None = ladder top or —
        with ``abr`` — its cheapest rung)."""
        return self._ensure_broadcast().subscribe(
            channel, tier=tier, queue_size=queue_size, abr=abr)

    def unsubscribe(self, sub) -> None:
        if self.broadcast is not None:
            self.broadcast.unsubscribe(sub)

    def spawn_broadcast_relay(self, channel: Optional[str] = None,
                              source_tier=None, tiers=(),
                              cause: str = "manual", reason: str = ""):
        """Spawn a relay-only egress replica (the elastic plane's
        ``relay_out`` actuator, also callable by hand). ``channel``
        None picks the channel with the most direct subscribers — the
        one whose fan-out the relay relieves."""
        plane = self._ensure_broadcast()
        if channel is None:
            rows = plane.stats()["channels"]
            if not rows:
                raise ServeError("no published channel to relay")
            channel = max(
                sorted(rows),
                key=lambda c: sum(
                    t.get("subscriber_count", 0)
                    for t in rows[c]["tiers"].values()))
        node = plane.spawn_relay(channel, source_tier=source_tier,
                                 tiers=tiers)
        with self._lock:
            self.relay_spawns += 1
        self.tracer.instant("relay_out", track=0, relay=node.id,
                            channel=channel, cause=cause, reason=reason)
        if self.ledger is not None:
            self.ledger.record(
                ledger_mod.RELAY_SPAWN, cause=cause,
                replica=node.id, channel=channel, reason=reason)
        return node

    def retire_broadcast_relay(self, relay_id: Optional[str] = None,
                               cause: str = "manual",
                               reason: str = "") -> bool:
        """Retire one relay (``relay_id`` None = the newest — LIFO, the
        scale-in mirror of spawn order). Its direct subscribers are
        evicted; the upstream channel is untouched."""
        if self.broadcast is None:
            return False
        if relay_id is None:
            stats = self.broadcast.stats()["relays"]
            if not stats:
                return False
            relay_id = sorted(stats)[-1]
        try:
            self.broadcast.retire_relay(relay_id)
        except KeyError:
            return False
        with self._lock:
            self.relay_retires += 1
        self.tracer.instant("relay_in", track=0, relay=relay_id,
                            cause=cause, reason=reason)
        if self.ledger is not None:
            self.ledger.record(ledger_mod.RELAY_RETIRE, cause=cause,
                               replica=relay_id, reason=reason)
        return True

    # -- audit plane: cross-replica divergence (obs.audit) ---------------

    def _audit_signature(self) -> Optional[str]:
        """The signature to probe: the canonical render warm on the
        MOST healthy replicas (a probe is only a comparison when at
        least two replicas can run it). None = nothing shared yet."""
        with self._lock:
            warm = {rid: set(keys) for rid, keys in self._warm.items()
                    if rid in self._replicas
                    and self._replicas[rid].state == HEALTHY}
        counts: Dict[str, int] = {}
        for keys in warm.values():
            for k in keys:
                counts[k] = counts.get(k, 0) + 1
        if not counts:
            return None
        best = max(sorted(counts), key=lambda k: counts[k])
        return best if counts[best] >= 2 else None

    def audit_divergence_check(
            self, signature: Optional[str] = None) -> dict:
        """Detector 3: run the identical deterministic probe frame
        through every healthy replica warm on ``signature`` (default:
        the most widely warm one) and compare output digests. A
        replica outvoted by the majority is flagged — and, under
        ``audit_quarantine``, drained and retired through the existing
        ``retire_replica`` seam. Returns the event record
        (``verdict``: match / mismatch / skipped)."""
        signature = signature if signature is not None \
            else self._audit_signature()
        if signature is None:
            return self.divergence.check({}, signature=None)
        with self._lock:
            replicas = [(rid, r) for rid, r in self._replicas.items()
                        if r.state == HEALTHY]
        probes: Dict[str, Optional[dict]] = {}
        for rid, r in replicas:
            try:
                probes[rid] = r.audit_probe(signature)
            except Exception:  # noqa: BLE001 — unprobeable this round
                probes[rid] = None       # (busy channel, not warm, mid-
                #   drain): counted as unreachable, never judged
        return self.divergence.check(
            probes, signature=signature,
            quarantine=self.config.audit_quarantine)

    def audit_document(self) -> dict:
        """The fleet's ``/audit`` endpoint / flight-dump audit.json:
        the divergence detector's counters + event window, plus each
        reachable replica's last-known audit counters would ride its
        own /audit — the fleet document stays RPC-free."""
        doc = self.divergence.document()
        doc["label"] = "fleet"
        doc["audit_interval_s"] = self.config.audit_interval_s
        doc["quarantine"] = self.config.audit_quarantine
        return doc

    def elastic_view(self) -> dict:
        """The structured half of a fleet control row — what the
        elastic plane composes with each flat ring sample before the
        controller's decision step. RPC-free by construction: per-
        replica queue/p99 come from the monitor's cached health-RPC
        load rows (one poll period old), never from a live fan-out on
        the sampler thread."""
        with self._lock:
            load = dict(self._load)
            cached = {rid: dict(v) for rid, v in self._replica_load.items()}
            replicas = [(rid, r.state) for rid, r in self._replicas.items()]
            desired = self.desired
        live = sum(1 for _, state in replicas if state == HEALTHY)
        rows = []
        for rid, state in replicas:
            if state != HEALTHY:
                continue
            lr = cached.get(rid) or {}
            rows.append({"rid": rid,
                         "sessions": float(load.get(rid, 0)),
                         "queue_depth": lr.get("queue_depth"),
                         "p99_ms": lr.get("p99_ms")})
        return {
            "replicas_live": float(live),
            "replicas_desired": float(desired),
            "standby_warm": (float(self.standby.warm_count)
                             if self.standby is not None else 0.0),
            "capacity_sessions": float(
                live * self.config.serve.max_sessions),
            "bound_sessions": float(sum(load.values())),
            "slo_ms": float(self.config.serve.slo_ms),
            "replica_rows": rows,
            "multihost_available": self._multihost_key is not None,
            "profile_device_ms": self._profile_device_ms,
            # Relay-axis inputs (zero rows when nothing publishes:
            # relay_pressure short-circuits and the recorded window
            # stays replayable against pre-broadcast controllers).
            **self._broadcast_view(),
        }

    def _broadcast_view(self) -> dict:
        if self.broadcast is None:
            return {"broadcast_subscribers": 0.0,
                    "broadcast_dropped_total": 0.0,
                    "relays_live": 0.0}
        sig = self.broadcast.signals()
        return {
            "broadcast_subscribers": sig.get("broadcast_subscribers", 0.0),
            "broadcast_dropped_total": sig.get(
                "broadcast_dropped_total", 0.0),
            "relays_live": sig.get("broadcast_relays", 0.0),
        }

    # -- observability ---------------------------------------------------

    def trace_snapshots(self) -> List[dict]:
        """Every reachable tracer's bounded event window: the front
        door's own plus one per replica (in-process read or the
        ``trace`` RPC) — the input to ONE merged Perfetto session. A
        dead or wedged replica costs its lane, nothing else."""
        snaps: List[dict] = []
        if len(self.tracer):
            snaps.append(self.tracer.snapshot())
        for r in list(self._replicas.values()):
            try:
                snap = r.trace_snapshot()
            except Exception:  # noqa: BLE001 — lane lost, merge lives
                continue
            if snap and snap.get("events"):
                snaps.append(snap)
        return snaps

    def export_trace(self, out_path: str) -> Optional[dict]:
        """Merge every replica's trace into one Perfetto file on one
        aligned clock (``obs.trace.merge_tracer_snapshots``)."""
        return merge_tracer_snapshots(self.trace_snapshots(), out_path)

    def explain(self) -> dict:
        """Fleet-wide latency attribution: every reachable replica's
        ``explain`` decomposition (lineage-armed replicas only — arm
        with ``ServeConfig.lineage``), keyed by replica id. One stats
        RPC per process replica; a busy or dead replica costs its row.
        Always the p99 decomposition — the per-replica rows ride the
        stats RPC, which computes at the attribution default.

        Freshness-cached (attach_fleet_provider's discipline): a stats
        RPC briefly holds each replica's serial channel lock against
        its submit hot path, so a curl loop on ``/explain`` must
        coalesce onto one fan-out per second, not multiply it. The
        fan-out runs OUTSIDE the cache lock: a busy fleet's refresh
        can take seconds (bounded channel-lock waits per replica), and
        concurrent callers must get the stale cache, not a pile-up."""
        with self._explain_cache_lock:
            if time.monotonic() - self._explain_cache_t < 1.0:
                return self._explain_cache
        if not self._explain_refresh_lock.acquire(blocking=False):
            # Another caller is mid-fan-out: serve the (possibly stale,
            # at worst empty-first-call) cache rather than queueing.
            with self._explain_cache_lock:
                return self._explain_cache
        try:
            out: dict = {"lineage": bool(self.config.serve.lineage),
                         "replicas": {}}
            for rid, r in list(self._replicas.items()):
                if r.state != HEALTHY:
                    continue
                try:
                    export = r.stats_full()
                except Exception:  # noqa: BLE001 — never throws
                    continue
                attr = ((export or {}).get("stats")
                        or {}).get("attribution")
                if attr and attr.get("explain"):
                    out["replicas"][rid] = attr["explain"]
            with self._explain_cache_lock:
                self._explain_cache = out
                self._explain_cache_t = time.monotonic()
        finally:
            self._explain_refresh_lock.release()
        return out

    def signals(self) -> dict:
        """RPC-free front-door signal row (the fleet telemetry ring's
        sample: never blocks on a replica channel). Since the elastic
        fleet this is also the controller's flat input: the
        admission-refusal counters (total AND per tier — previously
        only visible in rejection strings), the cached per-replica load
        aggregates (queue depth, worst p99, shed/SLO-miss/delivered
        sums — one health-poll period old), and the scale gauges."""
        with self._lock:
            open_sessions = sum(1 for s in self._sessions.values()
                                if not s.closed)
            cached = [dict(v) for rid, v in self._replica_load.items()
                      if rid in self._replicas]
            desired = self.desired
            # Snapshot under the lock: spawn/retire mutate _replicas
            # from the elastic apply thread.
            replicas = list(self._replicas.values())
        healthy = sum(1 for r in replicas if r.state == HEALTHY)

        def agg(key, fold):
            vals = [float(v[key]) for v in cached
                    if v.get(key) is not None]
            return fold(vals) if vals else None

        out = {
            "open_sessions": float(open_sessions),
            "healthy_replicas": float(healthy),
            "replica_losses_total": float(self.replica_losses),
            "migrated_sessions_total": float(self.migrated_sessions),
            "orphaned_sessions_total": float(self.orphaned_sessions),
            "order_violations_total": float(self.order_violations),
            "tier_rejections_total": float(
                self.admission.tier_rejections),
            "replica_restarts_total": float(sum(
                r.restarts for r in replicas)),
            # -- elastic fleet: scale gauges + the controller inputs --
            "replicas_live": float(healthy),
            "replicas_desired": float(desired),
            "standby_warm": (float(self.standby.warm_count)
                             if self.standby is not None else 0.0),
            "scale_out_total": float(self.scale_outs),
            "scale_in_total": float(self.scale_ins),
            "standby_adoptions_total": float(self.standby_adoptions),
            "rollout_swaps_total": float(self.rollout_swaps),
            "admission_refusals_total": float(self.admission.rejections),
            # Cached per-replica load aggregates (RPC-free; summed
            # counters dip on a replica restart/retire — the idiomatic
            # counter reset, and a non-advancing delta reads as calm).
            "fleet_queue_depth": agg("queue_depth", sum),
            "fleet_p99_ms": agg("p99_ms", max),
            "fleet_shed_total": agg("shed_total", sum),
            "fleet_slo_miss_total": agg("slo_miss_total", sum),
            "fleet_delivered_total": agg("delivered_total", sum),
        }
        # stats() hands back a locked snapshot — record_rejection may be
        # inserting a first-of-its-tier key on an open_stream thread.
        by_tier = self.admission.stats()["rejections_by_tier"]
        for t, n in sorted(by_tier.items()):
            name = TIER_NAMES.get(t, f"tier{t}")
            out[f"admission_refusals_{name}_total"] = float(n)
        if self.ledger is not None:
            out.update(self.ledger.signals())
        out.update(self.continuity.signals())
        out.update(self.divergence.signals())
        if self.broadcast is not None:
            out.update(self.broadcast.signals())
            out["relay_spawns_total"] = float(self.relay_spawns)
            out["relay_retires_total"] = float(self.relay_retires)
            out["broadcast_pump_errors_total"] = float(self._pump_errors)
        if self.elastic is not None:
            for k, v in self.elastic.signals().items():
                out.setdefault(k, v)   # plane extras (errors,
                #   saturations); applied-scale counters stay the
                #   fleet's own
        return out

    def stats(self) -> dict:
        """The fleet view: per-replica rows + merged latency/faults."""
        # One snapshot for the whole export: the elastic apply thread
        # inserts/pops replicas concurrently (pre-elastic this dict was
        # construction-time-fixed and bare iteration was safe).
        replica_items = list(self._replicas.items())
        exports: Dict[str, Optional[dict]] = {}
        for rid, r in replica_items:
            try:
                exports[rid] = r.stats_full() if r.state == HEALTHY else None
            except ReplicaLostError as e:
                self._note_loss(r, e)
                exports[rid] = None
            except Exception:  # noqa: BLE001 — stats must never throw
                exports[rid] = None
        with self._lock:
            sessions = {**self._retired, **self._sessions}
            load = dict(self._load)
            warm = {rid: list(keys) for rid, keys in self._warm.items()}
        replica_rows = {}
        for rid, r in replica_items:
            row = replica_row(r, exports.get(rid), load.get(rid, 0))
            d = row.get("delivered_total")
            with self._lock:
                # Max semantics make concurrent stats() calls (scrape
                # provider + off-thread dump) interleaving-safe: a stale
                # reader can never LOWER the watermark. Restarts reset
                # it explicitly in _handle_loss (fresh counter).
                prev = self._delivered_seen.get(rid)
                if d is not None and (prev is None or d > prev):
                    self._delivered_seen[rid] = d
                elif d is None:
                    # Transiently unreadable export (busy channel, mid-
                    # drain): hold the last-seen value so the summed
                    # fleet counter never dips-and-recovers (a fake
                    # rate() spike).
                    row["delivered_total"] = prev
            replica_rows[rid] = row
        session_rows = {}
        for sid, s in sessions.items():
            session_rows[sid] = {
                "replica": s.replica_id,
                "submitted": s.next_index,
                "polled": s.polled,
                "lost": s.lost,
                "migrations": s.migrations,
                "tier": s.tier,
                "state": ("orphaned" if s.orphaned
                          else "closed" if s.closed else "open"),
            }
        return {
            "replicas": replica_rows,
            "sessions": session_rows,
            "open_sessions": sum(1 for s in sessions.values()
                                 if not s.closed),
            "replica_losses": self.replica_losses,
            "migrated_sessions": self.migrated_sessions,
            "orphaned_sessions": self.orphaned_sessions,
            "order_violations": self.order_violations,
            # Per-replica warm-signature map (the placement input): what
            # each replica's pool serves without a compile.
            "warm_replicas": warm,
            # -- elastic fleet: live/desired/standby + scale counters --
            "replicas_live": sum(1 for _, r in replica_items
                                 if r.state == HEALTHY),
            "replicas_desired": self.desired,
            "standby_warm": (self.standby.warm_count
                             if self.standby is not None else 0),
            "scale_outs": self.scale_outs,
            "scale_ins": self.scale_ins,
            "standby_adoptions": self.standby_adoptions,
            "rollouts": self.rollouts,
            "rollout_swaps": self.rollout_swaps,
            **({"standby": self.standby.stats()}
               if self.standby is not None else {}),
            **({"elastic": self.elastic.stats()}
               if self.elastic is not None else {}),
            **({"broadcast": {
                **self.broadcast.stats(),
                "relay_spawns": self.relay_spawns,
                "relay_retires": self.relay_retires,
                "pump_errors": self._pump_errors,
                "pumps": {ch: p["session"]
                          for ch, p in self._publish_pumps.items()},
            }} if self.broadcast is not None else {}),
            **self.admission.stats(),
            "faults": merge_fault_summaries(
                self.faults.summary(),
                {rid: (e or {}).get("stats", {}).get("faults")
                 for rid, e in exports.items()}),
            "recoveries": {
                rid: (e or {}).get("stats", {}).get("recoveries", 0)
                for rid, e in exports.items()
            },
            "replica_restarts": sum(r.restarts
                                    for _, r in replica_items),
            "continuity": self.continuity.summary(),
            # Config provenance for the knobs that shape recovery
            # behavior (the continuity bench records these next to its
            # measurements, so a regression is attributable to a knob
            # change, not a mystery).
            "fleet": {
                "mode": self.config.mode,
                "replicas": self.config.replicas,
                "health_poll_s": self.config.health_poll_s,
                "startup_timeout_s": self.config.startup_timeout_s,
                "rpc_timeout_s": self.config.rpc_timeout_s,
                "rpc_op_timeout_s": self.config.rpc_op_timeout_s,
                "rpc_lock_timeout_s": self.config.rpc_lock_timeout_s,
                "drain_timeout_s": self.config.drain_timeout_s,
                "state_path": self.config.state_path,
                "snapshot_interval_s": self.config.snapshot_interval_s,
                "resume_state": self.config.resume_state,
                "reattach_grace_s": self.config.reattach_grace_s,
                "replay_window": self.config.serve.replay_window,
            },
            # Auto-plan plane: the plan the front door applied to the
            # serve template (None = hand-set defaults).
            **({"plan": self.applied_plan}
               if self.applied_plan is not None else {}),
            "aggregate": merge_latency_snapshots(
                {rid: (e or {}).get("latency")
                 for rid, e in exports.items()}),
            "audit": self.divergence.stats(),
            **({"ledger": self.ledger.summary()}
               if self.ledger is not None else {}),
            **({"chaos": self.config.chaos.summary()}
               if self.config.chaos is not None else {}),
            **({"flight": self.flight.stats()}
               if self.flight is not None else {}),
        }
