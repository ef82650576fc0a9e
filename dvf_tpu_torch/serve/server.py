"""The serving front door: N client streams, one device, M signatures
(port of ``dvf_tpu.serve.server`` on one CUDA device).

``ServeFrontend`` multiplexes independent client sessions onto a small
pool of compiled programs — the genuinely multi-tenant execution path in
the framework. Sessions group into **signature buckets** keyed by the
canonical ``(op_chain, geometry, dtype)`` triple
(runtime.signature.SignatureKey); each bucket leases its compiled
``Engine`` from a bounded LRU ``ProgramPool``, so a real traffic mix
(mixed filters, resolutions, dtypes) time-shares ONE device instead of
being refused at the door or forked into N processes. Topology (one
process, two service threads around the async device queue, mirroring
the single-stream pipeline's shape):

  clients ──submit──► per-session ingress (drop-oldest)
                          │ dispatch thread: pick ONE bucket per tick
                          ▼ (EDF-headroom ÷ measured tick cost), then
                      ContinuousBatcher EDF within it → one batch
                      bucket.Engine.submit  (in-flight depth bounded
                          │  across buckets — one device queue)
                          │ collect thread: materialize via the
                          ▼ bucket's fetcher → ResultRouter
                      per-session reorder → out queue / sink ──poll──► clients

Admission control is three-layered: ``max_sessions`` caps tenants at
``open_stream`` (AdmissionError beyond), ``max_buckets`` caps live
signatures (a new signature admits by creating a bucket — compiled
AHEAD of its first frame, so the compile (warm-up and calibrations)
happens at admission, where the program pool turns a returning
signature into a lease, never on the serving path; beyond the cap the refusal
enumerates the warm signatures this frontend can serve cheaply), and
``max_inflight`` caps device batches in flight (bounding queueing delay
for everyone — the per-batch analog of the single-stream pipeline's
semaphore). Overload beyond that is absorbed by the per-session
drop-oldest bounds and the batcher's SLO shedding, never by blocking a
client.

Only stateless filters are served: a stateful filter's temporal state
would thread *across* batches whose rows belong to different tenants —
cross-session state leakage by construction — so the frontend refuses
them at build time.

On a card every bucket's engine runs its hand kernels on ``cuda:0`` (or
the device given); its own H2D and D2H streams carry the streamed ingest
and egress copies, compute runs on the dispatch thread's current stream,
and the collect thread waits on each batch's events, never on a stream.
Compiles made beside live serving (admission, a hot swap's successor)
wait only on their own work (``Engine.compile``). ``device="cpu"`` runs
the plain torch versions.

The observability planes are the reference's: the audit plane
(``audit``: sampled shadow replay through an eager golden on the
bucket's device, the program-swap guard on every resize, quality rebind
and recovery rebuild, ``audit_probe``), frame lineage (``lineage``:
every delivered frame's additive latency decomposition, ``explain``),
the flight recorder (``flight_dir``, with a ``torch.profiler`` window
when ``flight_profile_s`` > 0) and stage profiles (``profile_dir``). On
a card the lineage ``device`` mark is taken after a wait on the batch's
own compute event, never on the whole device. So are the load-adaptive
control plane (``control``: quality downshift, batch and tick resizing,
priority-tier admission), auto-plan with its on-disk plan cache
(``autoplan``, ``plan_cache_dir``) and encode-once broadcast
(``open_stream(publish=...)``, ``subscribe``). A quality downshift's
program (the chain on a ×2-decimated frame, then ``upscale``) compiles
at admission on a background thread, on the engine's compile stream.

``ZmqStreamBridge`` binds one session to the reference app's socket pair
using the exact READY-credit framing of ``transport.zmq_ingress`` — a
reference-style client connects and sees one fast worker, while its
frames share device batches with every other tenant.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dvf_tpu_torch.api.filter import Filter, FilterChain
from dvf_tpu_torch.obs.audit import (
    AuditPlane,
    WireAudit,
    attach_audit_provider,
    engine_probe_row,
    frame_digest,
    maybe_corrupt_device,
)
from dvf_tpu_torch.obs.export import FlightRecorder, attach_signal_provider
from dvf_tpu_torch.obs.lineage import (
    AttributionPlane,
    load_stage_profile,
    save_stage_profile,
)
from dvf_tpu_torch.obs import ledger as ledger_mod
from dvf_tpu_torch.obs.ledger import ReconfigLedger
from dvf_tpu_torch.obs.memory import (
    LeakTrendWatch,
    attach_memory_provider,
)
from dvf_tpu_torch.obs.metrics import EgressStats, IngestStats, LatencyStats
from dvf_tpu_torch.obs.registry import (
    COUNTER,
    GAUGE,
    MetricSample,
    MetricsRegistry,
    TimeSeriesRing,
)
from dvf_tpu_torch.obs.trace import Tracer
from dvf_tpu_torch.resilience.budget import ErrorBudget, escalate
from dvf_tpu_torch.resilience.continuity import (
    ContinuityStats, HeartbeatConfig, ReconnectPolicy, check_resume_token,
    make_resume_token, new_secret,
)
from dvf_tpu_torch.resilience.faults import FaultError, FaultKind, FaultStats, classify
from dvf_tpu_torch.resilience.supervisor import InflightWindow, Supervisor
from dvf_tpu_torch.runtime.egress import (
    EGRESS_MODES,
    AsyncCodecPlane,
    ShardedBatchFetcher,
)
from dvf_tpu_torch.runtime.engine import (
    Engine,
    ProgramPool,
    host_array,
    wait_compute,
)
from dvf_tpu_torch.runtime.ingest import INGEST_MODES, ShardedBatchAssembler
from dvf_tpu_torch.runtime.signature import (
    SignatureKey,
    build_filter,
    canonical_dtype,
    canonical_geometry,
    canonical_op_chain,
    canonical_op_chain_or_verbatim,
    make_key,
    parse_manifest,
)
from dvf_tpu_torch.serve.batcher import BatchPlan, ContinuousBatcher
from dvf_tpu_torch.serve.router import ResultRouter
from dvf_tpu_torch.serve.session import (
    CLOSED,
    OPEN,
    AdmissionError,
    ServeError,
    SessionConfig,
    StreamSession,
)

# Trace track ids (one lane per stage, the pipeline's convention):
# dispatch staging, device span, H2D / D2H transfer lanes.
# The reconfiguration ledger stamps its events on its own lane
# (obs.ledger.TRACK_LEDGER = 6), clear of all of these.
TRACK_DISPATCH, TRACK_DEVICE, TRACK_H2D, TRACK_D2H = 0, 1, 3, 4

# dvf_compile_ms histogram bounds: serving compiles span sub-ms pool
# hits through multi-second cold compiles.
COMPILE_MS_BOUNDS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                     1000.0, 2500.0, 5000.0, 10000.0)

# dvf_swap_stall_ms histogram bounds: a hot swap's serving cost is the
# tick-boundary commit (a pointer swing + optional device-to-device
# state migration) — sub-millisecond to a few ms; anything in the
# hundreds means the compile leaked back onto the dispatch thread.
SWAP_STALL_MS_BOUNDS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                        25.0, 50.0, 100.0, 250.0)


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 8
    max_sessions: int = 16        # admission cap (open_stream)
    max_buckets: int = 4          # live signature buckets — how many
    #   distinct (op_chain, geometry, dtype) mixes this frontend serves
    #   concurrently; a new signature beyond the cap first retires an
    #   IDLE bucket (no sessions, nothing in flight — its program stays
    #   warm in the pool), else refuses with the warm-signature list
    pool_capacity: int = 8        # compiled-program pool bound (LRU;
    #   ≥ max_buckets keeps every retired bucket's program warm until
    #   genuine capacity pressure — eviction frees device buffers and a
    #   re-admission compiles a fresh engine)
    max_inflight: int = 4         # device batches in flight (latency bound)
    queue_size: int = 10          # per-session ingress bound
    slo_ms: float = 1000.0        # default per-stream latency budget
    frame_delay: int = 0          # per-session reorder cursor lag
    reorder_capacity: int = 50
    out_queue_size: int = 64      # per-session poll-side bound
    replay_window: int = 64       # per-session delivered-tail replay ring
    #   (resilience.continuity): resume_stream replays the retained tail
    #   from the client's last-seen index — effectively-exactly-once
    #   delivery within the window. 0 disables (no frames pinned).
    max_retired: int = 64         # closed sessions kept poll-able; oldest
    #   evicted beyond this (a churning long-lived server must not pin
    #   every dead tenant's tail frames forever — release() drops one
    #   explicitly once its client has drained)
    tick_s: float = 0.002         # dispatch idle poll
    resilient: bool = True        # one bad batch is dropped + counted;
    #   serving keeps going (live-mode semantics, like Pipeline.resilient)
    fault_budget: int = 16        # contained faults per kind inside
    #   fault_window_s before escalation (resilience.budget): first
    #   overflow degrades (h2d → monolithic ingest; compute/oom →
    #   supervised engine rebuild), second surfaces a hard ServeError —
    #   a permanently broken engine must not become a silent 0-fps server
    fault_window_s: float = 30.0
    stall_timeout_s: float = 30.0  # >0: stall watchdog over the in-flight
    #   window (resilience.supervisor) — a submitted batch older than this
    #   triggers recovery: shed the window, rebuild the engine (recompile,
    #   re-warm, re-calibrate), replace a wedged collect thread; open
    #   sessions survive with their frame index spaces intact. 0 = off.
    chaos: Any = None             # resilience.chaos.FaultPlan — arms the
    #   engine/assembler/collect injection sites (--chaos CLI spec)
    ingest: str = "streamed"      # "streamed": stage chosen frames into
    #   pinned slabs, copy each row chunk to the device as it fills, submit
    #   the already-resident batch (runtime/ingest.py — the same streamed
    #   assembler the single-stream pipeline uses); "monolithic": the
    #   classic stage-all → engine.submit path
    ingest_depth: int = 4         # in-flight chunk-copy window
    egress: str = "streamed"      # result fetch path: "streamed" issues
    #   the D2H on the engine's D2H stream at submit and materializes
    #   into a preallocated host slab at collect (runtime/egress.py;
    #   auto-degrades where streaming cannot win); "monolithic" is the
    #   classic whole-batch host copy escape hatch
    replica_label: Optional[str] = None  # fleet tier: this frontend is
    #   replica N of a fleet — every fault record it emits carries the
    #   label, so the merged fleet export can attribute per-replica
    #   (resilience.faults.FaultStats). None outside a fleet.
    trace: bool = False           # arm this frontend's Tracer (bounded
    #   event ring, obs.trace): dispatch/device/H2D/D2H lanes, mergeable
    #   fleet-wide via Tracer.snapshot() — also the flight recorder's
    #   always-on black box
    telemetry_sample_s: float = 0.0  # TimeSeriesRing cadence: the bounded
    #   sliding window of load-control signals (fps, p50/p99, queue
    #   depth, SLO headroom, overlap efficiencies, per-kind fault rates)
    #   behind /timeseries and the burn-rate trigger. 0 = off (a window
    #   nothing reads is a per-second percentile merge wasted — the CLI
    #   turns it on with --metrics-port, and arming flight_dir enables
    #   it automatically at 1 Hz since the burn trigger reads it).
    flight_dir: Optional[str] = None  # SLO flight recorder: post-mortem
    #   dumps (merged trace + stats + telemetry window) land here when
    #   the watchdog trips, a fault budget overflows (frontend failure),
    #   or the SLO burn rate crosses slo_burn_threshold. None = off.
    flight_min_interval_s: float = 10.0  # dump rate limit
    flight_max_total_bytes: Optional[int] = 256 * 1024 * 1024  # on-disk
    #   bound across all dumps: past it the oldest are evicted (the
    #   newest always survives). None = count cap (max_dumps) only.
    slo_burn_threshold: float = 0.5  # fraction of a sampling window's
    #   deliveries missing their SLO that trips a flight dump (needs
    #   flight_dir + the telemetry ring); 0 disables the burn trigger
    flight_profile_s: float = 0.0  # >0: each dump also opens a
    #   device-profiler capture window of this length (device lanes in
    #   the post-mortem); off by default — profiling is not free
    control: bool = False         # arm the load-adaptive control plane
    #   (dvf_tpu_torch.control): closed-loop controllers over the telemetry
    #   ring actuating per-bucket batch size + tick budget, per-session
    #   resolution downshift (sr upscale return path), and the
    #   priority-tier admission floor (--control on the CLI)
    control_config: Any = None    # control.ControlConfig; None = defaults
    default_tier: int = 1         # tier for open_stream(tier=None):
    #   0 interactive (sheds last), 1 standard, 2 batch (sheds first)
    lineage: bool = False         # arm frame-lineage attribution
    #   (obs.lineage): every frame carries a span context through
    #   ingress → bucket queue → assemble/H2D → device → D2H → deliver,
    #   each delivered frame's components summing to its end-to-end
    #   latency; aggregates behind stats()['attribution'], signals()
    #   attr_*, and the explain() surface; SLO-breaching frames retain
    #   full lineage as flight-dump exemplars (--lineage on the CLI)
    lineage_exemplars: int = 64   # exemplar retention bound (breaches +
    #   slowest-K-per-window records kept for post-mortems)
    profile_dir: Optional[str] = None  # persist per-signature stage-cost
    #   profiles here (sibling of the compile cache): measured
    #   per-component costs written at bucket retirement/stop, loaded at
    #   bucket creation to seed tick-cost estimates and annotate
    #   control-plane decisions. None = no persistence.
    audit: bool = False           # the audit plane (obs.audit):
    #   sampled shadow-replay of delivered frames against a golden
    #   eager re-execution (every audit_sample_every-th staged
    #   frame, judged off the hot threads), plus the program-swap
    #   equivalence guard — every recompile adopted by a batch resize,
    #   quality rebind, or recovery rebuild ledgers a probe-digest
    #   verdict. Exports: stats()["audit"], audit_* signals,
    #   dvf_audit_* samples, /audit, flight-dump audit.json; the first
    #   CONFIRMED corruption trips a flight dump. Overhead gated ≤3%
    #   fps in the reference. Off by default (--audit).
    audit_sample_every: int = 64  # shadow-replay sampling period K:
    #   every Kth staged frame is re-executed on the golden path
    audit_seed: int = 0           # sampler phase (deterministic replay)
    audit_tolerance: float = 2.0  # pinned max-abs-diff tolerance for
    #   chains whose compute leaves uint8 (jit-vs-unjit float rounding
    #   freedom); uint8_ok chains compare bit-exact regardless
    broadcast_sub_queue: int = 8  # broadcast plane (dvf_tpu_torch.broadcast,
    #   built lazily at the first open_stream(publish=...)): default
    #   per-subscriber drop-oldest bound — a slow watcher drops its own
    #   frames, never the tier's
    broadcast_ingest_depth: int = 8   # publisher-tap → fan-out worker
    #   queue bound (drop-oldest: fan-out pressure sheds whole frames
    #   before any tier encodes them, the publisher never blocks)
    broadcast_evict_after: int = 32   # consecutive displaced puts before
    #   a dead subscriber is evicted from its lane
    broadcast_keyframe_interval: int = 16  # delta-tier keyframe cadence;
    #   also sets the per-tier forced-keyframe cooldown (interval // 2)
    broadcast_audit_wire: bool = False  # stamp every tier payload with
    #   the obs.audit envelope at the tier encoder — one stamp per tier
    #   per frame, verified by the FINAL subscriber even across relay
    #   hops (chaos `corrupt_wire` rides config.chaos)
    ledger: bool = True           # compile & reconfiguration ledger +
    #   memory accounting (obs.ledger / obs.memory): every compile,
    #   pool acquire/evict, batch resize, quality rebind, and engine
    #   rebuild lands as a structured event (cause, wall cost, measured
    #   bucket stall) in a bounded ring — stats()["ledger"], /ledger,
    #   the dvf_compile_ms histogram, dvf_mem_* gauges, a dedicated
    #   Perfetto lane, and flight-dump ledger.json. Default ON: events
    #   are reconfiguration-rate, not frame-rate (overhead gated ≤2%
    #   fps in the reference). False = none of it.
    autoplan: bool = False        # auto-plan plane (control.planner):
    #   at startup, resolve an operating plan for the primary signature
    #   — plan-cache hit (warm restart: < 50 ms, no search), else a
    #   measured candidate search (analytic prune from the compile-time
    #   calibrations + stage profiles, then short paced bursts through
    #   THIS frontend for ≤ 1/3 of the grid), apply the winner (batch
    #   size, tick, ingest/egress + depth) and hand the load
    #   controllers its envelope. Every decision ledgers as a PLAN
    #   event with its measured search cost (--autoplan on the CLI).
    autoplan_burst_frames: int = 48  # paced frames per live candidate
    #   leg (short on purpose: the search runs before traffic is
    #   admitted, and the analytic prune already did the ranking)
    plan_cache_dir: Optional[str] = None  # on-disk plan + calibration
    #   cache (control.plan_cache), sibling of the compile cache:
    #   winning plans keyed by (signature, geometry, topology
    #   fingerprint, planner version); compile-time calibration triples
    #   keyed per topology — warm restarts skip both the plan search
    #   and the blocking calibration passes at engine compile. None
    #   with autoplan on = plan is searched but never persisted.


class _Bucket:
    """One serving signature's slice of the frontend.

    A bucket owns everything that is per-compiled-program: the leased
    ``Engine`` (from the frontend's :class:`ProgramPool`), the pinned
    frame geometry/dtype, its sessions, the streamed ingest assembler
    and egress fetcher built against THAT engine's streams, a
    per-bucket :class:`ErrorBudget` (fault attribution is per bucket —
    one tenant mix's broken program must not spend another's budget),
    and the MEASURED tick-cost estimate the EDF/cost bucket scheduler
    scores it by (``Engine.step_block_ms`` calibration seed + an EWMA
    over observed batch wall times).
    """

    _EWMA_ALPHA = 0.2

    def __init__(self, config: "ServeConfig", filt: Filter, op_chain: str,
                 engine: Engine, key: Optional[SignatureKey] = None):
        self.config = config
        self.filter = filt
        self.op_chain = op_chain        # canonical chain spelling
        self.engine = engine
        self.key = key                  # SignatureKey once pinned
        self.sessions: Dict[str, StreamSession] = {}
        self.frame_shape: Optional[tuple] = (tuple(key.geometry)
                                             if key is not None else None)
        self.frame_dtype = key.np_dtype if key is not None else None
        self.budget = ErrorBudget(limit=config.fault_budget,
                                  window_s=config.fault_window_s)
        self.faults: Dict[str, int] = {}   # per-bucket kind counters
        self.inflight_batches = 0          # guarded by _count_lock:
        #   dispatch increments, collect decrements, recovery resets —
        #   an unsynchronized `+=` across those threads can lose an
        #   update and leave the counter pinned >0, which would make
        #   idle() permanently false (a silent admission outage at the
        #   bucket cap)
        self._count_lock = threading.Lock()
        self.batches = 0
        self.routed_frames = 0             # lifetime rows demuxed for
        #   this bucket (ResultRouter.route) — monotone across session
        #   retirement, unlike a per-live-session sum
        self.batch_size = config.batch_size  # per-bucket device batch
        #   rows — the control plane's batch controller resizes this
        #   from measured occupancy via a HOT SWAP: the successor
        #   program compiles aside while this bucket keeps dispatching
        #   at the old size; the commit swings the program pointer
        #   between ticks, and in-flight batches drain on the old
        #   program (their collect fetches through plan.fetcher)
        self.mean_valid_rows: Optional[float] = None  # EWMA of VALID
        #   rows per served batch — the occupancy signal batch sizing
        #   divides by (rows beyond it are padding the device computes
        #   and drops)
        self.ingest_mode = config.ingest
        self.degrade_reason: Optional[str] = None
        self.egress_mode = config.egress
        self.egress_degrade_reason: Optional[str] = None
        self.assembler: Optional[ShardedBatchAssembler] = None
        self.ingest_stats: Optional[IngestStats] = None
        self.fetcher: Optional[ShardedBatchFetcher] = None
        self.draining_fetchers: List[ShardedBatchFetcher] = []  # egress
        #   fetchers retired by a hot swap while batches prefetched into
        #   them were still in flight (those fetch through plan.fetcher);
        #   released by collect once the bucket's window drains to zero
        self.egress_stats: Optional[EgressStats] = None
        self._tick_cost_ms: Optional[float] = None  # live EWMA
        self.last_dispatch_t: Optional[float] = None  # wall clock of
        #   this bucket's most recent batch submit — the reconfiguration
        #   ledger measures a bucket stall as the gap in these ticks
        #   around an event (obs.ledger.ReconfigLedger.note_dispatch)
        self._label_cache: Optional[str] = None
        self._label_key: Optional[SignatureKey] = None
        self.stage_profile: Optional[dict] = None  # persisted
        #   per-signature stage-cost profile (obs.lineage), loaded at
        #   creation when the frontend has a profile_dir: measured
        #   component costs from PREVIOUS runs of this package — seeds
        #   the tick-cost estimate before the first live sample
        self._pooled = False  # engine leased/adopted in the ProgramPool

    # -- scheduling ------------------------------------------------------

    def tick_cost_estimate(self) -> float:
        """Measured per-batch cost in ms for the EDF/cost score: the
        live EWMA when ticks have been observed, else the compile-time
        step calibration, else a 1 ms floor (a bucket is never scored
        on a guess for longer than its first batch)."""
        if self._tick_cost_ms is not None:
            return self._tick_cost_ms
        cal = getattr(self.engine, "step_block_ms", None)
        if cal:
            return cal
        prof = self.stage_profile
        if prof and prof.get("tick_cost_ms"):
            # A previous run's MEASURED cost beats the 1 ms guess for
            # the window before this run's first live sample.
            return float(prof["tick_cost_ms"])
        return 1.0

    def observe_tick(self, wall_ms: float, sample: bool = True,
                     valid: Optional[int] = None) -> None:
        """Collect-side cost sample (submit → materialized, wall).
        ``sample=False`` counts the batch without feeding the cost EWMA —
        the wall time of a batch that queued behind other in-flight
        work measures the pipeline, not this bucket's program.
        ``valid`` (real rows in the batch) always feeds the occupancy
        EWMA: queueing doesn't contaminate a row count."""
        self.batches += 1
        a = self._EWMA_ALPHA
        if valid is not None:
            if self.mean_valid_rows is None:
                self.mean_valid_rows = float(valid)
            else:
                self.mean_valid_rows = ((1 - a) * self.mean_valid_rows
                                        + a * float(valid))
        if wall_ms <= 0 or not sample:
            return
        if self._tick_cost_ms is None:
            self._tick_cost_ms = wall_ms
        else:
            self._tick_cost_ms = (1 - a) * self._tick_cost_ms + a * wall_ms

    def record_fault(self, kind: str) -> None:
        self.faults[kind] = self.faults.get(kind, 0) + 1

    def adjust_inflight(self, delta: int) -> None:
        with self._count_lock:
            self.inflight_batches = max(0, self.inflight_batches + delta)

    def reset_inflight(self) -> None:
        with self._count_lock:
            self.inflight_batches = 0

    def release_drained_fetchers(self) -> None:
        """Free swap-retired egress fetchers; call only when no batch
        prefetched into them can still be in flight (window at zero, or
        the bucket is being torn down)."""
        drained, self.draining_fetchers = self.draining_fetchers, []
        for f in drained:
            f.release()

    # -- signature -------------------------------------------------------

    def pinned_signature(self) -> Optional[tuple]:
        """The per-frame (shape, dtype) this bucket is committed to: the
        engine's compiled signature when one exists, else the geometry
        pinned by the first submit/declaration. None = still free (the
        default bucket before any traffic)."""
        sig = self.engine.signature
        if sig is not None:
            (batch_shape, dtype) = sig
            return (tuple(batch_shape[1:]), np.dtype(dtype))
        if self.frame_shape is not None:
            return (tuple(self.frame_shape), np.dtype(self.frame_dtype))
        return None

    def idle(self) -> bool:
        """True when this bucket could retire right now: no live
        sessions and nothing in flight on the device."""
        return not self.sessions and self.inflight_batches == 0

    def label(self) -> str:
        # Cached: label() sits on per-frame paths (attribution fold,
        # router row accounting) and a render is a string build.
        key = self.key
        if key is not None:
            if self._label_cache is None or self._label_key is not key:
                self._label_cache = key.render()
                self._label_key = key
            return self._label_cache
        return f"{self.op_chain}|unpinned"

    # -- observability ---------------------------------------------------

    def stats_row(self) -> dict:
        live = list(self.sessions.values())
        agg = LatencyStats.merged([s.latency for s in live])
        row = {
            "signature": self.label(),
            "op_chain": self.op_chain,
            "batch_size": self.batch_size,
            "mean_valid_rows": self.mean_valid_rows,
            "open_sessions": len(live),
            "queue_depth": sum(len(s.ingress) + len(s.pending)
                               for s in live),
            "inflight_batches": self.inflight_batches,
            "batches": self.batches,
            "tick_cost_ms": self._tick_cost_ms
            if self._tick_cost_ms is not None
            else getattr(self.engine, "step_block_ms", None),
            "fps": agg.get("fps"),
            "p50_ms": agg.get("p50_ms"),
            "p99_ms": agg.get("p99_ms"),
            "routed_frames_total": self.routed_frames,
            "shed_total": sum(s.shed for s in live),
            "faults": dict(self.faults),
            "fault_budget": self.budget.summary(),
            "engine_batches": self.engine.stats.batches,
            "engine_compile_count": self.engine.stats.compile_count,
        }
        if self.ingest_stats is not None:
            row["ingest"] = self.ingest_stats.summary()
        if self.egress_stats is not None:
            row["egress"] = self.egress_stats.summary()
        return row


class ServeFrontend:
    """Multi-tenant serving frontend: signature buckets over one device
    (see module docstring)."""

    def __init__(
        self,
        filt: Filter,
        config: Optional[ServeConfig] = None,
        engine: Optional[Engine] = None,
        device=None,
    ):
        """``device`` is where every bucket's engine runs: ``cuda:0``
        when None (raises without CUDA), ``"cpu"`` for the plain torch
        versions. A caller-built ``engine`` brings its own device, or its
        mesh (``Engine(filt, mesh=m)``): every bucket's engine then spans
        that mesh."""
        if filt.stateful:
            raise ValueError(
                f"filter {filt.name!r} is stateful; a shared batch "
                f"interleaves rows from different sessions, so temporal "
                f"state would leak across tenants — the serving frontend "
                f"only multiplexes stateless filters")
        self.filter = filt
        self.config = config or ServeConfig()
        if self.config.ingest not in INGEST_MODES:
            raise ValueError(
                f"ingest must be one of {INGEST_MODES}, got "
                f"{self.config.ingest!r}")
        if self.config.egress not in EGRESS_MODES:
            raise ValueError(
                f"egress must be one of {EGRESS_MODES}, got "
                f"{self.config.egress!r}")
        engine = engine or Engine(filt, device=device,
                                  chaos=self.config.chaos)
        if self.config.chaos is not None and engine.chaos is None:
            engine.chaos = self.config.chaos  # arm caller-built engine
        self.device = engine.device  # every bucket's engine runs here
        self.mesh = engine.mesh  # ... over this mesh, when the caller's
        #   engine spans one (None: the one device)
        # Signature buckets: the DEFAULT bucket (index 0) carries the
        # constructor filter/engine and keeps the legacy single-
        # signature behavior (geometry pinned by the first submit or
        # declaration); further buckets are created at admission when a
        # session declares a different (op_chain, geometry, dtype).
        default_chain = canonical_op_chain_or_verbatim(filt.name)
        self.pool = ProgramPool(capacity=self.config.pool_capacity)
        self._buckets: List[_Bucket] = [
            _Bucket(self.config, filt, default_chain, engine)]
        self._bucket_by_key: Dict[SignatureKey, _Bucket] = {}
        # Live Filter objects by canonical chain. A filter's DISPLAY
        # name (e.g. "gaussian_blur(ksize=9)" resolved to its kernel
        # impl) is not necessarily a buildable registry spec — so a new
        # geometry of an ALREADY-SERVED chain must reuse the existing
        # Filter object (filters are frozen dataclasses, shareable
        # across engines) instead of round-tripping through
        # build_filter. Only a never-seen chain builds from the spec.
        self._filters_by_chain: Dict[str, Filter] = {default_chain: filt}
        self.batcher = ContinuousBatcher(self.config.batch_size)
        self.router = ResultRouter()
        self._lock = threading.Lock()
        self._sessions: Dict[str, StreamSession] = {}
        self._retired: Dict[str, StreamSession] = {}   # closed; poll-able
        # Process-lifetime counter floor: sessions evicted from the
        # bounded retired map (or release()d) fold their totals in here,
        # so the *_total series stay MONOTONE — a Prometheus counter
        # that shrinks when an old tenant ages out reads as a reset and
        # fakes a rate() spike.
        self._evicted_totals: Dict[str, int] = {
            k: 0 for k in ("submitted", "delivered", "shed", "slo_miss",
                           "failed", "dropped_at_ingress")}
        self._ids = itertools.count()
        self.admission_rejections = 0
        self.errors = 0
        self.faults = FaultStats(replica=self.config.replica_label)
        #   per-kind counters + last errors (replica-attributed in a fleet)
        # -- continuity plane (resilience.continuity) ----------------------
        self.continuity = ContinuityStats()
        self._token_secret = new_secret()  # signs this frontend's resume
        #   tokens; a fleet snapshot persists its own fleet-level secret
        #   so tokens survive a front-door restart — this one is
        #   process-lifetime only (serve tier has no crash-recovery story
        #   of its own; the session state IS this process)
        # -- telemetry plane (obs/): tracer lanes, metrics registry,
        # sliding signal window, flight recorder ---------------------------
        label = self.config.replica_label
        self.tracer = Tracer(
            enabled=self.config.trace,
            process_name=f"serve:{label}" if label else "serve")
        self.registry = MetricsRegistry()
        attach_signal_provider(
            self.registry, "serve", self.signals,
            labels={"replica": label} if label else None)
        # -- compile & reconfiguration ledger + memory accounting ----------
        self.ledger: Optional[ReconfigLedger] = None
        self.compile_hist = None
        self.swap_hist = None
        self._leak_watch: Optional[LeakTrendWatch] = None
        if self.config.ledger:
            self.ledger = ReconfigLedger(tracer=self.tracer)
            # Every compile, labeled by canonical signature AND cause
            # (admission/resize/recovery/precompile/morph) — the
            # distribution the hot-swap work is judged against.
            self.compile_hist = self.registry.histogram(
                "compile_ms", COMPILE_MS_BOUNDS)
            # Per-swap serving cost (the commit's measured wall on the
            # dispatch thread): the distribution the "stall-free"
            # claim is audited against — dvf_swap_stall_ms on /metrics.
            self.swap_hist = self.registry.histogram(
                "swap_stall_ms", SWAP_STALL_MS_BOUNDS)
            self.pool.observer = self._on_pool_event
            attach_memory_provider(self.registry,
                                   bucket_rows_fn=self._memory_bucket_rows)
            self._leak_watch = LeakTrendWatch()
        # -- audit plane (obs.audit): shadow replay + swap guard -----------
        self.audit: Optional[AuditPlane] = None
        if self.config.audit:
            self.audit = AuditPlane(
                sample_every=self.config.audit_sample_every,
                seed=self.config.audit_seed,
                tolerance=self.config.audit_tolerance,
                tracer=self.tracer,
                ledger=self.ledger,
                flight_cb=self._flight_trip,
                fault_cb=lambda e: self.faults.record(
                    FaultKind.INTEGRITY, e),
                label=f"serve-{label}" if label else "serve")
            attach_audit_provider(self.registry, self.audit)
        # -- frame-lineage attribution plane (obs.lineage) -----------------
        self.attribution: Optional[AttributionPlane] = None
        if self.config.lineage:
            self.attribution = AttributionPlane(
                exemplar_capacity=self.config.lineage_exemplars)
        # -- broadcast plane (dvf_tpu_torch.broadcast) ---------------------
        # Built lazily at the first open_stream(publish=...): plain
        # per-session serving pays nothing for the fan-out machinery.
        self.broadcast: Any = None
        # -- load-adaptive control plane (dvf_tpu_torch.control) ----------
        # Built BEFORE the ring so the ring cadence can come from the
        # control config; the plane's decisions ride the ring's
        # on_sample seam (chained with the SLO burn check below).
        self.control_plane = None
        self._admission_tier_floor: Optional[int] = None  # controller-
        #   set admission floor: open_stream refuses tier > floor
        self._tick_s = self.config.tick_s  # live dispatch tick (the
        #   control plane's tick-budget actuator writes it)
        self._pending_resizes: Dict[_Bucket, Any] = {}  # bucket →
        #   (n, reason): the dispatch thread kicks each off as a
        #   compile-aside (Engine.prepare_swap on a background thread;
        #   the bucket KEEPS dispatching at the old size throughout)
        self._pending_rebinds: "queue.Queue" = queue.Queue()  # (sid,
        #   key, level, reason, morph_chain) quality moves / morphs —
        #   applied by the dispatch thread, which owns the session
        #   pending deques being flushed
        self._pending_commits: "queue.Queue" = queue.Queue()  # staged
        #   hot swaps whose aside-compile finished: the dispatch thread
        #   commits each between ticks (one pointer swing — a batch
        #   never straddles the old and new programs)
        self._preparing_swaps: set = set()  # buckets with an aside-
        #   prepare in flight (one at a time per bucket; a newer
        #   pending resize waits its turn)
        self.swaps = 0        # committed hot swaps
        self.swap_aborts = 0  # failed prepares/commits (old program
        #   kept serving — the contained-abort contract)
        self.morphs = 0       # committed live filter-chain morphs
        self.quality_rebinds = 0
        self.quality_rebinds_dropped = 0
        self._warmed_quality: set = set()   # quality keys pre-compiled
        #   at admission time (control armed): the moment the quality
        #   controller needs the downshift program is mid-overload —
        #   the worst time to pay a compile on a busy host
        self.quality_flushed_frames = 0   # frames dropped by rebind
        #   flushes — kept OUT of shed_total (the pressure predicate
        #   reads shed deltas; the controller's own moves must not feed
        #   back as overload evidence)
        self.resize_compile_errors = 0
        # -- auto-plan plane (dvf_tpu_torch.control.planner) ----------------
        self.applied_plan: Optional[dict] = None  # the Plan doc driving
        #   this frontend (autoplan() or a fleet front door applied it);
        #   None = the hand-set ServeConfig defaults
        self._topology: Optional[str] = None  # cached topology
        #   fingerprint (control.plan_cache) — the plan/calibration
        #   cache's invalidation axis; computed once from the device
        control_sample_s = 0.0
        if self.config.control:
            from dvf_tpu_torch.control import ControlConfig, ControlPlane

            ccfg = self.config.control_config or ControlConfig()
            if ccfg.batch_max <= 0:
                # The compiled staging/slab pools size from the
                # frontend batch_size; the controller may shrink below
                # it, never grow past it.
                ccfg = dataclasses.replace(ccfg,
                                           batch_max=self.config.batch_size)
            self.control_plane = ControlPlane(self, ccfg)
            control_sample_s = ccfg.interval_s
        self.telemetry: Optional[TimeSeriesRing] = None
        sample_s = self.config.telemetry_sample_s or control_sample_s or (
            1.0 if self.config.flight_dir else 0.0)  # burn trigger +
        #   post-mortem window need the ring; plain serving doesn't pay
        if sample_s > 0:
            self.telemetry = TimeSeriesRing(
                self.signals,
                interval_s=sample_s,
                name="dvf-serve-telemetry",
                on_sample=self._on_telemetry_sample)
        self.flight: Optional[FlightRecorder] = None
        if self.config.flight_dir:
            self.flight = FlightRecorder(
                self.config.flight_dir,
                label=f"serve-{label}" if label else "serve",
                min_interval_s=self.config.flight_min_interval_s,
                max_total_bytes=self.config.flight_max_total_bytes,
                trace_fn=lambda: [self.tracer.snapshot()],
                stats_fn=self.stats,
                ring=self.telemetry,
                profile_s=self.config.flight_profile_s,
                lineage_fn=(self.attribution.snapshot
                            if self.attribution is not None else None),
                ledger_fn=(self.ledger.document
                           if self.ledger is not None else None),
                audit_fn=(self.audit.document
                          if self.audit is not None else None))
        self.registry.register_provider(self._bucket_samples)
        #   per-bucket queue depth / p99 + the compile-cache counters
        #   (dvf_compile_cache_hits_total / _misses_total,
        #   dvf_pool_evictions_total) — unprefixed provider, so the
        #   series names are fleet-wide, not per-tier
        self._draining = False       # fleet drain hook: open_stream refuses
        self._retired_bucket_costs: Dict[str, Optional[float]] = {}
        #   label → tick_cost_ms of buckets retired for headroom —
        #   their measured costs must still persist at stop
        #   (profile_dir); recorded at retirement (no I/O under the
        #   admission lock), flushed by _persist_stage_profiles.
        self.recoveries = 0          # supervised engine rebuilds
        # Frontend-level budget = the default bucket's (fault budgets
        # attribute PER BUCKET — a broken signature's faults must not
        # spend another tenant mix's budget; non-bucket faults land here).
        self._budget = self._buckets[0].budget
        # Stall escalation is NOT time-windowed: stalls arrive at most
        # once per stall_timeout_s, so a sliding window can never fill.
        # Instead, consecutive recoveries with no successful batch in
        # between count up; a materialized batch resets the run. Past the
        # threshold the engine is declared unrecoverable.
        self._stalls_since_progress = 0
        self._stall_fail_after = max(2, self.config.fault_budget // 4)
        # In-flight registry (submit → materialize/discard), maintained
        # even with the watchdog off: budget-driven recovery must be able
        # to shed batches a wedged collect thread is holding.
        self._window = InflightWindow()
        self._supervisor: Optional[Supervisor] = None
        self._recovering = threading.Event()  # dispatch parks while set
        self._dispatch_parked = threading.Event()  # ack of that park
        self._dispatch_thread: Optional[threading.Thread] = None
        self._recover_lock = threading.Lock()
        self._collect_gen = 0  # bumped by recovery; a stale collect thread
        #   exits at its next loop check (and a wedged one, when it wakes)
        # Plain unbounded FIFO: depth is already bounded by the semaphore,
        # and drop-oldest semantics here would silently leak a permit and
        # the dropped batch's inflight claims.
        self._inflight: "queue.Queue" = queue.Queue()
        self._inflight_sem = threading.Semaphore(self.config.max_inflight)
        self._stop = threading.Event()
        self._dispatch_done = threading.Event()
        self._error: Optional[BaseException] = None
        self._threads: List[threading.Thread] = []

    @property
    def engine(self) -> Engine:
        """The DEFAULT bucket's engine — the legacy single-signature
        surface (tests monkeypatch its submit; the fleet's local factory
        hands one in). Multi-signature callers reach per-bucket engines
        through ``stats()['buckets']``/the pool."""
        return self._buckets[0].engine

    @engine.setter
    def engine(self, value: Engine) -> None:
        self._buckets[0].engine = value

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ServeFrontend":
        if self._threads:
            raise ServeError("frontend already started")
        self._threads = [
            threading.Thread(target=self._dispatch, name="dvf-serve-dispatch",
                             daemon=True),
            threading.Thread(target=self._collect, name="dvf-serve-collect",
                             daemon=True, args=(0,)),
        ]
        self._dispatch_thread = self._threads[0]
        for t in self._threads:
            t.start()
        if self.config.stall_timeout_s > 0:
            self._supervisor = Supervisor(
                self.config.stall_timeout_s, on_stall=self._on_stall,
                name="dvf-serve-supervisor", window=self._window,
                on_trip=self._flight_trip)
            self._supervisor.start()
        if self.control_plane is not None:
            self.control_plane.start()
        if self.telemetry is not None:
            self.telemetry.start()
        if self.audit is not None:
            self.audit.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful shutdown: stop batching new work, drain what's in
        flight, deliver every session's tail, retire all sessions."""
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.stop()
        if self.audit is not None:
            self.audit.stop()
        if self.control_plane is not None:
            self.control_plane.stop()
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry.sample_once()  # terminal row: a short run still
            #   leaves a window for the post-mortem/scrape to read
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=timeout)
        with self._lock:
            sessions = list(self._sessions.items())
            for sid, s in sessions:
                if s.bucket is not None:
                    s.bucket.sessions.pop(sid, None)
                self._retire_locked(sid, s)
            self._sessions.clear()
            buckets = list(self._buckets)
        for _, s in sessions:
            s.finalize()
        if self.broadcast is not None:
            # After the session tail delivery (finalize still taps) and
            # before device/slab release: fan-out workers, relays, and
            # tier codecs all join here — the broadcast leak guards pin
            # that nothing outlives stop().
            self.broadcast.stop(timeout=timeout)
        # Release every compiled program's device residency: pooled
        # engines free through the pool; an engine that never made it
        # into the pool (default bucket that never compiled, adoption
        # race) frees directly. Idempotent — pinned by the port's leak
        # guards (runtime.engine.live_pool_engines).
        self.pool.close()
        for b in buckets:
            b.engine.free()
            # Release every bucket's host staging/delivery slabs
            # eagerly (the retirement path already does; live buckets
            # must too): the memory-accounting guards pin that a closed
            # frontend leaves ZERO occupied host slabs.
            a, b.assembler = b.assembler, None
            f, b.fetcher = b.fetcher, None
            if a is not None:
                a.release()
            if f is not None:
                f.release()
            b.release_drained_fetchers()
            if self.ledger is not None:
                self.ledger.abandon_stalls(b.label())
        if self.config.profile_dir:
            # Persist this run's measured per-signature stage costs
            # (sibling of the compile cache): the next run's buckets
            # start from MEASURED numbers.
            self._persist_stage_profiles(buckets)
        if self._error is not None:
            raise self._error

    def _persist_stage_profiles(self, live_buckets) -> None:
        """Best-effort stage-cost persistence at stop: one profile per
        signature measured THIS run — live buckets plus buckets retired
        for headroom along the way (their tick costs were recorded at
        retirement; their attribution windows survive in the plane,
        keyed by label). Deduped by label; a live bucket's newer tick
        cost wins over a retired record's. Never raises — profiles are
        optimization state, not worth failing a shutdown over."""
        with self._lock:
            pending: Dict[str, Optional[float]] = dict(
                self._retired_bucket_costs)
        for b in live_buckets:
            if b.key is None:
                continue
            tick = b._tick_cost_ms
            if tick is None:
                tick = getattr(b.engine, "step_block_ms", None)
            pending[b.key.render()] = tick
        for label, tick in pending.items():
            comps: dict = {}
            count = 0
            if self.attribution is not None:
                doc = self.attribution.bucket_profile_doc(label)
                if doc is not None:
                    comps = doc["components"]
                    count = doc["count"]
            if comps or tick:
                save_stage_profile(self.config.profile_dir, label,
                                   comps, tick_cost_ms=tick, count=count)

    def _bucket_stage_cost(self, bucket: "_Bucket") -> Optional[dict]:
        """Measured mean per-component cost for one bucket: the live
        attribution window when lineage is running, else the persisted
        profile from a previous run — what control-plane decisions are
        annotated with."""
        if self.attribution is not None:
            live = self.attribution.bucket_stage_cost_ms(bucket.label())
            if live:
                return live
        prof = bucket.stage_profile
        if prof and prof.get("components_ms"):
            return {k: round(float(v.get("mean_ms", 0.0)), 4)
                    for k, v in prof["components_ms"].items()}
        return None

    def __enter__(self) -> "ServeFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- replica-embeddable lifecycle (fleet drain hooks) ---------------

    def begin_drain(self) -> None:
        """Stop admitting new sessions; existing ones keep flowing.
        The first half of a fleet replica drain — reversible only by
        building a fresh frontend (a draining replica restarts, it does
        not un-drain)."""
        with self._lock:
            self._draining = True

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful replica drain: refuse new sessions, close every open
        session with ``drain=True`` (queued + in-flight frames still
        deliver), and wait until all of them have retired. Returns True
        when fully drained within ``timeout`` — False means frames may
        still be in flight (a broken engine can't serve its tail; the
        fleet tier writes those off as ``replica`` losses)."""
        self.begin_drain()
        with self._lock:
            sids = list(self._sessions)
        for sid in sids:
            try:
                self.close(sid, drain=True)
            except KeyError:
                pass  # retired between the snapshot and the close
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.open_count() == 0:
                return True
            if self._error is not None or self._stop.is_set():
                break
            time.sleep(0.005)
        return self.open_count() == 0

    def health(self) -> dict:
        """Cheap liveness/health export for a fleet monitor: no
        percentile work, no per-session scan — safe to poll at hertz
        rates over an RPC. ``ok`` is False once the frontend has failed
        hard (error budget exhausted / fail-fast fault): the fleet
        drains and replaces such a replica."""
        err = self._error
        return {
            "ok": err is None,
            "error": repr(err) if err is not None else None,
            "draining": self._draining,
            "open_sessions": self.open_count(),
            "recoveries": self.recoveries,
            "fault_total": self.faults.total(),
            "stalls": (self._supervisor.stalls
                       if self._supervisor is not None else 0),
            # Signatures this frontend serves without a cold compile —
            # what a fleet's signature-aware spillover prefers a replica
            # by, and what its rejections enumerate. Cheap: a key-list
            # copy, no percentile work.
            "warm_signatures": self._warm_signatures(),
        }

    def load_row(self) -> dict:
        """The per-replica load summary the fleet monitor caches for
        its ELASTIC view (rides the health RPC, one row per poll):
        queue depth, occupancy, the monotone delivery/shed/refusal
        counters, and one weighted percentile merge — ``signals()``'s
        only aggregate cost, at ``health()``'s cadence. Everything the
        fleet elasticity controller reads per replica, nothing more."""
        with self._lock:
            live = list(self._sessions.values())
            retired = list(self._retired.values())
            floor = dict(self._evicted_totals)
        every = retired + live
        agg = LatencyStats.merged([s.latency for s in every])
        p99 = agg.get("p99_ms")
        return {
            "open_sessions": float(len(live)),
            "queue_depth": float(sum(
                len(s.ingress) + len(s.pending) for s in live)),
            "p99_ms": p99 if (p99 is not None and p99 == p99) else None,
            "delivered_total": float(floor["delivered"] + sum(
                s.delivered for s in every)),
            "shed_total": float(floor["shed"] + sum(
                s.shed for s in every)),
            "slo_miss_total": float(floor["slo_miss"] + sum(
                s.slo_miss for s in every)),
            "admission_rejections_total": float(self.admission_rejections),
        }

    def latency_snapshot(self) -> dict:
        """All sessions' latency samples as ONE mergeable snapshot
        (``LatencyStats.combined``) — the per-replica half of the fleet
        p50/p99 export; the front door merges replicas' snapshots with
        ``LatencyStats.merge_snapshots``."""
        with self._lock:
            every = {**self._retired, **self._sessions}
        return LatencyStats.combined([s.latency for s in every.values()])

    def signals(self) -> dict:
        """The flat load-control signal set — one dict, registry-
        conformant keys, cheap enough to sample at hertz rates: what the
        TimeSeriesRing windows, the ``/metrics`` provider scrapes
        (``obs.export.samples_from_signals``), and a load-adaptive
        controller would read. Counter reads are GIL-atomic ints; the
        only aggregate math is one weighted percentile merge."""
        with self._lock:
            live = list(self._sessions.values())
            retired = list(self._retired.values())
            floor = dict(self._evicted_totals)
            buckets = list(self._buckets)
        every = retired + live
        agg = LatencyStats.merged([s.latency for s in every])
        p99 = agg.get("p99_ms")
        headroom = (self.config.slo_ms - p99
                    if p99 is not None and p99 == p99 else None)
        out = {
            "fps": agg.get("fps"),
            "p50_ms": agg.get("p50_ms"),
            "p90_ms": agg.get("p90_ms"),
            "p99_ms": agg.get("p99_ms"),
            "slo_headroom_ms": headroom,
            # Standing work: frames queued before a device slot plus
            # batches in flight — the queueing-delay signal a dynamic
            # batch/tick controller keys off.
            "queue_depth": float(sum(
                len(s.ingress) + len(s.pending) for s in live)),
            "inflight_batches": float(len(self._window)),
            "open_sessions": float(len(live)),
            "retired_sessions": float(len(retired)),
            # Lifetime counters: live + retired sessions PLUS the floor
            # absorbed from evicted ones — monotone across retirement-
            # bound churn (a counter must never go backward).
            "submitted_total": float(floor["submitted"] + sum(
                s.submitted for s in every)),
            "delivered_total": float(floor["delivered"] + sum(
                s.delivered for s in every)),
            "shed_total": float(floor["shed"] + sum(
                s.shed for s in every)),
            "slo_miss_total": float(floor["slo_miss"] + sum(
                s.slo_miss for s in every)),
            "failed_total": float(floor["failed"] + sum(
                s.failed for s in every)),
            "dropped_at_ingress_total": float(
                floor["dropped_at_ingress"] + sum(
                    s.ingress.dropped for s in every)),
            "admission_rejections_total": float(self.admission_rejections),
            "errors_total": float(self.errors),
            "recoveries_total": float(self.recoveries),
            "engine_batches_total": float(sum(
                b.engine.stats.batches for b in buckets)),
            "engine_frames_total": float(sum(
                b.engine.stats.frames for b in buckets)),
            "trace_dropped_total": float(self.tracer.dropped),
            # Multi-signature plane: live buckets + the compiled-program
            # pool's hit/miss/eviction counters (the admission-cost
            # story: a hit is a warm admit, a miss a cold compile).
            "open_buckets": float(len(buckets)),
            "compile_cache_hits_total": float(self.pool.hits),
            "compile_cache_misses_total": float(self.pool.misses),
            "pool_evictions_total": float(self.pool.evictions),
            "pool_size": float(len(self.pool)),
            # Hot-swap plane: committed program swaps, contained aborts
            # (old program kept serving), live filter-chain morphs.
            "swaps_total": float(self.swaps),
            "swap_aborts_total": float(self.swap_aborts),
            "morphs_total": float(self.morphs),
        }
        out.update(self.continuity.signals())
        if self._supervisor is not None:
            out["stalls_total"] = float(self._supervisor.stalls)
        if self.control_plane is not None:
            # Control-plane decision counters (the acceptance bar:
            # controller actions are observable on the scrape endpoint)
            # plus the live actuation state.
            for k, v in self.control_plane.signals().items():
                out[f"control_{k}"] = v
            out["control_quality_rebinds_total"] = float(
                self.quality_rebinds)
            out["control_quality_rebinds_dropped_total"] = float(
                self.quality_rebinds_dropped)
            out["control_quality_flushed_frames_total"] = float(
                self.quality_flushed_frames)
            out["control_resize_compile_errors_total"] = float(
                self.resize_compile_errors)
            out["downshifted_sessions"] = float(sum(
                1 for s in live if s.quality_level > 0))
            out["dispatch_tick_s"] = float(self._tick_s)
        ing = self._buckets[0].ingest_stats
        egr = self._buckets[0].egress_stats
        if ing is not None:
            out["ingest_overlap_efficiency"] = ing.overlap_efficiency()
        if egr is not None:
            out["egress_overlap_efficiency"] = egr.overlap_efficiency()
        if self.ledger is not None:
            out.update(self.ledger.signals())
            # Occupied host staging/delivery slabs (cheap per-bucket
            # sums) — also the leak-trend watch's input via the ring.
            slab, state = self._slab_state_bytes(buckets)
            out["mem_host_slab_bytes"] = float(slab)
            out["mem_device_state_bytes"] = float(state)
        if self.attribution is not None:
            # Frame-lineage attribution: per-component p99 over the
            # window (attr_<component>_p99_ms) + lineage counters —
            # the "where did my p99 go" row, scrapeable per second.
            out.update(self.attribution.signals())
        if self.audit is not None:
            out.update(self.audit.signals())
        if self.broadcast is not None:
            out.update(self.broadcast.signals())
        for kind, n in self.faults.summary()["by_kind"].items():
            out[f"fault_{kind}_total"] = float(n)
        return out

    def audit_probe(self, signature: Optional[str] = None) -> dict:
        """Run the deterministic probe frame through one compiled
        bucket's program and return its output digest — the unit a
        fleet's cross-replica divergence detector compares (every
        replica derives the SAME probe pixels from the signature, so
        equal programs must produce equal digests). ``signature``
        (a canonical render) picks the bucket; None probes the first
        compiled one. Raises ``ServeError`` when nothing is compiled."""
        with self._lock:
            buckets = list(self._buckets)
        engine = None
        label = None
        for b in buckets:
            if b.engine.signature is None or b.engine.freed:
                continue
            if signature is None or b.label() == signature:
                engine, label = b.engine, b.label()
                break
        if engine is None:
            # Pool-warm fallback: "warm on a signature" includes
            # programs whose bucket retired (or that only ever
            # precompiled) — health() advertises exactly those.
            for key in sorted(self.pool.warm_keys(),
                              key=lambda k: k.render()):
                if signature is None or key.render() == signature:
                    cand = self.pool.peek(key)
                    if cand is not None and not cand.freed \
                            and cand.signature is not None:
                        engine, label = cand, key.render()
                        break
        if engine is None:
            raise ServeError(
                f"no compiled program to probe"
                + (f" for signature {signature!r}" if signature else ""))
        stream = (self.audit.stream(engine.device)
                  if self.audit is not None else None)
        row = engine_probe_row(engine, stream=stream)
        return {"signature": label,
                "digest": frame_digest(row).hex()}

    def explain(self, q: float = 99.0) -> dict:
        """The latency-attribution ``explain`` surface: which components
        the slowest frames actually spent their time in, frontend-wide
        and per bucket — "p99 = 62% queue_bucket, 21% device, …". Empty
        when lineage is not armed (``ServeConfig.lineage``)."""
        if self.attribution is None:
            return {"lineage": False,
                    "hint": "arm ServeConfig.lineage / --lineage to "
                            "collect frame-lineage attribution"}
        return {"lineage": True, **self.attribution.explain(q)}

    def _bucket_samples(self) -> List[MetricSample]:
        """Registry provider: the per-bucket load/latency series
        (``bucket=`` label carries the canonical signature) plus the
        frontend-wide compile-cache counters — unprefixed, so the
        series are ``dvf_compile_cache_hits_total`` /
        ``dvf_bucket_queue_depth{bucket=…}`` etc. on the scrape."""
        out = [
            MetricSample("compile_cache_hits_total",
                         float(self.pool.hits), (), COUNTER),
            MetricSample("compile_cache_misses_total",
                         float(self.pool.misses), (), COUNTER),
            MetricSample("pool_evictions_total",
                         float(self.pool.evictions), (), COUNTER),
            MetricSample("pool_size", float(len(self.pool)), (), GAUGE),
        ]
        # Snapshot under the lock, merge percentiles AFTER releasing it
        # (stats()'s discipline): a scrape must not stall submit/open/
        # dispatch behind per-bucket percentile math.
        with self._lock:
            snap = [(b, list(b.sessions.values())) for b in self._buckets]
        rows = []
        for b, live in snap:
            rows.append((
                b.label(),
                sum(len(s.ingress) + len(s.pending) for s in live),
                len(live),
                b.inflight_batches,
                b.tick_cost_estimate(),
                LatencyStats.merged([s.latency for s in live]),
            ))
        for label, qd, n_live, inflight, cost, agg in rows:
            labels = (("bucket", label),)
            out.append(MetricSample("bucket_queue_depth", float(qd),
                                    labels, GAUGE))
            out.append(MetricSample("bucket_open_sessions", float(n_live),
                                    labels, GAUGE))
            out.append(MetricSample("bucket_inflight_batches",
                                    float(inflight), labels, GAUGE))
            out.append(MetricSample("bucket_tick_cost_ms", float(cost),
                                    labels, GAUGE))
            for pk in ("p50_ms", "p99_ms"):
                v = agg.get(pk)
                if v is not None and v == v:  # NaN (empty window) = gap
                    out.append(MetricSample(f"bucket_{pk}", float(v),
                                            labels, GAUGE))
        return out

    def _on_telemetry_sample(self, prev: Optional[dict], cur: dict) -> None:
        """The ring's on_sample hook: the SLO burn check, the leak-trend
        watch over the occupied host slabs, then the control plane's
        decision step. Each leg is contained on its own: a burn-check or
        leak-watch hiccup is counted on the ring's ``hook_errors`` and
        the controller still gets its tick; a raising decision step is
        counted by the ring, which keeps sampling."""
        try:
            self._check_slo_burn(prev, cur)
        except Exception:  # noqa: BLE001 — the controller still runs
            if self.telemetry is not None:
                self.telemetry.hook_errors += 1
        if self._leak_watch is not None:
            try:
                trip = self._leak_watch.observe(
                    cur.get("mem_host_slab_bytes"))
                if trip is not None:
                    print(f"[serve] {trip}", file=sys.stderr, flush=True)
                    self._flight_trip(trip)
            except Exception:  # noqa: BLE001 — same containment rule as
                if self.telemetry is not None:  # the burn check above
                    self.telemetry.hook_errors += 1
        if self.control_plane is not None:
            self.control_plane.on_sample(prev, cur)

    def _check_slo_burn(self, prev: Optional[dict], cur: dict) -> None:
        """Telemetry-ring hook: burn rate over one sampling window =
        fraction of the window's deliveries that missed their SLO; past
        the threshold, the flight recorder dumps (rate-limited there)."""
        threshold = self.config.slo_burn_threshold
        if self.flight is None or threshold <= 0 or prev is None:
            return
        delivered = (cur.get("delivered_total", 0)
                     - prev.get("delivered_total", 0))
        if delivered <= 0:
            return
        missed = cur.get("slo_miss_total", 0) - prev.get("slo_miss_total", 0)
        burn = missed / delivered
        if burn >= threshold:
            self.flight.trigger(
                f"slo burn rate {burn:.2f} >= {threshold:g} "
                f"({missed:.0f}/{delivered:.0f} deliveries past "
                f"{self.config.slo_ms:g}ms in one window)")

    def _flight_trip(self, reason: str) -> None:
        """Observability tap for failure events (watchdog on_trip,
        budget-exhaustion _fail, the leak watch, the audit plane's first
        confirmed corruption): dump the black box OFF-THREAD — the
        callers are supervision and recovery paths, and serializing a
        trace window to disk must not extend the stall it records."""
        if self.flight is not None:
            self.flight.trigger_async(reason)

    # -- reconfiguration ledger + memory accounting ----------------------

    def _on_pool_event(self, kind: str, cause=None, key=None, cache=None,
                       wall_ms=None, engine=None, **_extra) -> None:
        """ProgramPool observer: pool hits, cold compiles, and evictions
        land in the ledger; compiles also feed the dvf_compile_ms
        histogram. Called outside the pool lock; never raises into a
        lease (the pool swallows, but stay cheap anyway)."""
        led = self.ledger
        if led is None:
            return
        sig = key.render() if hasattr(key, "render") else (
            str(key) if key is not None else None)
        cause = cause or ledger_mod.CAUSE_ADMISSION
        if kind == "compile":
            compile_ms = getattr(engine, "last_compile_ms", None)
            if compile_ms is None:
                compile_ms = wall_ms
            led.record(ledger_mod.COMPILE, cause=cause, signature=sig,
                       cache=cache, wall_ms=wall_ms,
                       compile_ms=(round(float(compile_ms), 3)
                                   if compile_ms is not None else None))
            self._observe_compile(compile_ms, sig, cause)
        elif kind == "pool_acquire":
            led.record(ledger_mod.POOL_ACQUIRE, cause=cause,
                       signature=sig, cache=cache, wall_ms=0.0)
        elif kind == "pool_evict":
            led.record(ledger_mod.POOL_EVICT, cause=cause, signature=sig,
                       freed_bytes=getattr(engine, "state_bytes", None))

    def _observe_compile(self, compile_ms, signature, cause) -> None:
        if self.compile_hist is not None and compile_ms is not None:
            self.compile_hist.observe(
                float(compile_ms),
                labels={"signature": signature or "unpinned",
                        "cause": cause or "unknown"})

    def _observe_swap(self, stall_ms, signature, cause) -> None:
        """The ``dvf_swap_stall_ms`` histogram: the measured serving
        time one hot swap consumed (the commit's pointer swing — ~0),
        NOT the aside-compile (nobody was blocked for that)."""
        if self.swap_hist is not None and stall_ms is not None:
            self.swap_hist.observe(
                float(stall_ms),
                labels={"signature": signature or "unpinned",
                        "cause": cause or "unknown"})

    def _record_inline_compile(self, bucket: "_Bucket", before: int,
                               cause: str) -> None:
        """Ledger a compile that ran OUTSIDE the pool (the default
        bucket's lazy first pin in ``_builder_for``, a resize's
        recompile): ``before`` is the engine's compile_count before the
        ``ensure_compiled`` call — unchanged means no compile ran."""
        led = self.ledger
        eng = bucket.engine
        if led is None or eng.stats.compile_count == before:
            return
        sig = bucket.label()
        compile_ms = eng.last_compile_ms
        led.record(ledger_mod.COMPILE, cause=cause, signature=sig,
                   bucket=sig, cache="miss",
                   wall_ms=compile_ms,
                   compile_ms=(round(float(compile_ms), 3)
                               if compile_ms is not None else None))
        self._observe_compile(compile_ms, sig, cause)

    def _memory_bucket_rows(self) -> List[dict]:
        """Per-bucket memory attribution for the dvf_mem_* gauges:
        device-resident state (measured at compile) + occupied host
        staging/delivery slabs. Scrape-time only."""
        with self._lock:
            buckets = list(self._buckets)
        rows = []
        for b in buckets:
            a, f = b.assembler, b.fetcher
            rows.append({
                "bucket": b.label(),
                "device_state_bytes": getattr(b.engine, "state_bytes", 0),
                "host_slab_bytes": ((a.slab_bytes() if a is not None else 0)
                                    + (f.slab_bytes()
                                       if f is not None else 0)),
            })
        return rows

    @staticmethod
    def _slab_state_bytes(buckets) -> tuple:
        """(host slab bytes, device state bytes) over an
        already-snapshotted bucket list — ONE copy of the sum shared by
        signals() and _host_slab_bytes. Fields are captured once per
        bucket: a concurrent resize/recovery nulls b.assembler under
        the frontend lock, and a check-then-call would race it."""
        slab = state = 0
        for b in buckets:
            a, f = b.assembler, b.fetcher
            if a is not None:
                slab += a.slab_bytes()
            if f is not None:
                slab += f.slab_bytes()
            state += getattr(b.engine, "state_bytes", 0) or 0
        return slab, state

    def _host_slab_bytes(self) -> int:
        """This frontend's occupied host staging memory (cheap sums —
        a handful of buckets), the signals()/leak-watch input."""
        with self._lock:
            buckets = list(self._buckets)
        return self._slab_state_bytes(buckets)[0]

    def _memory_stats(self) -> dict:
        """The ``stats()['memory']`` row: per-bucket attributed host
        slabs + device state. The process-wide device allocator read is
        deliberately absent here — it runs only on the /metrics scrape
        (obs.memory.attach_memory_provider), never in a stats() poll
        loop."""
        rows = self._memory_bucket_rows()
        return {
            "host_slab_bytes": sum(r["host_slab_bytes"] for r in rows),
            "device_state_bytes": sum(r["device_state_bytes"]
                                      for r in rows),
            "by_bucket": {r["bucket"]: {
                "host_slab_bytes": r["host_slab_bytes"],
                "device_state_bytes": r["device_state_bytes"],
            } for r in rows},
            "pool": {
                "engines": len(self.pool),
            },
        }

    # -- client API ------------------------------------------------------

    def open_stream(
        self,
        session_id: Optional[str] = None,
        slo_ms: Optional[float] = None,
        sink: Any = None,
        frame_shape: Optional[tuple] = None,
        frame_dtype: Any = None,
        op_chain: Optional[str] = None,
        tier: Optional[int] = None,
        publish: Optional[str] = None,
        publish_tiers: Optional[Sequence] = None,
    ) -> str:
        """Admit one new stream; returns its session id.

        ``publish`` registers the session's delivered output as a named
        broadcast channel (dvf_tpu_torch.broadcast): subscribers attach
        with :meth:`subscribe` at a (geometry, quality, wire) tier —
        ``publish_tiers`` pre-registers the ladder (tier specs like
        ``"640x360/q60/delta"`` or :class:`~dvf_tpu_torch.broadcast.Tier`).
        The publisher's own poll()/sink delivery is unchanged; fan-out
        rides a per-delivery tap behind it.

        Raises ``AdmissionError`` at the ``max_sessions`` cap — overload
        is refused at the door, not absorbed as unbounded queueing — and
        when the frontend is draining (fleet replica teardown).

        ``tier`` is the stream's priority tier (0 interactive, 1
        standard, 2 batch; default ``config.default_tier``): under
        sustained overload the control plane's admission floor refuses
        the highest tiers first, the batcher's slot pick prefers lower
        tiers, and the quality controller downshifts higher tiers first
        — paid/interactive streams shed LAST end to end.

        ``op_chain``/``frame_shape``/``frame_dtype`` declare the
        stream's signature at admission time and ROUTE it: a declaration
        matching a live bucket (or the default bucket's pin) joins that
        bucket; a new signature ADMITS BY CREATING a bucket — its
        program is compiled here, ahead of the first frame (a fresh
        engine's warm-up and calibrations through the program pool, so
        a signature still warm in the pool costs a lease), never as a
        stall on the serving path.
        Only past ``max_buckets`` (with no idle bucket to retire) is a
        new signature refused — and the refusal enumerates the warm
        signatures this frontend can serve cheaply. An undeclared open
        joins the default bucket, whose geometry pins at first submit
        (the legacy single-signature behavior, unchanged).
        """
        t = self.config.default_tier if tier is None else int(tier)
        if t < 0:
            raise ValueError(f"tier must be >= 0, got {tier!r}")
        cfg = SessionConfig(
            queue_size=self.config.queue_size,
            slo_ms=slo_ms if slo_ms is not None else self.config.slo_ms,
            frame_delay=self.config.frame_delay,
            reorder_capacity=self.config.reorder_capacity,
            out_queue_size=self.config.out_queue_size,
            tier=t,
            replay_window=self.config.replay_window,
        )
        declared = None
        if frame_shape is not None:
            # canonical_dtype, NOT np.dtype: the ML spelling "u8" means
            # uint8, while numpy alone reads it as an 8-BYTE uint64.
            declared = (tuple(int(d) for d in frame_shape),
                        canonical_dtype(frame_dtype))
        elif frame_dtype is not None:
            raise ValueError("frame_dtype given without frame_shape")
        chain = None
        if op_chain is not None:
            try:
                chain = canonical_op_chain(op_chain)
            except ValueError as e:
                with self._lock:
                    self.admission_rejections += 1
                raise AdmissionError(f"malformed op_chain: {e}") from e
        with self._lock:
            self._check_admission_locked(tier=t)
            bucket, create_key = self._route_locked(chain, declared)
            if bucket is not None:
                self._price_admission_locked(bucket, t, cfg.slo_ms)
                sid_out = self._register_session_locked(
                    bucket, session_id, cfg, sink)
        if bucket is not None:
            self._warm_quality_async(bucket)
            if publish:
                self.publish_stream(sid_out, publish, publish_tiers)
            return sid_out
        with self._lock:
            # Best-effort headroom check BEFORE the compile: a frontend
            # at the bucket cap with no idle victim must refuse now, not
            # after a compile whose orphan program would then sit
            # in the pool advertising a signature this frontend cannot
            # actually serve. _create_bucket_locked re-checks
            # authoritatively (state may change while we compile).
            self._check_bucket_headroom_locked(create_key)
        # New signature: build/lease its compiled program OUTSIDE the
        # frontend lock — a cold compile must not stall dispatch of the
        # other buckets (that is the stall this design removes from the
        # serving path); the pool's per-key latch dedups concurrent
        # admits of the same signature.
        engine = self._acquire_program(create_key)
        owned = False
        try:
            with self._lock:
                self._check_admission_locked(tier=t)
                bucket = self._bucket_by_key.get(create_key)
                if bucket is None:
                    bucket = self._create_bucket_locked(create_key, engine)
                    owned = True
                sid_out = self._register_session_locked(
                    bucket, session_id, cfg, sink)
        finally:
            if not owned:
                # Either the signature raced into existence (join — our
                # extra lease drops; the bucket keeps its own) or
                # admission failed after the lease: the program stays
                # WARM in the pool either way.
                self.pool.release(create_key)
        self._warm_quality_async(bucket)
        if publish:
            self.publish_stream(sid_out, publish, publish_tiers)
        return sid_out

    # -- broadcast plane (publish / subscribe) ---------------------------

    def _ensure_broadcast(self):
        if self.broadcast is None:
            from dvf_tpu_torch.broadcast import BroadcastPlane

            c = self.config
            self.broadcast = BroadcastPlane(
                audit_wire=c.broadcast_audit_wire, chaos=c.chaos,
                ingest_depth=c.broadcast_ingest_depth,
                sub_queue=c.broadcast_sub_queue,
                evict_after=c.broadcast_evict_after,
                keyframe_interval=c.broadcast_keyframe_interval,
                lineage=self.attribution is not None)
        return self.broadcast

    def publish_stream(self, session_id: str, channel: str,
                       tiers: Optional[Sequence] = None) -> None:
        """Register an open session's delivered output as broadcast
        channel ``channel``. The session keeps its own delivery path
        (poll/sink); the broadcast tap tees each delivered frame into
        the channel's fan-out worker (one copy + one bounded enqueue —
        a stalled fan-out sheds frames there, never the publisher)."""
        plane = self._ensure_broadcast()
        plane.publish(channel, publisher=session_id, tiers=tiers or ())
        with self._lock:
            s = self._sessions.get(session_id)
        if s is None:
            plane.unpublish(channel)
            raise ServeError(f"no open session {session_id!r} to publish")
        s.tap = plane.tap(channel)

    def subscribe(self, channel: str, tier=None,
                  queue_size: Optional[int] = None, abr: bool = False):
        """Attach a watcher to a published channel at a tier (spec
        string or :class:`~dvf_tpu_torch.broadcast.Tier`; None = the
        ladder top, or its cheapest rung when ``abr`` is on). Returns the
        :class:`~dvf_tpu_torch.broadcast.Subscription` handle (``poll`` /
        ``stats``; pass back to :meth:`unsubscribe`)."""
        return self._ensure_broadcast().subscribe(
            channel, tier=tier, queue_size=queue_size, abr=abr)

    def unsubscribe(self, sub) -> None:
        if self.broadcast is not None:
            self.broadcast.unsubscribe(sub)

    # -- admission internals (bucket routing) ---------------------------

    def _check_admission_locked(self, tier: Optional[int] = None) -> None:
        if self._draining:
            self.admission_rejections += 1
            raise AdmissionError(
                "frontend is draining (no new sessions admitted)")
        floor = self._admission_tier_floor
        if tier is not None and floor is not None and tier > floor:
            # Controller-set load shed at the door: the cheapest place
            # to refuse work is before any of it is queued. Graceful by
            # contract — a refused low-tier open is degradation, not a
            # failure (the fleet tier spills it to a replica with
            # headroom when one exists).
            self.admission_rejections += 1
            raise AdmissionError(
                f"tier {tier} not admitted under overload (admission "
                f"floor {floor}: the load controller is shedding "
                f"low-priority sessions first)")
        if len(self._sessions) >= self.config.max_sessions:
            self.admission_rejections += 1
            raise AdmissionError(
                f"session limit reached ({self.config.max_sessions} "
                f"open); close a stream or raise max_sessions")

    def _price_admission_locked(self, bucket: "_Bucket", tier: int,
                                slo_ms: float) -> None:
        """Feed-forward admission pricing (the auto-plan plane's third
        leg, armed by ``config.autoplan``): BEFORE a tenant is
        admitted, predict what its bucket's scheduling round will cost
        with it aboard — from the persisted stage-cost profile
        (obs.lineage) a previous run measured, else the live tick
        EWMA — and refuse a non-interactive tenant whose predicted
        steady-state latency already breaches its own SLO. The
        reactive tier controller (control.controllers) refuses AFTER
        queues build and refusals advance; this prices the marginal
        tenant from the profile so the refusal lands before its first
        frame is ever queued. Nothing measured yet → admit (the cold
        path stays reactive, exactly as before this plane)."""
        if not self.config.autoplan or tier <= 0:
            return
        from dvf_tpu_torch.control.planner import predicted_tick_cost_ms
        cost = predicted_tick_cost_ms(bucket.stage_profile,
                                      batch_size=bucket.batch_size)
        if cost is None:
            cost = bucket._tick_cost_ms
        if not cost:
            return
        occupants = len(bucket.sessions) + 1
        rounds = -(-occupants // max(1, bucket.batch_size))  # ceil
        predicted_ms = float(cost) * rounds
        if predicted_ms > float(slo_ms):
            self.admission_rejections += 1
            raise AdmissionError(
                f"admission priced out (feed-forward): predicted "
                f"steady-state latency {predicted_ms:.1f} ms for "
                f"tenant {occupants} of bucket {bucket.label()!r} "
                f"(predicted tick {float(cost):.2f} ms x {rounds} "
                f"scheduling rounds) exceeds its {float(slo_ms):g} ms "
                f"SLO; warm signatures this frontend serves cheaply: "
                f"{self._warm_signatures()}")

    def _route_locked(
        self, chain: Optional[str], declared: Optional[tuple],
    ) -> Tuple[Optional["_Bucket"], Optional[SignatureKey]]:
        """Map a declaration to ``(bucket, None)`` (join) or
        ``(None, key)`` (create a bucket for ``key``)."""
        default = self._buckets[0]
        if chain is None and declared is None:
            return default, None  # legacy: default bucket, pin at submit
        chain = chain if chain is not None else default.op_chain
        if declared is None:
            # op_chain alone: join the one live bucket serving it.
            matches = [b for b in self._buckets if b.op_chain == chain]
            if len(matches) == 1:
                return matches[0], None
            self.admission_rejections += 1
            raise AdmissionError(
                f"op_chain {chain!r} needs frame_shape to admit "
                f"({len(matches)} live buckets serve it); warm "
                f"signatures: {self._warm_signatures()}")
        shape, dtype = declared
        key = make_key(chain, shape, dtype)
        b = self._bucket_by_key.get(key)
        if b is not None:
            return b, None
        if chain == default.op_chain:
            pinned = default.pinned_signature()
            if pinned is None:
                # First declaration pins the default bucket (the legacy
                # seam, now one bucket among several).
                default.frame_shape = tuple(key.geometry)
                default.frame_dtype = key.np_dtype
                default.key = key
                if self.config.profile_dir:
                    default.stage_profile = load_stage_profile(
                        self.config.profile_dir, key.render())
                self._bucket_by_key[key] = default
                return default, None
            if pinned == (tuple(key.geometry), key.np_dtype):
                # Same signature spelled differently / pinned by a
                # first submit before any declaration: join.
                if default.key is None:
                    default.key = key
                self._bucket_by_key.setdefault(key, default)
                return default, None
        return None, key

    def _register_session_locked(self, bucket: "_Bucket",
                                 session_id: Optional[str],
                                 cfg: SessionConfig, sink: Any) -> str:
        sid = session_id if session_id is not None else f"s{next(self._ids)}"
        if sid in self._sessions or sid in self._retired:
            raise ServeError(f"session id {sid!r} already exists")
        s = StreamSession(sid, cfg, sink=sink)
        s.bucket = bucket
        s.attribution = self.attribution  # None when lineage is off
        self._sessions[sid] = s
        bucket.sessions[sid] = s
        return sid

    def _check_bucket_headroom_locked(self, key: SignatureKey) -> None:
        """Refuse a new-signature admission when the bucket cap is
        reached and nothing can retire (counts the rejection). Shared by
        the pre-compile fast refusal and the authoritative post-compile
        check in _create_bucket_locked."""
        if len(self._buckets) < self.config.max_buckets:
            return
        if any(b.idle() for b in self._buckets[1:]):
            return
        self.admission_rejections += 1
        raise AdmissionError(
            f"no bucket headroom for signature {key.render()}: "
            f"{len(self._buckets)}/{self.config.max_buckets} "
            f"buckets busy; warm signatures this frontend can "
            f"serve cheaply: {self._warm_signatures()}")

    def _create_bucket_locked(self, key: SignatureKey,
                              engine: Engine) -> "_Bucket":
        if len(self._buckets) >= self.config.max_buckets:
            self._check_bucket_headroom_locked(key)
            victim = next((b for b in self._buckets[1:] if b.idle()), None)
            self._retire_bucket_locked(victim)
        b = _Bucket(self.config, engine.filter, key.op_chain, engine,
                    key=key)
        b._pooled = True  # leased through self.pool by _acquire_program
        if self.config.profile_dir:
            # One small JSON read at bucket creation (a path that just
            # paid a compile): a previous run's measured stage costs
            # seed the tick-cost estimate.
            b.stage_profile = load_stage_profile(
                self.config.profile_dir, key.render())
        self._buckets.append(b)
        self._bucket_by_key[key] = b
        if self.ledger is not None:
            self.ledger.record(ledger_mod.BUCKET_CREATE,
                               signature=key.render(),
                               bucket=key.render(),
                               open_buckets=len(self._buckets))
        return b

    def _retire_bucket_locked(self, bucket: "_Bucket") -> None:
        """Drop an idle bucket to make headroom. Its program is NOT
        compiled away — the pool lease drops, the program stays warm
        until LRU capacity pressure actually frees it, so a returning
        signature re-admits as a pool hit. Its host staging slabs ARE
        released eagerly: retired sessions keep a ``.bucket`` reference
        (for tail drains), so without this a churned bucket would pin
        2×(max_inflight+1) batch-sized buffers until its sessions age
        out of the retirement map."""
        self._buckets.remove(bucket)
        if bucket.key is not None:
            if self._bucket_by_key.get(bucket.key) is bucket:
                del self._bucket_by_key[bucket.key]
            if self.config.profile_dir:
                # Record (no disk I/O under this lock) so stop() still
                # persists a churned-out signature's measured costs.
                tick = bucket._tick_cost_ms
                if tick is None:
                    tick = getattr(bucket.engine, "step_block_ms", None)
                self._retired_bucket_costs[bucket.label()] = tick
            if getattr(bucket, "_pooled", False):
                self.pool.release(bucket.key)
        a, bucket.assembler = bucket.assembler, None
        f, bucket.fetcher = bucket.fetcher, None
        if a is not None:
            a.release()
        if f is not None:
            f.release()
        bucket.release_drained_fetchers()
        if self.ledger is not None:
            label = bucket.label()
            # A retired bucket never dispatches again: close out any
            # stall window it owned rather than let it dangle.
            self.ledger.abandon_stalls(label)
            self.ledger.record(ledger_mod.BUCKET_RETIRE, bucket=label,
                               signature=(bucket.key.render()
                                          if bucket.key is not None
                                          else None),
                               open_buckets=len(self._buckets))

    def _acquire_program(self, key: SignatureKey,
                         cause: str = ledger_mod.CAUSE_ADMISSION) -> Engine:
        """Lease (or compile ahead) the program for ``key`` — the
        admission-time compile that replaces the first-frame stall.
        ``cause`` labels the ledger/histogram record (admission /
        quality / morph / precompile)."""
        def build() -> Engine:
            with self._lock:
                filt = self._filters_by_chain.get(key.op_chain)
            if filt is None:
                filt = build_filter(key.op_chain)
                if filt.stateful:
                    raise AdmissionError(
                        f"op_chain {key.op_chain!r} is stateful; a "
                        f"shared batch interleaves tenants, so temporal "
                        f"state would leak across sessions — stateless "
                        f"chains only")
                with self._lock:
                    self._filters_by_chain.setdefault(key.op_chain, filt)
            seed = None
            cal_sig = f"b{self.config.batch_size}|{key.render()}"
            if self.config.plan_cache_dir:
                # Warm-restart calibration seed (control.plan_cache): a
                # previous run on this exact (topology, batch signature)
                # already measured the H2D/D2H/step block costs — the
                # compile adopts them and skips its blocking measurement
                # passes (engine.calibration_seeded records the
                # adoption, and the ledgered compile's wall shows it).
                from dvf_tpu_torch.control import plan_cache as _pc
                seed = _pc.load_calibrations(
                    self.config.plan_cache_dir,
                    self._topology_fingerprint(), cal_sig)
            eng = Engine(filt, device=self.device, mesh=self.mesh,
                         chaos=self.config.chaos, op_chain=key.op_chain,
                         calibration_seed=seed)
            eng.compile((self.config.batch_size, *key.geometry),
                        key.np_dtype)
            if self.config.plan_cache_dir and not eng.calibration_seeded:
                from dvf_tpu_torch.control import plan_cache as _pc
                _pc.save_calibrations(
                    self.config.plan_cache_dir,
                    self._topology_fingerprint(), cal_sig,
                    {"h2d_block_ms": eng.h2d_block_ms,
                     "d2h_block_ms": eng.d2h_block_ms,
                     "step_block_ms": eng.step_block_ms})
            return eng

        try:
            return self.pool.acquire(key, build, cause=cause)
        except AdmissionError:
            with self._lock:
                self.admission_rejections += 1
            raise
        except Exception as e:  # noqa: BLE001 — unknown op, bad
            # geometry for the filter, compile failure: all refusals at
            # the door, never a half-created bucket
            with self._lock:
                self.admission_rejections += 1
            raise AdmissionError(
                f"cannot compile program for signature {key.render()}: "
                f"{e!r}") from e

    def _warm_signatures(self) -> List[str]:
        """Signatures servable without a cold compile: pooled programs
        plus live pinned buckets (which may predate pool adoption).
        Lock-free (callers may hold the non-reentrant ``_lock``): the
        dict snapshot below is ``list(dict)`` — one C-level call, atomic
        under the GIL — so a concurrent open_stream insert cannot raise
        mid-iteration; at worst the list is one insert stale.
        """
        keys = {k.render() for k in self.pool.warm_keys()}
        keys.update(k.render() for k in list(self._bucket_by_key))
        return sorted(keys)

    def precompile(self, manifest: Any) -> List[str]:
        """Warm the program pool from a ``--precompile`` manifest
        (runtime.signature.parse_manifest): each signature compiles once
        here, then idles warm in the pool, so its first real admission
        is a pool hit. Returns the canonical signatures warmed."""
        warmed = []
        for entry in parse_manifest(manifest):
            key = entry["key"]
            self._acquire_program(key, cause=ledger_mod.CAUSE_PRECOMPILE)
            self.pool.release(key)  # stays warm, un-leased
            warmed.append(key.render())
        return warmed

    # -- auto-plan plane (dvf_tpu_torch.control.planner / plan_cache) ---

    def _topology_fingerprint(self) -> str:
        """Cached: what hardware this frontend drives, laid out how —
        the plan/calibration cache's invalidation axis."""
        if self._topology is None:
            from dvf_tpu_torch.control.plan_cache import topology_fingerprint
            self._topology = topology_fingerprint(
                self.mesh if self.mesh is not None else self.device)
        return self._topology

    def _cal_signature(self, bucket: "_Bucket") -> Optional[str]:
        """The calibration-cache key for a bucket's compile: the batch
        size is part of the measured shape, so it is part of the key."""
        try:
            key = bucket.key or bucket.engine.signature_key
            if key is None:
                key = make_key(bucket.op_chain, bucket.frame_shape,
                               bucket.frame_dtype)
            return f"b{bucket.batch_size}|{key.render()}"
        except Exception:  # noqa: BLE001 — an unparseable display-name
            return None    #   chain just skips the calibration cache

    def _seed_calibrations(self, bucket: "_Bucket") -> None:
        """Before a bucket engine's FIRST compile: adopt the persisted
        (topology, batch signature) calibration triple from the plan
        cache so ``Engine.compile`` skips its blocking measurement
        passes on a warm restart. No cache dir, already compiled, or
        any cache miss → no-op (the cold path re-measures; always
        correct)."""
        eng = bucket.engine
        if (not self.config.plan_cache_dir
                or eng.calibration_seed is not None
                or eng.stats.compile_count > 0
                or bucket.frame_shape is None):
            return
        sig = self._cal_signature(bucket)
        if sig is None:
            return
        from dvf_tpu_torch.control import plan_cache as _pc
        eng.calibration_seed = _pc.load_calibrations(
            self.config.plan_cache_dir, self._topology_fingerprint(), sig)

    def _save_calibrations(self, bucket: "_Bucket", before: int) -> None:
        """After a compile that actually MEASURED (ran here, was not
        seeded): persist the calibration triple so the next restart on
        this topology skips the measurement passes."""
        eng = bucket.engine
        if (not self.config.plan_cache_dir
                or eng.stats.compile_count == before
                or eng.calibration_seeded):
            return
        sig = self._cal_signature(bucket)
        if sig is None:
            return
        from dvf_tpu_torch.control import plan_cache as _pc
        _pc.save_calibrations(
            self.config.plan_cache_dir, self._topology_fingerprint(), sig,
            {"h2d_block_ms": eng.h2d_block_ms,
             "d2h_block_ms": eng.d2h_block_ms,
             "step_block_ms": eng.step_block_ms})

    def autoplan(self, frame_shape, frame_dtype="uint8",
                 op_chain: Optional[str] = None,
                 log: Optional[Any] = None) -> Optional[dict]:
        """Plan this frontend's operating point for one signature —
        the auto-plan plane's entry point (``--autoplan`` on the CLI).
        Call AFTER :meth:`start` (the measured search pushes paced
        bursts through the live dispatch path).

        Warm restart: the cached winner for (canonical signature,
        geometry, topology fingerprint, planner version) applies in
        O(one JSON read) — no search, no traffic; the ledgered ``plan``
        event's ``wall_ms`` is the auditable "plan step under 50 ms"
        bound. Cold: the candidate grid is scored analytically from the
        compile-time calibration triple, the best ≤ 1/3 is
        live-profiled through a real measurement session (each
        candidate applied via the SAME actuators the controllers use —
        batch hot swap, tick write, depth-aware assembler rebuild), and
        the measured winner is applied, cached, and ledgered with its
        search cost. Returns the applied plan doc."""
        from dvf_tpu_torch.control import planner as planner_mod

        t0 = time.perf_counter()
        say = log if log is not None else (lambda _m: None)
        chain = (self._buckets[0].op_chain if op_chain is None
                 else canonical_op_chain_or_verbatim(op_chain))
        key = make_key(chain, frame_shape, frame_dtype)
        signature = key.render()
        shape = tuple(key.geometry)
        topo = self._topology_fingerprint()
        cache_dir = self.config.plan_cache_dir
        plan = planner_mod.plan_from_cache(cache_dir, signature, shape,
                                           topo)
        if plan is not None:
            self._apply_plan(plan, reason="plan cache hit")
            wall = (time.perf_counter() - t0) * 1e3
            if self.ledger is not None:
                self.ledger.record(
                    ledger_mod.PLAN, cause=ledger_mod.CAUSE_AUTOPLAN,
                    signature=signature, cache="hit",
                    wall_ms=round(wall, 3), plan=plan.to_doc(),
                    topology=topo, legs=0, grid=0)
            say(f"autoplan: cache hit {plan.label()} ({wall:.1f} ms)")
            return plan.to_doc()
        base = planner_mod.Plan(
            batch_size=self.config.batch_size, tick_s=self.config.tick_s,
            ingest_depth=self.config.ingest_depth)
        # Quiesce the reactive loops for the search: the batch
        # controller would size the measurement bucket to its
        # occupancy of one, undoing every candidate's hot swap
        # mid-burst. Resumed after the winner's envelope is applied.
        if self.control_plane is not None:
            self.control_plane.paused = True
        try:
            sid = self.open_stream(op_chain=chain, frame_shape=shape,
                                   frame_dtype=key.dtype, tier=0,
                                   slo_ms=120000.0)
            frame = np.zeros(shape, dtype=key.np_dtype)
            try:
                # Warmup burst at the hand-set defaults: compiles the
                # program on the real serving path and measures (or
                # adopts from the calibration cache) the triple the
                # analytic pruner seeds from.
                warm = self._measure_plan_candidate(sid, frame, base)
                if "error" in warm:
                    raise ServeError(f"autoplan warmup failed: "
                                     f"{warm['error']}")
                with self._lock:
                    bucket = self._sessions[sid].bucket
                eng = bucket.engine
                cal = {"h2d_block_ms": eng.h2d_block_ms,
                       "d2h_block_ms": eng.d2h_block_ms,
                       "step_block_ms": eng.step_block_ms}
                # The hand-set batch is a starting guess, not a bound:
                # the grid probes up to 2x above it (whether a bigger
                # batch pays is exactly what measuring decides — the
                # analytic-only fleet path stays capped at the hand-set
                # batch because nothing measured says otherwise). The
                # winner becomes the envelope's ladder top.
                grid = planner_mod.candidate_grid(
                    batch_cap=2 * base.batch_size)
                def measure(p):
                    # Best-of-2: the first burst after a hot swap pays
                    # cold staging (fresh program, empty assembler
                    # ring) — the second burst is the steady state the
                    # plan will actually run at. Same repeat discipline
                    # as the bench table's A/B legs.
                    a = self._measure_plan_candidate(sid, frame, p)
                    if "error" in a:
                        return a
                    b = self._measure_plan_candidate(sid, frame, p)
                    return a if "error" in b or a["fps"] >= b["fps"] \
                        else b

                plan, comp = planner_mod.plan_search(
                    grid, measure,
                    cal=cal, cal_batch=base.batch_size,
                    stage_profile=bucket.stage_profile, log=log)
            except BaseException:
                # A failed search must not leave a half-applied
                # candidate driving the frontend: restore the hand-set
                # point.
                self.config.ingest_depth = base.ingest_depth
                self.set_tick_interval(base.tick_s)
                with self._lock:
                    s = self._sessions.get(sid)
                    b = s.bucket if s is not None else None
                if b is not None and b.batch_size != base.batch_size:
                    self.request_batch_size(b.label(), base.batch_size,
                                            reason="autoplan aborted")
                raise
            finally:
                self.close(sid, drain=False)
            self._apply_plan(plan, reason="measured plan search")
        finally:
            if self.control_plane is not None:
                self.control_plane.paused = False
        planner_mod.plan_to_cache(cache_dir, signature, shape, topo, plan)
        wall = (time.perf_counter() - t0) * 1e3
        if self.ledger is not None:
            self.ledger.record(
                ledger_mod.PLAN, cause=ledger_mod.CAUSE_AUTOPLAN,
                signature=signature, cache="miss",
                wall_ms=round(wall, 3), plan=plan.to_doc(),
                topology=topo, legs=plan.searched, grid=plan.grid,
                reason=f"winner {comp.get('winner')}")
        say(f"autoplan: live-profiled {plan.searched}/{plan.grid} -> "
            f"{plan.label()} ({wall:.0f} ms)")
        return plan.to_doc()

    def apply_plan_doc(self, doc: dict,
                       reason: Optional[str] = None) -> bool:
        """Apply an externally-chosen plan doc (the fleet front door
        plans once and pushes the winner to replicas). Returns False on
        an implausible doc — never raises over an optimization."""
        from dvf_tpu_torch.control.planner import Plan

        plan = Plan.from_doc(doc)
        if plan is None:
            return False
        self._apply_plan(plan, reason=reason or "fleet plan")
        return True

    def _apply_plan(self, plan, reason: Optional[str] = None) -> None:
        """Make ``plan`` this frontend's operating point: the config
        fields (future buckets compile at the planned batch/depth), the
        live dispatch tick, every live bucket's batch size (hot swap
        when pinned, direct when nothing has flowed yet), and the
        control plane's operating envelope — the reactive loops
        then adapt WITHIN the planned envelope (ladder bounded at the
        planned batch, planned tick as the busy tick) instead of
        rediscovering it from hard-coded defaults."""
        with self._lock:
            self.config.batch_size = plan.batch_size
            self.config.ingest_depth = plan.ingest_depth
            self.config.tick_s = plan.tick_s
            self.config.ingest = plan.ingest
            self.config.egress = plan.egress
            buckets = list(self._buckets)
        for b in buckets:
            with self._lock:
                unpinned = b.frame_shape is None
                if unpinned:
                    b.batch_size = plan.batch_size
                    b.ingest_mode = plan.ingest
                    b.egress_mode = plan.egress
            if not unpinned and b.batch_size != plan.batch_size:
                self.request_batch_size(b.label(), plan.batch_size,
                                        reason=reason or "autoplan")
        self.set_tick_interval(plan.tick_s)
        if self.control_plane is not None:
            self.control_plane.apply_envelope(plan.envelope(),
                                              reason=reason)
        self.applied_plan = plan.to_doc()

    def _measure_plan_candidate(self, sid: str, frame: np.ndarray,
                                plan) -> dict:
        """One candidate's live leg: apply its knobs through the REAL
        actuators (batch hot swap via :meth:`request_batch_size` — the
        same compile-aside path the controllers use — the tick write,
        and the ingest-depth config the next assembler rebuild picks
        up), then push a paced burst of ``autoplan_burst_frames``
        frames through the measurement session and report sustained
        fps. The row shape matches the bench table's A/B legs
        (``fps`` or ``error``), so `control._ab.ab_comparison` ranks
        the search — one shared paced-measurement path."""
        with self._lock:
            s = self._sessions.get(sid)
            bucket = s.bucket if s is not None else None
        if bucket is None:
            return {"error": f"measurement session {sid!r} gone"}
        self.config.ingest_depth = plan.ingest_depth
        self.set_tick_interval(plan.tick_s)
        if bucket.batch_size != plan.batch_size:
            with self._lock:
                if bucket.frame_shape is None:
                    bucket.batch_size = plan.batch_size
            if bucket.batch_size != plan.batch_size:
                self.request_batch_size(
                    bucket.label(), plan.batch_size,
                    reason=f"autoplan candidate {plan.label()}")
                deadline = time.time() + 30.0
                while bucket.batch_size != plan.batch_size:
                    if time.time() > deadline:
                        return {"error": f"hot swap to batch "
                                         f"{plan.batch_size} timed out"}
                    time.sleep(0.002)
        # Quiet the pipe first: a previous candidate's over-submitted
        # frames may still be IN FLIGHT (not just queued for poll), and
        # arriving mid-burst they would inflate this candidate's fps.
        # Wait until nothing has arrived for 50 ms before measuring.
        quiet_deadline = time.perf_counter() + 5.0
        last_arrival = time.perf_counter()
        while time.perf_counter() - last_arrival < 0.05:
            if self.poll(sid):
                last_arrival = time.perf_counter()
            if time.perf_counter() > quiet_deadline:
                break
            time.sleep(0.002)
        n = max(4, int(self.config.autoplan_burst_frames))
        # Paced: keep ~2 batches of standing work so batching engages,
        # but never more than the per-session ingress bound — a frame
        # dropped at ingress never delivers, which would read as a
        # stalled (infinitely slow) candidate instead of a paced one.
        backlog = max(2, min(2 * plan.batch_size, self.config.queue_size))
        delivered = in_flight = 0
        t0 = time.perf_counter()
        deadline = t0 + 60.0
        last_progress = t0
        while delivered < n:
            while in_flight < backlog:
                self.submit(sid, frame)
                in_flight += 1
            got = self.poll(sid)
            delivered += len(got)
            in_flight -= len(got)
            if got:
                last_progress = time.perf_counter()
                continue
            now = time.perf_counter()
            if now > deadline:
                return {"error": f"burst stalled at "
                                 f"{delivered}/{n} delivered"}
            if now - last_progress > 2.0:
                # A shed frame (drop-oldest racing a mid-burst resize
                # swap) never delivers; after 2 s of silence assume
                # the standing work evaporated and re-prime rather
                # than waiting out the deadline on ghosts. Throughput
                # stays honest — the clock keeps running and fps is
                # delivered-work over total wall.
                in_flight = 0
                last_progress = now
            time.sleep(0.001)
        wall = time.perf_counter() - t0
        return {"fps": round(n / wall, 2), "frames": n,
                "wall_s": round(wall, 4), "batch": plan.batch_size,
                "tick_s": plan.tick_s, "depth": plan.ingest_depth}

    # -- control-plane actuator surface (dvf_tpu_torch.control) ---------
    # The ControlPlane's apply thread calls these; the decisions behind
    # them are deterministic over the telemetry window (controllers.py).
    # Anything that must be serialized with staging (quality rebinds,
    # batch resizes) is handed to the dispatch thread instead of done
    # here — the apply thread only ever pays for COMPILES, never for a
    # lock the serving path is hot on.

    def control_view(self) -> dict:
        """The per-bucket/per-session half of a control row — what the
        plane composes with each flat telemetry sample before the
        controllers' decision step. Cheap: counter reads, no percentile
        work."""
        with self._lock:
            buckets = [(b, len(b.sessions),
                        sum(len(s.ingress) + len(s.pending)
                            for s in b.sessions.values()),
                        min((s.config.tier
                             for s in b.sessions.values()), default=None))
                       for b in self._buckets]
            sessions = list(self._sessions.items())
        b_rows = []
        for b, n_live, qd, min_tier in buckets:
            b_rows.append({
                "label": b.label(),
                "batch_size": b.batch_size,
                "queue_depth": qd,
                "open_sessions": n_live,
                "inflight_batches": b.inflight_batches,
                "mean_valid_rows": b.mean_valid_rows,
                "tick_cost_ms": b.tick_cost_estimate(),
                # Highest-priority tenant tier (the resize stall-guard:
                # a bucket hosting tier 0 never shrink-resizes).
                "min_tier": min_tier,
                # Measured mean per-component latency (live lineage
                # window, else the persisted stage profile): what the
                # controllers annotate their decisions with. None until
                # something has been measured.
                "stage_cost_ms": self._bucket_stage_cost(b),
            })
        s_rows = []
        for sid, s in sessions:
            s_rows.append({
                "sid": sid,
                "tier": s.config.tier,
                "level": s.quality_level,
                "downshiftable": self._downshiftable(s),
            })
        return {"buckets": b_rows, "sessions": s_rows}

    def _downshiftable(self, s: StreamSession) -> bool:
        """Whether one more ×2 downshift step is geometrically possible
        for this session (signature pinned, H and W divisible)."""
        sig = s.base_sig
        if sig is None:
            bucket = s.bucket if s.bucket is not None else self._buckets[0]
            sig = bucket.pinned_signature()
        if sig is None:
            return False
        shape = sig[0]
        f = 1 << (s.quality_level + 1)
        return len(shape) >= 2 and shape[0] % f == 0 and shape[1] % f == 0

    def request_batch_size(self, bucket_label: str, n: int,
                           reason: Optional[str] = None) -> bool:
        """Queue a per-bucket batch resize, served as a HOT SWAP: the
        dispatch thread kicks the new size's program compile to a
        background thread while the bucket keeps serving at the old
        size, then commits the staged program
        with one pointer swing between ticks — no quiesce, no stall
        window. False = no such bucket (it retired between decide and
        apply). ``reason`` (the controller's decision rationale) rides
        into the ledger's ``swap`` event."""
        n = max(1, int(n))
        with self._lock:
            for b in self._buckets:
                if b.label() == bucket_label:
                    if n == b.batch_size:
                        self._pending_resizes.pop(b, None)
                    else:
                        self._pending_resizes[b] = (n, reason)
                    return True
        return False

    def set_tick_interval(self, tick_s: float) -> None:
        """The tick budget: how long dispatch idles between scheduling
        passes. Tight under load (queueing delay is paid per tick),
        relaxed when idle (a hot spin over empty queues is wasted
        host CPU)."""
        self._tick_s = max(1e-4, float(tick_s))

    def set_admission_tier_floor(self, floor: Optional[int]) -> None:
        """Controller-set admission floor: ``open_stream`` refuses
        sessions with tier > floor (None admits every tier)."""
        with self._lock:
            self._admission_tier_floor = floor

    def flight_trip(self, reason: str) -> None:
        """Control-plane observability tap (controller saturation):
        same off-thread flight dump as the watchdog/budget paths."""
        self._flight_trip(reason)

    def request_session_quality(self, session_id: str, level: int,
                                reason: Optional[str] = None) -> bool:
        """Move one session to quality ``level`` (0 = full). Builds or
        leases the downshift bucket's program HERE (apply thread — a
        compile must not stall sampling or dispatch), then hands the
        actual rebind to the dispatch thread, which owns the queues
        being flushed. False = impossible right now (session gone,
        geometry not divisible, bucket cap with no idle victim) — the
        controller counts it and re-decides on a later window."""
        level = int(level)
        if level < 0:
            return False
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None or s.state != OPEN:
                return False
            if level == s.quality_level:
                return True
            if s.base_sig is None:
                # First shift: capture the full-quality signature so
                # recovery can route home even if the base bucket
                # retires (its program stays warm in the pool).
                bucket = s.bucket if s.bucket is not None \
                    else self._buckets[0]
                pinned = bucket.pinned_signature()
                if pinned is None:
                    return False  # nothing has flowed yet — no geometry
                s.base_sig = pinned
                s.base_chain = bucket.op_chain
            shape, dtype = s.base_sig
            base_chain = s.base_chain
        key = self._quality_key(base_chain, shape, dtype, level)
        if key is None:
            return False
        try:
            self._ensure_quality_bucket(key, base_chain, level)
        except AdmissionError:
            return False
        self._pending_rebinds.put((session_id, key, level, reason, None))
        return True

    def morph_stream(self, session_id: str, op_chain: str,
                     reason: Optional[str] = None) -> bool:
        """Swap one live session's FILTER CHAIN mid-stream — no
        close/reopen, no index reset. The target chain's program is
        built or leased HERE (caller thread — a compile must not stall
        dispatch; through the pool it is usually a warm hit), then the
        cutover rides the rebind queue: the dispatch thread flushes the
        session's queued frames (old chain — they cannot enter the new
        program), swings the bucket binding between ticks, and ledgers
        a ``swap`` event (cause=morph) with the cutover frame index.
        Indices stay monotone: frames before the ledgered
        ``cutover_index`` were filtered by the old chain, frames at and
        after it by the new one. The adopted program carries a
        swap-guard equivalence verdict like every other substitution.
        False = impossible right now (session gone/closing, nothing
        flowed yet, malformed chain raises ServeError, bucket cap with
        no idle victim)."""
        try:
            chain = canonical_op_chain(op_chain)
        except Exception as e:  # noqa: BLE001 — surface as admission
            raise ServeError(f"morph_stream: bad op_chain "
                             f"{op_chain!r}: {e}") from None
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None or s.state != OPEN:
                return False
            if s.base_sig is None:
                bucket = s.bucket if s.bucket is not None \
                    else self._buckets[0]
                pinned = bucket.pinned_signature()
                if pinned is None:
                    return False  # nothing has flowed yet — no geometry
                s.base_sig = pinned
                s.base_chain = bucket.op_chain
            if chain == s.base_chain:
                return True  # already serving this chain
            shape, dtype = s.base_sig
            level = s.quality_level
        # The morph preserves the session's quality level: the target
        # key decimates the NEW chain at the same ladder rung.
        key = self._quality_key(chain, shape, dtype, level)
        if key is None:
            key = self._quality_key(chain, shape, dtype, 0)
            level = 0  # geometry stopped dividing under the new chain:
            #   morph to full quality rather than refuse the morph
        if key is None:
            return False
        try:
            self._ensure_quality_bucket(key, chain, level,
                                        cause=ledger_mod.CAUSE_MORPH)
        except AdmissionError:
            return False
        self._pending_rebinds.put((session_id, key, level, reason, chain))
        return True

    def _quality_key(self, base_chain: str, shape: tuple, dtype,
                     level: int) -> Optional[SignatureKey]:
        """The canonical signature serving ``base_chain`` at quality
        ``level``: decimated geometry + the matching upscale stage (so
        the program's OUTPUT stays full resolution). None when the
        geometry doesn't divide."""
        if level == 0:
            chain = base_chain
            geom = tuple(shape)
        else:
            f = 1 << level
            if len(shape) < 2 or shape[0] % f or shape[1] % f:
                return None
            chain = canonical_op_chain_or_verbatim(
                f"{base_chain}|upscale(scale={f})")
            geom = (shape[0] // f, shape[1] // f, *shape[2:])
        return SignatureKey(chain, canonical_geometry(geom),
                            canonical_dtype(dtype).name)

    def _register_quality_chain_locked(self, key: SignatureKey,
                                       base_chain: str, scale: int) -> None:
        """Register the downshift chain's Filter under ``key.op_chain``
        (caller holds ``_lock``): the live base Filter composed with the
        matching ``upscale`` stage — needed when the base chain is an
        ad-hoc filter name ``build_filter`` can't re-parse. No-op when
        already registered or the base filter is unknown (a registry
        spec builds through ``_acquire_program`` instead)."""
        if key.op_chain in self._filters_by_chain:
            return
        base_filt = self._filters_by_chain.get(base_chain)
        if base_filt is not None:
            from dvf_tpu_torch.ops import get_filter

            self._filters_by_chain[key.op_chain] = FilterChain(
                base_filt, get_filter("upscale", scale=scale),
                name=key.op_chain)

    def _ensure_quality_bucket(self, key: SignatureKey, base_chain: str,
                               level: int,
                               cause: str = ledger_mod.CAUSE_QUALITY
                               ) -> None:
        """Make a live bucket exist for ``key`` (join or create —
        open_stream's admission discipline, compile outside the lock).
        For a base chain that is NOT a registry spec (an ad-hoc filter
        name), the downshift filter is composed from the LIVE base
        Filter object instead of build_filter. ``cause`` labels the
        pool acquire in the ledger (quality rebind vs live morph)."""
        with self._lock:
            if self._bucket_by_key.get(key) is not None:
                return
            if level > 0:
                self._register_quality_chain_locked(key, base_chain,
                                                    1 << level)
            self._check_bucket_headroom_locked(key)
        engine = self._acquire_program(key, cause=cause)
        owned = False
        try:
            with self._lock:
                bucket = self._bucket_by_key.get(key)
                if bucket is None:
                    self._create_bucket_locked(key, engine)
                    owned = True
        finally:
            if not owned:
                self.pool.release(key)  # raced into existence: program
                #   stays warm, the live bucket keeps its own lease

    def _warm_quality_async(self, bucket) -> None:
        """Pre-compile the ×2 downshift program for ``bucket``'s
        signature on a background thread (control armed only). The
        moment the quality controller needs that program is
        mid-overload — the worst possible time to pay a cold compile on
        a busy host — so it is warmed through the pool at ADMISSION
        time instead; the eventual downshift costs a pool hit. No-op
        for an unpinned bucket (an undeclared open warms once a later
        declared open or the running controller touches the bucket) and
        for an already-warm or live key."""
        if self.control_plane is None:
            return
        sig = bucket.pinned_signature()
        base_chain = bucket.op_chain
        if sig is None or base_chain is None:
            return
        shape, dtype = sig
        key = self._quality_key(base_chain, shape, dtype, 1)
        if key is None:
            return
        with self._lock:
            if key in self._warmed_quality \
                    or self._bucket_by_key.get(key) is not None:
                return
            self._warmed_quality.add(key)
            self._register_quality_chain_locked(key, base_chain, 2)

        def warm():
            try:
                self._acquire_program(key,
                                      cause=ledger_mod.CAUSE_QUALITY)
                self.pool.release(key)
            except Exception:  # noqa: BLE001 — a failed warm only means
                with self._lock:   # the first downshift pays the
                    self._warmed_quality.discard(key)   # compile after all

        threading.Thread(target=warm, name="dvf-quality-warm",
                         daemon=True).start()

    def _apply_rebinds_dispatch(self) -> None:
        """Dispatch-thread half of a quality move or a live morph:
        flush the session's queued frames (OLD geometry/chain — they
        cannot enter the new program), swap its bucket binding, set the
        level. Atomic with submit's decimate+enqueue under ``_lock``.
        The target bucket's program was compiled ASIDE before the
        request was queued (``_ensure_quality_bucket``), so the cutover
        here is one binding swing between ticks — no stall window is
        opened; the MEASURED swing duration is ledgered as the event's
        ``stall_ms`` (~0). A target bucket that retired between request
        and apply drops the move (counted); the controller re-decides
        from a later window."""
        while True:
            try:
                (sid, key, level, reason,
                 morph_chain) = self._pending_rebinds.get_nowait()
            except queue.Empty:
                return
            t_c = time.time()
            with self._lock:
                s = self._sessions.get(sid)
                if s is None or s.state == CLOSED:
                    self.quality_rebinds_dropped += 1
                    continue
                target = self._bucket_by_key.get(key)
                if target is None:
                    self.quality_rebinds_dropped += 1
                    continue
                old = s.bucket if s.bucket is not None else self._buckets[0]
                flushed = 0
                if target is not old:
                    flushed = s.flush_queued(count_shed=False)
                    self.quality_flushed_frames += flushed
                    old.sessions.pop(sid, None)
                    target.sessions[sid] = s
                    s.bucket = target
                if morph_chain is not None:
                    # Live morph: from here on the session's quality
                    # ladder decimates from the NEW chain; frame
                    # indices stay monotone (submitted is untouched).
                    s.base_chain = morph_chain
                    cutover = s.submitted
                    self.morphs += 1
                else:
                    s.quality_shifts += 1
                    self.quality_rebinds += 1
                s.quality_level = level
            stall_ms = round((time.time() - t_c) * 1e3, 3)
            if self.ledger is not None:
                if morph_chain is not None:
                    self.ledger.record(
                        ledger_mod.SWAP, cause=ledger_mod.CAUSE_MORPH,
                        signature=key.render(), bucket=target.label(),
                        session=sid, cutover_index=cutover,
                        frames_flushed=flushed, stall_ms=stall_ms,
                        reason=reason, t0=t_c)
                    self._observe_swap(stall_ms, key.render(),
                                       ledger_mod.CAUSE_MORPH)
                else:
                    # The rebind's tenant-visible cost is the MEASURED
                    # binding swing (the target program was compiled
                    # aside) — no stall window: the target bucket never
                    # stopped dispatching.
                    self.ledger.record(
                        ledger_mod.QUALITY_REBIND,
                        cause=ledger_mod.CAUSE_QUALITY,
                        signature=key.render(), bucket=target.label(),
                        session=sid, level=level, frames_flushed=flushed,
                        stall_ms=stall_ms, reason=reason, t0=t_c)
            if self.audit is not None:
                # Equivalence verdict for the program the session was
                # just rebound onto — vs the golden path of ITS OWN
                # chain: a rebind/morph is by design not equivalent to
                # the base program, but the substituted program must
                # still compute its chain. Async: this is the dispatch
                # thread — the probe runs on the audit worker (the
                # bucket keeps its engine leased; a raced retirement
                # yields probe_failed, not a crash).
                self.audit.swap_guard(
                    engine=target.engine, filt=target.filter,
                    kind="morph" if morph_chain is not None
                    else "quality_rebind",
                    cause=(ledger_mod.CAUSE_MORPH
                           if morph_chain is not None
                           else ledger_mod.CAUSE_QUALITY),
                    signature=key.render(), bucket=target.label(),
                    reason=reason, asynchronous=True)

    def _apply_resizes_dispatch(self) -> None:
        """Dispatch-thread half of a batch resize, hot-swap edition:
        kick the successor program's compile ASIDE on a short-lived
        background thread (``Engine.prepare_swap``) while the bucket
        KEEPS dispatching at the old
        size. When the aside-compile lands, the staged commit comes
        back through ``_pending_commits`` and
        :meth:`_apply_commits_dispatch` swings the program pointer
        between ticks — no quiesce, no stall window, in-flight batches
        on the old program drain and collect normally."""
        with self._lock:
            pending = list(self._pending_resizes.items())
        for bucket, (n, reason) in pending:
            with self._lock:
                # Liveness checked HERE, under the same lock that
                # retires buckets: a pre-loop snapshot could let a
                # just-retired bucket through, and its pooled engine —
                # possibly re-leased to a new bucket by now — would be
                # recompiled under a live tenant's feet.
                if bucket not in self._buckets:
                    self._pending_resizes.pop(bucket, None)
                    continue
                if bucket in self._preparing_swaps:
                    continue  # an aside-prepare is already in flight;
                    #   this (possibly newer) target waits its turn
                if self._pending_resizes.get(bucket) != (n, reason):
                    continue  # superseded since the snapshot above
                self._pending_resizes.pop(bucket, None)
                if bucket.frame_shape is None:
                    # Nothing has flowed yet: no program at the old size
                    # to swap, the first batch compiles at the new one.
                    bucket.batch_size = n
                    bucket.assembler = None
                    if self.ledger is not None:
                        self.ledger.record(
                            ledger_mod.BATCH_RESIZE,
                            cause=ledger_mod.CAUSE_RESIZE,
                            bucket=bucket.label(), batch_size=n,
                            wall_ms=0.0, reason=reason)
                    continue
                self._preparing_swaps.add(bucket)
                shape = (n, *bucket.frame_shape)
                dtype = np.dtype(bucket.frame_dtype)
            threading.Thread(
                target=self._swap_prepare_resize,
                args=(bucket, n, shape, dtype, reason),
                name="dvf-serve-swap-prepare", daemon=True).start()

    def _swap_prepare_resize(self, bucket: "_Bucket", n: int,
                             shape: tuple, dtype,
                             reason: Optional[str] = None) -> None:
        """Background half of a hot resize: capture the OLD program's
        probe row (the swap guard's bit-identity reference), compile
        the successor at the new batch shape aside, then hand the
        staged commit to the dispatch thread. A failed aside-compile
        is contained — the staged successor is discarded, the old
        program never stopped serving, and the abort is ledgered."""
        t0 = time.time()
        try:
            # Swap guard (obs.audit): the OLD program's probe output
            # captured BEFORE the swap can land — the resize
            # substitutes a program under live tenants, which is only
            # safe if equivalence is proven.
            old_row = (self.audit.probe_row(bucket.engine)
                       if self.audit is not None else None)
            with self._recover_lock:
                prep = bucket.engine.prepare_swap(shape, dtype)
        except Exception as e:  # noqa: BLE001 — counted, never raised
            with self._lock:                # into the serving path
                self.resize_compile_errors += 1
                self.swap_aborts += 1
                self._preparing_swaps.discard(bucket)
            if self.ledger is not None:
                self.ledger.record(
                    ledger_mod.SWAP, cause=ledger_mod.CAUSE_RESIZE,
                    bucket=bucket.label(), batch_size=n,
                    wall_ms=(time.time() - t0) * 1e3, aborted=True,
                    reason=f"aside compile failed (old program keeps "
                           f"serving): {e!r}", t0=t0)
            return
        self._pending_commits.put(
            ("resize", bucket, n, prep, old_row, reason, t0))

    def _apply_commits_dispatch(self) -> None:
        """Dispatch-thread commit of staged hot swaps: one pointer
        swing per swap, between ticks — the only serving time a swap
        consumes, measured and ledgered as its ``stall_ms``."""
        while True:
            try:
                item = self._pending_commits.get_nowait()
            except queue.Empty:
                return
            if item[0] == "resize":
                self._commit_resize_swap(*item[1:])

    def _commit_resize_swap(self, bucket: "_Bucket", n: int, prep: dict,
                            old_row, reason: Optional[str],
                            t0: float) -> None:
        with self._lock:
            live = bucket in self._buckets
            self._preparing_swaps.discard(bucket)
        if not live:
            bucket.engine.abort_swap()  # retired between prepare and
            return                      # commit: staging must not leak
        try:
            res = (bucket.engine.commit_swap()
                   if bucket.engine.swap_staged
                   else {"migrate_ms": 0.0, "stall_ms": 0.0,
                         "migrated": False})
        except Exception as e:  # noqa: BLE001 — abort contained: the
            #   old program is serving, untouched (commit_swap's
            #   failure contract); only the abort is ledgered
            with self._lock:
                self.resize_compile_errors += 1
                self.swap_aborts += 1
            if self.ledger is not None:
                self.ledger.record(
                    ledger_mod.SWAP, cause=ledger_mod.CAUSE_RESIZE,
                    bucket=bucket.label(), batch_size=n,
                    wall_ms=(time.time() - t0) * 1e3, aborted=True,
                    reason=f"swap commit failed (old program keeps "
                           f"serving): {e!r}", t0=t0)
            return
        self._adopt_bucket_key(bucket)  # takes self._lock itself
        with self._lock:
            bucket.batch_size = n
            bucket.assembler = None  # staging re-derives at the new batch
            #   shape in _builder_for; the egress fetcher re-derives at
            #   the next dispatch (in-flight batches keep fetching
            #   through the fetcher pinned on their plan)
            self.swaps += 1
        if self.ledger is not None:
            label = bucket.label()
            self.ledger.record(
                ledger_mod.SWAP, cause=ledger_mod.CAUSE_RESIZE,
                signature=label, bucket=label, batch_size=n,
                wall_ms=(time.time() - t0) * 1e3,
                compile_aside_ms=round(
                    float(prep.get("compile_aside_ms", 0.0)), 3),
                migrate_ms=res["migrate_ms"],
                stall_ms=res["stall_ms"],
                cache=prep.get("cache"), reason=reason, t0=t0)
            self._observe_swap(res["stall_ms"], label,
                               ledger_mod.CAUSE_RESIZE)
        if self.audit is not None:
            # Equivalence verdict for the adopted program: probe
            # through the new program vs the golden path (and
            # bit-identity vs the old program's probe row — same
            # per-frame geometry across a batch resize). Async: this
            # is the dispatch thread. Ledgered as a swap_guard event:
            # zero unaudited substitutions.
            self.audit.swap_guard(
                engine=bucket.engine, filt=bucket.filter,
                kind="batch_resize", cause=ledger_mod.CAUSE_RESIZE,
                signature=bucket.label(), bucket=bucket.label(),
                old_row=old_row, reason=reason, asynchronous=True)

    def submit(self, session_id: str, frame: np.ndarray,
               ts: Optional[float] = None, tag: Any = None) -> int:
        """Enqueue one frame on a stream; returns its per-stream index."""
        if self._error is not None:
            # The service threads died (error budget exhausted / fail-fast
            # fault): surface it to the submitting client instead of
            # queueing frames nothing will ever serve.
            raise ServeError(
                f"frontend failed: {self._error!r}") from self._error
        s = self._session(session_id)
        if self.control_plane is None:
            # No control plane → no quality rebinds: a session's bucket
            # binding and level are fixed after open, so the hot path
            # stays lock-free (the lock below exists only to serialize
            # with rebind flushes). Geometry pin is the one first-frame
            # race, double-checked under the lock.
            bucket = s.bucket if s.bucket is not None else self._buckets[0]
            if bucket.frame_shape is None:
                with self._lock:
                    if bucket.frame_shape is None:
                        bucket.frame_shape = tuple(frame.shape)
                        bucket.frame_dtype = np.dtype(frame.dtype)
            if tuple(frame.shape) != tuple(bucket.frame_shape) \
                    or np.dtype(frame.dtype) != np.dtype(
                        bucket.frame_dtype):
                raise ValueError(
                    f"frame {frame.shape}/{frame.dtype} does not match "
                    f"this stream's pinned signature "
                    f"{tuple(bucket.frame_shape)}/"
                    f"{np.dtype(bucket.frame_dtype)} (one compiled "
                    f"program serves every session in a bucket — "
                    f"geometry is per-bucket, not per-stream; open a "
                    f"stream with frame_shape=/op_chain= to route to "
                    f"another bucket)")
            return s.submit(frame, ts=ts, tag=tag)
        # ONE atomic section for the (bucket, quality_level) read, the
        # decimation, the geometry check, AND the enqueue: quality
        # rebinds (dispatch thread) swap bucket+level and flush the
        # queues under this same lock, so no frame of the OLD geometry
        # can slip into the ingress after the flush — without this, a
        # submit racing a rebind could poison a whole device batch.
        with self._lock:
            bucket = s.bucket if s.bucket is not None else self._buckets[0]
            level = s.quality_level
            if level > 0:
                # Downshifted session: decimate ×2^level per axis at the
                # door (a strided VIEW — zero copy until staging); the
                # downshift bucket's op chain ends in the matching
                # upscale stage, so the DELIVERY is still full
                # resolution. Bit-exactness is waived exactly while the
                # level is > 0.
                f = 1 << level
                frame = frame[::f, ::f]
            if bucket.frame_shape is None:
                bucket.frame_shape = tuple(frame.shape)
                bucket.frame_dtype = np.dtype(frame.dtype)
            if tuple(frame.shape) != tuple(bucket.frame_shape) \
                    or np.dtype(frame.dtype) != np.dtype(bucket.frame_dtype):
                raise ValueError(
                    f"frame {frame.shape}/{frame.dtype} does not match this "
                    f"stream's pinned signature {tuple(bucket.frame_shape)}/"
                    f"{np.dtype(bucket.frame_dtype)} (one compiled program "
                    f"serves every session in a bucket — geometry is "
                    f"per-bucket, not per-stream; open a stream with "
                    f"frame_shape=/op_chain= to route to another bucket)")
            return s.submit(frame, ts=ts, tag=tag)

    def poll(self, session_id: str, max_items: Optional[int] = None) -> list:
        """Pop completed ``Delivery`` records for one stream (works on
        retired sessions until their tail is drained)."""
        return self._session(session_id).poll(max_items)

    def resume_token(self, session_id: str) -> str:
        """A resume credential for an open (or retired-but-pollable)
        session: a keyed MAC over the session id, verified by
        :meth:`resume_stream`. Cheap and stateless — issue it at open
        time and hand it to the client beside the session id."""
        self._session(session_id)  # existence check (raises KeyError)
        return make_resume_token(session_id, 0, self._token_secret)

    def resume_stream(self, session_id: str, token: str,
                      from_index: int = 0) -> list:
        """Replay the session's retained delivered tail from
        ``from_index`` (inclusive) — the reconnect path.

        Returns the replayed ``Delivery`` records in index order; the
        caller dedups by index against what it already has (duplicates
        are EXPECTED — replay overlaps the frames that did arrive).
        Frames older than the replay window are gone (the ring is
        bounded); a client that reconnects within the window gets an
        exactly-once stream, one that waited longer sees a gap it must
        treat as at-most-once loss. Raises ``ServeError`` on a bad
        token (counted as ``resume_rejected``), ``KeyError`` on an
        unknown session."""
        if check_resume_token(token, session_id, self._token_secret) is None:
            self.continuity.inc("resume_rejected")
            raise ServeError(
                f"invalid resume token for session {session_id!r}")
        s = self._session(session_id)
        replayed = ([] if s.replay is None
                    else [d for _, d in s.replay.replay_from(from_index)])
        self.continuity.inc("resumes")
        self.continuity.inc("replays")
        self.continuity.inc("replayed_frames", len(replayed))
        if self.ledger is not None:
            self.ledger.record(
                ledger_mod.RESUME, cause=ledger_mod.CAUSE_RECOVERY,
                sid=session_id, from_index=int(from_index),
                replayed=len(replayed))
        return replayed

    def close(self, session_id: str, drain: bool = True) -> None:
        """Per-session teardown. ``drain=True`` (graceful) serves what's
        queued and in flight first; the dispatch thread retires the
        session once it has drained. Other sessions are untouched."""
        self._session(session_id).close(drain=drain)

    def session_drained(self, session_id: str) -> bool:
        """True once a closed session has delivered everything it ever
        will: the dispatch thread finalized it (nothing queued or in
        flight, the reorder tail handed to its out-queue). What a
        fleet's graceful migration waits for before its last salvage
        poll, instead of a quiet window a slow batch can outlast."""
        return self._session(session_id).state == CLOSED

    def open_count(self) -> int:
        """Number of non-retired sessions — cheap (no percentile work),
        for polling loops that just watch for drain/retirement."""
        with self._lock:
            return len(self._sessions)

    def release(self, session_id: str) -> None:
        """Forget a retired session (its undrained tail is dropped).
        Call once the client has polled everything it wants — retired
        sessions are otherwise only evicted by the max_retired bound."""
        with self._lock:
            if session_id in self._sessions:
                raise ServeError(
                    f"session {session_id!r} is still open; close() it first")
            s = self._retired.pop(session_id, None)
            if s is not None:
                self._absorb_totals_locked(s)

    def _session(self, session_id: str) -> StreamSession:
        with self._lock:
            s = self._sessions.get(session_id) or self._retired.get(session_id)
        if s is None:
            raise KeyError(f"unknown session {session_id!r}")
        return s

    def _absorb_totals_locked(self, s: StreamSession) -> None:
        """Fold a session leaving the retired map into the lifetime
        counter floor (see _evicted_totals)."""
        t = self._evicted_totals
        t["submitted"] += s.submitted
        t["delivered"] += s.delivered
        t["shed"] += s.shed
        t["slo_miss"] += s.slo_miss
        t["failed"] += s.failed
        t["dropped_at_ingress"] += s.ingress.dropped

    def _retire_locked(self, sid: str, session: StreamSession) -> None:
        """Move one session to the retired map, evicting oldest beyond
        the retention bound (dicts iterate in insertion order)."""
        self._retired[sid] = session
        while len(self._retired) > self.config.max_retired:
            self._absorb_totals_locked(
                self._retired.pop(next(iter(self._retired))))

    # -- service threads -------------------------------------------------

    def _builder_for(self, bucket: "_Bucket", seq: int):
        """One staged batch via the bucket's assembler (runtime/ingest.py)
        — both ingest modes; the assembler owns the per-inflight-slot
        staging pool (max_inflight + 1 buffers: the one being rewritten
        always belongs to an already-collected batch, exactly like the
        single-stream pipeline's). Per bucket because the slabs follow
        THAT bucket's engine (its device and H2D stream) AND its
        (resizable) batch size."""
        shape = (bucket.batch_size, *bucket.frame_shape)
        dtype = np.dtype(bucket.frame_dtype)
        if (bucket.assembler is None
                or bucket.assembler.batch_shape != shape
                or bucket.assembler.depth != self.config.ingest_depth):
            # The depth check is the auto-plan seam: a planned (or
            # candidate) ingest depth lands in config and the next
            # rebuild picks it up — exactly how a batch resize already
            # re-derives the slab layout.
            before = bucket.engine.stats.compile_count
            self._seed_calibrations(bucket)
            bucket.engine.ensure_compiled(shape, dtype)
            self._save_calibrations(bucket, before)
            # A compile that actually ran here is the legacy lazy pin
            # (default bucket, first traffic) — ledger it as an
            # admission-cause compile ON THE DISPATCH THREAD, which is
            # exactly the stall the compile-ahead path exists to avoid.
            self._record_inline_compile(bucket, before,
                                        ledger_mod.CAUSE_ADMISSION)
            self._adopt_bucket_key(bucket)
            bucket.ingest_stats = IngestStats(
                requested_mode=self.config.ingest,
                depth=self.config.ingest_depth,
                h2d_block_ms=bucket.engine.h2d_block_ms)
            bucket.assembler = ShardedBatchAssembler(
                shape, dtype, bucket.engine.placement,
                mode=bucket.ingest_mode, depth=self.config.ingest_depth,
                slots=self.config.max_inflight + 1,
                stats=bucket.ingest_stats, chaos=self.config.chaos,
                tracer=self.tracer, track=TRACK_H2D,
                stream=bucket.engine.h2d_stream_for)
            if bucket.degrade_reason is not None:
                bucket.ingest_stats.fallback_reason = bucket.degrade_reason
        return bucket.assembler.begin(seq)

    def _adopt_bucket_key(self, bucket: "_Bucket") -> None:
        """Once a bucket's engine has compiled, its canonical signature
        is known: register the bucket under it (a later declared open of
        the same signature joins this bucket instead of forking a
        duplicate program) and adopt the engine into the program pool
        (the signature stays warm after the bucket retires)."""
        if getattr(bucket, "_pooled", False):
            return
        key = bucket.engine.signature_key
        if key is None:
            return
        prof = (load_stage_profile(self.config.profile_dir, key.render())
                if self.config.profile_dir else None)
        with self._lock:
            if bucket.key is None:
                bucket.key = key
            if prof is not None and bucket.stage_profile is None:
                bucket.stage_profile = prof
            self._bucket_by_key.setdefault(key, bucket)
        try:
            self.pool.adopt(key, bucket.engine)
        except (ValueError, RuntimeError):
            return  # another engine already pooled under this key (or
            #   the pool closed mid-stop): this engine stays un-pooled;
            #   stop() frees it directly
        bucket._pooled = True

    def _fetcher_for(self, bucket: "_Bucket"):
        """The bucket's streamed-egress fetcher for its engine's
        compiled output signature — the delivery-side mirror of
        ``_builder_for``, same slot discipline (max_inflight + 1 slabs;
        the router copies rows out during route(), so a slab is
        quiescent before its slot cycles). Built by the dispatch thread;
        the collect thread only reads it."""
        shape = getattr(bucket.engine, "out_shape", None)
        if shape is None:
            return None
        f = bucket.fetcher
        if f is None or f.out_shape != tuple(shape) \
                or f.dtype != bucket.engine.out_dtype:
            if f is not None:
                # Output signature changed under a hot swap: batches
                # already prefetched into the old fetcher are still in
                # flight (their plans pin it) — park it for release
                # once the bucket's window drains instead of freeing
                # slabs the collect side is about to read.
                bucket.draining_fetchers.append(f)
            bucket.egress_stats = EgressStats(
                requested_mode=self.config.egress,
                d2h_block_ms=bucket.engine.d2h_block_ms)
            bucket.fetcher = f = ShardedBatchFetcher(
                shape, bucket.engine.out_dtype, bucket.engine.placement,
                mode=bucket.egress_mode,
                slots=self.config.max_inflight + 1,
                stats=bucket.egress_stats, chaos=self.config.chaos,
                tracer=self.tracer, track=TRACK_D2H,
                stream=bucket.engine.d2h_stream_for)
            if bucket.egress_degrade_reason is not None:
                bucket.egress_stats.fallback_reason = \
                    bucket.egress_degrade_reason
        return f

    def _fail(self, e: BaseException) -> None:
        first = self._error is None
        if first:
            self._error = e
        self._stop.set()
        if first:
            # Hard failure (fault budget exhausted, fail-fast fault,
            # unrecoverable engine): the moment a post-mortem is worth a
            # dump. Best-effort, rate-limited in the recorder.
            self._flight_trip(f"frontend failed: {e!r}")

    def _contain(self, e: BaseException, where: str,
                 bucket: Optional["_Bucket"] = None) -> bool:
        """Bounded containment (resilience.budget): classify, count,
        continue while within the per-kind budget; the first overflow
        degrades (h2d → monolithic ingest, compute/oom → supervised
        engine rebuild), the second surfaces a hard ServeError — a
        permanently broken engine must not serve 0 fps silently.
        Budgets attribute PER BUCKET: one signature's broken program
        spends its own budget, never another tenant mix's."""
        kind = classify(e, site=where)
        self.faults.record(kind, e)
        if bucket is not None:
            bucket.record_fault(kind)
        if not (self.config.resilient and isinstance(e, Exception)):
            self._fail(e)
            return False
        self.errors += 1
        budget = bucket.budget if bucket is not None else self._budget
        if escalate(budget, kind,
                    lambda k: self._degrade(k, bucket)) == ErrorBudget.CONTAIN:
            print(f"[serve:{where}] {kind} fault (continuing): {e!r}",
                  file=sys.stderr, flush=True)
            return True
        self._fail(ServeError(
            f"error budget exhausted for {kind!r} faults "
            f"(> {self.config.fault_budget} in "
            f"{self.config.fault_window_s:g}s, after degradation"
            + (f"; bucket {bucket.label()}" if bucket is not None else "")
            + f"); last: {e!r}"))
        return False

    def _degrade(self, kind: str,
                 bucket: Optional["_Bucket"] = None) -> bool:
        """First-overflow degradation per kind (per bucket). Returns
        True if applied (the fault is then still contained; a second
        overflow fails)."""
        b = bucket if bucket is not None else self._buckets[0]
        if kind == FaultKind.H2D and b.ingest_mode == "streamed":
            b.ingest_mode = "monolithic"
            b.degrade_reason = "h2d_fault_budget"
            b.assembler = None
            print(f"[serve] repeated h2d faults: degrading ingest "
                  f"streamed → monolithic (bucket {b.label()})",
                  file=sys.stderr, flush=True)
            return True
        if kind == FaultKind.D2H and b.egress_mode == "streamed":
            b.egress_mode = "monolithic"
            b.egress_degrade_reason = "d2h_fault_budget"
            old, b.fetcher = b.fetcher, None
            if old is not None:
                old.release()
            print(f"[serve] repeated d2h faults: degrading egress "
                  f"streamed → monolithic (bucket {b.label()})",
                  file=sys.stderr, flush=True)
            return True
        if kind in (FaultKind.COMPUTE, FaultKind.OOM, FaultKind.INTERNAL):
            # The bucket's engine itself may be the broken thing
            # (poisoned compile cache, leaked device state): rebuild it
            # once. If the fresh engine still faults through a second
            # budget window, the filter/input is broken, not the
            # engine — FAIL.
            self._recover(f"fault budget overflow ({kind})", kind=kind,
                          bucket=b)
            return True
        return False

    def _on_stall(self, reason: str) -> None:
        """Watchdog callback (supervisor thread): a submitted batch aged
        past stall_timeout_s without materializing."""
        e = FaultError(FaultKind.STALL, f"serve stalled: {reason}")
        self.faults.record(FaultKind.STALL, e)
        if not self.config.resilient:
            self._fail(e)
            return
        self.errors += 1
        # Stall escalation is consecutive, not time-windowed: stalls
        # arrive at most once per stall_timeout_s, so a sliding window
        # could never fill — instead, recoveries that never restore
        # service (no batch materializes in between, which would reset
        # the counter in _collect) declare the engine unrecoverable.
        self._stalls_since_progress += 1
        if self._stalls_since_progress > self._stall_fail_after:
            self._fail(ServeError(
                f"{self._stalls_since_progress} consecutive stall "
                f"recoveries without a served batch (engine "
                f"unrecoverable): {reason}"))
            return
        self._recover(reason, kind=FaultKind.STALL)

    def _recover(self, reason: str, kind: str = FaultKind.STALL,
                 bucket: Optional["_Bucket"] = None) -> None:
        """Supervised recovery: shed the in-flight window (each lost
        frame attributed to ``kind`` in its session's fault counters),
        replace the collect thread (a wedged one exits when it wakes —
        generation check), rebuild the affected buckets' Engines
        (recompile, re-warm, re-calibrate h2d_block_ms — compiled aside
        and swapped in place), and reset the in-flight semaphore.
        ``bucket`` names the faulted
        bucket when the caller knows it (budget overflow); a stall
        rebuilds every bucket found in the shed window (all buckets if
        the window was empty — the wedge has no known owner). Open
        sessions are untouched: their frame index spaces, reorder
        cursors, and out queues survive, so indices stay monotone across
        the recovery. Runs in whichever thread detected the fault
        (supervisor, dispatch, or collect); serialized by _recover_lock.
        """
        with self._recover_lock:
            if self._stop.is_set():
                return
            print(f"[serve] recovering engine ({reason}): shedding "
                  f"in-flight window, rebuilding engine",
                  file=sys.stderr, flush=True)
            self._recovering.set()
            affected = set() if bucket is None else {bucket}
            try:
                # Wait (bounded) for the dispatch thread to park, unless
                # WE are the dispatch thread (then it's here, not mid-
                # staging): a straddling iteration could otherwise put a
                # batch into the old queue after the drain below. If it's
                # wedged past the deadline, any straggler is caught by
                # the watchdog window on the next trip.
                if threading.current_thread() is not self._dispatch_thread:
                    deadline = time.monotonic() + 2.0
                    while (not self._dispatch_parked.is_set()
                           and not self._stop.is_set()
                           and time.monotonic() < deadline):
                        time.sleep(0.002)
                old_q = self._inflight
                while True:  # shed everything queued for collection
                    try:
                        seq, plan, _result, _t0 = old_q.get_nowait()
                    except queue.Empty:
                        break
                    if plan.bucket is not None:
                        affected.add(plan.bucket)
                    self.router.discard(plan, kind=kind)
                    self._window.remove(seq)
                # Batches popped by a wedged collect but never routed:
                # write them off too (route() skips dead plans if that
                # thread ever wakes up holding one). The window is owned
                # by the frontend, so this works with the watchdog off.
                for _seq, plan in self._window.drain():
                    if plan is not None:
                        if plan.bucket is not None:
                            affected.add(plan.bucket)
                        self.router.discard(plan, kind=kind)
                # Fresh queue + semaphore BEFORE the replacement collect
                # thread starts: generation-pinning means the old thread
                # only ever sees the old (now drained) queue, and permits
                # held by shed batches die with the old semaphore instead
                # of leaking into (or over-crediting) the new window.
                self._inflight = queue.Queue()
                self._inflight_sem = threading.Semaphore(
                    self.config.max_inflight)
                # Replace the collect thread; a live one exits at its next
                # generation check, a wedged one whenever it wakes. Prune
                # exited threads first — a long-lived server recovering
                # through intermittent fault bursts must not accumulate
                # one dead Thread per recovery forever.
                self._collect_gen += 1
                t = threading.Thread(
                    target=self._collect, name="dvf-serve-collect",
                    daemon=True, args=(self._collect_gen,))
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
                t.start()
                # Rebuild the affected buckets' engines. A wedge with no
                # known owner (empty window, no named bucket) rebuilds
                # everything — correctness first.
                with self._lock:
                    all_buckets = list(self._buckets)
                targets = affected or set(all_buckets)
                for b in targets:
                    t_rb = time.time()
                    stall_from = (b.last_dispatch_t
                                  if b.last_dispatch_t is not None
                                  else t_rb)
                    # Swap guard: old-program probe BEFORE the rebuild
                    # replaces it (best-effort — a broken engine's
                    # probe failing is itself expected here).
                    old_row = (self.audit.probe_row(b.engine)
                               if self.audit is not None else None)
                    swapped = False
                    sig = b.engine.signature
                    if sig is not None:
                        # Double-buffered rebuild: compile the fresh
                        # program aside, then adopt it in place —
                        # Engine identity stays stable, so pool leases
                        # (and any other bucket sharing the lease)
                        # survive without pool.replace. force=True:
                        # the live program is suspect, a same-signature
                        # short-circuit would hand it right back.
                        # migrate_state=False: suspect state must not
                        # be carried into the replacement.
                        shape, dtype = sig
                        try:
                            b.engine.prepare_swap(shape, dtype,
                                                  force=True)
                            b.engine.commit_swap(migrate_state=False)
                            swapped = True
                            self.swaps += 1
                        except Exception:  # noqa: BLE001 — fall back
                            b.engine.abort_swap()   # to the cold path
                    if not swapped:
                        b.engine = b.engine.rebuild()
                        if b._pooled and b.key is not None:
                            try:
                                self.pool.replace(b.key, b.engine)
                            except RuntimeError:
                                # Pool closed mid-recovery (owner
                                # stopping): replace() freed the rebuilt
                                # engine — the frontend is past serving
                                # this bucket.
                                pass
                    a, b.assembler = b.assembler, None
                    f, b.fetcher = b.fetcher, None  # re-derive from the
                    #   fresh engine's re-calibrated d2h_block_ms; slabs
                    #   released eagerly so the memory accounting never
                    #   counts an abandoned pool as occupied
                    if a is not None:
                        a.release()
                    if f is not None:
                        f.release()
                    b.release_drained_fetchers()  # window fully shed:
                    #   nothing in flight can still pin them
                    if self.ledger is not None:
                        label = b.label()
                        compile_ms = b.engine.last_compile_ms
                        self.ledger.record(
                            ledger_mod.ENGINE_REBUILD,
                            cause=ledger_mod.CAUSE_RECOVERY,
                            signature=label, bucket=label,
                            fault_kind=kind, reason=reason,
                            wall_ms=(time.time() - t_rb) * 1e3,
                            compile_ms=(round(float(compile_ms), 3)
                                        if compile_ms is not None
                                        else None),
                            swap=swapped or None,
                            t0=t_rb, stall_from=stall_from)
                        if compile_ms is not None:
                            self._observe_compile(
                                compile_ms, label,
                                ledger_mod.CAUSE_RECOVERY)
                    if self.audit is not None:
                        # Equivalence verdict for the rebuilt program
                        # (recovery substitutes it under live
                        # sessions): new probe vs golden, plus
                        # bit-identity vs the old program when it was
                        # still probeable.
                        self.audit.swap_guard(
                            engine=b.engine, filt=b.filter,
                            kind="engine_rebuild",
                            cause=ledger_mod.CAUSE_RECOVERY,
                            signature=b.label(), bucket=b.label(),
                            old_row=old_row, reason=reason)
                # Second straggler sweep: a dispatch iteration that was
                # mid-staging when the drain above ran (wedged past the
                # park deadline) has had the whole engine rebuild to land
                # its put into the abandoned queue/window — write it off
                # now so its sessions' claims never leak even with the
                # watchdog (whose next trip would otherwise catch it) off.
                while True:
                    try:
                        seq, plan, _result, _t0 = old_q.get_nowait()
                    except queue.Empty:
                        break
                    self.router.discard(plan, kind=kind)
                    self._window.remove(seq)
                for _seq, plan in self._window.drain():
                    if plan is not None:
                        self.router.discard(plan, kind=kind)
                # The window is empty: no bucket has anything in flight.
                for b in all_buckets:
                    b.reset_inflight()
                self.recoveries += 1
            finally:
                self._recovering.clear()

    def _finalize_drained(self) -> None:
        """Retire closing sessions with nothing left queued or in flight
        (dispatch thread — it owns the pending deques being checked)."""
        with self._lock:
            done = [(sid, s) for sid, s in self._sessions.items()
                    if s.drained()]
            for sid, s in done:
                self._sessions.pop(sid)
                if s.bucket is not None:
                    s.bucket.sessions.pop(sid, None)
                self._retire_locked(sid, s)
        for _, s in done:
            s.finalize()

    def _dispatch(self) -> None:
        seq = 0
        try:
            while not self._stop.is_set():
                if self._recovering.is_set():
                    # Supervised recovery in progress: park — the engine,
                    # queue, and semaphore are being replaced under us.
                    # _recover waits for this flag before touching them.
                    self._dispatch_parked.set()
                    time.sleep(self._tick_s)
                    continue
                self._dispatch_parked.clear()
                if self._supervisor is not None:
                    self._supervisor.beat("dispatch")
                # Actuations owned by THIS thread: morphs (flush +
                # bucket swap touch the session pending deques only
                # dispatch may touch),
                # batch-resize aside-prepares (kicked to a background
                # thread; the bucket keeps serving), and staged swap
                # commits (the atomic pointer swing between ticks).
                if not self._pending_rebinds.empty():
                    self._apply_rebinds_dispatch()
                if self._pending_resizes:
                    self._apply_resizes_dispatch()
                if not self._pending_commits.empty():
                    # Staged hot swaps land HERE, between ticks: one
                    # pointer swing per swap — the only serving time a
                    # reconfiguration consumes on this thread.
                    self._apply_commits_dispatch()
                with self._lock:
                    # Buckets with an aside-prepare in flight keep
                    # dispatching at the OLD size/program — a hot swap
                    # never quiesces; the commit lands between ticks.
                    bucket_sessions = [
                        (b, [s for s in b.sessions.values()
                             if s.state != CLOSED])
                        for b in self._buckets if b.sessions]
                plan = None
                if bucket_sessions:
                    # One bucket per tick (one compiled program per
                    # batch): EDF-headroom ÷ measured tick cost picks
                    # the bucket, then the ordinary within-bucket EDF
                    # picks the slots. Frames are staged through the
                    # bucket's assembler below, after the in-flight
                    # permit is acquired (the permit is what makes
                    # staging-slab reuse safe) — one staging
                    # implementation for both ingest modes.
                    pick, chosen = self.batcher.select_bucket(
                        bucket_sessions, time.time())
                    if chosen:
                        plan = BatchPlan(batch=None, valid=len(chosen),
                                         slots=chosen, bucket=pick)
                self._finalize_drained()
                if plan is None:
                    time.sleep(self._tick_s)
                    continue
                # Bounded in-flight depth; poll so shutdown can't wedge on
                # a dead collect thread. Acquired before any staging
                # buffer is touched — the permit is what makes
                # staging/slab reuse safe. The semaphore AND queue are
                # captured per iteration: recovery installs fresh ones,
                # and a batch must live entirely in one generation — a
                # straddler releasing a permit into the NEW semaphore
                # would over-credit the window (one extra batch in flight
                # breaks the staging pool's max_inflight+1 reuse contract).
                sem = self._inflight_sem
                acquired = False
                while True:
                    if sem.acquire(timeout=0.1):
                        acquired = True
                        break
                    if self._stop.is_set():
                        self.router.discard(plan)
                        return
                    if self._recovering.is_set():
                        break  # shed below, then park at the loop top
                    sem = self._inflight_sem
                if not acquired or sem is not self._inflight_sem:
                    # Recovery started while we waited (or swapped the
                    # semaphore right after our acquire): shed this plan
                    # into the recovery's accounting rather than staging
                    # into structures being torn down.
                    self.router.discard(plan, kind=FaultKind.STALL)
                    continue
                q = self._inflight
                t0 = time.time()
                bucket = plan.bucket
                if self.attribution is not None:
                    # Lineage hop: bucket queue wait ends as staging
                    # begins (one stamp per batch, fanned to the chosen
                    # slots); the batch-level marks list then collects
                    # assemble_h2d here and device/d2h on the collect
                    # side — the router extends each slot's lineage.
                    for slot in plan.slots:
                        if slot.lin is not None:
                            slot.lin.mark("queue_bucket", t0)
                    plan.lin_marks = []
                # A tick-cost sample is trustworthy only when nothing
                # else is in flight at submit: otherwise submit→
                # materialize includes queue wait behind OTHER batches'
                # device time (possibly other buckets' much costlier
                # programs) and the EWMA the EDF/cost score divides by
                # converges to the shared pipeline latency, not this
                # program's cost. Contended ticks still count batches;
                # they just don't feed the estimate.
                plan.cost_sample = len(self._window) == 0
                if self.audit is not None:
                    # Shadow-replay sampling (obs.audit): the sampler
                    # decides per staged frame; a picked frame's INPUT
                    # is copied here — the only place it still exists —
                    # and paired with its delivered output at collect.
                    # One modulo per frame when nothing is picked.
                    for row, slot in enumerate(plan.slots[: plan.valid]):
                        if self.audit.want_sample():
                            if plan.audit_rows is None:
                                plan.audit_rows = []
                            plan.audit_rows.append(
                                (row, np.array(slot.frame, copy=True),
                                 slot.session.id, slot.index, slot.lin))
                pools = (bucket.assembler, bucket.fetcher)
                try:
                    builder = self._builder_for(bucket, seq)
                    for row, slot in enumerate(plan.slots):
                        builder.write_row(row, slot.frame)
                        slot.frame = None  # drop the client's buffer
                    batch, resident = builder.finish(plan.valid)
                    engine = bucket.engine
                    # Compute runs on this thread's current stream; on
                    # the streamed path it waits for the builder's last
                    # chunk copy (an event on the engine's H2D stream).
                    result = (engine.submit_resident(batch,
                                                     ready=builder.ready)
                              if resident
                              else engine.submit(batch, fetch=False))
                    if plan.lin_marks is not None:
                        # Batch assembly + H2D ends at submit return
                        # (the device now owns the batch).
                        plan.lin_marks.append(("assemble_h2d", time.time()))
                    # Start the D2H now, on the engine's D2H stream after
                    # the compute event, so the collect side only waits,
                    # never initiates (runtime/egress.py).
                    fetcher = self._fetcher_for(bucket)
                    if fetcher is not None:
                        fetcher.prefetch(result, seq)
                    if (bucket.assembler, fetcher) != pools:
                        # This tick built the bucket's staging or delivery
                        # slab pool (pinned host memory on a card: about
                        # 0.1 s per GB), which is not the program's cost.
                        # A divergence from the reference, whose first
                        # sample includes it.
                        plan.cost_sample = False
                    plan.fetcher = fetcher  # pinned: a hot swap may
                    #   re-derive bucket.fetcher (new output signature)
                    #   while this batch is in flight — collect must
                    #   fetch from the one the D2H was issued on
                    if self.tracer.enabled:
                        self.tracer.complete("serve_dispatch",
                                             self.tracer.perf_of_wall(t0),
                                             time.perf_counter(),
                                             TRACK_DISPATCH, seq=seq,
                                             frames=plan.valid,
                                             bucket=bucket.label())
                except Exception as e:  # noqa: BLE001 — drop this batch
                    sem.release()
                    self.router.discard(plan, kind=classify(e, "dispatch"))
                    if not self._contain(e, "dispatch", bucket=bucket):
                        return
                    continue
                # In-flight window: registered from now until the collect
                # side materializes (or discards) it; carries the plan so
                # a recovery can shed the sessions' claims even for a
                # batch a wedged collect thread is holding. The watchdog
                # (when armed) trips on this window's oldest age.
                self._window.add(seq, plan)
                bucket.adjust_inflight(1)
                q.put((seq, plan, result, t0))
                # Ledger stall accounting: this tick is the bucket's
                # dispatch heartbeat — it closes any reconfiguration
                # stall window open on the bucket (gap measured from
                # the last tick before the event to THIS one). One
                # attribute check when nothing is pending.
                bucket.last_dispatch_t = t0
                led = self.ledger
                if led is not None and led.has_pending_stalls:
                    led.note_dispatch(bucket.label(), t0)
                seq += 1
        except BaseException as e:  # noqa: BLE001
            self._fail(e)
        finally:
            self._dispatch_done.set()

    def _collect(self, gen: int = 0) -> None:
        chaos = self.config.chaos
        q = self._inflight  # generation-pinned: recovery installs a fresh
        #   queue before starting the replacement thread, so a superseded
        #   thread can never pop (and then wrongly discard) a
        #   post-recovery batch — it only ever sees its own, drained,
        #   queue and whatever single item it was already holding.
        sem = self._inflight_sem  # pinned with the queue: a permit must be
        #   released into the semaphore it was acquired from — releasing
        #   the live attribute would over-credit a post-recovery window
        try:
            while self._collect_gen == gen:  # superseded by recovery → exit
                if chaos is not None:
                    chaos.fire("freeze")  # injection site: a delay rule
                    #   wedges this consumer (deterministic stall for the
                    #   watchdog tests)
                if self._supervisor is not None:
                    self._supervisor.beat("collect")
                try:
                    seq, plan, result, _t0 = q.get(timeout=0.05)
                except queue.Empty:
                    if self._dispatch_done.is_set() and q.empty():
                        break
                    continue
                bucket = plan.bucket
                fetcher = (plan.fetcher if plan.fetcher is not None
                           else (bucket.fetcher if bucket is not None
                                 else None))  # plan-pinned first: the
                #   bucket's fetcher may already belong to a hot-swapped
                #   successor program with a different output signature
                if plan.lin_marks is not None:
                    # Lineage needs the device/D2H split: the device
                    # mark is taken once THIS batch's compute event has
                    # completed (submit returned at launch, so a stamp
                    # there would be the launch time); the fetch that
                    # follows is then the D2H wait. Never a device-wide
                    # synchronize: that would wait on every bucket's
                    # work and the copy streams.
                    try:
                        wait_compute(result)
                        plan.lin_marks.append(("device", time.time()))
                    except Exception:  # noqa: BLE001 — a poisoned batch
                        pass  # raises again in fetch below, where the
                        #   containment ladder owns it
                try:
                    # Streamed egress: the slot's pinned slab (D2H issued
                    # at submit); monolithic: a fresh host copy. Either
                    # way this waits on the batch's events, never on a
                    # stream. The router copies rows out during route(),
                    # so handing it the pooled slab is safe — the slot
                    # only cycles max_inflight+1 batches later.
                    out = (fetcher.fetch(result, seq) if fetcher is not None
                           else _fetch_whole(result))
                    if plan.lin_marks is not None:
                        plan.lin_marks.append(("d2h", time.time()))
                    if chaos is not None:
                        # Chaos site "corrupt_device": one element of
                        # row 0 perturbed in an otherwise-valid batch —
                        # the silent corruption ONLY the shadow replay
                        # below can catch (it parses, routes, delivers).
                        out = maybe_corrupt_device(chaos, out)
                except Exception as e:  # noqa: BLE001 — poisoned batch
                    if self._collect_gen != gen:
                        # Superseded mid-wait: make sure the plan's
                        # session claims are released — discard is
                        # idempotent, so this is a no-op when recovery
                        # already shed it.
                        self.router.discard(plan)
                        continue
                    self._window.remove(seq)
                    sem.release()
                    if bucket is not None:
                        bucket.adjust_inflight(-1)
                    self.router.discard(plan, kind=classify(e, "collect"))
                    if not self._contain(e, "collect", bucket=bucket):
                        return
                    continue
                if self._collect_gen != gen:
                    # Recovery wrote this batch off while we materialized
                    # it: drop the result (semaphore replaced, no release)
                    # but release the session claims if the recovery could
                    # not see this plan (it was popped, so only the
                    # supervisor window — when armed — tracked it).
                    self.router.discard(plan)
                    continue
                self._window.remove(seq)
                sem.release()
                if bucket is not None:
                    # Live tick-cost sample for the EDF/cost bucket score
                    # (submit → materialized wall time, EWMA-smoothed;
                    # contended ticks are counted but not sampled — see
                    # the dispatch-side cost_sample comment).
                    bucket.observe_tick((time.time() - _t0) * 1e3,
                                        sample=plan.cost_sample,
                                        valid=plan.valid)
                    bucket.adjust_inflight(-1)
                if self.tracer.enabled:
                    self.tracer.complete("batch_complete",
                                         self.tracer.perf_of_wall(_t0),
                                         time.perf_counter(),
                                         TRACK_DEVICE, seq=seq,
                                         frames=plan.valid)
                if plan.audit_rows and self.audit is not None \
                        and bucket is not None:
                    # Pair each sampled input with its DELIVERED output
                    # (post any corrupt_device perturbation — the replay
                    # must judge what the client actually receives) and
                    # hand the pair to the off-thread golden worker,
                    # which re-runs it on the bucket's device.
                    for row, in_frame, sid, idx, lin in plan.audit_rows:
                        if row < plan.valid:
                            self.audit.submit_replay(
                                bucket.filter, in_frame,
                                np.array(out[row], copy=True),
                                session=sid, index=idx,
                                bucket=bucket.label(), lineage=lin,
                                out_uint8=bucket.engine.out_uint8,
                                device=bucket.engine.device)
                self.router.route(plan, out)
                if bucket is not None and bucket.draining_fetchers \
                        and bucket.inflight_batches == 0:
                    # The last pre-swap batch just routed (route copies
                    # rows out of the slab, so it is quiescent now):
                    # the old program's egress slabs can finally go.
                    bucket.release_drained_fetchers()
                # A materialized batch is proof of engine progress: the
                # consecutive-stall escalation counter starts over.
                self._stalls_since_progress = 0
        except BaseException as e:  # noqa: BLE001
            self._fail(e)

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        """Per-session stats plus the fleet aggregate p50/p99 export."""
        with self._lock:
            live = dict(self._sessions)
            retired = dict(self._retired)
            buckets = list(self._buckets)
        every = {**retired, **live}
        session_stats = {sid: s.stats() for sid, s in every.items()}
        return {
            "sessions": session_stats,
            "open_sessions": len(live),
            "retired_sessions": len(retired),
            # Standing work ahead of the device (queued frames) plus
            # batches in flight — the scrape endpoint's queue-depth
            # series and the fleet row's per-replica signal.
            "queue_depth": sum(len(s.ingress) + len(s.pending)
                               for s in live.values()),
            "inflight_batches": len(self._window),
            "draining": self._draining,
            "admission_rejections": self.admission_rejections,
            # Sum of the per-session counters (covers deadline sheds AND
            # hard-close discards) so the aggregate always reconciles
            # with the per-stream rows it sits beside; sessions evicted
            # from the retention bound leave the sum.
            "shed_total": sum(s["shed"] for s in session_stats.values()),
            "errors": self.errors,
            # Classified per-kind fault counters + last errors, budget
            # escalation levels, and supervised recoveries — the fleet
            # half of the fault model (per-tenant attribution is in each
            # session row's "faults").
            "faults": self.faults.summary(),
            "fault_budget": self._budget.summary(),
            "recoveries": self.recoveries,
            "continuity": self.continuity.summary(),
            # Hot-swap plane: committed stall-free substitutions (resize
            # / morph / recovery), contained aborts (old program kept
            # serving), and live chain morphs.
            "swaps": self.swaps,
            "swap_aborts": self.swap_aborts,
            "morphs": self.morphs,
            "engine_batches": sum(b.engine.stats.batches for b in buckets),
            "engine_frames": sum(b.engine.stats.frames for b in buckets),
            # Multi-signature plane: one row per live bucket (keyed by
            # canonical signature) + the compiled-program pool counters.
            "open_buckets": len(buckets),
            "buckets": {b.label(): b.stats_row() for b in buckets},
            "pool": self.pool.stats(),
            # Auto-plan plane: the Plan doc driving this frontend (None
            # = hand-set defaults) — provenance says cache/measured.
            **({"plan": self.applied_plan}
               if self.applied_plan is not None else {}),
            **self.router.stats(),
            "aggregate": LatencyStats.merged(
                [s.latency for s in every.values()]),
            **({"ingest": buckets[0].ingest_stats.summary()}
               if buckets[0].ingest_stats is not None else {}),
            **({"egress": buckets[0].egress_stats.summary()}
               if buckets[0].egress_stats is not None else {}),
            **({"supervisor": {
                    "stalls": self._supervisor.stalls,
                    "heartbeat_ages_s": self._supervisor.heartbeat_ages(),
                }} if self._supervisor is not None else {}),
            **({"chaos": self.config.chaos.summary()}
               if self.config.chaos is not None else {}),
            **({"trace": {"events": len(self.tracer),
                          "dropped_total": self.tracer.dropped}}
               if self.tracer.enabled else {}),
            **({"attribution": self.attribution.summary()}
               if self.attribution is not None else {}),
            **({"audit": self.audit.stats()}
               if self.audit is not None else {}),
            **({"ledger": self.ledger.summary(),
                "memory": self._memory_stats()}
               if self.ledger is not None else {}),
            **({"flight": self.flight.stats()}
               if self.flight is not None else {}),
            **({"broadcast": self.broadcast.stats()}
               if self.broadcast is not None else {}),
            **({"control": {
                    **self.control_plane.stats(),
                    "quality_rebinds": self.quality_rebinds,
                    "quality_rebinds_dropped": self.quality_rebinds_dropped,
                    "resize_compile_errors": self.resize_compile_errors,
                    "admission_tier_floor": self._admission_tier_floor,
                }} if self.control_plane is not None else {}),
        }


def _fetch_whole(result) -> np.ndarray:
    """A whole batch on the host without a fetcher (the bucket's engine
    had no output signature yet at dispatch): wait for the compute
    event, then copy."""
    wait_compute(result)
    return host_array(result.device.cpu())


class ZmqStreamBridge:
    """One reference-style client ↔ one frontend session, over the wire
    framing of ``transport.zmq_ingress`` (READY credits on a DEALER, raw
    results on a PUSH — behaviorally a very fast single worker).

    The remote app keeps its own frame index space; each frame's remote
    index rides through the session as the slot ``tag`` and is echoed
    back in the result message, so the app's reorder buffer works
    unmodified while the session uses its private index space internally.

    ``wire`` is ``"raw"`` (uint8 RGB frames of ``raw_shape``, default
    ``raw_size``²), ``"jpeg"`` or ``"delta"``; ``codec`` replaces the
    wire codec the bridge would build (for example a ``DeltaCodec`` over
    a ``RawCodec``: a delta wire without JPEG). The raw wire builds no
    codec. ``audit_wire`` wraps every payload in the audit envelope
    (incoming frames are verified and stripped, deliveries stamped after
    encode); a lineage-armed frontend gets each delivery's ``encode`` and
    ``send`` marks folded into its attribution plane.
    """

    def __init__(
        self,
        frontend: ServeFrontend,
        host: str = "localhost",
        distribute_port: int = 5555,
        collect_port: int = 5556,
        use_jpeg: bool = True,
        raw_size: int = 512,
        jpeg_quality: int = 90,
        codec_threads: int = 4,
        encode_depth: int = 2,
        poll_ms: int = 10,
        slo_ms: Optional[float] = None,
        wire: Optional[str] = None,
        delta_tile: int = 32,
        delta_keyframe_interval: int = 16,
        delta_threshold: int = 0,
        delta_degrade_after: int = 8,
        audit_wire: bool = False,
        heartbeat: Optional[HeartbeatConfig] = None,
        raw_shape: Optional[Tuple[int, int]] = None,
        codec: Any = None,
    ):
        import zmq

        from dvf_tpu_torch.transport.codec import WIRE_MODES, make_wire_codec
        from dvf_tpu_torch.transport.zmq_ingress import READY

        if wire is None:
            wire = "jpeg" if use_jpeg else "raw"
        if wire not in WIRE_MODES:
            raise ValueError(f"wire must be one of {WIRE_MODES}, "
                             f"got {wire!r}")
        self._zmq = zmq
        self._ready = READY
        self.frontend = frontend
        self.session_id = frontend.open_stream(slo_ms=slo_ms)
        self.wire = wire
        if codec is not None:
            self.codec = codec
        elif wire == "delta":
            # Temporal-delta wire, both directions of this bridge: one
            # DeltaCodec instance carries independent encoder (result
            # deliveries — a single SESSION's frames, so they are
            # sequential even though the engine batch under them is
            # cross-tenant) and decoder (incoming app frames) state.
            self.codec = make_wire_codec(
                "delta", quality=jpeg_quality, threads=codec_threads,
                tile=delta_tile,
                keyframe_interval=delta_keyframe_interval,
                delta_threshold=delta_threshold,
                on_gap="raise")
        elif wire == "jpeg":
            self.codec = make_wire_codec("jpeg", quality=jpeg_quality,
                                         threads=codec_threads)
        else:
            self.codec = None  # raw rows ride as zero-copy memoryviews
        # Bounded delta degradation (the bridge has no fault-budget
        # ladder of its own): this many contained wire errors flip the
        # encoder to full-frame keyframes — the peer decodes those
        # unchanged, at full-frame JPEG cost.
        self._delta_degrade_after = delta_degrade_after
        self._delta_errors = 0
        self.wire_degraded = False
        # Asynchronous codec plane (runtime/egress.py): deliveries polled
        # from the session are batch-encoded on the codec pool while the
        # loop keeps pumping credits/frames; completed batches drain in
        # order. Raw mode rides the same plane as zero-copy memoryviews.
        self.plane = AsyncCodecPlane(self.codec, jpeg=(wire != "raw"),
                                     depth=encode_depth)
        # Lineage extension past delivery (lineage-armed frontends): the
        # bridge marks encode/send on each delivery's FrameLineage and
        # folds the wire components back into the frontend's attribution
        # plane — "21% encode" in explain() comes from here.
        self._attr = frontend.attribution
        # Wire-integrity audit (obs.audit): incoming frames must pass
        # the digest envelope, outgoing deliveries are stamped
        # post-encode; counters fold into the frontend's audit plane
        # when one is armed. Strict ingress — audit-mode peers stamp.
        self._wire_in = None
        self._wire_out = None
        if audit_wire:
            self._wire_in = WireAudit("bridge_ingress")
            self._wire_out = WireAudit("bridge_egress",
                                       chaos=frontend.config.chaos)
            if frontend.audit is not None:
                frontend.audit.register_wire(self._wire_in)
                frontend.audit.register_wire(self._wire_out)
        self.use_jpeg = wire != "raw"
        self.raw_size = raw_size
        self.raw_shape = (tuple(raw_shape) if raw_shape is not None
                          else (raw_size, raw_size))
        self.poll_ms = poll_ms
        self.errors = 0
        # Continuity plane (resilience.continuity): when a
        # HeartbeatConfig is armed, silence on the DEALER beyond
        # timeout_s is declared a PARTITION — counted, classified into
        # the frontend's fault stats, ledgered, and answered with a
        # jittered-backoff socket reconnect instead of pumping credits
        # into a dead wire forever. None = legacy behavior (off).
        self.heartbeat = heartbeat.validate() if heartbeat else None
        self.continuity = ContinuityStats()
        self._reconnect = (ReconnectPolicy(self.heartbeat)
                           if self.heartbeat else None)
        self.send_retries = 0  # zmq.Again re-sends of an already-encoded
        #   delivery (the single-encode cache makes these free of
        #   re-encode cost; the counter proves the retry path is taken)
        self._dealer_endpoint = f"tcp://{host}:{distribute_port}"
        self.ctx = zmq.Context()
        self.dealer = self.ctx.socket(zmq.DEALER)
        self.dealer.connect(self._dealer_endpoint)
        self.push = self.ctx.socket(zmq.PUSH)
        self.push.setsockopt(zmq.SNDTIMEO, 1000)
        self.push.connect(f"tcp://{host}:{collect_port}")
        self._stop = threading.Event()

    def _repartition_dealer(self) -> float:
        """Declare the ingress link partitioned: count + classify +
        ledger the event, rebuild the DEALER socket (drops the stale
        identity and any queued credits), and return the jittered
        backoff delay the caller should wait before resuming the pump."""
        self.continuity.inc("partitions")
        err = TimeoutError(
            f"no traffic on {self._dealer_endpoint} for "
            f"{self.heartbeat.timeout_s:.1f}s")
        self.frontend.faults.record(FaultKind.PARTITION, err)
        if self.frontend.ledger is not None:
            self.frontend.ledger.record(
                ledger_mod.PARTITION, cause=ledger_mod.CAUSE_RECOVERY,
                peer=self._dealer_endpoint, plane="bridge",
                attempt=self._reconnect.attempt)
        self.dealer.close(0)
        self.dealer = self.ctx.socket(self._zmq.DEALER)
        self.dealer.connect(self._dealer_endpoint)
        return self._reconnect.next_delay()

    def stop(self) -> None:
        self._stop.set()

    def stats(self) -> dict:
        return {
            "errors": self.errors,
            "send_retries": self.send_retries,
            "wire_degraded": self.wire_degraded,
            "continuity": self.continuity.summary(),
        }

    def _delta_fault(self) -> None:
        """Count one contained delta-wire fault; past the bound, degrade
        the encoder to full-frame keyframes (stays decodable by the same
        peer — the wire is framed either way)."""
        if self.wire != "delta" or self.wire_degraded:
            return
        self._delta_errors += 1
        if self._delta_errors >= self._delta_degrade_after:
            self.codec.full_frames = True
            self.wire_degraded = True
            print("[ZmqStreamBridge] repeated delta wire faults: "
                  "degrading to full-frame JPEG (keyframe-only)",
                  file=sys.stderr, flush=True)

    def _decode(self, payload: bytes) -> np.ndarray:
        if self.use_jpeg:
            h, w = self.codec.probe(payload)
            out = np.empty((h, w, 3), np.uint8)
            self.codec.decode_batch([payload], out=out[None])
            return out
        return np.frombuffer(payload, np.uint8).reshape(*self.raw_shape, 3)

    def run(self, max_frames: Optional[int] = None) -> None:
        """Credit-pump loop: READY credits out, frames in, deliveries
        back. Same per-iteration containment as TpuZmqWorker.run."""
        import collections
        import os

        from dvf_tpu_torch.transport.zmq_ingress import parse_frame_reply, result_msg

        pid = str(os.getpid()).encode()
        credits = 0
        served = 0
        budget = self.frontend.config.queue_size
        last_rx = time.monotonic()  # liveness clock: any DEALER traffic
        partitioned = False         # a reconnect is pending confirmation
        # Encoded deliveries not yet on the wire: a send timeout (stalled
        # PULL peer) must re-try them next iteration, not discard frames
        # that survived every other drop-bound in the system. Entries are
        # (delivery, payload) — encoding happened on the codec plane, so
        # a retry never pays the encode twice.
        out_pending: "collections.deque" = collections.deque()
        while not self._stop.is_set():
            in_send = False  # containment scope: True only while the
            #   head out_pending delivery is being sent
            try:
                while credits < budget:
                    try:
                        self.dealer.send(self._ready, flags=self._zmq.NOBLOCK)
                    except self._zmq.Again:
                        break
                    credits += 1
                if self.dealer.poll(self.poll_ms):
                    parts = self.dealer.recv_multipart()
                    credits = max(0, credits - 1)
                    last_rx = time.monotonic()
                    if partitioned:
                        # Traffic after a partition = the reconnect took:
                        # count it and reset the backoff ladder.
                        partitioned = False
                        self._reconnect.reset()
                        self.continuity.inc("reconnects")
                    parsed = parse_frame_reply(parts)
                    if parsed is None:
                        self.errors += 1
                    else:
                        remote_idx, payload = parsed
                        if self._wire_in is not None:
                            # Verify + strip the audit envelope before
                            # decode: a flipped bit on the wire raises
                            # WireIntegrityError into this loop's
                            # containment (counted, frame dropped)
                            # instead of decoding corrupt pixels.
                            payload = self._wire_in.verify(payload)
                        self.frontend.submit(
                            self.session_id, self._decode(payload),
                            tag=(remote_idx, time.time()))
                else:
                    credits = max(0, credits - 1)  # credit decay, see
                    #   transport.zmq_ingress._run_loop
                    if (self.heartbeat is not None
                            and (time.monotonic() - last_rx)
                            > self.heartbeat.timeout_s):
                        delay = self._repartition_dealer()
                        partitioned = True
                        credits = 0  # the old socket's credits died with it
                        last_rx = time.monotonic() + delay  # next liveness
                        #   window opens after the backoff — a dead peer
                        #   repartitions once per (timeout + backoff), so
                        #   the backoff ladder, not the timeout, paces it
                        self._stop.wait(delay)
                # All pending deliveries go to the codec plane as ONE
                # batch encode (pool-parallel), overlapped with the next
                # iteration's decode/submit work; raw frames ride as
                # zero-copy memoryviews (zmq copies at send).
                fresh = self.frontend.poll(self.session_id)
                if fresh:
                    self.plane.submit([d.frame for d in fresh], fresh)
                for batch in self.plane.ready(
                        block=len(self.plane) > self.plane.depth):
                    enc_t = time.time()
                    for d, payload, err in batch:
                        if err is not None:
                            self.errors += 1  # one bad frame: dropped
                            self._delta_fault()
                            print(f"[ZmqStreamBridge] encode failed "
                                  f"(dropping frame): {err!r}",
                                  file=sys.stderr)
                            continue
                        if self._attr is not None \
                                and d.lineage is not None:
                            d.lineage.mark("encode", enc_t)
                        if self._wire_out is not None:
                            # Stamp ONCE per frame, at enqueue: a
                            # zmq.Again retry must re-send the same
                            # stamped bytes, not re-stamp (which would
                            # inflate the stamp counter and advance the
                            # corrupt_wire chaos event index per
                            # ATTEMPT instead of per frame).
                            payload = self._wire_out.stamp(payload)
                        out_pending.append((d, payload))
                while out_pending:
                    d, payload = out_pending[0]
                    in_send = True  # head delivery is now the one at risk
                    remote_idx, t0 = d.tag
                    try:
                        self.push.send_multipart(result_msg(
                            remote_idx, pid, t0, time.time(), payload))
                    except self._zmq.Again:
                        self.send_retries += 1  # same encoded payload is
                        #   re-sent next iteration — never re-encoded
                        break  # peer stalled: keep the tail, retry later
                    out_pending.popleft()
                    if self._attr is not None and d.lineage is not None:
                        d.lineage.mark("send")
                        self._attr.observe_wire(d.lineage)
                    served += 1
                    in_send = False
                if max_frames is not None and served >= max_frames:
                    break
            except Exception as e:  # noqa: BLE001 — per-iteration containment
                self.errors += 1
                from dvf_tpu_torch.transport.codec import DeltaWireError

                if isinstance(e, DeltaWireError):
                    self._delta_fault()
                if in_send and out_pending:
                    # The head delivery's OWN send raised (never zmq.Again
                    # — that breaks out above): drop that one frame so
                    # containment cannot spin on it forever. Errors from
                    # the ingest half of the iteration leave out_pending
                    # untouched — a queued good frame must not pay for a
                    # corrupt incoming payload.
                    out_pending.popleft()
                print(f"[ZmqStreamBridge] error (continuing): {e!r}",
                      file=sys.stderr)
        # Loop exit (stop() / max_frames): flush the codec plane and
        # attempt the tail sends — frames already consumed from the
        # session must not vanish because they were mid-encode when the
        # loop ended (the worker's exit drain, mirrored; codec.close in
        # close() would otherwise cancel the pending futures). Best
        # effort: a stalled peer's zmq.Again bounds each send at SNDTIMEO.
        try:
            for batch in self.plane.flush():
                for d, payload, err in batch:
                    if err is None:
                        if self._wire_out is not None:
                            payload = self._wire_out.stamp(payload)
                        out_pending.append((d, payload))
                    else:
                        self.errors += 1
            while out_pending:
                d, payload = out_pending.popleft()
                remote_idx, t0 = d.tag
                self.push.send_multipart(result_msg(
                    remote_idx, pid, t0, time.time(), payload))
                served += 1
        except Exception as e:  # noqa: BLE001 — teardown best-effort
            self.errors += 1
            print(f"[ZmqStreamBridge] exit drain failed (dropping tail): "
                  f"{e!r}", file=sys.stderr)

    def close(self) -> None:
        self._stop.set()
        try:
            self.frontend.close(self.session_id, drain=False)
        except KeyError:
            pass
        if self.codec is not None:
            self.codec.close()
        self.dealer.close(0)
        self.push.close(0)
        self.ctx.term()
