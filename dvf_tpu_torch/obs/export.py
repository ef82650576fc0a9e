"""Scrape endpoints + SLO flight recorder (port of ``dvf_tpu.obs.export``).

The push half of the telemetry plane: `obs.registry` holds the samples,
this module gets them out of the process.

:class:`MetricsExporter`
    A tiny stdlib HTTP server (no new dependencies) exposing

    - ``/metrics``     Prometheus text exposition (``?format=json`` for
      the same samples as a JSON document),
    - ``/healthz``     the owner's cheap health export (200 ``ok: true``
      / 503 otherwise),
    - ``/timeseries``  the bounded sliding window of load-control
      signals (`obs.registry.TimeSeriesRing`),
    - ``/ledger``      the reconfiguration ledger's event window,
    - ``/explain``     the latency-attribution decomposition (a
      lineage-armed frontend's ``explain``),
    - ``/audit``       the audit plane's document (verdict counters and
      the recent confirmed-corruption events).

    Port 0 binds an ephemeral port (tests); the bound port is exported
    as ``.port``.

:func:`samples_from_signals`
    The one adapter between the runtime's flat ``signals()`` dicts and
    registry samples: ``*_total`` keys become counters, everything else
    gauges, and ``fault_<kind>_total`` keys pivot into the labeled
    ``faults_total{kind=…}`` family. Names are conformance-checked by
    the registry at collect, so a renamed signal fails loudly.


:class:`FlightRecorder`
    The post-mortem black box: on a trigger — watchdog trip, error
    budget overflow, SLO burn-rate breach, a confirmed corruption — it
    writes one bounded dump directory: the merged Perfetto trace from
    every registered tracer snapshot, the owner's full ``stats()``, the
    telemetry ring window, the lineage / ledger / audit documents and a
    ``meta.json`` naming the trigger. Rate-limited and capped in count
    and bytes so a flapping trigger cannot fill a disk; optionally opens
    a short ``torch.profiler`` window (CPU and CUDA activity) so the
    dump carries device lanes too.

:func:`fleet_samples` / :func:`attach_fleet_provider`
    The fleet scrape: the fleet's merged aggregate and per-replica rows
    (``replica=…`` labels), registered behind a freshness cache so
    concurrent scrapers share one stats fan-out.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from dvf_tpu_torch.obs.registry import (
    COUNTER,
    GAUGE,
    MetricSample,
    MetricsRegistry,
    TimeSeriesRing,
    finite_or_none,
)
from dvf_tpu_torch.obs.trace import merge_tracer_snapshots

_FAULT_KEY_RE = re.compile(r"^fault_([a-z][a-z0-9_]*)_total$")


def jsonable(doc: Any) -> Any:
    """Strict-JSON form of an export: non-finite floats → None (the
    literal ``NaN`` json.dumps would otherwise emit is rejected by
    RFC-8259 parsers — JS, Go, most dashboards), unknown objects →
    ``repr``. Applied to every document this module serves or dumps."""
    if isinstance(doc, dict):
        return {str(k): jsonable(v) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [jsonable(v) for v in doc]
    if isinstance(doc, float):
        return finite_or_none(doc)
    if doc is None or isinstance(doc, (bool, int, str)):
        return doc
    return repr(doc)


def samples_from_signals(
    signals: Dict[str, Any],
    prefix: str = "",
    labels: Optional[Dict[str, str]] = None,
) -> List[MetricSample]:
    """Flat ``signals()`` dict → registry samples.

    ``*_total`` → counter, else gauge; ``fault_<kind>_total`` pivots to
    ``faults_total{kind=<kind>}`` so fault kinds are a label dimension,
    not a metric-name explosion. ``None`` values are skipped (an
    unavailable signal is a gap, not a zero)."""
    base = tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))
    out: List[MetricSample] = []
    for key, value in signals.items():
        if value is None:
            continue
        try:
            v = float(value)
        except (TypeError, ValueError):
            continue  # non-numeric signals don't scrape
        m = _FAULT_KEY_RE.match(key)
        if m:
            name = f"{prefix}_faults_total" if prefix else "faults_total"
            out.append(MetricSample(
                name, v, tuple(sorted(base + (("kind", m.group(1)),))),
                COUNTER))
            continue
        name = f"{prefix}_{key}" if prefix else key
        kind = COUNTER if key.endswith("_total") else GAUGE
        out.append(MetricSample(name, v, base, kind))
    return out


def attach_signal_provider(
    registry: MetricsRegistry,
    prefix: str,
    signals_fn: Callable[[], Dict[str, Any]],
    labels: Optional[Dict[str, str]] = None,
) -> None:
    """Register ``signals_fn`` as a scrape-time provider under
    ``prefix`` — the standard wiring for serve/pipeline/worker tiers."""
    registry.register_provider(
        lambda: samples_from_signals(signals_fn(), prefix, labels))


def fleet_samples(fleet) -> List[MetricSample]:
    """The fleet scrape: merged aggregate + per-replica rows, every
    per-replica series labeled ``replica=…``. Rides the existing
    ``stats()`` merge discipline (``LatencyStats.merge_snapshots`` /
    ``FaultStats.absorb_summary``) — per-replica data already crossed
    the ``ProcessReplica`` RPC inside ``fleet.stats()``."""
    st = fleet.stats()
    agg = st.get("aggregate") or {}
    rows = st.get("replicas") or {}
    # delivered_total comes from the replicas' monotone lifetime
    # counters (signals() — evicted-session floor included), NOT from
    # the windowed aggregate.count: the latter shrinks when a replica
    # evicts retired sessions, which a Prometheus counter must never do.
    # (A replica restart still resets its share — the idiomatic counter
    # reset rate() handles.)
    delivered = [row.get("delivered_total") for row in rows.values()]
    delivered = [d for d in delivered if d is not None]
    out = samples_from_signals({
        "p50_ms": agg.get("p50_ms"),
        "p90_ms": agg.get("p90_ms"),
        "p99_ms": agg.get("p99_ms"),
        "fps": agg.get("fps"),
        "delivered_total": sum(delivered) if delivered else None,
        "open_sessions": st.get("open_sessions"),
        "replica_losses_total": st.get("replica_losses"),
        "migrated_sessions_total": st.get("migrated_sessions"),
        "orphaned_sessions_total": st.get("orphaned_sessions"),
        "order_violations_total": st.get("order_violations"),
        "spillovers_total": st.get("spillovers"),
        "rejections_total": st.get("rejections"),
        "tier_rejections_total": st.get("tier_rejections"),
        "replica_restarts_total": st.get("replica_restarts"),
        # Elastic fleet: how many replicas are serving vs wanted vs
        # pre-warmed, and the scale actions applied so far — the
        # autoscaler's observable surface (dvf_fleet_replicas_live /
        # _desired / dvf_fleet_standby_warm gauges, dvf_fleet_scale_*
        # counters).
        "replicas_live": st.get("replicas_live"),
        "replicas_desired": st.get("replicas_desired"),
        "standby_warm": st.get("standby_warm"),
        "scale_out_total": st.get("scale_outs"),
        "scale_in_total": st.get("scale_ins"),
        "standby_adoptions_total": st.get("standby_adoptions"),
        # Audit plane: the cross-replica divergence detector's counters
        # (per-replica shadow-replay/wire counters live on each
        # replica's own scrape).
        "audit_divergence_checks_total": (st.get("audit") or {}).get(
            "checks_total"),
        "audit_divergences_total": (st.get("audit") or {}).get(
            "divergences_total"),
        "audit_quarantined_total": (st.get("audit") or {}).get(
            "quarantined_total"),
    }, prefix="fleet")
    if st.get("rejections_by_tier"):
        # One tier vocabulary across surfaces: the ring/signals names
        # use TIER_NAMES ("standard"), so the label must too.
        from dvf_tpu_torch.control.controllers import TIER_NAMES

        for tier, n in st["rejections_by_tier"].items():
            label = TIER_NAMES.get(tier, f"tier{tier}")
            out.append(MetricSample(
                "fleet_admission_refusals_total", float(n),
                (("tier", label),), COUNTER))
    faults = st.get("faults") or {}
    for kind, n in (faults.get("by_kind") or {}).items():
        out.append(MetricSample("fleet_faults_total", float(n),
                                (("kind", str(kind)),), COUNTER))
    for rid, kinds in (faults.get("by_replica") or {}).items():
        for kind, n in kinds.items():
            out.append(MetricSample(
                "fleet_replica_faults_total", float(n),
                (("kind", str(kind)), ("replica", str(rid))), COUNTER))
    for rid, row in rows.items():
        ragg = row.get("aggregate") or {}
        out.extend(samples_from_signals({
            "up": 1.0 if row.get("state") == "healthy" else 0.0,
            "sessions": row.get("sessions"),
            "restarts_total": row.get("restarts"),
            "delivered_total": row.get("delivered_total"),
            "engine_frames_total": row.get("engine_frames"),
            "engine_batches_total": row.get("engine_batches"),
            "errors_total": row.get("errors"),
            "recoveries_total": row.get("recoveries"),
            "queue_depth": row.get("queue_depth"),
            "p50_ms": ragg.get("p50_ms"),
            "p99_ms": ragg.get("p99_ms"),
            "fps": ragg.get("fps"),
        }, prefix="fleet_replica", labels={"replica": rid}))
    return out


def attach_fleet_provider(registry: MetricsRegistry, fleet,
                          min_interval_s: float = 1.0) -> None:
    """Register the fleet provider with a freshness cache: one
    ``fleet.stats()`` costs a stats RPC per replica (each briefly
    holding that replica's serial channel lock against its submit hot
    path) plus a full percentile merge — concurrent or tight-loop
    scrapers must coalesce onto one fan-out per ``min_interval_s``
    rather than multiplying it."""
    lock = threading.Lock()
    cache: Dict[str, Any] = {"t": float("-inf"), "samples": []}

    def provider() -> List[MetricSample]:
        with lock:  # one fan-out at a time; followers reuse its result
            now = time.monotonic()
            if now - cache["t"] >= min_interval_s:
                cache["samples"] = fleet_samples(fleet)
                cache["t"] = now
            return cache["samples"]

    registry.register_provider(provider)


# ---------------------------------------------------------------------------
# HTTP exporter
# ---------------------------------------------------------------------------


class MetricsExporter:
    """Pull-based scrape endpoint over one registry (module docstring).

    ``health_fn()`` should be the owner's cheap liveness export (e.g.
    ``ServeFrontend.health`` — no percentile work); ``ring`` the owner's
    :class:`~dvf_tpu_torch.obs.registry.TimeSeriesRing` (``/timeseries``
    404s without one)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        host: str = "127.0.0.1",
        health_fn: Optional[Callable[[], dict]] = None,
        ring: Optional[TimeSeriesRing] = None,
        explain_fn: Optional[Callable[[], dict]] = None,
        ledger_fn: Optional[Callable[[], dict]] = None,
        audit_fn: Optional[Callable[[], dict]] = None,
    ):
        self.registry = registry
        self.health_fn = health_fn
        self.ring = ring
        self.explain_fn = explain_fn  # latency-attribution explain
        #   surface (``ServeFrontend.explain``); ``/explain`` 404s
        #   without one
        self.ledger_fn = ledger_fn  # reconfiguration-ledger document
        #   (``ReconfigLedger.document`` on a serve/fleet owner):
        #   ``/ledger`` serves the bounded event window; 404s without one
        self.audit_fn = audit_fn  # audit-plane document (obs.audit —
        #   ``AuditPlane.document`` / a worker's wire counters):
        #   ``/audit`` serves verdict counters + the recent
        #   confirmed-corruption events; 404s without one
        self.requests = 0
        self.request_errors = 0
        self._stat_lock = threading.Lock()  # handler threads are
        #   concurrent (ThreadingHTTPServer); unlocked += would let the
        #   request diagnostics undercount themselves
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
                pass  # scrape traffic must not spam stderr

            def do_GET(self):  # noqa: N802 — stdlib name
                with exporter._stat_lock:
                    exporter.requests += 1
                try:
                    exporter._route(self)
                except BrokenPipeError:
                    pass  # scraper hung up mid-reply
                except Exception as e:  # noqa: BLE001 — one bad scrape
                    with exporter._stat_lock:  # must not kill the server
                        exporter.request_errors += 1
                    try:
                        self.send_error(500, explain=repr(e))
                    except Exception:  # noqa: BLE001
                        pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- routing ---------------------------------------------------------

    def _route(self, req: BaseHTTPRequestHandler) -> None:
        from urllib.parse import parse_qs

        path, _, query = req.path.partition("?")
        if path == "/metrics":
            if parse_qs(query).get("format") == ["json"]:
                self._reply(req, 200, "application/json",
                            json.dumps(self.registry.to_json(),
                                       default=repr))
            else:
                self._reply(req, 200,
                            "text/plain; version=0.0.4; charset=utf-8",
                            self.registry.to_prometheus())
        elif path == "/healthz":
            health = {"ok": True}
            if self.health_fn is not None:
                health = self.health_fn()
            code = 200 if health.get("ok", False) else 503
            self._reply(req, code, "application/json",
                        json.dumps(jsonable(health)))
        elif path == "/timeseries":
            if self.ring is None:
                req.send_error(404, explain="no telemetry ring attached")
                return
            since = None
            raw = parse_qs(query).get("since")
            if raw:
                try:
                    since = float(raw[0])
                except ValueError:
                    req.send_error(400, explain=f"bad since={raw[0]!r} "
                                                f"(wall-clock seconds)")
                    return
            self._reply(req, 200, "application/json",
                        json.dumps(jsonable(self.ring.series(
                            since=since))))
        elif path == "/explain":
            if self.explain_fn is None:
                req.send_error(404, explain="no explain surface attached "
                                            "(lineage-armed serve tiers "
                                            "expose one)")
                return
            self._reply(req, 200, "application/json",
                        json.dumps(jsonable(self.explain_fn())))
        elif path == "/ledger":
            if self.ledger_fn is None:
                req.send_error(404, explain="no reconfiguration ledger "
                                            "attached (serve/fleet tiers "
                                            "expose one)")
                return
            self._reply(req, 200, "application/json",
                        json.dumps(jsonable(self.ledger_fn())))
        elif path == "/audit":
            if self.audit_fn is None:
                req.send_error(404, explain="no audit plane attached "
                                            "(arm audit / audit_wire)")
                return
            self._reply(req, 200, "application/json",
                        json.dumps(jsonable(self.audit_fn())))
        else:
            req.send_error(404)

    @staticmethod
    def _reply(req: BaseHTTPRequestHandler, code: int, ctype: str,
               body: str) -> None:
        payload = body.encode()
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)

    # -- lifecycle -------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsExporter":
        if self._thread is not None:
            raise RuntimeError("exporter already started")
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="dvf-metrics-http", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Device profiler (torch.profiler; the reference's jax.profiler windows)
# ---------------------------------------------------------------------------

# The file a device-trace window exports (a Kineto Chrome trace, plain
# JSON); obs.trace.merge_with_device_trace reads it.
DEVICE_TRACE_FILE = "trace.json"


def start_device_profiler():
    """Start one ``torch.profiler`` session: CPU activity, plus CUDA
    activity where a card is present. Shapes, stacks and memory stay
    off (each adds host work per launch). The caller stops it and
    exports its Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        # CPU ops of every thread (dispatch, collect, the audit worker),
        # not only of the one that starts the session, where the torch
        # build knows the option.
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False, **kw)
    prof.start()
    return prof


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


def _dir_bytes(path: str) -> int:
    """Recursive on-disk size of one dump directory (best-effort: a
    file racing deletion counts 0, never raises)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


def _slug(reason: str, limit: int = 48) -> str:
    s = re.sub(r"[^a-z0-9]+", "-", reason.lower()).strip("-")
    return (s[:limit].rstrip("-")) or "trip"


class FlightRecorder:
    """Bounded post-mortem dumper (module docstring).

    ``trace_fn()`` returns a list of :meth:`Tracer.snapshot` dicts (one
    per lane source — the always-on bounded rings the tracers already
    keep); ``stats_fn()`` the owner's full stats export; ``ring`` the
    telemetry window. All three are optional and best-effort: a dump
    writes whatever it can reach — a post-mortem with a missing artifact
    beats no post-mortem, and a dump must never take down the serving
    path that triggered it.
    """

    # One profiler session may exist per process (Kineto's as much as
    # jax.profiler's); a second trigger during a capture window skips
    # its own.
    _profiling = threading.Lock()

    def __init__(
        self,
        out_dir: str,
        label: str = "dvf",
        min_interval_s: float = 10.0,
        max_dumps: int = 16,
        trace_fn: Optional[Callable[[], List[dict]]] = None,
        stats_fn: Optional[Callable[[], dict]] = None,
        ring: Optional[TimeSeriesRing] = None,
        profile_s: float = 0.0,
        max_total_bytes: Optional[int] = None,
        lineage_fn: Optional[Callable[[], dict]] = None,
        ledger_fn: Optional[Callable[[], dict]] = None,
        audit_fn: Optional[Callable[[], dict]] = None,
    ):
        self.out_dir = out_dir
        self.label = label
        self.min_interval_s = min_interval_s
        self.max_dumps = max_dumps
        # Disk bound, not just a count bound: one dump's size scales
        # with the trace/stats/timeseries rings feeding it, so a count
        # cap alone can still eat a disk on a long-lived server whose
        # triggers keep firing. Past the cap the OLDEST dumps are
        # evicted (their count slots free up with them) — the newest
        # post-mortem always survives.
        self.max_total_bytes = max_total_bytes
        self.trace_fn = trace_fn
        self.stats_fn = stats_fn
        self.ring = ring
        self.lineage_fn = lineage_fn  # AttributionPlane.snapshot on a
        #   lineage-armed owner: the dump then carries ``lineage.json``
        #   — aggregates, the explain decomposition, and the FULL
        #   lineages of the SLO-breaching / slowest exemplar frames, so
        #   an SLO-burn post-mortem names the guilty stage instead of
        #   shrugging
        self.ledger_fn = ledger_fn  # ReconfigLedger.document on a
        #   ledger-armed owner: the dump then carries ``ledger.json`` —
        #   every compile/resize/rebuild/quality/scale event with its
        #   cause, wall cost, and measured bucket stall, so "what
        #   reconfigured right before the trip" is in the artifact
        self.audit_fn = audit_fn  # AuditPlane.document on an audit-
        #   armed owner: the dump then carries ``audit.json`` — verdict
        #   counters plus the confirmed-corruption events with their
        #   lineage/ledger context, so a corruption post-mortem names
        #   the frame, the hop, and what reconfigured before it
        self.profile_s = profile_s
        self.dumps: List[str] = []
        self.suppressed = 0
        self.dump_errors = 0
        self.evicted_dumps = 0
        self.last_reason: Optional[str] = None
        self._dump_bytes: dict = {}   # dump dir -> measured bytes
        self._last_ts: float = float("-inf")
        self._seq = 0
        self._lock = threading.Lock()

    def trigger_async(self, reason: str) -> None:
        """One dump on a short-lived daemon thread — for callers on
        supervision-critical paths (watchdog trips, loss handling, the
        monitor loop), where serializing a trace window to disk must not
        extend the incident it records. The rate limit inside
        :meth:`trigger` claims the slot, so a trigger storm spawns
        bounded no-op threads, not dumps."""
        threading.Thread(target=self.trigger, args=(reason,),
                         name="dvf-flight-dump", daemon=True).start()

    def trigger(self, reason: str) -> Optional[str]:
        """Attempt one dump; returns its directory, or None when
        rate-limited / capped / nothing could be written. Runs inline in
        the triggering thread (watchdog, monitor, sampler) — the write
        is a few JSON files, bounded by the rings feeding it."""
        with self._lock:
            now = time.monotonic()
            if (now - self._last_ts < self.min_interval_s
                    or len(self.dumps) >= self.max_dumps):
                self.suppressed += 1
                return None
            self._last_ts = now
            self._seq += 1
            seq = self._seq
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        dump_dir = os.path.join(
            self.out_dir,
            f"{self.label}-{seq:03d}-{stamp}-{_slug(reason)}")
        try:
            os.makedirs(dump_dir, exist_ok=True)
        except OSError:
            with self._lock:
                self.dump_errors += 1
                # Give the slot back: nothing was written, so the NEXT
                # trigger (disk recovered, ENOSPC cleared) must not be
                # rate-limited into producing no post-mortem at all.
                self._last_ts = float("-inf")
                self._seq -= 1
            return None
        self.last_reason = reason
        wrote = self._write_artifacts(dump_dir, reason)
        import sys

        if not wrote:
            # Every artifact write failed (ENOSPC after makedirs
            # succeeded): an empty directory is not a dump — give the
            # rate-limit AND max_dumps slots back, like the makedirs
            # failure path, so the recorder revives when the disk does.
            with self._lock:
                self._last_ts = float("-inf")
                self._seq -= 1
            print(f"[flight] {reason!r}: dump failed entirely "
                  f"(nothing written under {dump_dir})",
                  file=sys.stderr, flush=True)
            return None
        with self._lock:
            self.dumps.append(dump_dir)
            self._dump_bytes[dump_dir] = _dir_bytes(dump_dir)
        self._enforce_byte_cap()
        if self.profile_s > 0:
            self._profile_window(dump_dir)
        print(f"[flight] {reason!r} → {dump_dir} ({', '.join(wrote)})",
              file=sys.stderr, flush=True)
        return dump_dir

    def _enforce_byte_cap(self) -> None:
        """Evict oldest dumps while the directory's total measured size
        exceeds ``max_total_bytes`` (the newest dump always survives —
        a cap smaller than one dump degrades to keep-latest-only)."""
        if self.max_total_bytes is None:
            return
        while True:
            with self._lock:
                total = sum(self._dump_bytes.get(d, 0) for d in self.dumps)
                if total <= self.max_total_bytes or len(self.dumps) <= 1:
                    return
                victim = self.dumps.pop(0)
                self._dump_bytes.pop(victim, None)
                self.evicted_dumps += 1
            import shutil

            try:
                shutil.rmtree(victim)
            except OSError:
                pass  # eviction is best-effort; the tracking entry is
                #   gone either way, so the cap converges

    def _write_artifacts(self, dump_dir: str, reason: str) -> List[str]:
        wrote: List[str] = []

        def best_effort(name: str, fn) -> None:
            try:
                fn()
                wrote.append(name)
            except Exception:  # noqa: BLE001 — partial dumps are fine
                with self._lock:
                    self.dump_errors += 1

        best_effort("meta", lambda: self._json(
            dump_dir, "meta.json",
            {"reason": reason, "label": self.label,
             "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
             "ts": time.time(), "pid": os.getpid()}))
        if self.trace_fn is not None:
            def _trace():
                snaps = self.trace_fn()
                if not merge_tracer_snapshots(
                        snaps, os.path.join(dump_dir, "trace.pftrace")):
                    raise ValueError("no trace events to dump")
            best_effort("trace", _trace)
        if self.stats_fn is not None:
            best_effort("stats", lambda: self._json(
                dump_dir, "stats.json", self.stats_fn()))
        if self.ring is not None:
            best_effort("timeseries", lambda: self._json(
                dump_dir, "timeseries.json", self.ring.series()))
        if self.lineage_fn is not None:
            best_effort("lineage", lambda: self._json(
                dump_dir, "lineage.json", self.lineage_fn()))
        if self.ledger_fn is not None:
            best_effort("ledger", lambda: self._json(
                dump_dir, "ledger.json", self.ledger_fn()))
        if self.audit_fn is not None:
            best_effort("audit", lambda: self._json(
                dump_dir, "audit.json", self.audit_fn()))
        return wrote

    @staticmethod
    def _json(dump_dir: str, name: str, doc: Any) -> None:
        with open(os.path.join(dump_dir, name), "w") as f:
            json.dump(jsonable(doc), f)

    def _profile_window(self, dump_dir: str) -> None:
        """On-demand device capture: a short ``torch.profiler`` window
        (CPU and, where a card is present, CUDA activity; no shapes,
        stacks or memory — the window must not disturb the run it
        records) exported as ``device_trace/trace.json`` in the dump, on
        a daemon thread. At most one window per process at a time — a
        trigger landing inside an open window skips, it does not
        queue."""
        if not FlightRecorder._profiling.acquire(blocking=False):
            return

        def capture():
            try:
                trace_dir = os.path.join(dump_dir, "device_trace")
                os.makedirs(trace_dir, exist_ok=True)
                prof = start_device_profiler()
                try:
                    time.sleep(self.profile_s)
                finally:
                    prof.stop()
                prof.export_chrome_trace(
                    os.path.join(trace_dir, DEVICE_TRACE_FILE))
            except Exception:  # noqa: BLE001 — device capture is garnish
                with self._lock:
                    self.dump_errors += 1
            finally:
                FlightRecorder._profiling.release()
            # The device trace landed AFTER the dump was measured for
            # the byte cap — remeasure and re-enforce, unless the dump
            # was evicted while the capture window was open.
            with self._lock:
                tracked = dump_dir in self._dump_bytes
            if tracked:
                size = _dir_bytes(dump_dir)
                with self._lock:
                    if dump_dir in self._dump_bytes:
                        self._dump_bytes[dump_dir] = size
                self._enforce_byte_cap()

        threading.Thread(target=capture, name="dvf-flight-profile",
                         daemon=True).start()

    def stats(self) -> dict:
        with self._lock:
            return {
                "dumps": len(self.dumps),
                "suppressed": self.suppressed,
                "dump_errors": self.dump_errors,
                "evicted_dumps": self.evicted_dumps,
                "total_bytes": sum(self._dump_bytes.get(d, 0)
                                   for d in self.dumps),
                "last_reason": self.last_reason,
                "dir": self.out_dir,
            }
