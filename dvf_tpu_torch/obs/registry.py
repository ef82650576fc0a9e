"""Metrics registry + sliding-window telemetry ring (port of
``dvf_tpu.obs.registry``; host code only).

Every subsystem keeps its observability as an ad-hoc nested ``stats()``
dict with its own naming, point-in-time snapshots that nothing exports
continuously; the auto-plan and load-adaptive control (``control``)
need a signal substrate to read. This module is that substrate:

:class:`MetricsRegistry`
    Counters, gauges, and bounded histograms with label sets, plus
    *providers* — callables that adapt an existing ``stats()`` surface
    into metric samples at scrape time (pull model: the runtime keeps
    its counters exactly where they are; the registry reads them when an
    exporter asks). ``collect()`` is the one flat view the Prometheus /
    JSON endpoints (`obs.export`) render.

:class:`TimeSeriesRing`
    A sampling thread that keeps a bounded sliding window of the
    load-control signals (fps, p50/p99, queue depth, SLO headroom,
    overlap efficiencies, per-kind fault rates) — exactly the inputs a
    closed-loop controller needs, and the ``/timeseries`` endpoint's
    backing store. An ``on_sample`` hook sees each (prev, cur) pair, the
    seam the SLO burn-rate trigger (`obs.export.FlightRecorder`) hangs
    off.

Metric-name conformance lives here too (:func:`check_metric_name`,
:func:`walk_export`): one rule set shared by the exporter (which refuses
to emit a non-conformant name instead of silently renaming it) and the
tier-1 schema test (which walks every ``stats()`` export and bench JSON
writer), so a renamed key breaks the build instead of silently vanishing
from the scrape endpoint.
"""

from __future__ import annotations

import bisect
import collections
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

# ---------------------------------------------------------------------------
# Metric-name conformance (shared: exporter + tier-1 schema test)
# ---------------------------------------------------------------------------

# snake_case identifiers only: what both the Prometheus exposition and
# the bench JSON consumers key on.
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# Recognized unit tokens. A unit token may appear mid-name only when
# (a) a ``per`` follows later — rate names: ``ms_per_frame``,
# ``bytes_accessed_per_frame`` — or (b) the name still ends in a proper
# unit suffix, so the mid-name token is descriptive, not the unit
# (``total_ms`` is a duration; its unit IS ``_ms``). Anything else —
# ``latency_ms_avg``, ``total_frames_produced``, ``msPerFrame`` — is a
# rename hazard the exporter would otherwise silently mis-render, so it
# fails conformance.
UNIT_TOKENS = frozenset({
    "ms", "s", "us", "fps", "mbps", "gbps", "bytes", "mb", "db", "pct",
    "ratio", "total", "frac",
})


def check_metric_name(name: str) -> Optional[str]:
    """None when ``name`` is registry-conformant, else the violation."""
    if not isinstance(name, str):
        return f"non-string key {name!r}"
    if not METRIC_NAME_RE.match(name):
        return (f"{name!r} is not snake_case "
                f"(^[a-z][a-z0-9_]*$)")
    tokens = name.split("_")
    if tokens[-1] in UNIT_TOKENS:
        return None  # properly unit-suffixed (rule b covers the middle)
    for i, tok in enumerate(tokens[:-1]):
        if tok in UNIT_TOKENS and "per" not in tokens[i + 1:]:
            return (f"{name!r} buries unit token {tok!r} mid-name "
                    f"(units go last: ..._{tok}; rates: "
                    f"{tok}[_...]_per_...)")
    return None


# Export sub-dicts whose KEYS are data, not metric names (session ids,
# replica ids, fault kinds, thread names, chaos sites): the walker checks
# their values but not the keys themselves.
DYNAMIC_KEY_PARENTS = frozenset({
    "sessions", "by_kind", "by_replica", "last", "replicas", "recoveries",
    "faults", "heartbeat_ages_s", "chaos", "rules", "fired", "polled",
    "rates", "series", "configs", "rounds", "trials", "buckets",
    "warm_replicas", "by_signature", "by_bucket", "by_session",
    "rejections_by_tier", "standby", "phases", "by_cause",
    "digests",  # audit divergence events: digest-hex → replica ids
    # Broadcast plane: channel names, tier labels ("640x360/q60/delta"),
    # subscriber ids, and relay ids are all data-shaped keys.
    "channels", "tiers", "subscribers", "relays", "pumps",
})


def walk_export(export: Any, path: str = "",
                dynamic: bool = False) -> List[Tuple[str, str]]:
    """Walk one ``stats()``/bench-JSON export; returns
    ``[(key_path, violation), ...]`` for every non-conformant key.

    ``dynamic`` marks a level whose keys are data (see
    :data:`DYNAMIC_KEY_PARENTS`) — those keys are skipped but their
    values still recurse, so a dynamic map of sub-exports (per-session
    stats rows) is still fully checked.
    """
    bad: List[Tuple[str, str]] = []
    if isinstance(export, dict):
        for k, v in export.items():
            where = f"{path}.{k}" if path else str(k)
            if not dynamic:
                why = check_metric_name(k)
                if why is not None:
                    bad.append((where, why))
            bad.extend(walk_export(
                v, where,
                dynamic=(not dynamic and k in DYNAMIC_KEY_PARENTS)))
    elif isinstance(export, (list, tuple)):
        for i, v in enumerate(export):
            bad.extend(walk_export(v, f"{path}[{i}]"))
    return bad


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"


class MetricSample(NamedTuple):
    """One scraped value: what the exposition formats render."""

    name: str
    value: float
    labels: Tuple[Tuple[str, str], ...]  # sorted, hashable
    kind: str                            # counter | gauge | histogram


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic per-labelset counter (``..._total`` names)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}

    def inc(self, n: float = 1, labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        """Absolute set — for mirroring an externally-maintained
        monotonic count (e.g. a ``FaultStats`` table) into the registry."""
        with self._lock:
            self._values[_label_key(labels)] = value

    def samples(self) -> List[MetricSample]:
        with self._lock:
            return [MetricSample(self.name, v, k, COUNTER)
                    for k, v in self._values.items()]


class Gauge:
    """Last-write-wins per-labelset value; a labelset may instead carry a
    zero-arg callable evaluated at collect time."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: Dict[Tuple, Any] = {}

    def set(self, value, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def set_fn(self, fn: Callable[[], float],
               labels: Optional[Dict[str, str]] = None) -> None:
        self.set(fn, labels=labels)

    def samples(self) -> List[MetricSample]:
        with self._lock:
            items = list(self._values.items())
        out = []
        for k, v in items:
            try:
                if callable(v):
                    v = v()
                if v is None:
                    continue
                v = float(v)
            except Exception:  # noqa: BLE001 — a broken callback OR a
                continue       # non-numeric value drops its sample,
                #                never the scrape
            out.append(MetricSample(self.name, v, k, GAUGE))
        return out


class Histogram:
    """Fixed-bound bucketed distribution (cumulative counts + sum), the
    Prometheus histogram shape. Bounded by construction: ``observe`` is
    O(log buckets) and storage is the bucket array — safe on hot paths."""

    def __init__(self, name: str, buckets: Iterable[float]):
        self.name = name
        self.bounds = sorted(float(b) for b in buckets)
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        # per labelset: ([count per bound] + [+Inf overflow], sum, count)
        self._values: Dict[Tuple, list] = {}

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = [[0] * (len(self.bounds) + 1),
                                           0.0, 0]
            row[0][i] += 1
            row[1] += value
            row[2] += 1

    def samples(self) -> List[MetricSample]:
        out: List[MetricSample] = []
        with self._lock:
            items = [(k, list(r[0]), r[1], r[2])
                     for k, r in self._values.items()]
        for key, counts, total, count in items:
            cum = 0
            for bound, c in zip(self.bounds, counts):
                cum += c
                out.append(MetricSample(
                    f"{self.name}_bucket", cum,
                    key + (("le", f"{bound:g}"),), HISTOGRAM))
            cum += counts[-1]
            out.append(MetricSample(f"{self.name}_bucket", cum,
                                    key + (("le", "+Inf"),), HISTOGRAM))
            out.append(MetricSample(f"{self.name}_sum", total, key,
                                    HISTOGRAM))
            out.append(MetricSample(f"{self.name}_count", count, key,
                                    HISTOGRAM))
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class MetricsRegistry:
    """Instrument + provider registry, the scrape endpoints' one source.

    Names are checked at registration (:func:`check_metric_name`) and
    again per provider sample at collect — a provider that starts
    emitting a renamed key loses that sample loudly (counted in
    ``provider_errors``) instead of silently renaming a series.
    """

    def __init__(self, prefix: str = "dvf"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}
        self._providers: List[Callable[[], Iterable[MetricSample]]] = []
        self.provider_errors = 0
        self.dropped_samples = 0  # non-conformant provider sample names

    def _check(self, name: str) -> str:
        why = check_metric_name(name)
        if why is not None:
            raise ValueError(f"metric name not registry-conformant: {why}")
        return name

    def _get(self, name: str, kind, factory):
        self._check(name)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, buckets: Iterable[float]) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, buckets))

    def register_provider(
            self, fn: Callable[[], Iterable[MetricSample]]) -> None:
        """Register a scrape-time sample source (typically an adapter
        over an existing ``stats()`` surface — see `obs.export`)."""
        with self._lock:
            self._providers.append(fn)

    def collect(self) -> List[MetricSample]:
        with self._lock:
            instruments = list(self._instruments.values())
            providers = list(self._providers)
        out: List[MetricSample] = []
        for inst in instruments:
            out.extend(inst.samples())
        for fn in providers:
            try:
                samples = list(fn())
            except Exception:  # noqa: BLE001 — one broken provider must
                with self._lock:           # not take down the scrape
                    self.provider_errors += 1
                continue
            for s in samples:
                # `name_total_bucket{le=}` style suffixes come only from
                # instruments; provider names are checked whole.
                if check_metric_name(s.name) is not None:
                    with self._lock:  # concurrent scrapes: the loud-
                        # drop diagnostics must not undercount themselves
                        self.dropped_samples += 1
                    continue
                out.append(s)
        return out

    # -- exposition ------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        by_name: "collections.OrderedDict[str, list]" = collections.OrderedDict()
        kinds: Dict[str, str] = {}
        for s in self.collect():
            full = f"{self.prefix}_{s.name}" if self.prefix else s.name
            by_name.setdefault(full, []).append(s)
            # histogram sub-series share the family TYPE line
            fam = re.sub(r"_(bucket|sum|count)$", "", full) \
                if s.kind == HISTOGRAM else full
            kinds.setdefault(fam, s.kind)
        lines: List[str] = []
        typed: set = set()
        for full, samples in by_name.items():
            fam = re.sub(r"_(bucket|sum|count)$", "", full) \
                if samples[0].kind == HISTOGRAM else full
            if fam not in typed:
                typed.add(fam)
                lines.append(f"# TYPE {fam} {kinds[fam]}")
            for s in samples:
                if s.labels:
                    body = ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in s.labels)
                    lines.append(f"{full}{{{body}}} {_format_value(s.value)}")
                else:
                    lines.append(f"{full} {_format_value(s.value)}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """The same samples as a JSON document (``/metrics?format=json``)."""
        return {
            "prefix": self.prefix,
            "samples": [
                {"name": s.name, "value": _json_value(s.value),
                 "labels": dict(s.labels), "kind": s.kind}
                for s in self.collect()
            ],
        }


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _format_value(v: float) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def finite_or_none(v) -> Optional[float]:
    """THE non-finite rule, stated once: NaN/±Inf → None (a gap). Shared
    by the JSON exposition, the telemetry ring, and the flight dumps so
    the strict-JSON surfaces can never diverge on it. (The Prometheus
    TEXT format is the one deliberate exception — it has first-class
    NaN/+Inf literals, rendered by ``_format_value``.)"""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return None if (f != f or f in (float("inf"), float("-inf"))) else f


def _json_value(v: float):
    return finite_or_none(v)


# ---------------------------------------------------------------------------
# TimeSeriesRing
# ---------------------------------------------------------------------------


class TimeSeriesRing:
    """Bounded sliding window of periodic telemetry samples.

    ``sample_fn()`` returns one flat ``{signal: float}`` dict; the ring
    thread calls it every ``interval_s`` and keeps the last ``capacity``
    rows — at the 1 s / 600-row defaults, a ten-minute window, a few
    hundred KB regardless of uptime. ``on_sample(prev, cur)`` (optional)
    runs after each append — the burn-rate/controller seam; its
    exceptions are counted, never propagated (a broken trigger must not
    kill the sampler).

    Rows are wall-clock stamped (``t``) so windows from different
    processes line up in a merged view, mirroring the tracer's epoch
    discipline.
    """

    def __init__(
        self,
        sample_fn: Callable[[], Dict[str, float]],
        interval_s: float = 1.0,
        capacity: int = 600,
        name: str = "dvf-telemetry",
        on_sample: Optional[Callable[[Optional[dict], dict], None]] = None,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.sample_fn = sample_fn
        self.interval_s = interval_s
        self.capacity = capacity
        self.name = name
        self.on_sample = on_sample
        self.sample_errors = 0
        self.hook_errors = 0
        self._rows: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "TimeSeriesRing":
        if self._thread is not None:
            raise RuntimeError("ring already started")
        self._thread = threading.Thread(target=self._loop, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- sampling --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def sample_once(self) -> Optional[dict]:
        """One sampling tick (also callable directly — tests, and a
        final sample at shutdown so short runs still leave a window)."""
        try:
            values = self.sample_fn()
        except Exception:  # noqa: BLE001 — a failed sample is a gap,
            self.sample_errors += 1  # not a dead sampler
            return None
        row = {"t": time.time()}
        # None AND non-finite floats are gaps (finite_or_none): NaN
        # percentiles from an empty window would otherwise reach
        # json.dumps, which emits the RFC-8259-invalid literal `NaN`
        # that strict parsers reject.
        row.update({k: v for k, v in values.items()
                    if v is not None
                    and (not isinstance(v, float)
                         or finite_or_none(v) is not None)})
        with self._lock:
            prev = self._rows[-1] if self._rows else None
            if prev is not None and row["t"] <= prev["t"]:
                # Row stamps are the ?since= cursor, whose semantics
                # are strictly-after: two rows sharing one wall-clock
                # value (coarse clock, back-to-back sample_once) would
                # make the later one invisible to an incremental
                # scraper forever. Keep ``t`` a strict total order.
                import math

                row["t"] = math.nextafter(prev["t"], math.inf)
            self._rows.append(row)
        if self.on_sample is not None:
            try:
                self.on_sample(prev, row)
            except Exception:  # noqa: BLE001
                self.hook_errors += 1
        return row

    # -- export ----------------------------------------------------------

    def latest(self) -> Optional[dict]:
        with self._lock:
            return dict(self._rows[-1]) if self._rows else None

    def series(self, since: Optional[float] = None) -> dict:
        """The ``/timeseries`` document: row-oriented, bounded.

        ``since`` is the incremental-scrape cursor (``?since=<ts>`` on
        the endpoint): only rows with ``t`` STRICTLY greater than it are
        returned, so an external scraper polls the delta instead of
        re-pulling the full window each time. ``cursor`` in the reply is
        the newest retained row's wall-clock ``t`` — pass it back as the
        next ``since``. Semantics pinned in tests/test_obs.py: the
        cursor reflects the full window even when the filtered ``rows``
        are empty (no new data ⇒ same cursor back), and a ``since``
        older than the window's tail simply returns the whole bounded
        window (rows already evicted are gone — the ring is a sliding
        window, not a log)."""
        with self._lock:
            rows = [dict(r) for r in self._rows]
        cursor = rows[-1]["t"] if rows else None
        if since is not None:
            rows = [r for r in rows if r["t"] > since]
        return {
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "sample_errors": self.sample_errors,
            # Contained on_sample failures: a raising hook (burn check,
            # control plane) is counted here and sampling CONTINUES —
            # pinned in tests/test_obs.py (a dead sampler would blind
            # every controller and the flight recorder at once).
            "hook_errors_total": self.hook_errors,
            "cursor": cursor,
            "rows": rows,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)
