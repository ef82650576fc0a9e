"""Scrape endpoint (port of the ``jsonable``, ``samples_from_signals``,
``attach_signal_provider`` and ``MetricsExporter`` parts of
``dvf_tpu.obs.export``; host code only).

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
    - ``/ledger``      the reconfiguration ledger's event window.

    Port 0 binds an ephemeral port (tests); the bound port is exported
    as ``.port``.

:func:`samples_from_signals`
    The one adapter between the runtime's flat ``signals()`` dicts and
    registry samples: ``*_total`` keys become counters, everything else
    gauges, and ``fault_<kind>_total`` keys pivot into the labeled
    ``faults_total{kind=…}`` family. Names are conformance-checked by
    the registry at collect, so a renamed signal fails loudly.

Not ported yet: the fleet scrape (``fleet_samples``) and the flight
recorder.
"""

from __future__ import annotations

import json
import re
import threading
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


# ---------------------------------------------------------------------------
# HTTP exporter
# ---------------------------------------------------------------------------


class MetricsExporter:
    """Pull-based scrape endpoint over one registry (module docstring).

    ``health_fn()`` should be the owner's cheap liveness export (e.g.
    ``ServeFrontend.health`` — no percentile work); ``ring`` the owner's
    :class:`~dvf_tpu_torch.obs.registry.TimeSeriesRing` (``/timeseries``
    404s without one). ``/explain`` and ``/audit`` answer 404: their
    planes (frame lineage, audit) are not ported, and the reference
    answers 404 when none is attached."""

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        host: str = "127.0.0.1",
        health_fn: Optional[Callable[[], dict]] = None,
        ring: Optional[TimeSeriesRing] = None,
        ledger_fn: Optional[Callable[[], dict]] = None,
    ):
        self.registry = registry
        self.health_fn = health_fn
        self.ring = ring
        self.ledger_fn = ledger_fn  # reconfiguration-ledger document
        #   (``ReconfigLedger.document`` on a serve/fleet owner):
        #   ``/ledger`` serves the bounded event window; 404s without one
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
        elif path in ("/explain", "/audit"):
            req.send_error(404, explain="no lineage or audit plane "
                                        "attached")
        elif path == "/ledger":
            if self.ledger_fn is None:
                req.send_error(404, explain="no reconfiguration ledger "
                                            "attached (serve/fleet tiers "
                                            "expose one)")
                return
            self._reply(req, 200, "application/json",
                        json.dumps(jsonable(self.ledger_fn())))
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
