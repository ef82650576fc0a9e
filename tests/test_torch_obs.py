"""The port's observability planes (``dvf_tpu_torch.obs``) on the CPU:
counterparts of ``tests/test_obs.py``'s metric-name, registry,
time-series-ring, serve-endpoint, tracer-ring, trace-merge, flight
recorder, flight-trigger, export-schema and fleet tests (not its bench writers)
and of ``tests/test_ledger.py``'s ledger, leak-trend and
serve-ledger tests, plus parity with the JAX package: the ledger's event
kinds and causes, and the flight dump's file set and document keys. The
device-trace merge is held to a hand-written Kineto trace and to a real
``torch.profiler`` run on the CPU.
"""

import gc
import importlib
import os
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dvf_tpu_torch.obs import ledger as ledger_mod
from dvf_tpu_torch.obs.export import (
    FlightRecorder,
    MetricsExporter,
    jsonable,
    samples_from_signals,
)
from dvf_tpu_torch.obs.ledger import ReconfigLedger
from dvf_tpu_torch.obs.memory import LeakTrendWatch, memory_summary
from dvf_tpu_torch.obs.registry import (
    MetricsRegistry,
    TimeSeriesRing,
    check_metric_name,
    walk_export,
)
from dvf_tpu_torch.obs.trace import (
    LANE_STRIDE,
    MERGED_TRACE_NAME,
    Tracer,
    merge_tracer_snapshots,
    merge_with_device_trace,
)
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.resilience import FaultPlan
from dvf_tpu_torch.serve import ServeConfig
from dvf_tpu_torch.serve.session import ServeError
from torch_serve_util import (  # noqa: F401
    FleetFrontend,
    ServeFrontend,
    port_fleet_guard,
    port_leak_guard,
)

H, W = 16, 24


def tagged_frame(k: int, j: int) -> np.ndarray:
    f = np.full((H, W, 3), 7, np.uint8)
    f[0] = k
    f[1] = j % 251
    return f


def _get(url: str) -> str:
    return urllib.request.urlopen(url, timeout=10).read().decode()


def drain(fe, sid, want, deadline_s=30.0):
    got = []
    deadline = time.time() + deadline_s
    while len(got) < want and time.time() < deadline:
        got += fe.poll(sid)
        time.sleep(0.005)
    return got


# ---------------------------------------------------------------------------
# Name conformance + registry
# ---------------------------------------------------------------------------


class TestMetricNames:
    def test_conformant_names(self):
        for name in ("p50_ms", "fps", "capture_fps", "h2d_mbps",
                     "faults_total", "ms_per_frame",
                     "bytes_accessed_per_frame", "total_ms",
                     "overlap_efficiency", "queue_depth",
                     "heartbeat_ages_s", "d2h_fixed_ms"):
            assert check_metric_name(name) is None, name

    def test_rename_hazards_rejected(self):
        for name in ("msPerFrame", "p50-ms", "latency_ms_avg",
                     "total_frames_produced", "fps_mean", "Ms", "1abc",
                     "mbps_down_link"):
            assert check_metric_name(name) is not None, name

    def test_walker_skips_dynamic_keys_checks_their_values(self):
        doc = {"sessions": {"sid@g1": {"p50_ms": 1.0, "badKey": 2}},
               "by_kind": {"decode": 3}}
        bad = walk_export(doc)
        # The session id (data) passes; the nested stats key inside the
        # dynamic map is still checked.
        assert [p for p, _ in bad] == ["sessions.sid@g1.badKey"]

    def test_registry_refuses_nonconformant_registration(self):
        r = MetricsRegistry()
        with pytest.raises(ValueError, match="conformant"):
            r.counter("framesProcessed")
        with pytest.raises(ValueError, match="conformant"):
            r.gauge("latency_ms_avg")

    def test_provider_renamed_key_dropped_loudly(self):
        r = MetricsRegistry()
        r.register_provider(lambda: samples_from_signals(
            {"good_total": 1.0}, prefix="x"))
        from dvf_tpu_torch.obs.registry import GAUGE, MetricSample

        r.register_provider(lambda: [MetricSample("brokenName", 1.0, (),
                                                  GAUGE)])
        names = {s.name for s in r.collect()}
        assert "x_good_total" in names
        assert "brokenName" not in names
        assert r.dropped_samples == 1


class TestRegistry:
    def test_counter_gauge_histogram_render(self):
        r = MetricsRegistry()
        r.counter("faults_total").inc(2, labels={"kind": "decode"})
        r.gauge("p99_ms").set(12.5)
        h = r.histogram("tick_ms", [1, 10])
        for v in (0.5, 5, 50):
            h.observe(v)
        text = r.to_prometheus()
        assert "# TYPE dvf_faults_total counter" in text
        assert 'dvf_faults_total{kind="decode"} 2' in text
        assert "dvf_p99_ms 12.5" in text
        assert 'dvf_tick_ms_bucket{le="1"} 1' in text
        assert 'dvf_tick_ms_bucket{le="+Inf"} 3' in text
        assert "dvf_tick_ms_count 3" in text
        doc = r.to_json()
        assert {"name": "p99_ms", "value": 12.5, "labels": {},
                "kind": "gauge"} in doc["samples"]

    def test_signals_adapter_pivots_fault_keys(self):
        out = samples_from_signals(
            {"fps": 30.0, "fault_decode_total": 2, "shed_total": 1,
             "skipped": None},
            prefix="serve", labels={"replica": "r1"})
        by_name = {s.name: s for s in out}
        assert by_name["serve_faults_total"].labels == (
            ("kind", "decode"), ("replica", "r1"))
        assert by_name["serve_shed_total"].kind == "counter"
        assert by_name["serve_fps"].kind == "gauge"
        assert len(out) == 3  # None dropped

    def test_non_numeric_gauge_drops_sample_not_scrape(self):
        r = MetricsRegistry()
        r.gauge("bad_gauge").set_fn(lambda: "oops")
        r.gauge("worse_gauge").set("not-a-number")
        r.gauge("fps").set(3.0)
        text = r.to_prometheus()  # must not raise
        assert "dvf_fps 3" in text
        assert "bad_gauge" not in text and "worse_gauge" not in text

    def test_json_documents_are_strict_rfc8259(self):
        """NaN percentiles (empty windows) must never reach a JSON
        document as the invalid literal ``NaN`` — rows treat them as
        gaps, served documents sanitize to null (``jsonable``; the
        reference also checks its flight dumps, not ported yet)."""
        ring = TimeSeriesRing(lambda: {"p50_ms": float("nan"),
                                       "fps": 1.0}, interval_s=10.0)
        ring.sample_once()
        [row] = ring.series()["rows"]
        assert "p50_ms" not in row and row["fps"] == 1.0
        text = json.dumps(jsonable({"p99_ms": float("nan"), "n": 2,
                                    "rows": ring.series()["rows"]}))
        assert "NaN" not in text
        assert json.loads(text)["p99_ms"] is None

    def test_nan_and_inf_render(self):
        r = MetricsRegistry()
        r.gauge("p99_ms").set(float("nan"))
        r.gauge("capacity_fps").set(float("inf"))
        text = r.to_prometheus()
        assert "dvf_p99_ms NaN" in text
        assert "dvf_capacity_fps +Inf" in text


class TestTimeSeriesRing:
    def test_bounded_window_and_hook(self):
        seen = []
        n = {"v": 0}

        def sample():
            n["v"] += 1
            return {"x": float(n["v"]), "gap": None}

        ring = TimeSeriesRing(sample, interval_s=10.0, capacity=3,
                              on_sample=lambda prev, cur: seen.append(
                                  (prev or {}).get("x")))
        for _ in range(5):
            ring.sample_once()
        doc = ring.series()
        assert [row["x"] for row in doc["rows"]] == [3.0, 4.0, 5.0]
        assert all("gap" not in row and "t" in row for row in doc["rows"])
        assert seen == [None, 1.0, 2.0, 3.0, 4.0]
        assert len(ring) == 3

    def test_since_cursor_semantics(self):
        """The /timeseries incremental-scrape contract: ``since`` is an
        exclusive wall-clock cursor over row ``t``; ``cursor`` always
        reflects the newest retained row (pass it back as the next
        ``since``), even when the filtered rows are empty."""
        n = {"v": 0}

        def sample():
            n["v"] += 1
            return {"x": float(n["v"])}

        ring = TimeSeriesRing(sample, interval_s=10.0, capacity=10)
        for _ in range(4):
            ring.sample_once()
            time.sleep(0.002)  # distinct wall-clock stamps
        full = ring.series()
        assert [r["x"] for r in full["rows"]] == [1.0, 2.0, 3.0, 4.0]
        assert full["cursor"] == full["rows"][-1]["t"]
        mid = full["rows"][1]["t"]
        delta = ring.series(since=mid)
        # Strictly-after semantics: the row AT the cursor is not resent.
        assert [r["x"] for r in delta["rows"]] == [3.0, 4.0]
        assert delta["cursor"] == full["cursor"]
        # Caught up: empty rows, same cursor back (poll again later).
        done = ring.series(since=full["cursor"])
        assert done["rows"] == [] and done["cursor"] == full["cursor"]
        # A cursor older than the window's tail returns the whole
        # bounded window (the ring is a sliding window, not a log).
        assert len(ring.series(since=0.0)["rows"]) == 4
        # Empty ring: no rows, null cursor.
        empty = TimeSeriesRing(lambda: {}, interval_s=10.0)
        assert empty.series()["cursor"] is None

    def test_since_cursor_over_http(self):
        ring = TimeSeriesRing(lambda: {"x": 1.0}, interval_s=10.0)
        ring.sample_once()
        time.sleep(0.002)
        ring.sample_once()
        with MetricsExporter(MetricsRegistry(), ring=ring) as ex:
            full = json.loads(_get(f"{ex.url}/timeseries"))
            assert len(full["rows"]) == 2
            cur = full["rows"][0]["t"]
            delta = json.loads(_get(f"{ex.url}/timeseries?since={cur}"))
            assert len(delta["rows"]) == 1
            assert delta["rows"][0]["t"] > cur
            caught = json.loads(_get(
                f"{ex.url}/timeseries?since={full['cursor']}"))
            assert caught["rows"] == []
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(f"{ex.url}/timeseries?since=nonsense")
            assert ei.value.code == 400

    def test_sampler_thread_and_error_containment(self):
        boom = {"on": False}

        def sample():
            if boom["on"]:
                raise RuntimeError("sensor broke")
            return {"x": 1.0}

        ring = TimeSeriesRing(sample, interval_s=0.01).start()
        deadline = time.time() + 5.0
        while len(ring) < 2 and time.time() < deadline:
            time.sleep(0.005)
        assert len(ring) >= 2
        boom["on"] = True
        deadline = time.time() + 5.0
        while ring.sample_errors == 0 and time.time() < deadline:
            time.sleep(0.005)
        ring.stop()
        assert ring.sample_errors >= 1  # gap, not a dead sampler

    def test_rate_logger_lands_gauge_on_print_ticks(self):
        r = MetricsRegistry()
        from dvf_tpu_torch.obs.metrics import RateLogger

        rl = RateLogger("capture", interval_s=0.0, quiet=True, registry=r)
        rate = rl.tick(5)
        assert rate is not None and rate == rl.last_rate
        sample = [s for s in r.collect() if s.name == "rate_fps"]
        assert len(sample) == 1
        assert sample[0].labels == (("stage", "capture"),)
        assert sample[0].value == pytest.approx(rate)


class TestServeMetricsEndpoint:
    def test_metrics_healthz_timeseries(self):
        from dvf_tpu_torch.serve import ServeConfig

        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                        telemetry_sample_s=0.05, trace=True))
        with fe:
            sid = fe.open_stream()
            for j in range(6):
                fe.submit(sid, tagged_frame(0, j))
            got = drain(fe, sid, 6)
            assert len(got) == 6
            deadline = time.time() + 5.0
            while len(fe.telemetry) < 2 and time.time() < deadline:
                time.sleep(0.01)
            with MetricsExporter(fe.registry, health_fn=fe.health,
                                 ring=fe.telemetry) as ex:
                text = _get(f"{ex.url}/metrics")
                health = json.loads(_get(f"{ex.url}/healthz"))
                series = json.loads(_get(f"{ex.url}/timeseries"))
                with pytest.raises(urllib.error.HTTPError):
                    _get(f"{ex.url}/nope")
                # The lineage and audit planes are not ported: their
                # endpoints answer 404, as the reference's do without
                # a plane attached.
                for path in ("/explain", "/audit"):
                    with pytest.raises(urllib.error.HTTPError) as ei:
                        _get(f"{ex.url}{path}")
                    assert ei.value.code == 404
        # Prometheus text exposition with the headline signals.
        assert "# TYPE dvf_serve_p50_ms gauge" in text
        for want in ("dvf_serve_p50_ms ", "dvf_serve_p99_ms ",
                     "dvf_serve_queue_depth ", "dvf_serve_fps ",
                     "dvf_serve_delivered_total 6",
                     "dvf_serve_engine_frames_total "):
            assert want in text, (want, text)
        assert health["ok"] is True
        rows = series["rows"]
        assert rows and all("t" in r and "queue_depth" in r for r in rows)
        # delivered_total is monotone in the window
        dl = [r["delivered_total"] for r in rows]
        assert dl == sorted(dl)

    def test_counters_monotone_across_retirement_eviction(self):
        """*_total series are Prometheus counters: evicting old sessions
        from the bounded retired map (or release()) must never shrink
        them — a backward step reads as a counter reset and fakes a
        rate() spike."""
        from dvf_tpu_torch.serve import ServeConfig

        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                        max_retired=1, telemetry_sample_s=0.0))
        seen = []
        with fe:
            for k in range(3):  # retirement bound 1: sessions 0,1 evict
                sid = fe.open_stream()
                for j in range(4):
                    fe.submit(sid, tagged_frame(k, j))
                assert len(drain(fe, sid, 4)) == 4
                fe.close(sid, drain=True)
                deadline = time.time() + 20.0
                while fe.open_count() and time.time() < deadline:
                    time.sleep(0.005)
                seen.append(fe.signals()["delivered_total"])
            fe.release(next(iter(fe._retired)))  # explicit release too
            seen.append(fe.signals()["delivered_total"])
        assert seen == sorted(seen), seen
        assert seen[-1] == 12.0  # nothing lost to the eviction arithmetic

    def test_fault_counters_labeled_by_kind(self):
        from dvf_tpu_torch.resilience import FaultPlan
        from dvf_tpu_torch.serve import ServeConfig

        chaos = FaultPlan().add("compute", at=(1,), count=1)
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                        chaos=chaos, telemetry_sample_s=0.0))
        with fe:
            sid = fe.open_stream()
            for j in range(8):
                fe.submit(sid, tagged_frame(0, j))
                time.sleep(0.02)
            deadline = time.time() + 20.0
            while fe.faults.total() == 0 and time.time() < deadline:
                time.sleep(0.01)
            with MetricsExporter(fe.registry) as ex:
                text = _get(f"{ex.url}/metrics")
        assert 'dvf_serve_faults_total{kind="compute"} ' in text


# ---------------------------------------------------------------------------
# Reconfiguration ledger + memory accounting
# ---------------------------------------------------------------------------


def frame_u8(k: int, j: int) -> np.ndarray:
    f = np.full((H, W, 3), 11, np.uint8)
    f[0] = k
    f[1] = j % 251
    return f


def _drive_sync(fe, sid, frame, deadline_s=30.0):
    s = fe._session(sid)
    before = s.delivered + s.failed
    fe.submit(sid, frame)
    deadline = time.time() + deadline_s
    while s.delivered + s.failed < before + 1:
        assert time.time() < deadline, "serve path deadlocked"
        time.sleep(0.002)


def drain(fe, sid, want, deadline_s=30.0):
    got = []
    deadline = time.time() + deadline_s
    while len(got) < want and time.time() < deadline:
        got += fe.poll(sid)
        time.sleep(0.005)
    return got


def _events(fe, kind=None):
    evs = fe.ledger.snapshot()
    return [e for e in evs if kind is None or e["kind"] == kind]


def _wait(pred, deadline_s=20.0, msg="condition never held"):
    deadline = time.time() + deadline_s
    while not pred():
        assert time.time() < deadline, msg
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# Unit layer
# ---------------------------------------------------------------------------


class TestReconfigLedgerUnit:
    def test_record_snapshot_and_counters(self):
        led = ReconfigLedger(capacity=4)
        led.record(ledger_mod.COMPILE, cause="admission", signature="s",
                   cache="miss", wall_ms=12.5, compile_ms=12.5)
        led.record(ledger_mod.POOL_ACQUIRE, cause="admission",
                   signature="s", cache="hit", wall_ms=0.0)
        s = led.summary()
        assert s["events_total"] == 2 and s["dropped_total"] == 0
        assert s["by_kind"] == {"compile": 1, "pool_acquire": 1}
        assert s["by_cause"] == {"admission": 2}
        ev = s["events"][0]
        assert ev["cause"] == "admission" and ev["wall_ms"] == 12.5
        assert ev["thread"]  # who ran it is always recorded
        # Bounded ring: overflow sheds oldest and counts it.
        for i in range(6):
            led.record(ledger_mod.BUCKET_CREATE, bucket=f"b{i}")
        s = led.summary()
        assert len(led.snapshot()) == 4
        assert s["events_total"] == 8 and s["dropped_total"] == 4
        assert not walk_export(s), walk_export(s)

    def test_stall_window_measures_dispatch_gap(self):
        led = ReconfigLedger()
        t0 = 1000.0
        ev = led.record(ledger_mod.BATCH_RESIZE, cause="resize",
                        bucket="b", wall_ms=50.0, stall_from=t0)
        assert led.has_pending_stalls
        # The export never leaks the open window's internal mark.
        assert "stall_from" not in led.snapshot()[-1]
        assert "stall_ms" not in led.snapshot()[-1]
        led.note_dispatch("other-bucket", t0 + 0.2)  # wrong bucket: open
        assert led.has_pending_stalls
        led.note_dispatch("b", t0 + 0.25)
        assert not led.has_pending_stalls
        assert ev["stall_ms"] == pytest.approx(250.0, abs=1e-6)
        s = led.summary()
        assert s["stall_events_total"] == 1
        assert s["stall_ms_total"] == pytest.approx(250.0, abs=1e-3)
        # Closed: a later tick does not re-close or double-count.
        led.note_dispatch("b", t0 + 9.0)
        assert led.summary()["stall_events_total"] == 1

    def test_abandon_stalls_drops_open_windows(self):
        led = ReconfigLedger()
        ev = led.record(ledger_mod.BATCH_RESIZE, bucket="b",
                        stall_from=5.0)
        led.abandon_stalls("b")
        assert not led.has_pending_stalls
        assert "stall_from" not in ev and "stall_ms" not in ev

    def test_signals_are_flat_counters(self):
        led = ReconfigLedger()
        led.record(ledger_mod.COMPILE, cause="admission")
        sig = led.signals()
        assert sig["ledger_events_total"] == 1.0
        assert not walk_export(sig)


class TestLeakTrendWatch:
    def test_staircase_trips_once_and_rearms(self):
        w = LeakTrendWatch(window=4, min_growth_bytes=100)
        trips = [w.observe(v) for v in (0, 50, 110, 170)]
        assert trips[:3] == [None, None, None]
        assert trips[3] and "leak trend" in trips[3]
        # Still rising: same episode, no second trip.
        assert w.observe(240) is None
        # Plateau re-arms; a fresh staircase trips again.
        assert w.observe(240) is None
        for v in (300, 380, 460):
            last = w.observe(v)
        assert last and w.trips_total == 2

    def test_noise_and_small_growth_do_not_trip(self):
        w = LeakTrendWatch(window=4, min_growth_bytes=1000)
        assert all(w.observe(v) is None
                   for v in (0, 50, 40, 90, 80, 130, 120, 170))
        # Monotone but under the growth floor: no trip.
        w2 = LeakTrendWatch(window=4, min_growth_bytes=10_000)
        assert all(w2.observe(v) is None for v in (0, 10, 20, 30, 40))


def _frontend(**kw):
    cfg = ServeConfig(batch_size=2, queue_size=1000, slo_ms=60_000.0,
                      telemetry_sample_s=0.0, **kw)
    return ServeFrontend(get_filter("invert"), cfg)


class TestServeLedger:
    def test_admission_compile_event_and_histogram(self):
        fe = _frontend()
        with fe:
            fe.open_stream(op_chain="grayscale", frame_shape=(H, W, 3))
            evs = _events(fe, ledger_mod.COMPILE)
            assert len(evs) == 1
            ev = evs[0]
            assert ev["cause"] == "admission" and ev["cache"] == "miss"
            assert ev["compile_ms"] > 0 and ev["wall_ms"] > 0
            assert "grayscale" in ev["signature"]
            # A second identical admission JOINS the live bucket: no
            # new compile, no pool traffic — silence is the record.
            fe.open_stream(op_chain="grayscale", frame_shape=(H, W, 3))
            assert len(_events(fe, ledger_mod.COMPILE)) == 1
            # A precompiled signature's later admission is a pool HIT.
            warmed = fe.precompile([{"op_chain": "grayscale|invert",
                                     "frame_shape": [H, W, 3]}])
            assert warmed
            pre = [e for e in _events(fe, ledger_mod.COMPILE)
                   if e["cause"] == "precompile"]
            assert len(pre) == 1 and pre[0]["cache"] == "miss"
            fe.open_stream(op_chain="grayscale|invert",
                           frame_shape=(H, W, 3))
            hits = _events(fe, ledger_mod.POOL_ACQUIRE)
            assert hits and hits[-1]["cache"] == "hit"
            assert hits[-1]["cause"] == "admission"
            # dvf_compile_ms histogram: labeled by signature AND cause,
            # through the registry (conformance applied at registration).
            samples = [s for s in fe.registry.collect()
                       if s.name.startswith("compile_ms")]
            assert any(s.name == "compile_ms_count"
                       and dict(s.labels).get("cause") == "admission"
                       and "grayscale" in dict(s.labels)["signature"]
                       for s in samples)

    def test_chaos_mix_rebuild_resize(self):
        """One batch resize + one engine rebuild in a single run (the
        reference's acceptance run, without its quality downshift, which
        needs the control plane, and its flight dump). The resize rides
        the compile-aside hot swap (kind=swap, measured stall_ms, NO
        stall window); only the recovery rebuild — a real quiesce —
        opens a stall window; both land on the ledger's own trace lane."""
        fe = _frontend(stall_timeout_s=0.0, fault_budget=2, trace=True,
                       out_queue_size=500)
        with fe:
            sid = fe.open_stream(frame_shape=(H, W, 3))
            for j in range(3):  # healthy warm-up, pins the bucket
                _drive_sync(fe, sid, frame_u8(0, j))

            # -- leg 1: batch resize (hot swap) ------------------------
            label = next(iter(fe.stats()["buckets"]))
            assert fe.request_batch_size(label, 1,
                                        reason="test resize")
            _wait(lambda: _events(fe, ledger_mod.SWAP),
                  msg="swap event never landed")
            for j in range(3, 6):   # post-swap traffic (new program)
                _drive_sync(fe, sid, frame_u8(0, j))
            swap = _events(fe, ledger_mod.SWAP)[0]
            assert swap["cause"] == "resize"
            assert swap["compile_aside_ms"] > 0   # background compile
            assert 0 <= swap["stall_ms"] < 1000.0  # measured commit
            assert swap["reason"] == "test resize"
            assert not swap.get("aborted")
            assert fe.swaps >= 1

            # -- leg 2: forced engine rebuild (compute budget overflow:
            # three injected compute faults against a budget of two;
            # the rebuilt engine shares the spent plan and serves) ----
            fe.engine.chaos = FaultPlan().add("compute", every=1, count=3)
            for j in range(6, 9):  # 2 contained + overflow → rebuild
                _drive_sync(fe, sid, frame_u8(0, j))
            _wait(lambda: fe.recoveries >= 1, msg="rebuild never ran")
            for j in range(9, 12):  # rebuilt engine serves → closes
                _drive_sync(fe, sid, frame_u8(0, j))   # the stall window
            _wait(lambda: _events(fe, ledger_mod.ENGINE_REBUILD)
                  and all("stall_ms" in e for e in
                          _events(fe, ledger_mod.ENGINE_REBUILD)),
                  msg="rebuild event/stall never landed")
            rebuild = _events(fe, ledger_mod.ENGINE_REBUILD)[0]
            assert rebuild["cause"] == "recovery"
            assert rebuild["fault_kind"] == "compute"
            assert rebuild["compile_ms"] > 0
            assert rebuild["stall_ms"] > 0
            summary = fe.ledger.summary()
            assert summary["stall_events_total"] >= 1
            assert not walk_export(summary), walk_export(summary)

            # -- merged Perfetto trace: dedicated reconfig lane --------
            from dvf_tpu_torch.obs.trace import merge_tracer_snapshots

            doc = merge_tracer_snapshots([fe.tracer.snapshot()])
            names = {e.get("name") for e in doc["traceEvents"]}
            assert "reconfig:swap" in names
            assert "reconfig:engine_rebuild" in names
            assert "reconfig_stall_closed" in names
            lanes = {e.get("pid") for e in doc["traceEvents"]
                     if str(e.get("name", "")).startswith("reconfig")}
            assert lanes == {ledger_mod.TRACK_LEDGER}
        got = drain(fe, sid, 0, deadline_s=0.1)
        assert [d.index for d in got] == sorted(d.index for d in got)

    def test_chaos_mix_quality_downshift_leg(self, tmp_path):
        """The reference acceptance run's third leg: a quality downshift
        rebinds the session WITHOUT a bucket pause (the target program
        was compiled aside at cause=quality; the cutover cost is the
        measured binding swing), lands on the ledger's trace lane, and
        the flight dump's ledger.json carries it."""
        from dvf_tpu_torch.control import ControlConfig
        from dvf_tpu_torch.obs.viewer import render_text, summarize

        fe = _frontend(stall_timeout_s=0.0, trace=True,
                       flight_dir=str(tmp_path / "flight"),
                       flight_min_interval_s=0.0, control=True,
                       control_config=ControlConfig(interval_s=30.0),
                       out_queue_size=500)
        with fe:
            sid = fe.open_stream(frame_shape=(H, W, 3))
            for j in range(3):
                _drive_sync(fe, sid, frame_u8(0, j))
            assert fe.request_session_quality(sid, 1,
                                              reason="test downshift")
            _wait(lambda: _events(fe, ledger_mod.QUALITY_REBIND),
                  msg="rebind event never landed")
            for j in range(3, 6):
                _drive_sync(fe, sid, frame_u8(0, j))
            rebind = _events(fe, ledger_mod.QUALITY_REBIND)[0]
            assert rebind["cause"] == "quality"
            assert rebind["level"] == 1 and rebind["session"] == sid
            assert 0 <= rebind["stall_ms"] < 1000.0  # measured swing
            qcompiles = [e for e in _events(fe, ledger_mod.COMPILE)
                         if e["cause"] == "quality"]
            assert qcompiles and qcompiles[0]["compile_ms"] > 0
            summary = fe.ledger.summary()
            assert summary["stall_events_total"] == 0  # no quiesce
            assert not walk_export(summary), walk_export(summary)
            from dvf_tpu_torch.obs.trace import merge_tracer_snapshots

            doc = merge_tracer_snapshots([fe.tracer.snapshot()])
            names = {e.get("name") for e in doc["traceEvents"]}
            assert "reconfig:quality_rebind" in names
            lanes = {e.get("pid") for e in doc["traceEvents"]
                     if str(e.get("name", "")).startswith("reconfig")}
            assert lanes == {ledger_mod.TRACK_LEDGER}
            dump = fe.flight.trigger("test: quality downshift")
            assert dump is not None
            with open(os.path.join(dump, "ledger.json")) as f:
                led_doc = json.load(f)
            assert "quality_rebind" in {e["kind"] for e in led_doc["events"]}
            view = summarize(dump)
            assert "quality_rebind" in {
                e["kind"] for e in view["reconfigurations"]}
            assert "reconfiguration events" in render_text(view)
        got = drain(fe, sid, 0, deadline_s=0.1)
        assert [d.index for d in got] == sorted(d.index for d in got)
        assert all(d.frame.shape == (H, W, 3) for d in got)

    def test_ledger_endpoint(self):
        fe = _frontend()
        with fe:
            fe.open_stream(op_chain="grayscale", frame_shape=(H, W, 3))
            ex = MetricsExporter(fe.registry, port=0,
                                 ledger_fn=fe.ledger.document).start()
            try:
                with urllib.request.urlopen(f"{ex.url}/ledger") as r:
                    doc = json.loads(r.read())
                assert doc["events_total"] >= 1
                assert any(e["kind"] == "compile" for e in doc["events"])
                # /metrics carries the dvf_mem_* family.
                with urllib.request.urlopen(f"{ex.url}/metrics") as r:
                    text = r.read().decode()
                # No CUDA device here: the allocator read is a gap, not
                # a zero (the reference's jax walk reads the CPU).
                assert "dvf_mem_device_live_bytes" not in text
                assert "dvf_mem_host_slab_bytes" in text
                assert "dvf_mem_pool_engines" in text
                assert "dvf_compile_ms_bucket" in text
            finally:
                ex.stop()

    def test_ledger_off_zero_surface(self):
        fe = _frontend(ledger=False)
        with fe:
            sid = fe.open_stream()
            _drive_sync(fe, sid, frame_u8(0, 0))
            st = fe.stats()
            assert "ledger" not in st and "memory" not in st
            sig = fe.signals()
            assert "ledger_events_total" not in sig
            assert "mem_host_slab_bytes" not in sig
            assert not any(s.name.startswith(("mem_", "compile_ms"))
                           for s in fe.registry.collect())

    def test_memory_accounting_and_release_at_stop(self):
        from dvf_tpu_torch.runtime import egress, ingest

        fe = _frontend()
        with fe:
            sid = fe.open_stream()
            _drive_sync(fe, sid, frame_u8(0, 0))
            sig = fe.signals()
            assert sig["mem_host_slab_bytes"] > 0  # staging pool is live
            mem = fe.stats()["memory"]
            assert mem["host_slab_bytes"] == sig["mem_host_slab_bytes"]
            assert mem["by_bucket"]  # per-bucket attribution rows
            # Process-wide scrape document (the dvf_mem_* source).
            doc = memory_summary()
            assert doc["host_slab_bytes"] >= mem["host_slab_bytes"]
            assert doc["device_live_bytes"] is None  # the CPU: a gap
        # Stop released every slab this frontend pinned.
        gc.collect()
        assert fe._host_slab_bytes() == 0
        # And nothing of this frontend's remains in the registries.
        assert all(a.slab_bytes() == 0 for a in ingest.live_assemblers())
        assert all(f.slab_bytes() == 0 for f in egress.live_fetchers())

    def test_leak_watch_trips_on_telemetry_hook(self):
        """A synthetic rising mem_host_slab_bytes staircase through the
        telemetry hook trips the leak watch once (with a flight recorder
        armed, the trip dumps: test_leak_watch_trips_flight)."""
        fe = _frontend()
        fe._leak_watch = LeakTrendWatch(window=3, min_growth_bytes=10)
        with fe:
            for v in (0.0, 100.0, 250.0, 400.0):
                fe._on_telemetry_sample(None, {"mem_host_slab_bytes": v})
            assert fe._leak_watch.trips_total == 1


# ---------------------------------------------------------------------------
# Ledger parity with the JAX package
# ---------------------------------------------------------------------------


def _scripted_ledger(fe, drive) -> list:
    """admission → traffic → resize (hot swap) → close → a new signature
    at the bucket cap (retires the idle bucket): the ledgered
    (kind, cause) sequence, each step awaited before the next."""
    with fe:
        sid = fe.open_stream(op_chain="grayscale", frame_shape=(H, W, 3))
        for j in range(2):
            drive(fe, sid, frame_u8(0, j))
        label = next(k for k in fe.stats()["buckets"]
                     if k.startswith("grayscale"))
        assert fe.request_batch_size(label, 1, reason="scripted")
        _wait(lambda: _events(fe, ledger_mod.SWAP))
        drive(fe, sid, frame_u8(0, 2))
        fe.close(sid, drain=True)
        _wait(lambda: fe.open_count() == 0)
        fe.open_stream(op_chain="box_blur(ksize=3)", frame_shape=(H, W, 3))
        return [(e["kind"], e.get("cause")) for e in fe.ledger.snapshot()]


def test_scripted_ledger_kinds_and_causes_match_reference():
    import dvf_tpu
    from dvf_tpu.serve import ServeConfig as JaxConfig
    from dvf_tpu.serve import ServeFrontend as JaxFrontend

    kw = dict(batch_size=2, queue_size=100, slo_ms=60_000.0, max_buckets=2)
    got = _scripted_ledger(
        ServeFrontend(get_filter("invert"), ServeConfig(**kw)), _drive_sync)
    ref = _scripted_ledger(
        JaxFrontend(dvf_tpu.get_filter("invert"), JaxConfig(**kw)),
        _drive_sync)
    assert got == ref
    kinds = [k for k, _ in got]
    assert kinds.count(ledger_mod.SWAP) == 1
    assert ledger_mod.BUCKET_RETIRE in kinds
    assert kinds.count(ledger_mod.COMPILE) == 2


def _scripted_quality_ledger(fe, drive) -> list:
    """admission → traffic → downshift → traffic → recovery → traffic:
    the ledgered (kind, cause, level) sequence and the delivered
    frames."""
    with fe:
        sid = fe.open_stream(op_chain="invert", frame_shape=(H, W, 3))
        out = []
        for level, j in ((0, 0), (1, 1), (1, 2), (0, 3)):
            if level != fe._session(sid).quality_level:
                assert fe.request_session_quality(sid, level,
                                                  reason="scripted")
                _wait(lambda: fe._session(sid).quality_level == level)
            drive(fe, sid, frame_u8(0, j))
        out = [d.frame for d in drain(fe, sid, 4)]
        return ([(e["kind"], e.get("cause"), e.get("level"))
                 for e in fe.ledger.snapshot()], out)


def test_scripted_quality_ledger_matches_reference():
    """The quality-downshift leg on both frontends: the same ledger
    (kind, cause, level) sequence and bit-identical frames (invert)."""
    import dvf_tpu
    from dvf_tpu.control import ControlConfig as JaxControlConfig
    from dvf_tpu.serve import ServeConfig as JaxConfig
    from dvf_tpu.serve import ServeFrontend as JaxFrontend

    from dvf_tpu_torch.control import ControlConfig

    kw = dict(batch_size=2, queue_size=100, out_queue_size=100,
              slo_ms=60_000.0, control=True)
    got, frames = _scripted_quality_ledger(
        ServeFrontend(get_filter("invert"), ServeConfig(
            control_config=ControlConfig(interval_s=30.0), **kw)),
        _drive_sync)
    ref, ref_frames = _scripted_quality_ledger(
        JaxFrontend(dvf_tpu.get_filter("invert"), JaxConfig(
            control_config=JaxControlConfig(interval_s=30.0), **kw)),
        _drive_sync)
    # The downshift program's warm compile runs on its own thread beside
    # the admission, so the two compile events may land in either order.
    assert sorted(got, key=repr) == sorted(ref, key=repr)
    rebinds = [e for e in got if e[0] == ledger_mod.QUALITY_REBIND]
    assert rebinds == [e for e in ref if e[0] == ledger_mod.QUALITY_REBIND]
    assert [lv for _, _, lv in rebinds] == [1, 0]
    assert len(frames) == len(ref_frames) == 4
    for a, b in zip(frames, ref_frames):
        assert np.array_equal(a, b)


# The plane options of ServeConfig: every plane of the reference frontend
# is ported (the five observability planes, the control plane, auto-plan
# and the plan cache); each constructs, and a frontend built with it
# serves.
@pytest.mark.parametrize("option,value", [
    ("audit", True), ("lineage", True), ("flight_dir", "flight"),
    ("flight_profile_s", 1.0), ("profile_dir", "profiles"),
    ("control", True), ("autoplan", True), ("plan_cache_dir", "plans"),
])
def test_unported_plane_options_raise(option, value, tmp_path):
    """No ServeConfig option raises NotImplementedError any more: each
    plane option constructs, set at construction or changed after it,
    and a frontend built with it serves (the port's frontend has every
    option the reference frontend has)."""
    if isinstance(value, str):
        value = str(tmp_path / value)
    cfg = ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                      flight_min_interval_s=0.0, **{option: value})
    late = ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                       flight_min_interval_s=0.0)
    setattr(late, option, value)   # changed after construction
    for c in (cfg, late):
        fe = ServeFrontend(get_filter("invert"), c)
        with fe:
            sid = fe.open_stream()
            fe.submit(sid, tagged_frame(0, 0))
            got = drain(fe, sid, 1)
        assert len(got) == 1
        assert np.array_equal(got[0].frame, 255 - tagged_frame(0, 0))


def test_unported_surfaces_raise():
    """The broadcast surfaces, the audit probe and explain answer as the
    reference's do on an unarmed frontend: subscribing to a channel no
    session publishes is a KeyError, publishing builds the plane."""
    import dvf_tpu
    from dvf_tpu.serve import ServeConfig as JaxConfig
    from dvf_tpu.serve import ServeFrontend as JaxFrontend

    for fe in (ServeFrontend(get_filter("invert"), ServeConfig(batch_size=2)),
               JaxFrontend(dvf_tpu.get_filter("invert"),
                           JaxConfig(batch_size=2))):
        with fe:
            with pytest.raises(KeyError, match="ch"):
                fe.subscribe("ch")
            assert fe.broadcast is not None   # built lazily by subscribe
            sid = fe.open_stream(publish="ch")
            with pytest.raises(ValueError, match="no tiers"):
                fe.subscribe("ch")   # published without a ladder
            sub = fe.subscribe("ch", tier="native/raw")
            assert sub.tier.label() == "native/q90/raw"
            fe.unsubscribe(sub)
            assert fe.stats()["broadcast"]["channels"]["ch"]
            assert sid in fe.stats()["sessions"]
            with pytest.raises(Exception, match="no compiled program") as ei:
                fe.audit_probe()   # each package's own ServeError
            assert type(ei.value).__name__ == "ServeError"
            assert fe.explain() == {
                "lineage": False,
                "hint": "arm ServeConfig.lineage / --lineage to collect "
                        "frame-lineage attribution"}


class TestServeLedgerPlanes:
    def test_leak_watch_trips_flight(self, tmp_path):
        """A synthetic rising mem_host_slab_bytes staircase through the
        telemetry hook trips the flight recorder once."""
        fe = _frontend(flight_dir=str(tmp_path / "flight"),
                       flight_min_interval_s=0.0)
        fe._leak_watch = LeakTrendWatch(window=3, min_growth_bytes=10)
        with fe:
            before = fe.flight.stats()["dumps"]
            for v in (0.0, 100.0, 250.0, 400.0):
                fe._on_telemetry_sample(None, {"mem_host_slab_bytes": v})
            _wait(lambda: fe.flight.stats()["dumps"] == before + 1,
                  msg="leak trend never dumped")
            assert "leak trend" in fe.flight.last_reason

    def test_lineage_additivity_with_ledger_armed(self):
        """The two planes coexist: every delivered frame's lineage
        components still telescope to its e2e latency while the ledger
        records a live resize in the same run."""
        fe = _frontend(lineage=True, trace=True)
        with fe:
            sid = fe.open_stream(frame_shape=(H, W, 3))
            for j in range(4):
                _drive_sync(fe, sid, frame_u8(0, j))
            label = next(iter(fe.stats()["buckets"]))
            assert fe.request_batch_size(label, 1, reason="mid-run")
            _wait(lambda: _events(fe, ledger_mod.SWAP),
                  msg="resize swap never landed")
            for j in range(4, 10):
                _drive_sync(fe, sid, frame_u8(0, j))
            got = drain(fe, sid, 10)
            assert len(got) == 10
            for d in got:
                assert d.lineage is not None
                assert sum(d.lineage.components_ms().values()) == \
                    pytest.approx(d.latency_ms, abs=1e-6)
            assert fe.ledger.summary()["by_kind"]["swap"] >= 1
            assert not walk_export(fe.stats())


# ---------------------------------------------------------------------------
# Tracer ring + trace merges
# ---------------------------------------------------------------------------


class TestTracerRing:
    def test_bounded_with_dropped_counter(self):
        t = Tracer(enabled=True, max_events=4)
        for i in range(10):
            t.instant("ev", ts=t.perf_start + i * 1e-3, track=0, i=i)
        assert len(t) == 4
        assert t.dropped == 6
        snap = t.snapshot()
        assert [e["args"]["i"] for e in snap["events"]] == [6, 7, 8, 9]
        assert snap["dropped"] == 6

    def test_snapshot_cap_keeps_most_recent(self):
        t = Tracer(enabled=True)
        for i in range(10):
            t.instant("ev", ts=t.perf_start + i * 1e-3, i=i)
        snap = t.snapshot(max_events=3)
        assert [e["args"]["i"] for e in snap["events"]] == [7, 8, 9]
        assert snap["dropped"] == 7
        assert len(t.snapshot()["events"]) == 10

    def test_disabled_tracer_records_nothing(self):
        t = Tracer(enabled=False, max_events=4)
        for _ in range(10):
            t.instant("ev")
            t.complete("sp", t.perf_start, t.perf_start + 1)
        assert len(t) == 0 and t.dropped == 0

    def test_snapshot_is_plain_values(self):
        import pickle

        t = Tracer(enabled=True, process_name="serve:r0")
        t.complete("span", t.perf_start, t.perf_start + 0.01, track=2,
                   frames=3)
        snap = pickle.loads(pickle.dumps(t.snapshot()))
        assert snap["process_name"] == "serve:r0"
        assert snap["events"][0]["args"] == {"frames": 3}
        json.dumps(snap)


class TestMergeTracerSnapshots:
    def _tracer(self, name, epoch):
        t = Tracer(enabled=True, process_name=name)
        t.start_time = t.perf_start = epoch  # stamps below on this origin
        return t

    def test_clock_alignment_and_lane_blocks(self):
        e0 = 1_000_000.0
        a = self._tracer("serve:r0", e0)
        b = self._tracer("serve:r1", e0 + 2.0)
        a.complete("span", e0 + 0.5, e0 + 0.6, track=1)
        b.complete("span", b.start_time + 0.5, b.start_time + 0.6, track=1)
        doc = merge_tracer_snapshots([a.snapshot(), b.snapshot()])
        ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        by_pid = {e["pid"]: e for e in ev}
        assert set(by_pid) == {1, LANE_STRIDE + 1}
        assert by_pid[LANE_STRIDE + 1]["ts"] - by_pid[1]["ts"] == 2_000_000
        lanes = doc["dvfTraceLanes"]
        assert [ln["process_name"] for ln in lanes] == ["serve:r0",
                                                        "serve:r1"]
        assert [ln["epoch_offset_us"] for ln in lanes] == [0, 2_000_000]

    def test_lane_stride_overflow_cannot_interleave_pid_blocks(self):
        a = self._tracer("serve:r0", 1000.0)
        a.complete("ok", 1000.0, 1000.01, track=1)
        a.complete("big", 1000.0, 1000.01, track=LANE_STRIDE + 50)
        a.instant("neg", ts=1000.0, track=-3)
        b = self._tracer("serve:r1", 1000.0)
        b.complete("other", 1000.0, 1000.01, track=50)
        doc = merge_tracer_snapshots([a.snapshot(), b.snapshot()])
        ev = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
        assert all(0 <= e["pid"] < LANE_STRIDE for e in ev
                   if e["name"] in ("ok", "big", "neg"))
        assert all(LANE_STRIDE <= e["pid"] < 2 * LANE_STRIDE for e in ev
                   if e["name"] == "other")
        assert next(e for e in ev if e["name"] == "big")["pid"] == \
            LANE_STRIDE - 1
        assert next(e for e in ev if e["name"] == "neg")["pid"] == 0
        lanes = {ln["process_name"]: ln for ln in doc["dvfTraceLanes"]}
        assert lanes["serve:r0"]["folded_tracks"] == 2

    def test_longest_duration_cut_and_instants_kept(self):
        t = self._tracer("fleet", 1000.0)
        t.instant("replica_lost", ts=1000.5, track=0, replica="r1")
        for i in range(6):
            t.complete(f"s{i}", 1000.0, 1000.0 + (i + 1) * 0.01)
        doc = merge_tracer_snapshots([t.snapshot()], max_events=3)
        kept = [e["name"] for e in doc["traceEvents"] if e.get("ph") != "M"]
        assert "replica_lost" in kept and len(kept) == 3
        assert "s5" in kept and "s4" in kept
        assert merge_tracer_snapshots([]) is None

    def test_merged_document_matches_reference(self, tmp_path):
        """Cross-package: the same tracer events merge to the same
        document bytes."""
        from dvf_tpu.obs import trace as ref

        docs = []
        for mod in (importlib.import_module("dvf_tpu_torch.obs.trace"), ref):
            snaps = []
            for k, name in enumerate(("serve:r0", "worker")):
                t = mod.Tracer(enabled=True, process_name=name)
                t.start_time = 1000.0 + k
                # The port stamps on perf_counter from its anchor
                # perf_start, the reference on the wall clock: pin both
                # origins, so both do the same arithmetic.
                t.perf_start = t.start_time
                t.complete("batch_complete", t.start_time + 0.1,
                           t.start_time + 0.2, track=1, frames=8)
                t.instant("frame_delivered", ts=t.start_time + 0.3, frame=k)
                snaps.append(t.snapshot())
            docs.append(json.dumps(mod.merge_tracer_snapshots(snaps),
                                   sort_keys=True))
        assert docs[0] == docs[1]


def _host_trace(tmp_path, start=1000.0):
    t = Tracer(enabled=True, process_name="pipeline")
    t.start_time = t.perf_start = start
    t.complete("batch_complete", start + 0.010, start + 0.020, track=1)
    t.instant("frame_delivered", ts=start + 0.021, track=2)
    return t.export(str(tmp_path / "host.pftrace")), t


def _kineto_dir(tmp_path, events, base_ns=None, name="trace.json"):
    d = tmp_path / "dev"
    d.mkdir(exist_ok=True)
    doc = {"schemaVersion": 1, "traceEvents": events,
           "displayTimeUnit": "ms"}
    if base_ns is not None:
        doc["baseTimeNanoseconds"] = base_ns
    (d / name).write_text(json.dumps(doc))
    return str(d)


class TestMergeWithDeviceTrace:
    """The torch.profiler (Kineto) Chrome-trace counterpart of the
    reference's merge: alignment by baseTimeNanoseconds, the Python
    tracer's events dropped, the +10000 pid offset, the longest-duration
    cut, None on a missing or truncated trace."""

    def test_kineto_alignment_filters_and_offsets(self, tmp_path):
        host, tracer = _host_trace(tmp_path)
        base_ns = 999_000_000_000   # 999 s, on the wall clock
        dev = _kineto_dir(tmp_path, [
            {"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": "GPU 0"}},
            {"ph": "M", "name": "process_name", "pid": 4242,
             "args": {"name": "python"}},
            {"ph": "X", "cat": "python_function", "name": "<built-in>",
             "ts": 1_000_000.0, "dur": 99999.0, "pid": 4242},
            {"ph": "i", "cat": "cpu_instant_event", "name": "inst",
             "ts": 1_000_001.0, "pid": 4242, "s": "t"},
            # 1.0125 s after the base: 12.5 ms past the tracer's start.
            {"ph": "X", "cat": "kernel", "name": "sobel_bilateral_kernel",
             "ts": 1_012_500.0, "dur": 420.0, "pid": 0, "tid": 7},
            {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
             "ts": 1_011_000.0, "dur": 30.0, "pid": 4242, "tid": 1},
        ], base_ns=base_ns)
        out = str(tmp_path / "merged.pftrace")
        assert merge_with_device_trace(host, dev, out, device_epoch_us=0,
                                       host_start_s=tracer.start_time) == out
        doc = json.loads(open(out).read())
        names = [e.get("name") for e in doc["traceEvents"]]
        assert "<built-in>" not in names and "inst" not in names
        assert "batch_complete" in names and "frame_delivered" in names
        k = next(e for e in doc["traceEvents"]
                 if e.get("name") == "sobel_bilateral_kernel")
        assert k["pid"] == 10000
        assert k["ts"] == pytest.approx(12_500.0)
        # Inside the host batch span once aligned.
        b = next(e for e in doc["traceEvents"]
                 if e.get("name") == "batch_complete")
        assert b["ts"] <= k["ts"] and k["ts"] + k["dur"] <= b["ts"] + b["dur"]
        op = next(e for e in doc["traceEvents"]
                  if e.get("name") == "aten::copy_")
        assert op["pid"] == 14242
        metas = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"
                 and e["pid"] >= 10000}
        assert metas == {10000: "deviceGPU 0", 14242: "devicepython"}

    def test_no_base_time_falls_back_to_epoch(self, tmp_path):
        host, tracer = _host_trace(tmp_path)
        dev = _kineto_dir(tmp_path, [
            {"ph": "X", "name": "fusion", "ts": 5, "dur": 7, "pid": 3}])
        out = str(tmp_path / "merged.json")
        assert merge_with_device_trace(host, dev, out, device_epoch_us=100,
                                       host_start_s=tracer.start_time) == out
        doc = json.loads(open(out).read())
        fusion = next(e for e in doc["traceEvents"] if e["name"] == "fusion")
        assert fusion["pid"] == 10003 and fusion["ts"] == 105

    def test_truncated_trace_is_best_effort_none(self, tmp_path):
        host, _ = _host_trace(tmp_path)
        dev = _kineto_dir(tmp_path, [
            {"ph": "X", "name": "k", "ts": 5, "dur": 7, "pid": 0}])
        p = os.path.join(dev, "trace.json")
        data = open(p, "rb").read()
        open(p, "wb").write(data[:-12])  # profiler killed mid-write
        out = str(tmp_path / "merged.json")
        assert merge_with_device_trace(host, dev, out, 0) is None
        assert not os.path.exists(out)

    def test_no_candidates_is_none(self, tmp_path):
        host, _ = _host_trace(tmp_path)
        assert merge_with_device_trace(
            host, str(tmp_path / "missing"), str(tmp_path / "m.json"),
            0) is None

    def test_max_events_keeps_longest_durations(self, tmp_path):
        host, _ = _host_trace(tmp_path)
        dev = _kineto_dir(tmp_path, [
            {"ph": "X", "name": f"op{i}", "ts": i, "dur": i, "pid": 1}
            for i in range(1, 6)])
        out = str(tmp_path / "merged.json")
        merge_with_device_trace(host, dev, out, 0, max_events=2)
        doc = json.loads(open(out).read())
        assert sorted(e["name"] for e in doc["traceEvents"]
                      if e["name"].startswith("op")) == ["op4", "op5"]

    def test_real_profiler_run_aligns_with_host_spans(self, tmp_path):
        """A real torch.profiler session on the CPU, in a process of its
        own (one profiler session per process): an op run inside a host
        span on a worker thread lands inside that span once merged."""
        import subprocess
        import sys

        code = r"""
import json, os, sys, threading, time, torch
from torch.profiler import record_function
from dvf_tpu_torch.obs.export import DEVICE_TRACE_FILE, start_device_profiler
from dvf_tpu_torch.obs.trace import MERGED_TRACE_NAME, Tracer, merge_with_device_trace
d = sys.argv[1]
tracer = Tracer(enabled=True, process_name="pipeline")
prof = start_device_profiler()
try:
    def work():
        t0 = time.perf_counter()
        with record_function("dvf_marked_step"):
            x = torch.ones(64, 64)
            for _ in range(4):
                x = x @ x
        tracer.complete("batch_complete", t0, time.perf_counter(), 1)
    th = threading.Thread(target=work)
    th.start()
    th.join()
finally:
    prof.stop()
prof.export_chrome_trace(os.path.join(d, DEVICE_TRACE_FILE))
host = tracer.export(os.path.join(d, "host.pftrace"))
out = merge_with_device_trace(host, d, os.path.join(d, MERGED_TRACE_NAME),
                              0, host_start_s=tracer.start_time)
print(json.dumps({"out": out}))
"""
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                             capture_output=True, text=True, timeout=300,
                             env=env, cwd=str(tmp_path))
        assert res.returncode == 0, res.stderr[-2000:]
        out = json.loads(res.stdout.strip().splitlines()[-1])["out"]
        assert out == str(tmp_path / MERGED_TRACE_NAME)
        doc = json.loads(open(out).read())
        span = next(e for e in doc["traceEvents"]
                    if e.get("name") == "batch_complete")
        marks = [e for e in doc["traceEvents"]
                 if e.get("name") == "dvf_marked_step"
                 and e.get("ph") == "X"]
        assert marks and all(e["pid"] >= 10000 for e in marks)
        mark = marks[0]
        # Alignment within 1 ms (host and profiler clocks are read by
        # different calls).
        assert span["ts"] - 1000 <= mark["ts"]
        assert mark["ts"] + mark["dur"] <= span["ts"] + span["dur"] + 1000


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


class TestFlightRecorder:
    def test_dump_artifacts_and_rate_limit(self, tmp_path):
        t = Tracer(enabled=True, process_name="w")
        t.instant("ev", ts=t.perf_start)
        ring = TimeSeriesRing(lambda: {"fps": 1.0}, interval_s=10.0)
        ring.sample_once()
        fr = FlightRecorder(
            str(tmp_path), label="t", min_interval_s=60.0,
            trace_fn=lambda: [t.snapshot()],
            stats_fn=lambda: {"errors": 0}, ring=ring)
        d = fr.trigger("watchdog stall: oldest 1.2s")
        assert d is not None and os.path.isdir(d)
        assert sorted(os.listdir(d)) == ["meta.json", "stats.json",
                                         "timeseries.json", "trace.pftrace"]
        meta = json.loads(open(os.path.join(d, "meta.json")).read())
        assert meta["reason"].startswith("watchdog stall")
        assert "watchdog-stall" in os.path.basename(d)
        assert fr.trigger("again") is None
        assert fr.suppressed == 1
        assert fr.stats()["dumps"] == 1

    def test_partial_sources_still_dump(self, tmp_path):
        fr = FlightRecorder(
            str(tmp_path), min_interval_s=0.0,
            trace_fn=lambda: (_ for _ in ()).throw(RuntimeError("gone")),
            stats_fn=lambda: {"ok": 1})
        d = fr.trigger("loss")
        assert sorted(os.listdir(d)) == ["meta.json", "stats.json"]
        assert fr.dump_errors == 1

    def test_max_dumps_cap(self, tmp_path):
        fr = FlightRecorder(str(tmp_path), min_interval_s=0.0, max_dumps=2)
        assert fr.trigger("a") and fr.trigger("b")
        assert fr.trigger("c") is None

    def test_byte_cap_evicts_oldest(self, tmp_path):
        fr = FlightRecorder(str(tmp_path), min_interval_s=0.0,
                            stats_fn=lambda: {"pad": "x" * 4000},
                            max_total_bytes=6000)
        first = fr.trigger("one")
        second = fr.trigger("two")
        assert not os.path.exists(first) and os.path.isdir(second)
        assert fr.stats()["evicted_dumps"] == 1

    def test_dump_file_set_and_keys_match_reference(self, tmp_path):
        """Cross-package: the same sources give the same dump file set,
        the same document keys and the same directory-name pattern."""
        from dvf_tpu.obs import export as ref_export
        from dvf_tpu.obs import registry as ref_registry
        from dvf_tpu.obs import trace as ref_trace

        def dump(export_mod, registry_mod, trace_mod, where):
            t = trace_mod.Tracer(enabled=True, process_name="serve")
            base = getattr(t, "perf_start", t.start_time)
            t.complete("serve_dispatch", base, base + 0.01)
            ring = registry_mod.TimeSeriesRing(lambda: {"fps": 2.0},
                                               interval_s=10.0)
            ring.sample_once()
            fr = export_mod.FlightRecorder(
                str(where), label="serve", min_interval_s=0.0,
                trace_fn=lambda: [t.snapshot()],
                stats_fn=lambda: {"errors": 0, "faults": {"total": 0}},
                ring=ring, lineage_fn=lambda: {"summary": {}, "explain": {},
                                               "exemplars": []},
                ledger_fn=lambda: {"events": [], "events_total": 0},
                audit_fn=lambda: {"confirmed_corruptions_total": 0,
                                  "events": []})
            d = fr.trigger("audit: first confirmed silent corruption")
            files = sorted(os.listdir(d))
            keys = {f: sorted(json.load(open(os.path.join(d, f))))
                    for f in files}
            return os.path.basename(d).split("-", 3)[-1], files, keys, \
                sorted(fr.stats())

        ours = dump(importlib.import_module("dvf_tpu_torch.obs.export"),
                    importlib.import_module("dvf_tpu_torch.obs.registry"),
                    importlib.import_module("dvf_tpu_torch.obs.trace"),
                    tmp_path / "ours")
        ref = dump(ref_export, ref_registry, ref_trace, tmp_path / "ref")
        assert ours == ref
        assert ours[1] == ["audit.json", "ledger.json", "lineage.json",
                           "meta.json", "stats.json", "timeseries.json",
                           "trace.pftrace"]

    def test_profile_window_writes_device_trace(self, tmp_path):
        """flight_profile_s: a short torch.profiler window lands in the
        dump as device_trace/trace.json; the one-session lock is free
        again afterwards."""
        fr = FlightRecorder(str(tmp_path), min_interval_s=0.0,
                            stats_fn=lambda: {}, profile_s=0.05)
        d = fr.trigger("manual")
        assert FlightRecorder._profiling.acquire(timeout=120)
        FlightRecorder._profiling.release()
        p = os.path.join(d, "device_trace", "trace.json")
        assert os.path.exists(p), fr.stats()
        assert "traceEvents" in json.load(open(p))
        assert fr.stats()["dump_errors"] == 0


class TestServeFlightTriggers:
    def test_watchdog_trip_dumps(self, tmp_path):
        chaos = FaultPlan().add("freeze", at=(3,), delay_s=1.2)
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=4, queue_size=1000, slo_ms=60_000.0,
                        stall_timeout_s=0.35, chaos=chaos, trace=True,
                        telemetry_sample_s=0.1, flight_dir=str(tmp_path),
                        flight_min_interval_s=0.0))
        with fe:
            sid = fe.open_stream()
            i = 0
            deadline = time.time() + 30.0
            while fe.recoveries < 1:
                assert time.time() < deadline, "watchdog never tripped"
                fe.submit(sid, tagged_frame(0, i))
                i += 1
                fe.poll(sid)
                time.sleep(0.01)
            _wait(lambda: fe.flight.stats()["dumps"] >= 1, deadline_s=30.0)
            stats = fe.stats()
        assert stats["flight"]["dumps"] >= 1
        dump = sorted(tmp_path.iterdir())[0]
        assert "stall" in dump.name
        merged = json.loads((dump / "trace.pftrace").read_text())
        assert any(e.get("ph") == "X" for e in merged["traceEvents"])
        assert "sessions" in json.loads((dump / "stats.json").read_text())

    def test_slo_burn_rate_dumps(self, tmp_path):
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=2, queue_size=100, slo_ms=50.0,
                        telemetry_sample_s=30.0, slo_burn_threshold=0.5,
                        flight_dir=str(tmp_path), flight_min_interval_s=0.0))
        with fe:
            assert fe.telemetry.on_sample == fe._on_telemetry_sample
            fe._check_slo_burn({"delivered_total": 0, "slo_miss_total": 0},
                               {"delivered_total": 10, "slo_miss_total": 1})
            assert fe.flight.stats()["dumps"] == 0
            fe._check_slo_burn({"delivered_total": 10, "slo_miss_total": 1},
                               {"delivered_total": 20, "slo_miss_total": 9})
            st = fe.flight.stats()
        assert st["dumps"] == 1
        assert "slo burn rate" in st["last_reason"]
        assert "slo-burn-rate" in sorted(tmp_path.iterdir())[0].name
        fe._check_slo_burn({"delivered_total": 20, "slo_miss_total": 9},
                           {"delivered_total": 20, "slo_miss_total": 9})
        assert fe.flight.stats()["dumps"] == 1

    def test_flight_dir_arms_the_telemetry_ring(self, tmp_path):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(flight_dir=str(tmp_path)))
        assert fe.telemetry is not None and fe.telemetry.interval_s == 1.0
        assert fe.flight.ring is fe.telemetry
        fe.stop()

    def test_budget_exhaustion_failure_dumps(self, tmp_path):
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                        resilient=False, telemetry_sample_s=0.0,
                        flight_dir=str(tmp_path), flight_min_interval_s=0.0))
        fe.start()
        try:
            sid = fe.open_stream()
            for j in range(2):
                fe.submit(sid, tagged_frame(0, j))
            drain(fe, sid, 2)

            def dead_step(*a, **k):
                raise RuntimeError("engine died (forced)")

            fe.engine._step = dead_step
            deadline = time.time() + 30.0
            while fe._error is None and time.time() < deadline:
                try:
                    fe.submit(sid, tagged_frame(0, 99))
                except ServeError:
                    break
                time.sleep(0.01)
            _wait(lambda: fe.flight.stats()["dumps"] >= 1, deadline_s=30.0)
            assert "frontend failed" in fe.flight.stats()["last_reason"]
        finally:
            try:
                fe.stop()
            except Exception:  # noqa: BLE001 — fail-fast stop re-raises
                pass           # the stored engine error, as designed


class TestPipelineFlight:
    def test_pipeline_failure_dumps(self, tmp_path):
        from dvf_tpu_torch.io.sinks import NullSink
        from dvf_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig

        pipe = Pipeline([], get_filter("invert"), NullSink(),
                        PipelineConfig(flight_dir=str(tmp_path),
                                       flight_min_interval_s=0.0),
                        device="cpu")
        assert pipe.flight is not None
        pipe._fail(RuntimeError("forced"))
        _wait(lambda: pipe.flight.stats()["dumps"] == 1, deadline_s=30.0)
        st = pipe.flight.stats()
        assert "pipeline failed" in st["last_reason"]
        dump = sorted(tmp_path.iterdir())[0]
        assert (dump / "meta.json").exists()
        assert (dump / "stats.json").exists()

    def test_pipeline_registry_scrapes_signals(self):
        from dvf_tpu_torch import NullSink, Pipeline, PipelineConfig, SyntheticSource

        pipe = Pipeline(SyntheticSource(16, 16, n_frames=8),
                        get_filter("invert"), NullSink(),
                        PipelineConfig(batch_size=4, queue_size=100),
                        device="cpu")
        pipe.run()
        text = pipe.registry.to_prometheus()
        assert "dvf_pipeline_delivered_total 8" in text
        assert "dvf_pipeline_engine_batches_total" in text


class TestExportSchemas:
    def _assert_clean(self, label, doc):
        bad = walk_export(doc)
        assert not bad, (label, bad)

    def test_serve_and_pipeline_exports_with_planes(self, tmp_path):
        from dvf_tpu_torch import NullSink, Pipeline, PipelineConfig

        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(telemetry_sample_s=0.0, audit=True,
                                       lineage=True,
                                       flight_dir=str(tmp_path / "f")))
        with fe:
            sid = fe.open_stream()
            fe.open_stream(op_chain="grayscale", frame_shape=(H, W, 3))
            fe.submit(sid, tagged_frame(0, 0))
            drain(fe, sid, 1)
            st = fe.stats()
            assert {"audit", "attribution", "flight"} <= set(st)
            self._assert_clean("serve.stats", st)
            self._assert_clean("serve.signals", fe.signals())
            self._assert_clean("serve.health", fe.health())
            self._assert_clean("serve.explain", fe.explain())
            self._assert_clean("audit.document", fe.audit.document())
        pipe = Pipeline([], get_filter("invert"), NullSink(),
                        PipelineConfig(), device="cpu")
        self._assert_clean("pipeline.stats", pipe.stats())
        self._assert_clean("pipeline.signals", pipe.signals())

    def test_worker_exports(self):
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        worker = ZmqWorker(get_filter("invert"), wire="delta", batch_size=2,
                           raw_size=H, audit_wire=True, device="cpu",
                           connect=False, codec_threads=1)
        try:
            self._assert_clean("worker.stats", worker.stats())
            self._assert_clean("worker.signals", worker.signals())
            self._assert_clean("worker.audit", worker.audit_document())
        finally:
            worker.close()

    @pytest.mark.fleet
    def test_fleet_exports(self):
        from dvf_tpu_torch.fleet import FleetConfig

        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=2, mode="local",
                        serve=ServeConfig(telemetry_sample_s=0.0)))
        # Unstarted: rows render with state=dead, the same shape the
        # live export has, without building two frontends.
        self._assert_clean("fleet.stats", fleet.stats())
        self._assert_clean("fleet.signals", fleet.signals())


@pytest.mark.fleet
class TestFleetMetricsEndpoint:
    def test_fleet_merged_metrics_with_replica_labels(self):
        """/metrics against a running fleet returns fleet-merged
        p50/p99, per-replica queue depth, and per-kind fault counters
        with replica labels."""
        from dvf_tpu_torch.fleet import FleetConfig

        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(
                replicas=2, mode="local",
                serve=ServeConfig(batch_size=4, queue_size=1000,
                                  out_queue_size=1000, slo_ms=60_000.0,
                                  telemetry_sample_s=0.0),
                chaos_spec="compute:at=1:count=1",
                telemetry_sample_s=0.1))
        with fleet:
            sids = [fleet.open_stream() for _ in range(2)]
            for j in range(16):
                for k, sid in enumerate(sids):
                    fleet.submit(sid, tagged_frame(k, j))
                time.sleep(0.01)
            deliveries: dict = {}
            deadline = time.time() + 30.0
            while time.time() < deadline:
                for sid in sids:
                    deliveries.setdefault(sid, []).extend(fleet.poll(sid))
                st = fleet.stats()
                if (all(deliveries.get(s) for s in sids)
                        and len(st["faults"].get("by_replica", {})) >= 1):
                    break
                time.sleep(0.02)
            with MetricsExporter(fleet.registry, ring=fleet.telemetry) as ex:
                text = _get(f"{ex.url}/metrics")
        assert "dvf_fleet_p50_ms " in text
        assert "dvf_fleet_p99_ms " in text
        assert "dvf_fleet_delivered_total " in text
        assert 'dvf_fleet_replica_delivered_total{replica="r0"} ' in text
        for rid in ("r0", "r1"):
            assert f'dvf_fleet_replica_queue_depth{{replica="{rid}"}} ' \
                in text, (rid, text)
            assert f'dvf_fleet_replica_up{{replica="{rid}"}} 1' in text
        assert 'dvf_fleet_replica_faults_total{kind="compute",replica="' \
            in text, text


@pytest.mark.fleet
class TestProcessReplicaTrace:
    def test_trace_snapshot_crosses_the_rpc(self):
        """A process replica's tracer snapshot crosses the pickle RPC
        with a foreign pid and merges into the front door's session."""
        from dvf_tpu_torch.fleet import FleetConfig

        fleet = FleetFrontend(config=FleetConfig(
            replicas=1, mode="process", filter_spec=("invert", {}),
            serve=ServeConfig(batch_size=2, queue_size=100,
                              slo_ms=60_000.0, trace=True,
                              telemetry_sample_s=0.0),
            startup_timeout_s=180.0))
        with fleet:
            sid = fleet.open_stream()
            for j in range(4):
                fleet.submit(sid, tagged_frame(0, j))
            deliveries = []
            deadline = time.time() + 60.0
            while len(deliveries) < 4 and time.time() < deadline:
                deliveries += fleet.poll(sid)
                time.sleep(0.01)
            assert len(deliveries) == 4
            snaps = fleet.trace_snapshots()
        lanes = {s["process_name"]: s for s in snaps}
        assert "serve:r0" in lanes, lanes.keys()
        worker_snap = lanes["serve:r0"]
        assert worker_snap["pid"] != os.getpid()  # crossed the boundary
        assert any(e["name"] == "batch_complete"
                   for e in worker_snap["events"])
        assert merge_tracer_snapshots(snaps) is not None


@pytest.mark.fleet
@pytest.mark.chaos
class TestFleetFlightAcceptance:
    def test_chaos_watchdog_trip_dumps_two_replica_lanes(self, tmp_path):
        """A chaos-induced watchdog trip (a frozen collect in a replica,
        recovered by its supervision) produces a fleet flight-recorder
        dump whose merged trace holds lanes from >= 2 replicas on one
        aligned clock."""
        from dvf_tpu_torch.fleet import FleetConfig

        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(
                replicas=2, mode="local",
                serve=ServeConfig(batch_size=4, queue_size=1000,
                                  out_queue_size=1000, slo_ms=60_000.0,
                                  stall_timeout_s=0.35, trace=True,
                                  telemetry_sample_s=0.0),
                # each replica parses its own freeze plan: its collect
                # thread wedges 1.2 s on the 4th iteration, outliving the
                # 0.35 s stall budget
                chaos_spec="freeze:at=3:delay=1.2",
                health_poll_s=0.05,
                flight_dir=str(tmp_path),
                flight_min_interval_s=0.0))
        with fleet:
            sids = [fleet.open_stream() for _ in range(2)]
            i = 0
            deadline = time.time() + 40.0
            while fleet.flight.stats()["dumps"] == 0:
                assert time.time() < deadline, "no flight dump"
                for k, sid in enumerate(sids):
                    fleet.submit(sid, tagged_frame(k, i))
                for sid in sids:
                    fleet.poll(sid)
                i += 1
                time.sleep(0.01)
            st = fleet.stats()
        assert st["flight"]["dumps"] >= 1
        assert "stall" in st["flight"]["last_reason"]
        dump = next(p for p in sorted(tmp_path.iterdir())
                    if "stall" in p.name)
        merged = json.loads((dump / "trace.pftrace").read_text())
        lanes = merged["dvfTraceLanes"]
        replica_lanes = [ln for ln in lanes
                         if ln["process_name"].startswith("serve:r")]
        assert len({ln["process_name"] for ln in replica_lanes}) >= 2, lanes
        assert all(ln["events"] >= 1 for ln in replica_lanes)
        spans = {}
        for ln in replica_lanes:
            base = ln["pid_base"]
            ts = [e["ts"] for e in merged["traceEvents"]
                  if e.get("ph") in ("X", "i")
                  and base <= e.get("pid", -1) < base + LANE_STRIDE]
            assert ts and min(ts) >= 0
            spans[ln["process_name"]] = (min(ts), max(ts))
        (a0, a1), (b0, b1) = list(spans.values())[:2]
        assert max(a0, b0) <= min(a1, b1), spans
