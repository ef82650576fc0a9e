"""The port's observability planes (``dvf_tpu_torch.obs``) on the CPU:
counterparts of ``tests/test_obs.py``'s metric-name, registry,
time-series-ring and serve-endpoint tests and of ``tests/test_ledger.py``'s
ledger, leak-trend and serve-ledger tests (without their lineage and
flight-recorder cases: those planes are not ported yet), plus parity of
the ledger's event kinds and causes with the JAX package.
"""

import gc
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dvf_tpu_torch.obs import ledger as ledger_mod
from dvf_tpu_torch.obs.export import (
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
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.resilience import FaultPlan
from dvf_tpu_torch.serve import ServeConfig
from torch_serve_util import ServeFrontend, port_leak_guard  # noqa: F401

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
        telemetry hook trips the leak watch once (the reference also
        dumps its flight recorder there; not ported yet)."""
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


@pytest.mark.parametrize("option,value", [
    ("audit", True), ("lineage", True), ("flight_dir", "flight"),
    ("flight_profile_s", 1.0), ("profile_dir", "profiles"),
    ("control", True), ("autoplan", True), ("plan_cache_dir", "plans"),
])
def test_unported_plane_options_raise(option, value):
    """Every ServeConfig option whose plane is not ported raises at
    construction, naming the ROADMAP item that ports it — never runs
    silently without its plane; the default config runs."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        ServeConfig(**{option: value})
    cfg = ServeConfig()
    setattr(cfg, option, value)   # changed after construction: the
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # frontend
        ServeFrontend(get_filter("invert"), cfg)                # refuses


def test_unported_surfaces_raise():
    fe = ServeFrontend(get_filter("invert"), ServeConfig(batch_size=2))
    with fe:
        for call in (lambda: fe.audit_probe(), lambda: fe.explain(),
                     lambda: fe.subscribe("ch"),
                     lambda: fe.open_stream(publish="ch")):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                call()
