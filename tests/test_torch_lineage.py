"""The port's frame lineage and latency attribution
(``dvf_tpu_torch.obs.lineage``) on the CPU: counterparts of
``tests/test_lineage.py`` (its fleet cases included; its CLI case
waits for the CLI), plus the cross-package checks: lineage documents, aggregate
summaries and explain lines, and stage-profile JSON byte-equal to
``dvf_tpu``'s for the same inputs, and profile files that the two
packages never share.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

from dvf_tpu_torch.obs.lineage import (
    SERVE_COMPONENTS,
    AttributionAggregate,
    AttributionPlane,
    FrameLineage,
    load_stage_profile,
    save_stage_profile,
)
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.serve import ServeConfig
from torch_serve_util import (  # noqa: F401
    FleetFrontend,
    ServeFrontend,
    port_fleet_guard,
    port_leak_guard,
)

pytestmark = pytest.mark.lineage

H, W = 16, 24


def frame_u8(k: int, j: int) -> np.ndarray:
    f = np.full((H, W, 3), 7, np.uint8)
    f[0] = k
    f[1] = j % 251
    return f


def drain(fe, sid, want, deadline_s=30.0):
    got = []
    deadline = time.time() + deadline_s
    while len(got) < want and time.time() < deadline:
        got += fe.poll(sid)
        time.sleep(0.005)
    return got


def _seeded_rows(seed, n=200):
    """Seeded (total, components) rows with a slow tail."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        comps = {name: float(rng.gamma(2.0, 1.5))
                 for name in SERVE_COMPONENTS}
        if i % 37 == 0:
            comps["queue_bucket"] += float(rng.uniform(50, 120))
        rows.append((sum(comps.values()), comps))
    return rows


# ---------------------------------------------------------------------------
# Golden unit layer: the additivity invariant + clock re-base
# ---------------------------------------------------------------------------


class TestFrameLineageGolden:
    def test_components_telescope_to_total(self):
        lin = FrameLineage("s0", 7, ts=1000.0)
        lin.mark("queue_ingress", 1000.010)
        lin.mark("queue_bucket", 1000.050)
        lin.mark("assemble_h2d", 1000.065)
        lin.mark("device", 1000.165)
        lin.mark("d2h", 1000.170)
        lin.mark("deliver", 1000.172)
        comps = lin.components_ms()
        assert comps == pytest.approx({
            "queue_ingress": 10.0, "queue_bucket": 40.0,
            "assemble_h2d": 15.0, "device": 100.0,
            "d2h": 5.0, "deliver": 2.0}, abs=1e-6)
        assert lin.total_ms() == pytest.approx(172.0, abs=1e-6)
        assert sum(comps.values()) == pytest.approx(lin.total_ms(), abs=1e-9)
        doc = lin.to_dict()
        assert doc["session"] == "s0" and doc["index"] == 7
        json.dumps(doc)

    def test_repeated_component_accumulates(self):
        lin = FrameLineage("s", 0, ts=0.0)
        lin.mark("queue_ingress", 0.010)
        lin.mark("queue_ingress", 0.015)
        assert lin.components_ms() == pytest.approx(
            {"queue_ingress": 15.0}, abs=1e-9)

    def test_rebase_preserves_decomposition(self):
        lin = FrameLineage("s", 0, ts=1000.0)
        lin.mark("queue_ingress", 1000.020)
        lin.mark("deliver", 1000.100)
        before = lin.components_ms()
        lin.rebase(-2.5)
        assert lin.ts == pytest.approx(997.5)
        assert lin.components_ms() == pytest.approx(before, abs=1e-6)
        assert lin.total_ms() == pytest.approx(100.0, abs=1e-6)
        lin.mark("rpc", 997.650)
        comps = lin.components_ms()
        assert comps["rpc"] == pytest.approx(50.0, abs=1e-6)
        assert sum(comps.values()) == pytest.approx(lin.total_ms(), abs=1e-9)

    def test_rebase_zero_is_noop(self):
        lin = FrameLineage("s", 0, ts=5.0)
        lin.mark("deliver", 6.0)
        marks = list(lin.marks)
        lin.rebase(0.0)
        assert lin.marks == marks and lin.ts == 5.0

    @pytest.mark.parametrize("seed", [0, 3])
    def test_lineage_document_matches_reference(self, seed):
        """Cross-package: the same marks give the same to_dict bytes
        and the same repr."""
        from dvf_tpu.obs.lineage import FrameLineage as JaxLineage

        rng = np.random.default_rng(seed)
        ts = 1.7e9 + float(rng.uniform(0, 100))
        ours, ref = FrameLineage("s3", 11, ts), JaxLineage("s3", 11, ts)
        t = ts
        for name in SERVE_COMPONENTS + ("encode", "send"):
            t += float(rng.uniform(0, 0.05))
            ours.mark(name, t)
            ref.mark(name, t)
        assert (json.dumps(ours.to_dict(), sort_keys=True)
                == json.dumps(ref.to_dict(), sort_keys=True))
        assert repr(ours) == repr(ref)


class TestAggregateAndExplain:
    def test_percentiles_and_explain_tail_based(self):
        agg = AttributionAggregate(capacity=128)
        for _ in range(99):
            agg.observe(10.0, {"queue_bucket": 1.0, "device": 9.0})
        agg.observe(200.0, {"queue_bucket": 190.0, "device": 10.0})
        s = agg.summary()
        assert s["count"] == 100 and s["window_frames"] == 100
        assert s["components"]["device"]["mean_ms"] == pytest.approx(
            9.01, abs=0.01)
        e = agg.explain(q=99.0)
        assert e["fractions"]["queue_bucket"] > 0.9
        assert e["text"].startswith("p99 = ")
        assert "queue_bucket" in e["text"].split(",")[0]

    def test_empty_aggregate(self):
        agg = AttributionAggregate()
        assert agg.summary() == {"count": 0, "window_frames": 0}
        assert agg.explain() is None

    @pytest.mark.parametrize("seed,q", [(0, 99.0), (1, 50.0), (2, 90.0)])
    def test_summary_and_explain_match_reference(self, seed, q):
        """Cross-package: the same seeded rows give byte-equal summary
        and explain documents."""
        from dvf_tpu.obs.lineage import AttributionAggregate as JaxAgg

        ours, ref = AttributionAggregate(128), JaxAgg(128)
        rows = _seeded_rows(seed)
        for total, comps in rows[:50]:
            ours.observe(total, comps)
            ref.observe(total, comps)
        ours.observe_many(rows[50:])
        ref.observe_many(rows[50:])
        assert (json.dumps(ours.summary(), sort_keys=True)
                == json.dumps(ref.summary(), sort_keys=True))
        assert (json.dumps(ours.explain(q), sort_keys=True)
                == json.dumps(ref.explain(q), sort_keys=True))

    def test_plane_exemplars_breach_and_slow_window(self):
        plane = AttributionPlane(exemplar_capacity=8, window_frames=10,
                                 slow_k=2)
        for i in range(9):
            lin = FrameLineage("s0", i, ts=0.0)
            lin.mark("deliver", 0.001 * (i + 1))
            plane.observe(lin, lin.total_ms(), slo_ms=100.0,
                          bucket_label="b")
        breach = FrameLineage("s0", 99, ts=0.0)
        breach.mark("queue_bucket", 0.150)
        breach.mark("deliver", 0.151)
        plane.observe(breach, breach.total_ms(), slo_ms=100.0,
                      bucket_label="b")
        snap = plane.snapshot()
        recs = snap["exemplars"]
        breaches = [r for r in recs if r["breach"]]
        assert len(breaches) == 1 and breaches[0]["index"] == 99
        assert breaches[0]["slo_ms"] == 100.0
        slow = [r for r in recs if not r["breach"]]
        assert slow and max(r["total_ms"] for r in slow) == \
            pytest.approx(9.0, abs=0.1)
        assert plane.frames_total == 10
        assert plane.exemplars.breaches_total == 1
        sig = plane.signals()
        assert sig["lineage_breaches_total"] == 1.0
        assert "attr_queue_bucket_p99_ms" in sig
        json.dumps(snap)

    def test_plane_snapshot_matches_reference(self):
        """Cross-package: one scripted run of lineages through both
        planes gives the same snapshot and signals."""
        from dvf_tpu.obs.lineage import AttributionPlane as JaxPlane
        from dvf_tpu.obs.lineage import FrameLineage as JaxLineage

        ours = AttributionPlane(exemplar_capacity=8, window_frames=16,
                                slow_k=2)
        ref = JaxPlane(exemplar_capacity=8, window_frames=16, slow_k=2)
        rng = np.random.default_rng(5)
        for i in range(40):
            sid, bucket = f"s{i % 3}", f"b{i % 2}"
            ts = 1000.0 + i
            t = ts + float(rng.uniform(0.001, 0.2))
            pair = []
            for cls in (FrameLineage, JaxLineage):
                lin = cls(sid, i, ts)
                lin.mark("queue_bucket", ts + (t - ts) / 2)
                lin.mark("deliver", t)
                pair.append(lin)
            ours.observe(pair[0], pair[0].total_ms(), 60.0, bucket)
            ref.observe(pair[1], pair[1].total_ms(), 60.0, bucket)
        assert (json.dumps(ours.snapshot(), sort_keys=True)
                == json.dumps(ref.snapshot(), sort_keys=True))
        assert ours.signals() == ref.signals()


class TestStageProfiles:
    def test_save_load_roundtrip_and_merge(self, tmp_path):
        d = str(tmp_path)
        sig = "invert|16x24x3|uint8"
        p = save_stage_profile(d, sig, {"device": {"mean_ms": 10.0}},
                               tick_cost_ms=4.0, count=10)
        assert p is not None and os.path.exists(p)
        doc = load_stage_profile(d, sig)
        assert doc["components_ms"]["device"]["mean_ms"] == 10.0
        assert doc["tick_cost_ms"] == 4.0 and doc["count"] == 10
        save_stage_profile(d, sig, {"device": {"mean_ms": 20.0}},
                           tick_cost_ms=8.0, count=30)
        doc = load_stage_profile(d, sig)
        assert doc["count"] == 40
        assert doc["components_ms"]["device"]["mean_ms"] == \
            pytest.approx(17.5)
        assert doc["tick_cost_ms"] == pytest.approx(7.0)
        save_stage_profile(d, "other|8x8x3|uint8", {}, tick_cost_ms=1.0)
        assert load_stage_profile(d, "other|8x8x3|uint8")[
            "tick_cost_ms"] == 1.0
        assert load_stage_profile(d, sig)["count"] == 40
        assert load_stage_profile(None, sig) is None
        assert load_stage_profile(d, "never-saved") is None

    def test_profile_json_matches_reference_in_a_file_of_its_own(
            self, tmp_path, monkeypatch):
        """Cross-package: the same measurements (and clock) persist to
        byte-equal JSON — but under another file name, so neither
        package ever loads a profile the other measured for the same
        signature."""
        from dvf_tpu.obs import lineage as ref

        monkeypatch.setattr(time, "time", lambda: 1_790_000_000.25)
        sig = "sobel_bilateral|1080x1920x3|uint8"
        comps = {"device": {"mean_ms": 3.25, "p50_ms": 3.0, "p99_ms": 9.5},
                 "queue_bucket": {"mean_ms": 1.5, "p50_ms": 1.0,
                                  "p99_ms": 4.0}}
        ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
        for _ in range(2):   # the second save merges
            a = save_stage_profile(str(ours_dir), sig, comps,
                                   tick_cost_ms=5.5, count=12)
            b = ref.save_stage_profile(str(ref_dir), sig, comps,
                                       tick_cost_ms=5.5, count=12)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert os.path.basename(a) != os.path.basename(b)
        # One shared directory: each package reads only its own.
        shared = str(tmp_path / "shared")
        ref.save_stage_profile(shared, sig, comps, tick_cost_ms=99.0,
                               count=5)
        assert load_stage_profile(shared, sig) is None
        save_stage_profile(shared, sig, comps, tick_cost_ms=1.0, count=5)
        assert load_stage_profile(shared, sig)["tick_cost_ms"] == 1.0
        assert ref.load_stage_profile(shared, sig)["tick_cost_ms"] == 99.0


# ---------------------------------------------------------------------------
# Instrumented serve run: the in-process additivity acceptance
# ---------------------------------------------------------------------------


class TestServeLineage:
    def _frontend(self, **kw):
        cfg = ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                          lineage=True, telemetry_sample_s=0.0, **kw)
        return ServeFrontend(get_filter("invert"), cfg)

    def test_every_delivered_frame_is_additive(self):
        """Every delivered frame's components sum to its measured
        end-to-end latency (one clock read closes both), across every
        serve-path hop."""
        fe = self._frontend()
        with fe:
            sids = [fe.open_stream() for _ in range(2)]
            for j in range(8):
                for k, sid in enumerate(sids):
                    fe.submit(sid, frame_u8(k, j))
            for sid in sids:
                got = drain(fe, sid, 8)
                assert len(got) == 8
                for d in got:
                    lin = d.lineage
                    assert lin is not None
                    comps = lin.components_ms()
                    assert set(comps) == set(SERVE_COMPONENTS), comps
                    assert sum(comps.values()) == pytest.approx(
                        d.latency_ms, abs=1e-6)
                    assert lin.total_ms() == pytest.approx(
                        d.latency_ms, abs=1e-6)
                    assert lin.session_id == sid
                    assert all(v >= 0 for v in comps.values())
            st = fe.stats()
            attr = st["attribution"]
            assert attr["frames_total"] == 16
            assert set(attr["components"]) == set(SERVE_COMPONENTS)
            assert "explain" in attr and attr["explain"]["text"]
            assert any("invert" in k for k in attr["by_bucket"])
            assert set(attr["by_session"]) == set(sids)
            sig = fe.signals()
            assert sig["lineage_frames_total"] == 16.0
            for comp in SERVE_COMPONENTS:
                assert f"attr_{comp}_p99_ms" in sig
            ex = fe.explain()
            assert ex["lineage"] is True and ex["text"]
            from dvf_tpu_torch.obs.registry import walk_export

            for label, doc in (("stats", st), ("signals", sig),
                               ("explain", ex),
                               ("snapshot", fe.attribution.snapshot())):
                bad = walk_export(doc)
                assert not bad, (label, bad)

    def test_additive_across_buckets_and_kernel_chains(self):
        """The same invariant on the stencil chains' buckets (their
        engines run the kernels' plain versions here)."""
        fe = self._frontend()
        with fe:
            a = fe.open_stream(op_chain="gaussian_blur(ksize=9)",
                               frame_shape=(H, W, 3))
            b = fe.open_stream(op_chain="sobel_bilateral",
                               frame_shape=(H, W, 3))
            for j in range(6):
                fe.submit(a, frame_u8(0, j))
                fe.submit(b, frame_u8(1, j))
            for sid in (a, b):
                got = drain(fe, sid, 6)
                assert len(got) == 6
                for d in got:
                    comps = d.lineage.components_ms()
                    assert sum(comps.values()) == pytest.approx(
                        d.latency_ms, abs=1e-6)
            assert len(fe.explain()["by_bucket"]) == 2

    def test_stats_keys_match_reference(self):
        """The attribution document and signal row of one scripted run
        have the reference frontend's keys."""
        import dvf_tpu
        from dvf_tpu.serve import ServeConfig as JaxConfig
        from dvf_tpu.serve import ServeFrontend as JaxFrontend

        def run(fe):
            with fe:
                sid = fe.open_stream(op_chain="invert", frame_shape=(H, W, 3))
                for j in range(4):
                    fe.submit(sid, frame_u8(0, j))
                assert len(drain(fe, sid, 4)) == 4
                attr = fe.stats()["attribution"]
                return (set(attr), set(attr["components"]),
                        set(attr["explain"]), set(attr["by_bucket"]),
                        {k for k in fe.signals()
                         if k.startswith(("attr_", "lineage_"))},
                        set(fe.explain()))

        kw = dict(batch_size=2, queue_size=100, slo_ms=60_000.0,
                  lineage=True, telemetry_sample_s=0.0)
        ours = run(self._frontend())
        ref = run(JaxFrontend(dvf_tpu.get_filter("invert"), JaxConfig(**kw)))
        assert ours == ref

    def test_lineage_off_is_zero_cost_surface(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, queue_size=100,
                                       slo_ms=60_000.0,
                                       telemetry_sample_s=0.0))
        with fe:
            sid = fe.open_stream()
            for j in range(2):
                fe.submit(sid, frame_u8(0, j))
            got = drain(fe, sid, 2)
        assert all(d.lineage is None for d in got)
        assert "attribution" not in fe.stats()
        assert "lineage_frames_total" not in fe.signals()
        assert fe.explain()["lineage"] is False

    def test_explain_endpoint(self):
        from dvf_tpu_torch.obs.export import MetricsExporter

        fe = self._frontend()
        with fe:
            sid = fe.open_stream()
            for j in range(4):
                fe.submit(sid, frame_u8(0, j))
            assert len(drain(fe, sid, 4)) == 4
            with MetricsExporter(fe.registry, health_fn=fe.health,
                                 explain_fn=fe.explain) as ex:
                doc = json.loads(urllib.request.urlopen(
                    f"{ex.url}/explain", timeout=10).read().decode())
        assert doc["lineage"] is True
        assert "fractions" in doc and doc["text"].startswith("p")

    def test_profiles_persist_and_reload(self, tmp_path):
        prof_dir = str(tmp_path / "profiles")
        fe = self._frontend(profile_dir=prof_dir)
        with fe:
            sid = fe.open_stream(op_chain="invert", frame_shape=(H, W, 3))
            for j in range(6):
                fe.submit(sid, frame_u8(0, j))
            assert len(drain(fe, sid, 6)) == 6
        sig = "invert|16x24x3|uint8"
        doc = load_stage_profile(prof_dir, sig)
        assert doc is not None, os.listdir(prof_dir)
        assert doc["tick_cost_ms"] is None or doc["tick_cost_ms"] > 0
        assert "device" in doc["components_ms"]
        # A fresh frontend loads it at bucket creation.
        fe2 = self._frontend(profile_dir=prof_dir)
        try:
            fe2.open_stream(op_chain="invert", frame_shape=(H, W, 3))
            bucket = fe2._bucket_by_key[next(iter(fe2._bucket_by_key))]
            assert bucket.stage_profile is not None
            assert bucket.stage_profile["signature"] == sig
        finally:
            fe2.stop()

    def test_profile_seeds_tick_cost_before_first_sample(self, tmp_path):
        """A bucket with no live sample and no calibration scores by the
        persisted tick cost, not the 1 ms floor."""
        prof_dir = str(tmp_path / "profiles")
        sig = "grayscale|16x24x3|uint8"
        save_stage_profile(prof_dir, sig, {}, tick_cost_ms=7.25, count=0)
        fe = self._frontend(profile_dir=prof_dir)
        try:
            fe.open_stream(op_chain="grayscale", frame_shape=(H, W, 3))
            with fe._lock:
                b = next(x for x in fe._buckets
                         if x.key is not None and x.key.render() == sig)
            b.engine.step_block_ms = None
            assert b.tick_cost_estimate() == 7.25
        finally:
            fe.stop()

    def test_control_decisions_annotated_with_stage_cost(self):
        """The reference's decision-log annotation, through the port's
        plane: a bucket-targeted decision records that bucket's measured
        stage costs."""
        from dvf_tpu_torch.control import ControlConfig, ControlPlane
        from dvf_tpu_torch.control.controllers import Action

        plane = ControlPlane(actuator=None, config=ControlConfig())
        plane.batch.step = lambda row, prev, floor=None: [
            Action("resize", "bkt|16x24x3|uint8", 4, "occupancy")]
        plane.quality.step = lambda row, prev, floor=None: []
        plane.tiers.step = lambda row, prev: []
        cost = {"queue_bucket": 12.5, "device": 3.0}
        actions = plane.decide({
            "buckets": [{"label": "bkt|16x24x3|uint8",
                         "stage_cost_ms": cost}],
            "sessions": []})
        assert len(actions) == 1
        entry = plane.stats()["decisions"][-1]
        assert entry["kind"] == "resize"
        assert entry["stage_cost_ms"] == cost

    def test_control_view_stage_cost_live_then_persisted(self, tmp_path):
        """``control_view()``'s ``stage_cost_ms``: the live attribution
        window's per-component means while lineage runs, else the
        persisted profile's means (rounded as the reference rounds)."""
        from dvf_tpu_torch.control import ControlConfig

        prof_dir = str(tmp_path / "profiles")
        ctl = dict(control=True,
                   control_config=ControlConfig(interval_s=30.0))
        fe = self._frontend(profile_dir=prof_dir, **ctl)
        with fe:
            sid = fe.open_stream(op_chain="invert", frame_shape=(H, W, 3))
            for j in range(6):
                fe.submit(sid, frame_u8(0, j))
            assert len(drain(fe, sid, 6)) == 6
            row = fe.control_view()["buckets"][0]
            live = fe.attribution.bucket_stage_cost_ms(row["label"])
            assert live and row["stage_cost_ms"] == live
            assert "device" in live
        sig = "invert|16x24x3|uint8"
        doc = load_stage_profile(prof_dir, sig)
        cfg = ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                          profile_dir=prof_dir, **ctl)
        fe2 = ServeFrontend(get_filter("invert"), cfg)
        try:
            fe2.open_stream(op_chain="invert", frame_shape=(H, W, 3))
            row = next(b for b in fe2.control_view()["buckets"]
                       if b["label"] == sig)
            assert row["stage_cost_ms"] == {
                k: round(float(v["mean_ms"]), 4)
                for k, v in doc["components_ms"].items()}
        finally:
            fe2.stop()


# ---------------------------------------------------------------------------
# Chaos acceptance: SLO-breach dump attributes the injected stage
# ---------------------------------------------------------------------------


@pytest.mark.chaos
class TestBreachAttribution:
    def test_slo_breach_dump_names_the_injected_stage(self, tmp_path,
                                                      monkeypatch):
        """A chaos-injected h2d delay makes one bucket slow, frames
        breach their SLO, the burn-rate trigger dumps — and the dump's
        lineage.json exemplars attribute the breach to the injected
        stage (assemble_h2d dominates each breach)."""
        import dvf_tpu_torch.runtime.ingest as ingest_mod
        from dvf_tpu_torch.resilience import FaultPlan

        # Keep the streamed path (and its h2d injection site) on the CPU.
        monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
        # ingest_depth 4 → four row chunks per batch: 4 × 0.06 s ≈ 0.24 s
        # of assemble_h2d per batch of 8 (the reference's eight 1-row
        # chunks × 0.03 s).
        chaos = FaultPlan().add("h2d", every=1, delay_s=0.06)
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=8, queue_size=100, slo_ms=50.0,
                        lineage=True, chaos=chaos, telemetry_sample_s=0.1,
                        slo_burn_threshold=0.5, flight_dir=str(tmp_path),
                        flight_min_interval_s=0.0))
        with fe:
            sid = fe.open_stream()
            i = 0
            deadline = time.time() + 30.0
            while fe.flight.stats()["dumps"] == 0:
                assert time.time() < deadline, "burn trigger never fired"
                fe.submit(sid, frame_u8(0, i))
                i += 1
                fe.poll(sid)
                time.sleep(0.02)
        dump = next(p for p in sorted(tmp_path.iterdir())
                    if "slo-burn" in p.name)
        lin = json.loads((dump / "lineage.json").read_text())
        breaches = [r for r in lin["exemplars"] if r.get("breach")]
        assert breaches, lin["exemplars"]
        for rec in breaches:
            comps = rec["components"]
            assert max(comps, key=comps.get) == "assemble_h2d", comps
            assert sum(comps.values()) == pytest.approx(rec["total_ms"],
                                                        abs=0.01)
        assert "assemble_h2d" in lin["explain"]["text"].split(",")[0]


# ---------------------------------------------------------------------------
# The worker's batch attribution
# ---------------------------------------------------------------------------


def test_worker_batch_attribution_is_additive():
    """Every worker batch folds assemble_h2d / device / d2h, summing to
    the batch wall; stats()['attribution'] explains it."""
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    w = ZmqWorker(get_filter("invert"), batch_size=2, use_jpeg=False,
                  raw_size=16, device="cpu", connect=False)
    try:
        f = np.zeros((16, 16, 3), np.uint8).tobytes()
        for s in (0, 2, 4):
            w.process_batch([(s, f), (s + 1, f)], lambda *a: None)
        w.drain_egress()
        rows = w.attribution.rows()
        assert len(rows) == 3
        for total, comps in rows:
            assert set(comps) == {"assemble_h2d", "device", "d2h"}
            assert sum(comps.values()) == pytest.approx(total, abs=1e-6)
        st = w.stats()["attribution"]
        assert st["count"] == 3 and st["explain"]["text"].startswith("p99")
    finally:
        w.close()


# ---------------------------------------------------------------------------
# trace-view (offline summaries)
# ---------------------------------------------------------------------------


class TestTraceView:
    def _trace_file(self, tmp_path, pkg="dvf_tpu_torch"):
        import importlib

        trace = importlib.import_module(f"{pkg}.obs.trace")
        t = trace.Tracer(enabled=True, process_name="serve:r0")
        t.start_time = 1000.0
        t.perf_start = 1000.0  # the port's stamp origin (the reference has none)
        t.complete("serve_dispatch", 1000.0, 1000.050, track=0)
        t.complete("batch_complete", 1000.010, 1000.100, track=1)
        t.instant("frame_captured", ts=1000.0, track=0)
        path = str(tmp_path / f"trace-{pkg}.pftrace")
        trace.merge_tracer_snapshots([t.snapshot()], out_path=path)
        return path

    def test_summarize_trace(self, tmp_path):
        from dvf_tpu_torch.obs.viewer import summarize

        s = summarize(self._trace_file(tmp_path), top=5)
        assert s["events"] == 3
        lanes = {row["lane"]: row for row in s["lanes"]}
        assert "serve:r0" in lanes and "serve:r0/1" in lanes
        dev = lanes["serve:r0/1"]
        assert dev["busy_ms"] == pytest.approx(90.0)
        assert dev["utilization"] == pytest.approx(1.0)
        assert s["slowest_spans"][0]["name"] == "batch_complete"
        assert s["slowest_spans"][0]["dur_ms"] == pytest.approx(90.0)

    def _dump(self, tmp_path, pkg="dvf_tpu_torch"):
        d = tmp_path / f"dump-{pkg}"
        d.mkdir()
        os.rename(self._trace_file(tmp_path, pkg), d / "trace.pftrace")
        (d / "meta.json").write_text(json.dumps(
            {"reason": "slo burn rate 0.8 >= 0.5", "pid": 1,
             "utc": "2026-01-01T00:00:00Z"}))
        (d / "lineage.json").write_text(json.dumps({
            "explain": {"text": "p99 = 90% queue_bucket, 10% device"},
            "exemplars": [
                {"session": "s0", "index": 5, "total_ms": 120.0,
                 "breach": True, "slo_ms": 50.0,
                 "components": {"queue_bucket": 110.0, "device": 10.0}},
                {"session": "s1", "index": 2, "total_ms": 30.0,
                 "breach": False, "slo_ms": 50.0,
                 "components": {"device": 30.0}},
            ]}))
        (d / "audit.json").write_text(json.dumps({
            "replays_sampled_total": 4, "confirmed_corruptions_total": 1,
            "events": [{"kind": "shadow_replay", "verdict": "mismatch",
                        "session": "s0", "index": 3, "bucket": "b",
                        "max_abs_diff": 64.0}]}))
        return d

    def test_summarize_dump_with_lineage(self, tmp_path):
        from dvf_tpu_torch.obs.viewer import render_text, summarize

        s = summarize(str(self._dump(tmp_path)), top=5)
        assert s["meta"]["reason"].startswith("slo burn")
        assert s["explain"].startswith("p99 = 90% queue_bucket")
        assert [r["index"] for r in s["lineages"]] == [5, 2]
        text = render_text(s)
        assert "SLO-BREACH" in text
        assert "queue_bucket=110.0" in text
        assert "slowest spans:" in text
        assert "audit verdicts" in text

    def test_summaries_match_reference(self, tmp_path):
        """Cross-package: the same dump renders to the same summary and
        text in both packages' viewers."""
        from dvf_tpu.obs import viewer as ref
        from dvf_tpu_torch.obs import viewer as ours

        a = ours.summarize(str(self._dump(tmp_path, "dvf_tpu_torch")))
        b = ref.summarize(str(self._dump(tmp_path, "dvf_tpu")))
        a.pop("dump")
        b.pop("dump")
        assert a == b
        assert ours.render_text(a) == ref.render_text(b)

    def test_cli_subcommand(self, tmp_path, capsys):
        """`python -m dvf_tpu_torch trace-view`: the text view, --json, and
        rc 2 on a missing or a bad path; the same text as the reference
        CLI on the same file."""
        from dvf_tpu.cli import main as ref_main
        from dvf_tpu_torch.cli import main

        path = self._trace_file(tmp_path)
        assert main(["trace-view", path]) == 0
        out = capsys.readouterr().out
        assert "serve:r0" in out and "slowest spans:" in out
        assert ref_main(["trace-view", path]) == 0
        assert capsys.readouterr().out == out
        assert main(["trace-view", path, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["events"] == 3
        assert main(["trace-view", str(tmp_path / "missing")]) == 2
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        assert main(["trace-view", str(bad)]) == 2
        assert main(["trace-view", str(self._dump(tmp_path))]) == 0
        assert "SLO-BREACH" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Cross-process: lineage over the ProcessReplica RPC
# ---------------------------------------------------------------------------


@pytest.mark.fleet
class TestFleetLineage:
    def test_additivity_across_a_process_replica_hop(self):
        """Lineage crosses the ProcessReplica RPC, is re-based onto the
        front door's clock, gains the rpc component, and the components
        still sum to the end-to-end latency within tolerance."""
        from dvf_tpu_torch.fleet import FleetConfig

        fleet = FleetFrontend(config=FleetConfig(
            replicas=1, mode="process", filter_spec=("invert", {}),
            serve=ServeConfig(batch_size=2, queue_size=100,
                              slo_ms=60_000.0, lineage=True,
                              telemetry_sample_s=0.0),
            startup_timeout_s=180.0))
        with fleet:
            sid = fleet.open_stream()
            submit_ts = {}
            for j in range(4):
                ts = time.time()
                idx = fleet.submit(sid, frame_u8(0, j), ts=ts)
                submit_ts[idx] = ts
            deliveries = []
            deadline = time.time() + 60.0
            while len(deliveries) < 4 and time.time() < deadline:
                deliveries += fleet.poll(sid)
                time.sleep(0.01)
            assert len(deliveries) == 4
        for d in deliveries:
            lin = d.lineage
            assert lin is not None
            comps = lin.components_ms()
            assert set(SERVE_COMPONENTS) <= set(comps), comps
            assert "rpc" in comps
            assert sum(comps.values()) == pytest.approx(lin.total_ms(),
                                                        abs=1e-6)
            wall_ms = (lin.marks[-1][1] - submit_ts[d.index]) * 1e3
            assert lin.total_ms() == pytest.approx(wall_ms, abs=250.0)

    def test_fleet_explain_fans_out_replicas(self):
        from dvf_tpu_torch.fleet import FleetConfig

        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=1, mode="local",
                        serve=ServeConfig(batch_size=2, queue_size=100,
                                          slo_ms=60_000.0, lineage=True,
                                          telemetry_sample_s=0.0)))
        with fleet:
            sid = fleet.open_stream()
            for j in range(4):
                fleet.submit(sid, frame_u8(0, j))
            got = []
            deadline = time.time() + 30.0
            while len(got) < 4 and time.time() < deadline:
                got += fleet.poll(sid)
                time.sleep(0.01)
            assert len(got) == 4
            doc = fleet.explain()
            st = fleet.stats()
        assert doc["lineage"] is True
        assert "r0" in doc["replicas"], doc
        assert doc["replicas"]["r0"]["text"].startswith("p")
        assert "attribution" in st["replicas"]["r0"]
