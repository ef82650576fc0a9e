"""Spans inside the port on one clock: the tracer's perf_counter stamps and
its wall anchor, the pipeline's dispatch and collect lanes, the engine's
timed step, the monolithic egress counter and the train step's phases.
All on the CPU; CUDA events are stubbed where the card's path is checked."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

import dvf_tpu_torch
from dvf_tpu_torch.io import NullSink, SyntheticSource
from dvf_tpu_torch.obs.metrics import EgressStats
from dvf_tpu_torch.obs.trace import Tracer
from dvf_tpu_torch.runtime import egress as egress_mod
from dvf_tpu_torch.runtime import ingest as ingest_mod
from dvf_tpu_torch.runtime.egress import ShardedBatchFetcher
from dvf_tpu_torch.runtime.engine import BatchResult, Engine
from dvf_tpu_torch.runtime.pipeline import (
    TRACK_COLLECT,
    TRACK_DISPATCH,
    Pipeline,
    PipelineConfig,
)


class StubEvent:
    """``torch.cuda.Event`` on the CPU: counts the timing events made."""

    made = []

    def __init__(self, enable_timing=False, **_):
        self.enable_timing = enable_timing
        self.done = True
        StubEvent.made.append(self)

    def record(self, stream=None):
        pass

    def query(self):
        return self.done

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5


class StubStream:
    def wait_event(self, ev):
        pass


# Spans read back to the µs the export keeps.
US = 2e-6


@pytest.fixture
def stub_cuda(monkeypatch):
    StubEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", StubEvent)
    return StubEvent


# ---------------------------------------------------------------------------
# One clock
# ---------------------------------------------------------------------------


def test_tracer_stamps_perf_counter_and_exports_past_its_wall_anchor(tmp_path):
    t = Tracer(enabled=True, process_name="p")
    assert abs(t.perf_of_wall(t.start_time) - t.perf_start) < 1e-9
    t0 = time.perf_counter()
    t.complete("span", t0, t0 + 0.25, track=5, seq=3)
    t.instant("mark", track=1)          # stamped now, on the same clock
    path = t.export(str(tmp_path / "t.pftrace"))
    doc = json.loads(open(path).read())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    span = next(e for e in doc["traceEvents"] if e["name"] == "span")
    assert set(span) == {"name", "ph", "ts", "dur", "pid", "tid", "args"}
    assert span["dur"] == 250_000 and span["pid"] == 5 and span["args"] == {"seq": 3}
    # µs past the wall epoch: the same offset the wall clock would give.
    assert span["ts"] == pytest.approx((t0 - t.perf_start) * 1e6, abs=1)
    mark = next(e for e in doc["traceEvents"] if e["name"] == "mark")
    assert span["ts"] <= mark["ts"] <= span["ts"] + 10_000_000
    (name, s0, s1, track, args), = t.spans()
    assert (name, track, args) == ("span", 5, {"seq": 3})
    assert s0 == pytest.approx(t0, abs=2e-6) and s1 - s0 == pytest.approx(0.25, abs=2e-6)


def test_summarize_averages_batch_complete_spans_only():
    t = Tracer(enabled=True)
    p = t.perf_start
    t.complete("batch_complete", p, p + 0.004)
    t.complete("batch_complete", p, p + 0.006)
    t.complete("pipeline.assemble", p, p + 1.0)
    assert t.summarize()["mean_process_ms"] == pytest.approx(5.0, abs=0.002)


def test_device_spans_resolve_completed_pairs_without_waiting(stub_cuda):
    t = Tracer(enabled=True)
    a, b, c = StubEvent(True), StubEvent(True), StubEvent(True)
    c.done = False
    t.device_span("train.forward", a, b, step=0)
    t.device_span("train.backward", b, c, step=0)
    assert t.device_spans() == [("train.forward", 2.5, 0, {"step": 0})]
    c.done = True
    assert [s[0] for s in t.device_spans()] == ["train.forward", "train.backward"]
    off = Tracer(enabled=False)
    off.device_span("x", a, b)
    assert off.device_spans() == []


# ---------------------------------------------------------------------------
# The pipeline's lanes
# ---------------------------------------------------------------------------


def _open_gates(monkeypatch):
    monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 0.0)
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", True)


@pytest.mark.parametrize("streamed", [False, True], ids=["monolithic", "streamed"])
def test_traced_pipeline_spans_every_batch_under_its_seq(streamed, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if streamed:
        _open_gates(monkeypatch)
    tracer = Tracer(enabled=True)
    pipe = Pipeline(SyntheticSource(16, 16, n_frames=16), dvf_tpu_torch.get_filter("invert"),
                    NullSink(), PipelineConfig(batch_size=4, queue_size=100, frame_delay=0,
                                               max_inflight=2),
                    device="cpu", tracer=tracer)
    stats = pipe.run()
    assert stats["delivered"] == 16
    assert os.listdir(tmp_path) == []          # a caller's tracer writes no file
    assert stats["egress"]["mode"] == ("streamed" if streamed else "monolithic")
    by = {}
    for name, t0, t1, track, args in tracer.spans():
        if "seq" in args:
            by.setdefault(args["seq"], {}).setdefault(name, []).append((t0, t1, track))
    launched = sorted(s for s, names in by.items() if "engine.launch" in names)
    assert launched == list(range(pipe.engine.stats.batches)) and len(launched) >= 4
    for seq in launched:
        names = by[seq]
        (asm,), (win,), (launch,), (fetch,) = (names[k] for k in (
            "pipeline.assemble", "pipeline.window_wait", "engine.launch", "egress.fetch"))
        (wait,), (d2h,), (deliver,) = (names[k] for k in (
            "egress.wait_compute", "egress_d2h", "pipeline.deliver"))
        assert {asm[2], win[2], launch[2]} == {TRACK_DISPATCH}
        assert {fetch[2], wait[2], d2h[2], deliver[2]} == {TRACK_COLLECT}
        # Ordered on the dispatch lane, then on the collect lane.
        order = [asm[1], win[0], win[1], launch[0], launch[1], fetch[0]]
        assert all(a <= b + US for a, b in zip(order, order[1:]))
        assert fetch[1] <= deliver[0] + US and deliver[0] <= deliver[1]
        # The compute wait and the copy nest inside the fetch.
        for inner in (wait, d2h):
            assert fetch[0] - US <= inner[0] <= inner[1] <= fetch[1] + US
        assert wait[1] <= d2h[0] + US


def test_pipeline_own_trace_still_exports_its_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pipe = Pipeline(SyntheticSource(8, 8, n_frames=8), dvf_tpu_torch.get_filter("invert"),
                    NullSink(), PipelineConfig(batch_size=4, trace=True), device="cpu")
    pipe.run()
    assert os.listdir(tmp_path) == ["dvf_frame_timing.pftrace"]


# ---------------------------------------------------------------------------
# Egress and the engine
# ---------------------------------------------------------------------------


def test_monolithic_fetch_counts_its_copy_and_spans_it():
    tracer = Tracer(enabled=True)
    stats = EgressStats()
    f = ShardedBatchFetcher((2, 64, 64, 3), np.uint8, "cpu", mode="monolithic",
                            stats=stats, tracer=tracer, track=6)
    y = torch.arange(2 * 64 * 64 * 3, dtype=torch.int32).to(torch.uint8).view(2, 64, 64, 3)
    out = f.fetch(BatchResult(None, None, device=y), 7)
    np.testing.assert_array_equal(out, y.numpy())
    assert stats.batches == 1 and stats.d2h_wait_ms_total > 0 and stats.copy_ms_total == 0
    assert stats.summary()["span_ms"] >= stats.summary()["d2h_wait_ms"] > 0
    spans = {name: (t0, t1, args) for name, t0, t1, _, args in tracer.spans()}
    assert set(spans) == {"egress.fetch", "egress.wait_compute", "egress_d2h"}
    assert spans["egress_d2h"][2] == {"seq": 7, "rows": "0:2", "bytes": out.nbytes}
    d2h_ms = (spans["egress_d2h"][1] - spans["egress_d2h"][0]) * 1e3
    assert d2h_ms == pytest.approx(stats.d2h_wait_ms_total, abs=0.01)


def _fake_card(eng, monkeypatch):
    """The engine's compute stream on a stub: its CUDA paths then run."""
    monkeypatch.setattr(eng, "_compute_stream", lambda device=None: StubStream())


def test_disabled_tracer_records_nothing_and_makes_no_timing_event(stub_cuda, monkeypatch):
    eng = Engine(dvf_tpu_torch.get_filter("invert"), device="cpu")
    eng.compile((2, 8, 8, 3), np.uint8)
    _fake_card(eng, monkeypatch)
    batch = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    for tracer in (None, Tracer(enabled=False)):
        eng.tracer = tracer
        stub_cuda.made = []
        res = eng.submit_resident(batch)
        assert res.timing_start is None
        assert not [e for e in stub_cuda.made if e.enable_timing]
        assert tracer is None or (len(tracer) == 0 and tracer.spans() == [])
    assert eng.stats.device_ms == 0.0 and eng.stats.timed_batches == 0


def test_traced_engine_times_the_step_between_two_events(stub_cuda, monkeypatch):
    eng = Engine(dvf_tpu_torch.get_filter("invert"), device="cpu")
    eng.compile((2, 8, 8, 3), np.uint8)
    _fake_card(eng, monkeypatch)
    eng.tracer, eng.trace_track = Tracer(enabled=True), TRACK_DISPATCH
    stub_cuda.made = []
    res = eng.submit_resident(torch.zeros((2, 8, 8, 3), dtype=torch.uint8), seq=4)
    timing = [e for e in stub_cuda.made if e.enable_timing]
    assert timing == [res.timing_start, res.compute_event]
    eng.settle_timing(res)
    eng.settle_timing(res)                      # once per batch
    assert eng.stats.device_ms == 2.5 and eng.stats.timed_batches == 1
    (name, _, _, track, args), = eng.tracer.spans()
    assert (name, track, args) == ("engine.launch", TRACK_DISPATCH, {"seq": 4})


# ---------------------------------------------------------------------------
# The train step's phases
# ---------------------------------------------------------------------------


def test_cpu_train_step_records_its_phases_and_no_device_time():
    from dvf_tpu_torch.models import StyleNetConfig
    from dvf_tpu_torch.models.vgg import VGGConfig
    from dvf_tpu_torch.train import StyleTrainConfig, init_train_state, make_train_step

    cfg = StyleTrainConfig(net=StyleNetConfig(base_channels=8, n_residual=1),
                           vgg=VGGConfig(blocks=((1, 8), (1, 16))))
    state = init_train_state(0, np.full((1, 32, 32, 3), 0.25, np.float32), cfg, device="cpu")
    tracer = Tracer(enabled=True)
    step = make_train_step(config=cfg, state_template=state, tracer=tracer)
    batch = torch.full((2, 32, 32, 3), 0.5)
    for _ in range(2):
        state, _ = step(state, batch)
    spans = tracer.spans()
    for n in (0, 1):
        mine = [(name, t0, t1) for name, t0, t1, _, args in spans if args == {"step": n}]
        assert [m[0] for m in mine] == ["train.step", "train.optim", "train.forward",
                                        "train.backward", "train.optim"]
        (_, s0, s1), phases = mine[0], mine[1:]
        assert s0 == phases[0][1] and phases[-1][2] == pytest.approx(s1, abs=US)
        for a, b in zip(phases, phases[1:]):
            assert a[2] == pytest.approx(b[1], abs=US)   # contiguous, in order
    assert tracer.device_spans() == []          # no card: no device time
    quiet = Tracer(enabled=False)
    step = make_train_step(config=cfg, state_template=state, tracer=quiet)
    step(state, batch)
    assert len(quiet) == 0
