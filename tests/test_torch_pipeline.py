"""The port's host side and single-stream pipeline against the JAX
package's, on the same seeded streams.

Delivered indices and order must be identical; invert output byte for
byte, the stencil filters within 1 LSB (float sums taken in another order
can flip ``round`` at .5).
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch
from dvf_tpu.io.sources import SyntheticSource as JaxSource
from dvf_tpu.runtime.pipeline import Pipeline as JaxPipeline
from dvf_tpu.runtime.pipeline import PipelineConfig as JaxConfig
from dvf_tpu.sched.queues import DropOldestQueue as JaxQueue
from dvf_tpu.sched.reorder import ReorderBuffer as JaxReorder
from dvf_tpu_torch import CallbackSink, NullSink, Pipeline, PipelineConfig, SyntheticSource
from dvf_tpu_torch.obs.trace import Tracer
from dvf_tpu_torch.runtime.engine import Engine, resolve_device
from dvf_tpu_torch.sched.queues import DropOldestQueue
from dvf_tpu_torch.sched.reorder import ReorderBuffer


@pytest.mark.parametrize("kw", [
    {},
    {"motion": "block"},
    {"motion": "none", "texture": "structured"},
], ids=["roll-noise", "block", "static-structured"])
def test_synthetic_source_same_bytes(kw):
    ours = list(SyntheticSource(32, 40, n_frames=24, seed=0, **kw))
    ref = list(JaxSource(32, 40, n_frames=24, seed=0, **kw))
    assert len(ours) == len(ref) == 25
    assert ours[-1][0] is None and ref[-1][0] is None
    for (a, _), (b, _) in zip(ours[:-1], ref[:-1]):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def _run(pipeline_cls, config_cls, pkg, filt_spec, mode, **kw):
    got = {}
    order = []

    def keep(i, f, _ts):
        order.append(i)
        got[i] = f

    src_cls = SyntheticSource if pkg is dvf_tpu_torch else JaxSource
    pipe = pipeline_cls(src_cls(32, 40, n_frames=24, seed=0),
                        pkg.get_filter(filt_spec[0], **filt_spec[1]),
                        CallbackSink(keep),
                        config_cls(batch_size=8, queue_size=100,
                                   collect_mode=mode), **kw)
    stats = pipe.run()
    return order, got, stats


@pytest.mark.parametrize("mode", ["thread", "inline"])
@pytest.mark.parametrize("filt_spec,max_lsb", [
    (("invert", {}), 0),
    (("sobel_bilateral", {}), 1),
    (("gaussian_blur", {"ksize": 9}), 1),
], ids=["invert", "sobel_bilateral", "gaussian_blur9"])
def test_pipeline_matches_reference(filt_spec, max_lsb, mode):
    order, got, stats = _run(Pipeline, PipelineConfig, dvf_tpu_torch,
                             filt_spec, mode, device="cpu")
    ref_order, ref, ref_stats = _run(JaxPipeline, JaxConfig, dvf_tpu,
                                     filt_spec, mode)
    assert order == ref_order == list(range(24))
    assert stats["delivered"] == ref_stats["delivered"] == 24
    # 24 frames in batches of 8: at least 3 (a slow ingest thread can make
    # the assembler's 10 ms wait close a batch early).
    assert stats["engine_batches"] >= 3 and ref_stats["engine_batches"] >= 3
    assert stats["dropped_at_ingest"] == 0
    for i in order:
        assert got[i].dtype == np.uint8 and got[i].shape == (32, 40, 3)
        diff = np.abs(got[i].astype(np.int16) - ref[i].astype(np.int16))
        assert diff.max() <= max_lsb, (i, diff.max())


@pytest.mark.parametrize("warp_impl", ["pallas", "gather"])
def test_flow_warp_pipeline_matches_reference(warp_impl):
    """The stateful filter end to end: the temporal window carried across
    batches on each side. The assembler waits for full batches (no 10 ms
    early close), so both runs cut the stream at the same frames and pass
    the same first batch through."""
    spec = ("flow_warp", {"levels": 2, "win_size": 9, "n_iters": 2,
                          "max_disp": 2, "warp_impl": warp_impl})
    runs = []
    for pipe_cls, cfg_cls, pkg, kw in [
            (Pipeline, PipelineConfig, dvf_tpu_torch, {"device": "cpu"}),
            (JaxPipeline, JaxConfig, dvf_tpu, {})]:
        got, order = {}, []

        def keep(i, f, _ts, got=got, order=order):
            order.append(i)
            got[i] = f

        src_cls = SyntheticSource if pkg is dvf_tpu_torch else JaxSource
        stats = pipe_cls(src_cls(32, 40, n_frames=20, seed=0),
                         pkg.get_filter(spec[0], **spec[1]), CallbackSink(keep),
                         cfg_cls(batch_size=8, queue_size=100,
                                 assemble_timeout_s=60.0), **kw).run()
        runs.append((order, got, stats))
    (order, got, stats), (ref_order, ref, ref_stats) = runs
    assert order == ref_order == list(range(20))
    # 20 frames in full batches of 8: the last one short and padded.
    assert stats["engine_batches"] == ref_stats["engine_batches"] == 3
    frames = [f for f, _ in SyntheticSource(32, 40, n_frames=20, seed=0)][:-1]
    for i in order:
        if i < 8:   # the first batch has no previous frame: passthrough
            np.testing.assert_array_equal(got[i], frames[i])
        diff = np.abs(got[i].astype(np.int16) - ref[i].astype(np.int16))
        assert diff.max() <= 1, (i, diff.max())
    assert any(not np.array_equal(got[i], frames[i]) for i in range(8, 20))


@pytest.mark.parametrize("name,cfg,scale", [
    ("style_transfer", {"base_channels": 8, "n_residual": 2}, 1),
    ("super_resolution", {}, 2),
], ids=["style_transfer", "super_resolution"])
def test_neural_filter_pipeline_delivers_in_order(name, cfg, scale):
    """The neural filters end to end on the CPU (batch 2, 32x32 frames):
    every frame once and in order, SR at twice the geometry, each frame
    what a direct ``filt.fn`` call gives for its batch (the weights are
    the filter's state; full batches: the assembler waits for them)."""
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    filt = dvf_tpu_torch.get_filter(name, **cfg)
    src = SyntheticSource(32, 32, n_frames=8, seed=0)
    frames = [f for f, _ in SyntheticSource(32, 32, n_frames=8, seed=0)][:-1]
    got, order = {}, []

    def keep(i, f, _ts):
        order.append(i)
        got[i] = f

    stats = Pipeline(src, filt, CallbackSink(keep),
                     PipelineConfig(batch_size=2, queue_size=100,
                                    assemble_timeout_s=60.0), device="cpu").run()
    assert order == list(range(8)) and stats["delivered"] == 8
    assert stats["engine_batches"] == 4
    state = filt.init_state((2, 32, 32, 3), torch.float32, torch.device("cpu"))
    for s in range(0, 8, 2):
        x = to_float(torch.from_numpy(np.stack(frames[s:s + 2])))
        with torch.no_grad():
            want = to_uint8(filt.fn(x, state)[0]).numpy()
        for j in range(2):
            assert got[s + j].shape == (32 * scale, 32 * scale, 3)
            np.testing.assert_array_equal(got[s + j], want[j])


def test_pipeline_pads_short_batch_and_keeps_rows():
    """A stream that is no multiple of the batch: the short last batch is
    padded and its padding dropped; delivered rows survive the reuse of
    the output slots (max_inflight + 1 of them)."""
    src = SyntheticSource(16, 20, n_frames=21, seed=2)
    frames = [f for f, _ in src][:-1]
    got = {}
    stats = Pipeline(src, dvf_tpu_torch.get_filter("invert"),
                     CallbackSink(lambda i, f, _: got.__setitem__(i, f)),
                     PipelineConfig(batch_size=4, queue_size=100,
                                    max_inflight=1), device="cpu").run()
    # 21 is no multiple of 4, so at least one of the >= 6 batches is short.
    assert stats["delivered"] == 21 and stats["engine_batches"] >= 6
    assert sorted(got) == list(range(21))
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(got[i], 255 - f)


def test_telemetry_interval_prints_rates(capsys):
    """``telemetry_interval_s > 0`` prints capture/deliver rates (the
    reference's periodic fps prints); 0 keeps the stream silent."""
    cfg = PipelineConfig(batch_size=4, queue_size=100, telemetry_interval_s=1e-6)
    Pipeline(SyntheticSource(8, 8, n_frames=12, seed=1),
             dvf_tpu_torch.get_filter("invert"), NullSink(), cfg,
             device="cpu").run()
    out = capsys.readouterr().out
    assert "[capture]" in out and "[deliver]" in out and "fps" in out
    Pipeline(SyntheticSource(8, 8, n_frames=12, seed=1),
             dvf_tpu_torch.get_filter("invert"), NullSink(),
             PipelineConfig(batch_size=4, queue_size=100), device="cpu").run()
    assert capsys.readouterr().out == ""


def test_queue_parity_on_seeded_schedule():
    rng = np.random.default_rng(21)
    ours, ref = DropOldestQueue(maxsize=5), JaxQueue(maxsize=5)
    for step in range(400):
        op = rng.integers(0, 3)
        if op < 2:
            assert ours.put(step) == ref.put(step)
        else:
            n = int(rng.integers(1, 4))
            assert ours.pop_up_to(n) == ref.pop_up_to(n)
        assert len(ours) == len(ref)
    assert (ours.dropped, ours.put_total) == (ref.dropped, ref.put_total)


def test_reorder_parity_on_seeded_schedule():
    rng = np.random.default_rng(22)
    ours = ReorderBuffer(frame_delay=3, capacity=8)
    ref = JaxReorder(frame_delay=3, capacity=8)
    # Out-of-order completions: a shuffled window that slides forward.
    idx = np.arange(120)
    for start in range(0, 120, 10):
        rng.shuffle(idx[start:start + 10])
    for i in idx:
        ours.complete(int(i), int(i) * 7)
        ref.complete(int(i), int(i) * 7)
        if rng.random() < 0.5:
            assert ours.advance() == ref.advance()
            assert ours.get() == ref.get()
        if rng.random() < 0.3:
            assert ours.pop_ready() == ref.pop_ready()
        assert ours.stats() == ref.stats()
    ours.flush()
    ref.flush()
    assert ours.pop_ready() == ref.pop_ready()
    assert ours.evicted_total == ref.evicted_total


def test_empty_stream_terminates():
    pipe = Pipeline(SyntheticSource(16, 16, n_frames=0),
                    dvf_tpu_torch.get_filter("invert"), NullSink(),
                    device="cpu")
    out = {}
    t = threading.Thread(target=lambda: out.update(pipe.run()), daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out["delivered"] == 0 and out["engine_batches"] == 0


def test_engine_compiles_once_per_signature_and_fills_out():
    eng = Engine(dvf_tpu_torch.get_filter("gaussian_blur", ksize=3), device="cpu")
    x = np.random.default_rng(8).integers(0, 256, (2, 8, 10, 3), np.uint8)
    eng.ensure_compiled(x.shape)
    eng.ensure_compiled(x.shape)
    assert eng.stats.compile_count == 1
    assert eng.out_shape == x.shape and eng.out_dtype == np.uint8
    out = torch.empty(x.shape, dtype=torch.uint8)
    res = eng.submit(torch.from_numpy(x), out=out)
    assert res.is_ready()
    got = res.fetch()
    assert np.shares_memory(got, out.numpy())
    np.testing.assert_array_equal(got, eng.submit(x).fetch())
    assert (eng.stats.batches, eng.stats.frames) == (2, 4)
    eng.submit(x[:1])                       # a new signature compiles again
    assert eng.stats.compile_count == 2


def test_no_device_means_cuda_and_never_the_cpu(monkeypatch):
    """With no device given, the entry points ask for cuda:0 and raise
    when there is none — they do not run on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(dvf_tpu_torch.get_filter("invert"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(SyntheticSource(8, 8, n_frames=1),
                 dvf_tpu_torch.get_filter("invert"), NullSink())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("name", ["style_transfer", "super_resolution", "upscale",
                                  "equalize", "clahe", "canny"])
def test_new_filters_run_on_cuda_unless_told(monkeypatch, name):
    """The neural and histogram/canny filters go through the same entry
    points: no device means cuda:0, which raises where there is none;
    device="cpu" runs them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(dvf_tpu_torch.get_filter(name))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(SyntheticSource(8, 8, n_frames=1), dvf_tpu_torch.get_filter(name),
                 NullSink())
    frames = np.random.default_rng(1).integers(0, 256, (1, 8, 8, 3), np.uint8)
    eng = Engine(dvf_tpu_torch.get_filter(name), device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.submit(frames).fetch().dtype == np.uint8


def test_pipeline_refuses_engine_on_another_device():
    eng = Engine(dvf_tpu_torch.get_filter("invert"), device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        Pipeline(SyntheticSource(8, 8, n_frames=1), eng.filter, NullSink(),
                 engine=eng, device="cuda:0")


# ---------------------------------------------------------------------------
# Planes: device trace, registry, flight recorder (config parity)
# ---------------------------------------------------------------------------


def test_pipeline_config_has_every_reference_field():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(PipelineConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert set(ours) == set(ref)
    for name in ("device_trace_dir", "flight_dir", "flight_min_interval_s"):
        assert ours[name] == ref[name]


_DEVICE_TRACE_SCRIPT = r"""
import json, os, sys
import numpy as np
import dvf_tpu_torch as dt
from dvf_tpu_torch.api.filter import stateless
d = sys.argv[1]
out = {}
# (1) traced run: the device trace and the merged export land in the dir.
cfg = dt.PipelineConfig(batch_size=4, queue_size=100, trace=True,
                        frame_delay=0, device_trace_dir=os.path.join(d, "a"))
s = dt.Pipeline(dt.SyntheticSource(16, 16, n_frames=8),
                dt.get_filter("sobel_bilateral"), dt.NullSink(), cfg,
                device="cpu").run()
out["delivered"] = s["delivered"]
out["files_a"] = sorted(os.listdir(os.path.join(d, "a")))
doc = json.load(open(os.path.join(d, "a", "dvf_merged_timing.pftrace")))
ev = doc["traceEvents"]
out["host_spans"] = sorted({e["name"] for e in ev
                            if e.get("ph") == "X" and e["pid"] < 10000})
out["device_spans"] = len([e for e in ev
                           if e.get("ph") == "X" and e["pid"] >= 10000])
out["python_function"] = len([e for e in ev
                              if e.get("cat") == "python_function"])
# (2) untraced run: the device trace alone, no merge.
cfg = dt.PipelineConfig(batch_size=4, queue_size=100, frame_delay=0,
                        device_trace_dir=os.path.join(d, "b"))
dt.Pipeline(dt.SyntheticSource(16, 16, n_frames=4), dt.get_filter("invert"),
            dt.NullSink(), cfg, device="cpu").run()
out["files_b"] = sorted(os.listdir(os.path.join(d, "b")))
# (3) a failing run still stops the profiler: a next session starts.
def boom(x):
    raise RuntimeError("forced")
cfg = dt.PipelineConfig(batch_size=4, queue_size=100,
                        device_trace_dir=os.path.join(d, "c"))
try:
    dt.Pipeline(dt.SyntheticSource(16, 16, n_frames=4),
                stateless("boom", boom), dt.NullSink(), cfg,
                device="cpu").run()
    out["raised"] = False
except RuntimeError:
    out["raised"] = True
out["files_c"] = sorted(os.listdir(os.path.join(d, "c")))
from dvf_tpu_torch.obs.export import start_device_profiler
p = start_device_profiler()
p.stop()
print(json.dumps(out))
"""


def test_device_trace_capture_and_merge(tmp_path):
    """device_trace_dir runs a torch.profiler session around the run
    (in a process of its own: one profiler session per process): the
    Chrome trace lands in the dir and, with trace=True, the merged
    host+device file beside it; a failing run still stops the session."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", _DEVICE_TRACE_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["delivered"] == 8
    assert out["files_a"] == ["dvf_merged_timing.pftrace", "trace.json"]
    assert "batch_complete" in out["host_spans"]
    assert out["device_spans"] > 0
    assert out["python_function"] == 0
    assert out["files_b"] == ["trace.json"]
    assert out["raised"] is True and out["files_c"] == ["trace.json"]
    assert (tmp_path / "dvf_frame_timing.pftrace").exists()


# ---------------------------------------------------------------------------
# Short batches: held while the device backlog is two or more batches
# ---------------------------------------------------------------------------


class _Gate:
    """A compute event that completes when the test releases it."""

    def __init__(self):
        self._done = threading.Event()

    def query(self) -> bool:
        return self._done.is_set()

    def synchronize(self) -> None:
        if not self._done.wait(timeout=30.0):
            raise TimeoutError("batch never released")

    def release(self) -> None:
        self._done.set()


class _GatedEngine(Engine):
    """An engine whose batches stay unfinished, as on a busy card, until
    the test (or ``run_device``, a FIFO device of fixed step time)
    releases them."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.gates = []

    def _gated(self, result):
        gate = _Gate()
        result.compute_event = gate
        self.gates.append(gate)
        return result

    def submit(self, batch, *args, **kw):
        return self._gated(super().submit(batch, *args, **kw))

    def submit_resident(self, batch, *args, **kw):
        return self._gated(super().submit_resident(batch, *args, **kw))

    def launched(self) -> int:
        return len(self.gates)

    def release_all(self) -> None:
        for g in list(self.gates):
            g.release()

    def run_device(self, step_s: float, stop: threading.Event) -> threading.Thread:
        def device():
            done, t_free = 0, time.perf_counter()
            while not stop.is_set():
                if done == len(self.gates):
                    time.sleep(0.0005)
                    continue
                t_free = max(t_free, time.perf_counter()) + step_s
                time.sleep(max(0.0, t_free - time.perf_counter()))
                self.gates[done].release()
                done += 1

        th = threading.Thread(target=device, daemon=True)
        th.start()
        return th


class _FeedSource:
    """Frames the test lets through: ``feed(n)`` hands over n more,
    ``end()`` ends the stream. Frame i is filled with i % 256."""

    def __init__(self):
        self._tokens = queue.Queue()

    def feed(self, n: int) -> None:
        for _ in range(n):
            self._tokens.put(True)

    def end(self) -> None:
        self._tokens.put(None)

    def __iter__(self):
        i = 0
        while self._tokens.get(timeout=60.0) is not None:
            yield np.full((8, 8, 3), i % 256, np.uint8), time.time()
            i += 1


def _wait_for(cond, timeout=20.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.001)


class _Run:
    """Runs a pipeline in a thread; ``finish`` ends it and bounds the wait."""

    def __init__(self, pipe):
        self.pipe, self.stats, self.err = pipe, {}, []
        self.thread = threading.Thread(target=self._go, daemon=True)
        self.thread.start()

    def _go(self):
        try:
            self.stats.update(self.pipe.run())
        except BaseException as e:  # noqa: BLE001 — asserted in finish
            self.err.append(e)

    def finish(self, timeout=30.0) -> dict:
        self.thread.join(timeout=timeout)
        hung = self.thread.is_alive()
        if hung:
            self.pipe.abort()
        assert not hung, "the pipeline did not finish"
        assert not self.err, self.err
        return self.stats


def _gated_pipeline(source, collect_mode, got, tracer=None, **cfg):
    eng = _GatedEngine(dvf_tpu_torch.get_filter("invert"), device="cpu")
    cfg = dict(dict(batch_size=4, queue_size=100, frame_delay=0), **cfg)
    pipe = Pipeline(source, eng.filter,
                    CallbackSink(lambda i, f, _: got.append((i, int(f[0, 0, 0])))),
                    PipelineConfig(collect_mode=collect_mode, **cfg),
                    engine=eng, tracer=tracer)
    return eng, pipe


def _in_order(got, n):
    return got == [(i, 255 - i % 256) for i in range(n)]


@pytest.mark.parametrize("collect_mode", ["thread", "inline"])
def test_partial_batch_fills_while_device_backlog_is_two(collect_mode):
    """Two batches unfinished on the device: one frame waits far past
    assemble_timeout_s and launches in a full batch once three more come."""
    src, got, tracer = _FeedSource(), [], Tracer(enabled=True)
    eng, pipe = _gated_pipeline(src, collect_mode, got, tracer=tracer,
                                assemble_timeout_s=0.1)
    run = _Run(pipe)
    try:
        src.feed(8)
        _wait_for(lambda: eng.launched() == 2)
        src.feed(1)
        time.sleep(0.5)                      # five deadlines
        assert eng.launched() == 2
        src.feed(3)
        _wait_for(lambda: eng.launched() == 3)
    finally:
        eng.release_all()
        src.end()
    stats = run.finish()
    assert _in_order(got, 12)
    assert (stats["fill_holds"], stats["short_batches"], stats["padded_rows"]) == (1, 0, 0)
    sig = pipe.signals()
    assert (sig["fill_holds_total"], sig["short_batches_total"],
            sig["padded_rows_total"]) == (1.0, 0.0, 0.0)
    valid = [args["valid"] for name, _, _, _, args in tracer.spans()
             if name == "pipeline.assemble" and args["seq"] < 3]
    assert valid == [4, 4, 4]


@pytest.mark.parametrize("collect_mode", ["thread", "inline"])
@pytest.mark.parametrize("backlog", [0, 1])
def test_short_batch_launches_at_deadline_below_backlog_two(backlog, collect_mode):
    """Fewer than two batches unfinished (a paced source): a lone frame
    launches padded at assemble_timeout_s, as before the hold existed."""
    timeout = 0.2
    src, got = _FeedSource(), []
    eng, pipe = _gated_pipeline(src, collect_mode, got, assemble_timeout_s=timeout)
    run = _Run(pipe)
    try:
        src.feed(4 * backlog)
        _wait_for(lambda: eng.launched() == backlog)
        t0 = time.perf_counter()
        src.feed(1)
        _wait_for(lambda: eng.launched() == backlog + 1)
        assert time.perf_counter() - t0 >= timeout
    finally:
        eng.release_all()
        src.end()
    stats = run.finish()
    assert _in_order(got, 4 * backlog + 1)
    assert (stats["short_batches"], stats["padded_rows"], stats["fill_holds"]) == (1, 3, 0)


@pytest.mark.parametrize("collect_mode", ["thread", "inline"])
def test_closed_loop_fills_every_batch_but_the_last(collect_mode):
    """The stream cell's loop at a small size: 32 frames between source
    and sink, 5 of them in the reorder buffer, batch 8, four in flight,
    a FIFO device of fixed step time. 27 free frames make three full
    batches and three over; the three wait instead of launching padded."""
    n, outstanding = 8 * 12 + 3, 32
    admit = threading.Semaphore(outstanding)

    def source():
        for i in range(n):
            assert admit.acquire(timeout=60.0), "the loop never freed a frame"
            yield np.full((8, 8, 3), i % 256, np.uint8), time.time()

    def emit(i, f, _ts):
        got.append((i, int(f[0, 0, 0])))
        admit.release()

    got, stop = [], threading.Event()
    eng = _GatedEngine(dvf_tpu_torch.get_filter("invert"), device="cpu")
    pipe = Pipeline(source(), eng.filter, CallbackSink(emit),
                    PipelineConfig(batch_size=8, queue_size=40, frame_delay=5,
                                   max_inflight=4, collect_mode=collect_mode),
                    engine=eng)
    device = eng.run_device(step_s=0.05, stop=stop)
    run = _Run(pipe)
    try:
        stats = run.finish(timeout=60.0)
    finally:
        stop.set()
        eng.release_all()
        device.join(timeout=10.0)
    assert _in_order(got, n)
    assert stats["engine_batches"] == 13
    assert (stats["short_batches"], stats["padded_rows"]) == (1, 5)
    assert stats["fill_holds"] >= 1


@pytest.mark.parametrize("collect_mode", ["thread", "inline"])
def test_stream_tail_launches_while_batches_are_in_flight(collect_mode):
    """The end of the stream launches the held tail at once, with both
    earlier batches still unfinished, and every frame is delivered."""
    src, got = _FeedSource(), []
    eng, pipe = _gated_pipeline(src, collect_mode, got, assemble_timeout_s=0.05)
    run = _Run(pipe)
    try:
        src.feed(10)
        _wait_for(lambda: eng.launched() == 2)
        time.sleep(0.3)
        assert eng.launched() == 2           # the tail of two is held
        src.end()
        _wait_for(lambda: eng.launched() == 3)
        assert not any(g.query() for g in eng.gates)
    finally:
        eng.release_all()
        src.end()
    stats = run.finish()
    assert _in_order(got, 10)
    assert (stats["short_batches"], stats["padded_rows"], stats["fill_holds"]) == (1, 2, 1)
