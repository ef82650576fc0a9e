"""The port's host side and single-stream pipeline against the JAX
package's, on the same seeded streams.

Delivered indices and order must be identical; invert output byte for
byte, the stencil filters within 1 LSB (float sums taken in another order
can flip ``round`` at .5).
"""

import threading

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
