"""The port's bench harness (``dvf_tpu_torch.benchmarks`` and
``bench_child``) on the CPU, held to the JAX package's
(``dvf_tpu.benchmarks``): the counterparts of tests/test_benchmarks.py's
harness cases (its ``run_table`` / ``bench.py`` cases belong to the
repo-root harness, which the port does not have), of
tests/test_obs.py's bench JSON writers, and ``Engine.cost_analysis`` for
every ``BENCH_CONFIGS`` filter. Tiny shapes; measurement paths only, no
performance numbers."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dvf_tpu.benchmarks as RB
import dvf_tpu_torch.benchmarks as B
from dvf_tpu.ops import get_filter as ref_get_filter
from dvf_tpu_torch.benchmarks import (
    bench_device_resident,
    bench_e2e_latency,
    bench_e2e_streaming,
    bench_stage_decomposition,
    bench_transfer,
)
from dvf_tpu_torch.cli import BENCH_CONFIGS
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.runtime import cost
from dvf_tpu_torch.runtime.engine import Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def test_transfer_microbench_fields():
    r = bench_transfer(2, 16, 16, reps=2, device=CPU)
    ref = RB.bench_transfer(2, 16, 16, reps=2)
    assert r["h2d_mbps"] > 0 and r["d2h_mbps"] > 0
    assert r["batch_mb"] == ref["batch_mb"] == 2 * 16 * 16 * 3 / 1e6
    assert np.isfinite(r["d2h_mbps"]) and r["d2h_fixed_ms"] >= 0
    assert set(ref) < set(r) and r["d2h_measures"] == ref["d2h_measures"]
    assert r["host_memory"] == "pageable"


def test_transfer_times_the_pipelines_host_memory():
    """A deliberate difference from the reference (which times a pageable
    ``device_put``): on a card the legs copy from and into pinned host
    memory, the memory the port's ingest and egress slabs are."""
    assert B.transfer_host_memory(torch.device("cuda", 0)) == "pinned"
    assert B.transfer_host_memory(torch.device("cpu")) == "pageable"
    seen = []
    real = torch.empty

    def spy(*a, **k):
        seen.append(k.get("pin_memory", False))
        return real(*a, **{**k, "pin_memory": False})

    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch, "empty", spy)
        B._host_buffer((1, 2, 2, 3), torch.device("cuda", 0))
    assert seen == [True]


def test_device_resident_counts_frames():
    r = bench_device_resident(get_filter("invert"), iters=3, batch_size=2,
                              height=16, width=16, device=CPU)
    assert r["frames"] == 6
    assert r["fps"] > 0 and r["ms_per_frame"] > 0
    ref = RB.bench_device_resident(ref_get_filter("invert"), iters=3,
                                   batch_size=2, height=16, width=16)
    assert set(ref) <= set(r)


def test_device_resident_geometry_changing_filter():
    """super_resolution doubles H and W: the chain folds a scalar of the
    previous output into the fixed-shape input instead of feeding it
    back, so the signature stays put."""
    r = bench_device_resident(get_filter("super_resolution", scale=2), iters=2,
                              batch_size=1, height=8, width=8, device=CPU)
    assert r["frames"] == 2
    assert r["flops_per_frame"] == 2 * 26_688 * 8 * 8
    assert r["peak_tflops"] == 989.0


def test_bench_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_device_resident(get_filter("invert"), 1, 1, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_transfer(1, 8, 8)


def test_a_mesh_waits_for_multi_gpu():
    """A mesh runs: the device-resident bench over a data=2, space=2 mesh
    of virtual devices (a geometry-keeping and a geometry-changing
    filter), and a device beside the mesh must be its first."""
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    m = make_mesh(MeshConfig(data=2, space=2), devices=[CPU] * 4)
    r = bench_device_resident(get_filter("gaussian_blur", ksize=3), 2, 4, 16, 16,
                              mesh=m, device=CPU)
    assert r["frames"] == 8 and r["fps"] > 0
    r = bench_device_resident(get_filter("upscale"), 2, 4, 16, 16, mesh=m)
    assert r["frames"] == 8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_e2e_latency(get_filter("invert"), 8, 4, 8, 8, 10.0,
                          mesh=m, device="cuda:0")


def test_latency_bench_accepts_mesh():
    """Counterpart of the reference's: the rate-controlled latency bench
    over a data=2 mesh."""
    import dvf_tpu
    from dvf_tpu.benchmarks import bench_e2e_latency as ref_latency
    from dvf_tpu.parallel.mesh import MeshConfig as RefMeshConfig
    from dvf_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    kw = dict(n_frames=24, batch_size=8, height=32, width=32, target_fps=500.0)
    r = bench_e2e_latency(get_filter("invert"),
                          mesh=make_mesh(MeshConfig(data=2), devices=[CPU] * 2),
                          device=CPU, **kw)
    assert r["frames"] > 0 and r["p50_ms"] > 0
    ref = ref_latency(dvf_tpu.get_filter("invert"),
                      mesh=ref_make_mesh(RefMeshConfig(data=2)), **kw)
    assert set(r) >= set(ref) - {"backend"}


def test_e2e_streaming_throughput_mode():
    r = bench_e2e_streaming(get_filter("invert"), 24, 4, 16, 16, device=CPU)
    assert r["frames"] > 0 and r["fps"] > 0
    ref = RB.bench_e2e_streaming(ref_get_filter("invert"), 24, 4, 16, 16)
    assert set(r) == set(ref)


def test_e2e_latency_mode_is_rate_controlled():
    """Latency mode throttles the source and bounds the ingest queue: with
    a target far below capacity there must be no drops, and p50 must be a
    transit time."""
    r = bench_e2e_latency(get_filter("invert"), 16, 4, 16, 16, target_fps=10.0,
                          device=CPU)
    assert r["target_fps"] == 10.0
    assert r["dropped"] == 0
    assert r["frames"] == 16
    assert 0 < r["p50_ms"] < 1000.0


@pytest.mark.parametrize("wire", ["raw", "jpeg", "delta"])
def test_e2e_streaming_ring_transport_variants(wire):
    """bench plumbing for --transport ring / --wire (tiny shapes)."""
    r = bench_e2e_streaming(get_filter("invert"), 16, 4, 24, 32,
                            transport="ring", wire=wire, device=CPU)
    assert r["frames"] == 16, (wire, r)
    assert r["wire"]["wire"] == wire


def test_stage_decomposition_fields():
    d = bench_stage_decomposition(get_filter("invert"), (1, 2), 16, 16, reps=3,
                                  device=CPU)
    ref = RB.bench_stage_decomposition(ref_get_filter("invert"), (1, 2), 16, 16,
                                       reps=3)
    assert set(d) == set(ref) == {"batch_1", "batch_2", "codec"}
    assert set(d["codec"]) == set(ref["codec"])
    assert d["codec"]["wire"] == "jpeg"
    assert d["codec"]["assist"] == "none"
    assert d["codec"]["threads"] == 1  # per-frame serialized cost
    for b in ("batch_1", "batch_2"):
        legs = d[b]
        assert set(legs) == set(ref[b])
        for k in ("staging_ms", "h2d_ms", "compute_ms", "d2h_ms", "encode_ms"):
            assert legs[k] >= 0, (b, k, legs)
        # encode_ms is reported beside the four serialized-transfer legs
        # but excluded from their total (the codec plane overlaps it).
        assert legs["total_ms"] == pytest.approx(
            legs["staging_ms"] + legs["h2d_ms"] + legs["compute_ms"]
            + legs["d2h_ms"], abs=0.01)
        assert legs["total_ms"] >= legs["compute_ms"]
        assert legs["transfer_mode"] == "whole_batch"
        assert legs["per_frame_compute_ms"] == round(
            legs["compute_ms"] / int(b.removeprefix("batch_")), 4)


def test_stage_decomposition_without_the_encode_leg():
    d = bench_stage_decomposition(get_filter("invert"), (1,), 16, 16, reps=2,
                                  measure_encode=False, device=CPU)
    assert set(d) == {"batch_1"} and "encode_ms" not in d["batch_1"]


def test_encode_leg_fails_loudly_without_the_jpeg_codec(monkeypatch):
    """Where the JPEG shim cannot be built (no libjpeg, as on the card
    machine), asking for the encode leg raises: it is never skipped."""
    from dvf_tpu_torch.transport import codec

    def no_shim(**kw):
        raise RuntimeError("jpeg_shim build failed: no libjpeg")

    monkeypatch.setattr(codec, "make_codec", no_shim)
    with pytest.raises(RuntimeError, match="no libjpeg"):
        bench_stage_decomposition(get_filter("invert"), (1,), 16, 16, reps=1,
                                  device=CPU)


def test_roofline_fields_models():
    """The roofline columns use the engine's counted bytes: invert reads
    and writes one uint8 frame, so bytes accessed are exactly 2x the frame
    bytes (the number XLA reports for the reference), and the HBM
    fraction follows fps/(BW/bytes) at the H100's bandwidth."""
    from dvf_tpu_torch.benchmarks import H100_PEAKS, roofline_fields

    r = bench_device_resident(get_filter("invert"), iters=3, batch_size=2,
                              height=16, width=16, device=CPU)
    ref = RB.bench_device_resident(ref_get_filter("invert"), iters=3,
                                   batch_size=2, height=16, width=16)
    assert r["bytes_accessed_per_frame"] == ref["bytes_accessed_per_frame"] \
        == 2 * 16 * 16 * 3
    # CPU backend → no roofline claim (nor a TPU's).
    assert roofline_fields(r, "cpu") == {}
    assert roofline_fields(r, "tpu") == {}
    fake = dict(r, fps=1000.0)
    out = roofline_fields(fake, "cuda")
    ceil = H100_PEAKS["hbm_gbps"] * 1e9 / r["bytes_accessed_per_frame"]
    assert H100_PEAKS["hbm_gbps"] == 3350.0
    assert abs(out["hbm_roofline_fps"] - round(ceil, 1)) < 0.2
    assert out["hbm_roofline_frac"] == round(1000.0 / ceil, 3)
    # MFU against the peak of the filter's arithmetic: float32 CUDA cores
    assert out["mfu_peak_tflops"] == 67.0
    assert out["mfu"] == round(1000.0 * r["flops_per_frame"] / 67e12, 5)
    assert set(RB.roofline_fields(dict(ref, fps=1000.0), "tpu")) < set(out)


def _run_child(*argv, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return subprocess.run(
        [sys.executable, "-m", "dvf_tpu_torch.bench_child", *argv],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, timeout=timeout)


def test_bench_child_probe_mode():
    """--mode probe initializes the device, runs a tiny computation, and
    prints one JSON line, as the reference's child does."""
    p = _run_child("--mode", "probe", "--platform", "cpu")
    assert p.returncode == 0, p.stderr[-500:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["backend"] == "cpu"
    assert line["probe_sum"] == 28.0  # sum(range(8)) — the device executed
    assert "kernel build cache" in p.stderr


def test_bench_child_cuda_without_a_card_exits_3():
    """--platform cuda (the default) where no CUDA device is: init fails,
    exit 3, no result line — never a silent CPU run."""
    probe = ("import runpy, sys, torch\n"
             "torch.cuda.is_available = lambda: False\n"
             "sys.argv = ['bench_child', '--mode', 'probe']\n"
             "runpy.run_module('dvf_tpu_torch.bench_child', run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_bench_child_device_mode_keys_equal_the_references():
    """--mode device: the result line carries the reference child's keys
    for the mode (its roofline keys only on a card)."""
    p = _run_child("--mode", "device", "--platform", "cpu", "--iters", "2",
                   "--batch", "2", "--height", "16", "--width", "16",
                   "--e2e-batch", "2")
    assert p.returncode == 0, p.stderr[-500:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["device_frames"] == 4 and line["backend"] == "cpu"
    assert {"device_fps", "ms_per_batch", "ms_per_frame", "device_wall_s",
            "batch", "h2d_mbps", "d2h_mbps", "link_roofline_fps"} <= set(line)
    assert line["host_memory"] == "pageable"


# ---------------------------------------------------------------------------
# The congestion verdict and the latency leg's backoff, beside the
# reference's on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,want", [
    ((9.0, 10.0, 0, 100), False),     # kept up
    ((5.0, 10.0, 0, 100), True),      # delivery shortfall, no drops
    ((10.0, 10.0, 10, 100), True),    # ingest dropped
    ((10.0, 10.0, 1, 100), False),    # one start-up drop is forgiven
    ((10.0, 10.0, 2, 512), True),     # no percentage allowance
    ((1.0, 0.0, 0, 100), True),       # no target = no claim
    ((0.0, 10.0, 0, 0), True),        # nothing delivered
    ((8.5, 10.0, 0, 100), False),     # exactly 0.85x keeps up
])
def test_stream_congested_verdicts(args, want):
    assert B.stream_congested(*args) is want
    assert RB.stream_congested(*args) is want


def _backoff_run(module, monkeypatch, fake, **kw):
    monkeypatch.setattr(module, "_run_pipeline", fake)
    return module.bench_e2e_latency(object(), **kw)


def _both(monkeypatch, make_fake, **kw):
    """The port's and the reference's backoff loop on the same scripted
    runs: (port calls, port result), (reference calls, reference result)."""
    out = []
    for module in (B, RB):
        calls = []
        r = _backoff_run(module, monkeypatch, make_fake(calls), **kw)
        out.append((calls, r))
    return out


def test_latency_backoff_halves_until_uncongested(monkeypatch):
    def make(calls):
        def fake(filt, source, batch_size, h, w, max_inflight, queue_size, **kw):
            calls.append((source.rate, source.n_frames))
            if source.rate > 3.0:  # congested until the rate drops under 3 fps
                return {"fps": source.rate * 0.5,
                        "delivery_fps": source.rate * 0.5,
                        "frames": source.n_frames, "wall_s": 1.0,
                        "p50_ms": 99999.0, "p99_ms": 99999.0, "dropped": 10}
            return {"fps": source.rate, "delivery_fps": source.rate,
                    "frames": source.n_frames, "wall_s": 1.0,
                    "p50_ms": 12.0, "p99_ms": 20.0, "dropped": 0}
        return fake

    (calls, r), (ref_calls, ref) = _both(
        monkeypatch, make, n_frames=96, batch_size=8, height=8, width=8,
        target_fps=8.0)
    assert [c[0] for c in calls] == [8.0, 4.0, 2.0]
    assert [c[1] for c in calls] == [96, 48, 24]
    assert r["congested"] is False and r["backoffs"] == 2
    assert r["target_fps"] == 2.0 and r["p50_ms"] == 12.0
    assert (calls, r) == (ref_calls, ref)


def _always_congested(fps):
    def make(calls):
        def fake(filt, source, *a, **kw):
            calls.append((source.rate, source.n_frames))
            return {"fps": fps(source), "delivery_fps": fps(source),
                    "frames": source.n_frames, "wall_s": 1.0,
                    "p50_ms": 5000.0, "p99_ms": 9000.0, "dropped": 50}
        return fake
    return make


def test_latency_backoff_exhausted_flags_congested(monkeypatch):
    (calls, r), (ref_calls, ref) = _both(
        monkeypatch, _always_congested(lambda s: s.rate * 0.3), n_frames=64,
        batch_size=8, height=8, width=8, target_fps=8.0, max_backoffs=2)
    assert r["congested"] is True and r["backoffs"] == 2
    assert r["target_fps"] == 2.0  # the lowest rate actually tried
    assert (calls, r) == (ref_calls, ref)


def test_latency_backoff_never_inflates_frames(monkeypatch):
    (calls, _), (ref_calls, _) = _both(
        monkeypatch, _always_congested(lambda s: 0.1), n_frames=48,
        batch_size=64, height=8, width=8, target_fps=2.4, max_backoffs=2)
    assert [c[1] for c in calls] == [48, 24, 16]  # non-increasing
    assert calls == ref_calls


def test_latency_backoff_floor_never_exceeds_original(monkeypatch):
    (calls, r), (ref_calls, _) = _both(
        monkeypatch, _always_congested(lambda s: 0.01), n_frames=12,
        batch_size=8, height=8, width=8, target_fps=8.0, max_backoffs=2)
    assert [c[1] for c in calls] == [12, 12, 12]
    assert r["congested"] is True
    assert calls == ref_calls


def test_latency_backoff_respects_wall_budget(monkeypatch):
    # 12 frames at 0.08 fps: the first retry projects 12/0.04 = 300 s (ok
    # at the 400 s default), the second 12/0.02 = 600 s (skipped).
    (calls, r), (ref_calls, ref) = _both(
        monkeypatch, _always_congested(lambda s: 0.01), n_frames=12,
        batch_size=8, height=8, width=8, target_fps=0.08, max_backoffs=2)
    assert [c[0] for c in calls] == [0.08, 0.04]
    assert r["congested"] is True and r["backoffs"] == 1
    assert (calls, r) == (ref_calls, ref)


def test_latency_backoff_zero_target_returns_congested(monkeypatch):
    def make(calls):
        def fake(filt, source, *a, **kw):
            calls.append(source.rate)
            return {"fps": 0.0, "delivery_fps": 0.0, "frames": 0, "wall_s": 1.0,
                    "p50_ms": float("nan"), "p99_ms": float("nan"), "dropped": 0}
        return fake

    (calls, r), (ref_calls, ref) = _both(
        monkeypatch, make, n_frames=12, batch_size=8, height=8, width=8,
        target_fps=0.0)
    assert r["congested"] is True and ref["congested"] is True
    assert calls == ref_calls == [0.0]


def test_latency_backoff_invariants_property(monkeypatch):
    """Property check over arbitrary congestion patterns: the backoff
    loop terminates within max_backoffs+1 attempts, rates halve, frame
    counts never increase (floored at min(16, original)), the returned
    numbers are the LAST attempt's, and the whole run equals the
    reference's on the same script."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None)
    @given(
        congested_seq=st.lists(st.booleans(), min_size=1, max_size=8),
        n_frames=st.integers(min_value=1, max_value=200),
        target=st.floats(min_value=0.05, max_value=500.0),
        max_backoffs=st.integers(min_value=0, max_value=4),
    )
    def check(congested_seq, n_frames, target, max_backoffs):
        def make(attempts):
            def scripted(filt, source, *a, **kw):
                i = len(attempts)
                attempts.append((source.rate, source.n_frames))
                cong = congested_seq[min(i, len(congested_seq) - 1)]
                return {"fps": source.rate, "frames": source.n_frames,
                        "delivery_fps": (source.rate * 0.1 if cong
                                         else source.rate),
                        "wall_s": 1.0, "p50_ms": 100.0 + i,
                        "p99_ms": 200.0 + i, "dropped": 50 if cong else 0}
            return scripted

        (attempts, r), (ref_attempts, ref) = _both(
            monkeypatch, make, n_frames=n_frames, batch_size=8, height=8,
            width=8, target_fps=target, max_backoffs=max_backoffs)
        assert 1 <= len(attempts) <= max_backoffs + 1
        rates = [a[0] for a in attempts]
        frames = [a[1] for a in attempts]
        for j in range(1, len(attempts)):
            assert rates[j] == rates[j - 1] / 2.0
            assert frames[j] <= frames[j - 1]
            assert frames[j] >= min(16, n_frames)
        assert r["backoffs"] == len(attempts) - 1
        assert r["target_fps"] == rates[-1]
        assert r["p50_ms"] == 100.0 + len(attempts) - 1  # last attempt's
        last_cong = congested_seq[min(len(attempts) - 1,
                                      len(congested_seq) - 1)]
        assert r["congested"] is last_cong
        assert (attempts, r) == (ref_attempts, ref)

    check()


# ---------------------------------------------------------------------------
# The bench JSON writers (counterpart of test_obs.py::TestExportSchemas::
# test_bench_json_writers) and the fleet bench filter
# ---------------------------------------------------------------------------

def test_bench_json_writers():
    from dvf_tpu_torch.benchmarks import roofline_fields
    from dvf_tpu_torch.obs.registry import walk_export
    from dvf_tpu_torch.transport.codec import jpeg_wire_budget

    def clean(label, doc):
        assert not walk_export(doc), (label, walk_export(doc))

    clean("bench_transfer", bench_transfer(2, 16, 16, reps=2, device=CPU))
    r = bench_device_resident(get_filter("invert"), iters=3, batch_size=2,
                              height=16, width=16, device=CPU)
    clean("bench_device_resident", r)
    clean("roofline", roofline_fields(dict(r, fps=100.0), "cuda"))
    clean("bench_stage_decomposition",
          bench_stage_decomposition(get_filter("invert"), (1,), 16, 16, reps=2,
                                    device=CPU))
    clean("bench_e2e_streaming",
          bench_e2e_streaming(get_filter("invert"), 16, 4, 16, 16, device=CPU))
    clean("jpeg_wire_budget", jpeg_wire_budget(32, 32, threads=1))


def test_fleet_bench_filter_is_the_references():
    assert B.FLEET_BENCH_FILTER == RB.FLEET_BENCH_FILTER
    name, kw = B.FLEET_BENCH_FILTER
    filt = get_filter(name, **kw)
    c = cost.filter_cost(filt, (4, 16, 16, 3))
    assert c.flops == 3 * cost.ops_sep_blur((4, 16, 16, 3), 9, 9)


def test_measure_parallel_capacity_counts_processes():
    """One process against one: about 1. Both children run pinned to one
    core (the probe's processes inherit this thread's affinity), so a
    burst of other work on the host lands on both or on neither, and the
    reading is taken twice. A defect in the count shows in both
    readings; a skip (with both) only where they disagree, one inside
    the bar and one outside: then the host, not the count, moved."""
    core = sorted(os.sched_getaffinity(0))[-1]

    def capacity() -> float:
        mine = os.sched_getaffinity(0)
        os.sched_setaffinity(0, {core})
        try:
            return B.measure_parallel_capacity(1, seconds=0.2)
        finally:
            os.sched_setaffinity(0, mine)

    before, after = capacity(), capacity()
    inside = [0.5 < cap < 2.0 for cap in (before, after)]
    if inside[0] != inside[1]:
        pytest.skip(f"capacity {before} before and {after} after on core "
                    f"{core}: the readings disagree (host load moved)")
    assert all(inside), (before, after)


def test_measure_parallel_capacity_is_the_references():
    """The port's probe is a copy of the reference's: the same code,
    statement for statement (the docstrings differ)."""
    import ast
    import inspect

    def body(fn):
        tree = ast.parse(inspect.getsource(fn)).body[0]
        return ast.dump(ast.Module(tree.body[1:], []))

    assert body(B.measure_parallel_capacity) == body(RB.measure_parallel_capacity)


# ---------------------------------------------------------------------------
# Engine.cost_analysis for every BENCH_CONFIGS filter
# ---------------------------------------------------------------------------

SMALL = (2, 16, 32, 3)


def _engine(config: str) -> Engine:
    name, kw = BENCH_CONFIGS[config]["filter"]
    eng = Engine(get_filter(name, **kw), device=CPU)
    eng.compile(SMALL)
    return eng


def _frame_bytes(shape) -> int:
    return int(np.prod(shape))


@pytest.mark.parametrize("config", sorted(BENCH_CONFIGS))
def test_cost_analysis_for_every_bench_config(config):
    eng = _engine(config)
    ca = eng.cost_analysis()
    assert set(ca) == {"flops_per_batch", "bytes_accessed_per_batch"}
    b, h, w, c = SMALL
    n = b * h * w
    fname, kw = BENCH_CONFIGS[config]["filter"]
    flops = {
        "invert": b * h * w * c,
        "gaussian_blur": cost.ops_sep_blur(SMALL, kw.get("ksize", 9),
                                           kw.get("ksize", 9)),
        "sobel_bilateral": cost.ops_sobel_bilateral(SMALL, 5),
        "flow_warp": cost.ops_flow_warp(SMALL),
        "style_transfer": 2 * 153_792 * n,
        "super_resolution": 2 * 26_688 * n,
    }[fname]
    assert ca["flops_per_batch"] == flops
    out = _frame_bytes(eng.out_shape)
    state = {"flow_warp": 2, "style_transfer": 1,
             "super_resolution": 1}.get(fname, 0) * eng.state_bytes
    assert ca["bytes_accessed_per_batch"] == _frame_bytes(SMALL) + out + state
    if fname == "super_resolution":
        assert out == 4 * _frame_bytes(SMALL)
    if fname == "flow_warp":   # the previous frame (float32) and a flag
        assert eng.state_bytes == h * w * c * 4 + 1


def test_cost_analysis_of_invert_equals_xlas():
    """For invert the count equals the bytes XLA's cost analysis reports
    for the reference's engine at the same signature."""
    from dvf_tpu.runtime.engine import Engine as RefEngine

    ref = RefEngine(ref_get_filter("invert"))
    ref.compile(SMALL, np.uint8)
    assert _engine("invert_1080p").cost_analysis()["bytes_accessed_per_batch"] \
        == ref.cost_analysis()["bytes_accessed_per_batch"] == 2 * _frame_bytes(SMALL)


def test_cost_analysis_at_the_acceptance_shapes():
    """style_720p's flops are 2 x 153,792 MAC per pixel, sr2x_540p's
    2 x 26,688 per low-resolution pixel, invert_1080p's bytes 2·B·H·W·3
    (counted at the configs' own shapes, without compiling them)."""
    def at(config):
        spec = BENCH_CONFIGS[config]
        name, kw = spec["filter"]
        shape = (spec["batch"], spec["h"], spec["w"], 3)
        return cost.filter_cost(get_filter(name, **kw), shape), shape

    c, (b, h, w, _) = at("style_720p")
    assert c.flops == 2 * 153_792 * b * h * w and c.peak_flops_s == 989e12
    c, (b, h, w, _) = at("sr2x_540p")
    assert c.flops == 2 * 26_688 * b * h * w
    c, shape = at("invert_1080p")
    assert c.state_passes == 0 and c.flops == np.prod(shape)


def test_cost_analysis_is_none_before_compile_and_for_unknown_filters():
    assert Engine(get_filter("invert"), device=CPU).cost_analysis() is None
    eng = Engine(get_filter("sepia"), device=CPU)
    eng.compile((1, 8, 8, 3))
    assert eng.cost_analysis() is None


def test_cost_of_both_sobel_bilateral_impls_is_one_count():
    shape = (1, 8, 8, 3)
    a = cost.filter_cost(get_filter("sobel_bilateral"), shape)
    b = cost.filter_cost(get_filter("sobel_bilateral", impl="chain"), shape)
    assert a == b and a.flops == cost.ops_sobel_bilateral(shape, 5)
    blur3 = cost.filter_cost(get_filter("gaussian_blur", ksize=3), shape)
    assert blur3.flops == cost.ops_sep_blur(shape, 3, 3)
    assert cost.filter_cost(get_filter("bilateral", d=7), shape).flops == \
        cost.ops_bilateral(shape, 7)
