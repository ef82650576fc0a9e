"""The port's streamed ingest and egress (``dvf_tpu_torch/runtime/ingest.py``
and ``egress.py``), its engine's resident entry, probe and calibrations,
and its pipeline in both modes, against the JAX package on the CPU.

Streamed and monolithic paths must deliver byte-identical, identically
ordered frames; against the JAX package's pipeline on the same seeded
stream, invert byte for byte and the float filters within 1 LSB. Both
packages run with their streaming gates opened (``MIN_STREAM_*`` = 0,
``STREAM_ON_CPU``), as the reference's own stream tests do, so the
streamed machinery runs at test sizes. The steady state allocates no
large buffer per batch, in the pipeline and in the worker.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch
from dvf_tpu.io.sources import SyntheticSource as JaxSource
from dvf_tpu.obs.metrics import EgressStats as JaxEgressStats
from dvf_tpu.obs.metrics import IngestStats as JaxIngestStats
from dvf_tpu.parallel import MeshConfig, make_mesh
from dvf_tpu.runtime import Engine as JaxEngine
from dvf_tpu.runtime import egress as jax_egress
from dvf_tpu.runtime import ingest as jax_ingest
from dvf_tpu.runtime.pipeline import Pipeline as JaxPipeline
from dvf_tpu.runtime.pipeline import PipelineConfig as JaxConfig
from dvf_tpu_torch import CallbackSink, NullSink, Pipeline, PipelineConfig, SyntheticSource
from dvf_tpu_torch.obs.metrics import EgressStats, IngestStats
from dvf_tpu_torch.runtime import egress as egress_mod
from dvf_tpu_torch.runtime import engine as engine_mod
from dvf_tpu_torch.runtime import ingest as ingest_mod
from dvf_tpu_torch.runtime.egress import ShardedBatchFetcher
from dvf_tpu_torch.runtime.engine import Engine
from dvf_tpu_torch.runtime.ingest import ShardedBatchAssembler

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _force_streaming(monkeypatch):
    """Open the cheap-transfer and zero-copy gates in both packages so the
    streamed paths run at test sizes (the reference's stream tests do the
    same)."""
    monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 0.0)
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", True)
    monkeypatch.setattr(jax_ingest, "MIN_STREAM_H2D_MS", 0.0)
    monkeypatch.setattr(jax_egress, "MIN_STREAM_D2H_MS", 0.0)
    monkeypatch.setattr(jax_egress, "STREAM_ON_CPU", True)


def _rng_frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def _padded_ref(frames, batch_size):
    out = np.empty((batch_size, *frames[0].shape), frames[0].dtype)
    for i, f in enumerate(frames):
        out[i] = f
    out[len(frames):] = frames[-1]
    return out


# ---------------------------------------------------------------------------
# Assembler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,depth", [(4, 1), (8, 2), (8, 4), (3, 4)])
def test_write_row_matches_stacked_batch(batch, depth):
    """Per-row staging at depth 1, 2 and 4 (and more chunks asked for than
    rows) equals the padded stacked batch, across aliasing slots and
    short batches."""
    h, w = 16, 24
    asm = ShardedBatchAssembler((batch, h, w, 3), np.uint8, CPU,
                                depth=depth, slots=3)
    assert asm.effective_mode == "streamed"
    assert len(asm._chunks) == min(depth, batch)
    for slot, valid in enumerate([batch, max(1, batch - 1), 1, batch]):
        frames = _rng_frames(valid, h, w, seed=slot)
        b = asm.begin(slot)
        for row, f in enumerate(frames):
            b.write_row(row, f)
        arr, resident = b.finish(valid)
        assert resident and arr.device == CPU
        np.testing.assert_array_equal(arr.numpy(), _padded_ref(frames, batch))
    s = asm.stats.summary()
    assert s["batches"] == 4 and s["pool_allocs"] == 1 and s["mode"] == "streamed"


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_window_decode_path_matches_stacked_batch(depth):
    """windows / window_view / commit_window (the codec wire's bulk decode)
    equal per-row writes."""
    batch, h, w = 8, 16, 24
    asm = ShardedBatchAssembler((batch, h, w, 3), np.uint8, CPU,
                                depth=depth, slots=2)
    for slot, valid in enumerate([batch, 5, 2]):
        frames = _rng_frames(valid, h, w, seed=10 + slot)
        b = asm.begin(slot)
        windows = b.windows(valid)
        assert windows[0][0] == 0 and windows[-1][1] == valid
        assert all(s2 == e1 for (_, e1), (s2, _) in zip(windows, windows[1:]))
        for start, stop in windows:
            view = b.window_view(start, stop)
            assert view.shape == (stop - start, h, w, 3)
            view[:] = np.stack(frames[start:stop])
            b.commit_window(start, stop)
        arr, resident = b.finish(valid)
        assert resident
        np.testing.assert_array_equal(arr.numpy(), _padded_ref(frames, batch))


def test_monolithic_assembler_reuses_slot_buffers():
    asm = ShardedBatchAssembler((4, 8, 8, 3), np.uint8, CPU,
                                mode="monolithic", slots=2)
    b = asm.begin(0)
    b.write_row(0, np.zeros((8, 8, 3), np.uint8))
    a0, resident = b.finish(1)
    assert not resident and a0.device == CPU
    b = asm.begin(2)  # slot 2 % 2 == slot 0: the same buffer
    b.write_row(0, np.ones((8, 8, 3), np.uint8))
    a1, _ = b.finish(1)
    assert a0 is a1
    np.testing.assert_array_equal(a1.numpy(), np.ones((4, 8, 8, 3), np.uint8))
    assert asm.stats.fallback_reason is None
    # No device: monolithic, as the reference with no sharding.
    assert ShardedBatchAssembler((4, 8, 8, 3), np.uint8, None).effective_mode \
        == "monolithic"


def test_cheap_transfer_keeps_ingest_monolithic(monkeypatch):
    monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 2.0)
    shape = (8, 16, 16, 3)
    stats = IngestStats(h2d_block_ms=0.1)
    asm = ShardedBatchAssembler(shape, np.uint8, CPU, stats=stats)
    assert asm.effective_mode == "monolithic"
    assert stats.fallback_reason == "cheap_transfer"
    stats2 = IngestStats(h2d_block_ms=50.0)
    asm2 = ShardedBatchAssembler(shape, np.uint8, CPU, stats=stats2)
    assert asm2.effective_mode == "streamed"
    assert stats2.fallback_reason is None
    # The same thresholds as the reference's.
    assert ingest_mod.INGEST_MODES == jax_ingest.INGEST_MODES
    assert egress_mod.EGRESS_MODES == jax_egress.EGRESS_MODES


def test_assembler_bad_args_and_release():
    shape = (4, 8, 8, 3)
    with pytest.raises(ValueError, match="ingest mode"):
        ShardedBatchAssembler(shape, np.uint8, CPU, mode="bogus")
    with pytest.raises(ValueError, match="depth"):
        ShardedBatchAssembler(shape, np.uint8, CPU, depth=0)
    asm = ShardedBatchAssembler(shape, np.uint8, CPU, mode="monolithic")
    with pytest.raises(ValueError, match="valid"):
        asm.begin(0).finish(0)
    with pytest.raises(ValueError, match="valid"):
        asm.begin(0).finish(5)
    assert asm.slab_bytes() == 5 * int(np.prod(shape))
    assert ingest_mod.occupied_slab_bytes() >= asm.slab_bytes()
    asm.release()
    assert asm.slab_bytes() == 0 and asm in ingest_mod.live_assemblers()
    with pytest.raises(RuntimeError, match="released"):
        asm.begin(0)


# ---------------------------------------------------------------------------
# Fetcher
# ---------------------------------------------------------------------------


def _engine(name="invert", shape=(4, 16, 24, 3), **kw):
    eng = Engine(dvf_tpu_torch.get_filter(name, **kw), device="cpu")
    eng.ensure_compiled(shape, np.uint8)
    return eng


def test_fetch_matches_submit_across_slots():
    batch, h, w = 4, 16, 24
    eng = _engine(shape=(batch, h, w, 3))
    fetcher = ShardedBatchFetcher(eng.out_shape, eng.out_dtype, eng.device, slots=3)
    assert fetcher.effective_mode == "streamed"
    outs = []
    for slot in range(5):
        frames = np.stack(_rng_frames(batch, h, w, seed=slot))
        want = eng.submit(frames).fetch().copy()
        result = eng.submit(frames, fetch=False)
        fetcher.prefetch(result, slot)
        out = fetcher.fetch(result, slot)
        np.testing.assert_array_equal(out, want)
        assert fetcher.owns(out)
        outs.append(out)
    assert outs[0] is outs[3]  # slot 3 % 3 == slot 0: the same slab
    s = fetcher.stats.summary()
    assert s["batches"] == 5 and s["pool_allocs"] == 1 and s["mode"] == "streamed"
    assert egress_mod.occupied_slab_bytes() >= fetcher.slab_bytes() > 0
    fetcher.release()
    assert fetcher.slab_bytes() == 0


def test_monolithic_fetch_is_a_fresh_array():
    eng = _engine(shape=(4, 8, 8, 3))
    fetcher = ShardedBatchFetcher(eng.out_shape, eng.out_dtype, eng.device,
                                  mode="monolithic", slots=3)
    assert fetcher.effective_mode == "monolithic"
    a = fetcher.fetch(eng.submit(np.zeros((4, 8, 8, 3), np.uint8), fetch=False), 0)
    b = fetcher.fetch(eng.submit(np.ones((4, 8, 8, 3), np.uint8), fetch=False), 1)
    assert not fetcher.owns(a) and not np.shares_memory(a, b)
    np.testing.assert_array_equal(a, np.full((4, 8, 8, 3), 255))
    np.testing.assert_array_equal(b, np.full((4, 8, 8, 3), 254))


def test_fetcher_fallbacks(monkeypatch):
    eng = _engine(shape=(4, 8, 8, 3))
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", False)
    f = ShardedBatchFetcher(eng.out_shape, eng.out_dtype, eng.device)
    assert f.effective_mode == "monolithic"
    assert f.stats.fallback_reason == "zero_copy_backend"
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", True)
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 2.0)
    stats = EgressStats(d2h_block_ms=0.1)
    f = ShardedBatchFetcher(eng.out_shape, eng.out_dtype, eng.device, stats=stats)
    assert f.effective_mode == "monolithic" and stats.fallback_reason == "cheap_transfer"
    stats2 = EgressStats(d2h_block_ms=50.0)
    f2 = ShardedBatchFetcher(eng.out_shape, eng.out_dtype, eng.device, stats=stats2)
    assert f2.effective_mode == "streamed" and stats2.fallback_reason is None
    with pytest.raises(ValueError, match="egress mode"):
        ShardedBatchFetcher((4, 8, 8, 3), np.uint8, CPU, mode="bogus")


def test_geometry_mismatch_falls_back_per_batch():
    """A result at another geometry than the pool's (a mid-stream geometry
    change) is fetched the classic way, never written into a slab."""
    eng = _engine(shape=(4, 8, 8, 3))
    fetcher = ShardedBatchFetcher((4, 16, 16, 3), np.uint8, eng.device, slots=2)
    result = eng.submit(np.zeros((4, 8, 8, 3), np.uint8), fetch=False)
    fetcher.prefetch(result, 0)
    out = fetcher.fetch(result, 0)
    assert out.shape == (4, 8, 8, 3) and not fetcher.owns(out)
    np.testing.assert_array_equal(out, np.full((4, 8, 8, 3), 255))


# ---------------------------------------------------------------------------
# Stats against the reference's classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["streamed", "monolithic"])
def test_ingest_and_egress_stats_match_reference(mode):
    records = [(1.0, 1.5, 0.5, 3.0), (0.2, 0.1, 0.0, 0.9), (2.0, 4.0, 3.0, 9.0)]
    for cal in (10.0, 1.0, None):
        ours, ref = IngestStats(mode, 4, cal), JaxIngestStats(mode, 4, cal)
        ours.effective_mode = ref.effective_mode = mode
        for r in records:
            ours.record_batch(*r)
            ref.record_batch(*r)
        assert ours.overlap_efficiency() == ref.overlap_efficiency()
        # The port's summary also reports the mean span the reference sums
        # and never reads.
        got = ours.summary()
        assert got.pop("span_ms") == pytest.approx(sum(r[3] for r in records) / 3, abs=1e-4)
        assert got == ref.summary()
        eo, er = EgressStats(mode, 2, cal), JaxEgressStats(mode, 2, cal)
        eo.effective_mode = er.effective_mode = mode
        for w, c, s, _ in records:
            for st in (eo, er):
                st.record_fetch(wait_ms=w, copy_ms=c, span_ms=s)
                st.record_encode(encode_ms=s, wait_ms=w)
                st.record_entropy(c)
                st.record_send(w)
        assert eo.overlap_efficiency() == er.overlap_efficiency()
        got = eo.summary()
        assert got.pop("span_ms") == pytest.approx(sum(r[2] for r in records) / 3, abs=1e-4)
        assert got == er.summary()
    s = IngestStats(h2d_block_ms=10.0)
    s.record_batch(stage_ms=1.0, put_ms=1.5, wait_ms=0.5, span_ms=3.0)
    assert s.overlap_efficiency() == pytest.approx(0.8)


# ---------------------------------------------------------------------------
# Engine: resident entry, probe, calibrations
# ---------------------------------------------------------------------------


def test_submit_resident_matches_submit():
    eng = _engine("gaussian_blur", shape=(4, 16, 16, 3), ksize=5)
    batch = np.random.default_rng(0).integers(0, 255, (4, 16, 16, 3), np.uint8)
    ref = eng.submit(batch).fetch().copy()
    res = eng.run_device_resident(torch.from_numpy(batch.copy()))
    assert res.host is None and res.is_ready()
    np.testing.assert_array_equal(res.device.numpy(), ref)
    with pytest.raises(RuntimeError, match="fetch=False"):
        res.fetch()
    assert eng.stats.batches == 2 and eng.stats.frames == 8


def test_run_probe_touches_no_state_and_refuses_what_the_reference_refuses():
    eng = Engine(dvf_tpu_torch.get_filter("invert"), device="cpu")
    batch = np.random.default_rng(1).integers(0, 255, (2, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="cannot probe an uncompiled engine"):
        eng.run_probe(batch)
    eng.ensure_compiled(batch.shape)
    before = dict(vars(eng.stats))
    np.testing.assert_array_equal(eng.run_probe(batch), 255 - batch)
    assert dict(vars(eng.stats)) == before
    with pytest.raises(ValueError, match="does not match the compiled signature"):
        eng.run_probe(batch[:1])
    eng.free()
    with pytest.raises(RuntimeError, match="cannot probe a freed engine"):
        eng.run_probe(batch)
    flow = Engine(dvf_tpu_torch.get_filter("flow_warp", levels=1, win_size=5,
                                           n_iters=1), device="cpu")
    flow.ensure_compiled((2, 16, 16, 3))
    with pytest.raises(ValueError, match="cannot probe stateful filter"):
        flow.run_probe(np.zeros((2, 16, 16, 3), np.uint8))


def test_compile_calibrates_and_adopts_a_seed(monkeypatch):
    eng = Engine(dvf_tpu_torch.get_filter("invert"), device="cpu")
    assert eng.h2d_block_ms is None and eng.signature is None
    eng.ensure_compiled((4, 16, 16, 3))
    for v in (eng.h2d_block_ms, eng.d2h_block_ms, eng.step_block_ms,
              eng.last_compile_ms):
        assert v is not None and v >= 0
    assert eng.signature == ((4, 16, 16, 3), np.dtype(np.uint8))
    assert not eng.calibration_seeded and eng.state_bytes == 0
    seed = {"h2d_block_ms": 3.5, "d2h_block_ms": None, "step_block_ms": 1.25}
    s = Engine(dvf_tpu_torch.get_filter("invert"), device="cpu",
               calibration_seed=seed)
    s.ensure_compiled((4, 16, 16, 3))
    assert s.calibration_seeded
    assert (s.h2d_block_ms, s.d2h_block_ms, s.step_block_ms) == (3.5, None, 1.25)
    monkeypatch.setattr(engine_mod, "_D2H_CALIBRATION_CAP_BYTES", 1)
    big = Engine(dvf_tpu_torch.get_filter("invert"), device="cpu")
    big.ensure_compiled((4, 16, 16, 3))
    assert big.d2h_block_ms is None and big.step_block_ms is None
    assert big.h2d_block_ms is not None and big.out_shape == (4, 16, 16, 3)
    flow = Engine(dvf_tpu_torch.get_filter("flow_warp", levels=1, win_size=5,
                                           n_iters=1), device="cpu")
    flow.ensure_compiled((2, 16, 16, 3))
    assert flow.state_bytes > 0


def test_out_uint8_false_returns_the_float_output():
    x = np.random.default_rng(2).integers(0, 255, (2, 16, 16, 3), np.uint8)
    filt = dvf_tpu_torch.get_filter("gaussian_blur", ksize=5)
    eng = Engine(filt, device="cpu", out_uint8=False)
    got = eng.submit(x).fetch()
    assert got.dtype == np.float32 and eng.out_dtype == np.float32
    from dvf_tpu_torch.utils.image import to_float

    want = filt.fn(to_float(torch.from_numpy(x), torch.float32), None)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_rebuild_is_compiled_at_the_old_signature():
    eng = _engine(shape=(2, 8, 8, 3))
    fresh = eng.rebuild()
    assert fresh is not eng and fresh.signature == eng.signature
    assert fresh.h2d_block_ms is not None and fresh.stats.compile_count == 1


def test_identity_output_owns_its_bytes():
    """A filter that hands back its input: the output must not alias the
    staging buffer that is rewritten a few batches later."""
    eng = Engine(dvf_tpu_torch.get_filter("identity"), device="cpu")
    x = torch.from_numpy(np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3))
    res = eng.submit_resident(x)
    assert res.device.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(res.device.numpy(), x.numpy())


# ---------------------------------------------------------------------------
# Pipelines: streamed vs monolithic, and against the reference
# ---------------------------------------------------------------------------


def _run_port(name, kw, ingest, egress, n=30, batch=4, h=24, w=32, **cfg):
    got, order = {}, []

    def keep(i, f, _ts):
        order.append(i)
        got[i] = f.copy()

    stats = Pipeline(SyntheticSource(h, w, n_frames=n, seed=0),
                     dvf_tpu_torch.get_filter(name, **kw), CallbackSink(keep),
                     PipelineConfig(batch_size=batch, queue_size=1000,
                                    ingest=ingest, egress=egress, **cfg),
                     device="cpu").run()
    return order, got, stats


def _run_ref(name, kw, n=30, batch=4, h=24, w=32, **cfg):
    got, order = {}, []

    def keep(i, f, _ts):
        order.append(i)
        got[i] = np.array(f)

    # The single-device mesh: the counterpart of the one card.
    filt = dvf_tpu.get_filter(name, **kw)
    stats = JaxPipeline(JaxSource(h, w, n_frames=n, seed=0), filt, CallbackSink(keep),
                        JaxConfig(batch_size=batch, queue_size=1000, **cfg),
                        engine=JaxEngine(filt, mesh=make_mesh(MeshConfig(data=1)))).run()
    return order, got, stats


FLOW = ("flow_warp", {"levels": 1, "win_size": 7, "n_iters": 1, "max_disp": 2,
                      "warp_impl": "pallas"})


@pytest.mark.parametrize("spec,max_lsb", [
    (("invert", {}), 0),
    (("gaussian_blur", {"ksize": 5, "impl": "shift"}), 1),
    (FLOW, 1),
], ids=["invert", "gaussian_blur", "flow_warp"])
def test_streamed_and_monolithic_match_each_other_and_the_reference(spec, max_lsb):
    name, kw = spec
    flow = name == "flow_warp"
    geo = dict(n=18, batch=4, h=32, w=48, assemble_timeout_s=60.0) if flow \
        else dict(n=30, batch=4)
    runs = {}
    for mode in ("streamed", "monolithic"):
        order, got, stats = _run_port(name, kw, mode, mode, **geo)
        n = geo["n"]
        assert order == list(range(n)) and stats["delivered"] == n
        assert stats["ingest"]["mode"] == mode and stats["egress"]["mode"] == mode
        runs[mode] = got
    for i in runs["monolithic"]:
        np.testing.assert_array_equal(runs["streamed"][i], runs["monolithic"][i])
    ref_order, ref, ref_stats = _run_ref(name, kw, **geo)
    assert ref_order == order
    assert ref_stats["ingest"]["mode"] == "streamed"
    for i in ref_order:
        diff = np.abs(runs["streamed"][i].astype(np.int16) - ref[i].astype(np.int16))
        assert diff.max() <= max_lsb, (i, diff.max())
    assert PipelineConfig().ingest == JaxConfig().ingest == "streamed"
    assert PipelineConfig().egress == JaxConfig().egress == "streamed"


def _slow(eng, secs):
    """Slow the engine's submit entries down so the in-flight window fills
    and the staging slots wrap while older batches are still queued."""
    orig_r, orig_s = eng.submit_resident, eng.submit

    def slow_resident(b, ready=None):
        time.sleep(secs)
        return orig_r(b, ready=ready)

    def slow_submit(b, out=None, fetch=True):
        time.sleep(secs)
        return orig_s(b, out=out, fetch=fetch)

    eng.submit_resident, eng.submit = slow_resident, slow_submit


@pytest.mark.parametrize("spec", [("invert", {}), FLOW], ids=["invert", "flow_warp"])
def test_slot_reuse_under_a_full_window_with_reorder_residency(spec):
    """max_inflight 2, a slowed device and frame_delay 8: the staging and
    delivery slots wrap while the reorder buffer still holds earlier rows
    (a stateful filter carries its window across the same reuse). Rows
    must own their bytes, and the state must hold no view of a slot."""
    name, kw = spec
    runs = {}
    for mode in ("streamed", "monolithic"):
        got = {}
        eng = Engine(dvf_tpu_torch.get_filter(name, **kw), device="cpu")
        _slow(eng, 0.005)
        stats = Pipeline(SyntheticSource(32, 48, n_frames=24, seed=3), eng.filter,
                         CallbackSink(lambda i, f, _: got.__setitem__(i, f.copy())),
                         PipelineConfig(batch_size=2, queue_size=1000, frame_delay=8,
                                        max_inflight=2, ingest=mode, egress=mode,
                                        ingest_depth=1, assemble_timeout_s=60.0),
                         engine=eng).run()
        assert stats["delivered"] == 24 and sorted(got) == list(range(24))
        runs[mode] = got
    for i in range(24):
        np.testing.assert_array_equal(runs["streamed"][i], runs["monolithic"][i])
    if name == "invert":
        frames = [f for f, _ in SyntheticSource(32, 48, n_frames=24, seed=3)][:-1]
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(runs["streamed"][i], 255 - f)


@pytest.mark.parametrize("ingest,egress", [("streamed", "monolithic"),
                                           ("monolithic", "streamed")])
def test_mixed_modes_deliver_the_same_frames(ingest, egress):
    order, got, stats = _run_port("invert", {}, ingest, egress, n=21, batch=4)
    frames = [f for f, _ in SyntheticSource(24, 32, n_frames=21, seed=0)][:-1]
    assert order == list(range(21))
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(got[i], 255 - f)
    assert stats["ingest"]["mode"] == ingest and stats["egress"]["mode"] == egress


def test_streamed_defaults_reported_and_gated(monkeypatch):
    """The defaults stream and report their calibrations; with the gates
    closed again (the CPU defaults) both fall back and say why."""
    _, _, stats = _run_port("invert", {}, "streamed", "streamed", n=12)
    ing, eg = stats["ingest"], stats["egress"]
    assert ing["mode"] == "streamed" and ing["batches"] >= 3
    assert ing["h2d_block_ms"] is not None and eg["d2h_block_ms"] is not None
    assert eg["pool_allocs"] == 1 and ing["pool_allocs"] == 1
    for e in (ing["overlap_efficiency"], eg["overlap_efficiency"]):
        assert e is None or 0.0 <= e <= 1.0
    monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 1e9)
    monkeypatch.setattr(egress_mod, "STREAM_ON_CPU", False)
    _, _, stats = _run_port("invert", {}, "streamed", "streamed", n=8)
    assert stats["ingest"]["fallback_reason"] == "cheap_transfer"
    assert stats["egress"]["fallback_reason"] == "zero_copy_backend"
    with pytest.raises(ValueError, match="ingest"):
        Pipeline(SyntheticSource(8, 8, n_frames=2), dvf_tpu_torch.get_filter("invert"),
                 NullSink(), PipelineConfig(ingest="bogus"), device="cpu")
    with pytest.raises(ValueError, match="egress"):
        Pipeline(SyntheticSource(8, 8, n_frames=2), dvf_tpu_torch.get_filter("invert"),
                 NullSink(), PipelineConfig(egress="bogus"), device="cpu")


def test_traced_runs_emit_the_reference_span_names(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # run() exports the trace into the CWD
    cfg = dict(batch_size=4, queue_size=100, frame_delay=0, trace=True,
               ingest_depth=2)
    pipe = Pipeline(SyntheticSource(16, 16, n_frames=8), dvf_tpu_torch.get_filter("invert"),
                    NullSink(), PipelineConfig(**cfg), device="cpu")
    pipe.run()
    jf = dvf_tpu.get_filter("invert")
    ref = JaxPipeline(JaxSource(16, 16, n_frames=8), jf, NullSink(), JaxConfig(**cfg),
                      engine=JaxEngine(jf, mesh=make_mesh(MeshConfig(data=1))))
    ref.run()
    ours = {e["name"] for e in pipe.tracer._events}
    theirs = {e["name"] for e in ref.tracer._events}
    # Every reference name, plus the port's spans inside its own threads.
    assert ours - theirs == {"pipeline.assemble", "pipeline.window_wait", "engine.launch",
                             "egress.fetch", "egress.wait_compute", "pipeline.deliver"}
    assert theirs <= ours
    assert {"ingest_h2d", "ingest_overlap", "ingest_stage", "egress_d2h",
            "batch_complete", "frame_captured", "frame_delivered"} <= ours
    assert (tmp_path / "dvf_frame_timing.pftrace").exists()
    snap = pipe.tracer.snapshot()
    doc = dvf_tpu_torch.obs.merge_tracer_snapshots([snap, snap])
    assert len(doc["traceEvents"]) > len(snap["events"])


# ---------------------------------------------------------------------------
# Steady state: no large allocation per batch
# ---------------------------------------------------------------------------

_BIG = 300_000  # bytes; staging slabs sit above, frames below


class _AllocCounter:
    """Counts large np.empty and torch.empty calls — the allocations the
    staging and slab pools exist to remove from the hot loop."""

    def __init__(self, monkeypatch):
        self.big = []
        real_np, real_torch = np.empty, torch.empty

        def np_empty(shape, dtype=float, **kw):
            arr = real_np(shape, dtype, **kw)
            if arr.nbytes >= _BIG:
                self.big.append(arr.nbytes)
            return arr

        def torch_empty(*a, **kw):
            t = real_torch(*a, **kw)
            if t.numel() * t.element_size() >= _BIG:
                self.big.append(t.numel() * t.element_size())
            return t

        monkeypatch.setattr(np, "empty", np_empty)
        monkeypatch.setattr(torch, "empty", torch_empty)


def test_pipeline_steady_state_allocates_nothing(monkeypatch):
    def run(n_frames):
        with monkeypatch.context() as m:
            counter = _AllocCounter(m)
            stats = Pipeline(SyntheticSource(128, 256, n_frames=n_frames),
                             dvf_tpu_torch.get_filter("invert"), NullSink(),
                             PipelineConfig(batch_size=8, queue_size=1000,
                                            frame_delay=0),
                             device="cpu").run()
        assert stats["delivered"] == n_frames
        assert stats["ingest"]["pool_allocs"] == 1
        assert stats["egress"]["pool_allocs"] == 1
        assert stats["ingest"]["mode"] == stats["egress"]["mode"] == "streamed"
        return len(counter.big)

    run(8)
    assert run(16) == run(48)


def test_worker_steady_state_allocates_nothing(monkeypatch):
    def run(batches):
        with monkeypatch.context() as m:
            counter = _AllocCounter(m)
            worker = dvf_tpu_torch.ZmqWorker(
                dvf_tpu_torch.get_filter("invert"), batch_size=8, wire="raw",
                raw_size=128, device="cpu", connect=False)
            sent = []
            try:
                for b in range(batches):
                    worker.process_batch(
                        [(8 * b + i, np.full((128, 128, 3), (8 * b + i) % 251,
                                             np.uint8).tobytes()) for i in range(8)],
                        lambda i, t0, t1, p: sent.append((i, bytes(p))))
                worker.drain_egress()
                stats = worker.stats()
            finally:
                worker.close()
        assert [i for i, _ in sent] == list(range(8 * batches))
        for i, p in sent:
            assert p == np.full((128, 128, 3), 255 - i % 251, np.uint8).tobytes()
        assert stats["ingest"]["mode"] == stats["egress"]["mode"] == "streamed"
        assert stats["ingest"]["pool_allocs"] == stats["egress"]["pool_allocs"] == 1
        return len(counter.big)

    run(1)
    assert run(2) == run(6)
