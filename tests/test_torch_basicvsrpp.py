"""BasicVSR++ ×4 in the port (``models/basicvsrpp.py``,
``super_resolution(arch="basicvsrpp")``) held to the benchmark's plain
float32 reference (``portbench/reference/basicvsrpp.py``, written apart
from the port), on the CPU at small shapes: the whole net at a small
width and at the published widths, the deformable conv against a
per-pixel loop over the DCNv2 definition, the two warps, the clip rule of
the pipeline, the frontends that refuse a clip filter, and the filter's
entry, spans and counters. The JAX package has no BasicVSR++, so the
reference here is the benchmark's."""

import dataclasses
import math
import threading
import time

import numpy as np
import pytest
import torch

import dvf_tpu_torch
from dvf_tpu_torch import CallbackSink, Pipeline, PipelineConfig
from dvf_tpu_torch.api.filter import Filter, FilterChain, stateless
from dvf_tpu_torch.models import basicvsrpp as vsr
from dvf_tpu_torch.obs.trace import Tracer
from dvf_tpu_torch.ops.flow import warp_by_flow
from dvf_tpu_torch.ops.sr import super_resolution
from portbench import spec
from portbench.reference import basicvsrpp as ref

CPU = torch.device("cpu")
PUBLISHED_NET = spec.load_config("basicvsrpp_x4")["net"]
GAINS = spec.load_config("basicvsrpp_x4")["gains"]
SMALL = vsr.BasicVsrConfig(mid_channels=16, num_blocks=1, compute_dtype=torch.float32)
SMALL_NET = dict(PUBLISHED_NET, mid_channels=16, num_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The forward is thousands of small ops: with every test worker's
    intra-op pool spinning on the same cores each op's barrier waits for a
    time slice, so one thread a worker runs it ~100× faster."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _clip(seed, t, h, w):
    """A ramp plus noise, rolled 2 px a frame (the benchmark's frames)."""
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((h, w, 3), generator=g) / 2 + torch.linspace(0, 1, w).view(1, w, 1) / 2
    return torch.stack([torch.roll(base, 2 * i, dims=1) for i in range(t)])


def _levels(a, b):
    """(max, RMS) of a − b in levels (× 255)."""
    d = (a - b) * 255.0
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def test_float32_matches_the_reference_at_a_small_width():
    params = vsr.init_basicvsrpp(3, SMALL)
    x = _clip(1, 3, 64, 72)
    got = vsr.apply_basicvsrpp(params, x, SMALL)
    want = ref.forward(params, x, SMALL_NET)
    assert got.shape == want.shape == (3, 256, 288, 3)
    # The same float32 arithmetic in another order (NHWC, one grid_sample
    # for the nine taps, one GEMM): measured max 6e-8.
    assert float((got - want.clamp(0, 1)).abs().max()) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_published_widths_match_the_reference(dtype):
    """Every published width and depth on a 64×64 × 3 clip, on the
    benchmark's own weights (its gains included)."""
    params = ref.make_params(PUBLISHED_NET, 5, CPU, gains=GAINS)
    x = _clip(2, 3, 64, 64)
    got = vsr.apply_basicvsrpp(params, x, dataclasses.replace(vsr.BasicVsrConfig(),
                                                                compute_dtype=dtype))
    want = ref.forward(params, x, PUBLISHED_NET).clamp(0, 1)
    top, rms = _levels(got, want)
    if dtype == torch.float32:
        assert top <= 5e-3                   # float32 reordering (measured ~1e-5 levels)
    else:
        # bf16 keeps 8 bits of mantissa: each of ~500 convs in sequence
        # (four passes of 3 steps, 15 convs a step) rounds at ~2^-9, and the
        # residual that conv_last adds is ~10-20 levels RMS (measured: RMS
        # 0.12-0.18 levels, max under 2 levels).
        assert rms <= 0.5 and top <= 6.0


def test_the_benchmarks_weights_fit_the_port():
    """The benchmark draws its own weights in the port's layout: the same
    convs and shapes as ``init_basicvsrpp``, 7.3 M parameters."""
    mine = vsr.init_basicvsrpp(4)
    theirs = ref.make_params(PUBLISHED_NET, 4, CPU)
    assert list(mine) == list(theirs)
    for name in mine:
        for leaf in ("w", "b"):
            assert mine[name][leaf].shape == theirs[name][leaf].shape, (name, leaf)
    n = sum(v["w"].numel() + v["b"].numel() for v in mine.values())
    assert n == pytest.approx(7.3e6, rel=0.01)


def _bilinear_zero(img, y, x):
    """img (C, H, W) at (y, x): each corner outside the frame reads 0."""
    c, h, w = img.shape
    y0, x0 = math.floor(y), math.floor(x)
    out = torch.zeros(c, dtype=torch.float64)
    for yy, wy in ((y0, 1 - (y - y0)), (y0 + 1, y - y0)):
        for xx, wx in ((x0, 1 - (x - x0)), (x0 + 1, x - x0)):
            if 0 <= yy < h and 0 <= xx < w:
                out += wy * wx * img[:, yy, xx].double()
    return out


def test_deform_conv_matches_the_dcnv2_definition():
    """mmcv's modulated deformable conv, pixel by pixel: offset channel
    2·(g·9 + k) is tap k's dy in group g and the next its dx, mask channel
    g·9 + k; a tap samples at (y + k // 3 − 1 + dy, x + k % 3 − 1 + dx),
    zero outside the frame; the output is Σ w · mask · sample + b."""
    g = torch.Generator().manual_seed(6)
    groups, cin, cout, h, w = 2, 6, 5, 5, 7
    x = torch.randn(1, h, w, cin, generator=g)
    offset = torch.randn(1, h, w, 18 * groups, generator=g) * 2.5   # many taps leave the frame
    mask = torch.rand(1, h, w, 9 * groups, generator=g)
    weight = torch.randn(cout, cin, 3, 3, generator=g)
    bias = torch.randn(cout, generator=g)
    got = vsr.deform_conv(x, offset, mask, weight.reshape(cout, -1).t().contiguous(), bias,
                          groups)
    img = x[0].permute(2, 0, 1)
    cg = cin // groups
    want = torch.zeros(h, w, cout, dtype=torch.float64)
    for yy in range(h):
        for xx in range(w):
            acc = bias.double().clone()
            for gi in range(groups):
                for k in range(9):
                    dy = float(offset[0, yy, xx, 2 * (gi * 9 + k)])
                    dx = float(offset[0, yy, xx, 2 * (gi * 9 + k) + 1])
                    m = float(mask[0, yy, xx, gi * 9 + k])
                    s = _bilinear_zero(img[gi * cg:(gi + 1) * cg],
                                       yy + k // 3 - 1 + dy, xx + k % 3 - 1 + dx)
                    acc += weight[:, gi * cg:(gi + 1) * cg, k // 3, k % 3].double() @ s * m
            want[yy, xx] = acc
    assert got.shape == (1, h, w, cout)
    # float32 against float64: sums of ~100 products of unit size.
    assert float((got[0].double() - want).abs().max()) <= 1e-4


def test_border_warp_is_the_ports_warp_by_flow():
    g = torch.Generator().manual_seed(7)
    img = torch.rand(2, 9, 11, 3, generator=g)
    flow = torch.randn(2, 9, 11, 2, generator=g) * 4          # past the border
    got = vsr.flow_warp(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), "border")
    want = warp_by_flow(img, flow)
    # grid_sample's normalised coordinates round the position once more.
    assert float((got.permute(0, 2, 3, 1) - want).abs().max()) <= 1e-5


def test_zero_warp_reads_zero_outside_the_frame():
    g = torch.Generator().manual_seed(8)
    img = torch.rand(1, 4, 6, 5, generator=g)                   # N, C, H, W
    flow = torch.randn(1, 2, 6, 5, generator=g) * 3
    got = vsr.flow_warp(img, flow, "zeros")[0]
    for y in range(6):
        for x in range(5):
            want = _bilinear_zero(img[0], y + float(flow[0, 1, y, x]), x + float(flow[0, 0, y, x]))
            assert torch.allclose(got[:, y, x].double(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# The filter
# ---------------------------------------------------------------------------


def test_filter_names_itself_marks_a_clip_and_leaves_the_registry_alone():
    before = dvf_tpu_torch.list_filters()
    filt = dvf_tpu_torch.get_filter("super_resolution", arch="basicvsrpp", scale=4)
    assert filt.name == "super_resolution(basicvsrpp,x4)" and filt.stateful and filt.clip
    assert not super_resolution(arch="hat", scale=4).clip and not super_resolution().clip
    assert dvf_tpu_torch.list_filters() == before


@pytest.mark.parametrize("scale", [2, 3, 8])
def test_other_scales_raise(scale):
    with pytest.raises(ValueError, match="scale"):
        super_resolution(arch="basicvsrpp", scale=scale)


def test_short_or_small_clips_raise():
    params = vsr.init_basicvsrpp(0, SMALL)
    for shape in [(1, 64, 64, 3), (2, 48, 64, 3)]:
        with pytest.raises(ValueError, match="64x64"):
            vsr.apply_basicvsrpp(params, torch.rand(shape), SMALL)


@pytest.fixture(scope="module")
def small_step():
    """The filter body that ``super_resolution(arch="basicvsrpp")`` builds,
    with the small config's weights swapped in for speed."""
    def build(tracer):
        step = super_resolution(arch="basicvsrpp", scale=4, tracer=tracer).fn
        step.config = SMALL
        return step, vsr.prepare_basicvsrpp(vsr.init_basicvsrpp(9, SMALL), SMALL, CPU)
    return build


def test_enabled_tracer_records_the_spans_and_counters(small_step):
    tr = Tracer(enabled=True)
    step, state = small_step(tr)
    x = _clip(3, 4, 64, 64)
    step(x, state)
    y, _ = step(torch.cat([x[:2], x[1:2], x[1:2]]), state)     # padded as the pipeline pads
    assert y.shape == (4, 256, 256, 3)
    spans = tr.spans()
    assert {n for n, *_ in spans} == set(vsr.SPANS)
    assert {a["seq"] for *_, a in spans} == {0, 1}
    for name in (vsr.SPAN_WARP, vsr.SPAN_OFFSET, vsr.SPAN_DCN, vsr.SPAN_BACKBONE):
        assert {a["pass"] for n, *_, a in spans if n == name} == set(vsr.PASSES)
    per_clip = {n: sum(1 for m, *_, a in spans if m == n and a["seq"] == 0) for n in vsr.SPANS}
    assert per_clip == {vsr.SPAN_FLOW: 1, vsr.SPAN_EXTRACT: 1, vsr.SPAN_WARP: 12,
                        vsr.SPAN_OFFSET: 12, vsr.SPAN_DCN: 12, vsr.SPAN_BACKBONE: 16,
                        vsr.SPAN_UPSAMPLE: 1}
    assert step.stats == vsr.VsrStats(clips=2, frames=8, padded_frames=2, dcn_calls=24,
                                       propagation_steps=32)
    assert tr.dropped == 0


def test_disabled_tracer_records_nothing(small_step):
    for tr in (Tracer(enabled=False), None):
        step, state = small_step(tr)
        step(_clip(4, 2, 64, 64), state)
        assert step.stats == vsr.VsrStats()
        if tr is not None:
            assert len(tr) == 0 and tr.device_spans() == []


def test_engine_runs_basicvsrpp_at_published_widths():
    """The filter as registered, through the engine: a uint8 clip of 3
    frames in, ×4 uint8 out, the frames of the reference's clip."""
    params = vsr.init_basicvsrpp(10)
    eng = dvf_tpu_torch.Engine(super_resolution(params=params, arch="basicvsrpp", scale=4),
                               device="cpu")
    x = (_clip(5, 3, 64, 64) * 255).round().to(torch.uint8).numpy()
    out = eng.submit(x).fetch()
    assert out.shape == (3, 256, 256, 3) and out.dtype == np.uint8
    want = ref.forward(params, torch.from_numpy(x).float() / 255.0, PUBLISHED_NET)
    # uint8 rounding (0.29 levels RMS) over the bf16 gap (measured 0.31 RMS).
    assert _levels(torch.from_numpy(out).float() / 255.0, want.clamp(0, 1))[1] <= 0.6


def test_cli_serves_basicvsrpp_with_batch_as_the_clip(capsys, monkeypatch):
    import json

    from dvf_tpu_torch.cli import main

    monkeypatch.setenv("DVF_FORCE_PLATFORM", "cpu")
    rc = main(["serve", "--filter", "super_resolution", "--filter-config",
               '{"arch": "basicvsrpp", "scale": 4}', "--source", "synthetic", "--height", "64",
               "--width", "64", "--frames", "5", "--batch", "3", "--frame-delay", "0",
               "--queue-size", "8"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["delivered"] == 5


# ---------------------------------------------------------------------------
# The clip rule and the refusals
# ---------------------------------------------------------------------------


def _paced_run(filt, n=10, batch=4, gap_s=0.03):
    """A source that sends a frame every ``gap_s`` (three times the
    pipeline's 10 ms deadline); returns (the pipeline's stats, delivered
    indices, batch sizes the filter saw)."""
    seen = []

    def fn(b, state):
        seen.append(b.shape[0])
        return b, state

    filt = dataclasses.replace(filt, fn=fn)

    def source():
        for i in range(n):
            time.sleep(gap_s)
            yield np.full((8, 8, 3), i, np.uint8), time.time()

    got = []
    pipe = Pipeline(source(), filt, CallbackSink(lambda i, f, ts: got.append(i)),
                    PipelineConfig(batch_size=batch, frame_delay=0, queue_size=64),
                    device="cpu")
    stats = pipe.run()
    return stats, got, seen


def test_a_slow_source_never_cuts_a_clip_mid_stream():
    clip = Filter(name="clip", fn=None, clip=True)
    stats, got, _ = _paced_run(clip)
    assert got == list(range(10))
    assert stats["short_batches"] == 1 and stats["padded_rows"] == 2   # only the last: 4, 4, 2
    assert stats["fill_holds"] >= 2


def test_other_filters_keep_todays_deadline():
    stats, got, _ = _paced_run(stateless("plain", lambda b: b))
    assert got == list(range(10))
    assert stats["short_batches"] >= 5 and stats["fill_holds"] == 0


def test_a_chain_with_a_clip_member_is_a_clip():
    chain = FilterChain(stateless("plain", lambda b: b), Filter(name="c", fn=None, clip=True))
    assert chain.clip and not FilterChain(stateless("plain", lambda b: b)).clip


def test_the_zmq_worker_refuses_a_clip_filter():
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    with pytest.raises(ValueError, match="clip filter"):
        ZmqWorker(super_resolution(arch="basicvsrpp", scale=4), device="cpu")


@pytest.mark.parametrize("axes", [{"data": 2}, {"space": 2}])
def test_a_mesh_that_would_split_the_clip_is_refused(axes):
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(**axes), devices=[CPU] * 2)
    eng = dvf_tpu_torch.Engine(super_resolution(arch="basicvsrpp", scale=4), mesh=mesh)
    with pytest.raises(ValueError, match="split its clip"):
        eng.submit(np.zeros((2, 64, 64, 3), np.uint8)).fetch()


def test_the_serving_frontend_refuses_it():
    from dvf_tpu_torch.serve.server import ServeFrontend

    with pytest.raises(ValueError, match="stateful"):
        ServeFrontend(super_resolution(arch="basicvsrpp", scale=4), device="cpu")
