"""One closed-loop stream of low-resolution frames upscaled by BasicVSR++
in clips, through the port's ``Pipeline`` and ``Engine``.

The loop is ``traffic/sr_stream.py``'s: the source (run in the pipeline's
ingest thread) serves the seeded frame cycle and holds while
``outstanding`` frames are between it and the sink, so no frame is
dropped; it first sends ``warmup_frames`` (a whole number of clips) and
waits for them, then opens the window for ``--seconds``. The batch is the
clip: clip k is frames [k·batch, (k + 1)·batch) of the stream, and the
pipeline never cuts one short while the source is live. The sink keeps
exactly ``sample`` frames of the window, drawn from the seed among the
first four fifths of the frames that ``expected_fps`` puts in it.

``correct``: each sampled frame against ``reference/basicvsrpp.py``
(float32, TF32 off) run on the whole clip the frame belongs to (each
distinct clip once), clamped to [0, 1] as a video sink shows it; the
worst frame's RMS gap in levels (``sr_stream.compare``), with
``clipped_share``, order errors, frames lost, and the short clips the
pipeline launched while the source was live (its ``short_batches`` read
when the source ends: only the stream's last clip may be short).

Under ``--trace 1`` the filter and the pipeline share one enabled
``Tracer``: the ``vsr.*`` device spans of the clips collected inside the
traced window are summed after the closing sync (``vsr_spans``).

Params: height, width, batch (the clip), cycle, outstanding, queue_size,
frame_delay, warmup_frames, sample, expected_fps, trace_seconds.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time

import numpy as np
import torch

from portbench import inputs
from portbench.devtrace import DeviceWindow
from portbench.reference import basicvsrpp as ref
from portbench.reference import no_tf32
from portbench.traffic.sr_stream import compare
from portbench.window import ClosedLoop

# A fault planted under the timed path (tests, calibration): rows or
# columns of the program's weights zeroed, which drop the branch exactly.
# (layer suffix, leaf, axis, start, stop); rows are output channels.
ZEROED = {
    # SpyNet's last conv at every level: every flow is zero.
    "zero_flow": [(".c4", "w", 0, 0, None), (".c4", "b", 0, 0, None)],
    # o1 and o2 of the offset stack's last conv: the offsets are the flows.
    "no_deform": [(".offset3", "w", 0, 0, 288), (".offset3", "b", 0, 0, 288)],
    # h_{i-2} and f2 into the offset stack (cond_n2, flow_2) and into the DCN.
    "no_second_order": [(".offset0", "w", 1, 128, 192), (".offset0", "w", 1, 194, 196),
                        (".dcn", "w", 1, 64, 128)],
}


def weights(ctx):
    return ref.make_params(ctx.config["net"], ctx.seed, ctx.device, gains=ctx.config["gains"])


def _zeroed(params, fault):
    out = {k: dict(v) for k, v in params.items()}
    for suffix, leaf, axis, start, stop in ZEROED[fault]:
        for name, leaves in out.items():
            if name.endswith(suffix):
                t = leaves[leaf].clone()
                t.narrow(axis, start, (stop or t.shape[axis]) - start).zero_()
                leaves[leaf] = t
    return out


def _nearest(batch, state):
    """The ``nearest`` fault's body: the input upsampled x4 by nearest."""
    return batch.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2), state


def clip_of(idx: int, clip: int, cycle: int) -> tuple:
    """The cycle positions of the frames of ``idx``'s clip."""
    start = idx - idx % clip
    return tuple((start + j) % cycle for j in range(clip))


def reference_outputs(params, frames, keys, clip, net, device, prec=ref.F32):
    """{key: float32 (4H, 4W, 3), unclamped}: the reference run once on
    each distinct clip that holds a key, for the keys it holds."""
    by_clip = {}
    for k in sorted(keys):
        by_clip.setdefault(clip_of(k, clip, len(frames)), []).append(k)
    out = {}
    with torch.no_grad(), no_tf32():
        for positions, ks in by_clip.items():
            x = torch.tensor(np.stack([frames[i] for i in positions]), device=device)
            y = ref.forward(params, x.float() / 255.0, net, prec, frames=[k % clip for k in ks])
            out.update(zip(ks, y))
    return out


def _span_sums(tracer, pipe_stats, vsr_stats, t0, t1):
    """ms of each ``vsr.*`` device span over the clips collected in [t0,
    t1], and their frames. The filter numbers its calls from its first
    (the engine's compile calls included); the pipeline from its first
    batch: the offset is their difference at the end."""
    spans = tracer.spans()
    valid = {a["seq"]: a.get("valid", 0) for n, _, _, _, a in spans
             if n == "pipeline.assemble" and "seq" in a}
    seqs = {a["seq"] for n, s, _, _, a in spans
            if n == "pipeline.deliver" and t0 <= s <= t1}
    offset = vsr_stats.clips - pipe_stats["engine_batches"]
    want = {q + offset for q in seqs}
    sums = {}
    for name, ms, _, args in tracer.device_spans():
        if name.startswith("vsr.") and args.get("seq") in want:
            sums[name] = sums.get(name, 0.0) + ms
    return sums, sum(valid.get(q, 0) for q in seqs)


def run(ctx):
    from dvf_tpu_torch import CallbackSink, Pipeline, PipelineConfig
    from dvf_tpu_torch.obs.trace import Tracer
    from dvf_tpu_torch.ops.sr import super_resolution

    p = ctx.params
    net = ctx.config["net"]
    h, w, batch = p["height"], p["width"], p["batch"]
    frames = inputs.frame_cycle(ctx.seed, h, w, p["cycle"])
    params = weights(ctx)
    tracer = Tracer(enabled=True) if ctx.trace else None
    if ctx.fault not in (None, "nearest") and ctx.fault not in ZEROED:
        raise ValueError(f"unknown fault {ctx.fault!r}")
    filt = super_resolution(params=_zeroed(params, ctx.fault) if ctx.fault in ZEROED else params,
                            scale=net["upscale"], dtype=ctx.config["dtype"], arch="basicvsrpp",
                            tracer=tracer)
    if ctx.fault == "nearest":
        filt = dataclasses.replace(filt, fn=_nearest)
    step = filt.fn if hasattr(filt.fn, "stats") else None
    ctx.mark("inputs")

    rng = np.random.default_rng(ctx.seed)
    sure = max(p["sample"], int(0.8 * p["expected_fps"] * ctx.seconds))
    offsets = set(rng.choice(sure, size=p["sample"], replace=False).tolist())
    loop = ClosedLoop(p["outstanding"])
    delivered_idx, delivered_t = [], []
    kept = {}
    st = {"emitted": 0, "window_first": None, "window_last": None, "live_short": 0}
    opened, closed = threading.Event(), threading.Event()
    stop = threading.Event()

    def emit(idx, frame, _ts):
        delivered_t.append(time.perf_counter())
        delivered_idx.append(idx)
        first = st["window_first"]
        if first is not None and idx - first in offsets:
            kept[idx] = np.array(frame, copy=True)
        loop.complete()

    pipe = None

    def source():
        i = 0
        warm = p["warmup_frames"]
        while i < warm:
            if not loop.admit(stop):
                break
            yield frames[i % len(frames)], time.time()
            i += 1
        loop.wait_done(warm - pipe.config.frame_delay, timeout=1200.0)
        st["t_start"] = time.perf_counter()
        st["window_first"] = i
        opened.set()
        t_end = st["t_start"] + ctx.seconds
        while not stop.is_set():
            with ctx.spans.span("source.wait"):
                ok = loop.admit(stop)
            now = time.perf_counter()
            if not ok or now >= t_end:
                break
            with ctx.spans.span("source.emit"):
                yield frames[i % len(frames)], time.time()
            i += 1
        st["t_end"] = time.perf_counter()
        st["window_last"] = i - 1
        st["emitted"] = i
        st["live_short"] = pipe.short_batches      # the source still live: none may be short
        closed.set()
        yield None, time.time()

    dw = None
    if ctx.trace and ctx.device.type == "cuda":
        dw = DeviceWindow(ctx.device)
        dw.open()
    cfg = PipelineConfig(batch_size=batch, queue_size=p["queue_size"],
                         frame_delay=p["frame_delay"])
    pipe = Pipeline(source(), filt, CallbackSink(emit), cfg, device=ctx.device, tracer=tracer)
    err = []

    def drive():
        try:
            st["stats"] = pipe.run()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)
            stop.set()
            opened.set()
            closed.set()

    th = threading.Thread(target=drive, name="portbench-pipeline", daemon=True)
    th.start()
    opened.wait()
    if dw is not None and not err:
        time.sleep(max(0.0, (ctx.seconds - p["trace_seconds"]) / 2))
        dw.start()
        time.sleep(min(p["trace_seconds"], ctx.seconds))
        dw.stop()
    closed.wait()
    th.join(timeout=600.0)
    if dw is not None:
        dw.close()
    if err:
        raise err[0]
    if th.is_alive():
        raise RuntimeError("the pipeline did not drain within 600 s")

    t0, t1 = st["t_start"], st["t_end"]
    first, last = st["window_first"], st["window_last"]
    memory_peak = (torch.cuda.max_memory_allocated(ctx.device)
                   if ctx.device.type == "cuda" else 0)
    stats = st["stats"]
    detail = {"short_batches": stats["short_batches"], "padded_rows": stats["padded_rows"],
              "fill_holds": stats["fill_holds"]}
    reduced_trace = span_sums = None
    if tracer is not None and step is not None:
        lo, hi = (dw.t0, dw.t1) if dw is not None and dw.t1 is not None else (t0, t1)
        sums, frames_spanned = _span_sums(tracer, stats, step.stats, lo, hi)
        span_sums = {"ms": sums, "frames": frames_spanned}
        detail.update(tracer_dropped=tracer.dropped, vsr_stats=dataclasses.asdict(step.stats),
                      engine_device_ms=stats.get("engine_device_ms"))
    del pipe, filt, step
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    order_errors = sum(1 for pos, idx in enumerate(delivered_idx) if pos != idx)
    lost = st["emitted"] - len(delivered_idx) + int(stats["dropped_at_ingest"])
    in_order = {idx: t for pos, (idx, t) in enumerate(zip(delivered_idx, delivered_t))
                if pos == idx}
    due = set(range(first, last + 1))
    failed = len(due - in_order.keys())

    t_ref = time.perf_counter()
    refs = reference_outputs(params, frames, kept, batch, net, ctx.device)
    gap, clipped = compare(kept, refs)
    reference_s = time.perf_counter() - t_ref
    limits = ctx.cell["limits"]
    if dw is not None and dw.t1 is not None:
        reduced_trace = dw.reduce(ctx.spans.at)
        reduced_trace["frames"] = sum(1 for t in delivered_t if dw.t0 <= t <= dw.t1)
    return {
        "t_start": t0, "t_end": t1, "window_s": t1 - t0,
        "attempted": len(due), "failed": failed,
        "in_order_times": list(in_order.values()),
        "memory_peak_bytes": memory_peak,
        "batch": batch,
        "frame_hw": (h, w),
        "trace": reduced_trace,
        "vsr_spans": span_sums,
        "sampled": len(kept),
        "reference_s": reference_s,
        "detail": detail,
        "checks": {
            "worst_frame_rms_gap": (gap, limits["worst_frame_rms_gap"]),
            "clipped_share": (clipped, limits["clipped_share"]),
            "order_errors": (order_errors, limits["order_errors"]),
            "frames_lost": (lost, limits["frames_lost"]),
            "mid_stream_short_clips": (st["live_short"], limits["mid_stream_short_clips"]),
        },
    }


def control(ctx) -> dict:
    """The control's reading at the cell's size: the reference with float8
    operands in every conv and every deformable-conv product, rounded to
    bytes, in the program's place on ``sample`` frames of the cycle's
    first clip."""
    p = ctx.params
    net, clip = ctx.config["net"], p["batch"]
    frames = inputs.frame_cycle(ctx.seed, p["height"], p["width"], p["cycle"])
    params = weights(ctx)
    keys = range(min(p["sample"], clip))
    refs = reference_outputs(params, frames, keys, clip, net, ctx.device)
    low = reference_outputs(params, frames, keys, clip, net, ctx.device, prec=ref.FP8)
    kept = {k: torch.round(low[k].clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
            for k in low}
    return {"worst_frame_rms_gap": compare(kept, refs)[0]}
