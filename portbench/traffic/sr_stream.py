"""One closed-loop stream of low-resolution frames upscaled by HAT through
the port's ``Pipeline`` and ``Engine``.

The window and warm-up arithmetic are ``traffic/stream.py``'s: the source
(run in the pipeline's ingest thread) serves the seeded frame cycle and
holds while ``outstanding`` frames are between it and the sink, so no
frame is dropped; it first sends ``warmup_frames`` and waits for them,
then opens the window for ``--seconds``. The sink keeps exactly
``sample`` frames of the window, drawn from the seed among the first four
fifths of the frames that ``expected_fps`` puts in it, so every run that
reaches 80 % of that rate keeps them all.

``correct``: each sampled frame against ``reference/hat.py`` (float32,
TF32 off) on the same input, clamped to [0, 1] as a video sink shows it;
the worst frame's RMS gap in levels, with ``clipped_share`` (the share of
the reference's sampled values outside [0, 1], so that clipping cannot
hide a gap), order errors and frames lost.

Under ``--trace 1`` the filter and the pipeline share one enabled
``Tracer``: the ``hat.*`` device spans of the batches collected inside the
traced window are summed after the closing sync (``hat_span_ms``).

Params: height, width, batch, cycle, outstanding, queue_size,
frame_delay (the pipeline's display lag, which holds that many delivered
frames back: below ``outstanding``, or the loop stalls), warmup_frames,
sample, expected_fps, trace_seconds.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time

import numpy as np
import torch

from portbench import frames_check, inputs
from portbench.devtrace import DeviceWindow
from portbench.reference import hat as ref
from portbench.reference import no_tf32
from portbench.window import ClosedLoop

# A fault planted under the timed path (tests, calibration): the leaves
# zeroed in the program's weights, which drops the branch exactly.
ZEROED = {"no_window_attn": (".hab", ("proj.w", "proj.b")),
          "no_ocab": (".ocab", ("proj.w", "proj.b")),
          "no_cab": (".hab", ("cab2.w", "cab2.b"))}


def weights(ctx):
    return ref.make_params(ctx.config["net"], ctx.seed, ctx.device,
                           cab_conv_gain=ctx.config["cab_conv_gain"])


def _zeroed(params, fault):
    layer, leaves = ZEROED[fault]
    return {k: {n: (torch.zeros_like(t) if layer in k and n in leaves else t)
                for n, t in v.items()} for k, v in params.items()}


def _nearest(batch, state):
    """The ``nearest`` fault's body: the input upsampled x4 by nearest."""
    return batch.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2), state


def reference_outputs(params, frames_by_key, net, device, prec=ref.F32):
    """{key: float32 (4H, 4W, 3), unclamped} of the reference."""
    out = {}
    with torch.no_grad(), no_tf32():
        for k in sorted(frames_by_key):
            x = torch.tensor(np.asarray(frames_by_key[k]), device=device)[None]
            out[k] = ref.forward(params, x.float() / 255.0, net, prec)[0]
    return out


def compare(kept, refs):
    """(worst RMS gap in levels against the clamped reference, clipped share)."""
    gap = frames_check.worst_rms_gap([(kept[k], refs[k].clamp(0.0, 1.0))
                                      for k in sorted(kept)])
    n = sum(r.numel() for r in refs.values())
    clipped = sum(int(((r < 0) | (r > 1)).sum()) for r in refs.values())
    return gap, (clipped / n if n else float("nan"))


def _span_sums(tracer, pipe_stats, hat_stats, t0, t1):
    """ms of each ``hat.*`` device span over the batches collected in
    [t0, t1], and their frames. The filter numbers its calls from its
    first (the engine's compile calls included); the pipeline from its
    first batch: the offset is their difference at the end."""
    spans = tracer.spans()
    valid = {a["seq"]: a.get("valid", 0) for n, _, _, _, a in spans
             if n == "pipeline.assemble" and "seq" in a}
    seqs = {a["seq"] for n, s, _, _, a in spans
            if n == "pipeline.deliver" and t0 <= s <= t1}
    offset = hat_stats.batches - pipe_stats["engine_batches"]
    want = {q + offset for q in seqs}
    sums = {}
    for name, ms, _, args in tracer.device_spans():
        if name.startswith("hat.") and args.get("seq") in want:
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
                            scale=net["upscale"], dtype=ctx.config["dtype"], arch="hat",
                            tracer=tracer)
    if ctx.fault == "nearest":
        filt = dataclasses.replace(filt, fn=_nearest)
    hat_stats = getattr(filt.fn, "stats", None)
    ctx.mark("inputs")

    rng = np.random.default_rng(ctx.seed)
    sure = max(p["sample"], int(0.8 * p["expected_fps"] * ctx.seconds))
    offsets = set(rng.choice(sure, size=p["sample"], replace=False).tolist())
    loop = ClosedLoop(p["outstanding"])
    delivered_idx, delivered_t = [], []
    kept = {}
    st = {"emitted": 0, "window_first": None, "window_last": None}
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
    detail = {}
    reduced_trace = span_sums = None
    if tracer is not None and hat_stats is not None:
        lo, hi = (dw.t0, dw.t1) if dw is not None and dw.t1 is not None else (t0, t1)
        sums, frames_spanned = _span_sums(tracer, stats, hat_stats, lo, hi)
        span_sums = {"ms": sums, "frames": frames_spanned}
        detail = {"tracer_dropped": tracer.dropped, "hat_stats": dataclasses.asdict(hat_stats),
                  "engine_device_ms": stats.get("engine_device_ms")}
    del pipe, filt
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
    refs = reference_outputs(params, {k: frames[k % len(frames)] for k in kept}, net,
                             ctx.device)
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
        "hat_spans": span_sums,
        "sampled": len(kept),
        "reference_s": reference_s,
        "detail": detail,
        "checks": {
            "worst_frame_rms_gap": (gap, limits["worst_frame_rms_gap"]),
            "clipped_share": (clipped, limits["clipped_share"]),
            "order_errors": (order_errors, limits["order_errors"]),
            "frames_lost": (lost, limits["frames_lost"]),
        },
    }


def control(ctx) -> dict:
    """The control's reading at the cell's size: the reference with float8
    operands in every conv, linear and attention product, rounded to bytes,
    in the program's place on the cycle's first ``sample`` frames."""
    p = ctx.params
    net = ctx.config["net"]
    frames = inputs.frame_cycle(ctx.seed, p["height"], p["width"], p["cycle"])
    params = weights(ctx)
    sample = {k: frames[k] for k in range(min(p["sample"], len(frames)))}
    refs = reference_outputs(params, sample, net, ctx.device)
    low = reference_outputs(params, sample, net, ctx.device, prec=ref.FP8)
    kept = {k: torch.round(low[k].clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
            for k in low}
    return {"worst_frame_rms_gap": compare(kept, refs)[0]}
