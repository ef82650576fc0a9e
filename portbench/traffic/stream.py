"""One closed-loop stream through the port's ``Pipeline`` and ``Engine``.

The benchmark's source (run in the pipeline's ingest thread) serves the
seeded frame cycle and holds while ``outstanding`` frames are between it
and the sink, so no frame is dropped and offered work is never shed. It
first sends ``warmup_frames`` (every shape compiled, cuDNN's algorithms
picked, staging and egress pools built), waits for them, and then opens
the window for ``--seconds``; at its close the source ends and the
pipeline drains. The sink stamps each delivery and keeps a seeded sample
of the frames delivered in the window for the comparison.

Params: height, width, batch, cycle, outstanding, queue_size,
warmup_frames, sample, expected_fps, trace_seconds.
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
from portbench.window import ClosedLoop

MAX_FRAMES = 1 << 20


def _faulty(filt, fault):
    """A break planted under the timed path (tests, calibration)."""
    fn = filt.fn

    def broken(batch, state):
        y, state = fn(batch, state)
        if fault == "unchanged":          # the step hands its input back
            return batch.clone(), state
        if fault == "half_batch":         # half of the batch left out
            y = y.clone()
            y[y.shape[0] // 2:] = 0.0
            return y, state
        if fault == "altered":            # an answer altered where produced
            return y.roll(1, dims=0), state
        raise ValueError(f"unknown fault {fault!r}")

    return dataclasses.replace(filt, fn=broken)


def run(ctx):
    from dvf_tpu_torch import CallbackSink, Pipeline, PipelineConfig
    from dvf_tpu_torch.ops.style import style_transfer

    p = ctx.params
    net = ctx.config["net"]
    n_res = net["n_residual"]
    h, w, batch = p["height"], p["width"], p["batch"]
    frames = inputs.frame_cycle(ctx.seed, h, w, p["cycle"])
    weights = inputs.make_params(inputs.johnson_layers(net["base_channels"], n_res),
                                 ctx.seed, ctx.device)
    filt = style_transfer(params=weights, base_channels=net["base_channels"],
                          n_residual=n_res, dtype=ctx.config["dtype"])
    if ctx.fault:
        filt = _faulty(filt, ctx.fault)
    ctx.mark("inputs")

    rng = np.random.default_rng(ctx.seed)
    keep_p = min(1.0, p["sample"] / max(1.0, p["expected_fps"] * ctx.seconds))
    keep = rng.random(MAX_FRAMES) < keep_p
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
        if (first is not None and idx >= first and keep[idx % MAX_FRAMES]
                and len(kept) < 2 * p["sample"]):
            kept[idx] = np.array(frame, copy=True)
        loop.complete()

    pipe = None

    def snapshot():
        ing = pipe._ingest_stats
        return {"ingest_ms": ing.stage_ms_total + ing.put_ms_total + ing.wait_ms_total,
                "ingest_batches": ing.batches}

    def source():
        i = 0
        warm = p["warmup_frames"]
        while i < warm:
            if not loop.admit(stop):
                break
            yield frames[i % len(frames)], time.time()
            i += 1
        # The reorder buffer holds the newest frame_delay frames back.
        loop.wait_done(warm - pipe.config.frame_delay, timeout=1200.0)
        st["snap0"] = snapshot()
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
        st["snap1"] = snapshot()
        st["window_last"] = i - 1
        st["emitted"] = i
        closed.set()
        yield None, time.time()

    dw = None
    if ctx.trace and ctx.device.type == "cuda":
        # The session opens before the pipeline's threads start: one opened
        # while they run records none of their kernels. The window is
        # marked inside it.
        dw = DeviceWindow(ctx.device)
        dw.open()
    cfg = PipelineConfig(batch_size=batch, queue_size=p["queue_size"])
    pipe = Pipeline(source(), filt, CallbackSink(emit), cfg, device=ctx.device)
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
    del pipe, filt
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    # Order and completeness over every frame sent.
    order_errors = sum(1 for pos, idx in enumerate(delivered_idx) if pos != idx)
    lost = st["emitted"] - len(delivered_idx) + int(stats["dropped_at_ingest"])
    in_order = {idx: t for pos, (idx, t) in enumerate(zip(delivered_idx, delivered_t))
                if pos == idx}
    due = set(range(first, last + 1))
    failed = len(due - in_order.keys())

    t_ref = time.perf_counter()
    inputs_by_key = {k: frames[k % len(frames)] for k in kept}
    ref = frames_check.reference_outputs(weights, inputs_by_key, n_res, ctx.device)
    gap = frames_check.worst_rms_gap([(kept[k], ref[k]) for k in sorted(kept)])
    reference_s = time.perf_counter() - t_ref
    limits = ctx.cell["limits"]
    reduced_trace = None
    if dw is not None and dw.t1 is not None:
        reduced_trace = dw.reduce(ctx.spans.at)
        reduced_trace["frames"] = sum(1 for t in delivered_t if dw.t0 <= t <= dw.t1)
    s0, s1 = st["snap0"], st["snap1"]
    return {
        "t_start": t0, "t_end": t1, "window_s": t1 - t0,
        "attempted": len(due), "failed": failed,
        "in_order_times": list(in_order.values()),
        "memory_peak_bytes": memory_peak,
        "ingest_ms_per_batch": ((s1["ingest_ms"] - s0["ingest_ms"])
                                / max(1, s1["ingest_batches"] - s0["ingest_batches"])),
        "batch": batch,
        "frame_hw": (h, w),
        "trace": reduced_trace,
        "sampled": len(kept),
        "reference_s": reference_s,
        "checks": {
            "worst_frame_rms_gap": (gap, limits["worst_frame_rms_gap"]),
            "order_errors": (order_errors, limits["order_errors"]),
            "frames_lost": (lost, limits["frames_lost"]),
        },
    }


def control(ctx) -> dict:
    """The control's reading at the cell's size: the float8 reference in the
    program's place, on the cycle's first ``sample`` frames."""
    p = ctx.params
    net = ctx.config["net"]
    frames = inputs.frame_cycle(ctx.seed, p["height"], p["width"], p["cycle"])
    weights = inputs.make_params(inputs.johnson_layers(net["base_channels"],
                                                       net["n_residual"]),
                                 ctx.seed, ctx.device)
    sample = {k: frames[k] for k in range(min(p["sample"], len(frames)))}
    return {"worst_frame_rms_gap": frames_check.control_gap(
        weights, sample, net["n_residual"], ctx.device)}
