#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which raises (and so exits non-zero) on failure:

1. the card: torch's device name, and name + power limit from nvidia-smi;
2. build every kernel in dvf_tpu_torch/csrc with nvcc (sm_90a), one nvcc
   per source, all started together;
3. each hand-written kernel against its plain torch version on the card:
   the stencil kernels at an unaligned 68x40 shape and at their main-path
   shape (16 x 1080 x 1920 x 3), max abs error <= 1e-5; the bounded warp
   at 68x40 (3 and 5 channels, flows in +-6 so the clip engages), a border
   case, and its two main-path shapes (4 x 720 x 1280 x 3, the final warp;
   4 x 360 x 640 x 5, the inner warp), max abs error <= 3e-6. TF32 is off
   for every plain or library call;
4. CUDA-event times (median of 20 runs after warm-up) of each kernel, its
   plain version and, where one PyTorch call computes the same function
   (the separable blur's depthwise convolutions, the warp's grid_sample),
   that call as a yardstick; the bound each kernel could reach;
5. the main paths, each driven with the launch counters set to 0 just
   before and read just after: 1080p batch-16 Pipelines for invert,
   gaussian_blur(k=9), bilateral and sobel_bilateral, and 720p batch-4
   Pipelines for flow_warp() and flow_warp(inner_warp="pallas"), all with
   impl=None (the kernels). Every kernel of a leg must have launched its
   expected count per batch and no other kernel at all; frames must come
   in order, all of them, within 1 LSB of the plain version (for the flow
   legs: of the same stream computed on the card with the plain warp, the
   state carried across the same batches);
6. a coarse split of a pipeline batch: the engine alone (pinned H2D,
   filter, D2H, back to back) against the host copies the pipeline adds
   (frames into a pinned slot, rows out of it); for the flow legs also a
   torch.profiler window: the card's busy share and its kernels per batch.

Output: human-readable lines, then ``{"pipeline": [...]}``,
``{"stages": [...]}`` and ``{"kernels": [...]}`` lines, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
TOL = 1e-5
WARP_TOL = 3e-6
MAIN_SHAPE = (16, 1080, 1920, 3)
SMALL_SHAPE = (2, 68, 40, 3)
N_FRAMES = 320
# flow_warp (BASELINE configs[3]): 720p, batch 4; the flow is estimated at
# half resolution, so the inner warp runs on 360 x 640 5-channel stacks.
FLOW_SHAPE = (4, 720, 1280, 3)
INNER_SHAPE = (4, 360, 640, 5)
FLOW_FRAMES = 80
MAX_DISP = 4                          # flow_warp's default bound
INNER_DISP = 2                        # ceil(MAX_DISP / flow_scale)
INNER_LAUNCHES = 1 + 3 * 3            # final warp + levels * n_iters
REPS = 20
SOURCE = "dvf_tpu_torch/csrc/stencils.cu"
WARP_SOURCE = "dvf_tpu_torch/csrc/warp.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, x, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn(x)`` over ``reps`` runs after warm-up."""
    import torch

    for _ in range(3):
        fn(x)
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


def ops_sep_blur(shape, kh: int, kw: int) -> int:
    # a multiply and an add per tap per axis, per output element
    return int(np.prod(shape)) * 2 * (kh + kw)


def ops_bilateral(shape, d: int) -> int:
    # per tap: C sub + C mul + (C-1) add (distance), mul by 1/2sc^2, exp,
    # mul by the spatial weight, C mul-adds (numerator), 1 add
    # (denominator); then C divisions per pixel
    b, h, w, c = shape
    return b * h * w * (d * d * (5 * c + 3) + c)


def ops_sobel_bilateral(shape, d: int) -> int:
    # per pixel: gray 5; Sobel 4 x (1 mul + 2 add) + 2 sub; magnitude
    # 2 mul + add + sqrt + scale + 2 clip; single-channel bilateral 8 per
    # tap (sub, square, scale, exp, spatial mul, mul-add, add); 1 division
    b, h, w, _ = shape
    return b * h * w * (5 + 14 + 7 + 8 * d * d + 1)


def ops_warp(shape) -> int:
    # per pixel: 2 flow clips (4), 2 adds, 2 coordinate clamps (4), 2
    # floors, 2 fractions, 2 complements = 16; per channel 6 mul + 3 add
    b, h, w, c = shape
    return b * h * w * (16 + 9 * c)


def bound(shape, ops: int, nbytes=None):
    if nbytes is None:
        nbytes = 2 * int(np.prod(shape)) * 4  # float32 in once, out once
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def warp_bytes(shape) -> int:
    # float32 img in, flow (2 channels) in, out: each once
    b, h, w, c = shape
    return b * h * w * (2 * c + 2) * 4


def max_lsb(got: np.ndarray, want: np.ndarray) -> int:
    return int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import _build
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.ops.bilateral import bilateral_nhwc
    from dvf_tpu_torch.ops.conv import gaussian_kernel_1d, sep_conv2d
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"({time.perf_counter() - t0:.2f} s wall, nvcc {_build.nvcc_path()})")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    # 3-4. each kernel against its plain version; times
    k9 = gaussian_kernel_1d(9, 0.0)
    chain = dvf_tpu_torch.get_filter("sobel_bilateral", impl="chain")
    w9 = k9.to(dev)

    def library_blur(x):
        # two depthwise cuDNN convolutions on the reflect-padded input
        c = x.shape[-1]
        xp = F.pad(x.permute(0, 3, 1, 2), (4, 4, 4, 4), mode="reflect")
        y = F.conv2d(xp, w9.view(1, 1, 9, 1).expand(c, 1, 9, 1), groups=c)
        y = F.conv2d(y, w9.view(1, 1, 1, 9).expand(c, 1, 1, 9), groups=c)
        return y.permute(0, 2, 3, 1)

    specs = [
        dict(name="sep_blur",
             replaces="dvf_tpu/ops/pallas_kernels.py:363",
             kernel=lambda x: tk.sep_blur_nhwc_pallas(x, k9, k9),
             plain=lambda x: sep_conv2d(x, k9, k9, impl="shift"),
             library=library_blur, ops=lambda s: ops_sep_blur(s, 9, 9)),
        dict(name="bilateral",
             replaces="dvf_tpu/ops/pallas_kernels.py:188",
             kernel=lambda x: tk.bilateral_nhwc_pallas(x),
             plain=lambda x: bilateral_nhwc(x), library=None,
             ops=lambda s: ops_bilateral(s, 5)),
        dict(name="sobel_bilateral",
             replaces="dvf_tpu/ops/pallas_kernels.py:485",
             kernel=lambda x: tk.sobel_bilateral_nhwc_pallas(x),
             plain=lambda x: chain.fn(x, None)[0], library=None,
             ops=lambda s: ops_sobel_bilateral(s, 5)),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for spec in specs:
        err = 0.0
        for shape in (SMALL_SHAPE, MAIN_SHAPE):
            x = torch.rand(shape, generator=gen, device=dev)
            got = spec["kernel"](x)
            torch.cuda.synchronize()
            want = spec["plain"](x)
            e = (got - want).abs().max().item()
            log(f"check {spec['name']} {shape}: max abs err {e:.3e}")
            if not e <= TOL:
                raise AssertionError(
                    f"{spec['name']} kernel disagrees with its plain version "
                    f"at {shape}: {e} > {TOL}")
            err = max(err, e)
            del got, want
        ms = cuda_ms(spec["kernel"], x)
        plain_ms = cuda_ms(spec["plain"], x)
        lib_ms = None
        if spec["library"] is not None:
            lib_err = (spec["library"](x) - spec["plain"](x)).abs().max().item()
            lib_ms = cuda_ms(spec["library"], x)
            log(f"library {spec['name']}: max abs err vs plain {lib_err:.3e}")
        b_ms, b_by = bound(MAIN_SHAPE, spec["ops"](MAIN_SHAPE))
        log(f"time {spec['name']} {MAIN_SHAPE}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms} ms, bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(name=spec["name"], route="cuda", source=SOURCE,
                         replaces=spec["replaces"], shape=list(MAIN_SHAPE),
                         launches=None, max_abs_err=err, ms=ms, kernel_ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
        del x
    log("K2/K3 have no single PyTorch call computing the same function: "
        "library_ms is null for them")
    torch.cuda.empty_cache()
    rows.append(check_warp(dev, gen))
    torch.cuda.empty_cache()

    # 5. the main paths
    legs = [("invert", {}, None, 1),
            ("gaussian_blur", {"ksize": 9}, "sep_blur", 1),
            ("bilateral", {}, "bilateral", 1),
            ("sobel_bilateral", {}, "sobel_bilateral", 1),
            ("flow_warp", {}, "warp_bounded", 1),
            ("flow_warp", {"inner_warp": "pallas"}, "warp_bounded", INNER_LAUNCHES)]
    plain_of = {spec["name"]: spec["plain"] for spec in specs}
    engines = {}
    for name, kw, _, _ in legs:  # compile (and warm up) outside the counted run
        eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw))
        eng.compile(FLOW_SHAPE if name == "flow_warp" else MAIN_SHAPE)
        engines[leg_label(name, kw)] = eng
    keep = (0, 1, N_FRAMES // 2, N_FRAMES - 1)
    pipe_rows = []
    launches = {k: 0 for k in tk.LAUNCHES}
    for name, kw, counter, per_batch in legs:
        label = leg_label(name, kw)
        flow = name == "flow_warp"
        shape, n = (FLOW_SHAPE, FLOW_FRAMES) if flow else (MAIN_SHAPE, N_FRAMES)
        # Flow legs wait for full batches, so the reference below cuts the
        # stream where the pipeline did.
        cfg = dvf_tpu_torch.PipelineConfig(
            batch_size=shape[0], queue_size=n + 1,
            assemble_timeout_s=60.0 if flow else 0.01)
        order, kept = [], {}

        def sink(i, f, _ts):
            order.append(i)
            if flow or i in keep:
                kept[i] = f

        src = dvf_tpu_torch.SyntheticSource(*shape[1:], n_frames=n, seed=0)
        tk.reset_launches()
        stats = dvf_tpu_torch.Pipeline(src, engines[label].filter,
                                       dvf_tpu_torch.CallbackSink(sink), cfg,
                                       engine=engines[label]).run()
        delta = dict(tk.LAUNCHES)
        for k, v in delta.items():
            launches[k] += v
        if order != list(range(n)) or stats["delivered"] != n:
            raise AssertionError(f"{label}: delivered {stats['delivered']} of "
                                 f"{n}, in order: {order == sorted(order)}")
        want_delta = {k: (stats["engine_batches"] * per_batch if k == counter else 0)
                      for k in delta}
        if delta != want_delta:
            raise AssertionError(f"{label}: launches {delta}, want {want_delta}")
        frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
            *shape[1:], n_frames=n, seed=0)][:-1]
        if flow:
            if stats["engine_batches"] != n // shape[0]:
                raise AssertionError(f"{label}: {stats['engine_batches']} batches, "
                                     f"want {n // shape[0]} full ones")
            want = flow_reference(frames, shape[0], dev,
                                  inner=kw.get("inner_warp") == "pallas")
            got = np.stack([kept[i] for i in range(n)])
            if not np.array_equal(got[:shape[0]], want[:shape[0]]):
                raise AssertionError(f"{label}: the first batch did not pass through")
        else:
            x = torch.from_numpy(np.stack([frames[i] for i in keep])).to(dev)
            plain = plain_of.get(counter, lambda v: 1.0 - v)  # invert: no kernel
            want = to_uint8(plain(to_float(x))).cpu().numpy()
            got = np.stack([kept[i] for i in keep])
        lsb = max_lsb(got, want)
        if lsb > 1:
            raise AssertionError(f"{label}: delivered frames differ from the "
                                 f"plain version by {lsb} LSB")
        log(f"pipeline {label}: {stats['delivered']} frames, {stats['engine_batches']} "
            f"batches, {stats['fps']:.1f} fps, p50 {stats['p50_ms']:.2f} ms, "
            f"p99 {stats['p99_ms']:.2f} ms, launches {delta}, max {lsb} LSB vs plain")
        pipe_rows.append(dict(filter=label, frames=n, batch=shape[0],
                              geometry=list(shape[1:]), fps=stats["fps"],
                              p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
                              launches=delta, max_lsb_vs_plain=lsb))
        del kept, got, want, frames
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the main path")

    # 6. where a pipeline batch goes (after the counted run)
    stage_rows = []
    for name, kw, _, _ in legs:
        label = leg_label(name, kw)
        shape = FLOW_SHAPE if name == "flow_warp" else MAIN_SHAPE
        frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
            *shape[1:], n_frames=shape[0], seed=0)][:-1]
        inp = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        view = inp.numpy()
        outs = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                for _ in range(2)]
        t = time.perf_counter()
        for _ in range(REPS):
            for row, f in enumerate(frames):
                view[row] = f
        stage_ms = (time.perf_counter() - t) * 1e3 / REPS
        t = time.perf_counter()
        for _ in range(REPS):
            rows_out = [outs[0].numpy()[i].copy() for i in range(shape[0])]
        copy_out_ms = (time.perf_counter() - t) * 1e3 / REPS
        del rows_out
        eng = engines[label]
        eng.submit(inp, out=outs[0]).fetch()
        t = time.perf_counter()
        prev = None
        for i in range(REPS):
            cur = eng.submit(inp, out=outs[i % 2])
            if prev is not None:
                prev.fetch()
            prev = cur
        prev.fetch()
        engine_ms = (time.perf_counter() - t) * 1e3 / REPS
        row = dict(filter=label, batch=shape[0], engine_ms_per_batch=engine_ms,
                   staging_ms_per_batch=stage_ms, copy_out_ms_per_batch=copy_out_ms)
        busy = ""
        if name == "flow_warp":
            row.update(device_busy(eng, inp, outs))
            busy = (f"; profiled: device busy {row['device_busy_share']:.3f} of "
                    f"the wall ({row['profiled_wall_ms_per_batch']:.2f} ms/batch "
                    f"under the profiler), {row['device_ms_per_batch']:.2f} ms and "
                    f"{row['device_kernels_per_batch']:.0f} device kernels per "
                    f"batch; top [name, ms, count] per batch: "
                    f"{json.dumps(row['top_device_ms_per_batch'])}")
        log(f"stages {label}: engine alone {engine_ms:.2f} ms/batch "
            f"({shape[0] * 1e3 / engine_ms:.1f} fps); host staging "
            f"{stage_ms:.2f} ms, row copy-out {copy_out_ms:.2f} ms per batch{busy}")
        stage_rows.append(row)

    print(json.dumps({"pipeline": pipe_rows}))
    print(json.dumps({"stages": stage_rows}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def device_busy(eng, inp, outs, n: int = 5) -> dict:
    """Profile ``n`` engine batches back to back (each waited for): the
    share of the wall the card spent in kernels and copies, and per batch
    that device time and the number of device kernels. The profiler's own
    host overhead lengthens the wall, so the share errs low."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            eng.submit(inp, out=outs[i % 2]).fetch()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if dev_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:4]
    return dict(device_busy_share=dev_ms / wall_ms, device_ms_per_batch=dev_ms / n,
                device_kernels_per_batch=sum(e.count for e in dev) / n,
                profiled_wall_ms_per_batch=wall_ms / n,
                top_device_ms_per_batch=[
                    [e.key[:70], e.self_device_time_total / 1e3 / n, e.count / n]
                    for e in top])


def leg_label(name: str, kw: dict) -> str:
    args = ",".join(f"{k}={v!r}" for k, v in kw.items())
    return f"{name}({args})" if name == "flow_warp" else name


def check_warp(dev, gen) -> dict:
    """Phases 3-4 for the bounded warp (K4): against its plain version at
    the checked shapes, then timed at the final warp's shape."""
    import torch
    import torch.nn.functional as F

    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.ops.flow import warp_by_flow

    def plain(img, flow, r):
        return warp_by_flow(img, flow.clamp(-r, r))

    def inputs(shape, scale):
        img = torch.rand(shape, generator=gen, device=dev)
        flow = (torch.rand(shape[:3] + (2,), generator=gen, device=dev) - 0.5) * scale
        return img, flow

    cases = []
    for shape in ((2, 68, 40, 3), (2, 68, 40, 5)):
        cases.append((f"{shape} flows in +-6", *inputs(shape, 12.0), MAX_DISP))
    img, flow = inputs((2, 68, 40, 3), 4.0)          # border: +-2, edges outward
    flow[:, :3, :, 1] = -2.0
    flow[:, -3:, :, 1] = 2.0
    flow[:, :, :3, 0] = -2.0
    flow[:, :, -3:, 0] = 2.0
    cases.append(("(2, 68, 40, 3) border", img, flow, MAX_DISP))
    cases.append((f"{FLOW_SHAPE} final warp", *inputs(FLOW_SHAPE, 12.0), MAX_DISP))
    cases.append((f"{INNER_SHAPE} inner warp", *inputs(INNER_SHAPE, 6.0), INNER_DISP))
    err = 0.0
    for label, img, flow, r in cases:
        got = tk.warp_bounded_pallas(img, flow, r)
        torch.cuda.synchronize()
        e = (got - plain(img, flow, r)).abs().max().item()
        log(f"check warp_bounded {label}: max abs err {e:.3e}")
        if not e <= WARP_TOL:
            raise AssertionError(f"warp_bounded kernel disagrees with its plain "
                                 f"version at {label}: {e} > {WARP_TOL}")
        err = max(err, e)
    _, img, flow, _ = cases[3]
    inner_img, inner_flow = cases[4][1], cases[4][2]
    ms = cuda_ms(lambda _: tk.warp_bounded_pallas(img, flow, MAX_DISP), None)
    plain_ms = cuda_ms(lambda _: plain(img, flow, MAX_DISP), None)
    inner_ms = cuda_ms(lambda _: tk.warp_bounded_pallas(inner_img, inner_flow,
                                                        INNER_DISP), None)
    # Library yardstick: grid_sample on the clipped flow's normalized grid
    # (built outside the timed call), border padding = coordinate clamp.
    b, h, w, _ = FLOW_SHAPE
    fc = flow.clamp(-MAX_DISP, MAX_DISP)
    gx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w) + fc[..., 0]
    gy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1) + fc[..., 1]
    grid = torch.stack([gx * (2.0 / (w - 1)) - 1.0, gy * (2.0 / (h - 1)) - 1.0], -1)
    img_nchw = img.permute(0, 3, 1, 2)

    def library(_):
        return F.grid_sample(img_nchw, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lib_err = (library(None).permute(0, 2, 3, 1)
               - plain(img, flow, MAX_DISP)).abs().max().item()
    lib_ms = cuda_ms(library, None)
    b_ms, b_by = bound(FLOW_SHAPE, ops_warp(FLOW_SHAPE), warp_bytes(FLOW_SHAPE))
    ib_ms, _ = bound(INNER_SHAPE, ops_warp(INNER_SHAPE), warp_bytes(INNER_SHAPE))
    log(f"library warp_bounded (grid_sample): max abs err vs plain {lib_err:.3e}")
    log(f"time warp_bounded {FLOW_SHAPE}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
        f"{INNER_SHAPE}: kernel {inner_ms:.4f} ms, bound {ib_ms:.4f} ms")
    return dict(name="warp_bounded", route="cuda", source=WARP_SOURCE,
                replaces="dvf_tpu/ops/pallas_kernels.py:268",
                shape=list(FLOW_SHAPE), launches=None, max_abs_err=err, ms=ms,
                kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_max_abs_err=lib_err,
                inner_shape=list(INNER_SHAPE), inner_ms=inner_ms,
                inner_bound_ms=ib_ms)


def flow_reference(frames, bsz: int, dev, inner: bool) -> np.ndarray:
    """The flow legs' stream computed on the card with the plain warp
    (warp_by_flow on the clipped flow) in place of the kernel: batches of
    ``bsz`` in stream order, the previous frame carried across them, the
    first batch passed through. uint8 (N, H, W, C)."""
    import torch

    from dvf_tpu_torch.ops.flow import farneback_flow_seq, warp_by_flow
    from dvf_tpu_torch.utils.image import resize_linear, rgb_to_gray, to_float, to_uint8

    def clipped(r):
        return lambda img, f: warp_by_flow(img, f.clamp(-r, r))

    out, prev = [], None
    with torch.no_grad():
        for s in range(0, len(frames), bsz):
            batch = to_float(torch.from_numpy(np.stack(frames[s:s + bsz])).to(dev))
            if prev is None:
                res = batch
            else:
                _, h, w, _ = batch.shape
                seq = torch.cat([prev[None], batch], dim=0)
                sg = resize_linear(rgb_to_gray(seq), (h // 2, w // 2))
                flow = farneback_flow_seq(
                    sg, inner_warp=clipped(INNER_DISP) if inner else "gather")
                flow = resize_linear(flow, (h, w)) * 2.0
                res = clipped(MAX_DISP)(seq[:-1], flow)
            out.append(to_uint8(res).cpu().numpy())
            prev = batch[-1]
    return np.concatenate(out)


if __name__ == "__main__":
    sys.exit(main())
