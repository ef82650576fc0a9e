#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which raises (and so exits non-zero) on failure:

1. the card: torch's device name, and name + power limit from nvidia-smi;
   the host: libjpeg (library and header), zmq, g++;
2. build every kernel in dvf_tpu_torch/csrc with nvcc (sm_90a), one nvcc
   per source, all started together; the JPEG shim with g++ where libjpeg
   is present;
3. each hand-written kernel against its plain torch version on the card:
   the stencil kernels at an unaligned 68x40 shape and at their main-path
   shape (16 x 1080 x 1920 x 3), max abs error <= 1e-5; the bounded warp
   at 68x40 (3 and 5 channels, flows in +-6 so the clip engages), a border
   case, and its two main-path shapes (4 x 720 x 1280 x 3, the final warp;
   4 x 360 x 640 x 5, the inner warp), max abs error <= 3e-6; the codec
   kernels bit-exact (0 differing elements): tile_maxdiff at (2,68,40,3)
   tile 16, (2,68,40,1) tile 8, (8,512,512,3) and (16,1080,1920,3) tile 32,
   dct8x8_quant on uint8 and float32 (2,52,100) planes at q90, uint8
   (8,512,512) and (8,256,256) at q 50/90/95/100 and (4,720,1280) at q90.
   TF32 is off for every plain or library call;
4. CUDA-event times (median of 20 runs after warm-up) of each kernel, its
   plain version and, where one PyTorch call computes the same function
   (the separable blur's depthwise convolutions, the warp's grid_sample),
   that call as a yardstick; for the codec kernels, whose launch outlasts
   their work, the device time per call from a torch.profiler window
   instead (the CUDA-event time beside it); the bound each kernel could
   reach;
5. the main paths, each driven with the launch counters set to 0 just
   before and read just after: 1080p batch-16 Pipelines for invert,
   gaussian_blur(k=9), bilateral and sobel_bilateral, and 720p batch-4
   Pipelines for flow_warp() and flow_warp(inner_warp="pallas"), all with
   impl=None (the kernels). Every kernel of a leg must have launched its
   expected count per batch and no other kernel at all; frames must come
   in order, all of them, within 1 LSB of the plain version (for the flow
   legs: of the same stream computed on the card with the plain warp, the
   state carried across the same batches). Then the delta-wire worker on
   160 frames of SyntheticSource(512, 512, motion="block"), invert, batch
   8, tile 32, q90, keyframe every 16: its batch step driven without
   sockets (ZmqWorker(connect=False)), codec_assist "full" and "probe" on
   the JPEG delta wire where libjpeg is present; where it is not, "probe"
   on the raw-inner delta wire and an Engine -> FusedDeltaTransform leg
   (K5 and K6 without the entropy stage). Every index once and in order,
   K5 one launch and K6 three per batch where the leg runs them and no
   other kernel, and every payload (or dirty coefficient block) identical
   to the same stream recomputed on the card with the plain versions;
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
CODEC_SOURCE = "dvf_tpu_torch/csrc/codec.cu"
# The delta-wire worker (the reference webcam app's 512² crop, low motion):
# invert, batch 8, tile 32, JPEG quality 90, keyframe every 16 frames.
WIRE_SIZE, WIRE_FRAMES, WIRE_BATCH, WIRE_TILE = 512, 160, 8, 32
WIRE_QUALITY, WIRE_KEY = 90, 16


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


def profiled_ms(fn, x, reps: int = REPS):
    """Device time and device kernels per call of ``fn(x)`` from a
    torch.profiler window over ``reps`` calls after warm-up. Unlike
    ``cuda_ms`` it leaves out the gaps in which the card waits for the
    host to launch."""
    for _ in range(3):
        fn(x)
    p = profile_call(lambda: [fn(x) for _ in range(reps)], reps)
    return p["device_ms_per_batch"], p["device_kernels_per_batch"]


def profile_call(fn, per: int) -> dict:
    """Run ``fn()`` once under torch.profiler: device time (kernels and
    copies), device kernels and host wall, each per one of ``per`` units
    (batches), the share of the wall the card was busy, and the top
    device entries [name, ms, count] per unit. The profiler slows the
    host, so the share errs low."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if dev_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return dict(device_busy_share=dev_ms / wall_ms, device_ms_per_batch=dev_ms / per,
                device_kernels_per_batch=sum(e.count for e in dev) / per,
                profiled_wall_ms_per_batch=wall_ms / per,
                top_device_ms_per_batch=[[e.key[:60], e.self_device_time_total / 1e3 / per,
                                          e.count / per] for e in top])


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
    env = host_env()
    log(f"environment: {json.dumps(env)}")

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"({time.perf_counter() - t0:.2f} s wall, nvcc {_build.nvcc_path()})")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    if env["libjpeg"]:
        from dvf_tpu_torch.transport.codec import _load_shim

        t0 = time.perf_counter()
        _load_shim()
        log(f"build: jpeg_shim.cpp with g++ ({time.perf_counter() - t0:.2f} s)")
    else:
        log("build: jpeg_shim.cpp not built: no libjpeg on this machine "
            "(see the environment line)")

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
    rows.extend(check_codec_kernels(dev, gen))
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
    # the delta-wire worker's legs (K5, K6)
    for row, delta in wire_legs(dev, env["libjpeg"]):
        for k, v in delta.items():
            launches[k] += v
        pipe_rows.append(row)
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
            n = 5   # batches back to back, each waited for
            row.update(profile_call(lambda: [eng.submit(inp, out=outs[i % 2]).fetch()
                                             for i in range(n)], n))
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


def host_env() -> dict:
    """What the delta-wire legs need of the host, probed (never inferred
    from a failure): libjpeg (library and header, for the JPEG shim), zmq
    (the worker's sockets; the legs below drive its batch step without
    them) and g++."""
    import ctypes.util
    import importlib.util
    import shutil

    lib = ctypes.util.find_library("jpeg")
    headers = [p for p in ("/usr/include/jpeglib.h", "/usr/local/include/jpeglib.h")
               if os.path.exists(p)]
    return {"libjpeg": bool(lib and headers), "libjpeg_library": lib,
            "jpeglib_h": headers, "zmq": importlib.util.find_spec("zmq") is not None,
            "gxx": shutil.which("g++")}


def ops_tile_maxdiff(shape) -> int:
    # per element pair: |a - b| and a max
    return 2 * int(np.prod(shape))


def ops_dct(shape) -> int:
    # per pixel: level shift 1, vertical pass 8 mul + 7 add, horizontal
    # pass 8 mul + 7 add, quantizer multiply 1, round 1
    return 33 * int(np.prod(shape))


def check_codec_kernels(dev, gen) -> list:
    """Phases 3-4 for K5 (tile_maxdiff) and K6 (dct8x8_quant): each against
    its plain version on the card at every listed shape, bit-exact (0
    differing elements), then timed at the delta-wire worker's shapes."""
    import torch

    from dvf_tpu_torch.ops import kernels as tk

    def frames_pair(shape):
        a = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
        b = a.clone()
        h, w = shape[1], shape[2]
        b[:, h // 4: h // 2, w // 3: w // 2] = torch.randint(
            0, 256, b[:, h // 4: h // 2, w // 3: w // 2].shape, generator=gen,
            device=dev, dtype=torch.uint8)
        b[:, -1, -1] ^= 1                           # the ragged corner tile
        return a, b

    md_cases = [((2, 68, 40, 3), 16), ((2, 68, 40, 1), 8),
                ((8, 512, 512, 3), 32), ((16, 1080, 1920, 3), 32)]
    for shape, tile in md_cases:
        a, b = frames_pair(shape)
        got = tk.tile_maxdiff_pallas(a, b, tile)
        torch.cuda.synchronize()
        n_diff = int((got != tk.tile_maxdiff_ref(a, b, tile)).sum())
        log(f"check tile_maxdiff {shape} tile {tile}: {n_diff} differing of "
            f"{got.numel()}")
        if n_diff:
            raise AssertionError(f"tile_maxdiff kernel differs from its plain "
                                 f"version at {shape}/t{tile} in {n_diff} tiles")
    wire_shape = (WIRE_BATCH, WIRE_SIZE, WIRE_SIZE, 3)
    # Kernel and plain times are device times (profiler); at these sizes a
    # CUDA-event span per call also holds the card's wait for the host's
    # launch, reported beside them as *_call_ms.
    timed = {}
    for shape in (wire_shape, MAIN_SHAPE):
        a, b = frames_pair(shape)

        def kern(_):
            return tk.tile_maxdiff_pallas(a, b, WIRE_TILE)

        def plain(_):
            return tk.tile_maxdiff_ref(a, b, WIRE_TILE)

        timed[shape] = (profiled_ms(kern, None)[0], profiled_ms(plain, None),
                        cuda_ms(kern, None), cuda_ms(plain, None),
                        bound(shape, ops_tile_maxdiff(shape), 2 * int(np.prod(shape))))
        del a, b
        ms, (pms, pk), cms, pcms, (b_ms, b_by) = timed[shape]
        log(f"time tile_maxdiff {shape} tile {WIRE_TILE}: kernel {ms:.4f} ms device "
            f"({cms:.4f} ms per call with launch), plain {pms:.4f} ms device in "
            f"{pk:.0f} kernels ({pcms:.4f} ms per call), bound {b_ms:.4f} ms ({b_by})")

    def plane(shape, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=dtype)
        return torch.rand(shape, generator=gen, device=dev) * 255.0

    dct_cases = [((2, 52, 100), torch.uint8, 90), ((2, 52, 100), torch.float32, 90),
                 ((4, 720, 1280), torch.uint8, 90)]
    dct_cases += [(s, torch.uint8, q) for s in ((8, 512, 512), (8, 256, 256))
                  for q in (50, 90, 95, 100)]
    for shape, dtype, q in dct_cases:
        x = plane(shape, dtype)
        table = tk.jpeg_quant_table(q)
        got = tk.dct8x8_quant_pallas(x, table)
        torch.cuda.synchronize()
        n_diff = int((got != tk.dct8x8_quant_ref(x, table)).sum())
        log(f"check dct8x8_quant {shape} {str(dtype)[6:]} q{q}: {n_diff} differing "
            f"of {got.numel()}")
        if n_diff:
            raise AssertionError(f"dct8x8_quant kernel differs from its plain "
                                 f"version at {shape} q{q} in {n_diff} coefficients")
    table = tk.jpeg_quant_table(WIRE_QUALITY)
    dct_timed = {}
    for shape in ((WIRE_BATCH, WIRE_SIZE, WIRE_SIZE),
                  (WIRE_BATCH, WIRE_SIZE // 2, WIRE_SIZE // 2)):
        x = plane(shape, torch.uint8)

        def kern(_):
            return tk.dct8x8_quant_pallas(x, table)

        def plain(_):
            return tk.dct8x8_quant_ref(x, table)

        dct_timed[shape] = (profiled_ms(kern, None)[0], profiled_ms(plain, None),
                            cuda_ms(kern, None), cuda_ms(plain, None),
                            bound(shape, ops_dct(shape), 3 * int(np.prod(shape))))
        ms, (pms, pk), cms, pcms, (b_ms, b_by) = dct_timed[shape]
        log(f"time dct8x8_quant {shape} uint8: kernel {ms:.4f} ms device ({cms:.4f} "
            f"ms per call with launch), plain {pms:.4f} ms device in {pk:.0f} kernels "
            f"({pcms:.4f} ms per call), bound {b_ms:.4f} ms ({b_by})")
    log("K5/K6 have no single PyTorch call computing the same function: "
        "library_ms is null for them")

    def row(name, replaces, shape, t, **extra):
        ms, (pms, _), cms, pcms, (b_ms, b_by) = t
        return dict(name=name, route="cuda", source=CODEC_SOURCE, replaces=replaces,
                    shape=list(shape), launches=None, max_abs_err=0.0, ms=ms,
                    kernel_ms=ms, call_ms=cms, plain_ms=pms, plain_call_ms=pcms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None, **extra)

    hd, y_shape, c_shape = timed[MAIN_SHAPE], *dct_timed
    chroma = dct_timed[c_shape]
    return [
        row("tile_maxdiff", "dvf_tpu/ops/pallas_kernels.py:625", wire_shape,
            timed[wire_shape], tile=WIRE_TILE, hd_shape=list(MAIN_SHAPE),
            hd_ms=hd[0], hd_call_ms=hd[2], hd_plain_ms=hd[1][0], hd_bound_ms=hd[4][0]),
        row("dct8x8_quant", "dvf_tpu/ops/pallas_kernels.py:840", y_shape,
            dct_timed[y_shape], quality=WIRE_QUALITY, chroma_shape=list(c_shape),
            chroma_ms=chroma[0], chroma_call_ms=chroma[2],
            chroma_plain_ms=chroma[1][0], chroma_bound_ms=chroma[4][0]),
    ]


class plain_codec_kernels:
    """Within the block, the codec assist calls K5's and K6's plain
    versions (on the card) instead of the kernels: the reference the
    kernels' wire legs are held to."""

    def __enter__(self):
        from dvf_tpu_torch.ops import kernels as tk
        from dvf_tpu_torch.runtime import codec_assist as ca

        self._saved = (ca.tile_maxdiff, ca.dct8x8_quant)
        ca.tile_maxdiff, ca.dct8x8_quant = tk.tile_maxdiff_ref, tk.dct8x8_quant_ref
        return self

    def __exit__(self, *exc):
        from dvf_tpu_torch.runtime import codec_assist as ca

        ca.tile_maxdiff, ca.dct8x8_quant = self._saved


def wire_frames() -> list:
    import dvf_tpu_torch

    src = dvf_tpu_torch.SyntheticSource(WIRE_SIZE, WIRE_SIZE, n_frames=WIRE_FRAMES,
                                        seed=0, motion="block")
    return [np.ascontiguousarray(f) for f, _ in src][:-1]


def wire_legs(dev, have_jpeg: bool):
    """Phase 5 for the delta-wire worker: yields (pipeline row, launch
    counts) per leg. With libjpeg, the worker's batch step (no sockets) on
    the JPEG delta wire with codec_assist "full" and "probe"; without it,
    the batch step with "probe" on the raw-inner delta wire, and the
    engine → FusedDeltaTransform leg that runs K5 and K6."""
    frames = wire_frames()
    if have_jpeg:
        legs = [("full", "jpeg"), ("probe", "jpeg")]
    else:
        log("wire legs: no libjpeg on this machine (see the environment line): "
            "the JPEG delta-wire legs do not run; the probe leg runs on the "
            "raw-inner delta wire and the full transform runs without entropy "
            "coding")
        legs = [("probe", "raw")]
    for assist, inner in legs:
        yield worker_leg(dev, frames, assist, inner)
    if not have_jpeg:
        yield fused_leg(dev, frames)


def _delta_codec(inner: str, **kw):
    from dvf_tpu_torch.transport import codec as tc

    base = (tc.NativeJpegCodec(WIRE_QUALITY, threads=4) if inner == "jpeg"
            else tc.RawCodec(WIRE_SIZE, WIRE_SIZE))
    return tc.DeltaCodec(base, tile=WIRE_TILE, keyframe_interval=WIRE_KEY, **kw)


def _run_worker(dev, blobs, assist: str, inner: str):
    """One pass of the app's stream through a socket-less ZmqWorker.
    Returns (payloads in send order as (index, bytes), stats, seconds)."""
    import dvf_tpu_torch

    worker = dvf_tpu_torch.ZmqWorker(
        dvf_tpu_torch.get_filter("invert"), batch_size=WIRE_BATCH, wire="delta",
        jpeg_quality=WIRE_QUALITY, delta_tile=WIRE_TILE,
        delta_keyframe_interval=WIRE_KEY, codec_assist=assist, device=dev,
        codec=_delta_codec(inner, on_gap="raise"), connect=False)
    sent = []
    try:
        worker.engine.compile((WIRE_BATCH, WIRE_SIZE, WIRE_SIZE, 3))
        t = time.perf_counter()
        for s in range(0, len(blobs), WIRE_BATCH):
            worker.process_batch(list(enumerate(blobs))[s:s + WIRE_BATCH],
                                 lambda i, t0, t1, p: sent.append((i, p)))
        worker.drain_egress()
        secs = time.perf_counter() - t
        stats = worker.stats()
    finally:
        worker.close()
    return sent, stats, secs


def worker_leg(dev, frames: list, assist: str, inner: str):
    """The worker's batch step over the app's encoded stream, launch
    counters zeroed just before and read just after; every index once and
    in order, every payload byte-identical to the same stream recomputed
    with the plain K5/K6 versions on the card and a fresh encoder."""
    from dvf_tpu_torch.ops import kernels as tk

    label = f"zmq_worker(delta/{inner}, codec_assist={assist})"
    app_enc = _delta_codec(inner)
    try:
        blobs = [app_enc.encode(f) for f in frames]
    finally:
        app_enc.close()
    tk.reset_launches()
    sent, stats, secs = _run_worker(dev, blobs, assist, inner)
    delta = dict(tk.LAUNCHES)
    n, nb = len(frames), len(frames) // WIRE_BATCH
    if [i for i, _ in sent] != list(range(n)):
        raise AssertionError(f"{label}: delivered {len(sent)} of {n}, out of order "
                             f"or repeated")
    want = {k: 0 for k in delta}
    want["tile_maxdiff"] = nb
    if assist == "full":
        want["dct8x8_quant"] = 3 * nb
    if delta != want:
        raise AssertionError(f"{label}: launches {delta}, want {want}")
    with plain_codec_kernels():
        ref, _, _ = _run_worker(dev, blobs, assist, inner)
    if tk.LAUNCHES != delta:
        raise AssertionError(f"{label}: the plain recomputation launched a kernel")
    n_diff = sum(p != q for (_, p), (_, q) in zip(sent, ref))
    if n_diff:
        raise AssertionError(f"{label}: {n_diff} payloads differ from the plain "
                             f"recomputation")
    dec = _delta_codec(inner)
    try:
        decoded = [dec.decode(p) for _, p in sent]
    finally:
        dec.close()
    prof = (profile_call(lambda: _run_worker(dev, blobs, assist, inner), n // WIRE_BATCH)
            if dev.type == "cuda" else {})
    exact = inner == "raw"   # lossless tiles, raw keyframes: the inversion itself
    if exact and not all(np.array_equal(d, 255 - f) for d, f in zip(decoded, frames)):
        raise AssertionError(f"{label}: decoded results are not the inverted frames")
    d, split = stats["delta"], stats["split_ms_per_batch"]
    per = {k: round(v, 4) for k, v in split.items()}
    fps = n / secs
    log(f"pipeline {label}: {n} frames, {stats['batches']} batches, {fps:.1f} fps "
        f"(batch step + drain), dirty ratio {d['dirty_ratio']}, keyframes "
        f"{d['keyframes']}, entropy {d['entropy_ms'] / n:.4f} ms/frame, d2h coef "
        f"{d['d2h_coef_bytes'] / n:.0f} B/frame, encode {stats['egress']['encode_ms']:.3f}"
        f" ms/batch; per batch ms {json.dumps(per)}; launches {delta}; payloads "
        f"byte-identical to the plain recomputation"
        + ("; decoded == 255 - frame" if exact else "") + f"; profiled: {json.dumps(prof)}")
    row = dict(filter=label, frames=n, batch=WIRE_BATCH, geometry=[WIRE_SIZE, WIRE_SIZE, 3],
               fps=fps, dirty_ratio=d["dirty_ratio"], keyframes=d["keyframes"],
               entropy_ms_per_frame=d["entropy_ms"] / n,
               d2h_coef_bytes_per_frame=d["d2h_coef_bytes"] / n,
               encode_ms_per_batch=stats["egress"]["encode_ms"],
               split_ms_per_batch=per, launches=delta, payloads_differing=0, **prof)
    return row, delta


def _fused_pass(dev, frames: list):
    """Engine(invert) → FusedDeltaTransform over the stream, each frame's
    dirty blocks gathered (bitmap > 0) and the first frame's whole grid."""
    import torch

    import dvf_tpu_torch

    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("invert"), device=dev)
    shape = (WIRE_BATCH, WIRE_SIZE, WIRE_SIZE, 3)
    eng.compile(shape)
    fused = dvf_tpu_torch.FusedDeltaTransform(tile=WIRE_TILE, quality=WIRE_QUALITY)
    staging = torch.empty(shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    view = staging.numpy()
    bitmaps, dirty, first, d2h = [], [], None, 0
    split = {"staging_ms": 0.0, "engine_stream_ms": 0.0, "fused_stream_ms": 0.0,
             "gather_ms": 0.0}
    cuda = dev.type == "cuda"
    t = time.perf_counter()
    for s in range(0, len(frames), WIRE_BATCH):
        t0 = time.perf_counter()
        for i in range(WIRE_BATCH):
            view[i] = frames[s + i]
        t1 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
        if cuda:
            ev[0].record()
        res = eng.submit(staging, fetch=False)
        if cuda:
            ev[1].record()
        bm, cfs = fused.process(res.device)   # the bitmap fetch waits for it
        if cuda:
            ev[2].record()
        t2 = time.perf_counter()
        for i, cf in enumerate(cfs):
            dirty.append(cf.fetch_dirty(bm[i] > 0))
            if first is None:
                first = cf.frame_blocks()
            d2h += cf.d2h_bytes
        bitmaps.append(bm)
        split["staging_ms"] += (t1 - t0) * 1e3
        if cuda:
            split["engine_stream_ms"] += ev[0].elapsed_time(ev[1])
            split["fused_stream_ms"] += ev[1].elapsed_time(ev[2])
        split["gather_ms"] += (time.perf_counter() - t2) * 1e3
    secs = time.perf_counter() - t
    nb = len(frames) // WIRE_BATCH
    return (np.concatenate(bitmaps), dirty, first, d2h, secs,
            {k: v / nb for k, v in split.items()}, fused.calls)


def fused_leg(dev, frames: list):
    """The full transform without entropy coding: launch counters zeroed
    just before and read just after; the bitmaps against the host
    reduction of the inverted frames; every frame's dirty blocks and the
    first frame's whole grid bit-exact to the plain recomputation."""
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.transport.codec import host_tile_maxdiff

    label = "engine(invert) -> FusedDeltaTransform (no entropy stage)"
    n, nb = len(frames), len(frames) // WIRE_BATCH
    tk.reset_launches()
    bms, dirty, first, d2h, secs, split, calls = _fused_pass(dev, frames)
    delta = dict(tk.LAUNCHES)
    want = {k: 0 for k in delta}
    want.update(tile_maxdiff=nb, dct8x8_quant=3 * nb)
    if delta != want or calls != nb:
        raise AssertionError(f"{label}: launches {delta} in {calls} calls, want {want}")
    out = [255 - f for f in frames]
    if not (bms[0] == 255).all():
        raise AssertionError(f"{label}: the first frame is not all-dirty")
    for i in range(1, n):
        if not np.array_equal(bms[i], host_tile_maxdiff(out[i], out[i - 1], WIRE_TILE)):
            raise AssertionError(f"{label}: frame {i}'s bitmap differs from the host")
    with plain_codec_kernels():
        rbms, rdirty, rfirst, _, _, _, _ = _fused_pass(dev, frames)
    if tk.LAUNCHES != delta:
        raise AssertionError(f"{label}: the plain recomputation launched a kernel")
    same = (np.array_equal(bms, rbms)
            and all(np.array_equal(a, b) for a, b in zip(first, rfirst))
            and all(np.array_equal(a, b) for f, g in zip(dirty, rdirty)
                    for a, b in zip(f, g)))
    if not same:
        raise AssertionError(f"{label}: coefficient blocks differ from the plain "
                             f"recomputation")
    ratio = float((bms[1:] > 0).mean())
    per = {k: round(v, 4) for k, v in split.items()}
    prof = profile_call(lambda: _fused_pass(dev, frames), nb) if dev.type == "cuda" else {}
    fps = n / secs
    log(f"pipeline {label}: {n} frames, {nb} batches, {fps:.1f} fps, dirty ratio "
        f"{ratio:.4f}, d2h coef {d2h / n:.0f} B/frame; per batch ms {json.dumps(per)};"
        f" launches {delta}; dirty blocks and first keyframe grid bit-exact to the "
        f"plain recomputation, bitmaps == host reduction; profiled: {json.dumps(prof)}")
    row = dict(filter=label, frames=n, batch=WIRE_BATCH,
               geometry=[WIRE_SIZE, WIRE_SIZE, 3], fps=fps, dirty_ratio=ratio,
               d2h_coef_bytes_per_frame=d2h / n, split_ms_per_batch=per,
               launches=delta, blocks_differing=0, **prof)
    return row, delta


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
