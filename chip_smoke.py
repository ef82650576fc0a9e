#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which raises (and so exits non-zero) on failure:

1. the card: torch's device name, and name + power limit from nvidia-smi;
2. build every kernel in dvf_tpu_torch/csrc with nvcc (sm_90a);
3. each hand-written kernel against its plain torch version on the card, at
   an unaligned 68x40 shape and at the main-path shape (16 x 1080 x 1920 x 3),
   max abs error <= 1e-5 (TF32 off for every plain or library call);
4. CUDA-event times (median of 20 runs after warm-up) of the kernel, its
   plain version and, for the separable blur, one PyTorch library
   formulation as a yardstick; the bound each kernel could reach;
5. the main path: a 1080p batch-16 Pipeline for invert, gaussian_blur(k=9),
   bilateral and sobel_bilateral with impl=None (the kernels). Launch
   counters are set to 0 just before and read just after; every kernel must
   have launched once per batch of its filter. Delivered frames must come
   in order, all of them, within 1 LSB of the plain version;
6. a coarse split of a pipeline batch: the engine alone (pinned H2D,
   filter, D2H, back to back) against the host copies the pipeline adds
   (16 frames into a pinned slot, 16 rows out of it).

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
MAIN_SHAPE = (16, 1080, 1920, 3)
SMALL_SHAPE = (2, 68, 40, 3)
N_FRAMES = 320
REPS = 20
SOURCE = "dvf_tpu_torch/csrc/stencils.cu"


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


def bound(shape, ops: int):
    nbytes = 2 * int(np.prod(shape)) * 4  # float32 in once, out once
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    # 5. the main path
    legs = [("invert", {}, None),
            ("gaussian_blur", {"ksize": 9}, "sep_blur"),
            ("bilateral", {}, "bilateral"),
            ("sobel_bilateral", {}, "sobel_bilateral")]
    plain_of = {spec["name"]: spec["plain"] for spec in specs}
    cfg = dvf_tpu_torch.PipelineConfig(batch_size=MAIN_SHAPE[0],
                                       queue_size=N_FRAMES + 1)
    engines = {}
    for name, kw, _ in legs:  # compile (and warm up) outside the counted run
        eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw))
        eng.compile(MAIN_SHAPE)
        engines[name] = eng
    keep = (0, 1, N_FRAMES // 2, N_FRAMES - 1)
    pipe_rows = []
    tk.reset_launches()
    for name, kw, counter in legs:
        before = dict(tk.LAUNCHES)
        order, kept = [], {}

        def sink(i, f, _ts):
            order.append(i)
            if i in keep:
                kept[i] = f

        src = dvf_tpu_torch.SyntheticSource(*MAIN_SHAPE[1:], n_frames=N_FRAMES, seed=0)
        stats = dvf_tpu_torch.Pipeline(src, engines[name].filter,
                                       dvf_tpu_torch.CallbackSink(sink), cfg,
                                       engine=engines[name]).run()
        delta = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
        if order != list(range(N_FRAMES)) or stats["delivered"] != N_FRAMES:
            raise AssertionError(f"{name}: delivered {stats['delivered']} of "
                                 f"{N_FRAMES}, in order: {order == sorted(order)}")
        want_delta = {k: (stats["engine_batches"] if k == counter else 0)
                      for k in delta}
        if delta != want_delta:
            raise AssertionError(f"{name}: launches {delta}, want {want_delta}")
        frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
            *MAIN_SHAPE[1:], n_frames=N_FRAMES, seed=0)]
        x = torch.from_numpy(np.stack([frames[i] for i in keep])).to(dev)
        plain = plain_of.get(counter, lambda v: 1.0 - v)  # invert: no kernel
        want = to_uint8(plain(to_float(x))).cpu().numpy()
        got = np.stack([kept[i] for i in keep])
        lsb = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        if lsb > 1:
            raise AssertionError(f"{name}: delivered frames differ from the "
                                 f"plain version by {lsb} LSB")
        log(f"pipeline {name}: {stats['delivered']} frames, {stats['engine_batches']} "
            f"batches, {stats['fps']:.1f} fps, p50 {stats['p50_ms']:.2f} ms, "
            f"p99 {stats['p99_ms']:.2f} ms, launches {delta}, max {lsb} LSB vs plain")
        pipe_rows.append(dict(filter=name, frames=N_FRAMES,
                              batch=MAIN_SHAPE[0], geometry=list(MAIN_SHAPE[1:]),
                              fps=stats["fps"], p50_ms=stats["p50_ms"],
                              p99_ms=stats["p99_ms"], launches=delta,
                              max_lsb_vs_plain=lsb))
    launches = dict(tk.LAUNCHES)
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the main path")

    # 6. where a pipeline batch goes (after the counted run)
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        *MAIN_SHAPE[1:], n_frames=MAIN_SHAPE[0], seed=0)][:-1]
    inp = torch.empty(MAIN_SHAPE, dtype=torch.uint8, pin_memory=True)
    view = inp.numpy()
    outs = [torch.empty(MAIN_SHAPE, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    t = time.perf_counter()
    for _ in range(REPS):
        for row, f in enumerate(frames):
            view[row] = f
    stage_ms = (time.perf_counter() - t) * 1e3 / REPS
    t = time.perf_counter()
    for _ in range(REPS):
        rows_out = [outs[0].numpy()[i].copy() for i in range(MAIN_SHAPE[0])]
    copy_out_ms = (time.perf_counter() - t) * 1e3 / REPS
    del rows_out
    stage_rows = []
    for name, _, _ in legs:
        eng = engines[name]
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
        log(f"stages {name}: engine alone {engine_ms:.2f} ms/batch "
            f"({MAIN_SHAPE[0] * 1e3 / engine_ms:.1f} fps); host staging "
            f"{stage_ms:.2f} ms, row copy-out {copy_out_ms:.2f} ms per batch")
        stage_rows.append(dict(filter=name, engine_ms_per_batch=engine_ms,
                               staging_ms_per_batch=stage_ms,
                               copy_out_ms_per_batch=copy_out_ms))

    print(json.dumps({"pipeline": pipe_rows}))
    print(json.dumps({"stages": stage_rows}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
