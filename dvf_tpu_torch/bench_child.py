"""Inner benchmark process (port of ``dvf_tpu.bench_child``): all device
work of one bench run happens here, in ONE subprocess that a parent can
bound with the whole bench budget and kill on a hang.

Protocol: progress phases go to stderr with timestamps (so a timeout
post-mortem shows exactly how far initialisation/compile got); the result
is ONE JSON line on stdout:

    {"backend": ..., "n_devices": N, "device_fps": ..., "ms_per_frame": ...,
     "h2d_mbps": ..., "d2h_mbps": ..., "link_roofline_fps": ...,
     "e2e_fps": ..., "roofline_frac": ..., "p50_ms": ..., "p99_ms": ...,
     "ingest": "streamed"|"monolithic", "overlap_efficiency": ...}

(``d2h_mbps`` times MATERIALIZED bytes into pinned host memory on a card
— see benchmarks.bench_transfer; ``ingest`` / ``overlap_efficiency``
report the streamed transfer path and how much H2D it hid.)

``--platform`` is ``cuda`` (``cuda:0``, the default) or ``cpu``; the
process never moves to the CPU on its own. CUDA's initialisation runs
under ``--init-timeout`` in a watchdog thread: a card that does not
come up exits 3 at once instead of eating the parent's budget. The
kernel-build cache (``runtime.engine.enable_compilation_cache``: the
``DVF_COMPILE_CACHE_DIR`` variable, else ``dvf_tpu_torch/_build/``) is
armed first, so a rerun loads its kernels instead of building them.

Measurement design is in dvf_tpu_torch/benchmarks.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

PLATFORMS = ("cuda", "cpu")


def _log(msg: str) -> None:
    print(f"[bench-child +{time.perf_counter() - _T0:.1f}s] {msg}",
          file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def _heartbeat_during(label: str, period: float = 10.0):
    """Context manager: emit '<label> … still working' every ``period`` s.

    Initialisation and the first compile are the phases that hang; the
    heartbeat turns a silent SIGKILL post-mortem into a timeline.
    """
    stop = threading.Event()

    def beat():
        n = 0
        while not stop.wait(period):
            n += 1
            _log(f"{label}… still working ({n * period:.0f}s)")

    t = threading.Thread(target=beat, daemon=True)

    class _Ctx:
        def __enter__(self):
            t.start()

        def __exit__(self, *exc):
            stop.set()
            t.join(timeout=1.0)

    return _Ctx()


def _init_devices(platform: str) -> list:
    """The devices of ``platform``, initialising CUDA for "cuda"; raises
    when there is none."""
    import torch

    if platform == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --platform cpu "
                           "to run on the CPU)")
    torch.cuda.init()
    torch.zeros(1, device="cuda:0")   # the context exists and executes
    torch.cuda.synchronize()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--frames", type=int, default=512,
                    help="e2e frame cap; shrunk automatically when the "
                         "link roofline makes 512 frames exceed the budget")
    ap.add_argument("--e2e-batch", type=int, default=16)
    ap.add_argument("--lat-batch", type=int, default=4,
                    help="batch for the rate-controlled latency run (small "
                         "batches bound the assemble wait)")
    ap.add_argument("--e2e-budget-s", type=float, default=60.0,
                    help="target wall time for each e2e phase")
    ap.add_argument("--init-timeout", type=float, default=150.0,
                    help="give up on CUDA's initialisation after this many "
                         "seconds (healthy init takes a few seconds)")
    ap.add_argument("--collect-mode", choices=("thread", "inline"),
                    default="inline",
                    help="pipeline collect mode for the e2e phases")
    ap.add_argument("--ingest", choices=("streamed", "monolithic"),
                    default="streamed",
                    help="e2e batch staging path: streamed copies row "
                         "chunks on the H2D stream as they fill; monolithic "
                         "is the whole-batch copy baseline")
    ap.add_argument("--ingest-depth", type=int, default=4,
                    help="streamed ingest: max chunk copies in flight")
    ap.add_argument("--egress", choices=("streamed", "monolithic"),
                    default="streamed",
                    help="e2e result fetch path: streamed starts the D2H at "
                         "submit into pooled pinned slabs; monolithic is "
                         "the whole-batch fetch baseline")
    ap.add_argument("--transport", choices=("python", "ring"),
                    default="python",
                    help="e2e ingest transport; ring puts the native shm "
                         "ring (and with --wire, a codec) on the hot path")
    ap.add_argument("--wire", choices=("raw", "jpeg", "delta"),
                    default="raw",
                    help="e2e ring payload format (jpeg needs libjpeg)")
    ap.add_argument("--motion", choices=("roll", "block", "none"),
                    default="roll",
                    help="e2e synthetic stream motion: roll = full-motion "
                         "worst case, block = webcam-like low motion, "
                         "none = static")
    ap.add_argument("--mode", choices=("probe", "headline", "device", "e2e"),
                    default="headline")
    ap.add_argument("--no-decomp", action="store_true",
                    help="skip the per-stage latency decomposition in "
                         "headline mode")
    ap.add_argument("--platform", choices=PLATFORMS, default="cuda",
                    help="cuda (cuda:0, the default) or cpu")
    args = ap.parse_args(argv)

    from dvf_tpu_torch.runtime.engine import enable_compilation_cache

    _log(f"kernel build cache: {enable_compilation_cache()}")

    # Init watchdog: a healthy CUDA initialises in seconds; one that has
    # not come up after --init-timeout will not this window. The init
    # call cannot be cancelled, so run it in a worker thread and
    # hard-exit on timeout — rc 3 tells the parent at once.
    got: dict = {}

    def _init():
        try:
            got["devices"] = _init_devices(args.platform)
        except Exception as e:  # noqa: BLE001 — init can raise anything
            got["error"] = e

    t = threading.Thread(target=_init, daemon=True)
    with _heartbeat_during("device init"):
        t.start()
        t.join(args.init_timeout)
    if "devices" not in got:
        if "error" in got:
            _log(f"device init failed: {got['error']!r}")
        else:
            _log(f"device init exceeded {args.init_timeout:.0f}s — exiting")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(3)
    import torch

    devices = got["devices"]
    device = devices[0]
    backend = device.type
    name = ("cpu" if backend == "cpu" else torch.cuda.get_device_name(device))
    _log(f"backend={backend} n_devices={len(devices)} device0={name}")

    if args.mode == "probe":
        # Pre-flight health check: initialisation IS the phase that hangs,
        # so "init completed" is the whole signal. A tiny computation
        # confirms the device executes.
        val = float(torch.arange(8, device=device).sum().item())
        print(json.dumps({"backend": backend, "n_devices": len(devices),
                          "device0": name, "probe_sum": val}), flush=True)
        return 0

    from dvf_tpu_torch.benchmarks import (
        bench_device_resident,
        bench_e2e_latency,
        bench_e2e_streaming,
        bench_stage_decomposition,
        bench_transfer,
        roofline_fields,
    )
    from dvf_tpu_torch.ops import get_filter

    filt = get_filter("invert")
    result: dict = {"backend": backend, "n_devices": len(devices)}

    if args.mode in ("headline", "device"):
        _log(f"device-resident: batch={args.batch} iters={args.iters} "
             f"{args.height}x{args.width}")
        with _heartbeat_during("device-resident (first run compiles)"):
            r = bench_device_resident(filt, args.iters, args.batch,
                                      args.height, args.width, device=device)
        result.update(
            device_fps=round(r["fps"], 1),
            ms_per_batch=round(r["ms_per_batch"], 3),
            ms_per_frame=round(r["ms_per_frame"], 4),
            device_frames=r["frames"],
            device_wall_s=round(r["wall_s"], 2),
            batch=args.batch,
        )
        result.update(roofline_fields(r, backend))
        _log(f"device-resident done: {result['device_fps']} fps "
             f"(hbm_roofline_frac={result.get('hbm_roofline_frac')})")

    if args.mode == "headline" and not args.no_decomp:
        # Per-stage latency decomposition at small batch.
        _log("stage decomposition (batch 1/2/4)")
        with _heartbeat_during("stage decomposition"):
            decomp = bench_stage_decomposition(
                filt, sorted({1, 2, args.lat_batch}), args.height,
                args.width, reps=25 if backend == "cuda" else 5,
                device=device)
        # Codec provenance travels beside the encode_ms leg it produced.
        result["codec"] = decomp.pop("codec", None)
        result["stage_decomp_ms"] = decomp
        lat_key = f"batch_{args.lat_batch}"
        if lat_key in decomp:
            result["compute_p50_ms"] = decomp[lat_key]["compute_ms"]
        _log(f"decomposition done: {json.dumps(decomp)}")

    # Link microbench — also sizes the e2e phases.
    _log("transfer microbench")
    tr = bench_transfer(args.e2e_batch, args.height, args.width, device=device)
    frame_mb = tr["batch_mb"] / args.e2e_batch
    roof = 1.0 / (
        frame_mb / tr["h2d_mbps"]
        + frame_mb / tr["d2h_mbps"]
        + tr["d2h_fixed_ms"] / 1e3 / args.e2e_batch
    )
    result.update(
        h2d_mbps=round(tr["h2d_mbps"], 1),
        d2h_mbps=round(tr["d2h_mbps"], 1),
        link_roofline_fps=round(roof, 1),
        host_memory=tr["host_memory"],
    )
    _log(f"link: h2d={result['h2d_mbps']} MB/s d2h={result['d2h_mbps']} MB/s "
         f"({tr['host_memory']}) → roofline ≈ {result['link_roofline_fps']} "
         f"fps at {args.height}x{args.width}")

    if args.mode in ("headline", "e2e"):
        n_frames = max(48, min(args.frames, int(roof * args.e2e_budget_s)))
        _log(f"e2e throughput: batch={args.e2e_batch} frames={n_frames}")
        with _heartbeat_during("e2e throughput"):
            r = bench_e2e_streaming(filt, n_frames, args.e2e_batch,
                                    args.height, args.width,
                                    collect_mode=args.collect_mode,
                                    transport=args.transport,
                                    wire=args.wire,
                                    motion=args.motion,
                                    ingest=args.ingest,
                                    ingest_depth=args.ingest_depth,
                                    egress=args.egress,
                                    device=device)
        if "wire" in r:
            result.update(transport=args.transport, wire=args.wire,
                          motion=args.motion, wire_stats=r["wire"])
        result.update(
            e2e_fps=round(r["fps"], 1),
            e2e_frames=r["frames"],
            e2e_wall_s=round(r["wall_s"], 2),
            e2e_batch=args.e2e_batch,
            collect_mode=args.collect_mode,
            ingest=r["ingest"],
            ingest_depth=r["ingest_depth"],
            overlap_efficiency=r["overlap_efficiency"],
            egress=r["egress"],
            egress_overlap_efficiency=r["egress_overlap_efficiency"],
            faults=r.get("faults", {}),
            recoveries=r.get("recoveries", 0),
            roofline_frac=round(r["fps"] / roof, 3) if roof else None,
        )
        _log(f"e2e done: {result['e2e_fps']} fps "
             f"({result['roofline_frac']} of link roofline, "
             f"ingest={result['ingest']} "
             f"overlap_eff={result['overlap_efficiency']})")

        # Rate-controlled latency: 0.8× measured throughput, queue ≈ batch —
        # p50 is transit, not queue depth.
        target = 0.8 * r["fps"]
        n_lat = max(32, min(args.frames, int(target * args.e2e_budget_s)))
        _log(f"e2e latency: batch={args.lat_batch} target={target:.1f} fps "
             f"frames={n_lat}")
        with _heartbeat_during("e2e latency"):
            rl = bench_e2e_latency(filt, n_lat, args.lat_batch,
                                   args.height, args.width, target,
                                   collect_mode=args.collect_mode,
                                   transport=args.transport,
                                   wire=args.wire,
                                   motion=args.motion,
                                   ingest=args.ingest,
                                   ingest_depth=args.ingest_depth,
                                   egress=args.egress,
                                   device=device)
        result.update(
            p50_ms=round(rl["p50_ms"], 2),
            p99_ms=round(rl["p99_ms"], 2),
            lat_frames=rl["frames"],
            lat_batch=args.lat_batch,
            lat_target_fps=round(rl["target_fps"], 1),
            lat_delivery_fps=round(rl["delivery_fps"], 2),
            lat_congested=rl["congested"],
            lat_backoffs=rl["backoffs"],
        )
        _log(f"latency done: p50={result['p50_ms']}ms p99={result['p99_ms']}ms "
             f"(target {result['lat_target_fps']} fps after "
             f"{rl['backoffs']} backoffs, congested={rl['congested']})")

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
