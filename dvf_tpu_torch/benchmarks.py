"""Benchmark harnesses of the CLI's ``bench`` and ``fleet --scaling`` and of
``bench_child`` (port of ``dvf_tpu.benchmarks``).

Measurement modes:

- **device-resident** — a dependent chain of batches through the Engine
  (uint8 in/out, state threading), each output the next input, ending in
  a checksum whose host fetch (``.item()``) forces completion. The card is
  synchronised before the clock starts, so neither the warm-up's tail nor
  unfinished launches enter the window. This is the framework's sustained
  filter throughput, immune to asynchronous-launch timing lies and to
  host-link transfer costs.
- **transfer** — host↔device link microbench (MB/s each direction + fixed
  per-transfer cost), so the bench can report how close the pipeline
  gets to the link roofline instead of presenting a transfer-bound fps
  as a framework property.
- **e2e streaming (throughput)** — the full pipeline (synthetic source →
  batch assembler → device → ordered sink), source unthrottled: delivered
  fps, the metric the reference prints ad hoc (webcam_app.py:88-95,152-163).
- **e2e latency (rate-controlled)** — same pipeline with the source
  throttled below measured throughput and an ingest queue ≈ one batch, so
  p50/p99 measure pipeline *transit* (capture→deliver on an un-congested
  stream) rather than standing queue depth — the number BASELINE.md's
  <10 ms target is about.

Every entry point runs on ``cuda:0`` unless ``device`` names the CPU.
The host memory the transfer legs time is the pipeline's: pinned on a
card (the port's ingest and egress stage through pinned slabs), pageable
on the CPU, where there is no link (:func:`transfer_host_memory`). The
reference times a pageable ``device_put``. A ``mesh``
(``parallel.mesh.make_mesh``) runs the engine over it, the batch laid out
in blocks on its devices.
"""

from __future__ import annotations

import time
from typing import Optional

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.runtime.cost import H100_PEAKS


def _sync(device) -> None:
    """Wait for the device, or for every device of a mesh engine's
    (``device`` is then the engine)."""
    import torch

    for d in getattr(device, "devices", [device]):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def transfer_host_memory(device) -> str:
    """The host memory the transfer legs copy from and into: "pinned" for
    a card (what the pipeline's slabs are), "pageable" on the CPU."""
    return "pinned" if device.type == "cuda" else "pageable"


def _host_buffer(shape, device):
    import torch

    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=transfer_host_memory(device) == "pinned")


def bench_device_resident(
    filt: Filter,
    iters: int,
    batch_size: int,
    height: int,
    width: int,
    dtype=None,
    mesh=None,
    device=None,
) -> dict:
    import numpy as np
    import torch

    from dvf_tpu_torch.runtime.cost import filter_cost
    from dvf_tpu_torch.runtime.engine import Engine, host_tensor

    dtype = dtype or np.uint8
    shape = (batch_size, height, width, 3)
    engine = Engine(filt, device=device, mesh=mesh)
    dev = engine
    engine.compile(shape, dtype)

    rng = np.random.default_rng(0)
    host_batch = rng.integers(0, 255, size=shape, dtype=np.uint8).astype(dtype)

    def blocks(t):
        return getattr(t, "shards", [t])

    def checksum(t) -> float:
        # the host fetch ends the run
        return sum(b.to(torch.float32).sum().item() for b in blocks(t))

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        batch = engine.upload(host_tensor(host_batch))
        _sync(dev)
        h2d_s = time.perf_counter() - t0
        h2d_mbps = host_batch.nbytes / 1e6 / h2d_s if h2d_s > 0 else float("inf")

        out = engine.run_device_resident(batch).device
        checksum(out)
        if out.shape == batch.shape:
            # Dependent chain: each output IS the next input, so
            # asynchronous launches can't overlap away real work.
            batch = out
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                batch = engine.run_device_resident(batch).device
            checksum(batch)
            wall = time.perf_counter() - t0
        else:
            # Geometry-changing filter (super_resolution): feeding the
            # output back would change the signature every iteration. Keep
            # the cross-iteration data dependency instead by folding a
            # scalar of the previous output into the fixed-shape input —
            # same no-overlap guarantee, stable signature.
            def fold(x, y):
                z = blocks(y)[0].to(torch.float32).sum() * 0
                if hasattr(x, "shards"):
                    return x.map(lambda t: t + z.to(t.device).to(t.dtype))
                return x + z.to(x.dtype)

            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = engine.run_device_resident(fold(batch, out)).device
            checksum(out)
            wall = time.perf_counter() - t0

    frames = iters * batch_size
    result = {
        "fps": frames / wall if wall > 0 else 0.0,
        "frames": frames,
        "wall_s": wall,
        "ms_per_batch": wall / iters * 1e3,
        "ms_per_frame": wall / frames * 1e3,
        "h2d_mbps": h2d_mbps,
    }
    ca = engine.cost_analysis()
    if ca is not None:
        result["flops_per_frame"] = ca["flops_per_batch"] / batch_size
        result["bytes_accessed_per_frame"] = (
            ca["bytes_accessed_per_batch"] / batch_size)
        result["peak_tflops"] = filter_cost(filt, shape).peak_flops_s / 1e12
    return result


def roofline_fields(r: dict, backend: str) -> dict:
    """Roofline fraction + MFU for a :func:`bench_device_resident` result.

    Memory model for the fraction (right for the stencil/pointwise filter
    families, which are HBM-bound): achievable fps ceiling = HBM bandwidth
    / the counted bytes per frame (``Engine.cost_analysis``). MFU (right
    for the neural configs style/SR) = achieved FLOP rate / the card's
    peak for the filter's arithmetic (``peak_tflops``: bf16 tensor cores
    for the nets, float32 CUDA cores for the rest; bf16 when the result
    does not say). Both are reported so each config is judged against
    the model that binds it. Only the card has published peaks (the
    H100's, :data:`H100_PEAKS`) — CPU results return {}. A share above
    1.0 means the count is wrong.
    """
    if backend != "cuda" or "bytes_accessed_per_frame" not in r:
        return {}
    bytes_f = r["bytes_accessed_per_frame"]
    flops_f = r.get("flops_per_frame", 0.0)
    fps = r.get("fps", 0.0)
    out = {}
    if bytes_f > 0:
        ceil = H100_PEAKS["hbm_gbps"] * 1e9 / bytes_f
        # "hbm_" prefix: the e2e phase reports a LINK-based
        # `roofline_frac` (fraction of the host↔device ceiling); this one
        # is the fraction of the HBM-bandwidth ceiling for device-resident
        # throughput — different ceiling, different name.
        out["hbm_roofline_fps"] = round(ceil, 1)
        out["hbm_roofline_frac"] = round(fps / ceil, 3) if ceil else None
        out["hbm_gb_per_frame"] = round(bytes_f / 1e9, 6)
    if flops_f > 0:
        peak = r.get("peak_tflops", H100_PEAKS["bf16_tflops"])
        out["mfu"] = round(fps * flops_f / (peak * 1e12), 5)
        out["mfu_peak_tflops"] = peak
        out["gflops_per_frame"] = round(flops_f / 1e9, 3)
    return out


def bench_stage_decomposition(
    filt: Filter,
    batch_sizes=(1, 2, 4),
    height: int = 1080,
    width: int = 1920,
    reps: int = 50,
    transfer_reps: int = 3,
    measure_encode: bool = True,
    device=None,
) -> dict:
    """Per-stage latency decomposition at small batch.

    For each batch size, p50 over ``reps`` of the four legs a frame
    actually crosses in the pipeline: host staging copy (frames stacked
    into the dispatch slab, pinned on a card as the pipeline's are), H2D
    (the slab to the device, synchronised), compute (one engine step,
    synchronised — includes launch overhead, as the pipeline experiences
    it), D2H (the result into a pinned host buffer on a card). The D2H leg
    is timed only ``transfer_reps`` times (matching bench_transfer's
    reps).

    ``measure_encode`` adds the fifth leg a wire-delivery frame crosses:
    a single-threaded JPEG encode of the fetched batch (host work). It is
    reported per batch as ``encode_ms`` but kept OUT of ``total_ms``:
    these legs time the serialized monolithic path, and the asynchronous
    codec plane (runtime/egress.py) overlaps the encode with the next
    batch's compute. The codec measured is recorded under ``codec``. The
    codec is the native JPEG shim (``transport.codec.make_codec``), which
    raises where it cannot be built (no libjpeg): asking for the encode
    leg there fails loudly, it is never skipped.
    """
    import numpy as np
    import torch

    from dvf_tpu_torch.runtime.engine import Engine, host_array, resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out: dict = {}
    codec = None
    if measure_encode:
        from dvf_tpu_torch.transport.codec import make_codec

        # threads=1: the per-frame serialized CYCLE cost the latency
        # model wants (measure_codec_fps's mode="cycle").
        codec = make_codec(threads=1)
        out["codec"] = codec.config()
    try:
        for b in batch_sizes:
            shape = (b, height, width, 3)
            engine = Engine(filt, device=dev)
            engine.compile(shape, np.uint8)
            frames = [rng.integers(0, 255, size=(height, width, 3), dtype=np.uint8)
                      for _ in range(b)]
            staging_t = _host_buffer(shape, dev)
            staging = staging_t.numpy()
            d2h_dst = None  # sized from the result (geometry-changing filters)
            legs = {"staging_ms": [], "h2d_ms": [], "compute_ms": [], "d2h_ms": []}
            with torch.no_grad():
                for rep in range(reps):
                    t0 = time.perf_counter()
                    for i, f in enumerate(frames):
                        staging[i] = f
                    t1 = time.perf_counter()
                    x = staging_t.to(dev, non_blocking=True, copy=True)
                    _sync(dev)
                    t2 = time.perf_counter()
                    y = engine.run_device_resident(x).device
                    _sync(dev)
                    t3 = time.perf_counter()
                    legs["staging_ms"].append((t1 - t0) * 1e3)
                    legs["h2d_ms"].append((t2 - t1) * 1e3)
                    legs["compute_ms"].append((t3 - t2) * 1e3)
                    if rep < transfer_reps:
                        if d2h_dst is None:
                            d2h_dst = torch.empty(
                                y.shape, dtype=y.dtype,
                                pin_memory=transfer_host_memory(dev) == "pinned")
                            t3 = time.perf_counter()  # exclude the one-time alloc
                        d2h_dst.copy_(y)
                        t4 = time.perf_counter()
                        legs["d2h_ms"].append((t4 - t3) * 1e3)
                        host = host_array(d2h_dst)
                        if (codec is not None and host.dtype == np.uint8
                                and host.ndim == 4 and host.shape[-1] == 3):
                            codec.encode_batch(list(host))
                            legs.setdefault("encode_ms", []).append(
                                (time.perf_counter() - t4) * 1e3)
            enc = legs.pop("encode_ms", None)
            p50 = {k: round(float(np.percentile(v, 50)), 4) for k, v in legs.items()}
            # encode_ms deliberately excluded from total_ms (see docstring)
            p50["total_ms"] = round(sum(p50.values()), 4)
            if enc:
                p50["encode_ms"] = round(float(np.percentile(enc, 50)), 4)
            p50["per_frame_compute_ms"] = round(p50["compute_ms"] / b, 4)
            # These legs time the serialized whole-batch path by
            # construction; the streamed path's hiding shows up in
            # overlap_efficiency instead.
            p50["transfer_mode"] = "whole_batch"
            out[f"batch_{b}"] = p50
    finally:
        if codec is not None:
            codec.close()
    return out


def bench_transfer(batch_size: int, height: int, width: int, reps: int = 3,
                   device=None) -> dict:
    """Host↔device link microbench for one uint8 NHWC batch.

    Returns MB/s both directions plus the fixed per-transfer cost
    (estimated from a tiny D2H), so callers can compute the link roofline
    for any frame geometry: fps_ceiling = 1 / (bytes·(1/h2d + 1/d2h) + c).

    Both directions copy between the device and host buffers of the
    memory :func:`transfer_host_memory` names (``host_memory`` in the
    result): pinned on a card, the memory the pipeline's ingest and
    egress slabs use — not the reference's pageable ``device_put``. D2H
    measures MATERIALIZED bytes: a fresh device result copied into a
    preallocated host buffer and synchronised, never a view.
    """
    import numpy as np
    import torch

    from dvf_tpu_torch.runtime.engine import resolve_device

    dev = resolve_device(device)
    shape = (batch_size, height, width, 3)
    host = _host_buffer(shape, dev)
    host.numpy()[...] = np.random.default_rng(0).integers(
        0, 255, size=shape, dtype=np.uint8)
    dst = _host_buffer(shape, dev)            # materialization target
    tiny_src = _host_buffer((1, 8, width, 3), dev)
    tiny_src.copy_(host[:1, :8])
    tiny_dst = _host_buffer((1, 8, width, 3), dev)
    dev_batch = host.to(dev)
    _sync(dev)

    h2d, d2h = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        x = host.to(dev, non_blocking=True, copy=True)
        _sync(dev)
        h2d.append(time.perf_counter() - t0)
        del x
        y = dev_batch + 1  # fresh result each rep — no cached host copy
        _sync(dev)
        t0 = time.perf_counter()
        dst.copy_(y, non_blocking=True)
        _sync(dev)
        d2h.append(time.perf_counter() - t0)
    fixed = []
    for _ in range(reps):
        tiny = tiny_src.to(dev) + 1
        _sync(dev)
        t0 = time.perf_counter()
        tiny_dst.copy_(tiny, non_blocking=True)
        _sync(dev)
        fixed.append(time.perf_counter() - t0)
    # min over reps, and never let the correction exceed 90% of the bulk
    # time: one hiccup must not produce an absurd d2h_mbps.
    fixed_s = min(min(fixed), 0.9 * min(d2h))
    mb = host.numel() / 1e6
    return {
        "h2d_mbps": mb / min(h2d),
        "d2h_mbps": mb / (min(d2h) - fixed_s),
        "d2h_fixed_ms": fixed_s * 1e3,
        "batch_mb": mb,
        "d2h_measures": "materialized_copy",  # provenance of the number
        "host_memory": transfer_host_memory(dev),
    }


def _run_pipeline(filt, source, batch_size, height, width, max_inflight,
                  queue_size, collect_mode="thread", transport="python",
                  wire="raw", mesh=None, ingest="streamed",
                  ingest_depth=4, egress="streamed", device=None) -> dict:
    import numpy as np

    from dvf_tpu_torch.io.sinks import NullSink
    from dvf_tpu_torch.runtime.engine import Engine
    from dvf_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig

    engine = Engine(filt, device=device, mesh=mesh)
    engine.compile((batch_size, height, width, 3), np.uint8)
    sink = NullSink()
    queue = None
    if transport == "ring":
        from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

        queue = RingFrameQueue((height, width, 3),
                               capacity_frames=queue_size,
                               wire=wire)
    pipe = Pipeline(
        source,
        filt,
        sink,
        config=PipelineConfig(
            batch_size=batch_size,
            queue_size=queue_size,
            frame_delay=0,
            max_inflight=max_inflight,
            collect_mode=collect_mode,
            ingest=ingest,
            ingest_depth=ingest_depth,
            egress=egress,
        ),
        engine=engine,
        queue=queue,
    )
    t0 = time.perf_counter()
    try:
        stats = pipe.run()
    finally:
        # run() closes the queue on the happy path only; an erroring run
        # must not leak the native ring / codec thread pool.
        if queue is not None:
            queue.close()
    wall = time.perf_counter() - t0
    pct = sink.latency_percentiles()
    ingest_stats = stats.get("ingest", {})
    egress_stats = stats.get("egress", {})
    return {
        "fps": sink.count / wall if wall > 0 else 0.0,
        # Steady-state delivery rate, first→last delivery: excludes
        # start-up before the first frame and drain after the last, so it
        # is comparable to an offered rate where the whole-wall fps above
        # is not.
        "delivery_fps": sink.fps(),
        "frames": sink.count,
        "wall_s": wall,
        "p50_ms": pct.get("p50", float("nan")),
        "p99_ms": pct.get("p99", float("nan")),
        "dropped": stats.get("dropped_at_ingest", 0),
        # The transfer path actually taken and how much of the per-batch
        # H2D cost it hid under staging/compute (obs.metrics.IngestStats).
        "ingest": ingest_stats.get("mode", ingest),
        "ingest_depth": ingest_depth,
        "overlap_efficiency": ingest_stats.get("overlap_efficiency"),
        "ingest_stats": ingest_stats,
        # The delivery-side mirror (obs.metrics.EgressStats).
        "egress": egress_stats.get("mode", egress),
        "egress_overlap_efficiency": egress_stats.get("overlap_efficiency"),
        "egress_stats": egress_stats,
        # Per-kind fault counters — a clean bench run asserts an empty
        # dict; any entry means the number absorbed contained faults.
        "faults": stats.get("faults", {}).get("by_kind", {}),
        "recoveries": stats.get("recoveries", 0),
        # Wire provenance + delta accounting when the ring carried a
        # codec wire — the JSON must say WHICH wire produced the fps.
        **({"wire": queue.wire_stats()} if queue is not None else {}),
    }


def bench_e2e_streaming(
    filt: Filter,
    n_frames: int,
    batch_size: int,
    height: int,
    width: int,
    max_inflight: int = 4,
    queue_size: Optional[int] = None,
    rate: float = 0.0,
    collect_mode: str = "thread",
    transport: str = "python",
    wire: str = "raw",
    mesh=None,
    ingest: str = "streamed",
    ingest_depth: int = 4,
    egress: str = "streamed",
    motion: str = "roll",
    device=None,
) -> dict:
    """Throughput mode: unthrottled source (rate=0), deep queue.

    ``transport="ring"`` routes ingest through the native C++ ring
    (``wire="jpeg"`` additionally JPEG-encodes at capture and decodes into
    the staging slab — it needs the JPEG shim and raises without libjpeg;
    ``wire="delta"`` rides the temporal-delta codec, whose cost scales
    with the stream's dirty ratio — pick ``motion`` accordingly: ``"roll"``
    is the full-motion worst case, ``"block"`` the webcam-like low-motion
    regime). The p50/p99 this returns are congestion numbers (queue
    depth) — use :func:`bench_e2e_latency` for the latency claim.
    """
    from dvf_tpu_torch.io.sources import SyntheticSource

    return _run_pipeline(
        filt,
        SyntheticSource(height=height, width=width, n_frames=n_frames,
                        rate=rate, motion=motion),
        batch_size, height, width, max_inflight,
        queue_size if queue_size is not None else max(64, 4 * batch_size),
        collect_mode=collect_mode, transport=transport, wire=wire, mesh=mesh,
        ingest=ingest, ingest_depth=ingest_depth, egress=egress,
        device=device,
    )


def stream_congested(delivery_fps: float, target_fps: float, dropped: int,
                     frames: int) -> bool:
    """Was a rate-controlled run congested (offered rate > capacity)?

    Two signals, each covering the other's blind spot:

    1. **Ingest drops.** With the latency config's bounded drop-oldest
       queue (one batch) a paced source that outruns service fills the
       queue within one batch period and drops from then on. Exactly one
       drop is forgiven (start-up race while the ingest thread warms) — no
       percentage allowance. Blind spot: a stream SHORTER than the
       pipeline's total buffering never overflows.

    2. **Steady-state delivery rate** (first→last delivery, so start-up
       and drain are excluded): if frames leave slower than 0.85× the
       offered rate, they are accumulating somewhere, drops or not.

    All deliveries in one burst (a vacuously huge first→last rate) means
    ONE dispatched batch: no frame waited behind an earlier batch, so its
    p50 is uncongested transit."""
    if target_fps <= 0:
        return True
    if frames <= 0 or delivery_fps <= 0:
        return True
    if dropped > 1:
        return True
    return delivery_fps < 0.85 * target_fps


def bench_e2e_latency(
    filt: Filter,
    n_frames: int,
    batch_size: int,
    height: int,
    width: int,
    target_fps: float,
    max_inflight: int = 2,
    collect_mode: str = "thread",
    transport: str = "python",
    wire: str = "raw",
    mesh=None,
    ingest: str = "streamed",
    ingest_depth: int = 4,
    egress: str = "streamed",
    motion: str = "roll",
    max_backoffs: int = 2,
    max_retry_stream_s: float = 400.0,
    device=None,
) -> dict:
    """Latency mode: source throttled to ``target_fps`` (pick ~0.8× the
    measured throughput), ingest queue bounded to one batch, shallow
    in-flight depth — p50/p99 then measure capture→deliver transit of an
    un-congested stream. ``transport``/``wire`` select the same ingest
    path as the throughput mode.

    Capacity is a measurement with variance, so 0.8× the measured
    throughput can still exceed the latency leg's true capacity — the
    stream then congests and the percentiles become queue-residency
    numbers. This is detected (:func:`stream_congested`) and the leg backs
    off — halving ``target_fps`` up to ``max_backoffs`` times — until the
    pipeline provably kept up. The returned dict carries the verdict:
    ``congested`` (final run), ``target_fps`` (the rate actually
    measured) and ``backoffs``."""
    from dvf_tpu_torch.io.sources import SyntheticSource

    # The retry floor is a small absolute minimum capped at the ORIGINAL
    # count — a floor that could raise the count multiplies wall time on
    # exactly the slow configs that back off.
    n_floor = min(16, n_frames)
    attempts = 0
    while True:
        r = _run_pipeline(
            filt,
            SyntheticSource(height=height, width=width, n_frames=n_frames,
                            rate=target_fps, motion=motion),
            batch_size, height, width, max_inflight,
            queue_size=batch_size,
            collect_mode=collect_mode, transport=transport, wire=wire,
            mesh=mesh, ingest=ingest, ingest_depth=ingest_depth,
            egress=egress, device=device,
        )
        congested = stream_congested(r["delivery_fps"], target_fps,
                                     r["dropped"], r["frames"])
        retry_target = target_fps / 2.0
        retry_frames = max(n_floor, n_frames // 2)
        # A retry whose offered stream alone would outlast the wall budget
        # is skipped — the honest congested verdict beats burning the
        # harness's whole timeout to confirm it.
        can_retry = (attempts < max_backoffs
                     and retry_target > 0  # target 0 = no rate to verify
                     and retry_frames / retry_target <= max_retry_stream_s)
        if not congested or not can_retry:
            r["target_fps"] = target_fps
            r["congested"] = congested
            r["backoffs"] = attempts
            return r
        attempts += 1
        target_fps = retry_target
        n_frames = retry_frames


# The fleet scaling workload: compute-dominated on purpose (a 3-deep blur
# chain, an order of magnitude over what the front door spends shipping
# a 256² frame), so the measured ratio is replica scaling, not RPC
# overhead.
FLEET_BENCH_FILTER = (
    "chain", {"specs": ["gaussian_blur", "gaussian_blur", "gaussian_blur"]})


def measure_parallel_capacity(n: int = 2, seconds: float = 1.5) -> float:
    """How much CPU-bound throughput ``n`` concurrent processes actually
    get vs one — the machine's REAL parallel capacity, which is what an
    N-replica CPU fleet scales into. On a dedicated host this is ~n; on
    an oversubscribed VM it can be barely 1.x even when ``nproc`` says n.
    The fleet scaling test is GUARDED on this number, and the bench
    records it beside the scaling ratio so a capacity-bound result is
    self-describing."""
    import subprocess
    import sys

    script = ("import time\nn=0\nt0=time.perf_counter()\n"
              f"while time.perf_counter()-t0<{seconds}: n+=1\nprint(n)")

    def run(k: int) -> int:
        procs = [subprocess.Popen([sys.executable, "-c", script],
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(k)]
        return sum(int(p.communicate()[0]) for p in procs)

    one = run(1)
    many = run(n)
    return round(many / max(1, one), 3)


def bench_fleet_scaling(
    filter_spec=FLEET_BENCH_FILTER,
    sessions: int = 2,
    frames_per_session: int = 100,
    height: int = 256,
    width: int = 256,
    batch: int = 4,
    replica_counts=(1, 2),
    mode: str = "process",
    pin_replicas: bool = True,
    deadline_s: float = 180.0,
    device=None,
) -> dict:
    """Fleet scaling round: aggregate multi-session throughput at each
    replica count, same workload, same per-replica resources.

    Per round: open ``sessions`` streams through a FleetFrontend with N
    replicas, warm each replica (one delivered frame per session — the
    engine compile must not sit inside the timed window), then blast
    ``frames_per_session`` frames per session from one thread each and
    time until every frame is delivered. Delivery polling runs
    ``meta_only`` so the front door counts frames instead of copying N
    replicas' pixels through one Python loop. ``scaling[n] =
    fps[n] / fps[min]`` is the headline; per-round
    ``faults``/``recoveries`` ride along replica-attributed.

    ``pin_replicas`` (process mode) pins replica i to CPU core i — the
    CPU stand-in for "each replica owns its device". On one card every
    replica shares ``cuda:0`` (``device``), so there the ratio measures
    how far replicas overlap on one card, not more cards.
    """
    import threading

    import numpy as np

    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend
    from dvf_tpu_torch.serve import ServeConfig

    frame = np.random.default_rng(7).integers(
        0, 255, size=(height, width, 3), dtype=np.uint8)
    rounds = {}
    for n in replica_counts:
        cfg = FleetConfig(
            replicas=n, mode=mode, filter_spec=tuple(filter_spec),
            serve=ServeConfig(
                batch_size=batch,
                max_sessions=max(16, sessions),
                queue_size=frames_per_session + 8,  # throughput round:
                #   no drop-oldest losses, the wall clock is the bound
                out_queue_size=frames_per_session + 8,  # ditto on the
                #   poll side: N fast replicas can outrun one poll loop
                slo_ms=600_000.0,
            ),
            pin_replicas_to_cores=(pin_replicas and mode == "process"),
        )
        fleet = FleetFrontend(config=cfg, device=device)
        with fleet:
            sids = [fleet.open_stream() for _ in range(sessions)]
            # Warm every replica: one frame per session, delivered.
            for sid in sids:
                fleet.submit(sid, frame)
            deadline = time.perf_counter() + deadline_s
            warm = {sid: 0 for sid in sids}
            while (any(c < 1 for c in warm.values())
                   and time.perf_counter() < deadline):
                for sid in sids:
                    warm[sid] += len(fleet.poll(sid, meta_only=True))
                time.sleep(0.002)

            def blast(sid: str) -> None:
                for _ in range(frames_per_session):
                    fleet.submit(sid, frame)

            threads = [threading.Thread(target=blast, args=(sid,))
                       for sid in sids]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            got = {sid: 0 for sid in sids}
            target = frames_per_session
            while (any(c < target for c in got.values())
                   and time.perf_counter() < deadline):
                for sid in sids:
                    got[sid] += len(fleet.poll(sid, meta_only=True))
                # Throttle: a hot poll loop would burn a core of the
                # parent's own and hammer every (pinned) worker with
                # poll RPCs; the out queues hold the whole round.
                time.sleep(0.004)
            wall = time.perf_counter() - t0
            for t in threads:
                t.join()
            stats = fleet.stats()
        delivered = sum(got.values())
        rounds[n] = {
            "replicas": n,
            "fps": round(delivered / wall, 2) if wall > 0 else 0.0,
            "delivered": delivered,
            "expected": sessions * frames_per_session,
            "wall_s": round(wall, 3),
            "sessions": sessions,
            "faults": stats["faults"]["by_kind"],
            "faults_by_replica": stats["faults"].get("by_replica", {}),
            "recoveries": stats["recoveries"],
            "spillovers": stats["spillovers"],
            "per_replica_frames": {
                rid: row.get("engine_frames")
                for rid, row in stats["replicas"].items()},
        }
    base = min(replica_counts)
    base_fps = rounds[base]["fps"] or 1e-9
    return {
        "parallel_capacity": measure_parallel_capacity(max(replica_counts)),
        "mode": mode,
        "filter": [filter_spec[0], filter_spec[1]],
        "frame": [height, width, 3],
        "batch": batch,
        "pinned_replicas": bool(pin_replicas and mode == "process"),
        "rounds": {str(n): r for n, r in rounds.items()},
        "scaling": {str(n): round(rounds[n]["fps"] / base_fps, 3)
                    for n in replica_counts},
    }
