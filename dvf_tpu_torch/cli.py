"""Command-line interface of the PyTorch/CUDA port (port of
``dvf_tpu.cli``).

Reference counterparts: the app CLI (webcam_app.py:187-204: ports,
frame-delay, target-size, use-jpeg) and the worker CLI (inverter.py:48-61:
ports, delay). This CLI unifies them and adds what the reference lacks —
filter selection, synthetic sources, the serving, fleet and broadcast
tiers:

  python -m dvf_tpu_torch filters                 # list registered filters
  python -m dvf_tpu_torch serve  --filter invert  # pipeline: source→GPU→sink
  python -m dvf_tpu_torch worker --filter invert  # ZMQ worker for the ref app
  python -m dvf_tpu_torch doctor                  # environment diagnostics
  python -m dvf_tpu_torch train  --steps 50       # train the style net
  python -m dvf_tpu_torch train-sr --eval         # train the SR net
  python -m dvf_tpu_torch bench  --config invert_1080p [--e2e]

Every device-touching subcommand runs on ``cuda:0`` unless ``--platform
cpu`` (or ``DVF_FORCE_PLATFORM=cpu``) asks for the CPU; without a CUDA
device it exits 2 and never carries on on the CPU by itself. The
``worker`` subcommand keeps the reference's flag names
(--distribute-port, --collect-port, --delay) so launch scripts written for
``python inverter.py`` port over by changing only the module name.
``serve --mesh``, ``bench --mesh`` and ``worker --mesh`` run the engine
over a mesh of the attached cards (the worker's codec assist once per
block).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

PLATFORMS = ("cpu", "cuda")
NO_CUDA = "no CUDA device (pass --platform cpu to run on the CPU)"


# Benchmark configs from BASELINE.json `configs` (+ the headline): the
# reference CLI's keys and shapes.
BENCH_CONFIGS = {
    "invert_1080p": dict(filter=("invert", {}), h=1080, w=1920, batch=64),
    "invert_640x480": dict(filter=("invert", {}), h=480, w=640, batch=64),
    "gauss3_1080p": dict(filter=("gaussian_blur", {"ksize": 3}), h=1080, w=1920, batch=16),
    "gauss9_1080p": dict(filter=("gaussian_blur", {"ksize": 9}), h=1080, w=1920, batch=16),
    "sobel_bilateral_1080p": dict(filter=("sobel_bilateral", {}), h=1080, w=1920, batch=16),
    "flow_720p": dict(filter=("flow_warp", {}), h=720, w=1280, batch=8),
    "style_720p": dict(
        filter=("style_transfer", {"base_channels": 32, "n_residual": 5}),
        h=720, w=1280, batch=8,
    ),
    # 540p -> 1080p subpixel upscale; all conv FLOPs at the LOW resolution.
    "sr2x_540p": dict(filter=("super_resolution", {"scale": 2}), h=540, w=960, batch=8),
}


class PlatformError(RuntimeError):
    """The requested platform cannot run here: ``main`` prints it and
    returns 2."""


def _force_platform() -> str:
    """The device every object of this invocation is built on, from
    DVF_FORCE_PLATFORM (the flag form is ``--platform``): ``cuda:0`` by
    default, ``cpu`` only when asked for. Raises :class:`PlatformError`
    for another name, or for CUDA where there is none: the CLI never
    moves to the CPU on its own."""
    platform = os.environ.get("DVF_FORCE_PLATFORM") or "cuda"
    if platform not in PLATFORMS:
        raise PlatformError(f"unknown platform {platform!r} (want one of "
                            f"{', '.join(PLATFORMS)})")
    if platform == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise PlatformError(NO_CUDA)
    return "cuda:0"


def _mesh_devices() -> list:
    """The devices a ``--mesh`` spans: every attached card, or the CPU
    once on the CPU platform. The command line's one device list (the CPU
    tests put eight CPU entries here, a virtual mesh)."""
    import torch

    if (os.environ.get("DVF_FORCE_PLATFORM") or "cuda") == "cpu":
        return [torch.device("cpu")]
    from dvf_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.local_devices()


def _parse_filter_arg(name: str, config_json: Optional[str]):
    """``--filter`` value → Filter. ``"a|b|c"`` composes registered
    filters left-to-right into one FilterChain (one device program per
    batch — the analog of the reference's chain-of-worker-processes
    idea); ``--filter-config`` JSON applies to a single filter only, since
    a chain gives no way to address one member's kwargs."""
    from dvf_tpu_torch.ops import get_filter

    cfg = json.loads(config_json) if config_json else {}
    if "|" in name:
        if cfg:
            raise SystemExit(
                "error: --filter-config cannot target members of a '|' "
                "chain; use --filter chain --filter-config "
                "'{\"specs\": [[\"name\", {...}], ...]}' for per-member config")
        members = [part.strip() for part in name.split("|") if part.strip()]
        if len(members) < 2:
            raise SystemExit(f"error: bad chain --filter {name!r}")
        # Sugar over the registered generic chain factory (ops.chains) —
        # one composition path, the CLI just translates the syntax.
        return get_filter("chain", specs=members)
    return get_filter(name, **cfg)


class _BadMesh(SystemExit):
    """A bad ``--mesh``: the process exits 2 with the message on stderr
    (``str()`` of the exception is the message)."""

    def __init__(self, message: str):
        super().__init__(2)
        self.message = message
        print(message, file=sys.stderr)

    def __str__(self) -> str:
        return self.message


def _parse_mesh(arg):
    """Parse --mesh into a :class:`~dvf_tpu_torch.parallel.mesh.Mesh` over
    the attached devices (``_mesh_devices``); None (the single-device
    engine) when no mesh is asked for or the mesh spans one device.

    Forms: "data=2,space=2,model=2" (explicit axis sizes; omitted axes
    default to 1) or "auto" / "auto:space" / "auto:model"
    (parallel.mesh.auto_mesh_config policies over all attached devices).
    A bad --mesh, or one larger than the attached devices, exits 2.
    """
    if not arg:
        return None
    from dvf_tpu_torch.parallel.mesh import MeshConfig, auto_mesh_config, make_mesh

    def bad(why):
        raise _BadMesh(
            f"error: bad --mesh {arg!r} ({why}; want e.g. data=2,space=2 "
            f"or auto:space)")

    devices = _mesh_devices()
    have = len(devices)
    if arg == "auto" or arg.startswith("auto:"):
        prefer = arg.split(":", 1)[1] if ":" in arg else "data"
        if prefer not in ("data", "space", "model"):
            bad(f"unknown auto policy {prefer!r}")
        config = auto_mesh_config(max(1, have), prefer=prefer)
    else:
        sizes = {}
        for part in arg.split(","):
            k, _, v = part.partition("=")
            if k not in ("data", "space", "model") or not v.isdigit() or int(v) < 1:
                bad(f"bad axis spec {part!r}")
            if k in sizes:
                bad(f"duplicate axis {k!r}")  # a typo'd layout must not
                # silently become last-one-wins with the other axis at 1
            sizes[k] = int(v)
        config = MeshConfig(**sizes)
    if config.n_devices > have:  # more devices requested than attached
        bad(f"mesh {config} needs {config.n_devices} devices, have {have}")
    if config.n_devices == 1:
        return None
    return make_mesh(config, devices=devices)


def cmd_doctor(args) -> int:
    """Environment diagnostics, safely bounded: backend reachability is
    probed in a KILLED-on-timeout subprocess (a hung driver or CUDA
    initialization must never hang the diagnostic itself). Prints one
    JSON document."""
    import subprocess

    from dvf_tpu_torch.runtime.engine import (
        COMPILE_CACHE_ENV,
        DEFAULT_COMPILE_CACHE_DIR,
    )

    report = {"python": sys.version.split()[0]}

    # Native shims: build (content-hash cached) and report.
    try:
        from dvf_tpu_torch.transport.ring import FrameRing

        ring = FrameRing(capacity_bytes=1 << 16)
        ring.close()
        report["ring_shim"] = "ok"
    except Exception as e:  # noqa: BLE001
        report["ring_shim"] = f"FAILED: {e}"
    try:
        from dvf_tpu_torch.transport.codec import NativeJpegCodec

        NativeJpegCodec().close()
        report["jpeg_shim"] = "ok"
    except Exception as e:  # noqa: BLE001
        # The port has no cv2 fallback: the jpeg/delta wires need the shim.
        report["jpeg_shim"] = f"unavailable ({e})"

    # The kernel-build cache: the nvcc kernels and g++ shims this
    # invocation's subcommands would build into, and what is built there.
    cache_dir = os.environ.get(COMPILE_CACHE_ENV) or DEFAULT_COMPILE_CACHE_DIR
    report["compile_cache"] = {
        "dir": cache_dir,
        "entries": len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0,
    }

    # Backend probe in a bounded subprocess (never hangs this process).
    # Runs _force_platform itself, so the doctor reports exactly the
    # device every other subcommand would get.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = (
        "import json, sys\n"
        f"sys.path.insert(0, {root!r})\n"
        "from dvf_tpu_torch.cli import _force_platform\n"
        "dev = _force_platform()\n"
        "import torch\n"
        "n = 1 if dev == 'cpu' else torch.cuda.device_count()\n"
        "kinds = ['cpu'] if dev == 'cpu' else sorted(\n"
        "    {torch.cuda.get_device_name(i) for i in range(n)})\n"
        "print(json.dumps({'platform': 'cpu' if dev == 'cpu' else 'cuda',"
        " 'n_devices': n, 'kinds': kinds}))\n"
    )
    try:
        r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                           text=True, timeout=args.probe_timeout)
        line = (r.stdout.strip().splitlines() or [""])[-1]
        stderr_tail = (r.stderr.strip().splitlines() or ["<no stderr>"])[-1]
        report["backend"] = json.loads(line) if r.returncode == 0 and line.startswith("{") else {
            "error": f"probe rc={r.returncode}: {stderr_tail}"}
    except subprocess.TimeoutExpired:
        report["backend"] = {
            "error": f"backend init exceeded {args.probe_timeout:.0f}s; CPU "
                     "runs still work via DVF_FORCE_PLATFORM=cpu"}
    n = report["backend"].get("n_devices")
    if n:
        from dvf_tpu_torch.parallel.mesh import auto_mesh_config

        cfgs = {p: auto_mesh_config(n, prefer=p) for p in ("data", "space", "model")}
        report["mesh_suggestions"] = {
            p: f"data={c.data},space={c.space},model={c.model}"
            for p, c in cfgs.items()
        }
    print(json.dumps(report, indent=2))
    return 0 if "error" not in report["backend"] else 1


def cmd_filters(args) -> int:
    from dvf_tpu_torch.ops import list_filters
    from dvf_tpu_torch.ops.registry import _REGISTRY

    for name in list_filters():
        if getattr(args, "verbose", False):
            doc = (_REGISTRY[name].__doc__ or "").strip().splitlines()
            print(f"{name:24s} {doc[0] if doc else ''}")
        else:
            print(name)
    return 0


def _resolve_source(args, allow_shm: bool = True):
    """Build the frame source named by ``args.source`` and return
    ``(source, frame_shape)`` — ONE place owns the per-source geometry
    (synthetic: --height/--width; webcam/file: --target-size square), so
    the camera producer, the serve consumer, and the ring transport can
    never disagree about it within an invocation."""
    from dvf_tpu_torch.io.sources import (
        ShmRingSource,
        SyntheticSource,
        VideoFileSource,
        WebcamSource,
    )

    if args.source == "synthetic":
        return (
            SyntheticSource(height=args.height, width=args.width,
                            n_frames=args.frames, rate=args.rate),
            (args.height, args.width, 3),
        )
    if args.source.startswith("shm:"):
        if not allow_shm:
            raise SystemExit("error: the camera producer cannot read from "
                             "an shm ring (that's serve's side)")
        shape = (args.height, args.width, 3)
        return ShmRingSource(args.source[4:], frame_shape=shape), shape
    if args.source == "webcam":
        return (WebcamSource(target_size=args.target_size),
                (args.target_size, args.target_size, 3))
    # Ring consumers need fixed geometry; file sources get it from
    # --target-size whenever any fixed-geometry consumer is in play.
    force_crop = getattr(args, "transport", "python") == "ring" or not allow_shm
    return (
        VideoFileSource(args.source, rate=args.rate,
                        target_size=args.target_size if force_crop else None),
        (args.target_size, args.target_size, 3),
    )


def _start_exporter(args, registry, health_fn=None, ring=None,
                    explain_fn=None, ledger_fn=None, audit_fn=None):
    """--metrics-port: start the pull-based scrape endpoint (obs.export)
    over this invocation's registry. Returns the started exporter (None
    when the flag is absent). Port 0 binds an ephemeral port; the bound
    port is announced on stderr either way."""
    port = getattr(args, "metrics_port", None)
    if port is None:
        return None
    from dvf_tpu_torch.obs.export import MetricsExporter

    ex = MetricsExporter(registry, port=port, health_fn=health_fn,
                         ring=ring, explain_fn=explain_fn,
                         ledger_fn=ledger_fn, audit_fn=audit_fn).start()
    endpoints = "/metrics /healthz /timeseries" + (
        " /explain" if explain_fn is not None else "") + (
        " /ledger" if ledger_fn is not None else "") + (
        " /audit" if audit_fn is not None else "")
    print(f"[metrics] {endpoints} on {ex.url}",
          file=sys.stderr, flush=True)
    return ex


def _parse_chaos(args):
    """``--chaos`` spec → resilience.chaos.FaultPlan (None when unset)."""
    if not getattr(args, "chaos", None):
        return None
    from dvf_tpu_torch.resilience import FaultPlan

    try:
        return FaultPlan.parse(args.chaos, seed=args.chaos_seed)
    except ValueError as e:
        raise SystemExit(f"error: bad --chaos spec: {e}")


def _arm_compile_cache(args, device: str, tag: str = "serve"):
    """``--compile-cache-dir``: point the kernel-build cache (the nvcc
    kernels and the g++ shims; the port's counterpart of a persistent
    compilation cache) at a directory, size-bounded, so a restart or a
    respawned replica loads its libraries instead of building them. On a
    card every kernel library is built there up front, all nvcc runs in
    parallel, and the seconds each took are printed (0.0 = loaded from
    the cache). Returns the directory armed, or None when the flag was
    absent."""
    val = getattr(args, "compile_cache_dir", None)
    if val is None:
        return None
    from dvf_tpu_torch.runtime.engine import enable_compilation_cache

    cache_dir = enable_compilation_cache(val or None)
    print(f"[{tag}] kernel build cache: {cache_dir}", file=sys.stderr)
    if device != "cpu":
        from dvf_tpu_torch.ops import _build

        secs = _build.build_all()
        print(f"[{tag}] kernel builds (s): "
              f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}",
              file=sys.stderr, flush=True)
    return cache_dir


def _load_manifest(path):
    """Read a ``--precompile`` manifest (JSON list of signature
    entries); None when no path was given."""
    if not path:
        return None
    with open(path) as f:
        return json.load(f)


def _cmd_serve_multi(args, filt, engine) -> int:
    """Local multi-stream demo: N synthetic client streams at different
    frame rates multiplexed through ONE shared engine by the serving
    frontend (serve.ServeFrontend) — each stream keeps its own frame
    index space, drop-oldest ingress bound, and latency SLO; device
    batches mix sessions every tick. Prints one JSON line: per-session
    delivery/shed/latency stats plus the fleet aggregate p50/p99."""
    import threading

    from dvf_tpu_torch.io.sources import SyntheticSource
    from dvf_tpu_torch.serve import ServeConfig, ServeFrontend

    if args.source != "synthetic":
        print("error: --sessions > 1 runs the local multi-stream demo, "
              "which is synthetic-source only (use the in-process "
              "serve.ServeFrontend API for real streams)", file=sys.stderr)
        return 2
    if args.display:
        print("error: --display is single-stream only", file=sys.stderr)
        return 2

    n = args.sessions
    if args.max_sessions and args.max_sessions < n:
        print(f"error: --max-sessions {args.max_sessions} < --sessions {n}: "
              f"the demo opens every stream up front, so the cap must admit "
              f"them all", file=sys.stderr)
        return 2
    morph_after = None
    if getattr(args, "morph_after", None):
        # Validate BEFORE opening streams: a typo'd chain must fail the
        # command, not surface mid-demo from a watcher thread.
        from dvf_tpu_torch.runtime.signature import canonical_op_chain

        k_str, sep, chain_spec = args.morph_after.partition(":")
        try:
            if not sep:
                raise ValueError("want K:CHAIN")
            morph_after = (int(k_str), canonical_op_chain(chain_spec))
        except ValueError as e:
            print(f"error: bad --morph-after {args.morph_after!r}: {e}",
                  file=sys.stderr)
            return 2
    config = ServeConfig(
        batch_size=args.batch,
        max_sessions=args.max_sessions if args.max_sessions else max(16, n),
        max_buckets=args.max_buckets,
        pool_capacity=args.pool_capacity,
        queue_size=args.queue_size,
        slo_ms=args.slo_ms,
        frame_delay=args.frame_delay,
        resilient=not args.fail_fast,
        ingest=args.ingest,
        ingest_depth=args.ingest_depth,
        egress=args.egress,
        fault_budget=args.fault_budget,
        fault_window_s=args.fault_window,
        stall_timeout_s=(args.stall_timeout if args.stall_timeout is not None
                         else 30.0),
        chaos=_parse_chaos(args),
        trace=args.trace,
        flight_dir=args.flight_dir,
        # The sliding signal window costs a per-second percentile merge;
        # pay it only when something reads it (scrape endpoint here,
        # the burn trigger via flight_dir, or the control plane, which
        # arms its own cadence inside the frontend).
        telemetry_sample_s=(1.0 if args.metrics_port is not None else 0.0),
        control=args.control,
        default_tier=args.tier if args.tier is not None else 1,
        lineage=args.lineage,
        profile_dir=args.profile_dir,
        audit=args.audit,
        audit_sample_every=args.audit_sample,
        autoplan=args.autoplan,
        plan_cache_dir=args.plan_cache_dir,
    )
    if args.audit_wire:
        print("[serve] note: --audit-wire has no framed transport in the "
              "multi-session demo (streams are in-process); the "
              "wire-integrity envelope rides the worker tier, "
              "single-stream --transport ring, and the library "
              "ZmqStreamBridge(audit_wire=True)", file=sys.stderr)
    frontend = ServeFrontend(filt, config, engine=engine,
                             device=engine.device)
    manifest = _load_manifest(args.precompile)
    if manifest is not None:
        warmed = frontend.precompile(manifest)
        print(f"[serve] precompiled {len(warmed)} signature(s): "
              f"{', '.join(warmed)}", file=sys.stderr)
    exporter = _start_exporter(args, frontend.registry,
                               health_fn=frontend.health,
                               ring=frontend.telemetry,
                               explain_fn=(frontend.explain
                                           if args.lineage else None),
                               ledger_fn=(frontend.ledger.document
                                          if frontend.ledger is not None
                                          else None),
                               audit_fn=(frontend.audit.document
                                         if frontend.audit is not None
                                         else None))

    # Spread the streams across ~0.4×..1.6× the base rate: genuinely
    # different per-tenant cadences, so batches interleave sessions
    # rather than ticking in lockstep.
    base = args.rate if args.rate > 0 else 30.0
    rates = [base * 2.0 * (i + 1) / (n + 1) for i in range(n)]
    delivered: dict = {}

    def drive(sid: str, rate: float, seed: int) -> None:
        src = SyntheticSource(height=args.height, width=args.width,
                              n_frames=args.frames, rate=rate, seed=seed)
        for frame, ts in src:
            if frame is None:
                break
            # Cycle frames are immutable shared views — safe to submit
            # without copying (StreamSession.submit references them).
            frontend.submit(sid, frame, ts=ts)

    gate = None
    try:
        with frontend:
            if args.autoplan:
                # Plan BEFORE admitting tenants: the search runs short
                # paced bursts through the frontend's own ingest path,
                # and the winning envelope must be in place before the
                # control plane sees real traffic.
                plan = frontend.autoplan(
                    (args.height, args.width, 3), "uint8",
                    log=(None if args.quiet else
                         (lambda m: print(f"[serve] {m}",
                                          file=sys.stderr))))
                print(f"[serve] plan ({plan['source']}): "
                      f"batch={plan['batch_size']} "
                      f"tick={plan['tick_s']*1e3:g}ms "
                      f"depth={plan['ingest_depth']} "
                      f"searched={plan['searched']}/{plan['grid']}",
                      file=sys.stderr)
            sids = [frontend.open_stream(slo_ms=args.slo_ms, tier=args.tier)
                    for _ in range(n)]
            if args.publish:
                # First stream doubles as the broadcast publisher: its
                # deliveries tee into the channel's per-tier encoders
                # (its own poll loop below is untouched — the tap rides
                # the delivery path).
                frontend.publish_stream(
                    sids[0], args.publish,
                    tiers=[t.strip()
                           for t in args.publish_tiers.split(",")
                           if t.strip()])
                if args.broadcast_bind:
                    from dvf_tpu_torch.broadcast.plane import ZmqBroadcastGate

                    gate = ZmqBroadcastGate(frontend.broadcast,
                                            args.broadcast_bind)
                    print(f"[serve] broadcast channel {args.publish!r} "
                          f"on {args.broadcast_bind}", file=sys.stderr)
            drivers = [
                threading.Thread(target=drive, args=(sid, rate, i), daemon=True)
                for i, (sid, rate) in enumerate(zip(sids, rates))
            ]
            for t in drivers:
                t.start()
            morph_result: dict = {}
            if morph_after is not None:
                morph_k, morph_chain = morph_after

                def morph_watch() -> None:
                    deadline = time.time() + 120.0
                    while time.time() < deadline:
                        if delivered.get(sids[0], 0) >= morph_k:
                            try:
                                morph_result["applied"] = \
                                    frontend.morph_stream(
                                        sids[0], morph_chain,
                                        reason="cli --morph-after")
                            except Exception as e:  # noqa: BLE001
                                morph_result["error"] = str(e)
                            return
                        time.sleep(0.01)
                    morph_result["applied"] = False

                threading.Thread(target=morph_watch, daemon=True).start()
            while any(t.is_alive() for t in drivers):
                for sid in sids:
                    delivered[sid] = delivered.get(sid, 0) + len(frontend.poll(sid))
                time.sleep(0.01)
            for sid in sids:
                frontend.close(sid, drain=True)  # graceful: serve the tail
            deadline = time.time() + 30.0
            while time.time() < deadline:
                for sid in sids:
                    delivered[sid] = delivered.get(sid, 0) + len(frontend.poll(sid))
                if frontend.open_count() == 0:  # not stats(): the full
                    break                      # percentile merge is per-report
                time.sleep(0.01)
            for sid in sids:
                delivered[sid] = delivered.get(sid, 0) + len(frontend.poll(sid))
            stats = frontend.stats()
    finally:
        if gate is not None:
            gate.close()
        if exporter is not None:
            exporter.stop()

    out = {
        "sessions": {
            sid: {k: s[k] for k in ("submitted", "delivered", "shed",
                                    "slo_miss", "fps", "p50_ms", "p99_ms")}
            for sid, s in stats["sessions"].items()
        },
        "rates": {sid: round(r, 2) for sid, r in zip(sids, rates)},
        "polled": delivered,
        "aggregate": stats["aggregate"],
        "shed_total": stats["shed_total"],
        "admission_rejections": stats["admission_rejections"],
        "engine_batches": stats["engine_batches"],
        "errors": stats["errors"],
        # Per-kind contained-fault counters + supervised engine rebuilds
        # ({} / 0 on a clean run — see docs/GUIDE.md "Faults, chaos…").
        "faults": stats["faults"]["by_kind"],
        "recoveries": stats["recoveries"],
        # Live reconfiguration: hot swaps committed / aborted, and
        # mid-stream filter-chain morphs.
        "swaps": stats["swaps"],
        "swap_aborts": stats["swap_aborts"],
        "morphs": stats["morphs"],
    }
    if morph_after is not None:
        out["morph"] = {"chain": morph_after[1],
                        "after": morph_after[0], **morph_result}
    if args.publish and "broadcast" in stats:
        bc = stats["broadcast"]["channels"].get(args.publish, {})
        out["broadcast"] = {
            "channel": args.publish,
            "offered": bc.get("offered_total", 0),
            "tiers": {label: {"encodes": t.get("encodes_total", 0),
                              "delivered": t.get("delivered_total", 0),
                              "subscribers": t.get("subscriber_count", 0)}
                      for label, t in bc.get("tiers", {}).items()},
            **({"gate": gate.stats()} if gate is not None else {}),
        }
    print(json.dumps(out, default=float))
    return 0


def cmd_subscribe(args) -> int:
    """Remote watcher: DEALER-connect to a broadcast gate, hello into a
    channel/tier, decode what arrives, print one JSON summary line."""
    try:
        import zmq
    except ImportError:
        print("error: subscribe needs pyzmq (the gate side is "
              "`serve --publish --broadcast-bind`)", file=sys.stderr)
        return 2
    from dvf_tpu_torch.obs.audit import is_stamped, verify_wire
    from dvf_tpu_torch.transport.codec import make_wire_codec

    ctx = zmq.Context.instance()
    sock = ctx.socket(zmq.DEALER)
    sock.linger = 0
    sock.connect(args.endpoint)
    try:
        sock.send(json.dumps({"op": "hello", "channel": args.channel,
                              "tier": args.tier,
                              "queue": args.queue}).encode())
        if not sock.poll(int(args.timeout * 1000)):
            print(f"error: no hello reply from {args.endpoint} within "
                  f"{args.timeout:g}s", file=sys.stderr)
            return 1
        meta = json.loads(sock.recv_multipart()[0])
        if not meta.get("ok"):
            print(f"error: gate refused: {meta.get('error')}",
                  file=sys.stderr)
            return 1
        wire, quality = meta["wire"], meta["quality"]
        codec = None
        if wire != "raw":
            # The SAME codec shape the tier's encoder runs — the meta
            # carries every parameter the closed loop needs; delta
            # joins on the gate's forced keyframe, so decode starts in
            # sync. on_gap='composite': a dropped frame costs staleness
            # in the changed tiles, never a dead stream.
            kw = {}
            if wire == "delta":
                kw = {"tile": meta["delta_tile"],
                      "keyframe_interval": meta["keyframe_interval"],
                      "on_gap": "composite"}
            codec = make_wire_codec(wire, quality=quality, threads=2, **kw)
        t0 = time.time()
        got = frames_bytes = keyframes = integrity_errors = 0
        deadline = t0 + args.timeout
        # Liveness (continuity plane): heartbeat the gate on quiet links
        # — the pong (or any frame) proves the gate is alive, and a
        # gate armed with --liveness-timeout needs our beats to keep us
        # subscribed. A gate that stops answering for idle_timeout is
        # DEAD, and that is exit 3, not a zero-frame success hang.
        idle_timeout = max(0.1, args.idle_timeout)
        hb_interval = max(0.25, min(2.0, idle_timeout / 4.0))
        last_rx = last_hb = time.time()
        while got < args.frames and time.time() < deadline:
            now = time.time()
            if now - last_hb >= hb_interval:
                last_hb = now
                sock.send(json.dumps({"op": "hb"}).encode())
            if not sock.poll(200):
                if time.time() - last_rx > idle_timeout:
                    print(f"error: gate {args.endpoint} silent for "
                          f"{idle_timeout:g}s (no frames, no heartbeat "
                          f"reply): partitioned or dead",
                          file=sys.stderr)
                    return 3
                continue
            parts = sock.recv_multipart()
            last_rx = time.time()
            if len(parts) < 2:
                continue   # hb pong / control noise: liveness, not data
            head, payload = json.loads(parts[0]), parts[1]
            frames_bytes += len(payload)
            if meta.get("audit") and is_stamped(payload):
                try:
                    payload = verify_wire(payload, hop="subscribe")
                except Exception:  # noqa: BLE001 — counted, stream lives
                    integrity_errors += 1
                    continue
            if codec is not None:
                codec.decode(payload)
            keyframes += bool(head.get("key"))
            got += 1
        sock.send(json.dumps({"op": "bye"}).encode())
        dt = max(time.time() - t0, 1e-9)
        print(json.dumps({
            "channel": args.channel, "tier": meta["tier"],
            "wire": wire, "frames": got, "keyframes": keyframes,
            "bytes": frames_bytes, "fps": round(got / dt, 2),
            "integrity_errors": integrity_errors,
            "complete": got >= args.frames}))
        return 0 if got > 0 else 1
    finally:
        sock.close(0)


def cmd_serve(args) -> int:
    device = _force_platform()
    _arm_compile_cache(args, device)

    import signal

    from dvf_tpu_torch.io.display import LiveTap, SideBySideSink
    from dvf_tpu_torch.io.sinks import NullSink
    from dvf_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig

    if args.style_checkpoint and args.sr_checkpoint:
        print("error: --style-checkpoint and --sr-checkpoint are mutually "
              "exclusive (each loads a different filter family)", file=sys.stderr)
        return 2
    if args.style_checkpoint or args.sr_checkpoint:
        # Trained weights: rebuild the exact net from the checkpoint's
        # sidecar config and load params only (the port's params.npz
        # checkpoints; train.checkpoint).
        from dvf_tpu_torch.train.checkpoint import load_sr_filter, load_style_filter

        try:
            filt = (load_style_filter(args.style_checkpoint)
                    if args.style_checkpoint
                    else load_sr_filter(args.sr_checkpoint))
        except (FileNotFoundError, ValueError) as e:
            # A typo'd path fails cleanly; the loader maps corrupt or
            # incomplete sidecars to ValueError.
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        filt = _parse_filter_arg(args.filter, args.filter_config)
    # Parse --mesh BEFORE acquiring the source: a typo'd mesh must not
    # first open a camera / allocate the native shm ring.
    from dvf_tpu_torch.runtime.engine import Engine

    mesh = _parse_mesh(args.mesh)
    engine = Engine(filt, device=device, mesh=mesh)
    if args.sessions > 1:
        # Multi-tenant path: N streams through one shared engine via the
        # serving frontend (admission control, cross-session batching,
        # per-stream SLOs) instead of the one-stream Pipeline.
        return _cmd_serve_multi(args, filt, engine)
    source, frame_shape = _resolve_source(args)

    # Live serving is resilient (one bad frame never kills the stream,
    # worker.py:71-76 semantics) with the reference's 5 s telemetry prints
    # (webcam_app.py:88-95,152-163); --fail-fast restores strict mode.
    config = PipelineConfig(
        batch_size=args.batch,
        frame_delay=args.frame_delay,
        queue_size=args.queue_size,
        trace=args.trace,
        resilient=not args.fail_fast,
        telemetry_interval_s=0.0 if args.quiet else 5.0,
        device_trace_dir=args.device_trace,
        collect_mode=args.collect_mode,
        ingest=args.ingest,
        ingest_depth=args.ingest_depth,
        egress=args.egress,
        fault_budget=args.fault_budget,
        fault_window_s=args.fault_window,
        stall_timeout_s=args.stall_timeout or 0.0,
        chaos=_parse_chaos(args),
        # The single-stream tier honors --flight-dir with the same
        # spelling as serve --sessions N / fleet / worker: watchdog
        # trips and hard pipeline failures dump post-mortems there.
        flight_dir=args.flight_dir,
    )
    if args.publish:
        print("[serve] note: --publish is a multi-session feature (the "
              "broadcast plane taps the serving frontend's delivery "
              "path); use --sessions N, the fleet tier, or the "
              "in-process ServeFrontend.publish_stream API",
              file=sys.stderr)
    if args.lineage or args.profile_dir:
        print("[serve] note: --lineage/--profile-dir are multi-session "
              "features (per-frame attribution and per-signature stage "
              "profiles need the serving frontend); single-stream runs "
              "report stage costs via stats() — use --sessions N or "
              "the fleet tier", file=sys.stderr)
    if args.autoplan or args.plan_cache_dir:
        print("[serve] note: --autoplan/--plan-cache-dir are multi-"
              "session features (the plan search drives the serving "
              "frontend's actuators); use --sessions N or the fleet "
              "tier", file=sys.stderr)
    if args.audit:
        # Parser-accepted-but-ignored is a failure mode: say it loudly
        # instead of silently serving unaudited while the operator
        # believes the detector is armed.
        print("[serve] note: --audit (shadow replay + swap guard) is a "
              "multi-session feature — it arms the serving frontend's "
              "audit plane; use --sessions N or the fleet tier. "
              "Single-stream runs can still arm the wire-integrity "
              "envelope with --transport ring --audit-wire",
              file=sys.stderr)
    if args.audit_wire and args.transport != "ring":
        print("[serve] note: --audit-wire needs a framed transport — "
              "single-stream serve stamps/verifies on --transport ring "
              "(the worker tier envelopes its ZMQ wire; the library "
              "ZmqStreamBridge takes audit_wire=)", file=sys.stderr)

    queue = None
    if args.transport == "ring":
        from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

        # Same geometry the source was resolved with — _resolve_source is
        # the single owner of per-source frame shape.
        queue = RingFrameQueue(
            frame_shape=frame_shape,
            capacity_frames=args.queue_size,
            wire=args.wire,
            codec_threads=args.codec_threads,
            delta_tile=args.delta_tile,
            delta_keyframe_interval=args.delta_keyframe_interval,
            # Wire-integrity envelope on the ring hop (obs.audit):
            # stamped at put, verified at decode into staging —
            # mismatches classify as `integrity` faults in the
            # pipeline's containment.
            # Provenance mapping: 'full' stamps the codec-level string;
            # 'probe' leaves the codec unassisted (bitmaps only).
            codec_assist={"full": "full-transform",
                          "probe": "none"}.get(args.codec_assist, "none"),
            audit_wire=args.audit_wire,
            chaos=config.chaos,
        )
        if args.wire in ("jpeg", "delta"):
            # Host-codec budget check (SURVEY §7 hard part 3): the JPEG
            # wire costs one encode + one decode PER FRAME on this host's
            # cores, and at high rates that — not the device — is the
            # bottleneck. Measure this host's per-core codec speed (~0.2 s)
            # and warn loudly when the requested rate can't be sustained;
            # the raw/shm wire has no codec cost at all.
            from dvf_tpu_torch.transport.codec import jpeg_wire_budget

            # Budget against the pool the pipeline ACTUALLY runs: the
            # ring queue's codec pool (default 4 threads), clamped to
            # physical cores inside jpeg_wire_budget — which measures the
            # single-thread codec CYCLE explicitly (mode="cycle"): the
            # model multiplies one cycle by usable workers, so pool
            # throughput would double-count the pool. The delta wire's
            # ceiling depends on the stream's dirty ratio, which is
            # unknowable before frames flow — budget it at a webcam-like
            # 10% so the warning still catches hopeless rates.
            budget = jpeg_wire_budget(
                frame_shape[0], frame_shape[1],
                threads=queue.codec_pool_threads,
                expected_dirty_ratio=(0.1 if args.wire == "delta"
                                      else None),
                keyframe_interval=args.delta_keyframe_interval)
            cap_key = ("delta_capacity_fps" if args.wire == "delta"
                       else "capacity_fps")
            if args.rate and args.rate > budget[cap_key]:
                print(
                    f"[serve] WARNING: --wire {args.wire} cannot sustain "
                    f"--rate {args.rate:g}: measured codec capacity on "
                    f"this host is ~{budget[cap_key]} fps at "
                    f"{frame_shape[0]}x{frame_shape[1]} "
                    f"({budget['codec_workers']} usable codec workers; "
                    f"{budget['per_core_encode_fps']} enc / "
                    f"{budget['per_core_decode_fps']} dec fps/core). "
                    f"Frames beyond that rate will be dropped at ingest — "
                    f"use --wire raw (zero codec cost) for this rate.",
                    file=sys.stderr, flush=True)
            elif not args.quiet:
                print(
                    f"[serve] {args.wire} wire budget: ~{budget[cap_key]} "
                    f"fps ceiling at {frame_shape[0]}x{frame_shape[1]} on "
                    f"this host ({budget['cores']} cores)",
                    file=sys.stderr, flush=True)

    if args.display:
        tap = LiveTap(source)
        if args.display_backend == "gl":
            # The reference's literal draw path — GL texture blits
            # (webcam_app.py:118-150) — against a surfaceless EGL
            # context; offscreen by design (last_pane carries the canvas).
            from dvf_tpu_torch.io.gl_display import (
                GLRenderer,
                GLSideBySideSink,
                GLUnavailable,
            )

            # Fail fast: without this probe a missing GL stack would
            # first surface inside sink.emit, where resilient mode
            # contains it once per frame and serve exits 0 having
            # displayed nothing.
            try:
                GLRenderer(8, 8).close()
            except GLUnavailable as e:
                print(f"error: --display-backend gl unavailable: {e}",
                      file=sys.stderr)
                return 2
            sink = GLSideBySideSink(
                tap, telemetry_interval_s=config.telemetry_interval_s)
        else:
            sink = SideBySideSink(
                tap,
                headless=args.headless,
                telemetry_interval_s=config.telemetry_interval_s,
            )
        pipe = Pipeline(tap, filt, sink, config, engine=engine,
                        device=device, queue=queue)
        sink.stop_cb = pipe.stop        # ESC → graceful stop (cv2 backend)
        sink.stats_fn = pipe.stats
    else:
        sink = NullSink()
        pipe = Pipeline(source, filt, sink, config, engine=engine,
                        device=device, queue=queue)

    # --metrics-port: scrape endpoint over the pipeline's registry (the
    # RateLogger gauges + the signals() provider), with a 1 Hz telemetry
    # ring behind /timeseries.
    ring = None
    exporter = None
    if args.metrics_port is not None:
        from dvf_tpu_torch.obs.registry import TimeSeriesRing

        ring = TimeSeriesRing(pipe.signals, interval_s=1.0,
                              name="dvf-pipeline-telemetry").start()
        exporter = _start_exporter(args, pipe.registry,
                                   health_fn=pipe.health, ring=ring)

    # SIGINT/SIGTERM → graceful stop; repeat → hard abort (the reference
    # installs the same pair, webcam_app.py:46-48 / inverter.py:16-17).
    def _graceful(signum, frame):
        if pipe._stop_requested.is_set():
            pipe.abort()
        else:
            print(f"\n[serve] signal {signum}: stopping…", file=sys.stderr, flush=True)
            pipe.stop()

    old = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            old[sig] = signal.signal(sig, _graceful)
        except ValueError:
            pass  # not the main thread (embedded use)
    try:
        stats = pipe.run()
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        if exporter is not None:
            exporter.stop()
        if ring is not None:
            ring.stop()
    print(json.dumps({k: v for k, v in stats.items() if not isinstance(v, dict)}, default=float))
    return 0


def _fleet_chaos_split(args):
    """Split one ``--chaos`` spec into the fleet-level plan (``replica``
    site rules — fired by the front door's health monitor) and the
    serve-level spec string forwarded to every replica (which parses its
    own plan, so per-replica event streams stay deterministic)."""
    if not getattr(args, "chaos", None):
        return None, None
    fleet_rules, serve_rules = [], []
    for part in args.chaos.split(","):
        part = part.strip()
        if not part:
            continue
        (fleet_rules if part.split(":", 1)[0].strip() == "replica"
         else serve_rules).append(part)
    fleet_plan = None
    if fleet_rules:
        from dvf_tpu_torch.resilience import FaultPlan

        try:
            fleet_plan = FaultPlan.parse(",".join(fleet_rules),
                                         seed=args.chaos_seed)
        except ValueError as e:
            raise SystemExit(f"error: bad --chaos spec: {e}")
    return fleet_plan, (",".join(serve_rules) or None)


def cmd_fleet(args) -> int:
    """Multi-replica serving demo: N synthetic client streams through a
    FleetFrontend — one front door, ``--replicas`` engine replicas with
    session affinity, spillover admission, and supervised replica
    replacement. ``--scaling`` runs the fleet scaling round instead
    (aggregate throughput at 1..N replicas, ``benchmarks.
    bench_fleet_scaling``); on one card every replica shares it."""
    device = _force_platform()
    if args.scaling:
        from dvf_tpu_torch.benchmarks import bench_fleet_scaling

        counts = tuple(sorted({1, args.replicas}))
        out = bench_fleet_scaling(
            sessions=args.sessions, frames_per_session=args.frames,
            height=args.height, width=args.width, batch=args.batch,
            replica_counts=counts, mode=args.mode, device=device)
        print(json.dumps(out, default=float))
        return 0

    import threading

    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend
    from dvf_tpu_torch.io.sources import SyntheticSource
    from dvf_tpu_torch.runtime.engine import COMPILE_CACHE_ENV
    from dvf_tpu_torch.serve import AdmissionError, ServeConfig

    fleet_chaos, serve_chaos_spec = _fleet_chaos_split(args)
    name = args.filter
    if "|" in name:
        members = [p.strip() for p in name.split("|") if p.strip()]
        filter_spec = ("chain", {"specs": members})
    else:
        filter_spec = (name,
                       json.loads(args.filter_config)
                       if args.filter_config else {})
    cache_dir = _arm_compile_cache(args, device, "fleet")
    serve_cfg = ServeConfig(
        batch_size=args.batch,
        max_sessions=args.max_sessions if args.max_sessions else max(16, args.sessions),
        max_buckets=args.max_buckets,
        pool_capacity=args.pool_capacity,
        queue_size=args.queue_size,
        slo_ms=args.slo_ms,
        ingest=args.ingest,
        ingest_depth=args.ingest_depth,
        egress=args.egress,
        fault_budget=args.fault_budget,
        fault_window_s=args.fault_window,
        stall_timeout_s=(args.stall_timeout
                         if args.stall_timeout is not None else 30.0),
        trace=args.trace,
        control=args.control,
        lineage=args.lineage,
        profile_dir=args.profile_dir,
        audit=args.audit,
        audit_sample_every=args.audit_sample,
        plan_cache_dir=args.plan_cache_dir,
    )
    if args.audit_wire:
        print("[fleet] note: --audit-wire has no framed transport at the "
              "fleet front door (replica RPCs are length-prefixed "
              "pickle, demo streams are in-process); arm it on worker "
              "tiers / bridges at the edges", file=sys.stderr)
    if getattr(args, "codec_assist", "none") != "none":
        print(f"[fleet] note: --codec-assist {args.codec_assist} has no "
              f"codec at the fleet front door (replica RPCs carry "
              f"pixels); the assist tiers live on the worker "
              f"(--codec-assist full) and serve ring "
              f"(provenance stamp)", file=sys.stderr)
    autoscale = None
    if args.autoscale:
        try:
            lo, _, hi = args.autoscale.partition(":")
            autoscale = (int(lo), int(hi))
        except ValueError:
            raise SystemExit(
                f"error: bad --autoscale {args.autoscale!r} "
                f"(want MIN:MAX, e.g. 1:4)")
    if args.autoplan and not args.precompile:
        print("[fleet] note: --autoplan plans for the first --precompile "
              "manifest signature; without a manifest the front door "
              "keeps hand-set defaults", file=sys.stderr)
    config = FleetConfig(
        replicas=args.replicas,
        mode=args.mode,
        serve=serve_cfg,
        filter_spec=filter_spec,
        autoscale=autoscale,
        autoplan=args.autoplan,
        standby_warm=args.standby_warm,
        multihost_hosts=args.multihost_hosts,
        health_poll_s=args.health_poll,
        chaos=fleet_chaos,
        chaos_spec=serve_chaos_spec,
        chaos_seed=args.chaos_seed,
        devices_per_replica=args.devices_per_replica,
        flight_dir=args.flight_dir,
        audit_interval_s=args.audit_interval,
        audit_quarantine=args.audit_quarantine,
        state_path=args.state_path,
        resume_state=args.resume_state,
        snapshot_interval_s=args.snapshot_interval,
        telemetry_sample_s=(1.0 if args.metrics_port is not None else 0.0),
        precompile=_load_manifest(args.precompile),
        # Process-mode replicas share the kernel-build cache through the
        # env — a respawned replica loads its kernels instead of building
        # them (the fleet half of the warm start).
        replica_env=({COMPILE_CACHE_ENV: os.path.abspath(cache_dir)}
                     if cache_dir else {}),
    )

    n = args.sessions
    base = args.rate if args.rate > 0 else 30.0
    rates = [base * 2.0 * (i + 1) / (n + 1) for i in range(n)]
    polled: dict = {}

    fleet = FleetFrontend(config=config, device=device)
    def fleet_health():
        s = fleet.signals()
        return dict(s, ok=s["healthy_replicas"] > 0)

    exporter = _start_exporter(args, fleet.registry,
                               health_fn=fleet_health,
                               ring=fleet.telemetry,
                               explain_fn=(fleet.explain
                                           if args.lineage else None),
                               ledger_fn=(fleet.ledger.document
                                          if fleet.ledger is not None
                                          else None),
                               audit_fn=fleet.audit_document)

    def drive(sid: str, rate: float, seed: int) -> None:
        src = SyntheticSource(height=args.height, width=args.width,
                              n_frames=args.frames, rate=rate, seed=seed)
        for frame, ts in src:
            if frame is None:
                break
            try:
                fleet.submit(sid, frame, ts=ts)
            except Exception:  # noqa: BLE001 — a session orphaned by
                return         # replica loss just ends its stream

    try:
        with fleet:
            sids = []
            open_deadline = time.time() + 120.0
            for _ in range(n):
                while True:
                    try:
                        sids.append(fleet.open_stream(
                            slo_ms=args.slo_ms,
                            frame_shape=(args.height, args.width, 3),
                            tier=args.tier))
                        break
                    except AdmissionError as e:
                        # Under --autoscale a refusal is the controller's
                        # scale-out SIGNAL (graceful shed by contract):
                        # retry with backoff and land on the replica the
                        # refusal just caused to spawn.
                        if not args.autoscale \
                                or time.time() > open_deadline:
                            print(f"error: admission refused: {e}",
                                  file=sys.stderr)
                            return 2
                        time.sleep(0.2)
            drivers = [
                threading.Thread(target=drive, args=(sid, rate, i), daemon=True)
                for i, (sid, rate) in enumerate(zip(sids, rates))
            ]
            for t in drivers:
                t.start()
            rollout_result: dict = {}
            if args.rollout_after is not None:

                def rollout_watch() -> None:
                    time.sleep(max(0.0, args.rollout_after))
                    try:
                        rollout_result.update(fleet.rolling_rollout(
                            reason="cli --rollout-after"))
                    except Exception as e:  # noqa: BLE001
                        rollout_result["error"] = str(e)

                threading.Thread(target=rollout_watch, daemon=True).start()
            while any(t.is_alive() for t in drivers):
                for sid in sids:
                    polled[sid] = polled.get(sid, 0) + len(
                        fleet.poll(sid, meta_only=True))
                time.sleep(0.01)
            for sid in sids:
                fleet.close(sid, drain=True)  # graceful: the tail serves
            # Poll the tails until the fleet goes quiescent (no delivery for
            # a grace window — sheds/drops mean polled < submitted is a
            # legitimate end state, so "nothing moved" is the signal, with a
            # first-compile-sized grace).
            deadline = time.time() + 60.0
            last_move = time.time()
            while time.time() < deadline and time.time() - last_move < 3.0:
                moved = 0
                for sid in sids:
                    got = len(fleet.poll(sid, meta_only=True))
                    polled[sid] = polled.get(sid, 0) + got
                    moved += got
                if moved:
                    last_move = time.time()
                time.sleep(0.01)
            stats = fleet.stats()
    finally:
        if exporter is not None:
            exporter.stop()

    out = {
        "replicas": {
            rid: {k: row.get(k) for k in ("state", "restarts", "sessions",
                                          "engine_frames", "recoveries")}
            for rid, row in stats["replicas"].items()
        },
        "sessions": stats["sessions"],
        "polled": polled,
        "aggregate": stats["aggregate"],
        "spillovers": stats["spillovers"],
        "admission_rejections": stats["rejections"],
        "replica_losses": stats["replica_losses"],
        "migrated_sessions": stats["migrated_sessions"],
        "order_violations": stats["order_violations"],
        "faults": stats["faults"]["by_kind"],
        "faults_by_replica": stats["faults"].get("by_replica", {}),
        "recoveries": stats["recoveries"],
        "replicas_live": stats["replicas_live"],
        "replicas_desired": stats["replicas_desired"],
        "standby_warm": stats["standby_warm"],
        "scale_outs": stats["scale_outs"],
        "scale_ins": stats["scale_ins"],
        "rollouts": stats["rollouts"],
        "rollout_swaps": stats["rollout_swaps"],
        # Audit plane: the divergence detector's counters (events ride
        # /audit and the flight dumps; the demo line carries the tally).
        "audit": {k: stats["audit"][k] for k in
                  ("checks_total", "divergences_total",
                   "quarantined_total")},
    }
    if args.rollout_after is not None:
        out["rollout"] = rollout_result
    print(json.dumps(out, default=float))
    return 0


def cmd_worker(args) -> int:
    if args.stall_timeout is not None:
        # The worker's processing loop is synchronous (decode → step →
        # push, no in-flight window), so there is nothing for a stall
        # watchdog to supervise — reject rather than silently ignore.
        print("error: --stall-timeout does not apply to the worker "
              "(its batch loop is synchronous; the watchdog supervises "
              "the pipeline/serve in-flight windows)", file=sys.stderr)
        return 2
    device = _force_platform()

    from dvf_tpu_torch.runtime.engine import Engine
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    filt = _parse_filter_arg(args.filter, args.filter_config)
    worker = ZmqWorker(
        filt,
        engine=Engine(filt, device=device, mesh=_parse_mesh(args.mesh)),
        device=device,
        host=args.host,
        distribute_port=args.distribute_port,
        collect_port=args.collect_port,
        batch_size=args.batch,
        use_jpeg=not args.no_jpeg,
        wire=args.wire,
        delta_tile=args.delta_tile,
        delta_keyframe_interval=args.delta_keyframe_interval,
        delta_device=args.delta_device,
        codec_assist=args.codec_assist,
        raw_size=args.target_size,
        jpeg_quality=90,
        codec_threads=args.codec_threads,
        delay_s=args.delay,
        ingest=args.ingest,
        ingest_depth=args.ingest_depth,
        egress=args.egress,
        fault_budget=args.fault_budget,
        fault_window_s=args.fault_window,
        chaos=_parse_chaos(args),
        trace=args.trace,
        audit_wire=args.audit_wire or args.audit,
    )
    # /timeseries is part of every tier's endpoint surface: give the
    # worker its 1 Hz signal window when the exporter is requested.
    ring = None
    if args.metrics_port is not None:
        from dvf_tpu_torch.obs.registry import TimeSeriesRing

        ring = TimeSeriesRing(worker.signals, interval_s=1.0,
                              name="dvf-worker-telemetry").start()
    # Endpoint parity with serve/fleet: the worker's exporter serves
    # /ledger (its compile events) and /audit (wire-integrity counters)
    # beside /metrics /healthz /timeseries.
    exporter = _start_exporter(args, worker.registry,
                               health_fn=lambda: {"ok": True,
                                                  **worker.signals()},
                               ring=ring,
                               ledger_fn=(worker.ledger.document
                                          if worker.ledger is not None
                                          else None),
                               audit_fn=worker.audit_document)
    flight = None
    if args.flight_dir:
        from dvf_tpu_torch.obs.export import FlightRecorder

        # The worker tier's flight recorder: its loop contains faults
        # per iteration, so the trigger is the FATAL exit (budget
        # exhaustion / unrecoverable engine) — the moment the trace
        # window + stats are worth a dump.
        flight = FlightRecorder(args.flight_dir, label="worker",
                                trace_fn=lambda: [worker.tracer.snapshot()],
                                stats_fn=worker.stats, ring=ring)
    # SIGTERM/SIGINT → graceful stop: the run loop exits at the next
    # poll tick, completed encodes flush through drain_egress(), and the
    # final stats land on stdout — a supervisor's `kill` gets the same
    # clean accounting as a test's max_frames exit. A second signal
    # aborts (the loop may be wedged mid-compile). Handlers go in
    # BEFORE the serving banner: the banner is the readiness signal a
    # supervisor keys its kill on, so it must never precede them.
    import signal

    def _graceful(signum, frame):
        if worker._stop.is_set():
            raise KeyboardInterrupt
        print(f"\n[worker] signal {signum}: draining…",
              file=sys.stderr, flush=True)
        worker.stop()

    old = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            old[sig] = signal.signal(sig, _graceful)
        except ValueError:
            pass  # not the main thread (embedded use)
    print(
        f"{device} worker serving {filt.name} on "
        f"tcp://{args.host}:{args.distribute_port} → :{args.collect_port}",
        file=sys.stderr,
    )
    try:
        worker.run()
        # Ship every encode the codec pool already finished before the
        # stats line claims the totals (satellite: no frames stranded in
        # the egress plane on SIGTERM).
        worker.drain_egress()
        print(json.dumps(worker.stats(), default=float))
    except KeyboardInterrupt:
        pass
    except Exception as e:  # noqa: BLE001 — dump, then re-raise
        if flight is not None:
            flight.trigger(f"worker failed: {e!r}")
        raise
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        if exporter is not None:
            exporter.stop()
        if ring is not None:
            ring.stop()
        if worker.tracer.enabled:
            worker.tracer.export("dvf_worker_timing.pftrace")
        worker.close()
    return 0


def cmd_trace_view(args) -> int:
    """Offline post-mortem summary: a trace file or a flight-dump
    directory → per-lane utilization, slowest spans, and (when the dump
    carries lineage.json) the slowest frame lineages."""
    from dvf_tpu_torch.obs.viewer import render_text, summarize

    if not os.path.exists(args.path):
        print(f"error: {args.path}: no such file or directory",
              file=sys.stderr)
        return 2
    try:
        summary = summarize(args.path, top=args.top)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps(summary, default=float))
    else:
        print(render_text(summary))
    return 0


def cmd_camera(args) -> int:
    """Producer half of the cross-process shm path: capture (or
    synthesize) frames in THIS process and push them into a POSIX
    shared-memory ring that a `serve --source shm:NAME` process consumes —
    the reference's app→worker process boundary (distributor.py:27-35)
    with the C++ ring instead of ZMQ sockets."""
    import time as _time

    from dvf_tpu_torch.transport.ring import FrameRing

    source, frame_shape = _resolve_source(args, allow_shm=False)
    frame_bytes = frame_shape[0] * frame_shape[1] * frame_shape[2]
    print(f"[camera] pushing {frame_shape} frames into shm ring "
          f"{args.shm!r} — consume with: serve --source shm:{args.shm} "
          f"--height {frame_shape[0]} --width {frame_shape[1]}",
          file=sys.stderr)

    ring = FrameRing(
        capacity_bytes=max(1, args.queue_size) * (frame_bytes + 64),
        shm_name=args.shm,
        create=True,
        max_frame_bytes=frame_bytes + 64,
    )
    pushed = 0
    try:
        for idx, (frame, ts) in enumerate(iter(source)):
            if frame is None:
                break
            evicted = ring.push(frame.tobytes(), idx, ts)
            pushed += 1
            if evicted:
                # Consumer is behind: freshness beats completeness (the
                # ring evicted oldest), pace like the pipeline's ingest.
                _time.sleep(0.0002)
        ring.push(b"\x00", pushed, _time.time())  # EOF sentinel
        # Before the creator unlinks: wait for a consumer to attach AND
        # drain. A serve process cold-starting torch and CUDA can take
        # >5 s to attach; unlinking on a drain-only check would destroy a
        # short capture before anyone saw it.
        deadline = _time.time() + args.linger_s
        while _time.time() < deadline:
            if ring.popped > 0 and len(ring) == 0:
                break
            _time.sleep(0.01)
    except KeyboardInterrupt:
        try:
            ring.push(b"\x00", pushed, _time.time())
        except Exception:
            pass
    finally:
        stats = {"pushed": pushed, "dropped": ring.dropped}
        ring.close()
    print(json.dumps(stats))
    return 0


def cmd_bench(args) -> int:
    """One BENCH_CONFIGS entry: the device-resident chain and its H100
    roofline fields, or with ``--e2e`` the pipeline's throughput and its
    rate-controlled latency leg. One JSON line."""
    device = _force_platform()

    from dvf_tpu_torch.benchmarks import (
        bench_device_resident,
        bench_e2e_latency,
        bench_e2e_streaming,
        roofline_fields,
    )
    from dvf_tpu_torch.ops import get_filter

    spec = BENCH_CONFIGS[args.config]
    fname, fcfg = spec["filter"]
    filt = get_filter(fname, **fcfg)
    batch = args.batch or spec["batch"]
    h, w = spec["h"], spec["w"]
    mesh = _parse_mesh(args.mesh)

    if args.e2e:
        if args.wire != "raw" and args.transport != "ring":
            print("error: --wire jpeg/delta needs --transport ring "
                  "(the codec wire rides the ring payloads)",
                  file=sys.stderr)
            return 2
        if args.wire != "raw":
            from dvf_tpu_torch.transport.codec import _load_shim

            try:  # both codec wires encode with the native JPEG codec
                _load_shim()
            except RuntimeError as e:
                print(f"error: --wire {args.wire} needs the JPEG codec, "
                      f"which cannot be built here: {e}", file=sys.stderr)
                return 2
        r = bench_e2e_streaming(filt, args.frames, batch, h, w,
                                collect_mode=args.collect_mode,
                                transport=args.transport, wire=args.wire,
                                mesh=mesh, ingest=args.ingest,
                                ingest_depth=args.ingest_depth,
                                egress=args.egress, motion=args.motion,
                                device=device)
        out = {
            "metric": f"{args.config}_e2e_fps",
            "value": round(r["fps"], 1),
            "unit": "fps",
            "frames": r["frames"],
            "collect_mode": args.collect_mode,
            "transport": args.transport,
            "wire": args.wire,
            "motion": args.motion,
            # Delta accounting + codec provenance when a codec wire ran.
            **({"wire_stats": r["wire"]} if "wire" in r else {}),
            # Effective transfer path + hidden-H2D fraction.
            "ingest": r["ingest"],
            "ingest_depth": r["ingest_depth"],
            "overlap_efficiency": r["overlap_efficiency"],
            # The delivery-side mirror (runtime/egress.py).
            "egress": r["egress"],
            "egress_overlap_efficiency": r["egress_overlap_efficiency"],
            # Per-kind contained-fault counters ({} = clean run).
            "faults": r.get("faults", {}),
        }
        if args.lat_frames != 0 and r["fps"] > 0:
            # p50/p99 from a SEPARATE rate-controlled leg (source at 0.8x
            # the just-measured throughput, ingest queue ≈ one batch): the
            # published latency is pipeline transit, not standing queue
            # depth. The unthrottled run's percentiles are reported only
            # under the congestion_* names. lat_congested=True means even
            # the lowest tried rate congested and the percentiles are an
            # upper bound, not transit.
            target = 0.8 * r["fps"]
            lat_frames = args.lat_frames or min(
                args.frames, max(16, int(target * 20.0)))
            rl = bench_e2e_latency(filt, lat_frames, batch, h, w, target,
                                   collect_mode=args.collect_mode,
                                   transport=args.transport, wire=args.wire,
                                   mesh=mesh, ingest=args.ingest,
                                   ingest_depth=args.ingest_depth,
                                   egress=args.egress, motion=args.motion,
                                   device=device)
            out.update(
                p50_ms=round(rl["p50_ms"], 3),
                p99_ms=round(rl["p99_ms"], 3),
                lat_frames=rl["frames"],
                lat_target_fps=round(rl["target_fps"], 1),
                lat_delivery_fps=round(rl["delivery_fps"], 2),
                lat_congested=rl["congested"],
                lat_backoffs=rl["backoffs"],
            )
        out.update(
            congestion_p50_ms=round(r["p50_ms"], 3),
            congestion_p99_ms=round(r["p99_ms"], 3),
        )
    else:
        if args.transport != "python" or args.wire != "raw":
            print("error: --transport/--wire only apply to --e2e runs "
                  "(device-resident mode never touches the ingest path)",
                  file=sys.stderr)
            return 2
        r = bench_device_resident(filt, args.iters, batch, h, w, mesh=mesh,
                                  device=device)
        out = {
            "metric": f"{args.config}_device_fps",
            "value": round(r["fps"], 1),
            "unit": "fps",
            "ms_per_frame": round(r["ms_per_frame"], 4),
            "batch": batch,
        }
        out.update(roofline_fields(r, "cpu" if device == "cpu" else "cuda"))
    print(json.dumps(out))
    return 0


def make_style_image(kind: str, size: int):
    """Deterministic style targets for training. A flat image has trivial
    Gram statistics (training just desaturates); the textured presets carry
    strong orientation/color correlations that produce VISIBLE stylization
    even with the random-init VGG feature extractor."""
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    if kind == "gray":
        img = np.full((size, size, 3), 0.3, np.float32)
    elif kind == "stripes":
        # Bold diagonal stripes, alternating warm/cool — strong directional
        # second-order statistics at every feature scale.
        phase = np.sin((xx + yy) * (2.0 * np.pi / 12.0))
        warm = np.stack([0.9 + 0 * phase, 0.4 + 0 * phase, 0.1 + 0 * phase], -1)
        cool = np.stack([0.1 + 0 * phase, 0.3 + 0 * phase, 0.9 + 0 * phase], -1)
        img = np.where(phase[..., None] > 0, warm, cool).astype(np.float32)
    elif kind == "checker":
        c = (((xx // 8).astype(int) + (yy // 8).astype(int)) % 2).astype(np.float32)
        img = np.stack([c, 1.0 - c, 0.5 + 0 * c], -1)
    elif kind == "noise":
        img = np.random.default_rng(7).random((size, size, 3)).astype(np.float32)
    else:
        raise ValueError(f"unknown style preset {kind!r}")
    return img[None]  # (1, size, size, 3)


def _train_devices(device: str) -> list:
    """The devices a train run spans: every attached card, or the CPU
    alone with ``--platform cpu`` (the reference spans its CPU's devices
    there; the port's CPU is one device)."""
    import torch

    if torch.device(device).type == "cpu":
        return [torch.device(device)]
    from dvf_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.local_devices()


def _train_mesh(batch: int, device: str):
    """The train step's mesh, as the reference builds it: ``data`` = the
    largest divisor of the batch the devices give (the step folds the
    batch over data × space; spare devices idle). None on one device."""
    import math

    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    devices = _train_devices(device)
    data = math.gcd(batch, len(devices))
    return make_mesh(MeshConfig(data=data), devices=devices) if data > 1 else None


def cmd_train(args) -> int:
    """Train the style net on synthetic frames; checkpoint and resume.
    Every attached card (``data`` parallel, :func:`_train_mesh`), or the
    CPU with ``--platform cpu``."""
    device = _force_platform()

    from dvf_tpu_torch.io.sources import SyntheticSource
    from dvf_tpu_torch.models import StyleNetConfig
    from dvf_tpu_torch.models.vgg import VGGConfig
    from dvf_tpu_torch.train import StyleTrainConfig, init_train_state, make_train_step
    from dvf_tpu_torch.train.checkpoint import restore_checkpoint
    from dvf_tpu_torch.train.style import shard_train_state

    config = StyleTrainConfig(
        net=StyleNetConfig(base_channels=args.base_channels, n_residual=args.n_residual),
        vgg=VGGConfig(),
        learning_rate=args.lr,
        **({"style_weight": args.style_weight}
           if args.style_weight is not None else {}),
    )
    src = SyntheticSource(height=args.size, width=args.size,
                          n_frames=args.steps * args.batch, rate=0.0)
    frames = iter(src)

    mesh = _train_mesh(args.batch, device)
    state = init_train_state(args.seed, make_style_image(args.style, args.size),
                             config, device=device)
    if args.resume:
        if not os.path.isdir(args.resume):
            # A typo'd path must not silently restart from scratch.
            print(f"error: --resume path {args.resume!r} does not exist",
                  file=sys.stderr)
            return 2
        state = restore_checkpoint(args.resume, state, mesh=mesh, config=config)
        print(f"resumed from {args.resume} at step {int(state.step)}", file=sys.stderr)
    elif mesh is not None:
        state = shard_train_state(state, mesh, config)
    step_fn = make_train_step(mesh, config, state_template=state)

    if args.checkpoint_dir:
        # Sidecar net config so inference (serve --style-checkpoint) can
        # rebuild the exact architecture without guessing flags. Written
        # BEFORE the loop (it depends only on argv): a run killed
        # mid-training must still leave loadable step_* checkpoints.
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        with open(os.path.join(args.checkpoint_dir, "config.json"), "w") as f:
            json.dump({"base_channels": args.base_channels,
                       "n_residual": args.n_residual,
                       "style": args.style, "size": args.size,
                       "steps": args.steps}, f)

    return _run_train_loop(
        args, device, state, step_fn, frames,
        log_line=lambda m: f"loss={float(m['loss']):.5f}",
        final_json=lambda _state, m: {
            "steps": args.steps,
            "final_loss": float(m["loss"]) if m else float("nan"),
        },
    )


def _run_train_loop(args, device, state, step_fn, frames, log_line, final_json):
    """The training loop both families share: stack a float32 batch on
    the host → pinned → copied to the device without blocking → step →
    periodic log (the only place the loop waits for the device, besides
    the checkpoints) → periodic ASYNC checkpoint → final blocking
    checkpoint + JSON. ``log_line(metrics)`` and ``final_json(state,
    metrics)`` are the family's pieces."""
    import numpy as np
    import torch

    from dvf_tpu_torch.train.checkpoint import AsyncSaver, save_checkpoint

    pin = torch.device(device).type == "cuda"
    saver = AsyncSaver() if args.checkpoint_dir else None
    start = int(state.step)
    metrics = {}
    try:
        for i in range(start, args.steps):
            batch_np = np.stack([
                next(frames)[0] for _ in range(args.batch)
            ]).astype(np.float32) / 255.0
            batch = torch.from_numpy(batch_np)
            if pin:
                batch = batch.pin_memory()
            state, metrics = step_fn(state, batch.to(device, non_blocking=True))
            if (i + 1) % args.log_every == 0:
                print(f"step {i + 1}: {log_line(metrics)}", file=sys.stderr)
            if saver is not None and (i + 1) % args.checkpoint_every == 0:
                path = os.path.join(args.checkpoint_dir, f"step_{i + 1:06d}")
                saver.save(path, state)
                print(f"checkpointed {path} (async)", file=sys.stderr)
    finally:
        if saver is not None:
            try:
                saver.close()  # drain the in-flight write before final save
            except Exception as e:  # noqa: BLE001 — a failed background
                # write must not mask the training exception propagating
                # through this finally (the blocking final save below
                # still surfaces a genuinely broken disk on the happy path).
                print(f"[train] async checkpoint drain failed: {e!r}",
                      file=sys.stderr)
    if args.checkpoint_dir:
        path = os.path.join(args.checkpoint_dir, "final")
        save_checkpoint(path, state)
        print(f"checkpointed {path}", file=sys.stderr)
    print(json.dumps(final_json(state, metrics)))
    return 0


def _sr_held_out_eval(state, config) -> dict:
    """Held-out generalization check on the state's device: PSNR of the
    trained net vs the nearest-neighbor baseline on fresh structured
    draws at an UNSEEN geometry (80x80; eval seed 12345 is never used by
    training, which derives its stream from args.seed + 1)."""
    import numpy as np
    import torch

    from dvf_tpu_torch.models.espcn import apply_espcn
    from dvf_tpu_torch.models.layers import upsample_nearest
    from dvf_tpu_torch.train.optim import whole
    from dvf_tpu_torch.train.sr import downscale_area, synthesize_structured_batch

    rng = np.random.default_rng(12345)
    hr = torch.from_numpy(synthesize_structured_batch(rng, 8, 80)).to(
        state.step.device).float() / 255.0
    lr = downscale_area(hr, config.net.scale)
    with torch.no_grad():
        out = torch.clamp(apply_espcn(whole(state.params), lr, config.net), 0.0, 1.0)
    near = upsample_nearest(lr, config.net.scale)

    def psnr(a):
        return round(-10.0 * float(np.log10(float(torch.mean((a - hr) ** 2)) + 1e-12)), 2)

    p_sr, p_near = psnr(out), psnr(near)
    return {"psnr_sr_db": p_sr, "psnr_nearest_db": p_near,
            "delta_db": round(p_sr - p_near, 2)}


def cmd_train_sr(args) -> int:
    """Train the ESPCN SR net self-supervised on synthetic frames (each HR
    frame area-downscaled ×r on the device makes its own LR input — no
    dataset)."""
    device = _force_platform()

    import numpy as np

    from dvf_tpu_torch.models.espcn import EspcnConfig
    from dvf_tpu_torch.train.checkpoint import restore_sr_checkpoint
    from dvf_tpu_torch.train.sr import (
        SrTrainConfig,
        init_train_state,
        make_train_step,
        shard_train_state,
        synthesize_structured_batch,
    )

    if args.size % args.scale:
        print(f"error: --size {args.size} must be divisible by --scale {args.scale}",
              file=sys.stderr)
        return 2
    config = SrTrainConfig(net=EspcnConfig(scale=args.scale), learning_rate=args.lr)

    # Randomized structured frames: edge-rich content drawn fresh per
    # frame (train.sr.synthesize_structured_batch) — iid noise is
    # information-destroyed by downscaling, and a fixed frame cycle gets
    # memorized instead of teaching edge reconstruction.
    def _frame_gen():
        rng = np.random.default_rng(args.seed + 1)
        while True:
            for f in synthesize_structured_batch(rng, args.batch, args.size):
                yield f, 0.0

    frames = _frame_gen()

    mesh = _train_mesh(args.batch, device)
    state = init_train_state(args.seed, config, device=device)
    if args.resume:
        if not os.path.isdir(args.resume):
            print(f"error: --resume path {args.resume!r} does not exist",
                  file=sys.stderr)
            return 2
        state = restore_sr_checkpoint(args.resume, state, mesh=mesh, config=config)
        print(f"resumed from {args.resume} at step {int(state.step)}", file=sys.stderr)
    elif mesh is not None:
        state = shard_train_state(state, mesh, config)
    step_fn = make_train_step(mesh, config, state_template=state)

    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        with open(os.path.join(args.checkpoint_dir, "config.json"), "w") as f:
            json.dump({"scale": args.scale, "size": args.size,
                       "steps": args.steps}, f)

    def final_json(final_state, m):
        out = {
            "steps": args.steps,
            "final_loss": float(m["loss"]) if m else float("nan"),
            "final_psnr_db": float(m["psnr"]) if m else float("nan"),
        }
        if args.eval:
            out["held_out"] = _sr_held_out_eval(final_state, config)
        return out

    return _run_train_loop(
        args, device, state, step_fn, frames,
        log_line=lambda m: (f"loss={float(m['loss']):.5f} "
                            f"psnr={float(m['psnr']):.2f}dB"),
        final_json=final_json,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dvf_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    # Shared by the device-touching subcommands: --platform cpu|cuda is
    # the flag form of DVF_FORCE_PLATFORM (the default is cuda:0; cpu is
    # the explicit CPU run — see `doctor`).
    plat = argparse.ArgumentParser(add_help=False)
    plat.add_argument("--platform", default=None, metavar="NAME",
                      help="the device platform: cuda (the default, "
                           "cuda:0) or cpu; equivalent to "
                           "DVF_FORCE_PLATFORM=NAME")

    # Shared by every subcommand with a batch-ingest hot path (serve,
    # worker, fleet, bench): the streamed shard-level assembler vs the classic
    # monolithic staging, and its in-flight transfer window.
    ing = argparse.ArgumentParser(add_help=False)
    ing.add_argument("--ingest", choices=("streamed", "monolithic"),
                     default="streamed",
                     help="batch staging path: 'streamed' decodes into "
                          "per-device-shard slabs and ships each shard "
                          "the moment its rows fill (H2D overlaps decode "
                          "and the previous batch's compute); "
                          "'monolithic' is the classic decode-all → one "
                          "blocking device_put escape hatch")
    ing.add_argument("--ingest-depth", type=int, default=4,
                     help="streamed ingest: max shard transfers in "
                          "flight before staging blocks on the oldest "
                          "(also the per-device sub-chunk granularity)")
    ing.add_argument("--egress", choices=("streamed", "monolithic"),
                     default="streamed",
                     help="result fetch path: 'streamed' issues per-"
                          "output-shard copy_to_host_async at submit and "
                          "materializes into preallocated host slabs at "
                          "collect, overlapping D2H with the tail of "
                          "compute (runtime/egress.py; auto-degrades "
                          "where streaming cannot win); 'monolithic' is "
                          "the classic whole-batch np.asarray escape "
                          "hatch")

    # Shared by the long-running serving subcommands (serve, worker): the
    # resilience knobs — deterministic fault injection for reproducing
    # failures end-to-end, and the error-budget/watchdog bounds
    # (dvf_tpu_torch.resilience).
    res = argparse.ArgumentParser(add_help=False)
    res.add_argument("--chaos", default=None, metavar="SPEC",
                     help="arm deterministic fault injection: comma-"
                          "separated rules 'site[:key=value]*' over sites "
                          "decode|transport|h2d|d2h|compute|oom|freeze with "
                          "keys every=N, at=I/J/K (0-based event indices), "
                          "p=0.05, count=N, delay=SECONDS, kind=NAME — "
                          "e.g. 'compute:at=3,h2d:every=5:count=2'; "
                          "exactly reproducible with the same --chaos-seed")
    res.add_argument("--chaos-seed", type=int, default=0,
                     help="seed for probabilistic (p=) chaos rules")
    res.add_argument("--fault-budget", type=int, default=16,
                     help="contained faults per kind inside --fault-window "
                          "before escalation (drop → degrade → fail)")
    res.add_argument("--fault-window", type=float, default=30.0,
                     help="sliding window (seconds) for --fault-budget")
    res.add_argument("--stall-timeout", type=float, default=None,
                     help="stall watchdog: an in-flight batch older than "
                          "this (seconds) triggers supervised recovery "
                          "(shed window, rebuild engine). Default: 30 for "
                          "the multi-stream frontend, off for the single-"
                          "stream pipeline; rejected by the worker (its "
                          "batch loop is synchronous — nothing to watch)")

    # Shared by the serving subcommands (serve, fleet, worker): the
    # telemetry plane's scrape endpoint (obs.export).
    obsp = argparse.ArgumentParser(add_help=False)
    obsp.add_argument("--metrics-port", type=int, default=None,
                      metavar="PORT",
                      help="serve /metrics (Prometheus text exposition; "
                           "?format=json for JSON), /healthz, and "
                           "/timeseries on 127.0.0.1:PORT (0 = ephemeral; "
                           "the bound port is announced on stderr)")
    obsp.add_argument("--audit", action="store_true",
                      help="arm the audit plane (obs.audit): serve/fleet "
                           "run sampled shadow-replay of delivered frames "
                           "against a golden un-jitted path plus the "
                           "program-swap equivalence guard; the worker "
                           "arms its wire-integrity envelope. Exports "
                           "stats()['audit'], dvf_audit_* metrics, and "
                           "/audit on --metrics-port")
    obsp.add_argument("--audit-sample", type=int, default=64,
                      metavar="K",
                      help="shadow-replay sampling period: every Kth "
                           "staged frame is re-executed on the golden "
                           "path (default 64)")
    obsp.add_argument("--audit-wire", action="store_true",
                      help="wire-integrity digest envelope on the framed "
                           "transports this tier runs: the ZMQ worker "
                           "(both directions) and single-stream serve "
                           "--transport ring; an 8-byte blake2b stamped "
                           "at encode, verified at every decode hop — "
                           "mismatches are 'integrity' faults. Peers "
                           "must speak the envelope (the library "
                           "ZmqStreamBridge takes audit_wire=). Tiers "
                           "with no framed transport in the invocation "
                           "say so on stderr instead of silently "
                           "ignoring the flag")

    # Shared by serve + fleet: the multi-signature serving plane
    # (signature buckets, compiled-program pool, AOT warm-start).
    sig = argparse.ArgumentParser(add_help=False)
    sig.add_argument("--max-buckets", type=int, default=4,
                     help="live signature buckets per frontend — how many "
                          "distinct (op_chain, geometry, dtype) mixes one "
                          "frontend serves concurrently (beyond it, a new "
                          "signature first retires an idle bucket, else is "
                          "refused with the warm-signature list)")
    sig.add_argument("--pool-capacity", type=int, default=8,
                     help="compiled-program pool bound (LRU): how many "
                          "signatures stay warm on device; eviction frees "
                          "device buffers, re-admission recompiles through "
                          "the persistent compilation cache")
    sig.add_argument("--precompile", default=None, metavar="MANIFEST",
                     help="JSON manifest of signatures to AOT-compile "
                          "before serving ([{\"op_chain\": \"invert\", "
                          "\"frame_shape\": [H, W, 3], \"dtype\": "
                          "\"uint8\"}, ...] — see docs/GUIDE.md 'Serving "
                          "a mixed workload'): each warms the program "
                          "pool AND the persistent cache, so its first "
                          "real admission is milliseconds")
    sig.add_argument("--compile-cache-dir", default=None, nargs="?",
                     const="", metavar="DIR",
                     help="point the kernel-build cache here (the nvcc "
                          "kernels and g++ shims; bare flag = "
                          "$DVF_COMPILE_CACHE_DIR or the default "
                          "dvf_tpu_torch/_build/, gitignored, size-"
                          "bounded): a restart loads its libraries instead "
                          "of building them; on a card every kernel is "
                          "built there up front; process-mode fleet "
                          "replicas inherit it via DVF_COMPILE_CACHE_DIR")

    fp = sub.add_parser("filters", help="list registered filters")
    fp.add_argument("-v", "--verbose", action="store_true",
                    help="include each filter's one-line description")

    dp_ = sub.add_parser("doctor", parents=[plat],
                         help="environment diagnostics (bounded backend probe)")
    dp_.add_argument("--probe-timeout", type=float, default=60.0,
                     help="seconds before declaring the backend unreachable")

    sp = sub.add_parser("serve", parents=[plat, ing, res, obsp, sig],
                        help="run the pipeline")
    sp.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="arm the SLO flight recorder (--sessions mode): "
                         "watchdog trips, budget-exhaustion failures, and "
                         "SLO burn-rate breaches dump a post-mortem "
                         "(merged trace + stats + telemetry window) here")
    sp.add_argument("--filter", default="invert")
    sp.add_argument("--filter-config", default=None, help="JSON kwargs for the filter")
    sp.add_argument("--source", default="synthetic",
                    help="synthetic|webcam|shm:<name>|<video path> "
                         "(shm: consume a `dvf_tpu_torch camera --shm "
                         "<name>` "
                         "producer process)")
    sp.add_argument("--height", type=int, default=720)
    sp.add_argument("--width", type=int, default=1280)
    sp.add_argument("--frames", type=int, default=300)
    sp.add_argument("--rate", type=float, default=0.0, help="source fps; 0 = unthrottled")
    sp.add_argument("--batch", type=int, default=8)
    sp.add_argument("--frame-delay", type=int, default=5)
    sp.add_argument("--queue-size", type=int, default=10)
    sp.add_argument("--target-size", type=int, default=512)
    sp.add_argument("--display", action="store_true",
                    help="side-by-side live|processed window (ESC stops)")
    sp.add_argument("--headless", action="store_true",
                    help="with --display: compose panes but open no window")
    sp.add_argument("--display-backend", choices=("cv2", "gl"),
                    default="cv2",
                    help="pane composition: cv2 window (interactive; ESC "
                         "stops the stream) or the reference's GL "
                         "texture-blit path rendered offscreen via "
                         "surfaceless EGL (headless-capable; no window and "
                         "no ESC — stop an infinite source with Ctrl-C)")
    sp.add_argument("--fail-fast", action="store_true",
                    help="abort on the first error instead of containing it")
    sp.add_argument("--quiet", action="store_true", help="no 5s telemetry prints")
    sp.add_argument("--trace", action="store_true", help="export Perfetto trace")
    sp.add_argument("--device-trace", default=None, metavar="DIR",
                    help="capture a torch.profiler device trace into DIR")
    sp.add_argument("--transport", choices=("python", "ring"), default="python",
                    help="ingest queue: 'ring' routes frames through the "
                         "native C++ shared-memory ring (drop counter shows "
                         "up in stats as dropped_at_ingest)")
    sp.add_argument("--codec-threads", type=int, default=4,
                    help="JPEG codec thread-pool size for --wire jpeg "
                         "(and the serve-side ZmqStreamBridge) — the "
                         "host-codec throughput knob, SURVEY §7 hard "
                         "part 3")
    sp.add_argument("--mesh", default=None,
                    help="device mesh for the engine: 'data=2,space=2,"
                         "model=2' (omitted axes = 1) or 'auto[:space|"
                         ":model]' over the attached cards; default = the "
                         "one device")
    sp.add_argument("--collect-mode", choices=("thread", "inline"),
                    default="thread",
                    help="'inline': the dispatch thread retires results "
                         "itself (fewer threads on the GIL)")
    sp.add_argument("--style-checkpoint", default=None, metavar="DIR",
                    help="load trained style-transfer weights from a train "
                         "checkpoint dir (overrides --filter)")
    sp.add_argument("--sr-checkpoint", default=None, metavar="DIR",
                    help="load trained super-resolution weights from a "
                         "train-sr checkpoint dir (overrides --filter)")
    sp.add_argument("--wire", choices=("raw", "jpeg", "delta"), default="raw",
                    help="with --transport ring: payload format on the ring "
                         "(jpeg = encode at capture, decode into the device "
                         "staging buffer — the reference's use_jpeg path; "
                         "delta = temporal-delta wire, only changed tiles "
                         "cross with keyframes every N — host codec cost "
                         "scales with the stream's dirty ratio)")
    sp.add_argument("--delta-keyframe-interval", type=int, default=16,
                    help="--wire delta: full keyframe cadence (also the "
                         "resync bound after dropped delta frames)")
    sp.add_argument("--delta-tile", type=int, default=32,
                    help="--wire delta: change-detection tile size")
    sp.add_argument("--codec-assist", choices=("none", "probe", "full"),
                    default="none",
                    help="codec-assist tier this run requests; on serve "
                         "the ring is an ingest-side host wire, so the "
                         "flag stamps PROVENANCE into codec.config() "
                         "(none / ycbcr / full-transform rows in bench "
                         "output) — the worker tier is where 'full' "
                         "moves DCT+quant onto the device")
    sp.add_argument("--sessions", type=int, default=1,
                    help=">1: run the multi-stream serving demo — N "
                         "synthetic client streams at different frame "
                         "rates multiplexed through one shared engine "
                         "(serve.ServeFrontend: cross-session batching, "
                         "admission control, per-stream SLOs)")
    sp.add_argument("--slo-ms", type=float, default=1000.0,
                    help="per-stream latency budget for --sessions mode; "
                         "frames that blow it before reaching a device "
                         "slot are shed, not processed")
    sp.add_argument("--max-sessions", type=int, default=0,
                    help="admission cap for --sessions mode "
                         "(0 = max(16, --sessions))")
    sp.add_argument("--lineage", action="store_true",
                    help="arm frame-lineage latency attribution "
                         "(multi-session serve: per-frame additive "
                         "decomposition — ingress/bucket-queue/"
                         "assemble+H2D/device/D2H/deliver — behind "
                         "stats()['attribution'], attr_* metrics, and "
                         "the /explain endpoint; SLO-breaching frames "
                         "keep full lineage as flight-dump exemplars)")
    sp.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="persist per-signature stage-cost profiles "
                         "here (sibling of --compile-cache-dir): "
                         "measured component costs seed the next run's "
                         "tick-cost estimates and annotate control-"
                         "plane decisions")
    sp.add_argument("--autoplan", action="store_true",
                    help="--sessions mode: run the auto-plan plane at "
                         "startup (dvf_tpu_torch.control.planner) — "
                         "micro-"
                         "profile a pruned candidate grid (batch ladder "
                         "x tick x ingest depth) through the real "
                         "frontend, apply the measured-best plan, and "
                         "hand its envelope to the --control "
                         "controllers; with --plan-cache-dir a warm "
                         "restart replays the cached plan in "
                         "milliseconds instead of re-searching")
    sp.add_argument("--plan-cache-dir", default=None, metavar="DIR",
                    help="persist auto-plan winners and compile-time "
                         "calibrations here, keyed by (op-chain "
                         "signature, geometry, device-topology "
                         "fingerprint, planner version); any key "
                         "component changing forces a re-plan, a "
                         "corrupt entry is ignored, and cached "
                         "calibrations let engine compiles skip their "
                         "blocking transfer/step measurements")
    sp.add_argument("--control", action="store_true",
                    help="--sessions mode: arm the load-adaptive control "
                         "plane (dvf_tpu_torch.control) — closed-loop "
                         "controllers over the telemetry ring resize "
                         "per-bucket batches/tick budget, downshift "
                         "session quality under sustained pressure "
                         "(sr upscale keeps deliveries full-res), and "
                         "raise the priority-tier admission floor")
    sp.add_argument("--tier", type=int, default=None,
                    help="priority tier for the demo's streams (0 "
                         "interactive — sheds LAST, 1 standard, 2 "
                         "batch — sheds first; default 1). Under "
                         "--control overload the admission floor "
                         "refuses high tier values first")
    sp.add_argument("--morph-after", default=None, metavar="K:CHAIN",
                    help="multi-session demo: once the first stream has "
                         "K deliveries, hot-swap its filter chain to "
                         "CHAIN mid-stream (morph_stream — no "
                         "close/reopen, indices stay monotone, the "
                         "cutover frame rides the ledger's swap event); "
                         "e.g. 30:invert|box_blur")
    sp.add_argument("--publish", default=None, metavar="CHANNEL",
                    help="--sessions mode: register the first stream's "
                         "output as a broadcast channel (encode-once "
                         "tiered fan-out, dvf_tpu_torch.broadcast); "
                         "watchers "
                         "attach in-process via subscribe() or remotely "
                         "through --broadcast-bind")
    sp.add_argument("--publish-tiers", default="native/q90/jpeg",
                    metavar="SPECS",
                    help="comma-separated tier specs for --publish, "
                         "each 'GEOMxGEOM|native / qN / raw|jpeg|delta' "
                         "(e.g. 'native/q90/jpeg,640x360/q60/delta'); "
                         "one closed-loop encoder per tier, shared by "
                         "every watcher on it")
    sp.add_argument("--broadcast-bind", default=None, metavar="ENDPOINT",
                    help="with --publish: bind the ZMQ broadcast gate "
                         "here (e.g. tcp://127.0.0.1:5556) — remote "
                         "'dvf_tpu_torch subscribe' clients attach "
                         "through it")

    sb = sub.add_parser(
        "subscribe",
        help="watch a broadcast channel through a ZMQ gate (the client "
             "side of serve --publish --broadcast-bind)")
    sb.add_argument("endpoint", metavar="ENDPOINT",
                    help="the gate's ZMQ endpoint "
                         "(e.g. tcp://127.0.0.1:5556)")
    sb.add_argument("--channel", required=True,
                    help="published channel name to attach to")
    sb.add_argument("--tier", default=None, metavar="SPEC",
                    help="tier spec to watch (e.g. 'native/q90/jpeg'); "
                         "omitted = the channel's ladder top")
    sb.add_argument("--frames", type=int, default=120,
                    help="stop after this many received frames")
    sb.add_argument("--timeout", type=float, default=30.0,
                    help="give up after this many seconds without the "
                         "requested frame count")
    sb.add_argument("--queue", type=int, default=8,
                    help="gate-side drop-oldest queue depth for this "
                         "watcher (small = freshest, large = fewest "
                         "drops)")
    sb.add_argument("--idle-timeout", type=float, default=5.0,
                    help="declare the gate dead (exit 3) after this "
                         "many seconds with no frames AND no heartbeat "
                         "reply — a mid-stream gate death exits "
                         "promptly instead of running out the --timeout "
                         "deadline")

    fl = sub.add_parser(
        "fleet", parents=[plat, ing, res, obsp, sig],
        help="multi-replica serving: N engines behind one front door")
    fl.add_argument("--trace", action="store_true",
                    help="arm per-replica tracers (bounded event rings); "
                         "replica traces merge into one Perfetto session "
                         "in flight-recorder dumps")
    fl.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="arm the fleet flight recorder: replica losses "
                         "and replica-side watchdog trips dump a merged "
                         "multi-replica trace + fleet stats here")
    fl.add_argument("--replicas", type=int, default=2,
                    help="engine replica count behind the front door")
    fl.add_argument("--mode", choices=("local", "process"), default="process",
                    help="replica transport: 'process' = one child "
                         "process per replica (own torch runtime/cores — "
                         "the scale-out shape); 'local' = in-process "
                         "frontends on slices of the local device mesh")
    fl.add_argument("--sessions", type=int, default=4,
                    help="synthetic client streams to multiplex")
    fl.add_argument("--filter", default="invert")
    fl.add_argument("--filter-config", default=None,
                    help="JSON kwargs for the filter")
    fl.add_argument("--height", type=int, default=256)
    fl.add_argument("--width", type=int, default=256)
    fl.add_argument("--frames", type=int, default=120,
                    help="frames per stream")
    fl.add_argument("--rate", type=float, default=30.0,
                    help="base stream fps (streams spread 0.4–1.6×)")
    fl.add_argument("--batch", type=int, default=4)
    fl.add_argument("--queue-size", type=int, default=10)
    fl.add_argument("--slo-ms", type=float, default=1000.0)
    fl.add_argument("--max-sessions", type=int, default=0,
                    help="PER-REPLICA admission cap (0 = max(16, "
                         "--sessions)); the fleet's total gate is the "
                         "sum over healthy replicas")
    fl.add_argument("--health-poll", type=float, default=0.25,
                    help="replica health monitor cadence (seconds)")
    fl.add_argument("--audit-interval", type=float, default=0.0,
                    metavar="S",
                    help="cross-replica divergence cadence: every S "
                         "seconds an identical probe frame runs through "
                         "every replica warm on a shared signature and "
                         "the output digests are compared (0 = off; "
                         "--audit arms the per-replica planes too)")
    fl.add_argument("--audit-quarantine", action="store_true",
                    help="retire (drain + replace) a replica the "
                         "divergence detector flags, through the "
                         "scale-in seam — instead of only flagging it")
    fl.add_argument("--codec-assist", choices=("none", "probe", "full"),
                    default="none",
                    help="accepted for tier parity; the fleet front door "
                         "carries pixels (no codec), so a non-none value "
                         "only prints where the assist actually lives")
    fl.add_argument("--devices-per-replica", type=int, default=0,
                    help="local mode: devices per replica engine "
                         "(0 = even split)")
    fl.add_argument("--scaling", action="store_true",
                    help="run the fleet scaling round instead of the "
                         "demo: aggregate throughput at 1 and "
                         "--replicas replicas, core-pinned workers")
    fl.add_argument("--lineage", action="store_true",
                    help="arm frame-lineage latency attribution on every "
                         "replica (same spelling as serve --lineage); "
                         "lineage crosses the ProcessReplica RPC with a "
                         "clock re-base and /explain fans out per replica")
    fl.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="persist per-signature stage-cost profiles "
                         "(serve --profile-dir, applied per replica)")
    fl.add_argument("--autoplan", action="store_true",
                    help="apply a cached-or-analytic plan at the front "
                         "door (first --precompile manifest signature) "
                         "before replicas spawn — every replica "
                         "inherits the planned batch/tick/depth; with "
                         "--autoscale the elasticity controller turns "
                         "predictive (spawns on projected queue growth "
                         "before refusals start). The front door never "
                         "live-searches; run 'serve --sessions N "
                         "--autoplan' against the same --plan-cache-dir "
                         "to measure a plan first")
    fl.add_argument("--plan-cache-dir", default=None, metavar="DIR",
                    help="plan/calibration cache directory (see serve "
                         "--plan-cache-dir); rides into every replica "
                         "for calibration-seeded compiles")
    fl.add_argument("--control", action="store_true",
                    help="arm the load-adaptive control plane on every "
                         "replica's frontend (see serve --control); the "
                         "fleet door additionally bin-packs batch-tier "
                         "opens and reserves headroom for "
                         "interactive/standard tiers")
    fl.add_argument("--tier", type=int, default=None,
                    help="priority tier for the demo's streams (0 "
                         "interactive, 1 standard, 2 batch; default 1)")
    fl.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="arm controller-driven elasticity: the fleet "
                         "grows/shrinks itself between MIN and MAX "
                         "replicas from the merged telemetry ring "
                         "(admission-refusal rate, per-replica "
                         "occupancy/queue, shed and SLO-miss counters). "
                         "Scale-out adopts from the warm standby pool "
                         "when one is armed; scale-in drains and "
                         "migrates sessions before terminating. "
                         "--replicas (clamped into the bounds) is the "
                         "starting count")
    fl.add_argument("--standby-warm", type=int, default=0,
                    help="warm standby pool size: replicas pre-spawned "
                         "and AOT-precompiled (via --precompile + the "
                         "persistent compile cache) so a scale-out is "
                         "session-rebind time, not a cold spawn; a "
                         "background thread refills taken standbys")
    fl.add_argument("--rollout-after", type=float, default=None,
                    metavar="S",
                    help="S seconds into the demo, run a zero-downtime "
                         "rolling rollout: every replica is replaced "
                         "spawn-before-retire (warm standby adoption "
                         "when --standby-warm is armed) with sessions "
                         "migrated gracefully; the report rides the "
                         "demo's JSON line")
    fl.add_argument("--multihost-hosts", type=int, default=0,
                    help=">=2 arms the bigger-replica scaling axis: "
                         "scale-outs may spawn ONE replica spanning "
                         "this many distributed processes (one "
                         "program across the group), pinned to "
                         "the first --precompile manifest signature; "
                         "the elasticity controller chooses the axis "
                         "from measured --profile-dir stage costs")
    fl.add_argument("--state-path", default=None, metavar="FILE",
                    help="arm the continuity snapshot plane: the front "
                         "door periodically writes a crash-consistent "
                         "snapshot (session registry, placement map, "
                         "replica incarnations) here, and orphaned "
                         "workers wait for re-adoption instead of dying "
                         "with a crashed front door")
    fl.add_argument("--resume-state", action="store_true",
                    help="on start, re-adopt still-live replicas and "
                         "their sessions from --state-path (the recovery "
                         "half: a front door killed -9 mid-traffic comes "
                         "back without losing a session)")
    fl.add_argument("--snapshot-interval", type=float, default=1.0,
                    metavar="S", help="continuity snapshot cadence")

    cp = sub.add_parser(
        "camera",  # host-only (no device): the --platform flag would be a no-op
        help="push frames into a shared-memory ring for a serve process")
    cp.add_argument("--shm", required=True, help="shm ring name")
    cp.add_argument("--source", default="synthetic",
                    help="synthetic|webcam|<video path>")
    cp.add_argument("--height", type=int, default=720)
    cp.add_argument("--width", type=int, default=1280)
    cp.add_argument("--frames", type=int, default=300)
    cp.add_argument("--rate", type=float, default=30.0,
                    help="synthetic/file fps; 0 = unthrottled")
    cp.add_argument("--target-size", type=int, default=512)
    cp.add_argument("--queue-size", type=int, default=10,
                    help="ring capacity in frames (drop-oldest beyond)")
    cp.add_argument("--linger-s", type=float, default=20.0,
                    help="after the last frame, wait up to this long for a "
                         "consumer to attach and drain before unlinking "
                         "the shm ring (serve cold-start can take ~10 s)")

    wp = sub.add_parser("worker", parents=[plat, ing, res, obsp],
                        # --flight-dir spelled identically to serve/fleet:
                        # every tier that accepts --metrics-port accepts
                        # the flight flag too (audited in tests/test_cli)
                        help="ZMQ worker for the reference app")
    wp.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="flight recorder: a fatal worker fault dumps "
                         "the bounded post-mortem (trace window + stats "
                         "+ telemetry ring) here — serve/fleet's "
                         "--flight-dir, worker tier")
    wp.add_argument("--trace", action="store_true",
                    help="arm the worker's tracer (bounded ring; exported "
                         "to dvf_worker_timing.pftrace at exit)")
    wp.add_argument("--filter", default="invert")
    wp.add_argument("--filter-config", default=None)
    wp.add_argument("--host", default="localhost")
    wp.add_argument("--distribute-port", type=int, default=5555)
    wp.add_argument("--collect-port", type=int, default=5556)
    wp.add_argument("--batch", type=int, default=8)
    wp.add_argument("--no-jpeg", action="store_true")
    wp.add_argument("--wire", choices=("raw", "jpeg", "delta"), default=None,
                    help="wire mode override (default: jpeg, or raw with "
                         "--no-jpeg). 'delta': temporal-delta wire both "
                         "directions — composite incoming delta frames, "
                         "delta-encode results (host codec cost scales "
                         "with the stream's dirty ratio)")
    wp.add_argument("--delta-keyframe-interval", type=int, default=16)
    wp.add_argument("--delta-tile", type=int, default=32)
    wp.add_argument("--delta-device", action="store_true",
                    help="--wire delta: compute dirty-tile bitmaps on "
                         "DEVICE (runtime.codec_assist.DeviceDeltaProbe) "
                         "instead of the host reduction")
    wp.add_argument("--codec-assist", choices=("none", "probe", "full"),
                    default="none",
                    help="--wire delta: device codec assist tier. 'probe' "
                         "= dirty bitmaps on device (alias of "
                         "--delta-device); 'full' = probe + RGB→YCbCr + "
                         "8×8 DCT + quantization fused into ONE device "
                         "pass per batch — the host entropy-codes int16 "
                         "coefficient blocks and never touches pixels "
                         "(falls back to 'probe' when the native shim "
                         "or the stream geometry cannot serve it)")
    wp.add_argument("--codec-threads", type=int, default=4,
                    help="JPEG codec thread-pool size (encode/decode "
                         "parallelism; also the asynchronous egress "
                         "encode plane's pool)")
    wp.add_argument("--target-size", type=int, default=512)
    wp.add_argument("--delay", type=float, default=0.0,
                    help="fault injection: sleep this many seconds per batch "
                         "(simulate a slow worker, like inverter.py --delay)")
    wp.add_argument("--mesh", default=None,
                    help="device mesh, same forms as serve --mesh")

    tv = sub.add_parser(
        "trace-view",
        help="offline summary of a Perfetto trace or flight dump: "
             "per-lane utilization, slowest spans, slowest frame "
             "lineages — post-mortems without loading Perfetto")
    tv.add_argument("path",
                    help="a .pftrace / Chrome-trace JSON file, or a "
                         "flight-dump directory (meta.json + "
                         "trace.pftrace + lineage.json)")
    tv.add_argument("--top", type=int, default=10,
                    help="rows per section (slowest spans / lineages)")
    tv.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON instead of the text view")

    tp = sub.add_parser("train", parents=[plat], help="train the style net (checkpoint/resume)")
    tp.add_argument("--steps", type=int, default=50)
    tp.add_argument("--batch", type=int, default=4)
    tp.add_argument("--size", type=int, default=64, help="square frame size")
    tp.add_argument("--base-channels", type=int, default=8)
    tp.add_argument("--n-residual", type=int, default=2)
    tp.add_argument("--lr", type=float, default=1e-3)
    tp.add_argument("--seed", type=int, default=0)
    tp.add_argument("--log-every", type=int, default=10)
    tp.add_argument("--checkpoint-dir", default=None)
    tp.add_argument("--checkpoint-every", type=int, default=25)
    tp.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    tp.add_argument("--style", default="stripes",
                    choices=("gray", "stripes", "checker", "noise"),
                    help="style-target preset (textured presets give "
                         "visible stylization; gray was the old default)")
    tp.add_argument("--style-weight", type=float, default=None,
                    help="override StyleTrainConfig.style_weight")

    tsp = sub.add_parser(
        "train-sr", parents=[plat],
        help="train the super-resolution net (self-supervised, "
             "checkpoint/resume)")
    tsp.add_argument("--steps", type=int, default=50)
    tsp.add_argument("--batch", type=int, default=4)
    tsp.add_argument("--size", type=int, default=64,
                     help="square HR frame size (must be divisible by --scale)")
    tsp.add_argument("--scale", type=int, default=2)
    tsp.add_argument("--lr", type=float, default=1e-3)
    tsp.add_argument("--seed", type=int, default=0)
    tsp.add_argument("--log-every", type=int, default=10)
    tsp.add_argument("--checkpoint-dir", default=None)
    tsp.add_argument("--checkpoint-every", type=int, default=25)
    tsp.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    tsp.add_argument("--eval", action="store_true",
                     help="after training, report held-out PSNR vs the "
                          "nearest-neighbor baseline (unseen seed + geometry)")

    bp = sub.add_parser("bench", parents=[plat, ing],
                        help="run a benchmark config")
    bp.add_argument("--config", choices=sorted(BENCH_CONFIGS), default="invert_1080p")
    bp.add_argument("--iters", type=int, default=200)
    bp.add_argument("--frames", type=int, default=512, help="--e2e mode")
    bp.add_argument("--lat-frames", type=int, default=None,
                    help="--e2e: frames for the rate-controlled latency "
                         "leg (default ≈20 s at the measured rate; 0 "
                         "skips the leg)")
    bp.add_argument("--batch", type=int, default=None)
    bp.add_argument("--e2e", action="store_true")
    bp.add_argument("--collect-mode", choices=("thread", "inline"),
                    default="inline",
                    help="e2e pipeline collect mode")
    bp.add_argument("--transport", choices=("python", "ring"), default="python",
                    help="--e2e ingest transport (ring = native C++ ring)")
    bp.add_argument("--mesh", default=None,
                    help="device mesh, same forms as serve --mesh")
    bp.add_argument("--wire", choices=("raw", "jpeg", "delta"), default="raw",
                    help="--e2e ring payload format (jpeg measures the "
                         "codec-on-the-hot-path cost; delta the "
                         "temporal-delta wire over it; both need libjpeg "
                         "and exit 2 without it)")
    bp.add_argument("--motion", choices=("roll", "block", "none"),
                    default="roll",
                    help="--e2e synthetic stream motion: 'roll' = every "
                         "pixel changes per frame (full-motion worst "
                         "case), 'block' = webcam-like low motion (the "
                         "delta wire's target regime), 'none' = static")

    args = ap.parse_args(argv)
    prior = os.environ.get("DVF_FORCE_PLATFORM")
    if getattr(args, "platform", None):
        # Flag form of DVF_FORCE_PLATFORM: _force_platform (and every
        # probe subprocess inheriting the env) picks it up. Restored
        # after dispatch so in-process callers (tests, embeddings) don't
        # leak the forced platform into later invocations.
        os.environ["DVF_FORCE_PLATFORM"] = args.platform
    try:
        return {
            "filters": cmd_filters, "doctor": cmd_doctor,
            "serve": cmd_serve, "worker": cmd_worker, "fleet": cmd_fleet,
            "camera": cmd_camera, "trace-view": cmd_trace_view,
            "subscribe": cmd_subscribe, "train": cmd_train,
            "train-sr": cmd_train_sr, "bench": cmd_bench,
        }[args.cmd](args)
    except PlatformError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if getattr(args, "platform", None):
            if prior is None:
                os.environ.pop("DVF_FORCE_PLATFORM", None)
            else:
                os.environ["DVF_FORCE_PLATFORM"] = prior


if __name__ == "__main__":
    sys.exit(main())
