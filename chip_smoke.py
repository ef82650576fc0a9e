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
   4 x 360 x 640 x 5, the inner warp) and at ragged, smaller-than-a-tile,
   C = 1 and 8, offset-base and large-R cases, in both of its designs,
   bit-exact (0 differing elements); the codec
   kernels bit-exact (0 differing elements): tile_maxdiff at (2,68,40,3)
   tile 16, (2,68,40,1) tile 8, (8,512,512,3) and (16,1080,1920,3) tile 32,
   dct8x8_quant on uint8 and float32 (2,52,100) planes at q90, uint8
   (8,512,512) and (8,256,256) at q 50/90/95/100 and (4,720,1280) at q90,
   and its three-plane launch (dct8x8_quant_planes, one launch each) at
   the wire's Y/Cb/Cr shapes and a ragged set, uint8 and float32, at q
   50/90/95/100.
   TF32 is off for every plain or library call. The three stencil
   kernels also at frames larger than one tile with ragged edges, on a
   view whose base is not 16-byte aligned, at their largest C = 4 case
   (31 taps, d = 15) and in each compiled and the runtime-size
   instantiation. The style nets' bias + instance norm + ReLU + residual
   kernels (csrc/norm.cu) against their plain ops at the style stream's
   three norm geometries (``check_norm``), and their out stage's conv +
   bias + tanh kernel (csrc/outconv.cu) at the stream's shape and at
   ragged ones (``check_outconv``). The neural nets (cuDNN convs;
   the style net's norms through csrc/norm.cu, its out stage through
   csrc/outconv.cu): the port's trained
   checkpoints style_stripes_64 and sr2x_64 on the card in
   bfloat16 against the JAX package's goldens (tests/golden/, mean |d| <
   2.0 and max <= 30, their tests' bar), and in float32 against the CPU
   within 1e-4;
4. CUDA-event times (median of 20 runs after warm-up) of each kernel, its
   plain version and, where one PyTorch call computes the same function
   (the separable blur's depthwise convolutions, the warp's grid_sample),
   that call as a yardstick; the device time per call from a
   torch.profiler window beside them (for the warp, at both of its
   shapes and in both designs, with the inputs warm in L2 as on the flow
   path and with L2 flushed; for the warp and the codec kernels, whose
   launch outlasts their work, the device time is the reported time);
   the bound each kernel could reach; for the stencil kernels also the
   share of that bound, the achieved GB/s, the instantiation timed, the
   SM clock and power draw read right after the timing loop, and the
   device time of a plain copy of the same batch (a practical floor);
5. the main paths, each driven with the launch counters set to 0 just
   before and read just after. First each leg engine's compile-time
   calibrations (h2d_block_ms, d2h_block_ms, step_block_ms,
   last_compile_ms) and, on the gaussian_blur engine, its other entries:
   submit_resident and run_probe byte-identical to submit, run_probe
   refusing flow_warp, out_uint8=False within 1e-5 of the plain float
   version. Then 1080p batch-16 Pipelines for invert,
   gaussian_blur(k=9), bilateral and sobel_bilateral, each with ingest and
   egress "streamed" (the default) and again "monolithic", the delivered
   frames byte-identical between the two, each run's ingest/egress stats
   printed (mode, fallback reason, overlap efficiency, pool allocations,
   stage/put/wait/copy ms); on the streamed invert leg the cudaMalloc
   segments and pinned host allocations read at the sink after batch 3
   and after the run must agree; and 720p batch-4
   Pipelines for flow_warp() and flow_warp(inner_warp="pallas"), all with
   impl=None (the kernels). Every kernel of a leg must have launched its
   expected count per batch and no other kernel at all; frames must come
   in order, all of them, within 1 LSB of the plain version (for the flow
   legs: of the same stream computed on the card with the plain warp, the
   state carried across the same batches). Then a resilient 1080p invert
   leg under a seeded FaultPlan (three h2d and three d2h raises, fault
   budget 2): both sides must degrade to monolithic with their reasons,
   the other 96 frames delivered in order and exact; and the
   gaussian_blur leg traced (trace=True), its per-batch spans
   ingest_stage, ingest_h2d, ingest_overlap, egress_d2h and
   batch_complete printed. Then the delta-wire worker on
   160 frames of SyntheticSource(512, 512, motion="block"), invert, batch
   8, tile 32, q90, keyframe every 16: its batch step driven without
   sockets (ZmqWorker(connect=False)), codec_assist "full" and "probe" on
   the JPEG delta wire where libjpeg is present; where it is not, "probe"
   on the raw-inner delta wire and an Engine -> FusedDeltaTransform leg
   (K5 and K6 without the entropy stage), ingest and egress at their
   defaults (the modes the card picks printed). Every index once and in order,
   K5 one launch and K6 one per batch where the leg runs them and no
   other kernel, and every payload (or dirty coefficient block) identical
   to the same stream recomputed on the card with the plain versions.
   Then the neural filters and the rest of the registry, 64 frames each
   in full batches: style_transfer() (c 32, r 5, bf16) at 8 x 720 x
   1280 (BASELINE configs[4]) and again with fast_convs=True (an A/B
   row), each batch 15 instance_norm launches (csrc/norm.cu), one
   out_conv launch (csrc/outconv.cu; none with fast_convs) and no
   other kernel; super_resolution() (x2, bf16) at 8 x 540 x 960 (1080p
   out), and equalize, clahe and canny at 16 x 1080 x 1920, every launch
   count 0; every frame in order,
   the first batch within 1 LSB of a direct filt.fn call on the card,
   the classical ops' kept frames bit-exact to the CPU;
7. the multi-tenant serving frontend (legs (a)-(e) of ``serve_phase``);
8. the supervised rebuild and the worker's wire (``ring_phase``): (a) a
   ServeFrontend of sobel_bilateral at 4 x 1080 x 1920, fault_budget 2,
   whose live step is replaced after two healthy batches by one that
   raises: exactly one recovery, faults {"compute": 3}, frames 0, 1 and 5
   delivered within 1 LSB of the plain version, K3 launched twice per
   compile plus once per delivered batch, the rebuild's compile_aside_ms
   and stall_ms printed; (b) 1080p batch-16 Pipelines of invert and
   sobel_bilateral fed through a raw RingFrameQueue (ingest/egress
   streamed and monolithic) beside the DropOldestQueue leg of the same
   shape and bound, and invert again over a ring of the default 10
   frames: every delivered index in order, each frame exact (invert) or
   within 1 LSB of the plain version of its own index, ring drops, fps
   and the host's load printed, the streamed pair timed queue, ring,
   ring, queue, and the ring's host copies per frame timed alone; (c)
   the phase-5 worker setup with
   transport="ring" (frames staged by ``ZmqWorker.receive`` into the
   native ring), codec_assist "probe" on the raw-inner delta wire and,
   where libjpeg or cv2 is present, on the JPEG delta wire: K5 once per
   batch, every payload identical to the same stream through
   transport="list", timed list, ring, ring, list after one uncounted
   pass;
9. the observability planes (``planes_phase``): (a) audit (every 8th
   staged frame replayed through the eager golden on the bucket's
   device, on the plane's own stream) and lineage on phase 7 (a)'s mix
   with the flight recorder armed and a torch.profiler window over the
   drive: 0 confirmed corruptions, every sampled frame replayed, K1 and
   K3 launched once per serving batch of their bucket plus once per
   replay of it, every delivered frame's lineage components summing to
   its latency within 1e-6 ms, explain naming a dominant component,
   /audit and /explain answering with the reference's keys, the serving
   busy share; (b) corrupt_device on every 2nd collected batch, every
   frame replayed, each round submitted with the dispatch thread parked:
   confirmed corruptions on the row-0 sessions only, classified
   integrity, the other sessions bit-identical to (a), a flight dump with
   audit.json and lineage.json that ``obs.viewer.summarize_dump`` reads;
   (c) a resize and a direct ``_recover`` rebuild of the 1080p
   sobel_bilateral bucket, each with a swap_guard verdict "match" and
   the old program's probe row matching; (d) the phase-5 worker with
   audit_wire over the list and the ring (payloads, stripped,
   byte-identical to the unaudited run), then corrupt_wire on both stamp
   sides of the raw wire (each flip caught at its hop); (e) the 1080p
   sobel_bilateral pipeline (160 frames) with trace=True and
   device_trace_dir: the merged host+device file, every K3 event inside
   a host batch span, the busy share; (f) fps with the planes off, on,
   on, off (the (a) mix) and the trace off, on, on, off ((e)'s leg), and
   the blake2b time per 1080p frame;
10. the control plane, auto-plan and broadcast (``control_phase``): (a)
   a batch-16 frontend with the control plane armed (its controllers
   idle) serving 2 sobel_bilateral and 1 gaussian_blur(ksize=9) sessions
   at 1080p, 96 frames each, one sobel_bilateral session downshifted for
   frames 32-63: every frame in order at full size within 1 LSB of the
   plain full program, or of the plain frame[::2, ::2] -> program ->
   nearest x2 while downshifted; the downshift a pool hit on the program
   warmed at admission; K3 launched at 540 x 960; (b) the default
   ControlConfig over 6 sobel_bilateral sessions offered 60 frames/s each
   under a 150 ms SLO: the plane sampled, no hook or apply raised, every
   delivered frame in order, full size and within 1 LSB of the program
   the ledger's rebinds say served it; then a tier floor of 1 refuses a
   tier-2 open and admits a tier-0 one; (c) auto-plan of a batch-8
   gaussian_blur(ksize=9) frontend (45 candidates, at most 15 searched)
   into a fresh plan cache, a second frontend's cache hit and seeded
   compile, the fingerprint naming the card, a CPU entry missing; (d)
   (a)'s moving session published on three raw tiers to 64 subscribers,
   one that never drains and a relay, audit stamps on: one encode per
   lane per frame, the slow one evicted, payloads byte-identical to the
   delivered frames downscaled, the relay verbatim; and one session's fps
   with publishing off, on, on, off;
11. the fleet tier (``fleet_phase``), 1080p at batch 16: (a) a local
   fleet of 2 replicas sharing the card serving 2 sobel_bilateral and 2
   gaussian_blur(ksize=9) sessions, 32 frames each, placed on both
   replicas, every frame in order within 1 LSB of the plain version,
   K1/K3 launched once per batch of their buckets; beside one
   ServeFrontend serving the same mix (single, fleet, fleet, single), and
   the fleet's /metrics scrape (merged p50/p99, per-replica labels); (b)
   2 process replicas on the card serving sessions A and B
   (sobel_bilateral), fault-free and with B's replica SIGKILLed after
   frame 10: A bit-identical to the fault-free run, B migrated and
   monotone, the victim restarted and healthy, a new session served; each
   child's spawn-to-ready ms and the RPC ms per 1080p frame; (c) a local
   fleet's warm standby taken by spawn_replica() beside a cold spawn,
   each timed to its first frame, retire_replica() migrating the spawned
   replica's session, memory_allocated back after the retire and after
   stop(); (d) 3 local replicas warm on the sobel_bilateral signature: a
   divergence check matching with 3 probed (K3 once per replica), then a
   rigged replica outvoted, quarantined and retired; (e) a process fleet
   with a state file crash()ed and a resume_state front door adopting its
   live worker and session;
12. the command line (``cli_phase``), each leg through
   ``dvf_tpu_torch.cli.main`` in this process where its launches are
   counted, and through ``python -m dvf_tpu_torch`` where the process
   boundary is the point: (a) ``serve`` of sobel_bilateral and of
   gaussian_blur(ksize=9) at 1080p batch 16, 160 frames: all delivered,
   the kernel launched once per device batch besides its compile's
   warm-up and calibration launches (counted apart) and no other kernel;
   again with ``--display --headless``, every frame the sink composes in
   order and within 1 LSB of the plain version; the fps beside phase 5's
   Pipeline leg; (b) ``serve --sessions 4`` of gaussian_blur(ksize=9) at
   1080p, 32 frames each: every session's deliveries complete, in order
   and within 1 LSB, K1 once per batch, the reference's per-session keys;
   (c) ``camera --shm`` -> ``serve --source shm:NAME --transport ring``,
   two processes at 1080p with sobel_bilateral (the ring sized to
   /dev/shm): delivered = pushed - drops, each process's start-up (torch
   import, CUDA context, kernel load from the build cache) and first
   frame timed; (d) ``python -m dvf_tpu_torch worker`` with
   gaussian_blur(ksize=9) on the raw wire at 512 x 512, against a small
   app on the reference's socket pair: every frame back within 1 LSB,
   SIGTERM's stats line and rc 0; (e) ``fleet --mode local --replicas 2
   --sessions 4`` of sobel_bilateral at 1080p: both replicas used, no
   order violation or loss, K3 once per replica batch; (f) ``doctor``
   (a CUDA backend of one H100, the ring shim built, the JPEG shim's
   status printed) and ``filters`` as processes; (g) ``serve
   --compile-cache-dir`` twice on a fresh directory: the three kernel
   libraries built there, then loaded with 0.0 s of build, the default
   build directory untouched; (h) ``trace-view`` of a traced (a) run's
   host trace and merged host + device trace; (i) where cv2 and a
   surfaceless EGL are present, ``serve --source <video file>`` and
   ``--display-backend gl``;
13. training (``train_phase``), no hand kernel on its path (the style
   net's norms and out stage take their plain ops under autograd; the
   only launches are (d)'s serving's, 15 instance_norm and one out_conv
   a forward): (a) the default StyleTrainConfig (the style net at c
   32, r 5, the VGG encoder at its default blocks, bf16) on one batch of
   8 x 256 x 256 SyntheticSource frames with the stripes target, 30
   steps with an AsyncSaver checkpoint at step 15: every loss finite and
   the last below the first, the median step ms over steps 5-30 (CUDA
   events), a torch.profiler window of 5 steps (device ms and kernels
   per step, busy share, top kernels), the share of the step's bound
   (bf16 tensor-core MACs, float32 Gram MACs, bytes), then the final
   checkpoint; (b) one float32 step of each family at 2 x 64 x 64 on the
   card and on the CPU from the same state and batch, cuDNN's TF32
   switched on globally: the loss, every gradient leaf (<= 1e-4 of its
   largest element) and the params after the step; (c) the default
   SrTrainConfig (ESPCN x2) on 16 structured 128 x 128 HR frames, 30
   steps: the loss falls, the PSNR rises, step ms, profile, bound; (d)
   (a)'s two checkpoints restored onto templates from another seed: the
   steps, params bitwise, one more step against the uninterrupted run's,
   and the trained weights through ``load_style_filter`` and an Engine
   at 8 x 720 x 1280, within 1 LSB of a direct call, the served batch 15
   instance_norm launches and one out_conv; (e) ``python -m
   dvf_tpu_torch train`` (4 steps, checkpoints every 2, then resumed to
   6) and ``train-sr`` (4 steps with --eval; 0 steps from the committed
   sr2x_64 state with --eval, delta > 2.5 dB) as processes on cuda:0;
14. the bench harness (``bench_phase``): (a) ``bench --config C --iters
   30`` through ``dvf_tpu_torch.cli.main`` for each of the 8 BENCH_CONFIGS
   entries at their own shapes: the JSON line with its H100 roofline
   fields (``hbm_roofline_frac`` and ``mfu`` each <= 1.0: above it the
   count behind ``Engine.cost_analysis`` is wrong), K1 (gauss9_1080p), K3
   (sobel_bilateral_1080p) and K4 (flow_720p) once per device batch and
   instance_norm (style_720p) 15 times per batch and out_conv once, besides their
   compiles' launches, and no other kernel, then one batch
   of each config through an Engine within 1 LSB of its plain version,
   and K1 at 3 taps (its run-time-tap instantiation) at gauss3_1080p's
   shape within 1e-5 (gauss3_1080p itself runs plain torch ops: blurs
   under 9 taps resolve there); (b) ``bench --e2e`` (throughput, then
   the rate-controlled latency leg) of invert_1080p and gauss9_1080p at
   batch 16, 320 + 160 frames, over the python queue and the ring's raw
   wire (where libjpeg is present also the delta and jpeg wires; where
   it is not, both exit 2 and say why), K1 once per engine batch; (c)
   ``bench_transfer`` at 16 x 1080 x 1920 (pinned host memory) and
   ``bench_stage_decomposition`` of invert at 1080p, batches 1, 2, 4,
   without the encode leg (which must raise without libjpeg); (d)
   ``fleet --scaling --sessions 2`` at its defaults (256², the 3-deep
   gaussian_blur chain) in local mode (K1 three times per batch) and in
   process mode, every frame of every round delivered, the host's
   parallel capacity beside the ratio; (e) ``python -m
   dvf_tpu_torch.bench_child`` ``--mode probe --platform cuda`` (backend
   cuda, probe_sum 28.0) and ``--mode device``; (f) ``models.analysis``
   of style_720p and sr2x_540p with (a)'s measured ms per frame: the gap
   to each net's per-layer H100 bound;
15. the in-host mesh (``mesh_phase``): (a) ``make_mesh()`` over the
   visible cards, K1-K3 at 16 x 1080 x 1920 through ``Engine(mesh=)``
   bit-exact against ``Engine(device="cuda:0")``, fps of both; (b)
   ``data=2, space=4`` and ``space=8`` meshes of cuda:0 eight times, K1-K3
   routed through the halo exchange, bit-exact against the unsharded
   engine with one launch per block per batch, the step's ms per batch
   beside the unsharded engine's; (c) ema_smooth with H sharded on
   ``data=2, space=4`` within 1 level of one device, flow_warp at
   4 x 720 x 1280 per data block with H whole, bit-exact, K4 once per
   data block; (d) equalize on ``space=4``, bit-exact; (e) the style net
   (c 32, r 5) at 8 x 720 x 1280 with TP on ``model=2`` and PP on
   ``model=5``, ESPCN x2 TP on ``model=2`` at 8 x 540 x 960: in float32
   within 3 levels (TP) / 1 (PP) of the unsharded net, in bfloat16 within
   the bf16 nets' bar (mean < 2.0, max <= 30), and at the tests' own
   small sizes in bfloat16 within 3 / 1; each sharded style batch runs
   instance_norm 15 times a TP rank, and for PP 5 times plus 10 a
   microbatch and out_conv once on stage 0 (bf16, c 32), and no other
   kernel; (f) ``serve --mesh data=1`` and ``bench
   --mesh auto`` through ``cli.main``, ``serve --mesh data=2`` as a
   process (exit 2 on one card: needs 2 devices, has 1), and a 2-replica
   local fleet with ``devices_per_replica=0`` (both replicas on cuda:0)
   delivering every frame;
16. the multi-process runtime (``multiproc_phase``): (a) a 2-rank gloo
   group on the card (both ranks on cuda:0, each its own process) running
   ``MultiHostEngine`` with gaussian_blur(ksize=9) and sobel_bilateral at
   the global 16 x 1080 x 1920 batch, 8 rows per rank, every rank's rows
   bit-exact (row digests) to the single-process engine, K1/K3 once per
   rank per batch, ms per step and the lockstep all_reduce's ms; (b) the
   elastic kill: rank 1 exits at step 3 of 8, rank 0 degrades to its
   local mesh with its rows at every step bit-exact to one process, and
   the time from the exit to the degrade; (c) ``FleetFrontend(
   multihost_hosts=2)`` at 1080p: spawn-to-ready ms, 32 frames of invert
   and of gaussian_blur(ksize=9) through the group, in order and
   bit-exact, retire draining back to r0; (d) the delta-wire worker over
   ``[cuda:0]*2`` meshes (data=2; data=2, space=2) at 512² batch 8, 160
   frames: the probe's payloads and Engine → FusedDeltaTransform's
   bitmaps and coefficient blocks identical to one device, K5/K6 once per
   block per batch (the kernels line carries the rank and per-block
   counts);
17. the sharded train state (``train_mesh_phase``): (a) the default
   style train config (c 32, r 5, bf16) at 8 x 256 x 256 on
   ``[cuda:0]*8`` (data=2, space=2, model=2) and ``[cuda:0]*2``
   (model=2), and (b) ESPCN x2 at 16 x 128 x 128 HR on model=2 and
   data=2, each against the one-device step from the same state: step
   1's loss within 5e-3 relative, Adam's first moment (the bf16 gap
   recorded, no weight scaled by the model axis), every copy of a block
   bit-identical, ms per step against one device's over 10 steps; (c)
   the model=2 state saved, restored onto the mesh, and one more step of
   both bit for bit (cuDNN's deterministic algorithms), its ``.npz``
   members equal to the whole state's; (d) ``dvf_tpu_torch.dryrun``:
   ``entry()`` and ``dryrun_multichip(8)`` on ``[cuda:0]*8``, K3 and K4
   launches per sub-check; (e) ``Engine(gaussian_blur(ksize=9))`` with
   neither device nor mesh at 16 x 1080p bit-equal to
   ``device="cuda:0"``, K1 once per batch; (f) ``python -m
   dvf_tpu_torch train --steps 4 --batch 2`` as a process;
6. a coarse split of a pipeline batch: the engine alone (pinned H2D,
   filter, D2H, back to back) against the host copies the pipeline adds
   (frames into a pinned slot, rows out of it); for the flow, style and
   SR legs also a torch.profiler window: the card's busy share, its
   device time and kernels per batch and the top kernels; for the style
   and SR legs also their bound (FLOP at the bf16 tensor-core peak).

Phase 2 also prints the static SASS of the stencil kernels' main-path
instantiations, the warp kernels at C = 3 and 5 and the codec kernels'
uint8 instantiations (``cuobjdump -sass``: instruction count, opcode
histogram, innermost loops); ``sass_of(path)`` does the same for any of
those sources, e.g. an older checkout's. ``warp_times_of(checkout)`` and
``dct_times_of(checkout)`` print another checkout's K4 and K6 device
times through its own wrappers, ``neural_times_of(checkout)`` its style
and SR batches' device times; ``serve_only()``, ``ring_only()``,
``planes_only()``, ``control_only()``, ``fleet_only()``, ``cli_only()``
``train_only()``, ``bench_only()``, ``mesh_only()``, ``multiproc_only()``
and ``train_mesh_only()`` run the build and phase 7, 8, 9, 10, 11, 12,
13, 14, 15, 16 or 17 alone, ``norm_only()`` the build and the style nets'
instance-norm kernels (``check_norm``, part of phases 3-4),
``outconv_only()`` the build and their out stage's kernel
(``check_outconv``, part of phases 3-4); ``mp_rank(argv)`` is one rank of phase 16's group. The bounds and counts come from the package's
counters (``dvf_tpu_torch.runtime.cost``), the ones ``Engine.cost_analysis``
and the bench's roofline read.

Output: human-readable lines, then ``{"pipeline": [...]}``, ``{"serve":
[...]}``, ``{"ring": [...]}``, ``{"planes": [...]}``, ``{"control":
[...]}``, ``{"fleet": [...]}``, ``{"cli": [...]}``, ``{"train": [...]}``,
``{"bench": [...]}``, ``{"mesh": [...]}``, ``{"multiproc": [...]}``,
``{"train_mesh": [...]}``,
``{"stages": [...]}``, ``{"neural_checks": {...}}``, ``{"engine_checks": {...}}``
and ``{"kernels": [...]}`` lines, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

TOL = 1e-5
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
# The inner warp's coarser pyramid levels (flow_warp's pyr_scale 0.5): each
# of the three levels takes n_iters = 3 launches per batch.
COARSE_SHAPES = ((4, 180, 320, 5), (4, 90, 160, 5))
REPS = 20
SOURCE = "dvf_tpu_torch/csrc/stencils.cu"
WARP_SOURCE = "dvf_tpu_torch/csrc/warp.cu"
CODEC_SOURCE = "dvf_tpu_torch/csrc/codec.cu"
# The delta-wire worker (the reference webcam app's 512² crop, low motion):
# invert, batch 8, tile 32, JPEG quality 90, keyframe every 16 frames.
WIRE_SIZE, WIRE_FRAMES, WIRE_BATCH, WIRE_TILE = 512, 160, 8, 32
WIRE_QUALITY, WIRE_KEY = 90, 16
# The neural filters and the rest of the registry (no hand kernel on their
# path but the style net's norms, STYLE_NORMS launches a batch): style
# transfer at BASELINE configs[4] (720p, batch 8; the JAX
# package's style_720p / style_fast_720p shape), ESPCN x2 at 540p batch 8
# (its sr_fast_540p shape, 1080p out), equalize / clahe / canny at
# MAIN_SHAPE. The style net also with fast_convs=True, as an A/B row.
STYLE_SHAPE = (8, 720, 1280, 3)
SR_SHAPE = (8, 540, 960, 3)
REGISTRY_FRAMES = 64
# The style net's (c 32, r 5) instance norms a forward: stem, down1,
# down2, two a residual block, up1, up2. Each is one call of
# csrc/norm.cu's kernels, counted once as "instance_norm". Its out stage
# (bf16, unsharded, without fast_convs) is one launch of csrc/outconv.cu,
# "out_conv".
STYLE_NORMS = 3 + 2 * 5 + 2
STYLE_LAUNCHES = {"instance_norm": STYLE_NORMS, "out_conv": 1}
REGISTRY_LEGS = [("style_transfer", {}, STYLE_SHAPE),
                 ("style_transfer", {"fast_convs": True}, STYLE_SHAPE),
                 ("super_resolution", {}, SR_SHAPE),
                 ("equalize", {}, MAIN_SHAPE),
                 ("clahe", {}, MAIN_SHAPE),
                 ("canny", {}, MAIN_SHAPE)]
CLASSICAL = ("equalize", "clahe", "canny")


def log(msg: str) -> None:
    print(msg, flush=True)


def _cost():
    """The package's work counters and H100 peaks
    (``dvf_tpu_torch.runtime.cost``): one copy serves this script's
    bounds and the bench's roofline (``Engine.cost_analysis``). Every
    entry point puts the checkout on the path before it counts."""
    from dvf_tpu_torch.runtime import cost

    return cost


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def smi_sample() -> str:
    """SM clock and power draw now, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


_SASS_OPS = ("FFMA", "FMUL", "FADD", "MUFU", "LDS", "STS", "LDG", "STG", "LDC",
             "IMAD", "IADD3", "ISETP", "SEL", "IMNMX", "BRA", "I2F", "F2I", "FRND",
             "PRMT", "MOV", "LDL", "STL")
# Itanium codes of the template type arguments the kernels take.
_TYPE_CODES = {"h": "unsigned char", "f": "float"}


def _demangle(sym: str) -> str:
    """``...15sep_blur_kernelILi3ELi9ELi9EE...`` -> ``sep_blur_kernel<3,9,9>``,
    ``...19dct8x8_quant_kernelIhEE...`` -> ``dct8x8_quant_kernel<unsigned char>``."""
    m = re.search(r"(sobel_bilateral_kernel|bilateral_kernel|sep_blur_kernel|"
                  r"warp_bounded_kernel|warp_window_kernel|warp_gather_kernel|"
                  r"tile_maxdiff_kernel|dct8x8_quant_kernel)"
                  r"(I(?:Li-?\d+E|[hf])+E)?", sym)
    if not m:
        return sym
    args = [n or _TYPE_CODES[c]
            for n, c in re.findall(r"Li(-?\d+)E|([hf])", m.group(2) or "")]
    return m.group(1) + ("<" + ",".join(args) + ">" if args else "")


def _histogram(ops) -> dict:
    hist = {k: 0 for k in _SASS_OPS}
    for op in ops:
        base = op.split(".")[0]
        if base in hist:
            hist[base] += 1
        else:
            hist["other"] = hist.get("other", 0) + 1
    return {k: v for k, v in hist.items() if v}


def sass_report(binary: str, keep=None) -> dict:
    """Static SASS of each kernel in a built library or cubin: its
    instruction count, opcode histogram and innermost loops (a backward
    branch and the instructions from its target to it, holding no other
    loop). ``keep(name)`` selects the kernels. None where the toolkit has
    no cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(os.path.realpath(_nvcc())), "cuobjdump")
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", binary], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _demangle(m.group(1))
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                     r"([^;]*);", line)
        if m and name is not None:
            kernels[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    report = {}
    for name, insns in kernels.items():
        if keep is not None and not keep(name):
            continue
        loops = []
        for addr, op, args in insns:
            t = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        inner = [(a, b) for a, b in loops
                 if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
        report[name] = dict(
            instructions=len(insns), ops=_histogram(op for _, op, _ in insns),
            inner_loops=[dict(instructions=sum(a <= x <= b for x, _, _ in insns),
                              ops=_histogram(op for x, op, _ in insns if a <= x <= b))
                         for a, b in inner])
    return report


def _nvcc() -> str:
    from dvf_tpu_torch.ops import _build

    return _build.nvcc_path()


def sass_of(source: str) -> None:
    """Build a stencil, warp or codec source to a cubin with the port's
    nvcc flags and print the SASS report of its main-path kernels (for
    comparing an older design: ``python3 -c 'import chip_smoke;
    chip_smoke.sass_of("old/stencils.cu")'``)."""
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([_nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-o", cubin, source], check=True,
                       timeout=600)
        log_sass(source, sass_report(cubin, _main_path_kernel))


_WARP_TIMES = """
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("cs", {script!r})
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
from dvf_tpu_torch.ops import kernels as tk
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
flush = torch.empty(32 * 1024 * 1024, device=dev)
for shape, r, scale in ((cs.FLOW_SHAPE, cs.MAX_DISP, 12.0),
                        (cs.INNER_SHAPE, cs.INNER_DISP, 6.0),
                        *((c, cs.INNER_DISP, 6.0) for c in cs.COARSE_SHAPES)):
    img = torch.rand(shape, generator=gen, device=dev)
    flow = (torch.rand(shape[:3] + (2,), generator=gen, device=dev) - 0.5) * scale
    kern = lambda _: tk.warp_bounded_pallas(img, flow, r)
    warm, n = cs.profiled_ms(kern, None)
    cold = cs.profiled_ms(kern, None, match="warp_", between=flush.zero_)[0]
    print(json.dumps(dict(checkout={checkout!r}, shape=list(shape), r=r,
                          device_ms_warm=warm, device_ms_cold=cold,
                          kernels_per_call=n, call_ms=cs.cuda_ms(kern, None))))
"""


def warp_times_of(checkout: str) -> None:
    """Print the device times (torch.profiler; warm, and with L2 flushed)
    of a checkout's bounded-warp kernel at the final warp's shape and the
    inner warp's three levels, called through that checkout's own wrapper,
    e.g. an older
    design: ``python3 -c 'import chip_smoke;
    chip_smoke.warp_times_of("old")'``."""
    out = subprocess.run(
        [sys.executable, "-c", _WARP_TIMES.format(script=os.path.abspath(__file__),
                                                  checkout=checkout)],
        cwd=checkout, capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"warp_times_of({checkout!r}) failed:\n{out.stderr}")
    for line in out.stdout.splitlines():
        log(f"warp times {line}")


_DCT_TIMES = """
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("cs", {script!r})
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
from dvf_tpu_torch.ops import kernels as tk
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
n, b, q = cs.WIRE_SIZE, cs.WIRE_BATCH, cs.WIRE_QUALITY
planes = [torch.randint(0, 256, s, generator=gen, device=dev, dtype=torch.uint8)
          for s in ((b, n, n), (b, n // 2, n // 2), (b, n // 2, n // 2))]
tables = (tk.jpeg_quant_table(q), *(tk.jpeg_quant_table(q, chroma=True),) * 2)
one = getattr(tk, "dct8x8_quant_planes", None)
def batch(_):   # the fused transform's K6 work for one batch
    if one is not None:
        return one(planes, tables)
    return [tk.dct8x8_quant_pallas(p, t) for p, t in zip(planes, tables)]
res = dict(checkout={checkout!r})
for key, x, t in (("luma", planes[0], tables[0]), ("chroma", planes[1], tables[1])):
    res[key + "_ms"] = cs.profiled_ms(lambda _: tk.dct8x8_quant_pallas(x, t), None,
                                      match="dct8x8")[0]
res["batch_ms"], res["batch_launches"] = cs.profiled_ms(batch, None, match="dct8x8")
res["batch_call_ms"] = cs.cuda_ms(batch, None)
print(json.dumps(res))
"""


def dct_times_of(checkout: str) -> None:
    """Print the device times (torch.profiler) of a checkout's 8×8
    DCT+quant kernel at the delta wire's luma (8×512×512) and chroma
    (8×256×256) uint8 planes at q90, and of one fused batch's K6 work (Y,
    Cb and Cr, through that checkout's own wrappers); e.g. an older
    design: ``python3 -c 'import chip_smoke;
    chip_smoke.dct_times_of("old")'``."""
    out = subprocess.run(
        [sys.executable, "-c", _DCT_TIMES.format(script=os.path.abspath(__file__),
                                                 checkout=checkout)],
        cwd=checkout, capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"dct_times_of({checkout!r}) failed:\n{out.stderr}")
    for line in out.stdout.splitlines():
        log(f"dct times {line}")


_NEURAL_TIMES = """
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("cs", {script!r})
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
import dvf_tpu_torch
dev = torch.device("cuda", 0)
for name, kw, shape in cs.REGISTRY_LEGS[:3]:
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), device=dev)
    frames = torch.randint(0, 256, shape, dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0)).pin_memory()
    eng.compile(shape)
    eng.submit(frames).fetch()
    x = frames.to(dev)
    def step():
        for _ in range(5):
            eng._step(x, eng._state)
    p = cs.profile_call(step, 5)
    print(json.dumps(dict(checkout={checkout!r}, filter=cs.registry_label(name, kw),
                          device_ms=p["device_ms_per_batch"],
                          kernels=p["device_kernels_per_batch"],
                          top=p["top_device_ms_per_batch"])))
"""


def neural_times_of(checkout: str) -> None:
    """Print the device time per batch (torch.profiler) of a checkout's
    style_transfer() (and with fast_convs=True) at STYLE_SHAPE and
    super_resolution() at SR_SHAPE, the engine's on-card step alone (cast,
    filter, cast back; no copies), through that checkout's own filters:
    ``python3 -c 'import chip_smoke; chip_smoke.neural_times_of("old")'``."""
    out = subprocess.run(
        [sys.executable, "-c", _NEURAL_TIMES.format(script=os.path.abspath(__file__),
                                                    checkout=checkout)],
        cwd=checkout, capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"neural_times_of({checkout!r}) failed:\n{out.stderr}")
    for line in out.stdout.splitlines():
        log(f"neural times {line}")


def _main_path_kernel(name: str) -> bool:
    # the C = 3 instantiations of K1 and K2, K3's at d = 5 (an older
    # K3 is one kernel), the warp kernels at C = 3 (final warp) and C = 5
    # (inner warp), K5's 16-byte chunks and K6's uint8 planes
    if name in ("tile_maxdiff_kernel<16>", "dct8x8_quant_kernel<unsigned char>"):
        return True
    if name.startswith(("sep_blur_kernel", "bilateral_kernel")):
        return re.search(r"<3[,>]", name) is not None
    if name.startswith("sobel_bilateral_kernel"):
        return name in ("sobel_bilateral_kernel", "sobel_bilateral_kernel<3,2>")
    return name.startswith("warp_") and re.search(r"<[35]>", name) is not None


def log_sass(what: str, report) -> None:
    if report is None:
        log(f"sass {what}: not read (no cuobjdump in the toolkit)")
        return
    for name, r in report.items():
        log(f"sass {what} {name}: {r['instructions']} instructions {json.dumps(r['ops'])}; "
            f"innermost loops {json.dumps(r['inner_loops'])}")


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


def profiled_ms(fn, x, reps: int = REPS, match=None, between=None):
    """Device time and device kernels per call of ``fn(x)`` from a
    torch.profiler window over ``reps`` calls after warm-up. Unlike
    ``cuda_ms`` it leaves out the gaps in which the card waits for the
    host to launch. ``between()`` runs before each call (an L2 flush);
    ``match`` keeps only the device entries whose name holds it."""
    for _ in range(3):
        fn(x)

    def run():
        for _ in range(reps):
            if between is not None:
                between()
            fn(x)

    p = profile_call(run, reps, match)
    return p["device_ms_per_batch"], p["device_kernels_per_batch"]


PROFILE_RETRIES = [0]   # profiler windows taken again, over the run
PROFILE_ATTEMPTS = 4    # windows tried before a kernel's time is given up


class NoDeviceTime(AssertionError):
    """A profiler window that recorded no device time."""


def profile_call(fn, per: int, match=None) -> dict:
    """Run ``fn()`` once under torch.profiler: device time (kernels and
    copies; only entries whose name holds ``match`` where given), device
    kernels and host wall, each per one of ``per`` units (batches), the
    share of the wall the card was busy, and the top device entries
    [name, ms, count] per unit. The profiler slows the host, so the share
    errs low. The profiler now and then loses a window's device records
    (twice in a row once): such a window is taken again, up to
    PROFILE_ATTEMPTS in all, each retry counted in PROFILE_RETRIES (the
    kernels' rows report them as profile_retries)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        # A user annotation's device range (torch.optim's
        # "Optimizer.step#...") spans kernels counted on their own.
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and (match is None or match in e.key)]
        dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
        if dev_ms > 0:
            break
        if attempt == PROFILE_ATTEMPTS - 1:
            raise NoDeviceTime("the profiler recorded no device time")
        log("profiler: no device time recorded; profiling the window again")
        PROFILE_RETRIES[0] += 1
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return dict(device_busy_share=dev_ms / wall_ms, device_ms_per_batch=dev_ms / per,
                device_kernels_per_batch=sum(e.count for e in dev) / per,
                profiled_wall_ms_per_batch=wall_ms / per,
                top_device_ms_per_batch=[[e.key[:60], e.self_device_time_total / 1e3 / per,
                                          e.count / per] for e in top])


def bound(shape, ops: int, nbytes=None):
    if nbytes is None:
        nbytes = 2 * int(np.prod(shape)) * 4  # float32 in once, out once
    t_bytes, t_ops = nbytes / _cost().PEAK_BYTES_S * 1e3, ops / _cost().PEAK_F32_S * 1e3
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
    for src in ("stencils", "warp", "codec"):
        log_sass(f"{src}.cu", sass_report(str(_build.library_path(src)),
                                          _main_path_kernel))
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

    def chain_d(x, d):
        return dvf_tpu_torch.get_filter("sobel_bilateral", d=d,
                                        impl="chain").fn(x, None)[0]
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
             library=library_blur, ops=lambda s: _cost().ops_sep_blur(s, 9, 9),
             instance="sep_blur_kernel<{},{},{}>".format(
                 *tk.sep_blur_instance(9, 9, MAIN_SHAPE[-1])),
             extra=[((1, 150, 270, 3), (9, 9), 1), ((1, 70, 130, 4), (31, 31), 0),
                    ((2, 97, 131, 1), (5, 1), 0), ((1, 64, 130, 2), (3, 9), 1),
                    ((1, 150, 270, 3), (7, 7), 0)],
             extra_kernel=lambda x, k: tk.sep_blur_nhwc_pallas(
                 x, gaussian_kernel_1d(k[0], 0.0), gaussian_kernel_1d(k[1], 0.0)),
             extra_plain=lambda x, k: sep_conv2d(
                 x, gaussian_kernel_1d(k[0], 0.0), gaussian_kernel_1d(k[1], 0.0))),
        dict(name="bilateral",
             replaces="dvf_tpu/ops/pallas_kernels.py:188",
             kernel=lambda x: tk.bilateral_nhwc_pallas(x),
             plain=lambda x: bilateral_nhwc(x), library=None,
             ops=lambda s: _cost().ops_bilateral(s, 5),
             instance="bilateral_kernel<{},{}>".format(
                 *tk.bilateral_instance(5, MAIN_SHAPE[-1])),
             extra=[((1, 150, 270, 3), 5, 1), ((1, 70, 130, 4), 15, 0),
                    ((2, 97, 131, 1), 3, 0), ((1, 64, 130, 2), 7, 1),
                    ((1, 150, 270, 3), 9, 0)],
             extra_kernel=lambda x, d: tk.bilateral_nhwc_pallas(x, d=d),
             extra_plain=lambda x, d: bilateral_nhwc(x, d=d)),
        dict(name="sobel_bilateral",
             replaces="dvf_tpu/ops/pallas_kernels.py:485",
             kernel=lambda x: tk.sobel_bilateral_nhwc_pallas(x),
             plain=lambda x: chain.fn(x, None)[0], library=None,
             ops=lambda s: _cost().ops_sobel_bilateral(s, 5),
             instance="sobel_bilateral_kernel<{},{}>".format(
                 *tk.sobel_bilateral_instance(5, MAIN_SHAPE[-1])),
             extra=[((1, 150, 270, 3), 5, 1), ((1, 70, 130, 4), 15, 0),
                    ((2, 97, 131, 3), 3, 0), ((1, 64, 130, 4), 7, 1),
                    ((1, 150, 270, 3), 9, 0), ((1, 70, 130, 4), 1, 1)],
             extra_kernel=lambda x, d: tk.sobel_bilateral_nhwc_pallas(x, d=d),
             extra_plain=chain_d),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    # A practical floor for the stencils: the device time of a plain copy
    # of the main-path batch (the same bytes in and out, no arithmetic).
    x = torch.rand(MAIN_SHAPE, generator=gen, device=dev)
    copy_ms, _ = profiled_ms(torch.clone, x)
    log(f"time copy (torch.clone) {MAIN_SHAPE}: {copy_ms:.4f} ms device, "
        f"{2 * int(np.prod(MAIN_SHAPE)) * 4 / (copy_ms * 1e-3) / 1e9:.1f} GB/s")
    del x
    for spec in specs:
        retries0 = PROFILE_RETRIES[0]
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
        for shape, size, offset in spec.get("extra", []):
            # offset 1: a contiguous view whose base is not 16-byte aligned
            flat = torch.rand(int(np.prod(shape)) + offset, generator=gen, device=dev)
            xe = flat[offset:].view(shape)
            got = spec["extra_kernel"](xe, size)
            torch.cuda.synchronize()
            e = (got - spec["extra_plain"](xe, size)).abs().max().item()
            log(f"check {spec['name']} {shape} size {size} offset {offset}: max abs "
                f"err {e:.3e}")
            if not e <= TOL:
                raise AssertionError(
                    f"{spec['name']} kernel disagrees with its plain version at "
                    f"{shape} size {size} offset {offset}: {e} > {TOL}")
            err = max(err, e)
        ms = cuda_ms(spec["kernel"], x)
        smi_after = smi_sample()
        dev_ms, _ = profiled_ms(spec["kernel"], x)
        plain_ms = cuda_ms(spec["plain"], x)
        lib_ms = None
        if spec["library"] is not None:
            lib_err = (spec["library"](x) - spec["plain"](x)).abs().max().item()
            lib_ms = cuda_ms(spec["library"], x)
            log(f"library {spec['name']}: max abs err vs plain {lib_err:.3e}")
        b_ms, b_by = bound(MAIN_SHAPE, spec["ops"](MAIN_SHAPE))
        gbps = 2 * int(np.prod(MAIN_SHAPE)) * 4 / (ms * 1e-3) / 1e9
        extra = {}
        if "instance" in spec:
            clock, power = (v.strip() for v in smi_after.split(","))
            extra = dict(instance=spec["instance"], clocks_sm=clock, power_draw=power)
        log(f"time {spec['name']} {MAIN_SHAPE}: kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library {lib_ms} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"share of bound {b_ms / ms:.3f}, {gbps:.1f} GB/s"
            + (f", {extra['instance']}; after the timing loop: clocks.sm "
               f"{extra['clocks_sm']}, power.draw {extra['power_draw']}" if extra else ""))
        rows.append(dict(name=spec["name"], route="cuda", source=SOURCE,
                         replaces=spec["replaces"], shape=list(MAIN_SHAPE),
                         launches=None, max_abs_err=err, ms=ms, kernel_ms=ms,
                         device_ms=dev_ms, copy_ms=copy_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, share_of_bound=b_ms / ms,
                         achieved_gb_s=gbps,
                         profile_retries=PROFILE_RETRIES[0] - retries0, **extra))
        del x
    log("K2/K3 have no single PyTorch call computing the same function: "
        "library_ms is null for them")
    torch.cuda.empty_cache()
    rows.append(check_warp(dev, gen))
    torch.cuda.empty_cache()
    rows.extend(check_codec_kernels(dev, gen))
    torch.cuda.empty_cache()
    neural_checks = check_neural(dev)
    rows.extend(check_norm(dev))
    torch.cuda.empty_cache()
    rows.extend(check_outconv(dev))
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
        log_calibration(leg_label(name, kw), eng)
    engine_checks = check_engine_entries(dev, engines["gaussian_blur"])
    pipe_rows = []
    launches = {k: 0 for k in tk.LAUNCHES}
    for name, kw, counter, per_batch in legs:
        label = leg_label(name, kw)
        flow = name == "flow_warp"
        got = {}
        for mode in ("streamed",) if flow else ("streamed", "monolithic"):
            row, delta, got[mode] = pipeline_leg(
                dev, engines[label], name, kw, counter, per_batch, mode,
                plain_of, steady=label == "invert" and mode == "streamed")
            for k, v in delta.items():
                launches[k] += v
            pipe_rows.append(row)
        if not flow:
            n_diff = sum(not np.array_equal(got["streamed"][i], got["monolithic"][i])
                         for i in range(N_FRAMES))
            if n_diff:
                raise AssertionError(f"{label}: {n_diff} delivered frames differ "
                                     f"between streamed and monolithic")
            log(f"pipeline {label}: all {N_FRAMES} delivered frames byte-identical "
                f"between ingest/egress streamed and monolithic")
            pipe_rows[-1]["frames_differing_from_streamed"] = 0
        del got
    row, delta = resilient_leg(dev)
    for k, v in delta.items():
        launches[k] += v
    pipe_rows.append(row)
    row, delta = traced_leg(dev, engines["gaussian_blur"])
    for k, v in delta.items():
        launches[k] += v
    pipe_rows.append(row)
    # the delta-wire worker's legs (K5, K6)
    for row, delta in wire_legs(dev, env["libjpeg"]):
        for k, v in delta.items():
            launches[k] += v
        pipe_rows.append(row)
    # the neural filters and the rest of the registry (no hand kernel but
    # the style net's norms)
    registry_engines = {}
    for name, kw, shape in REGISTRY_LEGS:
        row, delta, eng = registry_leg(dev, name, kw, shape)
        for k, v in delta.items():
            launches[k] += v
        pipe_rows.append(row)
        registry_engines[row["filter"]] = (eng, shape)
        torch.cuda.empty_cache()
    # 7. the serving frontend (multi-tenant; the kernels through its buckets)
    serve_rows, delta = serve_phase(dev, plain_of)
    for k, v in delta.items():
        launches[k] += v
    # 8. the supervised rebuild and the worker's wire (the native ring)
    ring_rows, delta = ring_phase(dev, plain_of, env["libjpeg"])
    for k, v in delta.items():
        launches[k] += v
    # 9. the observability planes (replays and probes launch K1/K3)
    planes_rows, delta = planes_phase(dev, plain_of, env["libjpeg"])
    for k, v in delta.items():
        launches[k] += v
    # 10. the control plane, auto-plan and broadcast (K1/K3 through buckets)
    control_rows, delta = control_phase(dev, plain_of)
    for k, v in delta.items():
        launches[k] += v
    # 11. the fleet tier (K1/K3 through local replicas' buckets and probes)
    fleet_rows, delta = fleet_phase(dev, plain_of)
    for k, v in delta.items():
        launches[k] += v
    # 12. the command line (K1/K3 through serve, --sessions, fleet, trace)
    fps_of = {r["filter"]: r["fps"] for r in pipe_rows
              if r.get("mode") == "streamed" and "fps" in r and "filter" in r}
    cli_rows, delta = cli_phase(dev, plain_of, fps_of, kind)
    for k, v in delta.items():
        launches[k] += v
    # 13. training (no hand kernel on its path; the norms of (d)'s serving)
    train_rows, delta = train_phase(dev)
    for k, v in delta.items():
        launches[k] += v
    # 14. the bench harness (K1/K3/K4 and the style norms through bench, e2e
    # and fleet --scaling)
    bench_rows, delta = bench_phase(dev, plain_of, env["libjpeg"])
    for k, v in delta.items():
        launches[k] += v
    # 15. the in-host mesh (K1-K4 once per block through meshed engines, the
    # style norms once per TP rank or PP microbatch)
    mesh_rows, delta = mesh_phase(dev)
    for k, v in delta.items():
        launches[k] += v
    # 16. the multi-process runtime (K1/K3 once per rank per batch in a
    # 2-rank group) and the worker over a sharded batch (K5/K6 per block)
    mp_rows, delta, rank_launches, per_block = multiproc_phase(dev, env["libjpeg"])
    for k, v in delta.items():
        launches[k] += v
    # 17. the sharded train state (no hand kernel on the train path; K1
    # through the engine's all-card default, K3/K4 per block in the dry run)
    train_mesh_rows, train_mesh_delta = train_mesh_phase(dev, plain_of)
    for k, v in train_mesh_delta.items():
        launches[k] += v
    for row in rows:
        row["launches"] = launches[row["name"]]
        if train_mesh_delta.get(row["name"]):
            row["train_mesh_launches"] = train_mesh_delta[row["name"]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the main path")
        if rank_launches.get(row["name"]):
            row["multiproc_rank_launches"] = rank_launches[row["name"]]
        blocks = {k: v["launches"][row["name"]] for k, v in per_block.items()
                  if v["launches"].get(row["name"])}
        if blocks:
            row["per_block_launches"] = blocks

    # 6. where a pipeline batch goes (after the counted run)
    stage_rows = []
    for name, kw, _, _ in legs:
        label = leg_label(name, kw)
        stage_rows.append(stage_row(label, engines[label],
                                    FLOW_SHAPE if name == "flow_warp" else MAIN_SHAPE,
                                    profile=name == "flow_warp"))
    for label, (eng, shape) in registry_engines.items():
        log_calibration(label, eng)
        row = stage_row(label, eng, shape, profile=label.startswith(
            ("style_transfer", "super_resolution")))
        if "device_ms_per_batch" in row:
            flop, b_ms, b_by = net_bound(label, shape)
            row.update(flop_per_batch=flop, bound_ms=b_ms, bound_by=b_by,
                       share_of_bound=b_ms / row["device_ms_per_batch"])
            log(f"bound {label} {shape}: {flop / 1e12:.4f} TFLOP per batch, "
                f"bound {b_ms:.4f} ms ({b_by}, bf16 peak {_cost().PEAK_BF16_S / 1e12:.0f} "
                f"TFLOP/s), share of bound {row['share_of_bound']:.3f} of the "
                f"profiled device time")
        stage_rows.append(row)

    print(json.dumps({"pipeline": pipe_rows}))
    print(json.dumps({"serve": serve_rows}))
    print(json.dumps({"ring": ring_rows}))
    print(json.dumps({"planes": planes_rows}))
    print(json.dumps({"control": control_rows}))
    print(json.dumps({"fleet": fleet_rows}))
    print(json.dumps({"cli": cli_rows}))
    print(json.dumps({"train": train_rows}))
    print(json.dumps({"bench": bench_rows}))
    print(json.dumps({"mesh": mesh_rows}))
    print(json.dumps({"multiproc": mp_rows}))
    print(json.dumps({"train_mesh": train_mesh_rows}))
    print(json.dumps({"stages": stage_rows}))
    print(json.dumps({"neural_checks": neural_checks}))
    print(json.dumps({"engine_checks": engine_checks}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def leg_label(name: str, kw: dict) -> str:
    return registry_label(name, kw) if name == "flow_warp" else name


def log_calibration(label: str, eng) -> None:
    """The engine's compile-time calibrations (Engine.compile) and what
    the reference's streaming gates (MIN_STREAM_H2D_MS / _D2H_MS) pick
    from them on this card."""
    from dvf_tpu_torch.runtime import egress, ingest

    def pick(cal, gate):
        return "streamed" if cal is None or cal >= gate else "monolithic (cheap_transfer)"

    log(f"calibration {label} {eng.signature[0]}: h2d_block_ms {eng.h2d_block_ms}, "
        f"d2h_block_ms {eng.d2h_block_ms}, step_block_ms {eng.step_block_ms}, "
        f"last_compile_ms {eng.last_compile_ms}; the {ingest.MIN_STREAM_H2D_MS} ms "
        f"gates pick ingest {pick(eng.h2d_block_ms, ingest.MIN_STREAM_H2D_MS)}, "
        f"egress {pick(eng.d2h_block_ms, egress.MIN_STREAM_D2H_MS)}")


@contextlib.contextmanager
def gates_open():
    """Streamed ingest and egress whatever the calibrations: the 1080p
    batch crosses the host link in about the gates' 2.0 ms, so with them
    the card's pick flips from run to run (the calibration lines show
    it); the streamed legs set both to 0, as the CPU tests do."""
    from dvf_tpu_torch.runtime import egress, ingest

    saved = ingest.MIN_STREAM_H2D_MS, egress.MIN_STREAM_D2H_MS
    ingest.MIN_STREAM_H2D_MS = egress.MIN_STREAM_D2H_MS = 0.0
    try:
        yield
    finally:
        ingest.MIN_STREAM_H2D_MS, egress.MIN_STREAM_D2H_MS = saved


def check_engine_entries(dev, eng) -> dict:
    """The engine's other entries on one stateless main-path engine
    (gaussian_blur at MAIN_SHAPE): submit_resident byte-identical to
    submit; run_probe byte-identical to submit; run_probe refusing
    flow_warp; out_uint8=False against the plain float version (TOL)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.ops.conv import gaussian_kernel_1d, sep_conv2d
    from dvf_tpu_torch.utils.image import to_float

    frames = np.stack([f for f, _ in dvf_tpu_torch.SyntheticSource(
        *MAIN_SHAPE[1:], n_frames=MAIN_SHAPE[0], seed=1)][:-1])
    want = eng.submit(frames).fetch().copy()
    res = eng.submit_resident(torch.from_numpy(frames).to(dev))
    resident_diff = int((res.device.cpu().numpy() != want).sum())
    probe_diff = int((eng.run_probe(frames) != want).sum())
    flow = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("flow_warp"))
    flow.compile(FLOW_SHAPE)
    try:
        flow.run_probe(np.zeros(FLOW_SHAPE, np.uint8))
        refused = None
    except ValueError as e:
        refused = str(e)
    f32 = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("gaussian_blur", ksize=9),
                               out_uint8=False)
    got = f32.submit(frames).fetch()
    k9 = gaussian_kernel_1d(9, 0.0)
    x = to_float(torch.from_numpy(frames).to(dev))
    f32_err = float(np.abs(got - sep_conv2d(x, k9, k9, impl="shift").cpu().numpy()).max())
    out = dict(submit_resident_bytes_differing=resident_diff,
               run_probe_bytes_differing=probe_diff,
               run_probe_refuses_flow_warp=refused,
               out_uint8_false_dtype=str(got.dtype), out_uint8_false_max_abs_err=f32_err)
    log(f"engine entries gaussian_blur {MAIN_SHAPE}: {json.dumps(out)}")
    if resident_diff or probe_diff or refused is None or got.dtype != np.float32 \
            or not f32_err <= TOL:
        raise AssertionError(f"engine entries: {out}")
    return out


def alloc_counts() -> dict:
    """cudaMalloc segments and, where this torch has them, the pinned host
    allocator's counters."""
    import torch

    ms = torch.cuda.memory_stats()
    out = {"device_segments_allocated": ms.get("segment.all.allocated", 0),
           "device_alloc_retries": ms.get("num_alloc_retries", 0)}
    hs = getattr(torch.cuda, "host_memory_stats", None)
    if hs is not None:
        h = hs()
        for k in ("num_host_alloc", "allocations.allocated", "allocation.allocated",
                  "allocation.all.allocated", "segment.allocated"):
            if k in h:
                out[f"host_{k}"] = h[k]
    return out


def pipeline_leg(dev, eng, name: str, kw: dict, counter, per_batch: int, mode: str,
                 plain_of: dict, steady: bool = False):
    """One main-path Pipeline leg with ingest and egress ``mode``, the
    launch counters zeroed just before and read just after. Every frame
    once and in order, within 1 LSB of the plain version (the flow legs:
    the first batch passed through and the stream within 1 LSB of the
    plain recomputation); the 1080p legs return every delivered frame for
    the byte comparison between modes. ``steady``: the allocator counters
    read at the sink after the third batch and after the run must agree
    (no device segment, no pinned host allocation in steady state)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    label = leg_label(name, kw)
    flow = name == "flow_warp"
    shape, n = (FLOW_SHAPE, FLOW_FRAMES) if flow else (MAIN_SHAPE, N_FRAMES)
    # Flow legs wait for full batches, so the reference below cuts the
    # stream where the pipeline did.
    cfg = dvf_tpu_torch.PipelineConfig(
        batch_size=shape[0], queue_size=n + 1, ingest=mode, egress=mode,
        assemble_timeout_s=60.0 if flow else 0.01)
    order, kept, counts = [], {}, {}
    at = 3 * shape[0]

    def sink(i, f, _ts):
        order.append(i)
        kept[i] = f     # a copy (pooled slab rows) or a view of a fresh array
        if steady and i == at:
            torch.cuda.synchronize()
            counts["after_3_batches"] = alloc_counts()

    src = dvf_tpu_torch.SyntheticSource(*shape[1:], n_frames=n, seed=0)
    b0 = eng.stats.batches   # the engine also served earlier legs
    tk.reset_launches()
    pipe = dvf_tpu_torch.Pipeline(src, eng.filter, dvf_tpu_torch.CallbackSink(sink),
                                  cfg, engine=eng)
    with gates_open() if mode == "streamed" else contextlib.nullcontext():
        stats = pipe.run()
    delta = dict(tk.LAUNCHES)
    batches = eng.stats.batches - b0
    if steady:
        torch.cuda.synchronize()
        counts["after_run"] = alloc_counts()
    if order != list(range(n)) or stats["delivered"] != n:
        raise AssertionError(f"{label} [{mode}]: delivered {stats['delivered']} of "
                             f"{n}, in order: {order == sorted(order)}")
    want_delta = {k: (batches * per_batch if k == counter else 0) for k in delta}
    if delta != want_delta:
        raise AssertionError(f"{label} [{mode}]: launches {delta}, want {want_delta}")
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        *shape[1:], n_frames=n, seed=0)][:-1]
    keep = (0, 1, n // 2, n - 1)
    if flow:
        if batches != n // shape[0]:
            raise AssertionError(f"{label}: {batches} batches, "
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
        raise AssertionError(f"{label} [{mode}]: delivered frames differ from the "
                             f"plain version by {lsb} LSB")
    ing, egr = stats.get("ingest", {}), stats.get("egress", {})
    io = {k: {f: d.get(f) for f in (
        "mode", "fallback_reason", "overlap_efficiency", "pool_allocs", "stage_ms",
        "h2d_put_ms", "h2d_wait_ms", "h2d_block_ms", "d2h_wait_ms", "copy_ms",
        "d2h_block_ms") if f in d} for k, d in (("ingest", ing), ("egress", egr))}
    for k in ("ingest", "egress"):
        if io[k].get("mode") == "streamed" and io[k].get("pool_allocs") != 1:
            raise AssertionError(f"{label} [{mode}]: {k} pool_allocs "
                                 f"{io[k].get('pool_allocs')}, want 1")
    steady_note = ""
    if steady:
        if counts["after_3_batches"] != counts["after_run"]:
            raise AssertionError(f"{label}: allocations in steady state: {counts}")
        steady_note = (f"; steady state (sink after batch 3 vs after the run): "
                       f"{json.dumps(counts)}, no new device segment or pinned host "
                       f"allocation")
    log(f"pipeline {label} [ingest/egress {mode}]: {stats['delivered']} frames, "
        f"{batches} batches, {stats['fps']:.1f} fps, p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms, launches {delta}, "
        f"max {lsb} LSB vs plain; {json.dumps(io)}{steady_note}")
    row = dict(filter=label, mode=mode, frames=n, batch=shape[0],
               geometry=list(shape[1:]), fps=stats["fps"], p50_ms=stats["p50_ms"],
               p99_ms=stats["p99_ms"], launches=delta, max_lsb_vs_plain=lsb, **io)
    if steady:
        row["steady_state_alloc_counts"] = counts
    return row, delta, (None if flow else kept)


def resilient_leg(dev):
    """A resilient 1080p invert Pipeline, streaming gates open, under a
    seeded FaultPlan: three h2d raises (chunk copies 3, 7 and 11: the last
    chunk of batches 0-2) and three d2h raises (the next three streamed
    fetches, batches 3-5; the degradation then comes while at least two
    batches are still to be submitted), fault budget 2. Each fault
    drops its batch; the third of each kind trips the budget and degrades
    that side to monolithic. Every other frame is delivered, in order,
    and equal to 255 - frame."""
    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.resilience import FaultPlan

    n, bsz = 192, MAIN_SHAPE[0]
    spec, seed = "h2d:at=3/7/11,d2h:at=0/1/2", 8
    chaos = FaultPlan.parse(spec, seed=seed)
    order, bad = [], []
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        *MAIN_SHAPE[1:], n_frames=n, seed=0)][:-1]

    def sink(i, f, _ts):
        order.append(i)
        if not np.array_equal(f, 255 - frames[i]):
            bad.append(i)

    cfg = dvf_tpu_torch.PipelineConfig(batch_size=bsz, queue_size=n + 1,
                                       assemble_timeout_s=60.0, resilient=True,
                                       fault_budget=2, chaos=chaos)
    tk.reset_launches()
    with gates_open():
        stats = dvf_tpu_torch.Pipeline(
            dvf_tpu_torch.SyntheticSource(*MAIN_SHAPE[1:], n_frames=n, seed=0),
            dvf_tpu_torch.get_filter("invert"), dvf_tpu_torch.CallbackSink(sink),
            cfg).run()
    delta = dict(tk.LAUNCHES)
    faults = stats["faults"]["by_kind"]
    ing, egr = stats["ingest"], stats["egress"]
    label = f"invert resilient, chaos {spec!r} seed {seed}, fault_budget 2"
    ok = (faults == {"h2d": 3, "d2h": 3} and order == sorted(order)
          and len(set(order)) == len(order) and not bad
          and stats["delivered"] == n - 6 * bsz and stats["errors"] == 6
          and ing["fallback_reason"] == "h2d_fault_budget" and ing["mode"] == "monolithic"
          and egr["fallback_reason"] == "d2h_fault_budget" and egr["mode"] == "monolithic"
          and not any(delta.values()))
    log(f"pipeline {label}: delivered {stats['delivered']} of {n} in order, "
        f"{stats['engine_batches']} batches submitted, faults {faults}, errors "
        f"{stats['errors']}, ingest {ing['mode']} ({ing['fallback_reason']}), egress "
        f"{egr['mode']} ({egr['fallback_reason']}), chaos {json.dumps(stats['chaos'])}, "
        f"frames wrong {len(bad)}, launches {delta}")
    if not ok:
        raise AssertionError(f"resilient leg: {stats}")
    row = dict(filter=label, frames=n, batch=bsz, geometry=list(MAIN_SHAPE[1:]),
               delivered=stats["delivered"], faults=faults, errors=stats["errors"],
               ingest_mode=ing["mode"], ingest_fallback_reason=ing["fallback_reason"],
               egress_mode=egr["mode"], egress_fallback_reason=egr["fallback_reason"],
               fps=stats["fps"], launches=delta)
    return row, delta


def traced_leg(dev, eng):
    """The gaussian_blur 1080p leg with trace=True (exported into a
    temporary directory), streaming gates open: per-batch spans ingest_stage, ingest_h2d (summed
    over the batch's chunk copies), ingest_overlap, egress_d2h and
    batch_complete, in ms. Launch counters as in the other legs."""
    import tempfile

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk

    n, bsz = 160, MAIN_SHAPE[0]
    cfg = dvf_tpu_torch.PipelineConfig(batch_size=bsz, queue_size=n + 1,
                                       assemble_timeout_s=60.0, trace=True)
    order = []
    cwd = os.getcwd()
    b0 = eng.stats.batches   # the engine also served earlier legs
    tk.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            pipe = dvf_tpu_torch.Pipeline(
                dvf_tpu_torch.SyntheticSource(*MAIN_SHAPE[1:], n_frames=n, seed=0),
                eng.filter, dvf_tpu_torch.CallbackSink(lambda i, f, _: order.append(i)),
                cfg, engine=eng)
            with gates_open():
                stats = pipe.run()
        finally:
            os.chdir(cwd)
    delta = dict(tk.LAUNCHES)
    batches = eng.stats.batches - b0
    if order != list(range(n)) or delta != {k: batches if k == "sep_blur" else 0
                                            for k in delta}:
        raise AssertionError(f"traced leg: order ok {order == list(range(n))}, "
                             f"launches {delta}")
    names = ("ingest_stage", "ingest_h2d", "ingest_overlap", "egress_d2h",
             "batch_complete")
    spans = {k: [] for k in names}
    for e in pipe.tracer.snapshot()["events"]:
        if e.get("ph") == "X" and e["name"] in spans:
            spans[e["name"]].append(e)
    h2d = spans["ingest_h2d"]
    per_chunk = max(1, len(h2d) // max(1, len(spans["ingest_stage"])))
    per_batch = {k: [e["dur"] / 1e3 for e in v] for k, v in spans.items()}
    per_batch["ingest_h2d"] = [sum(e["dur"] for e in h2d[i:i + per_chunk]) / 1e3
                               for i in range(0, len(h2d), per_chunk)]
    summary = {k: {"batches": len(v),
                   "median_ms": round(statistics.median(v), 4) if v else None,
                   "max_ms": round(max(v), 4) if v else None}
               for k, v in per_batch.items()}
    if any(summary[k]["batches"] == 0 for k in names):
        raise AssertionError(f"traced leg: a span is missing: {summary}")
    first = {k: [round(x, 3) for x in v[:6]] for k, v in per_batch.items()}
    alone = ingest_alone(dev, eng)
    log(f"trace gaussian_blur {MAIN_SHAPE} [streamed]: {stats['fps']:.1f} fps, "
        f"{batches} batches, {per_chunk} chunk copies per batch; "
        f"per-batch span ms (median, max): {json.dumps(summary)}; first batches: "
        f"{json.dumps(first)}; ingest {json.dumps(stats['ingest'])}; egress "
        f"{json.dumps(stats['egress'])}; the same staging and chunk copies with "
        f"no pipeline thread beside them, per batch: {json.dumps(alone)}")
    row = dict(filter="gaussian_blur(ksize=9) traced", mode="streamed", frames=n,
               batch=bsz, geometry=list(MAIN_SHAPE[1:]), fps=stats["fps"],
               launches=delta, trace_spans=summary, ingest_alone=alone)
    return row, delta


def ingest_alone(dev, eng, reps: int = 8) -> dict:
    """Staging and chunk-copy launch of one MAIN_SHAPE batch through the
    streamed assembler with no other thread running (the pipeline's
    ingest and collect threads compete with its dispatch thread for the
    interpreter): median stage and put ms per batch over ``reps``
    batches, each waited for."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.runtime.ingest import ShardedBatchAssembler

    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        *MAIN_SHAPE[1:], n_frames=MAIN_SHAPE[0], seed=0)][:-1]
    with gates_open():
        asm = ShardedBatchAssembler(MAIN_SHAPE, np.uint8, dev, slots=2,
                                    stream=eng.h2d_stream)
    stage, put = [], []
    for i in range(reps):
        b = asm.begin(i)
        for row, f in enumerate(frames):
            b.write_row(row, f)
        b.finish(len(frames))
        torch.cuda.synchronize()
        stage.append(b._stage_s * 1e3)
        put.append(b._put_s * 1e3)
    asm.release()
    return {"stage_ms": round(statistics.median(stage), 4),
            "put_ms": round(statistics.median(put), 4), "batches": reps}


def check_warp(dev, gen) -> dict:
    """Phases 3-4 for the bounded warp (K4): both designs against the plain
    version at every checked shape, bit-exact; then device times at the
    final warp's and the inner warp's shape, and at the two coarser pyramid
    levels, beside grid_sample's and the plain version's."""
    import torch

    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.ops.flow import warp_by_flow

    retries0 = PROFILE_RETRIES[0]

    def plain(img, flow, r):
        return warp_by_flow(img, flow.clamp(-r, r))

    def inputs(shape, scale, offset=0, flow_offset=0):
        # offset: an image view whose base is `offset` floats into its
        # buffer; flow_offset 2: a flow 8- but not 16-byte aligned
        n = int(np.prod(shape))
        img = torch.rand(n + offset, generator=gen, device=dev)[offset:].view(shape)
        nf = int(np.prod(shape[:3])) * 2
        flow = ((torch.rand(nf + flow_offset, generator=gen, device=dev) - 0.5)
                * scale)[flow_offset:].view(shape[:3] + (2,))
        return img, flow

    cases = []   # (label, img, flow, R); the C = 8 case has no 48 KB window
    for shape in ((2, 68, 40, 3), (2, 68, 40, 5)):
        cases.append((f"{shape} flows in +-6", *inputs(shape, 12.0), MAX_DISP))
    img, flow = inputs((2, 68, 40, 3), 4.0)          # border: +-2, edges outward
    flow[:, :3, :, 1] = -2.0
    flow[:, -3:, :, 1] = 2.0
    flow[:, :, :3, 0] = -2.0
    flow[:, :, -3:, 0] = 2.0
    cases.append(("(2, 68, 40, 3) border", img, flow, MAX_DISP))
    for shape, scale, r, off, foff in [
            ((2, 37, 131, 3), 12.0, 4, 0, 0),   # W not a multiple of a tile or of 2 px
            ((1, 5, 9, 3), 6.0, 2, 0, 0),       # smaller than one tile
            ((3, 1, 3, 1), 6.0, 1, 0, 0),
            ((2, 45, 70, 1), 12.0, 4, 0, 0),    # C = 1
            ((1, 33, 65, 8), 12.0, 4, 0, 0),    # C = 8: the window does not fit
            ((2, 50, 67, 3), 12.0, 4, 1, 2),    # image base + 1 float, flow + 8 bytes
            ((2, 50, 67, 5), 6.0, 2, 1, 0),
            ((1, 40, 90, 3), 60.0, 12, 0, 0)]:  # R = 12
        cases.append((f"{shape} R {r} offsets {off}/{foff}",
                      *inputs(shape, scale, off, foff), r))
    for shape in COARSE_SHAPES:
        cases.append((f"{shape} coarse inner warp", *inputs(shape, 6.0), INNER_DISP))
    cases.append((f"{FLOW_SHAPE} final warp", *inputs(FLOW_SHAPE, 12.0), MAX_DISP))
    cases.append((f"{INNER_SHAPE} inner warp", *inputs(INNER_SHAPE, 6.0), INNER_DISP))
    for label, img, flow, r in cases:
        want = plain(img, flow, r)
        for design in (("auto", "gather") if img.shape[-1] == 8 else tk.WARP_DESIGNS):
            got = tk.warp_bounded_pallas(img, flow, r, design)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            log(f"check warp_bounded {label} design {design}: {n_diff} differing "
                f"of {got.numel()}")
            if n_diff:
                raise AssertionError(f"warp_bounded ({design}) differs from its plain "
                                     f"version at {label} in {n_diff} elements")
    # Device times (torch.profiler) are the reported times: at 0.01-0.07 ms a
    # CUDA-event span per call also holds the card's wait for the host's
    # launch (reported beside them as *_call_ms). "warm": calls back to
    # back, the inputs in L2 as on the flow path, where the previous op has
    # just written them; "cold": L2 flushed (a 128 MB write) before each.
    flush = torch.empty(32 * 1024 * 1024, device=dev)
    timed = {}
    for key, (_, img, flow, r) in (("final", cases[-2]), ("inner", cases[-1])):
        shape = tuple(img.shape)
        t = {}
        for design, name in (("auto", "warp_"), ("gather", "warp_gather_kernel")):
            def kern(_, design=design):
                return tk.warp_bounded_pallas(img, flow, r, design)
            t[design] = (profiled_ms(kern, None, match=name)[0],
                         profiled_ms(kern, None, match=name,
                                     between=flush.zero_)[0],
                         cuda_ms(kern, None))
        library = grid_sample_call(img, flow, r)
        lib_err = (library(None).permute(0, 2, 3, 1) - plain(img, flow, r)).abs().max().item()
        lib_warm, lib_kernels = profiled_ms(library, None)
        lib = (lib_warm,
               profiled_ms(library, None, match="grid_sampler", between=flush.zero_)[0],
               cuda_ms(library, None))
        plain_ms = cuda_ms(lambda _: plain(img, flow, r), None)
        b_ms, b_by = bound(shape, _cost().ops_warp(shape), warp_bytes(shape))
        timed[key] = dict(shape=list(shape), t=t, lib=lib, lib_err=lib_err,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"library warp_bounded (grid_sample) {shape}: max abs err vs plain "
            f"{lib_err:.3e}, {lib_kernels:.0f} device kernels per call")
        log(f"time warp_bounded {shape} R {r}: auto {t['auto'][0]:.4f} ms device warm, "
            f"{t['auto'][1]:.4f} cold ({t['auto'][2]:.4f} ms per call with launch); "
            f"gather {t['gather'][0]:.4f} warm, {t['gather'][1]:.4f} cold "
            f"({t['gather'][2]:.4f}); grid_sample {lib[0]:.4f} warm, {lib[1]:.4f} cold "
            f"({lib[2]:.4f}); plain {plain_ms:.4f} ms per call; bound {b_ms:.4f} ms "
            f"({b_by}), share of bound {b_ms / t['auto'][0]:.3f} warm, "
            f"{b_ms / t['auto'][1]:.3f} cold")
    coarse = []
    for _, img, flow, r in cases[-4:-2]:
        shape = tuple(img.shape)
        t = {d: profiled_ms(lambda _, d=d: tk.warp_bounded_pallas(img, flow, r, d),
                            None)[0] for d in tk.WARP_DESIGNS}
        b_ms, _ = bound(shape, _cost().ops_warp(shape), warp_bytes(shape))
        library = grid_sample_call(img, flow, r)
        lib_err = (library(None).permute(0, 2, 3, 1) - plain(img, flow, r)).abs().max().item()
        lib_ms = profiled_ms(library, None)[0]
        plain_ms = cuda_ms(lambda _: plain(img, flow, r), None)
        coarse.append(dict(shape=list(shape), ms=t["auto"], window_ms=t["window"],
                           gather_ms=t["gather"], bound_ms=b_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_max_abs_err=lib_err))
        log(f"time warp_bounded {shape} R {r} (a coarser inner level): auto "
            f"{t['auto']:.4f} ms device warm (window {t['window']:.4f}, gather "
            f"{t['gather']:.4f}), grid_sample {lib_ms:.4f} ms device warm (max abs "
            f"err vs plain {lib_err:.3e}), plain {plain_ms:.4f} ms per call; bound "
            f"{b_ms:.4f} ms, share of bound {b_ms / t['auto']:.3f}")
    del flush
    fin, inn = timed["final"], timed["inner"]
    return dict(name="warp_bounded", route="cuda", source=WARP_SOURCE,
                replaces="dvf_tpu/ops/pallas_kernels.py:268",
                shape=fin["shape"], launches=None, max_abs_err=0.0,
                ms=fin["t"]["auto"][0], kernel_ms=fin["t"]["auto"][0],
                cold_ms=fin["t"]["auto"][1],
                call_ms=fin["t"]["auto"][2], gather_ms=fin["t"]["gather"][0],
                gather_cold_ms=fin["t"]["gather"][1],
                plain_ms=fin["plain_ms"], bound_ms=fin["bound_ms"],
                bound_by=fin["bound_by"], library_ms=fin["lib"][0],
                library_cold_ms=fin["lib"][1], library_call_ms=fin["lib"][2],
                library_max_abs_err=fin["lib_err"],
                inner_shape=inn["shape"], inner_ms=inn["t"]["auto"][0],
                inner_cold_ms=inn["t"]["auto"][1], inner_call_ms=inn["t"]["auto"][2],
                inner_gather_ms=inn["t"]["gather"][0],
                inner_gather_cold_ms=inn["t"]["gather"][1],
                inner_plain_ms=inn["plain_ms"], inner_bound_ms=inn["bound_ms"],
                inner_library_ms=inn["lib"][0], inner_library_cold_ms=inn["lib"][1],
                inner_library_call_ms=inn["lib"][2], coarse=coarse,
                profile_retries=PROFILE_RETRIES[0] - retries0)


def grid_sample_call(img, flow, r: int):
    """The warp's library yardstick: ``fn(_)`` runs grid_sample on the
    clipped flow's normalized grid (built here, outside the timed call),
    border padding = coordinate clamp; it returns NCHW."""
    import torch
    import torch.nn.functional as F

    _, h, w, _ = img.shape
    fc = flow.clamp(-r, r)
    gx = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w) + fc[..., 0]
    gy = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1) + fc[..., 1]
    grid = torch.stack([gx * (2.0 / (w - 1)) - 1.0, gy * (2.0 / (h - 1)) - 1.0], -1)
    img_nchw = img.permute(0, 3, 1, 2)

    def library(_):
        return F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    return library


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


def issue_floor_ms(shape) -> float:
    """K6's floor on this card beside its published-peak bound: the
    golden's order bars FMA, so each of ops_dct's operations issues as
    one instruction, at most 128 per clock per SM (4 schedulers x 32
    lanes), at the card's maximum SM clock."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ops_dct(shape) / (128 * sms * mhz * 1e6) * 1e3


def wire_tables(quality: int) -> tuple:
    """The fused transform's tables for Y, Cb, Cr at a JPEG quality."""
    from dvf_tpu_torch.ops import kernels as tk

    chroma = tk.jpeg_quant_table(quality, chroma=True)
    return tk.jpeg_quant_table(quality), chroma, chroma


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
    retries0 = PROFILE_RETRIES[0]
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
    md_retries = PROFILE_RETRIES[0] - retries0

    def plane(shape, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=dtype)
        return torch.rand(shape, generator=gen, device=dev) * 255.0

    dct_cases = [((2, 52, 100), torch.uint8, 90), ((2, 52, 100), torch.float32, 90),
                 ((4, 720, 1280), torch.uint8, 90), ((16, 1080, 1920), torch.uint8, 90),
                 ((16, 1080, 1920), torch.float32, 90)]
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
    # Y, Cb, Cr in one launch: the wire's shapes and a ragged set
    wire_planes = ((WIRE_BATCH, WIRE_SIZE, WIRE_SIZE),
                   *((WIRE_BATCH, WIRE_SIZE // 2, WIRE_SIZE // 2),) * 2)
    ragged_planes = ((2, 52, 100), (2, 26, 50), (2, 26, 50))
    for shapes, dtype in ((wire_planes, torch.uint8), (ragged_planes, torch.uint8),
                          (ragged_planes, torch.float32)):
        for q in (50, 90, 95, 100):
            xs = [plane(s, dtype) for s in shapes]
            tables = wire_tables(q)
            before = tk.LAUNCHES["dct8x8_quant"]
            got = tk.dct8x8_quant_planes(xs, tables)
            torch.cuda.synchronize()
            launched = tk.LAUNCHES["dct8x8_quant"] - before
            n_diff = sum(int((g != w).sum()) for g, w in
                         zip(got, tk.dct8x8_quant_planes_ref(xs, tables)))
            log(f"check dct8x8_quant_planes {shapes} {str(dtype)[6:]} q{q}: {n_diff} "
                f"differing of {sum(g.numel() for g in got)}, {launched} launch")
            if n_diff or launched != 1:
                raise AssertionError(f"dct8x8_quant_planes at {shapes} q{q}: {n_diff} "
                                     f"differing coefficients, {launched} launches")
    table = tk.jpeg_quant_table(WIRE_QUALITY)
    retries0 = PROFILE_RETRIES[0]
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
            f"({pcms:.4f} ms per call), bound {b_ms:.4f} ms ({b_by}), issue floor "
            f"{issue_floor_ms(shape):.4f} ms")
    # one fused batch's K6 work: Y, Cb, Cr in one launch
    xs = [plane(s, torch.uint8) for s in wire_planes]
    tables = wire_tables(WIRE_QUALITY)

    def kern_batch(_):
        return tk.dct8x8_quant_planes(xs, tables)

    def plain_batch(_):
        return tk.dct8x8_quant_planes_ref(xs, tables)

    batch_px = sum(int(np.prod(s)) for s in wire_planes)
    b_ms, b_by = bound((batch_px,), ops_dct((batch_px,)), 3 * batch_px)
    batch_ms, batch_kernels = profiled_ms(kern_batch, None, match="dct8x8")
    batch = dict(batch_shapes=[list(s) for s in wire_planes], batch_ms=batch_ms,
                 batch_call_ms=cuda_ms(kern_batch, None),
                 batch_plain_ms=profiled_ms(plain_batch, None)[0],
                 batch_bound_ms=b_ms, batch_bound_by=b_by,
                 batch_issue_floor_ms=issue_floor_ms((batch_px,)),
                 batch_launches_per_call=batch_kernels,
                 profile_retries=PROFILE_RETRIES[0] - retries0)
    log(f"time dct8x8_quant_planes {wire_planes} uint8 (one fused batch): kernel "
        f"{batch_ms:.4f} ms device in {batch_kernels:.0f} launches per call "
        f"({batch['batch_call_ms']:.4f} ms per call with launch), plain "
        f"{batch['batch_plain_ms']:.4f} ms device, bound {b_ms:.4f} ms ({b_by}), issue "
        f"floor {batch['batch_issue_floor_ms']:.4f} ms")
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
            hd_ms=hd[0], hd_call_ms=hd[2], hd_plain_ms=hd[1][0], hd_bound_ms=hd[4][0],
            profile_retries=md_retries),
        row("dct8x8_quant", "dvf_tpu/ops/pallas_kernels.py:840", y_shape,
            dct_timed[y_shape], quality=WIRE_QUALITY,
            share_of_bound=dct_timed[y_shape][4][0] / dct_timed[y_shape][0],
            issue_floor_ms=issue_floor_ms(y_shape), chroma_shape=list(c_shape),
            chroma_ms=chroma[0], chroma_call_ms=chroma[2],
            chroma_plain_ms=chroma[1][0], chroma_bound_ms=chroma[4][0],
            chroma_issue_floor_ms=issue_floor_ms(c_shape), **batch),
    ]


class plain_codec_kernels:
    """Within the block, the codec assist calls K5's and K6's plain
    versions (on the card) instead of the kernels: the reference the
    kernels' wire legs are held to."""

    def __enter__(self):
        from dvf_tpu_torch.ops import kernels as tk
        from dvf_tpu_torch.runtime import codec_assist as ca

        self._saved = (ca.tile_maxdiff, ca.dct8x8_quant_planes)
        ca.tile_maxdiff, ca.dct8x8_quant_planes = (tk.tile_maxdiff_ref,
                                                   tk.dct8x8_quant_planes_ref)
        return self

    def __exit__(self, *exc):
        from dvf_tpu_torch.runtime import codec_assist as ca

        ca.tile_maxdiff, ca.dct8x8_quant_planes = self._saved


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


def _run_worker(dev, blobs, assist: str, inner: str, mesh=None):
    """One pass of the app's stream through a socket-less ZmqWorker (its
    engine over ``mesh`` when one is given). Returns (payloads in send
    order as (index, bytes), stats, seconds)."""
    import dvf_tpu_torch

    filt = dvf_tpu_torch.get_filter("invert")
    worker = dvf_tpu_torch.ZmqWorker(
        filt, batch_size=WIRE_BATCH, wire="delta",
        jpeg_quality=WIRE_QUALITY, delta_tile=WIRE_TILE,
        delta_keyframe_interval=WIRE_KEY, codec_assist=assist, device=dev,
        codec=_delta_codec(inner, on_gap="raise"), connect=False,
        engine=(dvf_tpu_torch.Engine(filt, mesh=mesh) if mesh is not None
                else None))
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
        want["dct8x8_quant"] = nb
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
    io = {k: {f: stats[k].get(f) for f in ("mode", "fallback_reason", "h2d_block_ms",
                                           "d2h_block_ms", "pool_allocs")
              if f in stats[k]} for k in ("ingest", "egress") if k in stats}
    log(f"pipeline {label}: {n} frames, {stats['batches']} batches, {fps:.1f} fps "
        f"(batch step + drain), dirty ratio {d['dirty_ratio']}, keyframes "
        f"{d['keyframes']}, entropy {d['entropy_ms'] / n:.4f} ms/frame, d2h coef "
        f"{d['d2h_coef_bytes'] / n:.0f} B/frame, encode {stats['egress']['encode_ms']:.3f}"
        f" ms/batch; per batch ms {json.dumps(per)}; ingest/egress {json.dumps(io)}; "
        f"launches {delta}; payloads "
        f"byte-identical to the plain recomputation"
        + ("; decoded == 255 - frame" if exact else "") + f"; profiled: {json.dumps(prof)}")
    row = dict(filter=label, frames=n, batch=WIRE_BATCH, geometry=[WIRE_SIZE, WIRE_SIZE, 3],
               fps=fps, dirty_ratio=d["dirty_ratio"], keyframes=d["keyframes"],
               entropy_ms_per_frame=d["entropy_ms"] / n,
               d2h_coef_bytes_per_frame=d["d2h_coef_bytes"] / n,
               encode_ms_per_batch=stats["egress"]["encode_ms"],
               split_ms_per_batch=per, launches=delta, payloads_differing=0,
               **io, **prof)
    return row, delta


def _fused_pass(dev, frames: list, mesh=None):
    """Engine(invert) → FusedDeltaTransform over the stream, each frame's
    dirty blocks gathered (bitmap > 0) and the first frame's whole grid
    (the engine over ``mesh`` when one is given: the transform then runs
    once per block)."""
    import torch

    import dvf_tpu_torch

    filt = dvf_tpu_torch.get_filter("invert")
    eng = (dvf_tpu_torch.Engine(filt, mesh=mesh) if mesh is not None
           else dvf_tpu_torch.Engine(filt, device=dev))
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
    want.update(tile_maxdiff=nb, dct8x8_quant=nb)
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


def net_bound(label: str, shape):
    """(FLOP per batch, bound ms, bound_by) of a neural leg's batch: the
    convs' multiply-adds x 2 at the bf16 tensor-core peak, against the
    float32 batch read once and the float32 output written once."""
    b, h, w, c = shape
    if label.startswith("style_transfer"):
        flop, out = 2 * _cost().style_macs_per_pixel() * b * h * w, b * h * w * c
    else:
        flop, out = 2 * _cost().espcn_macs_per_pixel() * b * h * w, 4 * b * h * w * c
    t_ops = flop / _cost().PEAK_BF16_S * 1e3
    t_bytes = (b * h * w * c + out) * 4 / _cost().PEAK_BYTES_S * 1e3
    return flop, max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _golden_diff(out, name: str) -> tuple:
    """(mean, max) |Δ| of frame 0 of a [0, 1] output, as the reference's
    golden tests make it uint8, against tests/golden/<name>."""
    import torch

    got = (torch.clamp(out, 0, 1)[0].cpu().numpy() * 255).astype(np.uint8)
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "golden", name))
    diff = np.abs(got.astype(int) - golden.astype(int))
    return float(diff.mean()), int(diff.max())


def _filter_out(filt, x, device):
    import torch

    state = (filt.init_state(tuple(x.shape), torch.float32, device)
             if filt.stateful else None)
    with torch.no_grad():
        return filt.fn(x.to(device), state)[0]


def check_neural(dev) -> dict:
    """Phase 3 for the neural filters (cuDNN convs, no hand kernel): the
    port's trained checkpoints on the card against the JAX package's
    goldens at their tests' bar (mean |Δ| < 2.0, max <= 30), and the
    float32 nets on the card against the CPU within 1e-4 (the reference's
    f32 bar)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.train import checkpoint as tc
    from dvf_tpu_torch.train.sr import downscale_area, synthesize_structured_batch

    style_dir = os.path.join(tc.CHECKPOINT_ROOT, "style_stripes_64")
    sr_dir = os.path.join(tc.CHECKPOINT_ROOT, "sr2x_64")
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(64, 64, n_frames=4)][:4]
    x_style = torch.from_numpy(np.stack(frames)).to(dev).float() / 255.0
    hr = torch.from_numpy(synthesize_structured_batch(
        np.random.default_rng(12345), 8, 80)).to(dev).float() / 255.0
    x_sr = downscale_area(hr, 2)
    res = {}
    for key, load, ckpt, x, golden in (
            ("style_stripes_64", tc.load_style_filter, style_dir, x_style,
             "style_demo_out.npy"),
            ("sr2x_64", tc.load_sr_filter, sr_dir, x_sr, "sr_demo_out.npy")):
        mean, mx = _golden_diff(_filter_out(load(ckpt), x, dev), golden)
        log(f"check {key} (bfloat16) on the card vs {golden}: mean |d| {mean:.4f}, "
            f"max {mx} (bar: mean < 2.0, max <= 30)")
        if not (mean < 2.0 and mx <= 30):
            raise AssertionError(f"{key} drifted from {golden}: mean {mean}, max {mx}")
        f32 = load(ckpt, dtype="float32")
        err = float((_filter_out(f32, x, dev).cpu()
                     - _filter_out(f32, x, torch.device("cpu"))).abs().max())
        log(f"check {key} (float32) card vs CPU: max abs err {err:.3e} (bar 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"{key} float32 on the card differs from the CPU "
                                 f"by {err}")
        res[key] = dict(golden_mean_abs=mean, golden_max_abs=mx,
                        f32_card_vs_cpu_max_abs_err=err)
    return res


def _ulp_bf16(x):
    """One bf16 ulp at |x| (float32 in, float32 out)."""
    import torch

    e = torch.frexp(x.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(x), e - 8)


# The style stream's norm geometries (8 x 720 x 1280, bf16): stem and up2,
# down1 and up1, down2 and the residual trunk (whose res*_b norms add the
# residual).
NORM_SHAPES = ((8, 720, 1280, 32), (8, 360, 640, 64), (8, 180, 320, 128))


def check_norm(dev) -> list:
    """The style nets' bias + instance norm + ReLU + residual kernels
    (``csrc/norm.cu``, ``ops.kernels.bias_norm_act_cuda``) against their
    plain ops at the stream's three geometries in bf16, with ReLU and (at
    the trunk's geometry) with the residual instead: bf16 ulps apart and
    the share of elements that differ; CUDA-event times of the kernels,
    of the plain ops and of ``F.instance_norm`` (the norm alone, a
    yardstick the port never calls); the profiler's device time of the
    kernels' three launches; the bound, each input byte read once and the
    output written once (4 bytes an element, 6 with the residual) at the
    card's 3.35 TB/s, and the two-pass design's own floor (6 and 8: the
    statistics read y a second time). Phase 5 counts the main path's
    launches. Replaces no TPU kernel."""
    import torch
    import torch.nn.functional as F

    from dvf_tpu_torch.models import layers as tl
    from dvf_tpu_torch.ops import kernels as tk

    rows = []
    gen = torch.Generator(device=dev).manual_seed(27)
    cases = [(s, False) for s in NORM_SHAPES] + [(NORM_SHAPES[-1], True)]
    for shape, with_res in cases:
        c = shape[-1]
        y = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        res = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               if with_res else None)
        p = {"scale": torch.rand(c, generator=gen, device=dev) + 0.5,
             "bias": torch.randn(c, generator=gen, device=dev)}
        b = torch.randn(c, generator=gen, device=dev)
        relu = not with_res

        def kernel(x, p=p, b=b, res=res, relu=relu):
            return tk.bias_norm_act_cuda(p, x, b, relu=relu, residual=res)

        def plain(x, p=p, b=b, res=res, relu=relu):
            return tl.bias_norm_act_plain(p, x, b, relu=relu, residual=res)

        def library(x, p=p):
            return F.instance_norm(x.permute(0, 3, 1, 2), weight=p["scale"],
                                   bias=p["bias"], eps=1e-5)

        got, want = kernel(y).float(), plain(y).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        max_ulp = float((diff / _ulp_bf16(torch.maximum(got.abs(), want.abs()))).max())
        share = float((diff > 0).float().mean())
        # Beyond one ulp of the output only where the sum cancels: within
        # two ulps of the terms summed (tests/test_torch_cuda.py _check_norm).
        yb = (y + b.to(y.dtype)).float()
        var, mean = torch.var_mean(yb, dim=(1, 2), keepdim=True, correction=0)
        a = torch.rsqrt(var + 1e-5) * p["scale"]
        terms = ((yb * a).abs() + (p["bias"] - mean * a).abs()
                 + (mean.abs() + var.sqrt()) * a.abs())
        if res is not None:
            terms += res.float().abs()
        guard_ok = bool((diff <= 2 * _ulp_bf16(terms)).logical_or(diff <= _ulp_bf16(
            torch.maximum(got.abs(), want.abs()))).all())
        del got, want, diff, yb, terms
        ms = cuda_ms(kernel, y)
        dev_ms, launches = profiled_ms(kernel, y)
        plain_ms = cuda_ms(plain, y)
        lib_ms = cuda_ms(library, y)
        n = int(np.prod(shape))
        least = (6 if with_res else 4) * n
        moved = (8 if with_res else 6) * n
        b_ms = least / _cost().PEAK_BYTES_S * 1e3
        floor_ms = moved / _cost().PEAK_BYTES_S * 1e3
        row = dict(name="instance_norm", route="cuda",
                   source="dvf_tpu_torch/csrc/norm.cu", replaces=None,
                   shape=list(shape), dtype="bfloat16", relu=relu, residual=with_res,
                   max_ulp=max_ulp, beyond_one_ulp_within_terms=guard_ok,
                   differing_share=share, kernel_ms=ms,
                   device_ms=dev_ms, device_kernels=launches, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by="bytes",
                   share_of_bound=b_ms / dev_ms, two_pass_floor_ms=floor_ms,
                   achieved_tb_s=moved / (dev_ms * 1e-3) / 1e12)
        log(f"norm {shape} relu {relu} residual {with_res}: max {max_ulp:.2f} bf16 ulp "
            f"of the output (within 2 ulp of the terms where more: {guard_ok}), "
            f"{share:.2e} of elements differ; kernel {ms:.4f} ms (device {dev_ms:.4f} "
            f"ms, {launches:.0f} kernels), plain {plain_ms:.4f} ms, F.instance_norm "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms (bytes), share {b_ms / dev_ms:.3f}, "
            f"two-pass floor {floor_ms:.4f} ms, {row['achieved_tb_s']:.2f} TB/s moved")
        if not (guard_ok and share < 1e-3):
            raise AssertionError(f"norm kernels disagree with the plain ops at {shape}: "
                                 f"{max_ulp} ulp, share {share}")
        rows.append(row)
        del y, res
        torch.cuda.empty_cache()
    return rows


def norm_only() -> None:
    """The build and the instance norm's kernels alone (their check, times
    and bound at the style stream's shapes, ``check_norm``):
    ``python3 -c 'import chip_smoke; chip_smoke.norm_only()'``."""
    from dvf_tpu_torch.ops import _build

    dev, _, _ = _only_setup()
    for line in _build.build_log.get("norm", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas[norm]: {line.strip()}")
    print(json.dumps({"kernels": check_norm(dev)}))


# The style stream's out stage (csrc/outconv.cu): its input, and frames
# that are no multiple of the kernel's tile, the smallest it takes, and
# every other channel count it is compiled for.
OUTCONV_SHAPES = ((8, 720, 1280, 32), (1, 5, 5, 32), (2, 37, 53, 32), (3, 97, 131, 32),
                  (2, 37, 53, 16), (2, 37, 53, 48), (1, 70, 131, 64))
# The share of the outputs whose pre-tanh value may sit one bf16 rounding
# apart from the plain ops' (the conv's summation order over 81·Cin
# products; tests/test_torch_cuda.py _check_outconv).
OUTCONV_MAX_SHARE = 2e-3


def _outconv_operands(shape, dev, seed):
    """A post-ReLU bf16 activation as up2's norm leaves it, the out conv's
    He-normal weight and a bias."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    cin = shape[-1]
    x = torch.relu(torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
    p = {"w": torch.randn((9, 9, cin, 3), generator=gen, device=dev)
         * (2.0 / (81 * cin)) ** 0.5,
         "b": torch.randn(3, generator=gen, device=dev) * 0.3}
    return x, p


def outconv_gap(got, x, p):
    """The kernel's output against the plain ops' on the same operands:
    the largest difference over its bound (one bf16 ulp of the conv result
    and of the sum with the bias, halved by the scaled tanh, plus float32
    noise of tanh), and the share of outputs that differ beyond that
    noise (a pre-tanh rounding flipped)."""
    import torch

    from dvf_tpu_torch.models import layers as tl

    s = tl.conv2d_nb(p, x, compute_dtype=torch.bfloat16, reflect=True)
    z = (s + p["b"].to(torch.bfloat16)).float()
    want = (0.5 * (torch.tanh(z) + 1.0))
    diff = (got.float() - want).abs()
    us = _ulp_bf16(s.float().abs() + _ulp_bf16(s.float()))
    bound = 0.5 * (us + _ulp_bf16(z.abs() + us + _ulp_bf16(z))) + 2.0 ** -22
    return float((diff / bound).max()), float((diff > 2.0 ** -22).float().mean())


def check_outconv(dev) -> list:
    """The style nets' out stage kernel (``csrc/outconv.cu``,
    ``ops.kernels.out_conv_tanh_cuda``) against the plain ops
    (``models.layers.out_conv_tanh_plain``) at the stream's shape and at
    ragged ones: the largest gap over its bound and the share of outputs a
    flipped rounding moved (``outconv_gap``); at the stream's shape
    CUDA-event and profiler times of the kernel, of the plain ops as the
    stream runs them (cuDNN with TF32 allowed: a TF32 kernel on a float32
    copy of the input) and of cuDNN bf16 with Cout zero-padded to 8 on a
    pre-padded input (a yardstick the port never calls; it too takes
    TF32); the bound, max(FLOPs ÷ 989e12, bytes ÷ 3.35e12) with the input
    read once and the float32 output written once. Phase 5 counts the main
    path's launches. Replaces no TPU kernel."""
    import torch

    from dvf_tpu_torch.models import layers as tl
    from dvf_tpu_torch.ops import kernels as tk

    rows = []
    for i, shape in enumerate(OUTCONV_SHAPES):
        x, p = _outconv_operands(shape, dev, 29 + i)
        before = tk.LAUNCHES["out_conv"]
        got = tk.out_conv_tanh_cuda(p, x)
        torch.cuda.synchronize()
        if tk.LAUNCHES["out_conv"] != before + 1:
            raise AssertionError("out_conv: not counted once a call")
        worst, share = outconv_gap(got, x, p)
        log(f"outconv {shape}: worst {worst:.3f} of the bound, {share:.2e} of the "
            f"outputs a rounding apart")
        if not (worst <= 1 and share < OUTCONV_MAX_SHARE):
            raise AssertionError(f"out_conv disagrees with the plain ops at {shape}: "
                                 f"{worst} of the bound, share {share}")
        row = dict(name="out_conv", route="cuda", source="dvf_tpu_torch/csrc/outconv.cu",
                   replaces=None, shape=list(shape), dtype="bfloat16", out_dtype="float32",
                   worst_of_bound=worst, rounded_apart_share=share)
        if i == 0:
            ms = cuda_ms(lambda t: tk.out_conv_tanh_cuda(p, t), x)
            dev_ms, launches = profiled_ms(lambda t: tk.out_conv_tanh_cuda(p, t), x)
            xp = tl.pad_nhwc(x, 4, "reflect")
            wp = torch.zeros((9, 9, shape[-1], 8), device=dev)
            wp[..., :3] = p["w"]
            wp = wp.to(torch.bfloat16)
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                plain_ms = cuda_ms(lambda t: tl.out_conv_tanh_plain(
                    p, t, torch.bfloat16, torch.float32), x)
                plain_dev_ms, plain_kernels = profiled_ms(lambda t: tl.out_conv_tanh_plain(
                    p, t, torch.bfloat16, torch.float32), x)
                lib_ms = cuda_ms(lambda t: tl._conv(t, wp), xp)
            finally:
                torch.backends.cudnn.allow_tf32 = prev
            n = int(np.prod(shape[:3]))
            flops = 2 * 81 * shape[-1] * 3 * n
            mma_flops = 2 * 81 * shape[-1] * 8 * n * 5 // 9  # 5 tap pairs of 9 taps, N 8
            nbytes = n * shape[-1] * 2 + n * 3 * 4
            t_ops = flops / _cost().PEAK_BF16_S * 1e3
            t_bytes = nbytes / _cost().PEAK_BYTES_S * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            row.update(kernel_ms=ms, device_ms=dev_ms, device_kernels=launches,
                       plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
                       plain_device_kernels=plain_kernels, library_ms=lib_ms,
                       library="cuDNN bf16, Cout zero-padded to 8, pre-padded input",
                       bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / dev_ms,
                       achieved_tb_s=nbytes / (dev_ms * 1e-3) / 1e12,
                       achieved_tflop_s=flops / (dev_ms * 1e-3) / 1e12,
                       mma_tflop_s=mma_flops / (dev_ms * 1e-3) / 1e12)
            log(f"outconv {shape}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms, "
                f"{launches:.0f} kernels), plain {plain_ms:.4f} ms (device "
                f"{plain_dev_ms:.4f}, {plain_kernels:.0f} kernels), cuDNN Cout 8 "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share "
                f"{b_ms / dev_ms:.3f}, {row['achieved_tb_s']:.2f} TB/s, "
                f"{row['achieved_tflop_s']:.1f} TFLOP/s ({row['mma_tflop_s']:.1f} issued)")
            del xp, wp
        rows.append(row)
        del x, got
        torch.cuda.empty_cache()
    return rows


def outconv_only() -> None:
    """The build and the out stage's kernel alone (its check, times and
    bound at the style stream's shape, ``check_outconv``):
    ``python3 -c 'import chip_smoke; chip_smoke.outconv_only()'``."""
    from dvf_tpu_torch.ops import _build

    dev, _, _ = _only_setup()
    for line in _build.build_log.get("outconv", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas[outconv]: {line.strip()}")
    print(json.dumps({"kernels": check_outconv(dev)}))


def registry_label(name: str, kw: dict) -> str:
    args = ",".join(f"{k}={v!r}" for k, v in kw.items())
    return f"{name}({args})"


def registry_leg(dev, name: str, kw: dict, shape):
    """Phase 5 for a neural or registry filter: a Pipeline over
    REGISTRY_FRAMES frames of SyntheticSource(seed=0) in full batches, the
    launch counters zeroed just before and read just after (every count
    must stay 0 but the style net's instance_norm, STYLE_NORMS a batch,
    and its out_conv, one a batch without fast_convs).
    Every frame once and in order; the first delivered batch
    within 1 LSB of a direct ``filt.fn`` call on the card on the same
    frames; for the classical ops the kept frames also bit-exact to the
    same filter on the CPU. Returns (pipeline row, launch counts, engine)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    label = registry_label(name, kw)
    n, bsz = REGISTRY_FRAMES, shape[0]
    filt = dvf_tpu_torch.get_filter(name, **kw)
    eng = dvf_tpu_torch.Engine(filt, device=dev)
    eng.compile(shape)   # the first call's cuDNN set-up falls outside the run
    keep = (0, 1, n // 2, n - 1)
    order, kept = [], {}

    def sink(i, f, _ts):
        order.append(i)
        if i < bsz or i in keep:
            kept[i] = f

    cfg = dvf_tpu_torch.PipelineConfig(batch_size=bsz, queue_size=n + 1,
                                       assemble_timeout_s=60.0)
    src = dvf_tpu_torch.SyntheticSource(*shape[1:], n_frames=n, seed=0)
    tk.reset_launches()
    stats = dvf_tpu_torch.Pipeline(src, filt, dvf_tpu_torch.CallbackSink(sink), cfg,
                                   engine=eng).run()
    delta = dict(tk.LAUNCHES)
    if order != list(range(n)) or stats["delivered"] != n:
        raise AssertionError(f"{label}: delivered {stats['delivered']} of {n}, in "
                             f"order: {order == sorted(order)}")
    if stats["engine_batches"] != n // bsz:
        raise AssertionError(f"{label}: {stats['engine_batches']} batches, want "
                             f"{n // bsz} full ones")
    want = {k: 0 for k in delta}
    if name == "style_transfer":
        want["instance_norm"] = STYLE_NORMS * (n // bsz)
        if not kw.get("fast_convs"):
            want["out_conv"] = n // bsz
    if delta != want:
        raise AssertionError(f"{label}: launches {delta}, want {want}")
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        *shape[1:], n_frames=n, seed=0)][:-1]
    x = torch.from_numpy(np.stack(frames[:bsz])).to(dev)
    direct = to_uint8(_filter_out(filt, x if filt.uint8_ok else to_float(x), dev))
    got = np.stack([kept[i] for i in range(bsz)])
    lsb = max_lsb(got, direct.cpu().numpy())
    if lsb > 1:
        raise AssertionError(f"{label}: the first batch differs from a direct call "
                             f"by {lsb} LSB")
    extra, cpu_note = {}, ""
    if name in CLASSICAL:
        cpu = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw),
                                   device="cpu").submit(
            np.stack([frames[i] for i in keep])).fetch()
        n_diff = int((np.stack([kept[i] for i in keep]) != cpu).sum())
        if n_diff:
            raise AssertionError(f"{label}: {n_diff} bytes of the kept frames differ "
                                 f"from the CPU")
        extra = dict(bytes_differing_from_cpu=0, out_mean=float(cpu.mean()))
        cpu_note = f"; kept frames {keep} bit-exact to the CPU"
    log(f"pipeline {label}: {stats['delivered']} frames {list(shape[1:])} -> "
        f"{list(eng.out_shape[1:])}, {stats['engine_batches']} batches, "
        f"{stats['fps']:.1f} fps, p50 {stats['p50_ms']:.2f} ms, p99 "
        f"{stats['p99_ms']:.2f} ms, launches {delta}, first batch max {lsb} LSB vs "
        f"a direct call{cpu_note}")
    row = dict(filter=label, frames=n, batch=bsz, geometry=list(shape[1:]),
               out_geometry=list(eng.out_shape[1:]), fps=stats["fps"],
               p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"], launches=delta,
               max_lsb_vs_direct=lsb, **extra)
    return row, delta, eng


def stage_row(label: str, eng, shape, profile: bool) -> dict:
    """Phase 6 for one leg: the engine alone (pinned H2D, filter, D2H, back
    to back) against the host copies the pipeline adds (frames into a
    pinned slot, rows out of it); with ``profile`` also a torch.profiler
    window over batches each waited for: the card's busy share, device ms
    and kernels per batch, the top device kernels."""
    import torch

    import dvf_tpu_torch

    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        *shape[1:], n_frames=shape[0], seed=0)][:-1]
    inp = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    view = inp.numpy()
    outs = [torch.empty(eng.out_shape, dtype=torch.uint8, pin_memory=True)
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
    if profile:
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
    return row


# ---------------------------------------------------------------------------
# Phase 7: the multi-tenant serving frontend (dvf_tpu_torch.serve)
# ---------------------------------------------------------------------------

SERVE_BATCH = 16
SERVE_HD = MAIN_SHAPE[1:]        # 1080 x 1920 x 3: BASELINE configs[1] and [2]
SERVE_SD = (480, 640, 3)         # configs[0]'s geometry
SERVE_FRAMES = 32                # per session in legs (a), (c) and (d)
SWAP_FRAMES = 96                 # per session in leg (b)
BRIDGE_FRAMES = 64               # per wire in leg (e)
# Serving keeps every frame: ingress and poll queues hold a whole
# session's frames and the SLO never sheds.
SERVE_KW = dict(batch_size=SERVE_BATCH, queue_size=128, out_queue_size=128,
                slo_ms=600_000.0, stall_timeout_s=0.0)


def serve_bases(shape, n: int, seed: int) -> list:
    """One random base frame per session: a frame delivered to the wrong
    session differs everywhere."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


def tagged(base: np.ndarray, j: int) -> np.ndarray:
    """Frame ``j`` of a session: its base with row 0 set to the index."""
    f = base.copy()
    f[0] = j % 251
    return f


def serve_plain(chain: str, frames: list, dev, plain_of: dict) -> np.ndarray:
    """The plain torch version of ``chain`` on the card, in batches."""
    import torch

    from dvf_tpu_torch.utils.image import to_float, to_uint8

    fn = {"gaussian_blur(ksize=9)": plain_of["sep_blur"],
          "sobel_bilateral": plain_of["sobel_bilateral"],
          "bilateral": plain_of["bilateral"]}.get(chain)
    out = []
    for i in range(0, len(frames), SERVE_BATCH):
        x = torch.from_numpy(np.stack(frames[i:i + SERVE_BATCH])).to(dev)
        y = 255 - x if fn is None else to_uint8(fn(to_float(x)))
        out.append(y.cpu().numpy())
    return np.concatenate(out)


def serve_check(label: str, chain: str, base, got: list, n: int, dev,
                plain_of: dict) -> int:
    """One session's deliveries: indices 0..n-1 in order, every frame
    within 1 LSB of the plain version of its own input (bit-exact for
    invert). Returns the max LSB."""
    idx = [d.index for d in got]
    if idx != list(range(n)):
        raise AssertionError(f"{label}: delivered indices {idx[:8]}... "
                             f"({len(idx)} of {n}), want 0..{n - 1} in order")
    want = serve_plain(chain, [tagged(base, j) for j in range(n)], dev, plain_of)
    lsb = max_lsb(np.stack([d.frame for d in got]), want)
    if lsb > (0 if chain == "invert" else 1):
        raise AssertionError(f"{label}: frames differ from the plain version "
                             f"by {lsb} LSB")
    return lsb


def serve_drive(fe, plan: dict, per_session: int, deadline_s: float = 120.0):
    """Submit ``per_session`` frames to every session of ``plan`` ({sid:
    base}) round robin, then poll until each has them all. Returns ({sid:
    [Delivery]}, wall seconds)."""
    got = {sid: [] for sid in plan}
    t0 = time.perf_counter()
    for j in range(per_session):
        for sid, base in plan.items():
            fe.submit(sid, tagged(base, j))
    deadline = time.time() + deadline_s
    while any(len(v) < per_session for v in got.values()):
        if time.time() > deadline:
            raise AssertionError(f"serving stalled: "
                                 f"{ {s: len(v) for s, v in got.items()} } of "
                                 f"{per_session}; {fe.health()}")
        for sid in plan:
            got[sid].extend(fe.poll(sid))
        time.sleep(0.002)
    return got, time.perf_counter() - t0


def serve_counted(delta: dict, want: dict, label: str) -> None:
    """Every kernel launched exactly its expected count (0 where absent)."""
    full = {k: want.get(k, 0) for k in delta}
    if delta != full:
        raise AssertionError(f"{label}: launches {delta}, want {full}")


def bucket_of(fe, sid):
    return fe._session(sid).bucket


def serve_leg_mixed(dev, plain_of: dict):
    """(a) Mixed signatures: one frontend (batch 16, max_buckets 3,
    pool_capacity 3) serving 2 sessions of sobel_bilateral and 2 of
    gaussian_blur(ksize=9) at 1080p and 2 of invert at 480 x 640; the
    launch counters zeroed after admission (the compiles) and read after
    the run."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.obs.memory import memory_summary
    from dvf_tpu_torch.ops import kernels as tk

    cfg = dvf_tpu_torch.ServeConfig(max_buckets=3, pool_capacity=3, **SERVE_KW)
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"), cfg)
    tenants = [("sobel_bilateral", SERVE_HD, 2), ("gaussian_blur(ksize=9)",
                                                   SERVE_HD, 2),
               ("invert", SERVE_SD, 2)]
    plan, chain_of, t_admit = {}, {}, {}
    with fe:
        seed = 70
        for chain, shape, n in tenants:
            t = time.perf_counter()
            for base in serve_bases(shape, n, seed):
                sid = fe.open_stream(op_chain=chain, frame_shape=shape)
                plan[sid], chain_of[sid] = base, chain
            t_admit[chain] = (time.perf_counter() - t) * 1e3
            seed += 1
        tk.reset_launches()
        got, wall = serve_drive(fe, plan, SERVE_FRAMES)
        delta = dict(tk.LAUNCHES)
        st = fe.stats()
        mem = memory_summary()
        # invert at 480 x 640 pins the constructor's (invert) bucket, which
        # compiles at its first batch on the dispatch thread, as the
        # reference's default bucket does; the others compiled at admission
        quiet = {chain_of[s]: calibrations(bucket_of(fe, s).engine) for s in plan}
    batches = {chain_of[s]: bucket_of(fe, s).engine.stats.batches for s in plan}
    serve_counted(delta, {"sobel_bilateral": batches["sobel_bilateral"],
                          "sep_blur": batches["gaussian_blur(ksize=9)"]},
                  "serve (a)")
    if not (delta["sep_blur"] and delta["sobel_bilateral"]):
        raise AssertionError(f"serve (a): K1/K3 never launched: {delta}")
    lsb = {sid: serve_check(f"serve (a) {chain_of[sid]} {sid}", chain_of[sid],
                            plan[sid], got[sid], SERVE_FRAMES, dev, plain_of)
           for sid in plan}
    buckets = {}
    for label, row in st["buckets"].items():
        buckets[label] = dict(
            fps=row["fps"], p50_ms=row["p50_ms"], p99_ms=row["p99_ms"],
            batches=row["batches"], mean_valid_rows=row["mean_valid_rows"],
            tick_cost_ms=row["tick_cost_ms"],
            ingest=row.get("ingest", {}).get("mode"),
            ingest_fallback=row.get("ingest", {}).get("fallback_reason"),
            egress=row.get("egress", {}).get("mode"),
            egress_fallback=row.get("egress", {}).get("fallback_reason"))
        log(f"serve (a) bucket {label}: {row['batches']} batches, fps "
            f"{row['fps']:.1f}, p50 {row['p50_ms']:.2f} ms, p99 "
            f"{row['p99_ms']:.2f} ms, mean valid rows {row['mean_valid_rows']}, "
            f"tick-cost estimate {row['tick_cost_ms']:.3f} ms, ingest "
            f"{buckets[label]['ingest']} ({buckets[label]['ingest_fallback']}), "
            f"egress {buckets[label]['egress']} "
            f"({buckets[label]['egress_fallback']})")
    for chain, cal in quiet.items():
        log(f"serve (a) {chain}: admission {t_admit[chain]:.1f} ms for its "
            f"sessions; compile calibrations {json.dumps(cal)}")
    log("serve (a): a bucket's tick-cost estimate starts from its first "
        "sampled batch (submit -> collected, on an empty window), which "
        "includes building its pinned staging and delivery slabs")
    sessions = {}
    for sid in plan:
        s = st["sessions"][sid]
        sessions[sid] = dict(chain=chain_of[sid], delivered=s["delivered"],
                             p50_ms=s["p50_ms"], p99_ms=s["p99_ms"],
                             max_lsb=lsb[sid])
        log(f"serve (a) session {sid} {chain_of[sid]}: {s['delivered']} frames "
            f"in order, p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms, max "
            f"{lsb[sid]} LSB vs plain")
    frames = sum(len(v) for v in got.values())
    log(f"serve (a): {frames} frames in {wall:.3f} s ({frames / wall:.1f} fps "
        f"over all buckets), launches {delta}, pool {json.dumps(st['pool'])}, "
        f"memory_summary {json.dumps(mem)}, aggregate p50 "
        f"{st['aggregate']['p50_ms']:.2f} ms, p99 {st['aggregate']['p99_ms']:.2f} ms")
    torch.cuda.empty_cache()
    return dict(leg="a_mixed", frames=frames, wall_s=wall, fps=frames / wall,
                launches=delta, buckets=buckets, sessions=sessions,
                pool=st["pool"], memory_summary=mem,
                aggregate=st["aggregate"], calibrations_quiet=quiet), delta


def calibrations(eng) -> dict:
    return dict(batch=eng.signature[0][0] if eng.signature else None,
                h2d_block_ms=eng.h2d_block_ms, d2h_block_ms=eng.d2h_block_ms,
                step_block_ms=eng.step_block_ms,
                last_compile_ms=eng.last_compile_ms)


def serve_leg_swap(dev, plain_of: dict):
    """(b) Hot swap under load: request_batch_size 16 -> 8 -> 16 on the
    sobel_bilateral bucket (2 sessions) while its sessions stream, a
    bilateral bucket (1 session) beside it; every frame within 1 LSB
    throughout. The successor programs' calibrations are measured under
    that load; quiet ones beside them: the admission compile (batch 16)
    and a fresh engine compiled at batch 8 after the leg."""
    import threading

    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk

    cfg = dvf_tpu_torch.ServeConfig(max_buckets=3, **SERVE_KW)
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"), cfg)
    plan, chain_of = {}, {}
    with fe:
        for chain, n, seed in (("sobel_bilateral", 2, 80), ("bilateral", 1, 81)):
            for base in serve_bases(SERVE_HD, n, seed):
                sid = fe.open_stream(op_chain=chain, frame_shape=SERVE_HD)
                plan[sid], chain_of[sid] = base, chain
        sob = next(s for s in plan if chain_of[s] == "sobel_bilateral")
        bucket = bucket_of(fe, sob)
        label = bucket.label()
        quiet16 = calibrations(bucket.engine)
        got = {sid: [] for sid in plan}
        failed = []

        def produce():
            try:
                for j in range(SWAP_FRAMES):
                    # a bounded backlog: about two batches per session
                    while j - min(len(v) for v in got.values()) > 2 * SERVE_BATCH:
                        time.sleep(0.001)
                    for sid, base in plan.items():
                        fe.submit(sid, tagged(base, j))
            except BaseException as e:   # noqa: BLE001 — raised below
                failed.append(e)

        tk.reset_launches()
        t0 = time.perf_counter()
        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        under_load = []
        deadline = time.time() + 120.0
        targets = [(SWAP_FRAMES // 6, 8), (SWAP_FRAMES // 2, 16)]
        while any(len(v) < SWAP_FRAMES for v in got.values()):
            if time.time() > deadline or failed:
                raise AssertionError(f"serve (b) stalled or failed: {failed} "
                                     f"{ {s: len(v) for s, v in got.items()} }")
            for sid in plan:
                got[sid].extend(fe.poll(sid))
            if targets and len(got[sob]) >= targets[0][0]:
                n_swaps = fe.swaps
                fe.request_batch_size(label, targets[0][1],
                                      reason=f"leg (b) to {targets[0][1]}")
                while fe.swaps == n_swaps and fe.swap_aborts == 0:
                    if time.time() > deadline:
                        raise AssertionError("serve (b): the swap never committed")
                    for sid in plan:
                        got[sid].extend(fe.poll(sid))
                    time.sleep(0.001)
                under_load.append(calibrations(bucket.engine))
                targets.pop(0)
            time.sleep(0.002)
        wall = time.perf_counter() - t0
        producer.join(timeout=10.0)
        delta = dict(tk.LAUNCHES)
        st = fe.stats()
        swaps = [e for e in fe.ledger.snapshot() if e["kind"] == "swap"]
        eng_batches = {chain_of[s]: bucket_of(fe, s).engine.stats.batches
                       for s in plan}
        compiles = {chain_of[s]: bucket_of(fe, s).engine.stats.compile_count
                    for s in plan}
    quiet8 = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("sobel_bilateral"))
    quiet8.compile((8, *SERVE_HD))
    quiet8 = calibrations(quiet8)
    if fe.swaps != 2 or fe.swap_aborts:
        raise AssertionError(f"serve (b): swaps {fe.swaps}, aborts {fe.swap_aborts}")
    # Each swap's successor compile launches its kernel twice (the warm-up
    # step and the step calibration) inside the counted run.
    serve_counted(delta, {"sobel_bilateral": eng_batches["sobel_bilateral"]
                          + 2 * (compiles["sobel_bilateral"] - 1),
                          "bilateral": eng_batches["bilateral"]}, "serve (b)")
    lsb = {sid: serve_check(f"serve (b) {chain_of[sid]} {sid}", chain_of[sid],
                            plan[sid], got[sid], SWAP_FRAMES, dev, plain_of)
           for sid in plan}
    events = [dict(batch_size=e.get("batch_size"), stall_ms=e.get("stall_ms"),
                   compile_aside_ms=e.get("compile_aside_ms"),
                   migrate_ms=e.get("migrate_ms"), wall_ms=e.get("wall_ms"),
                   aborted=bool(e.get("aborted"))) for e in swaps]
    frames = sum(len(v) for v in got.values())
    log(f"serve (b): {frames} frames in {wall:.3f} s, swaps {fe.swaps}, "
        f"swap_aborts {fe.swap_aborts}, stall events "
        f"{st['ledger']['stall_events_total']}, launches {delta}, max LSB "
        f"{max(lsb.values())}; swap events {json.dumps(events)}")
    log(f"serve (b) calibrations of {label}: quiet batch 16 (admission) "
        f"{json.dumps(quiet16)}; under load {json.dumps(under_load)}; quiet "
        f"batch 8 (fresh engine after the leg) {json.dumps(quiet8)}")
    torch.cuda.empty_cache()
    return dict(leg="b_hot_swap", frames=frames, wall_s=wall, swaps=fe.swaps,
                swap_aborts=fe.swap_aborts, swap_events=events,
                stall_events_total=st["ledger"]["stall_events_total"],
                launches=delta, max_lsb=max(lsb.values()),
                calibrations_quiet_b16=quiet16, calibrations_under_load=under_load,
                calibrations_quiet_b8=quiet8), delta


def serve_leg_pool(dev, plain_of: dict):
    """(c) Pool eviction and re-admission: pool_capacity 2, max_buckets 2,
    three signatures served one after another (each admission retires the
    idle bucket before it, whose program stays warm until the pool evicts
    it), then the first again: a recompile. memory_allocated after stop()
    within 1 MiB of its value before the leg. Stateless programs hold no
    device state, so their evictions free 0 state bytes; a ProgramPool of
    one with a stateful engine (ema_smooth at 1080p) shows the freed-bytes
    counter advancing by the evicted state."""
    import gc

    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.runtime import engine as reng

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    freed0 = reng.freed_device_bytes_total()
    cfg = dvf_tpu_torch.ServeConfig(max_buckets=2, pool_capacity=2, **SERVE_KW)
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"), cfg)
    sigs = [("gaussian_blur(ksize=9)", SERVE_HD), ("sobel_bilateral", SERVE_HD),
            ("gaussian_blur(ksize=9)", SERVE_SD), ("gaussian_blur(ksize=9)", SERVE_HD)]
    steps = []
    tk.reset_launches()
    with fe:
        for i, (chain, shape) in enumerate(sigs):
            misses = fe.pool.misses
            t = time.perf_counter()
            sid = fe.open_stream(op_chain=chain, frame_shape=shape)
            admit_ms = (time.perf_counter() - t) * 1e3
            base = serve_bases(shape, 1, 90 + i)[0]
            got, _ = serve_drive(fe, {sid: base}, SERVE_BATCH)
            lsb = serve_check(f"serve (c) {chain} {shape}", chain, base, got[sid],
                              SERVE_BATCH, dev, plain_of)
            fe.close(sid, drain=True)
            deadline = time.time() + 30.0
            while fe.open_count():
                if time.time() > deadline:
                    raise AssertionError("serve (c): a session never retired")
                time.sleep(0.002)
            steps.append(dict(signature=f"{chain}|{'x'.join(map(str, shape))}",
                              compiled=fe.pool.misses > misses,
                              admit_ms=admit_ms, pool=fe.pool.stats(),
                              max_lsb=lsb))
        compiles = [e for e in fe.ledger.snapshot() if e["kind"] == "compile"]
        evicts = [e for e in fe.ledger.snapshot() if e["kind"] == "pool_evict"]
    delta = dict(tk.LAUNCHES)
    del fe
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    leaked = reng.live_pool_engines()
    readmit = steps[-1]
    if not (steps[-1]["pool"]["evictions"] >= 1 and readmit["compiled"]
            and len(compiles) == 4 and not leaked):
        raise AssertionError(f"serve (c): steps {json.dumps(steps)}, compiles "
                             f"{len(compiles)}, live pool engines {len(leaked)}")
    if abs(after - before) > 1 << 20:
        raise AssertionError(f"serve (c): memory_allocated {before} before the "
                             f"leg, {after} after stop()")
    freed_serve = reng.freed_device_bytes_total() - freed0
    # The freed-bytes counter on a stateful program's eviction.
    pool = reng.ProgramPool(capacity=1)
    ema = pool.acquire("ema", lambda: _compiled(dvf_tpu_torch.get_filter(
        "ema_smooth"), (SERVE_BATCH, *SERVE_HD)))
    state_bytes = ema.state_bytes
    pool.release("ema")
    mem_ema = torch.cuda.memory_allocated()
    freed1 = reng.freed_device_bytes_total()
    pool.acquire("invert", lambda: _compiled(dvf_tpu_torch.get_filter("invert"),
                                             (SERVE_BATCH, *SERVE_HD)))
    freed_ema = reng.freed_device_bytes_total() - freed1
    dropped = mem_ema - torch.cuda.memory_allocated()
    pool.close()
    del ema
    if not (state_bytes > 0 and freed_ema == state_bytes and dropped >= state_bytes
            and pool.evictions == 1):
        raise AssertionError(f"serve (c): ema state {state_bytes} B, counter "
                             f"+{freed_ema}, memory_allocated -{dropped}")
    log(f"serve (c): steps {json.dumps(steps)}; {len(evicts)} evictions "
        f"({[e.get('signature') for e in evicts]}), {len(compiles)} compiles "
        f"(the re-admission recompiled), launches {delta}; memory_allocated "
        f"{before} B before the leg, {after} B after stop() "
        f"({after - before:+d} B); engine_freed_bytes_total +{freed_serve} B "
        f"over the serving evictions (stateless programs hold no device "
        f"state); a stateful eviction (ema_smooth {SERVE_HD}): state "
        f"{state_bytes} B, counter +{freed_ema} B, memory_allocated "
        f"-{dropped} B")
    return dict(leg="c_pool", steps=steps, evictions=len(evicts),
                compiles=len(compiles), launches=delta,
                memory_allocated_before=before, memory_allocated_after=after,
                freed_bytes_serving=freed_serve, ema_state_bytes=state_bytes,
                freed_bytes_ema_eviction=freed_ema,
                memory_allocated_drop_ema=dropped), delta


def _compiled(filt, shape):
    import dvf_tpu_torch

    eng = dvf_tpu_torch.Engine(filt)
    eng.compile(shape)
    return eng


def serve_leg_chaos(dev, plain_of: dict):
    """(d) Compute chaos in one bucket: after one clean frame each, three
    compute faults armed on the invert bucket's engine while both
    sessions stream SERVE_FRAMES frames; the sobel_bilateral bucket's
    frames arrive complete, in order and within 1 LSB; the faults (three
    failed batches) are attributed to the invert bucket and its session
    only, no recovery runs, and a second wave on the invert session is
    delivered whole and exact once the faults are spent."""
    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.resilience import FaultPlan

    kw = dict(SERVE_KW, fault_budget=16)
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"),
                                     dvf_tpu_torch.ServeConfig(**kw))
    n = SERVE_FRAMES
    with fe:
        good = fe.open_stream(op_chain="sobel_bilateral", frame_shape=SERVE_HD)
        bad = fe.open_stream(op_chain="invert", frame_shape=SERVE_SD)
        gbase, bbase = serve_bases(SERVE_HD, 1, 100)[0], serve_bases(SERVE_SD, 1, 101)[0]
        first, _ = serve_drive(fe, {good: gbase, bad: bbase}, 1)
        bucket_bad = bucket_of(fe, bad)
        bucket_bad.engine.chaos = FaultPlan(seed=7).add("compute", every=1, count=3)
        tk.reset_launches()
        got = {good: list(first[good]), bad: list(first[bad])}
        for j in range(1, n):
            fe.submit(good, tagged(gbase, j))
            fe.submit(bad, tagged(bbase, j))
            time.sleep(0.002)
        deadline = time.time() + 60.0

        def settled(total):
            sb = fe.stats()["sessions"][bad]
            return sb["delivered"] + sb["failed"] + sb["shed"] \
                + sb["dropped_at_ingress"] >= total

        while len(got[good]) < n or not settled(n):
            if time.time() > deadline:
                raise AssertionError(f"serve (d) stalled: {fe.health()}")
            for sid in (good, bad):
                got[sid].extend(fe.poll(sid))
            time.sleep(0.002)
        got[bad].extend(fe.poll(bad))
        j = n
        # batches that happened to carry wave 1 may have left a fault
        # unspent: one frame at a time until all three have fired
        while fe.stats()["buckets"][bucket_bad.label()]["faults"].get(
                "compute", 0) < 3:
            fe.submit(bad, tagged(bbase, j))
            j += 1
            while not settled(j):
                if time.time() > deadline:
                    raise AssertionError(f"serve (d) stalled: {fe.health()}")
                time.sleep(0.002)
        got[bad].extend(fe.poll(bad))
        wave1 = fe.stats()["sessions"][bad]
        w2 = j
        for j in range(w2, w2 + n):   # the faults are spent: all delivered
            fe.submit(bad, tagged(bbase, j))
        while not settled(w2 + n):
            if time.time() > deadline:
                raise AssertionError(f"serve (d) stalled: {fe.health()}")
            got[bad].extend(fe.poll(bad))
            time.sleep(0.002)
        got[bad].extend(fe.poll(bad))
        st = fe.stats()
    delta = dict(tk.LAUNCHES)
    lsb = serve_check("serve (d) healthy sobel_bilateral", "sobel_bilateral",
                      gbase, got[good], n, dev, plain_of)
    sb, sg = st["sessions"][bad], st["sessions"][good]
    rows = st["buckets"]
    second = [d.index for d in got[bad] if d.index >= w2]
    if not (sb["failed"] == wave1["failed"] > 0
            and sb["faults"] == {"compute": sb["failed"]}
            and sg["failed"] == 0 and sg["faults"] == {}
            and rows[bucket_bad.label()]["faults"] == {"compute": 3}
            and st["recoveries"] == 0 and second == list(range(w2, w2 + n))
            and sb["submitted"] == sb["delivered"] + sb["shed"] + sb["failed"]
            + sb["dropped_at_ingress"]):
        raise AssertionError(f"serve (d): chaos session {sb}, healthy {sg}, "
                             f"recoveries {st['recoveries']}, second wave "
                             f"{second[:8]}...")
    # what the chaos bucket delivered is exact
    for d in got[bad]:
        if not np.array_equal(d.frame, 255 - tagged(bbase, d.index)):
            raise AssertionError(f"serve (d): chaos bucket frame {d.index} wrong")
    log(f"serve (d): healthy sobel_bilateral {len(got[good])}/{n} in order, max "
        f"{lsb} LSB; chaos invert bucket: {sb['failed']} frames failed in its "
        f"3 faulted batches, faults {sb['faults']}, bucket faults "
        f"{rows[bucket_bad.label()]['faults']}, recoveries {st['recoveries']}, "
        f"then {len(second)}/{n} of a second wave delivered exact; launches "
        f"{delta}")
    return dict(leg="d_chaos", healthy_delivered=len(got[good]), healthy_max_lsb=lsb,
                chaos_delivered=sb["delivered"], chaos_failed=sb["failed"],
                chaos_faults=sb["faults"], recoveries=st["recoveries"],
                launches=delta), delta


def serve_leg_bridge(dev):
    """(e) ZmqStreamBridge: a reference-style app (ROUTER fan-out + PULL
    collect on tcp loopback) sends BRIDGE_FRAMES frames of invert at
    480 x 640, once on the raw wire and once on the delta wire over the
    raw inner codec (no libjpeg on the card); every result exact and in
    the app's order."""
    import socket
    import threading

    import zmq

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.serve import ZmqStreamBridge
    from dvf_tpu_torch.transport.codec import DeltaCodec, RawCodec

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    h, w, _ = SERVE_SD
    base = serve_bases(SERVE_SD, 1, 110)[0]
    frames = []
    for j in range(BRIDGE_FRAMES):   # a moving block: the delta wire
        f = base.copy()              # carries a few tiles per frame
        y = 32 + 4 * j
        f[y:y + 64, 96:224] = 255 - f[y:y + 64, 96:224]
        frames.append(f)
    cfg = dvf_tpu_torch.ServeConfig(**dict(SERVE_KW, queue_size=BRIDGE_FRAMES))
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"), cfg)
    rows = []
    tk.reset_launches()
    with fe:
        for wire in ("raw", "delta"):
            def codec():
                return DeltaCodec(RawCodec(h, w), tile=32, keyframe_interval=16)

            app_enc = codec() if wire == "delta" else None
            app_dec = codec() if wire == "delta" else None
            p_dist, p_coll = free_port(), free_port()
            ctx = zmq.Context()
            router = ctx.socket(zmq.ROUTER)
            router.bind(f"tcp://127.0.0.1:{p_dist}")
            pull = ctx.socket(zmq.PULL)
            pull.bind(f"tcp://127.0.0.1:{p_coll}")
            order, wrong, nbytes = [], [], 0
            t0 = time.perf_counter()
            try:
                bridge = ZmqStreamBridge(
                    fe, host="127.0.0.1", distribute_port=p_dist,
                    collect_port=p_coll, wire=wire, raw_shape=(h, w),
                    codec=codec() if wire == "delta" else None)
                bt = threading.Thread(target=bridge.run,
                                      kwargs={"max_frames": BRIDGE_FRAMES},
                                      daemon=True)
                bt.start()
                pending = list(range(BRIDGE_FRAMES))
                deadline = time.time() + 60.0
                while len(order) < BRIDGE_FRAMES and time.time() < deadline:
                    if router.poll(5):
                        ident, _ready = router.recv_multipart()
                        if pending:
                            i = pending.pop(0)
                            blob = (frames[i].tobytes() if app_enc is None
                                    else app_enc.encode(frames[i]))
                            router.send_multipart([ident, str(i).encode(), blob])
                    while pull.poll(0):
                        idx_b, _pid, _t0, _t1, res = pull.recv_multipart()
                        i = int(idx_b.decode())
                        nbytes += len(res)
                        out = (np.frombuffer(res, np.uint8).reshape(h, w, 3)
                               if app_dec is None else app_dec.decode(res))
                        order.append(i)
                        if not np.array_equal(out, 255 - frames[i]):
                            wrong.append(i)
                bridge.stop()
                bt.join(timeout=10.0)
                bstats = bridge.stats()
                bridge.close()
            finally:
                for c in (app_enc, app_dec):
                    if c is not None:
                        c.close()
                router.close(0)
                pull.close(0)
                ctx.term()
            wall = time.perf_counter() - t0
            if order != list(range(BRIDGE_FRAMES)) or wrong or bstats["errors"]:
                raise AssertionError(f"serve (e) {wire}: order {order[:8]}... "
                                     f"({len(order)}), wrong {wrong[:8]}, bridge "
                                     f"{bstats}")
            log(f"serve (e) bridge {wire} wire: {BRIDGE_FRAMES} frames {SERVE_SD} "
                f"exact and in order in {wall:.3f} s "
                f"({BRIDGE_FRAMES / wall:.1f} fps), {nbytes} result bytes, "
                f"bridge {json.dumps(bstats)}")
            rows.append(dict(wire=wire, frames=BRIDGE_FRAMES, wall_s=wall,
                             fps=BRIDGE_FRAMES / wall, result_bytes=nbytes,
                             bridge=bstats))
    delta = dict(tk.LAUNCHES)
    serve_counted(delta, {}, "serve (e)")
    return dict(leg="e_bridge", wires=rows, launches=delta), delta


def _only_setup():
    """The bring-up every ``*_only()`` shares: the port on the path, TF32
    off, the card, the host and the build logged. Returns (the card, the
    plain versions of K1-K3 by kernel name, the host environment)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dvf_tpu_torch
    from dvf_tpu_torch.ops import _build
    from dvf_tpu_torch.ops.bilateral import bilateral_nhwc
    from dvf_tpu_torch.ops.conv import gaussian_kernel_1d, sep_conv2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    env = host_env()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}; "
        f"environment: {json.dumps(env)}; torch {torch.__version__}")
    log(f"build: {json.dumps({k: round(v, 2) for k, v in _build.build_all().items()})}")
    k9 = gaussian_kernel_1d(9, 0.0)
    chain = dvf_tpu_torch.get_filter("sobel_bilateral", impl="chain")
    plain_of = {"sep_blur": lambda x: sep_conv2d(x, k9, k9, impl="shift"),
                "bilateral": lambda x: bilateral_nhwc(x),
                "sobel_bilateral": lambda x: chain.fn(x, None)[0]}
    return torch.device("cuda", 0), plain_of, env


def serve_only() -> None:
    """The build and phase 7 alone (a quick check of the serving legs):
    ``python3 -c 'import chip_smoke; chip_smoke.serve_only()'``."""
    dev, plain_of, _ = _only_setup()
    rows, _ = serve_phase(dev, plain_of)
    print(json.dumps({"serve": rows}))


def serve_phase(dev, plain_of: dict):
    """Phase 7: legs (a)-(e) of the serving frontend. Returns (rows, the
    summed launch counts of the legs' counted runs)."""
    t0 = time.perf_counter()
    rows, total = [], {}
    for leg in (lambda: serve_leg_mixed(dev, plain_of),
                lambda: serve_leg_swap(dev, plain_of),
                lambda: serve_leg_pool(dev, plain_of),
                lambda: serve_leg_chaos(dev, plain_of),
                lambda: serve_leg_bridge(dev)):
        row, delta = leg()
        rows.append(row)
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
    from dvf_tpu_torch.runtime.engine import live_pool_engines

    if live_pool_engines():
        raise AssertionError(f"serve: pool engines outlived their frontends: "
                             f"{[e.op_chain for e in live_pool_engines()]}")
    log(f"serve phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total



# ---------------------------------------------------------------------------
# Phase 8: the supervised rebuild (F1) and the worker's wire (the native ring)
# ---------------------------------------------------------------------------

REBUILD_BATCH = 4                # leg (a): 4 x 1080 x 1920 x 3, sobel_bilateral
RING_FRAMES = 160                # leg (b): frames per 1080p batch-16 pipeline
RING_DEFAULT_CAPACITY = 10       # RingFrameQueue's default (~62 MB at 1080p)


def _serve_sync(fe, sid, frame, deadline_s: float = 60.0) -> None:
    """Submit one frame and wait until it resolved (delivered or failed):
    each batch then carries exactly that frame."""
    s = fe._session(sid)
    before = s.delivered + s.failed
    fe.submit(sid, frame)
    deadline = time.time() + deadline_s
    while s.delivered + s.failed < before + 1:
        if time.time() > deadline:
            raise AssertionError(f"ring (a): serving stalled: {fe.health()}")
        time.sleep(0.002)


def ring_leg_rebuild(dev, plain_of: dict):
    """(a) The supervised rebuild on the card: a ServeFrontend of
    sobel_bilateral at 4 x 1080 x 1920 with fault_budget 2. After two
    healthy batches the live engine's step is replaced by one that
    raises; the third fault overflows the budget and the frontend rebuilds
    the program aside and adopts it. Exactly one recovery, faults
    {"compute": 3}, the rebuilt engine serves, every delivered frame
    within 1 LSB of the plain version, and K3 launched exactly what the
    engine ran: two per compile (warm-up and step calibration) and one per
    delivered batch."""
    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk

    fe = dvf_tpu_torch.ServeFrontend(
        dvf_tpu_torch.get_filter("sobel_bilateral"),
        dvf_tpu_torch.ServeConfig(batch_size=REBUILD_BATCH, queue_size=64,
                                  out_queue_size=64, slo_ms=600_000.0,
                                  stall_timeout_s=0.0, fault_budget=2),
        device=dev)
    base = serve_bases(SERVE_HD, 1, 200)[0]
    tk.reset_launches()
    with fe:
        sid = fe.open_stream()
        eng = fe.engine
        c0, b0 = eng.stats.compile_count, eng.stats.batches
        for j in range(2):
            _serve_sync(fe, sid, tagged(base, j))

        def dead_step(*a, **k):
            raise RuntimeError("engine died (forced)")

        eng._step = dead_step
        for j in range(2, 5):
            _serve_sync(fe, sid, tagged(base, j))
        deadline = time.time() + 60.0
        while fe.recoveries < 1:
            if time.time() > deadline:
                raise AssertionError(f"ring (a): no rebuild: {fe.health()}")
            time.sleep(0.002)
        if fe.engine is not eng or eng._step is dead_step:
            raise AssertionError("ring (a): the rebuild kept the broken step")
        _serve_sync(fe, sid, tagged(base, 5))
        got = fe.poll(sid)
        st = fe.stats()
        compiles = eng.stats.compile_count - c0
        batches = eng.stats.batches - b0
        prep, swap = dict(eng.last_prepare or {}), dict(eng.last_swap or {})
        events = [e for e in st["ledger"]["events"] if e["kind"] == "engine_rebuild"]
    delta = dict(tk.LAUNCHES)
    sess = st["sessions"][sid]
    idx = [d.index for d in got]
    if not (st["recoveries"] == 1 and st["faults"]["by_kind"] == {"compute": 3}
            and sess["faults"] == {"compute": 3} and sess["delivered"] == 3
            and idx == [0, 1, 5] and fe._error is None):
        raise AssertionError(f"ring (a): recoveries {st['recoveries']}, faults "
                             f"{st['faults']['by_kind']}, session {sess}, "
                             f"delivered {idx}")
    want = serve_plain("sobel_bilateral", [tagged(base, i) for i in idx], dev, plain_of)
    lsb = max_lsb(np.stack([d.frame for d in got]), want)
    if lsb > 1:
        raise AssertionError(f"ring (a): frames differ from the plain version by "
                             f"{lsb} LSB")
    want_k3 = 2 * compiles + batches
    if compiles != 2 or batches != 3:
        raise AssertionError(f"ring (a): {compiles} compiles and {batches} batches, "
                             f"want 2 (first and rebuilt program) and 3")
    serve_counted(delta, {"sobel_bilateral": want_k3}, "ring (a)")
    log(f"ring (a) supervised rebuild (sobel_bilateral {REBUILD_BATCH} x "
        f"{SERVE_HD[0]} x {SERVE_HD[1]}, fault_budget 2): recoveries "
        f"{st['recoveries']}, faults {st['faults']['by_kind']}, delivered {idx}, max "
        f"{lsb} LSB; rebuild compile_aside_ms {prep.get('compile_aside_ms')}, "
        f"stall_ms {swap.get('stall_ms')}, ledger engine_rebuild "
        f"{json.dumps(events[-1] if events else None)}; compiles {compiles}, "
        f"batches {batches}, launches {delta} (2 per compile + 1 per batch)")
    return dict(leg="a_rebuild", recoveries=st["recoveries"],
                faults=st["faults"]["by_kind"], delivered=idx, max_lsb=lsb,
                compile_aside_ms=prep.get("compile_aside_ms"),
                stall_ms=swap.get("stall_ms"), compiles=compiles, batches=batches,
                launches=delta), delta


def ring_pipeline_leg(dev, name: str, counter, mode: str, transport: str,
                      plain_of: dict, capacity=None):
    """(b) One 1080p batch-16 Pipeline over ``transport`` ("ring": a raw
    RingFrameQueue of ``capacity`` frames, default RING_FRAMES + 1;
    "queue": the DropOldestQueue of phase 5 with the same bound), launch
    counters zeroed just before and read just after. Every delivered
    index in order, each frame exact (invert) or within 1 LSB of the plain
    version of its own index."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.transport.ring_queue import RingFrameQueue
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    n = RING_FRAMES
    cap = capacity or n + 1
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name), device=dev)
    eng.compile(MAIN_SHAPE)
    queue = RingFrameQueue(MAIN_SHAPE[1:], capacity_frames=cap) \
        if transport == "ring" else None
    cfg = dvf_tpu_torch.PipelineConfig(batch_size=MAIN_SHAPE[0], queue_size=cap,
                                       ingest=mode, egress=mode)
    kept = {}
    order = []

    def sink(i, f, _ts):
        order.append(i)
        kept[i] = f

    src = dvf_tpu_torch.SyntheticSource(*MAIN_SHAPE[1:], n_frames=n, seed=0)
    b0 = eng.stats.batches
    load0 = os.getloadavg()
    tk.reset_launches()
    pipe = dvf_tpu_torch.Pipeline(src, eng.filter, dvf_tpu_torch.CallbackSink(sink),
                                  cfg, engine=eng, queue=queue)
    with gates_open() if mode == "streamed" else contextlib.nullcontext():
        stats = pipe.run()
    delta = dict(tk.LAUNCHES)
    batches = eng.stats.batches - b0
    load1 = os.getloadavg()
    label = f"{name} over {'RingFrameQueue' if queue is not None else 'DropOldestQueue'}" \
            f"(capacity {cap}) [ingest/egress {mode}]"
    if order != sorted(set(order)) or stats["delivered"] != len(order) \
            or stats["delivered"] + stats["dropped_at_ingest"] > n:
        raise AssertionError(f"ring (b) {label}: delivered {stats['delivered']}, "
                             f"dropped {stats['dropped_at_ingest']}, in order "
                             f"{order == sorted(order)}")
    if stats["transport"] != ("RingFrameQueue" if queue is not None else "DropOldestQueue"):
        raise AssertionError(f"ring (b) {label}: transport {stats['transport']}")
    want_delta = {k: (batches if k == counter else 0) for k in delta}
    if delta != want_delta:
        raise AssertionError(f"ring (b) {label}: launches {delta}, want {want_delta}")
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        *MAIN_SHAPE[1:], n_frames=n, seed=0)][:-1]
    lsb = 0
    plain = plain_of.get(counter)
    for s in range(0, len(order), MAIN_SHAPE[0]):
        ids = order[s:s + MAIN_SHAPE[0]]
        x = torch.from_numpy(np.stack([frames[i] for i in ids])).to(dev)
        want = (255 - x if plain is None else to_uint8(plain(to_float(x)))).cpu().numpy()
        lsb = max(lsb, max_lsb(np.stack([kept[i] for i in ids]), want))
    if lsb > (0 if plain is None else 1):
        raise AssertionError(f"ring (b) {label}: delivered frames differ from the "
                             f"plain version of their own index by {lsb} LSB")
    ing, egr = stats.get("ingest", {}), stats.get("egress", {})
    log(f"ring (b) {label}: {stats['delivered']} of {n} delivered in order, ring "
        f"drops {stats['dropped_at_ingest']}, {batches} batches, {stats['fps']:.1f} "
        f"fps, p50 {stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms, max {lsb} "
        f"LSB vs plain; ingest {ing.get('mode')} ({ing.get('fallback_reason')}), "
        f"egress {egr.get('mode')} ({egr.get('fallback_reason')}); host loadavg "
        f"{load0[0]:.2f} -> {load1[0]:.2f} (of {os.cpu_count()} cores); launches {delta}")
    row = dict(filter=name, transport=stats["transport"], capacity_frames=cap,
               mode=mode, frames=n, delivered=stats["delivered"],
               dropped=stats["dropped_at_ingest"], fps=stats["fps"],
               p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"], max_lsb=lsb,
               ingest_mode=ing.get("mode"), egress_mode=egr.get("mode"),
               loadavg_1m=[load0[0], load1[0]], launches=delta)
    del kept, frames
    eng.free()
    return row, delta


def ring_copy_ms(samples: int = 32) -> dict:
    """The host copies a raw RingFrameQueue adds per 1080p frame against
    the DropOldestQueue's handoff of the array itself: ``tobytes`` (the
    serialize in ``put``), the native push (a memcpy into the ring), the
    pop (a memcpy out into a new ``bytes``); and the row copy into the
    staging slab that both transports pay (``decode_into``), beside a
    plain ``np.copyto`` of one frame. Medians in ms."""
    from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

    frame = np.random.default_rng(0).integers(0, 255, MAIN_SHAPE[1:], np.uint8)
    staging = np.empty((1,) + MAIN_SHAPE[1:], np.uint8)
    q = RingFrameQueue(MAIN_SHAPE[1:], capacity_frames=4)
    ts = {k: [] for k in ("tobytes", "push", "pop", "decode_into", "copyto")}
    try:
        for i in range(samples + 2):
            t0 = time.perf_counter()
            payload = frame.tobytes()
            t1 = time.perf_counter()
            q.ring.push(payload, i, 0.0)
            t2 = time.perf_counter()
            items = q.pop_up_to(1)
            t3 = time.perf_counter()
            q.decode_into(items, staging)
            t4 = time.perf_counter()
            np.copyto(staging[0], frame)
            t5 = time.perf_counter()
            if i >= 2:  # the first two touch fresh pages
                for k, a, b in (("tobytes", t0, t1), ("push", t1, t2), ("pop", t2, t3),
                                ("decode_into", t3, t4), ("copyto", t4, t5)):
                    ts[k].append((b - a) * 1e3)
            del payload, items
    finally:
        q.close()
    out = {k: float(np.median(v)) for k, v in ts.items()}
    out["ring_extra"] = out["tobytes"] + out["push"] + out["pop"]
    log(f"ring (b) host copies per {MAIN_SHAPE[1:]} frame (medians of {samples}, "
        f"ms): {json.dumps(out)}; the ring's extra over the queue's handoff is "
        f"tobytes + push + pop")
    return out


def ring_pipeline_phase(dev, plain_of: dict):
    """(b) invert and sobel_bilateral over the ring, streamed and
    monolithic, beside the DropOldestQueue leg at the same shape and bound
    (streamed), the streamed pair timed queue, ring, ring, queue so that
    neither transport alone runs first; invert again over the ring at its
    default capacity; the ring's host copies per frame."""
    rows, total = [], {}
    for name, counter in (("invert", None), ("sobel_bilateral", "sobel_bilateral")):
        legs = []
        for mode, transport in (("streamed", "queue"), ("streamed", "ring"),
                                ("monolithic", "ring"), ("streamed", "ring"),
                                ("streamed", "queue")):
            row, delta = ring_pipeline_leg(dev, name, counter, mode, transport,
                                           plain_of)
            legs.append(row)
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
        rows.extend(legs)
        q = [legs[0]["fps"], legs[4]["fps"]]
        r = [legs[1]["fps"], legs[3]["fps"]]
        log(f"ring (b) {name} streamed at {MAIN_SHAPE}: queue, ring, ring, queue "
            f"{q[0]:.1f}, {r[0]:.1f}, {r[1]:.1f}, {q[1]:.1f} fps; ring / queue "
            f"{sum(r) / sum(q):.3f}x (first pair {r[0] / q[0]:.3f}x, second pair "
            f"{r[1] / q[1]:.3f}x)")
    row, delta = ring_pipeline_leg(dev, "invert", None, "streamed", "ring", plain_of,
                                   capacity=RING_DEFAULT_CAPACITY)
    rows.append(row)
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v
    rows.append(dict(leg="b_host_copies_ms", **ring_copy_ms()))
    return rows, total


def _ring_worker_pass(dev, blobs, transport: str, codec):
    """The app's stream through a socket-less ZmqWorker on ``transport``:
    each batch's frames staged with receive() (into the native ring or the
    list), taken with next_batch() and run by process_batch. Returns
    (payloads in send order, stats, seconds)."""
    import dvf_tpu_torch

    worker = dvf_tpu_torch.ZmqWorker(
        dvf_tpu_torch.get_filter("invert"), batch_size=WIRE_BATCH, wire="delta",
        jpeg_quality=WIRE_QUALITY, delta_tile=WIRE_TILE,
        delta_keyframe_interval=WIRE_KEY, codec_assist="probe",
        transport=transport, raw_size=WIRE_SIZE, device=dev, codec=codec,
        connect=False)
    sent = []
    try:
        worker.engine.compile((WIRE_BATCH, WIRE_SIZE, WIRE_SIZE, 3))
        t = time.perf_counter()
        for s in range(0, len(blobs), WIRE_BATCH):
            for i in range(s, min(s + WIRE_BATCH, len(blobs))):
                worker.receive(i, blobs[i])
            worker.process_batch(worker.next_batch(),
                                 lambda i, t0, t1, p: sent.append((i, p)))
        worker.drain_egress()
        secs = time.perf_counter() - t
        stats = worker.stats()
    finally:
        worker.close()
    return sent, stats, secs


def ring_worker_legs(dev, have_jpeg: bool):
    """(c) The phase-5 worker setup (SyntheticSource(512, 512,
    motion="block"), invert, batch 8, tile 32, keyframe 16) with
    transport="ring" on the raw-inner delta wire, codec_assist "probe"
    (K5, one launch per batch); every payload identical to the same stream
    through transport="list". Then the JPEG delta wire over the ring where
    libjpeg (the native codec) or cv2 is present."""
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.transport import codec as tc

    frames = wire_frames()
    inners = [("raw", lambda: tc.RawCodec(WIRE_SIZE, WIRE_SIZE))]
    if have_jpeg:
        inners.append(("jpeg (native libjpeg)",
                       lambda: tc.NativeJpegCodec(WIRE_QUALITY, threads=4)))
    else:
        try:
            import cv2  # noqa: F401
            inners.append(("jpeg (cv2)", lambda: tc.JpegCodec(WIRE_QUALITY, threads=4)))
        except ImportError:
            log("ring (c): neither libjpeg nor cv2 on this machine: the JPEG "
                "delta wire over the ring does not run")
    rows, total = [], {}
    n, nb = len(frames), -(-len(frames) // WIRE_BATCH)
    for inner, make in inners:
        def codec(**kw):
            return tc.DeltaCodec(make(), tile=WIRE_TILE, keyframe_interval=WIRE_KEY,
                                 **kw)

        app = codec()
        try:
            blobs = [app.encode(f) for f in frames]
        finally:
            app.close()
        # One uncounted pass takes the process's one-time costs (codec pool
        # threads, first-touch pages); then list, ring, ring, list, so that
        # neither transport alone runs first. The first ring pass is the
        # counted one.
        _ring_worker_pass(dev, blobs, "list", codec(on_gap="raise"))
        listed, lstats, lsecs = _ring_worker_pass(dev, blobs, "list",
                                                  codec(on_gap="raise"))
        tk.reset_launches()
        sent, stats, secs = _ring_worker_pass(dev, blobs, "ring", codec(on_gap="raise"))
        delta = dict(tk.LAUNCHES)
        sent2, _, secs2 = _ring_worker_pass(dev, blobs, "ring", codec(on_gap="raise"))
        listed2, _, lsecs2 = _ring_worker_pass(dev, blobs, "list",
                                               codec(on_gap="raise"))
        label = f"zmq_worker(delta/{inner}, codec_assist=probe, transport=ring)"
        if [i for i, _ in sent] != list(range(n)):
            raise AssertionError(f"ring (c) {label}: delivered {len(sent)} of {n}, "
                                 f"out of order or repeated")
        want = {k: 0 for k in delta}
        want["tile_maxdiff"] = nb
        if delta != want:
            raise AssertionError(f"ring (c) {label}: launches {delta}, want {want}")
        for ring_sent in (sent, sent2):
            for list_sent in (listed, listed2):
                n_diff = sum(p != q for (_, p), (_, q) in zip(ring_sent, list_sent))
                if n_diff or len(list_sent) != len(ring_sent):
                    raise AssertionError(f"ring (c) {label}: {n_diff} payloads "
                                         f"differ from transport='list'")
        if inner == "raw":
            dec = codec()
            try:
                if not all(np.array_equal(dec.decode(p), 255 - f)
                           for (_, p), f in zip(sent, frames)):
                    raise AssertionError(f"ring (c) {label}: decoded results are "
                                         f"not the inverted frames")
            finally:
                dec.close()
        if stats["transport"] != "ring" or stats["ring_dropped"] != 0:
            raise AssertionError(f"ring (c) {label}: transport {stats['transport']}, "
                                 f"ring drops {stats.get('ring_dropped')}")
        fps = [n / lsecs, n / secs, n / secs2, n / lsecs2]
        ratio = (fps[1] + fps[2]) / (fps[0] + fps[3])
        log(f"ring (c) {label}: {n} frames, {stats['batches']} batches; after one "
            f"uncounted pass, list, ring, ring, list {fps[0]:.1f}, {fps[1]:.1f}, "
            f"{fps[2]:.1f}, {fps[3]:.1f} fps; ring / list {ratio:.3f}x (first pair "
            f"{fps[1] / fps[0]:.3f}x, second pair {fps[2] / fps[3]:.3f}x); ring drops "
            f"{stats['ring_dropped']}, dirty ratio {stats['delta']['dirty_ratio']}, "
            f"launches {delta}; all {n} payloads byte-identical to transport='list'")
        rows.append(dict(filter=label, inner=inner, frames=n,
                         fps_list_ring_ring_list=fps, ring_over_list=ratio,
                         ring_dropped=stats["ring_dropped"], payloads_differing=0,
                         launches=delta))
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
    return rows, total


def ring_phase(dev, plain_of: dict, have_jpeg: bool):
    """Phase 8: legs (a)-(c). Returns (rows, the summed launch counts of
    the legs' counted runs)."""
    import torch

    t0 = time.perf_counter()
    row, delta = ring_leg_rebuild(dev, plain_of)
    rows, total = [row], dict(delta)
    for leg in (lambda: ring_pipeline_phase(dev, plain_of),
                lambda: ring_worker_legs(dev, have_jpeg)):
        torch.cuda.empty_cache()
        leg_rows, leg_delta = leg()
        rows.extend(leg_rows)
        for k, v in leg_delta.items():
            total[k] = total.get(k, 0) + v
    from dvf_tpu_torch.runtime.engine import live_pool_engines

    if live_pool_engines():
        raise AssertionError(f"ring: pool engines outlived their frontends: "
                             f"{[e.op_chain for e in live_pool_engines()]}")
    log(f"ring phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total


def ring_only() -> None:
    """The build and phase 8 alone (the supervised rebuild and the ring
    legs): ``python3 -c 'import chip_smoke; chip_smoke.ring_only()'``."""
    dev, plain_of, env = _only_setup()
    rows, _ = ring_phase(dev, plain_of, env["libjpeg"])
    print(json.dumps({"ring": rows}))

# ---------------------------------------------------------------------------
# Phase 9: the observability planes (audit, lineage, flight, device trace)
# ---------------------------------------------------------------------------

PLANES_SAMPLE_EVERY = 8          # leg (a): every 8th staged frame replayed
PLANES_CHAOS_ROUNDS = 16         # leg (b): rounds of one frame per session
PLANES_TRACE_FRAMES = 160        # leg (e): the 1080p sobel_bilateral pipeline
PLANES_WIRE_FRAMES = 64          # leg (d): the corrupt_wire run (raw wire)
PLANES_FLIPS_IN = (3, 20, 45)    # app-side stamps flipped: frames in batches 0, 2, 5
PLANES_FLIPS_OUT = (5, 30)       # worker-side result stamps flipped
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The reference's /audit and /explain documents (dvf_tpu.obs.audit
# AuditPlane.document, ServeFrontend.explain with lineage armed).
AUDIT_DOC_KEYS = {"sample_every", "tolerance", "replays_sampled_total",
                  "replays_ok_total", "replay_mismatches_total",
                  "replays_dropped_total", "replay_errors_total",
                  "swap_guards_total", "swap_guard_mismatches_total",
                  "confirmed_corruptions_total", "queue_depth", "events",
                  "label"}
EXPLAIN_DOC_KEYS = {"lineage", "frames_total", "quantile", "p_ms",
                    "tail_frames", "tail_mean_ms", "fractions", "text",
                    "by_bucket"}


def busy_share(events, t0_us: float, t1_us: float, cats) -> float:
    """Share of [t0, t1] (µs, one clock) covered by the union of the
    device spans of ``cats`` (overlapping spans counted once)."""
    spans = sorted((max(e["ts"], t0_us), min(e["ts"] + e.get("dur", 0), t1_us))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in cats)
    busy, end = 0.0, t0_us
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy / (t1_us - t0_us) if t1_us > t0_us else 0.0


def _planes_config(planes: bool, **kw):
    import dvf_tpu_torch

    extra = dict(audit=True, audit_sample_every=PLANES_SAMPLE_EVERY,
                 lineage=True) if planes else {}
    extra.update(kw)
    return dvf_tpu_torch.ServeConfig(max_buckets=3, pool_capacity=3,
                                     flight_min_interval_s=0.0,
                                     **{**SERVE_KW, **extra})


def _planes_open(fe) -> tuple:
    """Phase 7 (a)'s tenants: 2 sessions each of sobel_bilateral and
    gaussian_blur(ksize=9) at 1080p and of invert at 480 x 640, the same
    seeded bases. Returns ({sid: base}, {sid: chain})."""
    plan, chain_of = {}, {}
    seed = 70
    for chain, shape, n in (("sobel_bilateral", SERVE_HD, 2),
                            ("gaussian_blur(ksize=9)", SERVE_HD, 2),
                            ("invert", SERVE_SD, 2)):
        for base in serve_bases(shape, n, seed):
            sid = fe.open_stream(op_chain=chain, frame_shape=shape)
            plan[sid], chain_of[sid] = base, chain
        seed += 1
    return plan, chain_of


def _count_replays(fe) -> dict:
    """Per-bucket count of the replays the collect thread hands the audit
    plane (a wrapper on this frontend's plane only)."""
    counts = {}
    real = fe.audit.submit_replay

    def counting(*a, **kw):
        counts[kw.get("bucket")] = counts.get(kw.get("bucket"), 0) + 1
        return real(*a, **kw)

    fe.audit.submit_replay = counting
    return counts


def _get_text(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return r.read().decode()


def _get_json(url: str) -> dict:
    return json.loads(_get_text(url))


def planes_leg_audit(dev, plain_of: dict, tmp: str):
    """(a) Audit (every 8th staged frame) and lineage on a clean run of
    phase 7 (a)'s mix, flight recorder armed, a torch.profiler window over
    the drive (the serving busy share). 0 confirmed corruptions; every
    sampled frame replayed; K1 and K3 launched once per serving batch of
    their bucket plus once per replay of it; every delivered frame's
    lineage components summing to its latency; explain naming a dominant
    component; /audit and /explain answering with the reference's keys."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.obs.export import MetricsExporter, start_device_profiler
    from dvf_tpu_torch.ops import kernels as tk

    fe = dvf_tpu_torch.ServeFrontend(
        dvf_tpu_torch.get_filter("invert"),
        _planes_config(True, flight_dir=os.path.join(tmp, "flight_a")))
    with fe:
        plan, chain_of = _planes_open(fe)
        replays = _count_replays(fe)
        b0 = {s: bucket_of(fe, s).engine.stats.batches for s in plan}
        prof = start_device_profiler()
        tk.reset_launches()
        try:
            w0 = time.time()
            got, wall = serve_drive(fe, plan, SERVE_FRAMES)
            w1 = time.time()
            if not fe.audit.drain(120.0):
                raise AssertionError("planes (a): the replay queue never drained")
            delta = dict(tk.LAUNCHES)
        finally:
            prof.stop()
        trace_path = os.path.join(tmp, "serve_a_trace.json")
        prof.export_chrome_trace(trace_path)
        st = fe.stats()
        with MetricsExporter(fe.registry, explain_fn=fe.explain,
                             audit_fn=fe.audit.document) as ex:
            aud = _get_json(f"{ex.url}/audit")
            expl = _get_json(f"{ex.url}/explain")
        batches = {chain_of[s]: bucket_of(fe, s).engine.stats.batches - b0[s]
                   for s in plan}
        labels = {chain_of[s]: bucket_of(fe, s).label() for s in plan}
    audit = st["audit"]
    by_chain = {c: replays.get(labels[c], 0) for c in labels}
    if audit["confirmed_corruptions_total"] or audit["replay_errors_total"] \
            or audit["replays_dropped_total"]:
        raise AssertionError(f"planes (a): {json.dumps(audit)[:800]}")
    if not (audit["replays_sampled_total"] == audit["replays_ok_total"]
            == sum(replays.values()) > 0):
        raise AssertionError(f"planes (a): sampled {audit['replays_sampled_total']}, "
                             f"ok {audit['replays_ok_total']}, handed over {replays}")
    want = {"sep_blur": batches["gaussian_blur(ksize=9)"]
            + by_chain["gaussian_blur(ksize=9)"],
            "sobel_bilateral": batches["sobel_bilateral"]
            + by_chain["sobel_bilateral"]}
    serve_counted(delta, want, "planes (a)")
    lsb = max(serve_check(f"planes (a) {chain_of[s]} {s}", chain_of[s], plan[s],
                          got[s], SERVE_FRAMES, dev, plain_of) for s in plan)
    worst = 0.0
    for s in plan:
        for d in got[s]:
            comps = d.lineage.components_ms()
            worst = max(worst, abs(sum(comps.values()) - d.latency_ms))
    if worst > 1e-6:
        raise AssertionError(f"planes (a): lineage components miss the latency "
                             f"by {worst} ms")
    fr = expl.get("fractions") or {}
    dominant = max(fr, key=fr.get) if fr else None
    if not dominant or not expl.get("text"):
        raise AssertionError(f"planes (a): explain names no component: {expl}")
    if set(aud) != AUDIT_DOC_KEYS or set(expl) != EXPLAIN_DOC_KEYS:
        raise AssertionError(f"planes (a): /audit keys {sorted(aud)}, /explain "
                             f"keys {sorted(expl)}")
    with open(trace_path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    t0, t1 = w0 * 1e6 - base_us, w1 * 1e6 - base_us
    ev = doc["traceEvents"]
    share_k = busy_share(ev, t0, t1, ("kernel",))
    share_all = busy_share(ev, t0, t1, GPU_CATS)
    frames = sum(len(v) for v in got.values())
    comp_p50 = {c: round(v["p50_ms"], 3)
                for c, v in st["attribution"]["components"].items()}
    log(f"planes (a) audit + lineage on the phase-7 (a) mix: {frames} frames in "
        f"{wall:.3f} s ({frames / wall:.1f} fps, profiler window open), "
        f"replays {json.dumps(by_chain)} all ok, 0 confirmed corruptions, "
        f"launches {delta} (batches {json.dumps(batches)}), max {lsb} LSB vs "
        f"plain; lineage additive (worst {worst:.2e} ms); explain "
        f"{expl['text']!r}, component p50 ms {json.dumps(comp_p50)}; /audit and "
        f"/explain 200 with the reference's keys; serving busy share kernels "
        f"{share_k:.4f}, kernels + copies {share_all:.4f} over the drive's "
        f"{(w1 - w0) * 1e3:.1f} ms")
    keep = {s: [d.frame for d in got[s][:PLANES_CHAOS_ROUNDS]]
            for s in plan if s != _victims(chain_of).get(chain_of[s])}
    torch.cuda.empty_cache()
    row = dict(leg="a_audit_lineage", frames=frames, wall_s=wall, fps=frames / wall,
               replays=by_chain, replays_sampled=audit["replays_sampled_total"],
               confirmed_corruptions=0, launches=delta, batches=batches,
               max_lsb=lsb, lineage_worst_ms=worst, explain=expl["text"],
               dominant=dominant, component_p50_ms=comp_p50,
               busy_share_kernels=share_k, busy_share_gpu=share_all)
    return row, delta, keep, chain_of


@contextlib.contextmanager
def dispatch_parked(fe):
    """Hold the frontend's dispatch thread at the top of its loop (the
    park it takes during a recovery) while a round is submitted, so each
    bucket's next batch holds the whole round, in submission order."""
    fe._recovering.set()
    try:
        deadline = time.time() + 30.0
        while not fe._dispatch_parked.is_set():
            if time.time() > deadline:
                raise AssertionError("planes: the dispatch thread never parked")
            time.sleep(0.001)
        yield
    finally:
        fe._recovering.clear()


def _victims(chain_of: dict) -> dict:
    """Each bucket's first-opened session: row 0 of its batches when every
    session submits in opening order and waits for its frame."""
    out = {}
    for sid, chain in chain_of.items():
        out.setdefault(chain, sid)
    return out


def planes_leg_chaos(dev, plain_of: dict, tmp: str, control: dict,
                     chain_of_a: dict):
    """(b) corrupt_device every 2nd collected batch (row 0 perturbed) on
    the same buckets, every frame replayed; each round submits one frame
    per session in opening order with the dispatch thread parked and
    waits for all of them, so each bucket's first session is row 0. At least one confirmed corruption,
    attributed to its session and bucket, classified integrity; the other
    sessions' frames bit-identical to leg (a)'s; a flight dump holding
    audit.json and lineage.json that the viewer reads."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.obs.viewer import summarize_dump
    from dvf_tpu_torch.resilience import FaultPlan

    fdir = os.path.join(tmp, "flight_b")
    chaos = FaultPlan(seed=7).add("corrupt_device", every=2)
    fe = dvf_tpu_torch.ServeFrontend(
        dvf_tpu_torch.get_filter("invert"),
        _planes_config(True, audit_sample_every=1, flight_dir=fdir, chaos=chaos))
    with fe:
        plan, chain_of = _planes_open(fe)
        victims = _victims(chain_of)
        got = {s: [] for s in plan}
        for j in range(PLANES_CHAOS_ROUNDS):
            with dispatch_parked(fe):
                for sid, base in plan.items():
                    fe.submit(sid, tagged(base, j))
            deadline = time.time() + 60.0
            while any(len(v) < j + 1 for v in got.values()):
                if time.time() > deadline:
                    raise AssertionError(f"planes (b): stalled at round {j}")
                for sid in plan:
                    got[sid].extend(fe.poll(sid))
                time.sleep(0.001)
        if not fe.audit.drain(120.0):
            raise AssertionError("planes (b): the replay queue never drained")
        st = fe.stats()
        labels = {s: bucket_of(fe, s).label() for s in plan}
        deadline = time.time() + 60.0
        while fe.flight.stats()["dumps"] == 0 and time.time() < deadline:
            time.sleep(0.02)
        dumps = list(fe.flight.dumps)
    audit = st["audit"]
    events = [e for e in audit["events"] if e["kind"] == "shadow_replay"]
    if audit["confirmed_corruptions_total"] < 1 or not events:
        raise AssertionError(f"planes (b): no confirmed corruption: "
                             f"{json.dumps(audit)[:800]}")
    victim_ids = set(victims.values())
    for e in events:
        if e["session"] not in victim_ids or e["bucket"] != labels[e["session"]]:
            raise AssertionError(f"planes (b): corruption attributed to "
                                 f"{e['session']} / {e['bucket']}, victims "
                                 f"{victims}")
    integrity = st["faults"]["by_kind"].get("integrity", 0)
    if integrity < 1:
        raise AssertionError(f"planes (b): faults {st['faults']['by_kind']}")
    # the other sessions: bit-identical to leg (a) (the same bases and
    # indices; sessions are matched by opening order within each chain)
    order_a = {}
    for sid, chain in chain_of_a.items():
        order_a.setdefault(chain, []).append(sid)
    order_b = {}
    for sid, chain in chain_of.items():
        order_b.setdefault(chain, []).append(sid)
    compared = 0
    for chain, sids in order_b.items():
        for k, sid in enumerate(sids):
            if sid in victim_ids:
                continue
            ref = control[order_a[chain][k]]
            mine = [d.frame for d in got[sid]]
            if [d.index for d in got[sid]] != list(range(PLANES_CHAOS_ROUNDS)) \
                    or not all(np.array_equal(a, b) for a, b in zip(mine, ref)):
                raise AssertionError(f"planes (b): control session {sid} "
                                     f"({chain}) differs from leg (a)")
            compared += len(mine)
    if not dumps:
        raise AssertionError("planes (b): no flight dump")
    files = sorted(os.listdir(dumps[0]))
    if not {"audit.json", "lineage.json", "meta.json", "stats.json"} <= set(files):
        raise AssertionError(f"planes (b): dump files {files}")
    summary = summarize_dump(dumps[0])
    if summary.get("audit", {}).get("confirmed_corruptions_total", 0) < 1 \
            or "lineages" not in summary:
        raise AssertionError(f"planes (b): the viewer's summary "
                             f"{json.dumps(summary)[:800]}")
    log(f"planes (b) corrupt_device every 2nd batch: {audit['confirmed_corruptions_total']} "
        f"confirmed corruptions of {audit['replays_sampled_total']} replays, each "
        f"on a row-0 session ({sorted({e['session'] for e in events})}), faults "
        f"integrity {integrity}; {compared} control frames bit-identical to leg "
        f"(a); flight dump {os.path.basename(dumps[0])} with {files}; viewer: "
        f"{summary['audit']}")
    torch.cuda.empty_cache()
    return dict(leg="b_corrupt_device", confirmed=audit["confirmed_corruptions_total"],
                replays=audit["replays_sampled_total"], integrity_faults=integrity,
                control_frames_identical=compared, dump_files=files)


def planes_leg_guard(dev, plain_of: dict):
    """(c) The swap guard on the 1080p sobel_bilateral bucket: a
    request_batch_size 16 -> 8 resize (hot swap) and a direct _recover
    rebuild; each substitution ledgers a swap_guard verdict "match", the
    resize (and the rebuild) with old_program_match true."""
    import dvf_tpu_torch
    from dvf_tpu_torch.resilience.faults import FaultKind

    fe = dvf_tpu_torch.ServeFrontend(
        dvf_tpu_torch.get_filter("invert"),
        _planes_config(True, audit_sample_every=10 ** 9))
    n = 3 * SERVE_BATCH
    with fe:
        base = serve_bases(SERVE_HD, 1, 90)[0]
        sid = fe.open_stream(op_chain="sobel_bilateral", frame_shape=SERVE_HD)
        got = []

        def feed(lo, hi):
            for j in range(lo, hi):
                fe.submit(sid, tagged(base, j))
            deadline = time.time() + 60.0
            while len(got) < hi:
                if time.time() > deadline:
                    raise AssertionError(f"planes (c): stalled: {fe.health()}")
                got.extend(fe.poll(sid))
                time.sleep(0.002)

        feed(0, SERVE_BATCH)
        label = bucket_of(fe, sid).label()
        if not fe.request_batch_size(label, SERVE_BATCH // 2, reason="planes (c)"):
            raise AssertionError("planes (c): resize refused")
        deadline = time.time() + 60.0
        while fe.swaps < 1:
            if time.time() > deadline:
                raise AssertionError("planes (c): the resize never committed")
            time.sleep(0.005)
        feed(SERVE_BATCH, 2 * SERVE_BATCH)
        bucket = bucket_of(fe, sid)
        fe._recover("planes (c) direct rebuild", kind=FaultKind.COMPUTE,
                    bucket=bucket)
        feed(2 * SERVE_BATCH, n)
        if not fe.audit.drain(120.0):
            raise AssertionError("planes (c): the guard queue never drained")
        events = fe.ledger.snapshot()
    subs = [e for e in events if e["kind"] in ("swap", "engine_rebuild")
            and not e.get("aborted")]
    guards = [e for e in events if e["kind"] == "swap_guard"]
    kinds = {e["swap_kind"]: e for e in guards}
    ok = (len(guards) >= len(subs) >= 2
          and set(kinds) >= {"batch_resize", "engine_rebuild"}
          and all(e["verdict"] == "match" for e in guards)
          and kinds["batch_resize"].get("old_program_match") is True)
    if not ok:
        raise AssertionError(f"planes (c): substitutions "
                             f"{[e['kind'] for e in subs]}, guards "
                             f"{json.dumps(guards)[:1200]}")
    lsb = serve_check("planes (c) sobel_bilateral", "sobel_bilateral", base, got, n,
                      dev, plain_of)
    log(f"planes (c) swap guard: {len(subs)} substitutions "
        f"({[e['kind'] for e in subs]}), {len(guards)} guard verdicts "
        f"{[(e['swap_kind'], e['verdict'], e.get('old_program_match')) for e in guards]}; "
        f"{n} frames in order, max {lsb} LSB vs plain")
    return dict(leg="c_swap_guard", substitutions=len(subs),
                guards=[dict(kind=e["swap_kind"], verdict=e["verdict"],
                             old_program_match=e.get("old_program_match"))
                        for e in guards], max_lsb=lsb)


def _planes_worker_pass(dev, blobs, transport: str, codec, assist: str, wire: str,
                        audit: bool, app_chaos=None, worker_chaos=None):
    """The app's stream through a socket-less ZmqWorker on ``transport``;
    with ``audit`` the app stamps every payload (its own corrupt_wire
    site: ``app_chaos``) and the worker runs audit_wire. A batch whose
    payload fails its envelope raises out of process_batch; the hop is
    recorded. Returns (payloads in send order, the caught hops, the
    worker's audit document)."""
    import dvf_tpu_torch
    from dvf_tpu_torch.obs.audit import WireAudit, WireIntegrityError

    worker = dvf_tpu_torch.ZmqWorker(
        dvf_tpu_torch.get_filter("invert"), batch_size=WIRE_BATCH, wire=wire,
        use_jpeg=False, jpeg_quality=WIRE_QUALITY, delta_tile=WIRE_TILE,
        delta_keyframe_interval=WIRE_KEY, codec_assist=assist,
        transport=transport, raw_size=WIRE_SIZE, device=dev, codec=codec,
        connect=False, audit_wire=audit, chaos=worker_chaos)
    app = WireAudit("app_egress", chaos=app_chaos) if audit else None
    sent, caught = [], []
    try:
        worker.engine.compile((WIRE_BATCH, WIRE_SIZE, WIRE_SIZE, 3))
        for s in range(0, len(blobs), WIRE_BATCH):
            for i in range(s, min(s + WIRE_BATCH, len(blobs))):
                worker.receive(i, app.stamp(blobs[i]) if app else blobs[i])
            try:
                worker.process_batch(worker.next_batch(),
                                     lambda i, t0, t1, p: sent.append((i, p)))
            except WireIntegrityError as e:
                caught.append((s // WIRE_BATCH, e.hop))
        worker.drain_egress()
        doc = worker.audit_document()
    finally:
        worker.close()
    return sent, caught, doc


def planes_leg_wire(dev, have_jpeg: bool):
    """(d) The audited wire: the phase-5 worker setup (512², batch 8, the
    delta wire; codec_assist "full" (K5, K6) on the JPEG inner wire where
    libjpeg is present, else "probe" (K5) on the raw inner wire) with
    audit_wire over the list and over the ring: every payload, envelope
    stripped, byte-identical to the unaudited list run's. Then the raw
    wire with corrupt_wire armed on both stamp sides: every app-side flip
    raises WireIntegrityError at the worker's zmq_ingress hop (its batch
    dropped, the worker's audit document counting it), every worker-side
    flip fails the app's own verify."""
    from dvf_tpu_torch.obs.audit import WireAudit, WireIntegrityError, verify_wire
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.resilience import FaultPlan
    from dvf_tpu_torch.transport import codec as tc

    frames = wire_frames()
    assist, inner = ("full", "jpeg") if have_jpeg else ("probe", "raw")

    def codec(**kw):
        base = (tc.NativeJpegCodec(WIRE_QUALITY, threads=4) if inner == "jpeg"
                else tc.RawCodec(WIRE_SIZE, WIRE_SIZE))
        return tc.DeltaCodec(base, tile=WIRE_TILE, keyframe_interval=WIRE_KEY, **kw)

    app = codec()
    try:
        blobs = [app.encode(f) for f in frames]
    finally:
        app.close()
    plain, _, _ = _planes_worker_pass(dev, blobs, "list", codec(on_gap="raise"),
                                      assist, "delta", audit=False)
    n, nb = len(frames), -(-len(frames) // WIRE_BATCH)
    tk.reset_launches()
    audited = {t: _planes_worker_pass(dev, blobs, t, codec(on_gap="raise"), assist,
                                      "delta", audit=True)
               for t in ("list", "ring")}
    delta = dict(tk.LAUNCHES)
    want = {k: 0 for k in delta}
    want["tile_maxdiff"] = 2 * nb
    if assist == "full":
        want["dct8x8_quant"] = 2 * nb
    if delta != want:
        raise AssertionError(f"planes (d): launches {delta}, want {want}")
    for t, (sent, caught, doc) in audited.items():
        if caught or [i for i, _ in sent] != list(range(n)):
            raise AssertionError(f"planes (d) {t}: caught {caught}, sent "
                                 f"{len(sent)} of {n}")
        stripped = [verify_wire(p, hop="app") for _, p in sent]
        n_diff = sum(a != b for a, (_, b) in zip(stripped, plain))
        if n_diff:
            raise AssertionError(f"planes (d) {t}: {n_diff} payloads differ from "
                                 f"the unaudited run once stripped")
        hops = {h["hop"]: h for h in doc["wire_hops"]}
        if hops["zmq_ingress"]["verified_total"] != n \
                or hops["zmq_egress"]["stamped_total"] != n:
            raise AssertionError(f"planes (d) {t}: audit document {doc}")
    # corrupt_wire armed on both stamp sides (the raw wire: no delta state
    # for a dropped batch to break)
    raw = [f.tobytes() for f in frames[:PLANES_WIRE_FRAMES]]
    app_chaos = FaultPlan(seed=11).add("corrupt_wire", at=PLANES_FLIPS_IN)
    worker_chaos = FaultPlan(seed=12).add("corrupt_wire", at=PLANES_FLIPS_OUT)
    sent, caught, doc = _planes_worker_pass(
        dev, raw, "ring", None, "none", "raw", audit=True, app_chaos=app_chaos,
        worker_chaos=worker_chaos)
    want_batches = [i // WIRE_BATCH for i in PLANES_FLIPS_IN]
    if caught != [(b, "zmq_ingress") for b in want_batches]:
        raise AssertionError(f"planes (d): ingress flips caught {caught}, want "
                             f"batches {want_batches} at zmq_ingress")
    if doc["wire_mismatches_total"] != len(PLANES_FLIPS_IN):
        raise AssertionError(f"planes (d): worker audit document {doc}")
    verifier = WireAudit("app_ingress")
    bad = []
    for k, (i, p) in enumerate(sent):
        try:
            out = verifier.verify(p)
        except WireIntegrityError as e:
            bad.append((k, e.hop))
            continue
        if out != (255 - frames[i]).tobytes():
            raise AssertionError(f"planes (d): result {i} is not the inverted frame")
    if bad != [(k, "app_ingress") for k in PLANES_FLIPS_OUT]:
        raise AssertionError(f"planes (d): egress flips caught {bad}, want "
                             f"{PLANES_FLIPS_OUT} at app_ingress")
    fired = {"app": app_chaos.summary()["fired"],
             "worker": worker_chaos.summary()["fired"]}
    log(f"planes (d) audited wire ({assist} on the {inner}-inner delta wire): list "
        f"and ring {n} payloads each, byte-identical to the unaudited run once "
        f"stripped, launches {delta}; corrupt_wire on the raw wire over the ring: "
        f"{len(caught)} ingress flips caught at zmq_ingress (batches "
        f"{want_batches} dropped), {len(bad)} egress flips caught by the app, "
        f"worker audit document mismatches {doc['wire_mismatches_total']}; fired "
        f"{json.dumps(fired)}")
    return dict(leg="d_audited_wire", assist=assist, inner=inner, frames=n,
                payloads_differing=0, launches=delta,
                ingress_flips_caught=len(caught), egress_flips_caught=len(bad),
                worker_mismatches=doc["wire_mismatches_total"]), delta


def _traced_pipeline(dev, eng, n: int, trace: bool, tmp: str, tag: str):
    """One 1080p sobel_bilateral Pipeline over ``eng`` (streamed, gates
    open): with ``trace`` the host trace and a device trace into
    ``tmp/tag``. Returns (stats, the merged file or None, the batches)."""
    import dvf_tpu_torch

    d = os.path.join(tmp, tag)
    os.makedirs(d, exist_ok=True)
    cfg = dvf_tpu_torch.PipelineConfig(
        batch_size=MAIN_SHAPE[0], queue_size=n + 1, assemble_timeout_s=60.0,
        trace=trace, device_trace_dir=d if trace else None)
    order = []
    b0 = eng.stats.batches
    cwd = os.getcwd()
    os.chdir(d)
    try:
        pipe = dvf_tpu_torch.Pipeline(
            dvf_tpu_torch.SyntheticSource(*MAIN_SHAPE[1:], n_frames=n, seed=0),
            eng.filter, dvf_tpu_torch.CallbackSink(lambda i, f, _: order.append(i)),
            cfg, engine=eng)
        with gates_open():
            stats = pipe.run()
    finally:
        os.chdir(cwd)
    if order != list(range(n)):
        raise AssertionError(f"planes ({tag}): delivered {len(order)} of {n} "
                             f"in order {order == sorted(order)}")
    merged = os.path.join(d, "dvf_merged_timing.pftrace")
    return stats, (merged if trace else None), eng.stats.batches - b0


def planes_leg_trace(dev, tmp: str):
    """(e) The 1080p sobel_bilateral pipeline, 160 frames, trace=True and
    device_trace_dir: the merged file holds the host lanes and the device
    lanes, every K3 kernel event falls inside a host batch span once
    aligned (1 ms slack for the two clocks' reads), and the busy share
    (device kernels, and kernels + copies, over the host's traced window)
    is printed. K3 one launch per batch."""
    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk

    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("sobel_bilateral"),
                               device=dev)
    eng.compile(MAIN_SHAPE)
    tk.reset_launches()
    stats, merged, batches = _traced_pipeline(dev, eng, PLANES_TRACE_FRAMES, True,
                                              tmp, "e")
    delta = dict(tk.LAUNCHES)
    if delta != {k: batches if k == "sobel_bilateral" else 0 for k in delta}:
        raise AssertionError(f"planes (e): launches {delta}, batches {batches}")
    if not os.path.exists(merged):
        raise AssertionError(f"planes (e): no merged trace; {os.listdir(os.path.dirname(merged))}")
    with open(merged) as f:
        doc = json.load(f)
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in ev if e["pid"] < 10000]
    dev_ev = [e for e in ev if e["pid"] >= 10000]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                   if e["name"] == "batch_complete")
    k3 = [e for e in dev_ev if e.get("cat") == "kernel"
          and "sobel_bilateral" in e.get("name", "")]
    if not spans or not k3:
        raise AssertionError(f"planes (e): host batch spans {len(spans)}, K3 "
                             f"events {len(k3)}, device events {len(dev_ev)}")
    outside = [e["ts"] for e in k3
               if not any(a - 1000 <= e["ts"] and e["ts"] + e["dur"] <= b + 1000
                          for a, b in spans)]
    if outside:
        raise AssertionError(f"planes (e): {len(outside)} of {len(k3)} K3 events "
                             f"outside every host batch span")
    t0 = min(e["ts"] for e in host)
    t1 = max(e["ts"] + e["dur"] for e in host)
    share_k = busy_share(dev_ev, t0, t1, ("kernel",))
    share_all = busy_share(dev_ev, t0, t1, GPU_CATS)
    k3_ms = statistics.median(e["dur"] for e in k3) / 1e3
    cats = {}
    for e in dev_ev:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    log(f"planes (e) traced sobel_bilateral {MAIN_SHAPE} pipeline: {stats['fps']:.1f} "
        f"fps (trace on), {batches} batches, launches {delta}; merged "
        f"{os.path.basename(merged)}: {len(host)} host and {len(dev_ev)} device "
        f"spans (by category {json.dumps(cats)}), all {len(k3)} K3 events inside "
        f"a host batch span, K3 median {k3_ms:.4f} ms; busy share over the "
        f"traced {(t1 - t0) / 1e3:.1f} ms: kernels {share_k:.4f}, kernels + copies "
        f"{share_all:.4f}")
    row = dict(leg="e_device_trace", frames=PLANES_TRACE_FRAMES, batches=batches,
               fps_traced=stats["fps"], host_spans=len(host),
               device_spans=len(dev_ev), k3_events=len(k3), k3_median_ms=k3_ms,
               window_ms=(t1 - t0) / 1e3, busy_share_kernels=share_k,
               busy_share_gpu=share_all, launches=delta)
    return row, delta, eng


def planes_leg_cost(dev, eng, tmp: str):
    """(f) What the planes cost: fps of the phase-7 (a) mix with the
    planes off, on, on, off (audit every 8th frame, lineage, flight
    recorder) and of (e)'s pipeline with the trace off, on, on, off, in
    this call; the blake2b digest per 1080p frame. Reported, not gated."""
    import dvf_tpu_torch
    from dvf_tpu_torch.obs.audit import frame_digest

    fps = []
    for planes in (False, True, True, False):
        fe = dvf_tpu_torch.ServeFrontend(
            dvf_tpu_torch.get_filter("invert"),
            _planes_config(planes, flight_dir=os.path.join(tmp, "flight_f")
                           if planes else None))
        with fe:
            plan, _ = _planes_open(fe)
            got, wall = serve_drive(fe, plan, SERVE_FRAMES)
        fps.append(sum(len(v) for v in got.values()) / wall)
        del got
    serve_ratio = (fps[1] + fps[2]) / (fps[0] + fps[3])
    tfps = []
    for k, trace in enumerate((False, True, True, False)):
        stats, _, _ = _traced_pipeline(dev, eng, PLANES_TRACE_FRAMES, trace, tmp,
                                       f"f{k}")
        tfps.append(stats["fps"])
    trace_ratio = (tfps[1] + tfps[2]) / (tfps[0] + tfps[3])
    frame = np.random.default_rng(0).integers(0, 256, MAIN_SHAPE[1:], dtype=np.uint8)
    times = []
    for _ in range(20):
        t = time.perf_counter()
        frame_digest(frame)
        times.append((time.perf_counter() - t) * 1e3)
    digest_ms = statistics.median(times)
    log(f"planes (f) cost: serving mix off, on, on, off {fps[0]:.1f}, {fps[1]:.1f}, "
        f"{fps[2]:.1f}, {fps[3]:.1f} fps, on / off {serve_ratio:.3f} (the "
        f"reference's audit budget: >= 0.97); sobel_bilateral pipeline trace off, "
        f"on, on, off {tfps[0]:.1f}, {tfps[1]:.1f}, {tfps[2]:.1f}, {tfps[3]:.1f} fps, "
        f"on / off {trace_ratio:.3f}; blake2b {digest_ms:.3f} ms per "
        f"{frame.nbytes / 1e6:.1f} MB frame (median of 20); host loadavg "
        f"{os.getloadavg()[0]:.2f} of {os.cpu_count()} cores")
    return dict(leg="f_cost", serve_fps_off_on_on_off=fps, serve_on_over_off=serve_ratio,
                audit_budget_reference=0.97, trace_fps_off_on_on_off=tfps,
                trace_on_over_off=trace_ratio, blake2b_ms_per_1080p_frame=digest_ms)


def planes_phase(dev, plain_of: dict, have_jpeg: bool):
    """Phase 9: legs (a)-(f) of the observability planes. Returns (rows,
    the summed launch counts of the legs' counted runs)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    rows, total = [], {}

    def add(delta):
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        row, delta, control, chain_of = planes_leg_audit(dev, plain_of, tmp)
        rows.append(row)
        add(delta)
        rows.append(planes_leg_chaos(dev, plain_of, tmp, control, chain_of))
        del control
        rows.append(planes_leg_guard(dev, plain_of))
        torch.cuda.empty_cache()
        row, delta = planes_leg_wire(dev, have_jpeg)
        rows.append(row)
        add(delta)
        row, delta, eng = planes_leg_trace(dev, tmp)
        rows.append(row)
        add(delta)
        rows.append(planes_leg_cost(dev, eng, tmp))
        eng.free()
    from dvf_tpu_torch.runtime.engine import live_pool_engines

    if live_pool_engines():
        raise AssertionError(f"planes: pool engines outlived their frontends: "
                             f"{[e.op_chain for e in live_pool_engines()]}")
    torch.cuda.empty_cache()
    log(f"planes phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total


def planes_only() -> None:
    """The build and phase 9 alone (the observability planes):
    ``python3 -c 'import chip_smoke; chip_smoke.planes_only()'``."""
    dev, plain_of, env = _only_setup()
    rows, _ = planes_phase(dev, plain_of, env["libjpeg"])
    print(json.dumps({"planes": rows}))



# ---------------------------------------------------------------------------
# Phase 10: the control plane, auto-plan with its plan cache, and broadcast
# ---------------------------------------------------------------------------

CONTROL_FRAMES = 96              # leg (a): frames per session
CONTROL_CUTS = (32, 64)          # leg (a): downshift after 32, recover after 64
LOOP_SESSIONS = 6                # leg (b): sobel_bilateral sessions at 1080p
LOOP_WAVES, LOOP_HZ = 240, 60.0  # leg (b): one frame per session per wave
LOOP_SLO_MS = 150.0              # leg (b): tight enough to press the plane
PLAN_BATCH, PLAN_BURST = 8, 24   # leg (c): hand-set batch, frames per burst
BCAST_TIERS = ("native/raw", "960x540/raw", "640x360/raw")
BCAST_SUBS = 64                  # leg (d): subscribers over the three tiers
BCAST_FPS_FRAMES = 48            # leg (d): frames per publishing on/off run


def _mem_after_stop(label: str) -> int:
    import torch

    torch.cuda.synchronize()
    b = torch.cuda.memory_allocated()
    log(f"control {label}: memory_allocated after stop {b} B")
    return b


def _serve_config(**kw):
    """A ServeConfig over SERVE_KW (every frame kept) with ``kw`` on top."""
    import dvf_tpu_torch

    return dvf_tpu_torch.ServeConfig(**{**SERVE_KW, **kw})


def plain_down(chain: str, frames: list, dev, plain_of: dict) -> np.ndarray:
    """The plain version of the quality-1 program: frame[::2, ::2] ->
    ``chain`` -> nearest x2 (the upscale stage), on the card."""
    half = serve_plain(chain, [np.ascontiguousarray(f[::2, ::2])
                               for f in frames], dev, plain_of)
    return half.repeat(2, axis=1).repeat(2, axis=2)


def _wait(pred, what: str, deadline_s: float = 60.0,
          phase: str = "control") -> None:
    deadline = time.time() + deadline_s
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"{phase}: timed out waiting for {what}")
        time.sleep(0.002)


def _timed_lanes(ch) -> dict:
    """Wrap each tier lane's fan-out (encode once + enqueue to every
    subscriber) with a timer; returns {tier label: [seconds per frame]}."""
    spent = {}
    for tier, lane in list(ch._lanes.items()):
        real = lane.offer
        spent[tier.label()] = acc = []

        def timed(*a, _real=real, _acc=acc, **k):
            t = time.perf_counter()
            out = _real(*a, **k)
            _acc.append(time.perf_counter() - t)
            return out

        lane.offer = timed
    return spent


def control_leg_quality(dev, plain_of: dict):
    """(a) Quality actuation, and (d) broadcast on the same frontend: batch
    16, control armed with its controllers idle (manual actuation), 2
    sessions of sobel_bilateral and 1 of gaussian_blur(ksize=9) at 1080p,
    96 frames each; sobel_bilateral session A downshifts after frame 32
    and recovers after 64. A publishes channel "cam" on three raw tiers to
    64 subscribers, one subscriber that never drains, and a relay."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.broadcast import Tier
    from dvf_tpu_torch.broadcast.channel import downscale
    from dvf_tpu_torch.control import ControlConfig
    from dvf_tpu_torch.obs import ledger as ledger_mod
    from dvf_tpu_torch.obs.audit import is_stamped, verify_wire
    from dvf_tpu_torch.ops import kernels as tk

    n = CONTROL_FRAMES
    cfg = _serve_config(
        max_buckets=5, pool_capacity=6, control=True,
        control_config=ControlConfig(interval_s=3600.0),
        broadcast_audit_wire=True, broadcast_ingest_depth=n + 8,
        broadcast_sub_queue=n + 8)
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"), cfg)
    bases = serve_bases(SERVE_HD, 3, 100)
    chains = ("sobel_bilateral", "sobel_bilateral", "gaussian_blur(ksize=9)")
    tiers = [Tier.parse(t) for t in BCAST_TIERS]
    with fe:
        t = time.perf_counter()
        sids = [fe.open_stream(op_chain=c, frame_shape=SERVE_HD,
                               **({"publish": "cam",
                                   "publish_tiers": list(BCAST_TIERS)}
                                  if i == 0 else {}))
                for i, c in enumerate(chains)]
        admit_ms = (time.perf_counter() - t) * 1e3
        a = sids[0]
        # The x2 programs of both signatures compile at admission on
        # background threads; the downshift must find its program warm.
        _wait(lambda: len([e for e in fe.ledger.snapshot()
                           if e["kind"] == ledger_mod.COMPILE
                           and e.get("cause") == ledger_mod.CAUSE_QUALITY]) >= 2,
              "the quality programs' admission warm-up")
        warm = [e for e in fe.ledger.snapshot()
                if e["kind"] == ledger_mod.COMPILE
                and e.get("cause") == ledger_mod.CAUSE_QUALITY]
        subs = [fe.subscribe("cam", tier=tiers[i % 3]) for i in range(BCAST_SUBS)]
        slow = fe.subscribe("cam", tier=tiers[0], queue_size=2)
        node = fe.broadcast.spawn_relay("cam", sub_queue=n + 8,
                                        upstream_queue=n + 8)
        rsub = node.subscribe()
        ch = fe.broadcast.channel("cam")
        fanout_s = _timed_lanes(ch)
        got = {sid: [] for sid in sids}
        sub_got = [[] for _ in subs]
        relay_got = []
        cut_at, rebinds_t, seg_s = {}, {}, []
        b0 = {id(b.engine): b.engine.stats.batches for b in fe._buckets}
        tk.reset_launches()
        t0 = time.perf_counter()
        for lo, hi, level in ((0, CONTROL_CUTS[0], None),
                              (CONTROL_CUTS[0], CONTROL_CUTS[1], 1),
                              (CONTROL_CUTS[1], n, 0)):
            if level is not None:
                # Move A only when its queue is empty, so the rebind flushes
                # no frame: every index 0..95 is delivered.
                _wait(lambda: len(got[a]) >= lo, f"session A's first {lo}")
                tr = time.perf_counter()
                if not fe.request_session_quality(a, level, reason="phase 10"):
                    raise AssertionError(f"control (a): quality {level} refused")
                _wait(lambda: fe._session(a).quality_level == level,
                      f"the rebind to level {level}")
                rebinds_t[level] = (time.perf_counter() - tr) * 1e3
                cut_at[level] = fe._session(a).submitted
            ts = time.perf_counter()
            for j in range(lo, hi):
                for sid, base in zip(sids, bases):
                    fe.submit(sid, tagged(base, j))
            while any(len(v) < hi for v in got.values()):
                if time.perf_counter() - t0 > 300:
                    raise AssertionError(f"control (a) stalled: "
                                         f"{ {s: len(v) for s, v in got.items()} }")
                for sid in sids:
                    got[sid].extend(fe.poll(sid))
                for i, s in enumerate(subs):
                    sub_got[i].extend(s.poll(256))
                relay_got.extend(rsub.poll(256))
                time.sleep(0.002)
            seg_s.append(time.perf_counter() - ts)
        wall = time.perf_counter() - t0
        delta = dict(tk.LAUNCHES)
        if not ch.flush(timeout=60.0):
            raise AssertionError("control (d): the fan-out did not quiesce")
        for i, s in enumerate(subs):
            sub_got[i].extend(s.poll(256))
        deadline = time.time() + 30.0
        while len(relay_got) < n and time.time() < deadline:
            relay_got.extend(rsub.poll(256))
            time.sleep(0.002)
        view = fe.control_view()
        ch_stats = ch.stats()
        slow_stats = slow.stats()
        relay_stats = node.stats()
        events = fe.ledger.snapshot()
        quality_buckets = {b.label(): b.engine.stats.batches
                           - b0.get(id(b.engine), 0) for b in fe._buckets}
        k3_batches = sum(v for k, v in quality_buckets.items()
                         if k.startswith("sobel_bilateral"))
        k1_batches = sum(v for k, v in quality_buckets.items()
                         if k.startswith("gaussian_blur"))
        half = [k for k in quality_buckets
                if k.startswith("sobel_bilateral|upscale(scale=2)|"
                                f"{SERVE_HD[0] // 2}x{SERVE_HD[1] // 2}x3")]
        half_batches = quality_buckets[half[0]] if half else 0
    mem = _mem_after_stop("(a)+(d)")
    # -- (a) checks -------------------------------------------------------
    serve_counted(delta, {"sobel_bilateral": k3_batches,
                          "sep_blur": k1_batches}, "control (a)")
    if not half_batches:
        raise AssertionError(f"control (a): K3 never ran at half size: "
                             f"{quality_buckets}")
    hits = [e for e in events if e["kind"] == ledger_mod.POOL_ACQUIRE
            and e.get("cause") == ledger_mod.CAUSE_QUALITY]
    if not hits or any(e.get("cache") != "hit" for e in hits):
        raise AssertionError(f"control (a): the downshift was not a pool "
                             f"hit: {hits}")
    rebinds = [e for e in events if e["kind"] == ledger_mod.QUALITY_REBIND]
    if [e["level"] for e in rebinds] != [1, 0] or \
            [cut_at[1], cut_at[0]] != list(CONTROL_CUTS):
        raise AssertionError(f"control (a): rebinds {rebinds}, cutovers "
                             f"{cut_at}")
    for sid in sids:
        idx = [d.index for d in got[sid]]
        if idx != list(range(n)):
            raise AssertionError(f"control (a) {sid}: indices {idx[:8]}...")
        if any(d.frame.shape != SERVE_HD for d in got[sid]):
            raise AssertionError(f"control (a) {sid}: a frame not {SERVE_HD}")
    lsb = {}
    for sid, chain, base in zip(sids, chains, bases):
        frames = [tagged(base, j) for j in range(n)]
        want = serve_plain(chain, frames, dev, plain_of)
        if sid == a:
            lo, hi = CONTROL_CUTS
            want[lo:hi] = plain_down(chain, frames[lo:hi], dev, plain_of)
        lsb[sid] = max_lsb(np.stack([d.frame for d in got[sid]]), want)
        if lsb[sid] > 1:
            raise AssertionError(f"control (a) {sid} {chain}: {lsb[sid]} LSB "
                                 f"from the plain version")
    segments = ((0, CONTROL_CUTS[0]), CONTROL_CUTS, (CONTROL_CUTS[1], n))

    def rate(lo, hi):
        # session A's delivery rate over its frames lo..hi-1: the level-1
        # bucket served A alone while A was downshifted
        t = [d.capture_ts + d.latency_ms / 1e3 for d in got[a][lo:hi]]
        return (len(t) - 1) / (max(t) - min(t))

    fps = {"session_a_level_0_1_0": [rate(lo, hi) for lo, hi in segments],
           # all three sessions' frames per second in each segment
           "all_sessions_level_0_1_0": [3 * (hi - lo) / w for (lo, hi), w
                                        in zip(segments, seg_s)]}
    for e in rebinds:
        log(f"control (a) ledger quality_rebind: level {e['level']}, session "
            f"{e['session']}, cutover index {cut_at[e['level']]}, stall_ms "
            f"{e['stall_ms']}, frames_flushed {e['frames_flushed']}, signature "
            f"{e['signature']}")
    log(f"control (a): admission {admit_ms:.1f} ms; quality programs warmed at "
        f"admission: {[(e['signature'], e.get('compile_ms')) for e in warm]}; "
        f"downshift pool acquires {[(e['signature'], e['cache']) for e in hits]}")
    log(f"control (a): {3 * n} frames in {wall:.3f} s; session A's fps with A "
        f"at level 0, 1, 0 (its bucket's): "
        f"{[round(v, 1) for v in fps['session_a_level_0_1_0']]}, all three "
        f"sessions' over the same segments: "
        f"{[round(v, 1) for v in fps['all_sessions_level_0_1_0']]}; request "
        f"to rebind applied {json.dumps({k: round(v, 3) for k, v in rebinds_t.items()})} "
        f"ms; launches {delta} (K3 at {SERVE_HD[0] // 2}x{SERVE_HD[1] // 2}: "
        f"{half_batches} batches); max "
        f"LSB {lsb}")
    log(f"control (a) control_view(): {json.dumps(view)}")
    # -- (d) checks -------------------------------------------------------
    frame_of = {d.index: d.frame for d in got[a]}
    encodes = {k: v["encodes_total"] for k, v in ch_stats["tiers"].items()}
    if ch_stats["offered_total"] != n or ch_stats["ingest_dropped_total"] or \
            any(v != n for v in encodes.values()):
        raise AssertionError(f"control (d): offered {ch_stats['offered_total']}, "
                             f"ingest drops {ch_stats['ingest_dropped_total']}, "
                             f"encodes {encodes} (want {n} per tier)")
    if not slow_stats["evicted"]:
        raise AssertionError(f"control (d): the slow subscriber was not "
                             f"evicted: {slow_stats}")
    first = {}
    for i, got_i in enumerate(sub_got):
        tier = tiers[i % 3]
        if [d.seq for d in got_i] != list(range(n)):
            raise AssertionError(f"control (d) subscriber {i}: seqs "
                                 f"{[d.seq for d in got_i][:8]}...")
        if tier not in first:
            first[tier] = got_i
            for d in got_i:
                f = frame_of[d.seq]
                want = (f if tier.geometry is None
                        else downscale(f, tier.geometry)).tobytes()
                if not is_stamped(d.payload) or \
                        verify_wire(d.payload, hop="subscriber") != want:
                    raise AssertionError(f"control (d) {tier.label()} seq "
                                         f"{d.seq}: payload is not the "
                                         f"delivered frame's")
        elif any(x.payload is not y.payload and x.payload != y.payload
                 for x, y in zip(got_i, first[tier])):
            raise AssertionError(f"control (d) subscriber {i}: payloads "
                                 f"differ from its tier's")
    direct = {d.seq: d.payload for d in first[tiers[0]]}
    if [d.seq for d in relay_got] != list(range(n)) or any(
            d.payload != direct[d.seq] for d in relay_got):
        raise AssertionError("control (d): the relay did not forward verbatim")
    for d in relay_got:
        verify_wire(d.payload, hop="relay subscriber")
    if relay_stats["forward"]["encodes_total"] != 0:
        raise AssertionError(f"control (d): the relay encoded: {relay_stats}")
    fan_ms = {k: 1e3 * statistics.mean(v) for k, v in fanout_s.items() if v}
    log(f"control (d): channel offered {ch_stats['offered_total']}, encodes "
        f"per tier {encodes}, fan-out frames "
        f"{ {k: v['fanout_frames_total'] for k, v in ch_stats['tiers'].items()} }; "
        f"slow subscriber evicted (dropped {slow_stats['dropped']}); {BCAST_SUBS} "
        f"subscribers byte-identical to downscale(delivered frame, tier) "
        f"(audit-stamped, verified); relay forwarded {len(relay_got)} verbatim, "
        f"stamps verified, {relay_stats['forward']['encodes_total']} encodes; "
        f"fan-out ms per frame per tier (encode once + enqueue + stamp) "
        f"{json.dumps({k: round(v, 4) for k, v in fan_ms.items()})}, total "
        f"{sum(fan_ms.values()):.4f}")
    torch.cuda.empty_cache()
    row_a = dict(leg="a_quality", frames=3 * n, wall_s=wall, launches=delta,
                 k3_half_batches=half_batches, fps=fps, max_lsb=lsb,
                 cutovers={str(k): v for k, v in cut_at.items()},
                 rebinds=[{k: e.get(k) for k in ("level", "stall_ms",
                                                 "frames_flushed", "signature")}
                          for e in rebinds],
                 request_to_rebind_ms=rebinds_t,
                 warm_compile_ms=[e.get("compile_ms") for e in warm],
                 control_view=view, memory_allocated_after_stop=mem)
    row_d = dict(leg="d_broadcast", offered=ch_stats["offered_total"],
                 encodes=encodes, subscribers=BCAST_SUBS,
                 slow_evicted=True, relay_forwarded=len(relay_got),
                 fanout_ms_per_frame=fan_ms)
    return row_a, row_d, delta


def _levels_matched(chain: str, frames: list, got: list, dev, plain_of: dict,
                    levels) -> list:
    """Per delivered frame, the set of quality levels (of ``levels``)
    whose plain program it matches within 1 LSB, computed on the card in
    batches."""
    import torch

    from dvf_tpu_torch.utils.image import to_float, to_uint8

    fn = plain_of[chain]
    out = []
    for i in range(0, len(frames), SERVE_BATCH):
        x = torch.from_numpy(np.stack(frames[i:i + SERVE_BATCH])).to(dev)
        y = torch.from_numpy(np.stack([d.frame for d in got[i:i + SERVE_BATCH]])
                             ).to(dev).to(torch.int16)
        lsb = {}
        for lv in levels:
            xi = x if lv == 0 else x[:, ::2, ::2].contiguous()
            w = to_uint8(fn(to_float(xi)))
            if lv:
                w = w.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            lsb[lv] = (y - w.to(torch.int16)).abs().amax(dim=(1, 2, 3)).tolist()
        for k in range(y.shape[0]):
            out.append({lv for lv in levels if lsb[lv][k] <= 1})
    return out


def control_leg_loop(dev, plain_of: dict):
    """(b) The closed loop: the default ControlConfig, 6 sobel_bilateral
    sessions at 1080p, one frame to each per wave at 60 Hz (360 frames/s
    offered, above what the bucket serves) under a 150 ms SLO. Asserts only what no timing
    decides: the plane sampled, no hook or apply raised, every delivered
    frame full size, in order, and within 1 LSB of the program the
    ledger's rebinds say served it. Then the admission floor."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.obs import ledger as ledger_mod
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.serve import AdmissionError

    cfg = _serve_config(max_buckets=3, pool_capacity=4, queue_size=8,
                          out_queue_size=LOOP_WAVES, slo_ms=LOOP_SLO_MS,
                          control=True)
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"), cfg)
    bases = serve_bases(SERVE_HD, LOOP_SESSIONS, 110)
    with fe:
        sids = [fe.open_stream(op_chain="sobel_bilateral", frame_shape=SERVE_HD)
                for _ in range(LOOP_SESSIONS)]
        _wait(lambda: any(e["kind"] == ledger_mod.COMPILE
                          and e.get("cause") == ledger_mod.CAUSE_QUALITY
                          for e in fe.ledger.snapshot()),
              "the quality program's admission warm-up")
        got = {sid: [] for sid in sids}
        tk.reset_launches()
        t0 = time.perf_counter()
        for w in range(LOOP_WAVES):
            for sid, base in zip(sids, bases):
                fe.submit(sid, tagged(base, w))
            for sid in sids:
                got[sid].extend(fe.poll(sid))
            time.sleep(max(0.0, t0 + (w + 1) / LOOP_HZ - time.perf_counter()))
        quiet_deadline = time.time() + 60.0
        while any(len(s.ingress) + len(s.pending)
                  for s in (fe._session(x) for x in sids)) or \
                len(fe._window):
            if time.time() > quiet_deadline:
                raise AssertionError(f"control (b): never drained: {fe.health()}")
            for sid in sids:
                got[sid].extend(fe.poll(sid))
            time.sleep(0.005)
        time.sleep(0.2)
        for sid in sids:
            got[sid].extend(fe.poll(sid))
        wall = time.perf_counter() - t0
        delta = dict(tk.LAUNCHES)
        cstats = fe.control_plane.stats()
        series = fe.telemetry.series()
        st = fe.stats()
        events = fe.ledger.snapshot()
        # The admission floor, with the controllers paused so that none of
        # their own floor moves races this one.
        fe.control_plane.paused = True
        _wait(lambda: fe.control_plane.stats()["pending_applies"] == 0,
              "the control plane's pending applies")
        fe.set_admission_tier_floor(1)
        try:
            fe.open_stream(op_chain="sobel_bilateral", frame_shape=SERVE_HD,
                           tier=2)
            raise AssertionError("control (b): a tier-2 open passed floor 1")
        except AdmissionError as e:
            refused = str(e)
        admitted = fe.open_stream(op_chain="sobel_bilateral",
                                  frame_shape=SERVE_HD, tier=0)
    mem = _mem_after_stop("(b)")
    if series["hook_errors_total"] or cstats["apply_errors_total"] or \
            not series["rows"]:
        raise AssertionError(f"control (b): rows {len(series['rows'])}, hook "
                             f"errors {series['hook_errors_total']}, apply "
                             f"errors {cstats['apply_errors_total']}")
    if not delta["sobel_bilateral"]:
        raise AssertionError(f"control (b): K3 never launched: {delta}")
    checked, moves = 0, {}
    for sid, base in zip(sids, bases):
        d_list = got[sid]
        idx = [d.index for d in d_list]
        if idx != sorted(set(idx)):
            raise AssertionError(f"control (b) {sid}: indices out of order: "
                                 f"{idx[:12]}...")
        if any(d.frame.shape != SERVE_HD for d in d_list):
            raise AssertionError(f"control (b) {sid}: a frame not full size")
        levels = [0] + [e["level"] for e in events
                        if e["kind"] == ledger_mod.QUALITY_REBIND
                        and e.get("session") == sid]
        moves[sid] = levels[1:]
        frames = [tagged(base, i) for i in idx]
        pos = 0
        for i, ok in enumerate(_levels_matched(
                "sobel_bilateral", frames, d_list, dev, plain_of,
                sorted(set(levels)))):
            nxt = next((q for q in range(pos, len(levels))
                        if levels[q] in ok), None)
            if nxt is None:
                raise AssertionError(
                    f"control (b) {sid} frame {idx[i]}: matches levels {ok}, "
                    f"but the ledger's sequence {levels} is at {levels[pos]}")
            pos = nxt
        checked += len(d_list)
        del frames
    if not checked:
        raise AssertionError("control (b): no frame was delivered")
    decisions = {}
    for e in cstats["decisions"]:
        decisions.setdefault(e["kind"], []).append(
            {k: e.get(k) for k in ("target", "value", "reason")})
    log(f"control (b): {LOOP_WAVES} waves x {LOOP_SESSIONS} sessions in "
        f"{wall:.3f} s; delivered {checked} (each within 1 LSB of the program "
        f"the ledger says served it), shed {st['shed_total']}, samples "
        f"{len(series['rows'])}, hook errors 0; launches {delta}")
    log(f"control (b) counters: {json.dumps({k: v for k, v in cstats.items() if k.endswith('_total')})}, "
        f"tier floor {cstats['tier_floor']}, tick {cstats['tick_s']}; per-session "
        f"rebind levels {json.dumps(moves)}")
    for kind, acts in decisions.items():
        log(f"control (b) {kind} actions ({len(acts)}): {json.dumps(acts[:6])}")
    log(f"control (b): floor 1 refused a tier-2 open ({refused}); admitted a "
        f"tier-0 open ({admitted})")
    torch.cuda.empty_cache()
    return dict(leg="b_closed_loop", waves=LOOP_WAVES, sessions=LOOP_SESSIONS,
                wall_s=wall, delivered=checked, shed=st["shed_total"],
                samples=len(series["rows"]), launches=delta,
                counters={k: v for k, v in cstats.items() if k.endswith("_total")},
                rebind_levels=moves, memory_allocated_after_stop=mem), delta


def control_leg_plan(dev, tmp: str):
    """(c) Auto-plan: a 1080p gaussian_blur(ksize=9) frontend, batch 8,
    autoplan on a fresh plan_cache_dir (cold: the measured search), then a
    second frontend on the same directory (warm: a cache hit, its compile
    seeded), and a CPU entry that a card lookup must miss."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.control import plan_cache as pc
    from dvf_tpu_torch.control import planner as pl
    from dvf_tpu_torch.obs import ledger as ledger_mod
    from dvf_tpu_torch.ops import kernels as tk

    chain = "gaussian_blur(ksize=9)"
    cache = os.path.join(tmp, "plans")
    kind = torch.cuda.get_device_name(0)

    def frontend():
        return dvf_tpu_torch.ServeFrontend(
            dvf_tpu_torch.get_filter("invert"),
            _serve_config(batch_size=PLAN_BATCH, queue_size=4 * PLAN_BATCH,
                            out_queue_size=4 * PLAN_BATCH, autoplan=True,
                            plan_cache_dir=cache,
                            autoplan_burst_frames=PLAN_BURST))

    def compiles(fe):
        return [e for e in fe.ledger.snapshot()
                if e["kind"] == ledger_mod.COMPILE
                and e.get("cause") == ledger_mod.CAUSE_ADMISSION]

    fe = frontend()
    with fe:
        tk.reset_launches()
        t0 = time.perf_counter()
        doc = fe.autoplan(op_chain=chain, frame_shape=SERVE_HD,
                          log=lambda m: log(f"control (c) search: {m}"))
        search_s = time.perf_counter() - t0
        delta = dict(tk.LAUNCHES)
        cold = [e for e in fe.ledger.snapshot() if e["kind"] == ledger_mod.PLAN]
        cold_compile = compiles(fe)
        topo = fe._topology_fingerprint()
    mem_cold = _mem_after_stop("(c) cold")
    ev = cold[-1]
    grid = pl.candidate_grid(batch_cap=2 * PLAN_BATCH)
    if ev["cache"] != "miss" or ev["grid"] != len(grid) or len(grid) != 45 or \
            not 0 < ev["legs"] <= len(grid) // 3 or doc["source"] != "measured":
        raise AssertionError(f"control (c) cold: {ev}, plan {doc}")
    if kind not in topo or not topo.startswith("torch-cuda/"):
        raise AssertionError(f"control (c): fingerprint {topo!r} does not "
                             f"name the card {kind!r}")
    if not delta["sep_blur"]:
        raise AssertionError(f"control (c): the search never launched K1: {delta}")
    sig = f"{chain}|{SERVE_HD[0]}x{SERVE_HD[1]}x3|uint8"
    cal_sig = f"b{PLAN_BATCH}|{sig}"
    cached_cal = pc.load_calibrations(cache, topo, cal_sig)
    log(f"control (c) cold: grid {len(grid)} candidates (batch "
        f"{sorted({p.batch_size for p in grid})} x tick "
        f"{sorted({p.tick_s for p in grid})} x depth "
        f"{sorted({p.ingest_depth for p in grid})}), live-profiled "
        f"{ev['legs']}, winner {json.dumps(doc)}, wall_ms {ev['wall_ms']} "
        f"({search_s:.2f} s), topology {topo!r}, launches {delta}; admission "
        f"compile {[e.get('compile_ms') for e in cold_compile]} ms")
    fe = frontend()
    with fe:
        sid = fe.open_stream(op_chain=chain, frame_shape=SERVE_HD)
        eng = fe._session(sid).bucket.engine
        seeded = eng.calibration_seeded
        warm_compile = compiles(fe)
        t0 = time.perf_counter()
        doc2 = fe.autoplan(op_chain=chain, frame_shape=SERVE_HD)
        hit_s = time.perf_counter() - t0
        warm = [e for e in fe.ledger.snapshot() if e["kind"] == ledger_mod.PLAN]
        fe.close(sid, drain=False)
    mem_warm = _mem_after_stop("(c) warm")
    ev2 = warm[-1]
    if ev2["cache"] != "hit" or ev2["legs"] != 0 or not seeded or \
            doc2["source"] != "cache" or {k: v for k, v in doc2.items()
                                          if k != "source"} != \
            {k: v for k, v in doc.items() if k != "source"}:
        raise AssertionError(f"control (c) warm: {ev2}, seeded {seeded}, "
                             f"plan {doc2}")
    # A quiet calibration beside the cached one (the cold run's was taken
    # beside its own search traffic).
    quiet = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("gaussian_blur",
                                                          ksize=9))
    quiet.compile((PLAN_BATCH, *SERVE_HD))
    quiet_cal = calibrations(quiet)
    quiet.free()
    # A CPU entry for the same signature never answers a card lookup.
    cpu_dir = os.path.join(tmp, "plans-cpu")
    cpu_plan = pl.Plan.from_doc(doc)
    pl.plan_to_cache(cpu_dir, sig, SERVE_HD, pc.topology_fingerprint("cpu"),
                     dataclasses.replace(cpu_plan, source=pl.PLAN_SOURCE_MEASURED))
    if pl.plan_from_cache(cpu_dir, sig, SERVE_HD,
                          pc.topology_fingerprint("cpu")) is None or \
            pl.plan_from_cache(cpu_dir, sig, SERVE_HD, topo) is not None:
        raise AssertionError("control (c): a CPU plan entry answered a card lookup")
    log(f"control (c) warm: plan event cache {ev2['cache']}, legs {ev2['legs']}, "
        f"wall_ms {ev2['wall_ms']} ({hit_s * 1e3:.2f} ms), same plan; compile "
        f"seeded {seeded}: {[e.get('compile_ms') for e in warm_compile]} ms "
        f"against the cold {[e.get('compile_ms') for e in cold_compile]} ms; "
        f"cached calibrations {json.dumps(cached_cal)} beside a quiet compile's "
        f"{json.dumps(quiet_cal)}; a CPU entry misses under the card's "
        f"fingerprint")
    torch.cuda.empty_cache()
    return dict(leg="c_autoplan", grid=len(grid), searched=ev["legs"],
                winner=doc, wall_ms_cold=ev["wall_ms"], wall_ms_warm=ev2["wall_ms"],
                topology=topo, launches=delta,
                compile_ms_cold=[e.get("compile_ms") for e in cold_compile],
                compile_ms_warm=[e.get("compile_ms") for e in warm_compile],
                seeded=seeded, cached_calibrations=cached_cal,
                quiet_calibrations=quiet_cal,
                memory_allocated_after_stop=[mem_cold, mem_warm]), delta


def control_leg_publish_fps(dev):
    """(d) The publisher's cost: one 1080p sobel_bilateral session's fps
    with publishing off, on, on, off in one frontend (on: the three raw
    tiers, 64 subscribers drained by a thread)."""
    import threading

    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk

    n = BCAST_FPS_FRAMES
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"),
                                     _serve_config(max_buckets=2))
    base = serve_bases(SERVE_HD, 1, 120)[0]
    runs = []
    with fe:
        warm = fe.open_stream(op_chain="sobel_bilateral", frame_shape=SERVE_HD)
        serve_drive(fe, {warm: base}, SERVE_BATCH)   # an uncounted pass
        fe.close(warm, drain=True)
        tk.reset_launches()
        for k, on in enumerate((False, True, True, False)):
            kw = ({"publish": f"fps{k}", "publish_tiers": list(BCAST_TIERS)}
                  if on else {})
            sid = fe.open_stream(op_chain="sobel_bilateral",
                                 frame_shape=SERVE_HD, **kw)
            stop = threading.Event()
            drainer = None
            if on:
                subs = [fe.subscribe(f"fps{k}", tier=BCAST_TIERS[i % 3])
                        for i in range(BCAST_SUBS)]

                def drain_subs(subs=subs):
                    while not stop.is_set():
                        for s in subs:
                            s.poll(256)
                        time.sleep(0.001)

                drainer = threading.Thread(target=drain_subs, daemon=True)
                drainer.start()
            got, wall = serve_drive(fe, {sid: base}, n)
            if [d.index for d in got[sid]] != list(range(n)):
                raise AssertionError(f"control (d) fps run {k}: out of order")
            stop.set()
            if drainer is not None:
                drainer.join(timeout=10)
            fe.close(sid, drain=True)
            if on:
                fe.broadcast.unpublish(f"fps{k}")
            runs.append(dict(publish=on, fps=n / wall, wall_s=wall))
        delta = dict(tk.LAUNCHES)
    mem = _mem_after_stop("(d) fps")
    log(f"control (d) publisher fps off, on, on, off: "
        f"{[round(r['fps'], 2) for r in runs]} ({n} frames each, "
        f"{BCAST_SUBS} subscribers on the three raw tiers when on); launches "
        f"{delta}")
    torch.cuda.empty_cache()
    return dict(leg="d_publish_fps", runs=runs,
                memory_allocated_after_stop=mem), delta


def control_phase(dev, plain_of: dict):
    """Phase 10: legs (a)-(d) of the control plane, auto-plan and broadcast.
    Returns (rows, the summed launch counts of the legs' counted runs)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    rows, total = [], {}

    def add(delta):
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v

    log(f"control phase on {nvidia_smi()}")
    row_a, row_d, delta = control_leg_quality(dev, plain_of)
    rows += [row_a, row_d]
    add(delta)
    row, delta = control_leg_loop(dev, plain_of)
    rows.append(row)
    add(delta)
    with tempfile.TemporaryDirectory() as tmp:
        row, delta = control_leg_plan(dev, tmp)
    rows.append(row)
    add(delta)
    row, delta = control_leg_publish_fps(dev)
    rows.append(row)
    add(delta)
    from dvf_tpu_torch.broadcast import plane as bplane
    from dvf_tpu_torch.broadcast import relay as brelay
    from dvf_tpu_torch.runtime.engine import live_pool_engines

    if live_pool_engines() or bplane.live_broadcast_sockets() or \
            brelay.live_relay_nodes():
        raise AssertionError("control: engines, gates or relays outlived "
                             "their frontends")
    torch.cuda.empty_cache()
    log(f"control phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total


def control_only() -> None:
    """The build and phase 10 alone (control, auto-plan, broadcast):
    ``python3 -c 'import chip_smoke; chip_smoke.control_only()'``."""
    dev, plain_of, _ = _only_setup()
    rows, _ = control_phase(dev, plain_of)
    print(json.dumps({"control": rows}))


# ---------------------------------------------------------------------------
# Phase 11: the fleet tier (local and process replicas on the one card)
# ---------------------------------------------------------------------------

FLEET_HD = SERVE_HD              # 1080 x 1920 x 3, phase 7 (a)'s geometry
FLEET_FRAMES = 32                # leg (a): frames per session
KILL_FRAMES, KILL_AT = 40, 10    # leg (b): frames per session, SIGKILL after 10
SNAP_FRAMES = 4                  # leg (e): frames before the front door's crash


def _manifest(chains) -> list:
    return [{"op_chain": c, "frame_shape": list(FLEET_HD)} for c in chains]


def fleet_drive(fleet, plan: dict, frames, deadline_s: float = 180.0):
    """Submit ``frames`` (a range of indices) to every session of ``plan``
    ({sid: base}) round robin, then poll until each has them all. Returns
    ({sid: [Delivery]}, wall seconds, submit seconds, poll seconds)."""
    frames = list(frames)
    got = {sid: [] for sid in plan}
    t0 = time.perf_counter()
    for j in frames:
        for sid, base in plan.items():
            fleet.submit(sid, tagged(base, j))
    t_submit = time.perf_counter() - t0
    t_poll = 0.0
    deadline = time.time() + deadline_s
    while any(len(v) < len(frames) for v in got.values()):
        if time.time() > deadline:
            raise AssertionError(
                f"fleet stalled: { {s: len(v) for s, v in got.items()} } of "
                f"{len(frames)}; replicas {fleet.stats()['replicas']}")
        for sid in plan:
            t = time.perf_counter()
            fresh = fleet.poll(sid)
            if fresh:
                t_poll += time.perf_counter() - t
            got[sid].extend(fresh)
        time.sleep(0.002)
    return got, time.perf_counter() - t0, t_submit, t_poll


def fleet_counted(delta: dict, want: dict, label: str) -> None:
    """K1/K3 launched exactly ``want`` times, and both at least once."""
    serve_counted(delta, want, label)
    if not all(delta[k] for k in want):
        raise AssertionError(f"{label}: a kernel never launched: {delta}")


def _replica_batches(fleet, sids: dict) -> dict:
    """Device batches per chain, summed over the buckets the sessions'
    replicas served them in ({sid: chain})."""
    out, seen = {}, set()
    for sid, chain in sids.items():
        s = fleet._sessions[sid]
        fe = fleet._replicas[s.replica_id].frontend
        eng = fe._session(s.replica_sid).bucket.engine
        if id(eng) not in seen:
            seen.add(id(eng))
            out[chain] = out.get(chain, 0) + eng.stats.batches
    return out


def fleet_leg_local(dev, plain_of: dict):
    """(a) Two local replicas on the card serving 2 sobel_bilateral and 2
    gaussian_blur(ksize=9) sessions at 1080p (declared by op_chain), 32
    frames each, beside one ServeFrontend serving the same mix: single,
    fleet, fleet, single in one call. The fleet runs are counted (K1/K3
    launches against their buckets' batches) and checked frame by frame;
    the first one's registry is scraped (leg (e))."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend
    from dvf_tpu_torch.obs.export import MetricsExporter
    from dvf_tpu_torch.ops import kernels as tk

    tenants = [("sobel_bilateral", 2), ("gaussian_blur(ksize=9)", 2)]
    runs, delta_total, scrape = [], {}, None
    for k, kind in enumerate(("single", "fleet", "fleet", "single")):
        if kind == "fleet":
            front = FleetFrontend(
                dvf_tpu_torch.get_filter("invert"),
                FleetConfig(replicas=2, mode="local",
                            serve=_serve_config(max_buckets=3,
                                                      pool_capacity=3)),
                device=dev)
        else:
            front = dvf_tpu_torch.ServeFrontend(
                dvf_tpu_torch.get_filter("invert"),
                _serve_config(max_buckets=3, pool_capacity=3), device=dev)
        plan, chain_of = {}, {}
        with front:
            t = time.perf_counter()
            seed = 110
            for chain, n in tenants:
                for base in serve_bases(FLEET_HD, n, seed):
                    sid = front.open_stream(op_chain=chain, frame_shape=FLEET_HD)
                    plan[sid], chain_of[sid] = base, chain
                seed += 1
            admit_ms = (time.perf_counter() - t) * 1e3
            load = os.getloadavg()
            tk.reset_launches()
            got, wall, _, _ = fleet_drive(front, plan, range(FLEET_FRAMES))
            delta = dict(tk.LAUNCHES)
            row = dict(run=k, kind=kind, frames=FLEET_FRAMES * len(plan),
                       wall_s=wall, fps=FLEET_FRAMES * len(plan) / wall,
                       admit_ms=admit_ms, loadavg=list(load), launches=delta)
            if kind == "fleet":
                st = front.stats()
                placed = {sid: st["sessions"][sid]["replica"] for sid in plan}
                if set(placed.values()) != {"r0", "r1"}:
                    raise AssertionError(f"fleet (a): placements {placed}")
                batches = _replica_batches(front, chain_of)
                fleet_counted(delta, {"sobel_bilateral": batches["sobel_bilateral"],
                                      "sep_blur": batches["gaussian_blur(ksize=9)"]},
                              f"fleet (a) run {k}")
                if st["order_violations"] or st["replica_losses"]:
                    raise AssertionError(f"fleet (a): {st['order_violations']} "
                                         f"order violations, "
                                         f"{st['replica_losses']} losses")
                row.update(placements=placed, batches=batches,
                           aggregate=st["aggregate"],
                           replicas={rid: {x: r.get(x) for x in (
                               "sessions", "engine_batches", "engine_frames")}
                               for rid, r in st["replicas"].items()})
                for key, v in delta.items():
                    delta_total[key] = delta_total.get(key, 0) + v
                if scrape is None:
                    with MetricsExporter(front.registry, ring=front.telemetry) as ex:
                        text = _get_text(f"{ex.url}/metrics")
                    want = ["dvf_fleet_p50_ms ", "dvf_fleet_p99_ms "] + [
                        f'dvf_fleet_replica_up{{replica="{r}"}} 1' for r in ("r0", "r1")]
                    missing = [w for w in want if w not in text]
                    if missing:
                        raise AssertionError(f"fleet (e) scrape: missing {missing}")
                    scrape = dict(
                        series=sum(1 for ln in text.splitlines()
                                   if ln.startswith("dvf_fleet")),
                        lines=[ln for ln in text.splitlines() if ln.startswith((
                            "dvf_fleet_p50_ms", "dvf_fleet_p99_ms",
                            "dvf_fleet_replica_up", "dvf_fleet_replica_sessions"))])
            lsb = max(serve_check(f"fleet (a) {kind} {chain_of[sid]} {sid}",
                                  chain_of[sid], plan[sid], got[sid],
                                  FLEET_FRAMES, dev, plain_of) for sid in plan)
            row["max_lsb"] = lsb
        runs.append(row)
        log(f"fleet (a) run {k} {kind}: {row['frames']} frames in {wall:.3f} s "
            f"({row['fps']:.1f} fps), admission {admit_ms:.1f} ms, loadavg "
            f"{load}, launches {delta}, max {lsb} LSB"
            + (f", placements {row['placements']}, batches {row['batches']}"
               if kind == "fleet" else ""))
        del front
        torch.cuda.empty_cache()
    fps = {kind: [r["fps"] for r in runs if r["kind"] == kind]
           for kind in ("single", "fleet")}
    ratio = statistics.mean(fps["fleet"]) / statistics.mean(fps["single"])
    log(f"fleet (a): fleet / single fps {ratio:.3f} ({fps}); scrape "
        f"{json.dumps(scrape)}")
    return dict(leg="a_local", runs=runs, fleet_over_single=ratio,
                scrape=scrape), delta_total


def _process_fleet(**kw):
    """A process fleet on the card (its default device, cuda:0), each
    child precompiling the 1080p sobel_bilateral signature before ready."""
    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend

    return FleetFrontend(config=FleetConfig(
        mode="process", filter_spec=("sobel_bilateral", {}),
        serve=_serve_config(), startup_timeout_s=300.0,
        precompile=_manifest(["sobel_bilateral"]), **kw))


def _kill_scenario(kill: bool, bases: dict):
    """Two process replicas serving sessions A and B (sobel_bilateral,
    undeclared: least-loaded placement); with ``kill`` B's replica gets a
    real SIGKILL after frame 10, then A and B keep streaming to 40 and a
    new session C is served after the loss. Returns (deliveries, stats,
    spawn-to-ready ms per replica, RPC seconds)."""
    fleet = _process_fleet(replicas=2, health_poll_s=0.1, max_restarts=1)
    t0 = time.monotonic()
    got = {"A": [], "B": []}
    rpc = {"submit_s": 0.0, "poll_s": 0.0, "frames": 0}
    with fleet:
        ready_ms = {rid: (r.started_at - t0) * 1e3
                    for rid, r in fleet._replicas.items()}
        a, b = fleet.open_stream("A"), fleet.open_stream("B")
        st = fleet.stats()
        rb = st["sessions"]["B"]["replica"]
        if st["sessions"]["A"]["replica"] == rb:
            raise AssertionError(f"fleet (b): A and B share {rb}")

        def drive(sids, frames):
            g, _, ts, tp = fleet_drive(fleet, {s: bases[s] for s in sids}, frames)
            for s in sids:
                got[s].extend(g[s])
            rpc["submit_s"] += ts
            rpc["poll_s"] += tp
            rpc["frames"] += len(list(frames)) * len(sids)

        drive(["A", "B"], range(KILL_AT))
        if kill:
            fleet._replicas[rb].kill()   # a real SIGKILL
            # frames submitted into the loss window: A's all arrive, B's
            # at most once
            for j in range(KILL_AT, 2 * KILL_AT):
                fleet.submit(a, tagged(bases["A"], j))
                fleet.submit(b, tagged(bases["B"], j))
                time.sleep(0.02)
            _wait(lambda: fleet.stats()["migrated_sessions"] >= 1,
                  "the migration", 120.0, phase="fleet (b)")
            for j in range(2 * KILL_AT, KILL_FRAMES):
                fleet.submit(a, tagged(bases["A"], j))
                fleet.submit(b, tagged(bases["B"], j))

            def done():
                for s in ("A", "B"):
                    got[s].extend(fleet.poll(s))
                return (len(got["A"]) >= KILL_FRAMES and got["B"]
                        and got["B"][-1].index == KILL_FRAMES - 1)

            _wait(done, "A's and B's last frames", 180.0, phase="fleet (b)")
        else:
            drive(["A", "B"], range(KILL_AT, KILL_FRAMES))
        c = fleet.open_stream("C")
        fleet.submit(c, tagged(bases["C"], 0))
        got["C"] = []
        _wait(lambda: got["C"].extend(fleet.poll(c)) or got["C"],
              "session C", 120.0, phase="fleet (b)")
        if kill:
            _wait(lambda: any(r["restarts"] >= 1 and r["state"] == "healthy"
                              for r in fleet.stats()["replicas"].values()),
                  "the victim's restart", 180.0, phase="fleet (b)")
        st = fleet.stats()
    return got, st, ready_ms, rpc


def fleet_leg_process(dev, plain_of: dict):
    """(b) Process replicas on the card: a fault-free run and one whose
    replica of session B is SIGKILLed after frame 10."""
    from dvf_tpu_torch.fleet.replica import live_worker_processes

    bases = dict(zip("ABC", serve_bases(FLEET_HD, 3, 120)))
    clean, clean_st, ready_clean, rpc = _kill_scenario(False, bases)
    faulted, st, ready_faulted, rpc_f = _kill_scenario(True, bases)
    if live_worker_processes():
        raise AssertionError("fleet (b): worker processes outlived the fleet")
    for s in ("A", "B"):
        serve_check(f"fleet (b) clean {s}", "sobel_bilateral", bases[s],
                    clean[s], KILL_FRAMES, dev, plain_of)
    if clean_st["faults"]["by_kind"] or clean_st["replica_losses"]:
        raise AssertionError(f"fleet (b) clean: faults {clean_st['faults']}")
    # the survivor: complete and bit-identical to the fault-free run
    lsb_a = serve_check("fleet (b) survivor A", "sobel_bilateral", bases["A"],
                        faulted["A"], KILL_FRAMES, dev, plain_of)
    identical = all(np.array_equal(x.frame, y.frame)
                    for x, y in zip(clean["A"], faulted["A"]))
    if not identical:
        raise AssertionError("fleet (b): the survivor's frames differ from "
                             "the fault-free run")
    bi = [d.index for d in faulted["B"]]
    if bi != sorted(set(bi)) or bi[:KILL_AT] != list(range(KILL_AT)) \
            or bi[-1] != KILL_FRAMES - 1:
        raise AssertionError(f"fleet (b): victim B delivered {bi}")
    want_b = serve_plain("sobel_bilateral",
                         [tagged(bases["B"], j) for j in bi], dev, plain_of)
    lsb_b = max_lsb(np.stack([d.frame for d in faulted["B"]]), want_b)
    if lsb_b > 1:
        raise AssertionError(f"fleet (b): victim B off by {lsb_b} LSB")
    restarted = [rid for rid, r in st["replicas"].items() if r["restarts"] >= 1]
    if not (st["replica_losses"] == 1 and st["migrated_sessions"] == 1
            and st["sessions"]["B"]["migrations"] == 1
            and st["order_violations"] == 0 and len(restarted) == 1
            and st["replicas"][restarted[0]]["state"] == "healthy"
            and len(faulted["C"]) == 1):
        raise AssertionError(f"fleet (b): losses {st['replica_losses']}, "
                             f"migrated {st['migrated_sessions']}, replicas "
                             f"{st['replicas']}, C {len(faulted['C'])}")
    rpc_ms = {"submit_ms_per_frame": rpc["submit_s"] * 1e3 / rpc["frames"],
              "poll_ms_per_frame": rpc["poll_s"] * 1e3 / rpc["frames"]}
    lost_b = KILL_FRAMES - len(bi)
    log(f"fleet (b): spawn-to-ready ms (torch import, CUDA context, kernel "
        f"load, 1080p precompile) clean {ready_clean}, faulted {ready_faulted}; "
        f"RPC per 1080p frame {json.dumps(rpc_ms)} over {rpc['frames']} frames "
        f"(6.2 MB pickled each way); survivor A bit-identical, max {lsb_a} LSB; "
        f"victim B {len(bi)} of {KILL_FRAMES} delivered (lost {lost_b} in the "
        f"loss window), max {lsb_b} LSB; restarted {restarted}; C served")
    return dict(leg="b_process", spawn_to_ready_ms=dict(clean=ready_clean,
                                                         faulted=ready_faulted),
                rpc=rpc_ms, rpc_frames=rpc["frames"], victim_delivered=len(bi),
                victim_lost=lost_b, survivor_identical=identical,
                max_lsb=max(lsb_a, lsb_b), restarted=restarted,
                faults=st["faults"]["by_kind"]), {}


def _mem(label: str) -> int:
    import gc

    import torch

    # Collect first: earlier phases leave device tensors in reference
    # cycles, and a collection between two readings would free them there
    # and move the reading by bytes that are not the fleet's.
    gc.collect()
    torch.cuda.synchronize()
    b = torch.cuda.memory_allocated()
    log(f"fleet {label}: memory_allocated {b} B")
    return b


def _serve_one(fleet, sid, frame, got: list, label: str) -> None:
    n = len(got)
    fleet.submit(sid, frame)
    _wait(lambda: got.extend(fleet.poll(sid)) or len(got) > n, label, 120.0,
          phase="fleet (c)")


def fleet_leg_elastic(dev, plain_of: dict):
    """(c) A local fleet with one warm standby: spawn_replica() takes it,
    and a fleet without a pool spawns cold, each timed to the spawned
    replica's first delivered frame; retire_replica() drains that
    replica's session onto the survivor. memory_allocated is back at its
    value before the spawn after the retire (the pool's refill stands in
    for the standby taken) and after a served replica's kill(), and at its
    value before the fleet after stop()."""
    import dvf_tpu_torch
    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend
    from dvf_tpu_torch.obs.memory import memory_summary

    base0, base = serve_bases(FLEET_HD, 2, 130)
    m_base = _mem("(c) before")
    out = {}
    for warm in (1, 0):
        kind = "warm" if warm else "cold"
        fleet = FleetFrontend(
            dvf_tpu_torch.get_filter("invert"),
            FleetConfig(replicas=1, mode="local", standby_warm=warm,
                        serve=_serve_config(),
                        precompile=_manifest(["sobel_bilateral"])),
            device=dev)
        with fleet:
            # r0 serves a frame first, so the spawn's memory is the only
            # difference the retire must take back
            s0 = fleet.open_stream(op_chain="sobel_bilateral", frame_shape=FLEET_HD)
            _serve_one(fleet, s0, tagged(base0, 0), [], "r0's first frame")
            if warm:
                _wait(lambda: fleet.standby.warm_count == 1, "the warm standby",
                      120.0, phase="fleet (c)")
            m0 = _mem(f"(c) {kind}: before the spawn")
            t0 = time.perf_counter()
            rid = fleet.spawn_replica()
            spawn_ms = (time.perf_counter() - t0) * 1e3
            sid = fleet.open_stream(op_chain="sobel_bilateral", frame_shape=FLEET_HD)
            if fleet._sessions[sid].replica_id != rid:
                raise AssertionError(f"fleet (c): the open went to "
                                     f"{fleet._sessions[sid].replica_id}, not {rid}")
            got = []
            _serve_one(fleet, sid, tagged(base, 0), got, f"{rid}'s first frame")
            first_ms = (time.perf_counter() - t0) * 1e3
            if fleet.standby_adoptions != warm:
                raise AssertionError(f"fleet (c): standby adoptions "
                                     f"{fleet.standby_adoptions}, want {warm}")
            if warm:
                _wait(lambda: fleet.standby.warm_count == 1, "the pool's refill",
                      120.0, phase="fleet (c)")
            for j in range(1, 5):
                fleet.submit(sid, tagged(base, j))
            t = time.perf_counter()
            if not fleet.retire_replica(rid):
                raise AssertionError(f"fleet (c): retire of {rid} refused")
            retire_ms = (time.perf_counter() - t) * 1e3
            _wait(lambda: got.extend(fleet.poll(sid)) or len(got) >= 5,
                  "the migrated session's frames", 120.0, phase="fleet (c)")
            _serve_one(fleet, sid, tagged(base, 5), got, "a frame after the retire")
            serve_check(f"fleet (c) {kind}", "sobel_bilateral", base, got, 6,
                        dev, plain_of)
            st = fleet.stats()
            if rid in st["replicas"] or st["sessions"][sid]["migrations"] != 1:
                raise AssertionError(f"fleet (c): {rid} not retired cleanly")
            m_retired = _mem(f"(c) {kind}: after the retire")
            # a killed local replica (abandoned, as on a loss) frees its
            # frontend's device memory too
            h = fleet._make_replica("rk", 9).start()
            h.open_stream("k0", op_chain="sobel_bilateral", frame_shape=FLEET_HD)
            h.submit("k0", tagged(base, 0), tag=(0, None))
            _wait(lambda: h.poll("k0"), "the killed replica's frame", 120.0,
                  phase="fleet (c)")
            m_served = _mem(f"(c) {kind}: a replica outside the fleet served")
            h.kill()
            m_killed = _mem(f"(c) {kind}: after its kill()")
        m_stop = _mem(f"(c) {kind}: after stop()")
        log(f"fleet (c) {kind}: memory_summary after stop() "
            f"{json.dumps(memory_summary())}")
        out[kind] = dict(spawn_ms=spawn_ms, spawn_to_first_frame_ms=first_ms,
                         retire_ms=retire_ms, memory_before_spawn=m0,
                         memory_after_retire=m_retired,
                         memory_kill_served=m_served,
                         memory_after_kill=m_killed, memory_after_stop=m_stop)
        log(f"fleet (c) {kind} spawn: spawn_replica {spawn_ms:.1f} ms, "
            f"spawn-to-first-frame {first_ms:.1f} ms, retire (drain + migrate "
            f"+ stop) {retire_ms:.1f} ms")
        if m_retired != m0 or m_killed != m_retired or m_stop != m_base:
            raise AssertionError(f"fleet (c) {kind}: memory_allocated {m0} "
                                 f"before the spawn, {m_retired} after the "
                                 f"retire, {m_killed} after a kill, {m_stop} "
                                 f"after stop() (before the fleet {m_base})")
    return dict(leg="c_elastic", **out), {}


def fleet_leg_divergence(dev):
    """(d) Three local replicas warm on the 1080p sobel_bilateral
    signature: a divergence check matches with 3 probed (K3 once per
    replica), then one replica's probe is rigged (the reference test's
    rig: the corrupt_device chaos site acts on served batches after the
    fetch and does not reach the probe) and is outvoted, quarantined and
    retired."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend
    from dvf_tpu_torch.ops import kernels as tk

    fleet = FleetFrontend(
        dvf_tpu_torch.get_filter("invert"),
        FleetConfig(replicas=3, mode="local", audit_quarantine=True,
                    serve=_serve_config(),
                    precompile=_manifest(["sobel_bilateral"])),
        device=dev)
    with fleet:
        # the monitor learns each replica's warm signatures from its health
        key = fleet._signature_render("sobel_bilateral", FLEET_HD, "uint8")
        _wait(lambda: sum(key in w for w in list(fleet._warm.values())) == 3,
              "3 replicas warm on the signature", 60.0, phase="fleet (d)")
        m0 = _mem("(d) 3 replicas")
        tk.reset_launches()
        t = time.perf_counter()
        ev = fleet.audit_divergence_check()
        check_ms = (time.perf_counter() - t) * 1e3
        delta = dict(tk.LAUNCHES)
        if ev["verdict"] != "match" or ev["replicas_probed"] != 3:
            raise AssertionError(f"fleet (d): {ev}")
        serve_counted(delta, {"sobel_bilateral": 3}, "fleet (d) probes")
        victim = sorted(fleet._replicas)[-1]
        fleet._replicas[victim].audit_probe = (
            lambda sig=None: {"signature": sig, "digest": "deadbeefdeadbeef"})
        ev2 = fleet.audit_divergence_check()
        st = fleet.stats()["audit"]
        if not (ev2["verdict"] == "mismatch" and ev2["divergent"] == [victim]
                and st["quarantined_total"] == 1
                and victim not in fleet._replicas):
            raise AssertionError(f"fleet (d): {ev2}, {st}")
        m1 = _mem("(d) after the quarantine")
    torch.cuda.empty_cache()
    log(f"fleet (d): check {check_ms:.1f} ms over 3 replicas, launches "
        f"{delta}; {victim} outvoted ({ev2['verdict']}), quarantined and "
        f"retired (rig: the probe's digest replaced); memory_allocated "
        f"{m0} -> {m1} B")
    return dict(leg="d_divergence", check_ms=check_ms, launches=delta,
                divergent=ev2["divergent"], rig="probe digest replaced",
                memory_before=m0, memory_after_quarantine=m1), delta


def fleet_leg_snapshot(dev, plain_of: dict):
    """(e) The snapshot plane: a process fleet with ``state_path`` serves
    a session, crash()es (its worker lives on), and a new front door with
    ``resume_state=True`` adopts the worker; the session delivers again."""
    import dataclasses
    import tempfile

    from dvf_tpu_torch.fleet import FleetFrontend

    base = serve_bases(FLEET_HD, 1, 140)[0]
    with tempfile.TemporaryDirectory() as tmp:
        f1 = _process_fleet(replicas=1, state_path=os.path.join(tmp, "s.json"),
                            snapshot_interval_s=0.05, reattach_grace_s=60.0)
        f2, got = None, []
        try:
            f1.start()
            sid = f1.open_stream()
            g, _, _, _ = fleet_drive(f1, {sid: base}, range(SNAP_FRAMES))
            got += g[sid]
            time.sleep(0.3)   # the snapshot thread sees the traffic
            f1.crash()
            t = time.perf_counter()
            f2 = FleetFrontend(config=dataclasses.replace(f1.config,
                                                          resume_state=True),
                               device=f1.device)
            f2.start()
            adopt_ms = (time.perf_counter() - t) * 1e3
            if (f2.continuity.get("adopted_replicas") != 1
                    or f2.continuity.get("adopted_sessions") != 1):
                raise AssertionError(f"fleet (e): {f2.stats()['continuity']}")
            g, _, _, _ = fleet_drive(f2, {sid: base},
                                     range(SNAP_FRAMES, SNAP_FRAMES + 2))
            got += g[sid]
        finally:
            (f2 if f2 is not None else f1).stop()
    serve_check("fleet (e) adopted session", "sobel_bilateral", base, got,
                SNAP_FRAMES + 2, dev, plain_of)
    log(f"fleet (e): crash, then a resume_state front door adopted the live "
        f"worker and its session in {adopt_ms:.1f} ms; "
        f"{len(got)} frames in order")
    return dict(leg="e_snapshot", adopt_ms=adopt_ms, frames=len(got)), {}


def fleet_phase(dev, plain_of: dict):
    """Phase 11: legs (a)-(e) of the fleet tier. Returns (rows, the summed
    launch counts of the in-process legs' counted runs; the process
    replicas' launches happen in their own processes)."""
    import torch

    from dvf_tpu_torch.fleet.elastic import live_standby_handles
    from dvf_tpu_torch.fleet.replica import live_worker_processes
    from dvf_tpu_torch.runtime.engine import live_pool_engines

    os.environ.setdefault("DVF_FLEET_WORKER_STDERR", "1")
    t0 = time.perf_counter()
    rows, total = [], {}
    log(f"fleet phase on {nvidia_smi()}")
    for leg in (lambda: fleet_leg_local(dev, plain_of),
                lambda: fleet_leg_process(dev, plain_of),
                lambda: fleet_leg_elastic(dev, plain_of),
                lambda: fleet_leg_divergence(dev),
                lambda: fleet_leg_snapshot(dev, plain_of)):
        t = time.perf_counter()
        row, delta = leg()
        row["wall_s"] = time.perf_counter() - t
        rows.append(row)
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
        log(f"fleet leg {row['leg']}: {row['wall_s']:.1f} s")
    if live_pool_engines() or live_worker_processes() or live_standby_handles():
        raise AssertionError("fleet: engines, workers or standbys outlived "
                             "their fleets")
    torch.cuda.empty_cache()
    log(f"fleet phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total


def fleet_only() -> None:
    """The build and phase 11 alone (the fleet tier):
    ``python3 -c 'import chip_smoke; chip_smoke.fleet_only()'``."""
    dev, plain_of, _ = _only_setup()
    rows, _ = fleet_phase(dev, plain_of)
    print(json.dumps({"fleet": rows}))


# ---------------------------------------------------------------------------
# Phase 12: the command line (python -m dvf_tpu_torch)
# ---------------------------------------------------------------------------

CLI_HD = ("--height", str(MAIN_SHAPE[1]), "--width", str(MAIN_SHAPE[2]))
CLI_FRAMES = 160                 # leg (a): frames per 1080p batch-16 serve
CLI_SESSION_FRAMES = 32          # leg (b): frames per session
CLI_SHM_FRAMES = 64              # leg (c): frames the camera pushes
CLI_WORKER_FRAMES = 64           # leg (d): 512 x 512 raw frames, batch 8
CLI_FLEET_FRAMES = 32            # leg (e): frames per session
CLI_TRACE_FRAMES = 64            # leg (h): the traced 1080p serve
CLI_BLUR = ("--filter", "gaussian_blur", "--filter-config", '{"ksize": 9}')
# serve --sessions N: the per-session keys of the JAX package's line
# (dvf_tpu/cli.py:515)
CLI_SESSION_KEYS = {"submitted", "delivered", "shed", "slo_miss", "fps",
                    "p50_ms", "p99_ms"}

# A CLI process with its start-up taken apart: torch import, (serve) the
# CUDA context and the kernel libraries loaded from the build cache, the
# CLI imported (ready_s), then the first frame the sink (serve) or the
# ring (camera) sees. Prints
# "[ready]" before the CLI starts and one "[timing] {...}" line at exit,
# both on stderr; argv: role, kernel libraries, then the CLI's own argv.
_TIMED_CLI = r"""
import json, os, sys, time
t0 = time.time()
sys.path.insert(0, os.getcwd())
import torch
marks = {"start": t0, "torch_import_s": time.time() - t0}
role, libs, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
if role == "serve":
    t = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda_context_s"] = time.time() - t
    from dvf_tpu_torch.ops import _build
    t = time.time()
    for name in libs.split(","):
        _build.load(name)
    marks["kernel_load_s"] = time.time() - t
    import dvf_tpu_torch.io.sinks as hook
    cls, meth = hook.NullSink, "emit"
else:
    import dvf_tpu_torch.transport.ring as hook
    cls, meth = hook.FrameRing, "push"
real = getattr(cls, meth)
def first(self, *a, **k):
    marks.setdefault("first_frame", time.time())
    return real(self, *a, **k)
setattr(cls, meth, first)
from dvf_tpu_torch.cli import main
marks["ready_s"] = time.time() - t0
print("[ready]", file=sys.stderr, flush=True)
rc = main(argv)
print("[timing] " + json.dumps(marks), file=sys.stderr, flush=True)
sys.exit(rc)
"""


def _cli(argv, cwd=None):
    """``dvf_tpu_torch.cli.main(argv)`` in this process (so its launches
    are counted here). Returns (rc, stdout, stderr)."""
    import io

    from dvf_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    if cwd is not None:
        os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(list(argv))
    finally:
        os.chdir(here)
    return rc, out.getvalue(), err.getvalue()


def _cli_json(label: str, argv, cwd=None) -> dict:
    rc, out, err = _cli(argv, cwd)
    if rc != 0:
        raise AssertionError(f"cli ({label}): rc {rc}; stderr tail:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


class _EngineLedger:
    """While active: every Engine built, and the launches made inside
    Engine.compile (its warm-up and calibration steps) counted apart, on
    the thread that compiles, so the launches of the serving batches can
    be told from the compiles' even when compiles overlap serving."""

    def __init__(self):
        self.engines, self.compile = [], {}

    def __enter__(self):
        import threading

        from dvf_tpu_torch.ops import kernels as tk
        from dvf_tpu_torch.runtime import engine as em

        self._saved = (em.Engine.__init__, em.Engine.compile, tk._count)
        real_init, real_compile, real_count = self._saved
        lock, here, ledger = threading.Lock(), threading.local(), self

        def init(eng, *a, **k):
            real_init(eng, *a, **k)
            with lock:
                ledger.engines.append(eng)

        def compile_(eng, *a, **k):
            here.depth = getattr(here, "depth", 0) + 1
            try:
                return real_compile(eng, *a, **k)
            finally:
                here.depth -= 1

        def count(lib, fn, counter, rc):
            real_count(lib, fn, counter, rc)   # raises on a refused launch
            if getattr(here, "depth", 0):
                with lock:
                    ledger.compile[counter] = ledger.compile.get(counter, 0) + 1

        em.Engine.__init__, em.Engine.compile, tk._count = init, compile_, count
        return self

    def __exit__(self, *exc):
        from dvf_tpu_torch.ops import kernels as tk
        from dvf_tpu_torch.runtime import engine as em

        em.Engine.__init__, em.Engine.compile, tk._count = self._saved
        return False

    def batches(self) -> int:
        """Device batches of every engine built (each leg serves one
        filter)."""
        return sum(e.stats.batches for e in self.engines)


def _cli_counted(label: str, delta: dict, ledger: "_EngineLedger", counter: str,
                 batches_json=None) -> dict:
    """The serving launches (all launches less the compiles') of
    ``counter``: once per device batch of the engines built in the run;
    no other kernel launched at all."""
    serving = delta[counter] - ledger.compile.get(counter, 0)
    batches = ledger.batches()
    others = {k: v for k, v in delta.items() if k != counter and v}
    if serving != batches or others or not serving:
        raise AssertionError(
            f"cli ({label}): {counter} launched {delta[counter]} times, "
            f"{ledger.compile.get(counter, 0)} in compiles, {serving} serving "
            f"for {batches} batches; other kernels {others}")
    if batches_json is not None and batches_json != batches:
        raise AssertionError(f"cli ({label}): the JSON line says {batches_json} "
                             f"engine batches, the engines {batches}")
    return dict(launches=delta[counter], compile_launches=ledger.compile.get(counter, 0),
                serving_launches=serving, batches=batches)


def _synthetic_plain(dev, plain, h: int, w: int, n: int, seed: int) -> list:
    """The plain version on the card of a SyntheticSource's distinct
    frames (its cycle of min(16, n)): uint8 host frames, frame i of the
    stream being entry i % len."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        h, w, n_frames=min(16, n), seed=seed)][:-1]
    out = []
    for f in frames:
        x = torch.from_numpy(np.array(f)[None]).to(dev)
        out.append(to_uint8(plain(to_float(x))).cpu().numpy()[0].astype(np.int16))
    return out


def cli_leg_serve(dev, plain_of: dict, name: str, counter: str, fps_of: dict):
    """(a) ``serve`` at 1080p batch 16, 160 frames, through main(): every
    frame delivered, the kernel launched once per device batch and no
    other; again with --display --headless, the frames the sink composes
    read in order and each within 1 LSB of the plain version."""
    from dvf_tpu_torch.io import display
    from dvf_tpu_torch.ops import kernels as tk

    flt = CLI_BLUR if name == "gaussian_blur" else ("--filter", name)
    argv = ["serve", *flt, *CLI_HD, "--batch", str(MAIN_SHAPE[0]), "--frames",
            str(CLI_FRAMES), "--frame-delay", "0", "--queue-size",
            str(CLI_FRAMES + 1), "--quiet"]
    label = f"a {name}"
    with _EngineLedger() as ledger:
        tk.reset_launches()
        stats = _cli_json(label, argv)
        delta = dict(tk.LAUNCHES)
    if stats["delivered"] != CLI_FRAMES or stats["dropped_at_ingest"]:
        raise AssertionError(f"cli ({label}): delivered {stats['delivered']} of "
                             f"{CLI_FRAMES}, dropped {stats['dropped_at_ingest']}")
    counts = _cli_counted(label, delta, ledger, counter, stats["engine_batches"])
    plain = _synthetic_plain(dev, plain_of[counter], *MAIN_SHAPE[1:3], CLI_FRAMES, 0)
    order, worst = [], [0]
    real = display.SideBySideSink.emit

    def emit(sink, index, processed, capture_ts):
        order.append(index)
        d = np.abs(processed.astype(np.int16) - plain[index % len(plain)])
        worst[0] = max(worst[0], int(d.max()))
        return real(sink, index, processed, capture_ts)

    display.SideBySideSink.emit = emit
    try:
        with _EngineLedger() as ledger2:
            tk.reset_launches()
            shown = _cli_json(label + " display", argv + ["--display", "--headless"])
            delta2 = dict(tk.LAUNCHES)
    finally:
        display.SideBySideSink.emit = real
    counts2 = _cli_counted(label + " display", delta2, ledger2, counter,
                           shown["engine_batches"])
    if order != list(range(CLI_FRAMES)) or worst[0] > 1:
        raise AssertionError(f"cli ({label} display): {len(order)} frames, in order "
                             f"{order == sorted(order)}, max {worst[0]} LSB vs plain")
    ref = fps_of.get(name)
    log(f"cli (a) serve {name} {MAIN_SHAPE}: {stats['delivered']} frames, "
        f"{counts['batches']} batches, {stats['fps']:.1f} fps (phase 5 Pipeline "
        f"leg: {ref if ref is None else round(ref, 1)} fps), p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms, launches "
        f"{counts}; --display --headless: {len(order)} frames in order, max "
        f"{worst[0]} LSB vs plain, {shown['fps']:.1f} fps with the sink's "
        f"per-frame check")
    total = {k: delta[k] + delta2[k] for k in delta}
    return dict(leg=f"a_serve_{name}", filter=name, frames=CLI_FRAMES,
                fps=stats["fps"], p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
                pipeline_fps_phase5=ref, display_checked_fps=shown["fps"],
                max_lsb_vs_plain=worst[0], **counts), total


def cli_leg_sessions(dev, plain_of: dict):
    """(b) ``serve --sessions 4`` at 1080p, gaussian_blur(ksize=9): each
    session's deliveries (read through the frontend's poll) complete, in
    order and within 1 LSB of the plain version of its own synthetic
    stream; K1 once per device batch; the per-session keys the JAX
    package's line carries."""
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.serve import server

    n, frames = 4, CLI_SESSION_FRAMES
    plains = [_synthetic_plain(dev, plain_of["sep_blur"], *MAIN_SHAPE[1:3], frames, i)
              for i in range(n)]
    seen, worst = {}, [0]
    real = server.ServeFrontend.poll

    def poll(fe, sid, *a, **k):
        got = real(fe, sid, *a, **k)
        plain = plains[int(sid[1:])]   # session i is "s<i>", fed seed i
        for d in got:
            seen.setdefault(sid, []).append(d.index)
            diff = np.abs(d.frame.astype(np.int16) - plain[d.index % len(plain)])
            worst[0] = max(worst[0], int(diff.max()))
        return got

    argv = ["serve", "--sessions", str(n), *CLI_BLUR, *CLI_HD, "--batch",
            str(MAIN_SHAPE[0]), "--frames", str(frames), "--rate", "120",
            "--queue-size", "64", "--slo-ms", "60000", "--quiet"]
    server.ServeFrontend.poll = poll
    try:
        with _EngineLedger() as ledger:
            tk.reset_launches()
            out = _cli_json("b", argv)
            delta = dict(tk.LAUNCHES)
    finally:
        server.ServeFrontend.poll = real
    counts = _cli_counted("b", delta, ledger, "sep_blur", out["engine_batches"])
    for sid, row in out["sessions"].items():
        if set(row) != CLI_SESSION_KEYS:
            raise AssertionError(f"cli (b): session keys {sorted(row)}")
        if seen.get(sid) != list(range(frames)) or out["polled"][sid] != frames:
            raise AssertionError(f"cli (b): {sid} delivered {seen.get(sid)}")
    if len(out["sessions"]) != n or worst[0] > 1 or out["shed_total"]:
        raise AssertionError(f"cli (b): {len(out['sessions'])} sessions, max "
                             f"{worst[0]} LSB, shed {out['shed_total']}")
    log(f"cli (b) serve --sessions {n} gaussian_blur(ksize=9) {MAIN_SHAPE[1:]}: "
        f"{n} x {frames} frames in order, max {worst[0]} LSB vs plain, aggregate "
        f"{out['aggregate']['fps']:.1f} fps, p50 {out['aggregate']['p50_ms']:.1f} ms, "
        f"p99 {out['aggregate']['p99_ms']:.1f} ms, launches {counts}")
    return dict(leg="b_sessions", sessions=n, frames=frames,
                aggregate=out["aggregate"], max_lsb_vs_plain=worst[0], **counts), delta


def _spawn_timed(role: str, libs: str, argv, env):
    import subprocess

    t = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-c", _TIMED_CLI, role, libs, *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, t


def _timing(label: str, err: str, spawned: float) -> dict:
    lines = [ln for ln in err.splitlines() if ln.startswith("[timing] ")]
    if not lines:
        raise AssertionError(f"cli ({label}): no timing line; stderr:\n{err[-3000:]}")
    marks = json.loads(lines[-1][len("[timing] "):])
    if "first_frame" not in marks:
        raise AssertionError(f"cli ({label}): no frame reached the {label}")
    row = {k: v for k, v in marks.items() if k.endswith("_s")}
    row["start_to_first_frame_s"] = marks["first_frame"] - marks["start"]
    row["spawn_to_first_frame_s"] = marks["first_frame"] - spawned
    return row


def _shm_frames(frame_bytes: int) -> int:
    """Ring capacity in frames that /dev/shm holds with room to spare."""
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    return max(0, min(16, int(free * 0.8) // (frame_bytes + 64) - 1)), free


def cli_leg_shm(dev):
    """(c) ``camera --shm NAME`` → ``serve --source shm:NAME --transport
    ring``: two processes at 1080p, sobel_bilateral. The consumer is
    started first (it waits for the ring) and delivers every frame the
    producer pushed less the ring's and its ingest's drops; each
    process's start-up and first frame timed."""
    import uuid

    frame_bytes = int(np.prod(MAIN_SHAPE[1:]))
    cap, free = _shm_frames(frame_bytes)
    if cap < 2:
        raise AssertionError(f"cli (c): /dev/shm has {free} bytes free, not two "
                             f"1080p frames")
    name = f"/dvf_chip_{uuid.uuid4().hex[:8]}"
    env = dict(os.environ)
    consumer, t_c = _spawn_timed("serve", "stencils", [
        "serve", "--source", f"shm:{name}", "--filter", "sobel_bilateral", *CLI_HD,
        "--batch", str(MAIN_SHAPE[0]), "--frame-delay", "0", "--queue-size", "64",
        "--transport", "ring", "--quiet"], env)
    producer = None
    try:
        ready = consumer.stderr.readline()
        if "[ready]" not in ready:
            raise AssertionError(f"cli (c): the consumer did not start: {ready}"
                                 f"{consumer.stderr.read()[-3000:]}")
        producer, t_p = _spawn_timed("camera", "", [
            "camera", "--shm", name, "--source", "synthetic", *CLI_HD,
            "--frames", str(CLI_SHM_FRAMES), "--rate", "30",
            "--queue-size", str(cap)], env)
        pout, perr = producer.communicate(timeout=180)
        cout, cerr = consumer.communicate(timeout=180)
    finally:
        for proc in (producer, consumer):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
        try:
            os.unlink(f"/dev/shm{name}")
        except OSError:
            pass
    if producer.returncode != 0 or consumer.returncode != 0:
        raise AssertionError(f"cli (c): camera rc {producer.returncode}, serve rc "
                             f"{consumer.returncode}:\n{perr[-2000:]}\n{cerr[-3000:]}")
    p, c = json.loads(pout.strip().splitlines()[-1]), json.loads(cout.strip().splitlines()[-1])
    want = p["pushed"] - p["dropped"] - c["dropped_at_ingest"]
    if (p["pushed"] != CLI_SHM_FRAMES or c["delivered"] != want
            or c["completed_total"] != c["delivered"] or c["errors"]):
        raise AssertionError(f"cli (c): camera {p}, serve delivered "
                             f"{c['delivered']} (want {want}), {c}")
    tc, tp = _timing("serve", cerr, t_c), _timing("camera", perr, t_p)
    log(f"cli (c) camera -> serve over shm ({cap}-frame ring, /dev/shm {free} bytes "
        f"free), sobel_bilateral {MAIN_SHAPE[1:]}: pushed {p['pushed']}, ring drops "
        f"{p['dropped']}, ingest drops {c['dropped_at_ingest']}, delivered "
        f"{c['delivered']} at {c['fps']:.1f} fps; serve start-up {json.dumps(tc)}; "
        f"camera start-up {json.dumps(tp)}")
    return dict(leg="c_shm", ring_frames=cap, pushed=p["pushed"],
                ring_dropped=p["dropped"], ingest_dropped=c["dropped_at_ingest"],
                delivered=c["delivered"], fps=c["fps"], serve_timing=tc,
                camera_timing=tp), {}


def cli_leg_worker(dev, plain_of: dict):
    """(d) ``python -m dvf_tpu_torch worker --filter gaussian_blur
    --no-jpeg`` (the raw wire: the card machine has no libjpeg) against a
    small app speaking the reference's socket pair (a ROUTER handing one
    frame per READY, a PULL collecting): every frame back, within 1 LSB of
    the plain version; SIGTERM gives the stats line and rc 0."""
    import signal
    import subprocess

    import zmq

    import dvf_tpu_torch

    size, n = WIRE_SIZE, CLI_WORKER_FRAMES
    frames = [np.ascontiguousarray(f) for f, _ in dvf_tpu_torch.SyntheticSource(
        size, size, n_frames=n, seed=0)][:-1]
    plain = _synthetic_plain(dev, plain_of["sep_blur"], size, size, n, 0)
    ctx = zmq.Context()
    router, pull = ctx.socket(zmq.ROUTER), ctx.socket(zmq.PULL)
    p_dist = router.bind_to_random_port("tcp://127.0.0.1")
    p_coll = pull.bind_to_random_port("tcp://127.0.0.1")
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dvf_tpu_torch", "worker", *CLI_BLUR, "--no-jpeg",
         "--host", "127.0.0.1", "--distribute-port", str(p_dist),
         "--collect-port", str(p_coll), "--batch", str(WIRE_BATCH),
         "--target-size", str(size)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    results, first = {}, None
    try:
        todo = list(range(n))
        deadline = time.time() + 180
        while len(results) < n:
            if time.time() > deadline or proc.poll() is not None:
                raise AssertionError(f"cli (d): {len(results)} of {n} frames back, "
                                     f"worker rc {proc.poll()}")
            if router.poll(5):
                client = router.recv_multipart()[0]
                if todo:
                    i = todo.pop(0)
                    router.send_multipart([client, str(i).encode(), frames[i].tobytes()])
            if pull.poll(5):
                idx, *_mid, payload = pull.recv_multipart()
                first = first or time.time()
                results[int(idx.decode())] = payload
        wall = time.time() - first
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        router.close(0)
        pull.close(0)
        ctx.term()
    worst = max(int(np.abs(np.frombuffer(results[i], np.uint8).reshape(size, size, 3)
                           .astype(np.int16) - plain[i % len(plain)]).max())
                for i in range(n))
    lines = [ln for ln in out.splitlines() if ln.strip()]
    stats = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or "draining" not in err or stats.get("frames_processed") != n \
            or stats.get("errors") or worst > 1:
        raise AssertionError(f"cli (d): rc {proc.returncode}, max {worst} LSB, "
                             f"stats {str(stats)[:400]}; stderr:\n{err[-3000:]}")
    log(f"cli (d) worker gaussian_blur(ksize=9) raw wire {size}x{size} batch "
        f"{WIRE_BATCH}: {n} frames back, max {worst} LSB vs plain, "
        f"{n / max(wall, 1e-9):.1f} fps after the first result, spawn to first "
        f"result {first - t0:.2f} s; SIGTERM: rc 0, frames_processed "
        f"{stats['frames_processed']}, batches {stats.get('batches')}")
    return dict(leg="d_worker", frames=n, max_lsb_vs_plain=worst,
                spawn_to_first_result_s=first - t0, fps=n / max(wall, 1e-9),
                batches=stats.get("batches")), {}


def cli_leg_fleet(dev):
    """(e) ``fleet --mode local --replicas 2 --sessions 4 --filter
    sobel_bilateral`` at 1080p batch 16 through main(): both replicas
    used, every frame polled, no order violation, no replica lost, K3
    once per device batch of the replicas' engines."""
    from dvf_tpu_torch.ops import kernels as tk

    argv = ["fleet", "--mode", "local", "--replicas", "2", "--sessions", "4",
            "--filter", "sobel_bilateral", *CLI_HD, "--batch", str(MAIN_SHAPE[0]),
            "--frames", str(CLI_FLEET_FRAMES), "--rate", "120", "--queue-size",
            "64", "--slo-ms", "60000"]
    with _EngineLedger() as ledger:
        tk.reset_launches()
        out = _cli_json("e", argv)
        delta = dict(tk.LAUNCHES)
    counts = _cli_counted("e", delta, ledger, "sobel_bilateral")
    replicas = {s["replica"] for s in out["sessions"].values()}
    if (replicas != {"r0", "r1"} or out["order_violations"] or out["replica_losses"]
            or any(v != CLI_FLEET_FRAMES for v in out["polled"].values())):
        raise AssertionError(f"cli (e): replicas {replicas}, polled {out['polled']}, "
                             f"order violations {out['order_violations']}, losses "
                             f"{out['replica_losses']}")
    log(f"cli (e) fleet --mode local --replicas 2, 4 sessions of sobel_bilateral "
        f"{MAIN_SHAPE[1:]}: placed on {sorted(replicas)}, every frame polled, "
        f"aggregate {out['aggregate']['fps']:.1f} fps, p50 "
        f"{out['aggregate']['p50_ms']:.1f} ms, launches {counts}")
    return dict(leg="e_fleet", replicas=sorted(replicas), aggregate=out["aggregate"],
                **counts), delta


def cli_leg_doctor(kind: str):
    """(f) ``doctor`` and ``filters`` as processes: the backend CUDA with
    one card, of this card's kind (an H100), the ring shim built; the
    filters those of dvf_tpu_torch.list_filters()."""
    import subprocess

    import dvf_tpu_torch

    root = os.path.dirname(os.path.abspath(__file__))
    t = time.time()
    r = subprocess.run([sys.executable, "-m", "dvf_tpu_torch", "doctor"], cwd=root,
                       capture_output=True, text=True, timeout=300)
    doc_s = time.time() - t
    doc = json.loads(r.stdout)
    be = doc.get("backend", {})
    if (r.returncode != 0 or be.get("platform") != "cuda" or be.get("n_devices") != 1
            or be.get("kinds") != [kind] or "H100" not in kind
            or doc.get("ring_shim") != "ok" or "data" not in doc.get("mesh_suggestions", {})):
        raise AssertionError(f"cli (f): doctor rc {r.returncode}: {r.stdout[-2000:]}"
                             f"{r.stderr[-2000:]}")
    f = subprocess.run([sys.executable, "-m", "dvf_tpu_torch", "filters"], cwd=root,
                       capture_output=True, text=True, timeout=300)
    if f.returncode != 0 or f.stdout.split() != dvf_tpu_torch.list_filters():
        raise AssertionError(f"cli (f): filters rc {f.returncode}: {f.stdout[:500]}")
    log(f"cli (f) doctor ({doc_s:.1f} s): backend {json.dumps(be)}, ring_shim "
        f"{doc['ring_shim']}, jpeg_shim {doc['jpeg_shim']!r}, compile_cache "
        f"{json.dumps(doc['compile_cache'])}; filters: {len(f.stdout.split())} names, "
        f"equal to list_filters()")
    return dict(leg="f_doctor", backend=be, ring_shim=doc["ring_shim"],
                jpeg_shim=doc["jpeg_shim"], doctor_s=doc_s), {}


def _dir_state(path: str) -> dict:
    if not os.path.isdir(path):
        return {}
    return {n: os.stat(os.path.join(path, n)).st_mtime_ns for n in os.listdir(path)}


def cli_leg_cache(tmp: str):
    """(g) ``serve --compile-cache-dir DIR`` in two processes on one fresh
    directory: the first builds every kernel library there (its build
    seconds printed), the second loads them with 0.0 s of build;
    the default dvf_tpu_torch/_build/ is written by neither."""
    import subprocess

    from dvf_tpu_torch.runtime.engine import DEFAULT_COMPILE_CACHE_DIR

    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(tmp, "kernel-cache")
    before = _dir_state(DEFAULT_COMPILE_CACHE_DIR)
    builds, walls = [], []
    for _ in range(2):
        t = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "dvf_tpu_torch", "serve", "--filter",
             "sobel_bilateral", "--height", "64", "--width", "64", "--frames", "16",
             "--batch", "4", "--frame-delay", "0", "--queue-size", "17", "--quiet",
             "--compile-cache-dir", cache],
            cwd=root, capture_output=True, text=True, timeout=600)
        walls.append(time.time() - t)
        line = [ln for ln in r.stderr.splitlines() if "kernel builds (s): " in ln]
        if r.returncode != 0 or not line:
            raise AssertionError(f"cli (g): rc {r.returncode}: {r.stderr[-3000:]}")
        builds.append(json.loads(line[-1].split("kernel builds (s): ", 1)[1]))
    names = {"stencils", "warp", "codec", "norm", "outconv"}
    libs = sorted(n for n in os.listdir(cache) if n.endswith(".so"))
    if (set(builds[0]) != names or not all(v > 0 for v in builds[0].values())
            or builds[1] != {n: 0.0 for n in names}
            or not {n.split("-")[0][3:] for n in libs} >= names):
        raise AssertionError(f"cli (g): builds {builds}, libraries {libs}")
    if _dir_state(DEFAULT_COMPILE_CACHE_DIR) != before:
        raise AssertionError("cli (g): the default build directory was written")
    log(f"cli (g) --compile-cache-dir (fresh dir): first process built {builds[0]} "
        f"s ({walls[0]:.1f} s wall), second {builds[1]} ({walls[1]:.1f} s wall); "
        f"libraries {libs}; the default build directory untouched")
    return dict(leg="g_cache", first_build_s=builds[0], second_build_s=builds[1],
                walls_s=walls), {}


def cli_leg_trace(tmp: str):
    """(h) A traced (a) run (--trace --device-trace DIR, 1080p batch 16,
    sobel_bilateral) and ``trace-view`` over its host trace and its
    merged host + device trace: rc 0, the text naming host and device
    lanes. K3 once per device batch."""
    from dvf_tpu_torch.ops import kernels as tk

    d = os.path.join(tmp, "cli-trace")
    os.makedirs(d, exist_ok=True)
    argv = ["serve", "--filter", "sobel_bilateral", *CLI_HD, "--batch",
            str(MAIN_SHAPE[0]), "--frames", str(CLI_TRACE_FRAMES), "--frame-delay",
            "0", "--queue-size", str(CLI_TRACE_FRAMES + 1), "--quiet", "--trace",
            "--device-trace", os.path.join(d, "device")]
    with _EngineLedger() as ledger:
        tk.reset_launches()
        stats = _cli_json("h", argv, cwd=d)
        delta = dict(tk.LAUNCHES)
    counts = _cli_counted("h", delta, ledger, "sobel_bilateral",
                          stats["engine_batches"])
    host = os.path.join(d, "dvf_frame_timing.pftrace")
    merged = os.path.join(d, "device", "dvf_merged_timing.pftrace")
    texts = {}
    for label, path in (("host", host), ("merged", merged)):
        rc, out, err = _cli(["trace-view", path])
        if rc != 0:
            raise AssertionError(f"cli (h): trace-view {label} rc {rc}: {err[-2000:]}")
        texts[label] = out
    from dvf_tpu_torch.obs.viewer import summarize

    lanes = [row["lane"] for row in summarize(merged)["lanes"]]
    dev_lanes = [ln for ln in lanes if ln.startswith("device")]
    host_lanes = [ln for ln in lanes if not ln.startswith("device") and not ln.isdigit()]
    if not dev_lanes or not host_lanes or not all(
            ln in texts["merged"] for ln in dev_lanes[:1] + host_lanes[:1]):
        raise AssertionError(f"cli (h): lanes {lanes}; text:\n{texts['merged'][:2000]}")
    log(f"cli (h) traced serve sobel_bilateral: {stats['delivered']} frames, "
        f"{stats['fps']:.1f} fps, launches {counts}; trace-view: host lanes "
        f"{host_lanes[:4]}, device lanes {dev_lanes[:4]} ({len(lanes)} lanes)")
    for line in texts["merged"].splitlines()[:12]:
        log(f"  trace-view: {line}")
    return dict(leg="h_trace", fps=stats["fps"], lanes=lanes, **counts), delta


def cli_leg_host(tmp: str):
    """(i) The host-only legs, where the machine allows them: ``serve
    --source <file>`` on a short video that cv2 writes, and
    ``--display-backend gl``. Each library is probed first; a missing one
    skips its leg with a printed line, a leg that runs and fails fails."""
    rows = {}
    try:
        import cv2
    except ImportError as e:
        log(f"cli (i) video file: skipped, cv2 is not importable here ({e})")
        cv2 = None
    if cv2 is not None:
        path = os.path.join(tmp, "clip.avi")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (320, 240))
        if not wr.isOpened():
            log(f"cli (i) video file: skipped, cv2 {cv2.__version__} cannot write MJPG")
        else:
            for i in range(24):
                frame = np.full((240, 320, 3), i * 8, np.uint8)
                frame[:, : i * 10, 0] = 255
                wr.write(frame)
            wr.release()
            stats = _cli_json("i file", ["serve", "--filter", "invert", "--source", path,
                                         "--target-size", "128", "--batch", "4",
                                         "--frame-delay", "0", "--queue-size", "64",
                                         "--quiet", "--transport", "ring"])
            if stats["delivered"] != 24:
                raise AssertionError(f"cli (i): the file served {stats['delivered']} of 24")
            rows["file"] = stats["delivered"]
            log(f"cli (i) video file (cv2 {cv2.__version__}): 24 frames decoded, cropped "
                f"to 128x128, served over the ring: delivered {stats['delivered']}")
    try:
        from dvf_tpu_torch.io.gl_display import GLRenderer, GLUnavailable

        GLRenderer(8, 8).close()
        gl = True
    except GLUnavailable as e:
        log(f"cli (i) --display-backend gl: skipped, no surfaceless EGL/GL here ({e})")
        gl = False
    if gl:
        stats = _cli_json("i gl", ["serve", "--filter", "invert", "--height", "96",
                                   "--width", "128", "--frames", "16", "--batch", "4",
                                   "--frame-delay", "2", "--queue-size", "64", "--quiet",
                                   "--display", "--display-backend", "gl", "--headless"])
        if stats["delivered"] != 16:
            raise AssertionError(f"cli (i): the GL sink saw {stats['delivered']} of 16")
        rows["gl"] = stats["delivered"]
        log(f"cli (i) --display-backend gl --headless: delivered {stats['delivered']}")
    return dict(leg="i_host", **rows), {}


def cli_phase(dev, plain_of: dict, fps_of: dict, kind: str):
    """Phase 12: legs (a)-(i) of the command line. Returns (rows, the
    summed launch counts of the in-process legs' runs; the subprocess
    legs' launches happen in their own processes)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    rows, total = [], {}
    log(f"cli phase on {nvidia_smi()}")
    with tempfile.TemporaryDirectory(prefix="dvf-cli-") as tmp:
        for leg in (lambda: cli_leg_serve(dev, plain_of, "sobel_bilateral",
                                          "sobel_bilateral", fps_of),
                    lambda: cli_leg_serve(dev, plain_of, "gaussian_blur", "sep_blur",
                                          fps_of),
                    lambda: cli_leg_sessions(dev, plain_of),
                    lambda: cli_leg_shm(dev),
                    lambda: cli_leg_worker(dev, plain_of),
                    lambda: cli_leg_fleet(dev),
                    lambda: cli_leg_doctor(kind),
                    lambda: cli_leg_cache(tmp),
                    lambda: cli_leg_trace(tmp),
                    lambda: cli_leg_host(tmp)):
            t = time.perf_counter()
            row, delta = leg()
            row["wall_s"] = time.perf_counter() - t
            rows.append(row)
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
            log(f"cli leg {row['leg']}: {row['wall_s']:.1f} s")
            torch.cuda.empty_cache()
    from dvf_tpu_torch.runtime.engine import live_pool_engines

    if live_pool_engines():
        raise AssertionError("cli: pool engines outlived their frontends")
    log(f"cli phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total


def cli_only() -> None:
    """The build and phase 12 alone (the command line):
    ``python3 -c 'import chip_smoke; chip_smoke.cli_only()'``."""
    import torch

    dev, plain_of, _ = _only_setup()
    rows, _ = cli_phase(dev, plain_of, {}, torch.cuda.get_device_name(0))
    print(json.dumps({"cli": rows}))


# ---------------------------------------------------------------------------
# Phase 13: training (the style net's perceptual-loss step with its VGG
# encoder, the ESPCN step, checkpoint and resume, train / train-sr)
# ---------------------------------------------------------------------------

TRAIN_STYLE_SHAPE = (8, 256, 256, 3)   # the committed style_stripes_256's geometry
TRAIN_SR_SHAPE = (16, 128, 128, 3)     # HR frames: the committed sr2x_128's geometry
TRAIN_STEPS = 30
TRAIN_TIMED_FROM = 5                   # step ms: the median over steps 5..30
TRAIN_PROFILED = 5                     # steps in the profiler window
TRAIN_CHECK_SHAPE = (2, 64, 64, 3)     # (b): one float32 step, card vs CPU
TRAIN_SERVE_SHAPE = (8, 720, 1280, 3)  # (d): the trained weights served


def vgg_macs_per_pixel(blocks=((1, 32), (1, 64), (2, 128))) -> int:
    """Multiply-adds of the VGG encoder per full-resolution pixel: 3x3 SAME
    convs, block b at 1/4^b of the pixels. 19,296 at the default blocks."""
    total, cin = 0, 3
    for bi, (n, c) in enumerate(blocks):
        for _ in range(n):
            total += 9 * cin * c // 4 ** bi
            cin = c
    return total


def style_train_macs_per_pixel(c: int = 32, r: int = 5,
                               blocks=((1, 32), (1, 64), (2, 128))) -> dict:
    """Multiply-adds of one style train step per full-resolution pixel, by
    dtype. bf16: the net forward, its weight gradient and its data
    gradient (less the stem's, which the input does not need), the VGG
    over the output forward and data gradient (frozen: no weight
    gradient), the VGG over the content batch forward. float32: the Gram
    matrices of the output's features, forward and backward (HW·C² each
    per block)."""
    net, vgg = _cost().style_macs_per_pixel(c, r), vgg_macs_per_pixel(blocks)
    grams = sum(ch * ch // 4 ** bi for bi, (_, ch) in enumerate(blocks))
    return {"bf16": 3 * net - 81 * 3 * c + 3 * vgg, "f32": 2 * grams,
            "every_data_grad_no_grams": 3 * net + 3 * vgg}


def sr_train_macs_per_lr_pixel(c1: int = 64, c2: int = 32, scale: int = 2) -> int:
    """Multiply-adds of one ESPCN train step per low-resolution pixel:
    forward, weight gradient and data gradient, less the first conv's data
    gradient (the input needs none)."""
    return 3 * _cost().espcn_macs_per_pixel(c1, c2, scale) - 25 * 3 * c1


def _n_params(params) -> int:
    from dvf_tpu_torch.train import optim

    return sum(t.numel() for t in optim.flatten(params).values())


def train_bound(macs: dict, pixels: int, in_bytes: int, n_params: int):
    """(bound ms, bound_by, the parts): operations at their dtype's peak
    (bf16 tensor cores, float32 CUDA cores) against the bytes a step must
    move — the batch read once and, per parameter, the param read and
    written, its gradient read, both Adam moments read and written (7
    float32 words)."""
    t_bf16 = 2 * macs["bf16"] * pixels / _cost().PEAK_BF16_S * 1e3
    t_f32 = 2 * macs.get("f32", 0) * pixels / _cost().PEAK_F32_S * 1e3
    t_bytes = (in_bytes + 7 * 4 * n_params) / _cost().PEAK_BYTES_S * 1e3
    parts = {"bf16_ms": t_bf16, "f32_ms": t_f32, "bytes_ms": t_bytes}
    b_ms = max(parts.values())
    return b_ms, "bytes" if b_ms == t_bytes else "operations", parts


def _timed_steps(step, state, batch, n: int, on_step=None):
    """``n`` steps back to back, each bracketed by CUDA events; metrics
    kept on the card until the end. Returns (state, per-step ms, per-step
    metrics as floats, host wall s)."""
    import torch

    evs, ms = [], []
    t = time.perf_counter()
    for i in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        evs.append((a, b))
        ms.append(m)
        if on_step is not None:
            on_step(i + 1, state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (state, [a.elapsed_time(b) for a, b in evs],
            [{k: float(v) for k, v in m.items()} for m in ms], wall)


def _train_profile(step, state, batch) -> dict:
    """A torch.profiler window over TRAIN_PROFILED steps: device ms and
    kernels per step, the busy share, the top kernels."""
    return profile_call(lambda: [step(state, batch) for _ in range(TRAIN_PROFILED)],
                        TRAIN_PROFILED)


def _train_row(label: str, ms: list, wall: float, prof: dict, bound) -> dict:
    b_ms, b_by, parts = bound
    med = statistics.median(ms[TRAIN_TIMED_FROM - 1:])
    row = dict(leg=label, step_ms_median=med, step_ms_first=ms[0],
               host_wall_ms_per_step=wall * 1e3 / len(ms),
               bound_ms=b_ms, bound_by=b_by, bound_parts_ms=parts,
               share_of_bound=b_ms / med,
               share_of_bound_device=b_ms / prof["device_ms_per_batch"], **prof)
    log(f"train {label}: step {med:.3f} ms median over steps {TRAIN_TIMED_FROM}-"
        f"{len(ms)} (CUDA events; first {ms[0]:.1f} ms, host {row['host_wall_ms_per_step']:.3f}"
        f" ms/step); profiled: {prof['device_ms_per_batch']:.3f} ms device and "
        f"{prof['device_kernels_per_batch']:.0f} kernels per step, busy "
        f"{prof['device_busy_share']:.3f}; bound {b_ms:.4f} ms ({b_by}: "
        f"{json.dumps({k: round(v, 5) for k, v in parts.items()})}), share of bound "
        f"{row['share_of_bound']:.4f} of the step, {row['share_of_bound_device']:.4f} "
        f"of its device time; top [name, ms, count] per step: "
        f"{json.dumps(prof['top_device_ms_per_batch'])}")
    return row


def train_leg_style(dev, tmp: str):
    """(a) the default StyleTrainConfig (c 32, r 5, the VGG's default
    blocks, bf16) on one 8 x 256 x 256 batch of SyntheticSource frames
    with the stripes target: 30 timed steps with an AsyncSaver checkpoint
    at step 15, 5 profiled steps, then the final checkpoint (step 35).
    Returns (row, state, step, batch, checkpoint dir)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.cli import make_style_image
    from dvf_tpu_torch.train import StyleTrainConfig, init_train_state, make_train_step
    from dvf_tpu_torch.train.checkpoint import AsyncSaver, save_checkpoint

    b, h, w, _ = TRAIN_STYLE_SHAPE
    cfg = StyleTrainConfig()
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(h, w, n_frames=b, seed=0)][:-1]
    batch = (torch.from_numpy(np.stack(frames).astype(np.float32) / 255.0)
             .pin_memory().to(dev, non_blocking=True))
    state = init_train_state(0, make_style_image("stripes", h), cfg, device=dev)
    step = make_train_step(None, cfg, state_template=state)
    ck = os.path.join(tmp, "style")
    os.makedirs(ck)
    with open(os.path.join(ck, "config.json"), "w") as f:
        json.dump({"base_channels": cfg.net.base_channels,
                   "n_residual": cfg.net.n_residual, "style": "stripes", "size": h,
                   "steps": TRAIN_STEPS}, f)
    saver = AsyncSaver()
    torch.cuda.reset_peak_memory_stats(dev)

    def mid(i, st):
        if i == TRAIN_STEPS // 2:
            saver.save(os.path.join(ck, f"step_{i:06d}"), st)

    try:
        state, ms, metrics, wall = _timed_steps(step, state, batch, TRAIN_STEPS, mid)
    finally:
        saver.close()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train (a): losses {losses}")
    macs = style_train_macs_per_pixel()
    log(f"train (a) MAC per pixel: {json.dumps(macs)} (3 x net + 3 x VGG would count "
        f"the stem's data gradient, which autograd skips, and no Gram matrices)")
    prof = _train_profile(step, state, batch)
    save_checkpoint(os.path.join(ck, "final"), state)   # after the profiled steps
    row = _train_row("a_style", ms, wall, prof,
                     train_bound(macs, b * h * w, batch.numel() * 4, _n_params(state.params)))
    row.update(shape=list(TRAIN_STYLE_SHAPE), losses=losses, peak_allocated_bytes=peak,
               macs_per_pixel=macs, terms_last={k: metrics[-1][k] for k in
                                                ("content", "style", "tv")})
    log(f"train (a): loss {losses[0]:.4f} -> {losses[-1]:.4f} over {TRAIN_STEPS} steps "
        f"(content/style/tv at the end {json.dumps(row['terms_last'])}); peak "
        f"allocated {peak / 2**30:.2f} GiB")
    return row, state, step, batch, ck


def _zero_grad_leaf(k: str) -> bool:
    """Leaves whose exact gradient is zero: the conv biases an instance
    norm follows, and the residual norms' biases (a per-channel constant
    on the trunk reaches only such convs)."""
    return (k.endswith("/b") and k != "out/b") or (k.startswith("res") and
                                                  k.endswith("_bn/bias"))


def train_leg_card_vs_cpu(dev):
    """(b) one float32 step of each family from the same state and batch
    (2 x 64 x 64) on the card and on the CPU, cuDNN's TF32 switched on
    globally (the step turns it off for forward and backward): the loss's
    relative error, every gradient leaf's error against its largest
    element, the largest parameter difference after the step."""
    import torch

    from dvf_tpu_torch.cli import make_style_image
    from dvf_tpu_torch.models import EspcnConfig, StyleNetConfig
    from dvf_tpu_torch.models.vgg import VGGConfig
    from dvf_tpu_torch.train import optim
    from dvf_tpu_torch.train import sr as tsr
    from dvf_tpu_torch.train import style as tst

    f32 = torch.float32
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random(TRAIN_CHECK_SHAPE, dtype=np.float32))
    style_cfg = tst.StyleTrainConfig(net=StyleNetConfig(compute_dtype=f32),
                                     vgg=VGGConfig(compute_dtype=f32))
    sr_cfg = tsr.SrTrainConfig(net=EspcnConfig(compute_dtype=f32))
    img = make_style_image("stripes", TRAIN_CHECK_SHAPE[1])
    rows = []
    for family, init, make, cfg in (
            ("style", lambda d: tst.init_train_state(0, img, style_cfg, device=d),
             tst.make_train_step, style_cfg),
            ("sr", lambda d: tsr.init_train_state(0, sr_cfg, device=d),
             tsr.make_train_step, sr_cfg)):
        out = {}
        torch.backends.cudnn.allow_tf32 = True
        try:
            for where in ("card", "cpu"):
                state = init(dev if where == "card" else "cpu")
                state, m = make(None, cfg, state_template=state)(state, x)
                out[where] = (state, float(m["loss"]))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        (card, lc), (cpu, lp) = out["card"], out["cpu"]
        pc, pp = optim.flatten(card.params), optim.flatten(cpu.params)
        big = max(float(t.grad.abs().max()) for t in pp.values())
        grad_err, zero_max, dp, dp_clear = 0.0, 0.0, 0.0, 0.0
        lr = cfg.learning_rate
        for k in pp:
            gc, gp = pc[k].grad.cpu(), pp[k].grad
            d = (pc[k].detach().cpu() - pp[k].detach()).abs()
            dp = max(dp, float(d.max()))
            clear = gp.abs() >= 1e-4 * big
            if clear.any():
                dp_clear = max(dp_clear, float(d[clear].max()))
            if family == "style" and _zero_grad_leaf(k):
                zero_max = max(zero_max, float(gc.abs().max()), float(gp.abs().max()))
            else:
                grad_err = max(grad_err, float((gc - gp).abs().max() / gp.abs().max()))
        loss_rel = abs(lc - lp) / abs(lp)
        row = dict(leg=f"b_{family}_card_vs_cpu", shape=list(TRAIN_CHECK_SHAPE),
                   loss_card=lc, loss_cpu=lp, loss_rel_err=loss_rel,
                   grad_max_rel_err=grad_err, zero_grad_leaves_max_abs=zero_max,
                   largest_grad=big, param_max_abs_diff=dp,
                   param_max_abs_diff_clear=dp_clear, lr=lr)
        log(f"train (b) {family} float32 step, card vs CPU at {TRAIN_CHECK_SHAPE} (TF32 "
            f"on globally): loss rel err {loss_rel:.3e}, gradient max rel err per leaf "
            f"{grad_err:.3e} (bar 1e-4), zero-gradient leaves max |g| {zero_max:.3e} "
            f"(largest |g| {big:.3e}), params after the step max |d| {dp:.3e} = "
            f"{dp / lr:.3f} lr ({dp_clear / lr:.2e} lr where |g| >= 1e-4 of the largest)")
        if not (loss_rel <= 1e-5 and grad_err <= 1e-4 and zero_max <= 1e-5 * big
                and dp <= 2 * lr * (1 + 1e-5) and dp_clear <= 1e-3 * lr):
            raise AssertionError(f"train (b) {family}: the card's float32 step differs "
                                 f"from the CPU's: {row}")
        rows.append(row)
    return rows


def train_leg_sr(dev):
    """(c) the default SrTrainConfig (ESPCN x2, bf16) on one batch of 16
    structured 128 x 128 HR frames, 30 steps: the loss falls and the PSNR
    rises; step ms, profile, bound."""
    import torch

    from dvf_tpu_torch.train import sr as tsr

    b, h, w, _ = TRAIN_SR_SHAPE
    cfg = tsr.SrTrainConfig()
    hr = tsr.synthesize_structured_batch(np.random.default_rng(1), b, h)
    batch = (torch.from_numpy(hr.astype(np.float32) / 255.0).pin_memory()
             .to(dev, non_blocking=True))
    state = tsr.init_train_state(0, cfg, device=dev)
    step = tsr.make_train_step(None, cfg, state_template=state)
    state, ms, metrics, wall = _timed_steps(step, state, batch, TRAIN_STEPS)
    losses, psnrs = [m["loss"] for m in metrics], [m["psnr"] for m in metrics]
    if not (losses[-1] < losses[0] and psnrs[-1] > psnrs[0]):
        raise AssertionError(f"train (c): loss {losses}, psnr {psnrs}")
    macs = {"bf16": sr_train_macs_per_lr_pixel()}
    prof = _train_profile(step, state, batch)
    row = _train_row("c_sr", ms, wall, prof,
                     train_bound(macs, b * (h // 2) * (w // 2), batch.numel() * 4,
                                 _n_params(state.params)))
    row.update(shape=list(TRAIN_SR_SHAPE), losses=losses, psnrs=psnrs,
               macs_per_lr_pixel=macs["bf16"])
    log(f"train (c): loss {losses[0]:.4f} -> {losses[-1]:.4f}, psnr {psnrs[0]:.2f} -> "
        f"{psnrs[-1]:.2f} dB over {TRAIN_STEPS} steps; {macs['bf16']} MAC per LR pixel")
    return row


def train_leg_resume(dev, state, step, batch, ck: str):
    """(d) the (a) run's checkpoints restored on the card into templates
    from another seed: step and params bitwise; one more step of the
    restored state against the uninterrupted run's next step; the trained
    weights served by an Engine at 8 x 720 x 1280, the served batch
    STYLE_LAUNCHES (instance_norm and out_conv); the row holds every
    launch of the leg (the engine's compile, the batch, the direct
    call)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.cli import make_style_image
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.train import StyleTrainConfig, init_train_state, optim
    from dvf_tpu_torch.train.checkpoint import load_style_filter, restore_checkpoint
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    cfg = StyleTrainConfig()
    img = make_style_image("stripes", TRAIN_STYLE_SHAPE[1])

    def template():
        return init_train_state(1, img, cfg, device=dev)

    t = time.perf_counter()
    mid = restore_checkpoint(os.path.join(ck, f"step_{TRAIN_STEPS // 2:06d}"), template())
    restored = restore_checkpoint(os.path.join(ck, "final"), template())
    restore_s = (time.perf_counter() - t) / 2
    final_step = TRAIN_STEPS + TRAIN_PROFILED
    if int(mid.step) != TRAIN_STEPS // 2 or int(restored.step) != final_step:
        raise AssertionError(f"train (d): restored steps {int(mid.step)}, "
                             f"{int(restored.step)}")
    saved = optim.flatten(state.params)
    n_diff = sum(int((optim.flatten(restored.params)[k] != v).sum()) for k, v in saved.items())
    if n_diff:
        raise AssertionError(f"train (d): {n_diff} restored param elements differ")
    del mid
    state, m1 = step(state, batch)
    restored, m2 = step(restored, batch)
    dp = max(float((optim.flatten(restored.params)[k] - v).detach().abs().max())
             for k, v in optim.flatten(state.params).items())
    dl = abs(float(m1["loss"]) - float(m2["loss"]))
    log(f"train (d): the mid-run (async) and final checkpoints restored at steps "
        f"{TRAIN_STEPS // 2} and {final_step}, params bitwise equal to the saved "
        f"ones ({restore_s:.2f} s per restore); the next step resumed vs "
        f"uninterrupted: loss |d| {dl:.3e}, params max |d| {dp:.3e}")
    launches0 = dict(tk.LAUNCHES)
    filt = load_style_filter(ck)
    eng = dvf_tpu_torch.Engine(filt, device=dev)
    eng.compile(TRAIN_SERVE_SHAPE)
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
        *TRAIN_SERVE_SHAPE[1:], n_frames=TRAIN_SERVE_SHAPE[0], seed=0)][:-1]
    x = np.stack(frames)
    t = time.perf_counter()
    before = dict(tk.LAUNCHES)
    got = eng.submit(x).fetch()
    served = {k: v - before[k] for k, v in tk.LAUNCHES.items() if v != before[k]}
    serve_ms = (time.perf_counter() - t) * 1e3
    if served != STYLE_LAUNCHES:
        raise AssertionError(f"train (d): the served batch launched {served}, want "
                             f"{STYLE_LAUNCHES}")
    direct = to_uint8(_filter_out(filt, to_float(torch.from_numpy(x).to(dev)), dev))
    launches = {k: v - launches0[k] for k, v in tk.LAUNCHES.items()}
    lsb = max_lsb(got, direct.cpu().numpy())
    if got.shape != TRAIN_SERVE_SHAPE or got.dtype != np.uint8 or lsb > 1:
        raise AssertionError(f"train (d): served {got.shape} {got.dtype}, {lsb} LSB "
                             f"from a direct call")
    log(f"train (d): load_style_filter -> Engine on the card served {TRAIN_SERVE_SHAPE} "
        f"in {serve_ms:.1f} ms, max {lsb} LSB from a direct call, mean "
        f"{float(got.mean()):.1f}")
    eng.free()
    return dict(leg="d_resume", serve_launches=launches,
                restored_steps=[TRAIN_STEPS // 2, final_step],
                params_differing=0, restore_s=restore_s,
                next_step_loss_abs_diff=dl, next_step_param_max_abs_diff=dp,
                served_shape=list(got.shape), served_max_lsb_vs_direct=lsb,
                served_ms=serve_ms)


def _train_proc(argv, env):
    return subprocess.Popen([sys.executable, "-m", "dvf_tpu_torch", *argv],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _train_procs(label_argv: list, env) -> dict:
    """Start every (label, argv) process together; each must exit 0 with a
    JSON last line. Returns {label: (JSON, stderr, wall s)}; kills every
    process left on the way out."""
    t = time.perf_counter()
    procs = [(label, _train_proc(argv, env)) for label, argv in label_argv]
    res = {}
    try:
        for label, p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"train (e) {label}: rc {p.returncode}; "
                                     f"stderr tail:\n{err[-3000:]}")
            res[label] = (json.loads(out.strip().splitlines()[-1]), err,
                          time.perf_counter() - t)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def train_leg_cli(tmp: str):
    """(e) ``python -m dvf_tpu_torch train`` / ``train-sr`` as processes
    on cuda:0 (no --platform): train 4 steps with checkpoints every 2,
    then resumed to 6; train-sr 4 steps with --eval; train-sr --steps 0
    from the committed sr2x_64 state with --eval (delta > 2.5 dB)."""
    env = dict(os.environ)
    env.pop("DVF_FORCE_PLATFORM", None)
    d = os.path.join(tmp, "cli")
    train = ["train", "--steps", "4", "--batch", "4", "--size", "64",
             "--checkpoint-dir", d, "--checkpoint-every", "2", "--log-every", "2"]
    sr64 = os.path.join("dvf_tpu_torch", "checkpoints", "sr2x_64", "final")
    first = _train_procs([
        ("train", train),
        ("train_sr", ["train-sr", "--steps", "4", "--eval", "--log-every", "2"]),
        ("train_sr_eval", ["train-sr", "--steps", "0", "--resume", sr64, "--eval"]),
    ], env)
    second = _train_procs([
        ("train_resumed", ["train", "--steps", "6", "--batch", "4", "--size", "64",
                           "--checkpoint-dir", d, "--resume", os.path.join(d, "final"),
                           "--log-every", "2"])], env)
    res = {**first, **second}
    j, err, _ = res["train"]
    if j["steps"] != 4 or "(async)" not in err or not np.isfinite(j["final_loss"]):
        raise AssertionError(f"train (e) train: {j}; {err[-2000:]}")
    j, err, _ = res["train_resumed"]
    if j["steps"] != 6 or "at step 4" not in err:
        raise AssertionError(f"train (e) resumed: {j}; {err[-2000:]}")
    held = res["train_sr"][0]["held_out"]
    if not all(np.isfinite(v) for v in held.values()):
        raise AssertionError(f"train (e) train-sr --eval: {held}")
    claim = res["train_sr_eval"][0]["held_out"]
    if not claim["delta_db"] > 2.5 or "at step 6000" not in res["train_sr_eval"][1]:
        raise AssertionError(f"train (e) the sr2x_64 claim: {claim}")
    for label, (j, _, wall) in res.items():
        log(f"train (e) {label}: {json.dumps(j)} ({wall:.1f} s from the start of its "
            f"group)")
    return dict(leg="e_cli", **{k: v[0] for k, v in res.items()},
                wall_s={k: v[2] for k, v in res.items()})


def train_phase(dev):
    """Phase 13: legs (a)-(e) of training. Returns (rows, the launch counts
    of the phase: the train path runs no hand kernel, so all 0 but (d)'s
    serving of the trained net, its instance_norm and out_conv launches)."""
    import tempfile

    import torch

    from dvf_tpu_torch.ops import kernels as tk

    t0 = time.perf_counter()
    log(f"train phase on {nvidia_smi()}")
    tk.reset_launches()
    rows = []

    def timed(leg, *args):
        t = time.perf_counter()
        out = leg(*args)
        new = out[0] if isinstance(out, tuple) else out
        for row in new if isinstance(new, list) else [new]:
            row["wall_s"] = time.perf_counter() - t
            rows.append(row)
        log(f"train leg {rows[-1]['leg']}: {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
        return out

    with tempfile.TemporaryDirectory(prefix="dvf-train-") as tmp:
        _, state, step, batch, ck = timed(train_leg_style, dev, tmp)
        timed(train_leg_resume, dev, state, step, batch, ck)
        del state, step, batch
        timed(train_leg_card_vs_cpu, dev)
        timed(train_leg_sr, dev)
        timed(train_leg_cli, tmp)
    delta = dict(tk.LAUNCHES)
    served = next(r["serve_launches"] for r in rows if r["leg"] == "d_resume")
    if delta != served:
        raise AssertionError(f"train: the train path launched a hand kernel: {delta} "
                             f"(the serving leg's: {served})")
    if not (tk.AUTOGRAD_CALLS["instance_norm"] and tk.AUTOGRAD_CALLS["out_conv"]):
        raise AssertionError(f"train: no norm or out stage of the train path took the "
                             f"plain ops: {tk.AUTOGRAD_CALLS}")
    log(f"train phase: {time.perf_counter() - t0:.1f} s, launches {delta}, the "
        f"plain calls under autograd {tk.AUTOGRAD_CALLS}")
    return rows, delta


def train_only() -> None:
    """The build and phase 13 alone (training):
    ``python3 -c 'import chip_smoke; chip_smoke.train_only()'``."""
    dev, _, _ = _only_setup()
    rows, _ = train_phase(dev)
    print(json.dumps({"train": rows}))


# ---------------------------------------------------------------------------
# Phase 14: the bench harness (bench, fleet --scaling, bench_child and the
# roofline model)
# ---------------------------------------------------------------------------

BENCH_ITERS = 30                 # (a): device-resident batches per config
# (a): the hand kernels each BENCH_CONFIGS entry launches, and how often
# per device batch. gauss3_1080p's 3-tap blur has none: gaussian_blur resolves
# blurs under 9 taps to plain torch ops (ops/conv.py), as the reference's
# measured default does on its CPU and TPU alike.
BENCH_KERNEL = {"gauss9_1080p": {"sep_blur": 1},
                "sobel_bilateral_1080p": {"sobel_bilateral": 1},
                "flow_720p": {"warp_bounded": 1},
                "style_720p": STYLE_LAUNCHES}
BENCH_E2E_BATCH = 16             # (b): the 1080p pipeline legs' batch
BENCH_E2E_FRAMES = 320           # (b): frames of the throughput run
BENCH_LAT_FRAMES = 160           # (b): frames of the rate-controlled run
BENCH_STAGE_BATCHES = (1, 2, 4)  # (c)
BENCH_CHILD_ITERS = 20           # (e): --mode device batches (1080p, 64)


def bench_hold(dev, config: str, plain_of: dict) -> int:
    """(a)'s check of one batch of ``config`` (the bench's own seeded
    batch at the config's shape) through an Engine on the card against
    the plain version: K1/K3 configs against their plain torch
    versions, flow_720p's second batch (the first passes through)
    against the same stream with the plain clipped warp, the others
    against a direct ``filt.fn`` call. Returns the max |difference| in
    LSB. For gauss3_1080p also the separable-blur kernel at 3 taps (its
    run-time-tap instantiation) against its plain version at the
    config's shape. Outside any counted run."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.cli import BENCH_CONFIGS
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.ops.conv import gaussian_kernel_1d, sep_conv2d
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    spec = BENCH_CONFIGS[config]
    name, kw = spec["filter"]
    shape = (spec["batch"], spec["h"], spec["w"], 3)
    filt = dvf_tpu_torch.get_filter(name, **kw)
    rng = np.random.default_rng(0)
    eng = dvf_tpu_torch.Engine(filt, device=dev)
    counter = next(iter(BENCH_KERNEL.get(config, {})), None)
    if name == "flow_warp":
        frames = [rng.integers(0, 255, size=shape[1:], dtype=np.uint8)
                  for _ in range(2 * shape[0])]
        got = np.concatenate([eng.submit(np.stack(frames[s:s + shape[0]])).fetch().copy()
                              for s in (0, shape[0])])
        want = flow_reference(frames, shape[0], dev, inner=False)
    else:
        x = rng.integers(0, 255, size=shape, dtype=np.uint8)
        got = eng.submit(x).fetch().copy()
        xd = torch.from_numpy(x).to(dev)
        with torch.no_grad():
            if counter in plain_of:
                want = to_uint8(plain_of[counter](to_float(xd)))
            else:
                want = to_uint8(_filter_out(filt, xd if filt.uint8_ok else to_float(xd),
                                            dev))
        want = want.cpu().numpy()
    lsb = max_lsb(got, want)
    if got.shape != want.shape or lsb > 1:
        raise AssertionError(f"bench (a) {config}: one batch {lsb} LSB from the "
                             f"plain version (bar 1)")
    if config == "gauss3_1080p":
        k3 = gaussian_kernel_1d(3, 0.0)
        xf = torch.rand(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        err = (tk.sep_blur_nhwc_pallas(xf, k3, k3)
               - sep_conv2d(xf, k3, k3, impl="shift")).abs().max().item()
        log(f"check sep_blur k=3 (sep_blur_kernel<{','.join(map(str, tk.sep_blur_instance(3, 3, 3)))}>"
            f", taps at run time) {shape}: max abs err {err:.3e}")
        if not err <= TOL:
            raise AssertionError(f"sep_blur at 3 taps disagrees with its plain "
                                 f"version at {shape}: {err} > {TOL}")
    del eng
    torch.cuda.empty_cache()
    return lsb


def bench_leg_device(dev, plain_of: dict):
    """(a) ``bench --config C --iters BENCH_ITERS`` through main() for each
    BENCH_CONFIGS entry, the launch counters zeroed before and read
    after: the JSON line with its H100 roofline fields (each share <= 1.0,
    a count being wrong otherwise), the configs' kernel launched once per
    device batch (the style net's STYLE_LAUNCHES; warm-up and
    timed batches) besides its compile's launches, no other kernel; then one batch held to the plain version
    (``bench_hold``). Returns (rows, launch counts, ms_per_frame by
    config)."""
    from dvf_tpu_torch.cli import BENCH_CONFIGS
    from dvf_tpu_torch.ops import kernels as tk

    rows, total, ms = [], {}, {}
    for config in sorted(BENCH_CONFIGS):
        with _EngineLedger() as ledger:
            tk.reset_launches()
            out = _cli_json(f"a {config}", ["bench", "--config", config,
                                            "--iters", str(BENCH_ITERS)])
            delta = dict(tk.LAUNCHES)
        per = BENCH_KERNEL.get(config, {})
        batches = ledger.batches()
        serving = {k: v - ledger.compile.get(k, 0) for k, v in delta.items()}
        want = {k: per.get(k, 0) * batches for k in delta}
        if serving != want or batches != BENCH_ITERS + 1:
            raise AssertionError(f"bench (a) {config}: serving launches {serving} "
                                 f"for {batches} batches, want {want}")
        shares = {k: out.get(k) for k in ("hbm_roofline_frac", "mfu")}
        if any(v is None or not 0 <= v <= 1.0 for v in shares.values()):
            raise AssertionError(f"bench (a) {config}: shares {shares} (a share "
                                 f"above 1.0 means the count is wrong): {out}")
        lsb = bench_hold(dev, config, plain_of)
        ms[config] = out["ms_per_frame"]
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
        row = dict(leg="a_device", config=config, **out, batches=batches,
                   launches=delta, compile_launches=dict(ledger.compile),
                   max_lsb_vs_plain=lsb)
        log(f"bench (a) {config}: {json.dumps(out)}; launches {delta} "
            f"({ledger.compile} in compiles) over {batches} batches; one batch "
            f"{lsb} LSB from the plain version")
        rows.append(row)
    return rows, total, ms


def bench_leg_e2e(dev, have_jpeg: bool):
    """(b) ``bench --e2e`` (throughput, then the rate-controlled latency
    leg) for invert_1080p and gauss9_1080p at batch BENCH_E2E_BATCH through
    main(), over the python queue and the ring's raw wire and, where
    libjpeg is present, the ring's delta and jpeg wires: every frame
    delivered, no fault, K1 once per engine batch on the gauss9 legs and
    no other kernel. Without libjpeg both codec wires (the delta wire
    encodes its tiles with the JPEG codec) must exit 2 and say why.
    Returns (rows, launch counts)."""
    from dvf_tpu_torch.ops import kernels as tk

    wires = [("python", "raw"), ("ring", "raw")]
    if have_jpeg:
        wires += [("ring", "delta"), ("ring", "jpeg")]
    rows, total = [], {}
    for config, counter in (("invert_1080p", None), ("gauss9_1080p", "sep_blur")):
        for transport, wire in wires:
            label = f"b {config} {transport}/{wire}"
            argv = ["bench", "--config", config, "--e2e", "--batch",
                    str(BENCH_E2E_BATCH), "--frames", str(BENCH_E2E_FRAMES),
                    "--lat-frames", str(BENCH_LAT_FRAMES), "--transport",
                    transport, "--wire", wire]
            if wire == "delta":
                argv += ["--motion", "block"]
            with _EngineLedger() as ledger:
                tk.reset_launches()
                out = _cli_json(label, argv)
                delta = dict(tk.LAUNCHES)
            # The throughput run's source is unthrottled into a drop-oldest
            # queue, so it delivers what the pipeline keeps up with; the
            # latency leg's verdict (lat_congested) says whether it kept up.
            if (not 0 < out["frames"] <= BENCH_E2E_FRAMES or out["faults"]
                    or not out["lat_frames"]):
                raise AssertionError(f"bench ({label}): {out}")
            if counter is not None:
                counts = _cli_counted(label, delta, ledger, counter)
            elif any(delta.values()):
                raise AssertionError(f"bench ({label}): launched {delta}")
            else:
                counts = dict(launches=0, batches=ledger.batches())
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
            log(f"bench ({label}): {out['value']} fps e2e ({out['frames']} of "
                f"{BENCH_E2E_FRAMES} frames delivered), latency leg p50 "
                f"{out['p50_ms']} / p99 {out['p99_ms']} ms at "
                f"{out['lat_target_fps']} fps (congested {out['lat_congested']}, "
                f"{out['lat_backoffs']} backoffs), ingest {out['ingest']} / egress "
                f"{out['egress']}; {counts}")
            rows.append(dict(leg="b_e2e", config=config, **out, **counts))
    if not have_jpeg:
        for wire in ("jpeg", "delta"):
            rc, _, err = _cli(["bench", "--config", "invert_1080p", "--e2e",
                               "--transport", "ring", "--wire", wire])
            if rc != 2 or "needs the JPEG codec" not in err:
                raise AssertionError(f"bench (b) --wire {wire} without libjpeg: rc "
                                     f"{rc}; {err[-2000:]}")
            log(f"bench (b) --wire {wire} without libjpeg: rc 2, "
                f"{err.strip().splitlines()[-1][:160]}")
        rows.append(dict(leg="b_codec_wires_without_libjpeg", rc=2))
    return rows, total


def bench_leg_transfer(dev, have_jpeg: bool):
    """(c) ``bench_transfer`` at 16 x 1080 x 1920 (pinned host memory) and
    ``bench_stage_decomposition`` of invert at 1080p, batches 1, 2 and 4,
    without the encode leg; without libjpeg, asking for the encode leg
    must raise. Returns (row, launch counts: none)."""
    from dvf_tpu_torch.benchmarks import bench_stage_decomposition, bench_transfer
    from dvf_tpu_torch.ops import get_filter

    h, w = MAIN_SHAPE[1:3]
    tr = bench_transfer(BENCH_E2E_BATCH, h, w, device=dev)
    if tr["host_memory"] != "pinned" or not all(
            np.isfinite(tr[k]) and tr[k] > 0 for k in ("h2d_mbps", "d2h_mbps")):
        raise AssertionError(f"bench (c) transfer: {tr}")
    st = bench_stage_decomposition(get_filter("invert"), BENCH_STAGE_BATCHES, h, w,
                                   reps=25, measure_encode=False, device=dev)
    if set(st) != {f"batch_{b}" for b in BENCH_STAGE_BATCHES}:
        raise AssertionError(f"bench (c) stages: {st}")
    if not have_jpeg:
        try:
            bench_stage_decomposition(get_filter("invert"), (1,), h, w, reps=1,
                                      device=dev)
        except RuntimeError as e:
            log(f"bench (c) measure_encode=True without libjpeg raises: {e}"[:200])
        else:
            raise AssertionError("bench (c): the encode leg ran without libjpeg")
    log(f"bench (c) transfer {BENCH_E2E_BATCH} x {h} x {w}: {json.dumps(tr)}")
    for k, v in st.items():
        log(f"bench (c) stages invert {k}: {json.dumps(v)}")
    return dict(leg="c_transfer_stages", transfer=tr, stages=st), {}


def bench_leg_fleet(dev):
    """(d) ``fleet --scaling --sessions 2`` at the defaults (256², the
    3-deep gaussian_blur chain, batch 4, 120 frames a session, 1 and 2
    replicas) in local mode through main(), K1 three times per engine
    batch and no other kernel, and in process mode (core-pinned children
    on the one card); every frame delivered in each round, the host's
    parallel capacity beside the ratio. Returns (rows, launch counts of
    the local run)."""
    from dvf_tpu_torch.ops import kernels as tk

    rows, total = [], {}
    for mode in ("local", "process"):
        argv = ["fleet", "--scaling", "--mode", mode, "--sessions", "2"]
        with _EngineLedger() as ledger:
            tk.reset_launches()
            out = _cli_json(f"d {mode}", argv)
            delta = dict(tk.LAUNCHES)
        for n, r in out["rounds"].items():
            if r["delivered"] != r["expected"] or r["faults"]:
                raise AssertionError(f"bench (d) {mode} round {n}: {r}")
        if mode == "local":
            serving = delta["sep_blur"] - ledger.compile.get("sep_blur", 0)
            others = {k: v for k, v in delta.items() if k != "sep_blur" and v}
            if serving != 3 * ledger.batches() or others or not serving:
                raise AssertionError(f"bench (d) local: K1 {delta['sep_blur']} "
                                     f"({ledger.compile} in compiles) for "
                                     f"{ledger.batches()} batches; others {others}")
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
        log(f"bench (d) fleet --scaling --mode {mode}: fps "
            f"{ {n: r['fps'] for n, r in out['rounds'].items()} }, scaling "
            f"{out['scaling']}, parallel capacity {out['parallel_capacity']}, "
            f"launches {delta}")
        rows.append(dict(leg=f"d_fleet_{mode}", **out,
                         launches=delta if mode == "local" else None))
    return rows, total


def bench_leg_child():
    """(e) ``python -m dvf_tpu_torch.bench_child`` as processes on the card:
    ``--mode probe --platform cuda`` (backend "cuda", probe_sum 28.0), then
    ``--mode device`` at BENCH_CHILD_ITERS (invert, 1080p, batch 64, its
    H100 roofline share <= 1.0, the transfer legs on pinned memory)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("DVF_FORCE_PLATFORM", None)
    res = {}
    for mode, extra in (("probe", []), ("device", ["--iters", str(BENCH_CHILD_ITERS)])):
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "dvf_tpu_torch.bench_child",
                            "--mode", mode, "--platform", "cuda", *extra],
                           cwd=root, env=env, capture_output=True, text=True,
                           timeout=300)
        if p.returncode != 0:
            raise AssertionError(f"bench (e) bench_child --mode {mode}: rc "
                                 f"{p.returncode}; {p.stderr[-2000:]}")
        line = json.loads(p.stdout.strip().splitlines()[-1])
        res[mode] = dict(line, wall_s=time.perf_counter() - t)
        log(f"bench (e) bench_child --mode {mode} ({res[mode]['wall_s']:.1f} s): "
            f"{json.dumps(line)}")
    if res["probe"]["backend"] != "cuda" or res["probe"]["probe_sum"] != 28.0:
        raise AssertionError(f"bench (e) probe: {res['probe']}")
    dev_line = res["device"]
    if (dev_line["backend"] != "cuda" or dev_line["host_memory"] != "pinned"
            or not 0 <= dev_line["hbm_roofline_frac"] <= 1.0):
        raise AssertionError(f"bench (e) device: {dev_line}")
    return dict(leg="e_bench_child", **res), {}


def bench_leg_analysis(ms: dict, tmp: str):
    """(f) ``models.analysis`` for style_720p and sr2x_540p with (a)'s
    measured ms per frame: each net's per-layer H100 bound and the gap of
    the measured time to it (the measured time below the bound, or an
    MFU above 1, would mean the model is wrong)."""
    import io

    from dvf_tpu_torch.models import analysis

    argv = ["--json", "--md-out", os.path.join(tmp, "roofline.md")]
    for config in ("style_720p", "sr2x_540p"):
        argv += ["--measured", f"{config}={ms[config]}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        analysis.main(argv)
    doc = json.loads(buf.getvalue().strip().splitlines()[0])
    for config, s in doc.items():
        if not (s["lowering_gap_x"] >= 1.0 and s["mfu_measured"] <= 1.0):
            raise AssertionError(f"bench (f) {config}: {s}")
        log(f"bench (f) {config}: measured {s['measured_ms_per_frame']} ms/frame, "
            f"per-layer H100 bound {s['serial_ideal_ms']} ms (tensor "
            f"{s['tc_floor_ms']}, HBM {s['hbm_floor_ms']}), gap "
            f"{s['lowering_gap_x']}x, MFU {s['mfu_measured']}: {s['verdict']}")
    return dict(leg="f_analysis", **doc), {}


def bench_phase(dev, plain_of: dict, have_jpeg: bool):
    """Phase 14: legs (a)-(f) of the bench harness. Returns (rows, the
    summed launch counts of the in-process legs' runs; bench_child's and
    the process replicas' launches happen in their own processes)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    log(f"bench phase on {nvidia_smi()}")
    rows, total = [], {}

    def timed(leg, *args):
        t = time.perf_counter()
        out = leg(*args)
        new, delta = out[0], out[1]
        for row in new if isinstance(new, list) else [new]:
            row["wall_s"] = time.perf_counter() - t
            rows.append(row)
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
        log(f"bench leg {rows[-1]['leg']}: {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
        return out

    with tempfile.TemporaryDirectory(prefix="dvf-bench-") as tmp:
        _, _, ms = timed(bench_leg_device, dev, plain_of)
        timed(bench_leg_e2e, dev, have_jpeg)
        timed(bench_leg_transfer, dev, have_jpeg)
        timed(bench_leg_fleet, dev)
        timed(bench_leg_child)
        timed(bench_leg_analysis, ms, tmp)
    from dvf_tpu_torch.runtime.engine import live_pool_engines

    if live_pool_engines():
        raise AssertionError("bench: pool engines outlived their frontends")
    log(f"bench phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total


def bench_only() -> None:
    """The build and phase 14 alone (the bench harness):
    ``python3 -c 'import chip_smoke; chip_smoke.bench_only()'``."""
    dev, plain_of, env = _only_setup()
    rows, _ = bench_phase(dev, plain_of, env["libjpeg"])
    print(json.dumps({"bench": rows}))


# ---------------------------------------------------------------------------
# 15. the in-host mesh
# ---------------------------------------------------------------------------

# Phase 15's shapes: the 1080p batch-16 stencil legs, flow_warp at 720p
# batch 4, the style net (c 32, r 5, bf16) at 720p batch 8 and ESPCN x2 at
# 540p batch 8, each against its unsharded engine on the same card.
MESH_REPS = 3
MESH_STENCILS = [("gaussian_blur", {"ksize": 9}, "sep_blur"),
                 ("bilateral", {}, "bilateral"),
                 ("sobel_bilateral", {}, "sobel_bilateral")]


def _mesh_frames(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, shape, np.uint8)


def _engine_ms(eng, x: np.ndarray, reps: int = MESH_REPS) -> float:
    """Wall ms per batch of ``submit`` + ``fetch`` (host in, host out),
    after one untimed batch."""
    eng.submit(x).fetch()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.submit(x).fetch()
    return (time.perf_counter() - t0) / reps * 1e3


def _resident_ms(eng, x: np.ndarray, reps: int = MESH_REPS) -> float:
    """Wall ms per batch of the step alone on a batch already on the
    card (blocks laid out by the engine's input sharding), synchronised."""
    import torch

    from dvf_tpu_torch.runtime.engine import host_tensor

    eng.ensure_compiled(x.shape, x.dtype)
    xd = eng.upload(host_tensor(x))
    torch.cuda.synchronize()
    eng.run_device_resident(xd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.run_device_resident(xd)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _launch_delta(fn):
    from dvf_tpu_torch.ops import kernels as tk

    before = dict(tk.LAUNCHES)
    out = fn()
    import torch

    torch.cuda.synchronize()
    return out, {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}


def mesh_leg_cards(dev, smi: str):
    """(a) The mesh over the visible cards (``make_mesh()``): K1-K3 at
    1080p batch 16 equal ``Engine(device="cuda:0")`` bit for bit."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh()
    rows, total = [], {}
    for name, kw, counter in MESH_STENCILS:
        x = _mesh_frames(MAIN_SHAPE, 15)
        one = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), device=dev)
        eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), mesh=m)
        want = one.submit(x).fetch().copy()
        eng.compile(MAIN_SHAPE)  # its warm-up and calibration launches
        got, delta = _launch_delta(lambda: eng.submit(x).fetch().copy())
        if not np.array_equal(got, want):
            raise AssertionError(f"mesh (a) {name}: make_mesh() engine differs "
                                 f"from cuda:0")
        if delta[counter] != 1:
            raise AssertionError(f"mesh (a) {name}: {counter} launched "
                                 f"{delta[counter]} times, want 1")
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
        ms_one, ms_mesh = _engine_ms(one, x), _engine_ms(eng, x)
        fps_one = MAIN_SHAPE[0] / ms_one * 1e3
        fps_mesh = MAIN_SHAPE[0] / ms_mesh * 1e3
        log(f"mesh (a) {name} {MAIN_SHAPE} over make_mesh() "
            f"({m.shape}, {len(m.distinct_devices())} card): bit-exact vs "
            f"cuda:0; fps {fps_mesh:.1f} (mesh) vs {fps_one:.1f} (cuda:0), "
            f"submit+fetch; {smi}")
        rows.append(dict(leg="a_visible_cards", filter=name, mesh=m.shape,
                         shape=list(MAIN_SHAPE), bit_exact=True,
                         fps_mesh=fps_mesh, fps_device=fps_one,
                         ms_mesh=ms_mesh, ms_device=ms_one, card=smi))
        del one, eng
        torch.cuda.empty_cache()
    return rows, total


def mesh_leg_virtual(dev, smi: str):
    """(b) Virtual meshes on the one card: ``data=2, space=4`` and
    ``space=8`` over ``[cuda:0] * 8`` for K1-K3, bit-exact against the
    unsharded engine, one launch per block per batch; ms per batch of
    the step against the unsharded engine (the cost of the mechanism,
    not a scaling figure)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    rows, total = [], {}
    x = _mesh_frames(MAIN_SHAPE, 16)
    for name, kw, counter in MESH_STENCILS:
        one = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), device=dev)
        want = one.submit(x).fetch().copy()
        ms_one = _resident_ms(one, x)
        for cfg in (MeshConfig(data=2, space=4), MeshConfig(space=8)):
            m = make_mesh(cfg, devices=[dev] * 8)
            eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), mesh=m)
            eng.compile(MAIN_SHAPE)
            blocks = len(eng.input_sharding.shards(MAIN_SHAPE))
            got, delta = _launch_delta(lambda: eng.submit(x).fetch().copy())
            if not eng._exec_filter.name.startswith("spatial("):
                raise AssertionError(f"mesh (b) {name} {m.shape}: not routed "
                                     f"through the halo ({eng._exec_filter.name})")
            if delta[counter] != blocks or blocks != 8:
                raise AssertionError(f"mesh (b) {name} {m.shape}: {counter} "
                                     f"launched {delta[counter]} times for "
                                     f"{blocks} blocks")
            n_diff = int((got != want).sum())
            if n_diff:
                raise AssertionError(f"mesh (b) {name} {m.shape}: {n_diff} "
                                     f"values differ from the unsharded engine")
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
            ms_mesh = _resident_ms(eng, x)
            log(f"mesh (b) {name} {MAIN_SHAPE} over {m.shape} of cuda:0 x8: "
                f"bit-exact, {delta[counter]} {counter} launches per batch "
                f"({blocks} blocks); step {ms_mesh:.3f} ms per batch vs "
                f"{ms_one:.3f} ms unsharded (x{ms_mesh / ms_one:.2f}); {smi}")
            rows.append(dict(leg="b_virtual", filter=name, mesh=m.shape,
                             shape=list(MAIN_SHAPE), bit_exact=True,
                             launches_per_batch=delta[counter], blocks=blocks,
                             step_ms_mesh=ms_mesh, step_ms_device=ms_one,
                             card=smi))
            del eng
            torch.cuda.empty_cache()
        del one
    return rows, total


def mesh_leg_stateful(dev, smi: str):
    """(c) ema_smooth keeps H sharded on ``data=2, space=4`` (<= 1 LSB
    from one device); flow_warp at 720p batch 4 runs per data block with
    H whole, bit-exact, K4 once per data block."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    rows, total = [], {}
    m = make_mesh(MeshConfig(data=2, space=4), devices=[dev] * 8)
    one = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("ema_smooth"), device=dev)
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("ema_smooth"), mesh=m)
    eng.compile(MAIN_SHAPE)
    if tuple(eng.input_sharding.spec[:2]) != ("data", "space"):
        raise AssertionError(f"mesh (c) ema_smooth: H not sharded "
                             f"({eng.input_sharding.spec})")
    worst = 0
    for seed in range(3):
        x = _mesh_frames(MAIN_SHAPE, 20 + seed)
        worst = max(worst, max_lsb(eng.submit(x).fetch(), one.submit(x).fetch()))
    if worst > 1:
        raise AssertionError(f"mesh (c) ema_smooth: {worst} LSB from one device")
    log(f"mesh (c) ema_smooth {MAIN_SHAPE} over {m.shape}: H sharded "
        f"({eng.input_sharding.spec}), max {worst} LSB from one device over "
        f"3 batches; {smi}")
    rows.append(dict(leg="c_ema_smooth", mesh=m.shape, shape=list(MAIN_SHAPE),
                     spec=[str(s) for s in eng.input_sharding.spec],
                     max_lsb=worst, card=smi))
    del one, eng
    torch.cuda.empty_cache()
    one = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("flow_warp"), device=dev)
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("flow_warp"), mesh=m)
    eng.compile(FLOW_SHAPE)
    spec = eng.input_sharding.spec
    if spec[1] is not None:
        raise AssertionError(f"mesh (c) flow_warp: H sharded ({spec})")
    blocks = len(eng.input_sharding.shards(FLOW_SHAPE))
    base = _mesh_frames(FLOW_SHAPE, 30)
    for k in range(3):  # the pass-through batch, then warped ones
        x = np.roll(base, 3 * k, axis=2)
        want = one.submit(x).fetch().copy()
        got, delta = _launch_delta(lambda: eng.submit(x).fetch().copy())
        n_diff = int((got != want).sum())
        if n_diff:
            raise AssertionError(f"mesh (c) flow_warp batch {k}: {n_diff} "
                                 f"values differ from one device")
        if delta["warp_bounded"] != blocks:
            raise AssertionError(f"mesh (c) flow_warp: K4 launched "
                                 f"{delta['warp_bounded']} times for {blocks} "
                                 f"data blocks")
        for kk, v in delta.items():
            total[kk] = total.get(kk, 0) + v
    log(f"mesh (c) flow_warp {FLOW_SHAPE} over {m.shape}: layout {spec} "
        f"({blocks} data blocks, H whole), bit-exact over 3 batches, "
        f"warp_bounded {blocks} launches per batch; {smi}")
    rows.append(dict(leg="c_flow_warp", mesh=m.shape, shape=list(FLOW_SHAPE),
                     spec=[str(s) for s in spec], bit_exact=True,
                     launches_per_batch=blocks, card=smi))
    del one, eng
    torch.cuda.empty_cache()
    return rows, total


def mesh_leg_equalize(dev, smi: str):
    """(d) equalize on ``space=4``: per-block counts, one sum per frame,
    bit-exact."""
    import dvf_tpu_torch
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    m = make_mesh(MeshConfig(space=4), devices=[dev] * 4)
    x = _mesh_frames(MAIN_SHAPE, 40)
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("equalize"), mesh=m)
    got = eng.submit(x).fetch().copy()
    want = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("equalize"),
                                device=dev).submit(x).fetch()
    if not eng._exec_filter.name.startswith("space("):
        raise AssertionError(f"mesh (d) equalize: {eng._exec_filter.name}")
    n_diff = int((got != want).sum())
    if n_diff:
        raise AssertionError(f"mesh (d) equalize: {n_diff} values differ")
    log(f"mesh (d) equalize {MAIN_SHAPE} over {m.shape}: bit-exact; {smi}")
    return [dict(leg="d_equalize", mesh=m.shape, shape=list(MAIN_SHAPE),
                 bit_exact=True, card=smi)], {}


def _level_stats(got: np.ndarray, want: np.ndarray) -> dict:
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return dict(max=int(d.max()), mean=float(d.mean()),
                share_over_1=float((d > 1).mean()), share_over_3=float((d > 3).mean()))


def mesh_leg_nets(dev, smi: str):
    """(e) The style net (c 32, r 5) at 720p batch 8 with TP on
    ``model=2`` and PP on ``model=5``, and ESPCN x2 TP on ``model=2`` at
    540p batch 8, on ``[cuda:0] * n``, against the unsharded net. In
    float32 within the bars tests/test_models.py and tests/test_pp.py pin
    (3 levels for TP, 1 for PP); at those tests' own sizes in bfloat16
    within the same bars. At full width in bfloat16 a net re-scheduled in
    any way (PP changes only its microbatch sizes) drifts by a few
    levels, so there it is held to the bar the repo holds bfloat16 nets
    to (mean |d| < 2.0, max <= 30, the goldens' bar) and its spread is
    logged. The sharded batch's launches: instance_norm (csrc/norm.cu)
    STYLE_NORMS times a TP rank; for PP the 5 norms outside the trunk
    once and the trunk's 2 r in each microbatch (4 here), and in bf16 at
    c 32 the out stage (csrc/outconv.cu) once on stage 0; the TP body's
    row-parallel out conv keeps the plain ops; no other kernel. Returns
    (rows, those launch counts summed)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    rows, total = [], {}
    small = {"base_channels": 8, "n_residual": 2}
    tp = {"instance_norm": 2 * STYLE_NORMS}
    pp = {"instance_norm": 5 + 2 * 5 * 4}
    legs = [  # name, kwargs, shape, model ranks, body, bar, timed, launches
        ("style_transfer", {"parallel": "tp"}, STYLE_SHAPE, 2, "tp(", None, True, tp),
        ("style_transfer", {"parallel": "pp"}, STYLE_SHAPE, 5, "pp(", None, True,
         {**pp, "out_conv": 1}),
        ("super_resolution", {}, SR_SHAPE, 2, "tp(", None, True, {}),
        ("style_transfer", {"parallel": "tp", "dtype": "float32"}, STYLE_SHAPE, 2,
         "tp(", 3, False, tp),
        ("style_transfer", {"parallel": "pp", "dtype": "float32"}, STYLE_SHAPE, 5,
         "pp(", 1, False, pp),
        ("super_resolution", {"dtype": "float32"}, SR_SHAPE, 2, "tp(", 3, False, {}),
        ("style_transfer", {"parallel": "tp", **small}, (2, 32, 32, 3), 2, "tp(", 3,
         False, {"instance_norm": 2 * (3 + 2 * 2 + 2)}),
        ("style_transfer", {"parallel": "pp", "base_channels": 8, "n_residual": 4},
         (4, 32, 32, 3), 4, "pp(", 1, False, {"instance_norm": 5 + 2 * 4 * 4}),
    ]
    for name, kw, shape, n, prefix, bar, timed, launches in legs:
        x = _mesh_frames(shape, 50)
        one = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), device=dev)
        want = one.submit(x).fetch().copy()
        ms_one = _resident_ms(one, x, reps=2) if timed else None
        del one
        m = make_mesh(MeshConfig(model=n), devices=[dev] * n)
        eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), mesh=m)
        eng.compile(shape)
        if not eng._exec_filter.name.startswith(prefix):
            raise AssertionError(f"mesh (e) {name}: body {eng._exec_filter.name}")
        got, delta = _launch_delta(lambda: eng.submit(x).fetch().copy())
        if delta != {k: launches.get(k, 0) for k in delta}:
            raise AssertionError(f"mesh (e) {eng._exec_filter.name} {shape}: launches "
                                 f"{delta}, want {launches} and no other")
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
        st = _level_stats(got, want)
        label = f"{eng._exec_filter.name} {kw.get('dtype', 'bfloat16')} {shape}"
        if bar is not None:
            held = st["max"] <= bar
            what = f"bar max <= {bar}"
        else:
            held = st["mean"] < 2.0 and st["max"] <= 30
            what = "bf16 nets' bar mean < 2.0, max <= 30"
        if not held:
            raise AssertionError(f"mesh (e) {label}: {st} outside the {what}")
        ms_mesh = _resident_ms(eng, x, reps=2) if timed else None
        log(f"mesh (e) {label} over {m.shape} of cuda:0 x{n}: from the "
            f"unsharded net max {st['max']} levels, mean {st['mean']:.4f}, "
            f"share > 1: {st['share_over_1']:.5f}, > 3: {st['share_over_3']:.5f} "
            f"({what})"
            + (f"; step {ms_mesh:.2f} ms per batch vs {ms_one:.2f} ms unsharded"
               if timed else "") + f"; {smi}")
        rows.append(dict(leg="e_nets", filter=eng._exec_filter.name,
                         dtype=kw.get("dtype", "bfloat16"), mesh=m.shape,
                         shape=list(shape), levels=st, bar=bar, launches=delta,
                         step_ms_mesh=ms_mesh, step_ms_device=ms_one, card=smi))
        del eng
        torch.cuda.empty_cache()
    return rows, total


def mesh_leg_cli(dev, smi: str):
    """(f) The command line and the fleet: ``serve --mesh data=1`` and
    ``bench --mesh auto`` run; ``serve --mesh data=2`` on one card exits 2
    saying it needs 2 devices and has 1; a 2-replica local fleet with
    ``devices_per_replica=0`` puts both replicas on cuda:0 and delivers
    every frame."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend
    from dvf_tpu_torch.serve import ServeConfig

    rows, total = [], {}
    _, delta = _launch_delta(lambda: _cli_json("mesh serve", [
        "serve", "--filter", "gaussian_blur", "--filter-config", '{"ksize": 9}',
        "--source", "synthetic", "--height", "1080", "--width", "1920",
        "--frames", "64", "--batch", "16", "--frame-delay", "0", "--quiet",
        "--mesh", "data=1"]))
    if delta["sep_blur"] < 4:
        raise AssertionError(f"mesh (f) serve --mesh data=1: {delta}")
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v
    out, delta = _launch_delta(lambda: _cli_json("mesh bench", [
        "bench", "--config", "gauss9_1080p", "--iters", "5", "--mesh", "auto"]))
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v
    log(f"mesh (f) serve --mesh data=1 and bench --mesh auto ran "
        f"(bench {out['value']} {out['unit']}); {smi}")
    r = subprocess.run([sys.executable, "-m", "dvf_tpu_torch", "serve",
                        "--filter", "invert", "--height", "16", "--width", "16",
                        "--frames", "4", "--mesh", "data=2"],
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    if torch.cuda.device_count() == 1 and not (
            r.returncode == 2 and "needs 2 devices, have 1" in r.stderr):
        raise AssertionError(f"mesh (f) serve --mesh data=2: rc {r.returncode}, "
                             f"stderr {r.stderr[-500:]}")
    log(f"mesh (f) serve --mesh data=2 on {torch.cuda.device_count()} card(s): "
        f"rc {r.returncode}: {r.stderr.strip().splitlines()[-1]}")
    fleet = FleetFrontend(dvf_tpu_torch.get_filter("gaussian_blur", ksize=9),
                          FleetConfig(replicas=2, mode="local",
                                      devices_per_replica=0,
                                      serve=ServeConfig(batch_size=4,
                                                        queue_size=1000,
                                                        out_queue_size=1000,
                                                        slo_ms=60_000.0)))
    shape = (270, 480, 3)
    bases = serve_bases(shape, 2, 60)
    with fleet:
        meshes = {rid: str(list(r.frontend.engine.mesh.devices.flat))
                  for rid, r in fleet._replicas.items()}
        if set(meshes.values()) != {"[device(type='cuda', index=0)]"}:
            raise AssertionError(f"mesh (f) fleet: replicas on {meshes}")
        sids = {fleet.open_stream(frame_shape=shape): b for b in bases}
        (got, wall, _, _), delta = _launch_delta(
            lambda: fleet_drive(fleet, sids, range(16)))
        replicas = {fleet.stats()["sessions"][s]["replica"] for s in sids}
    for sid, base in sids.items():
        if [d.index for d in got[sid]] != list(range(16)):
            raise AssertionError(f"mesh (f) fleet: session {sid} got "
                                 f"{[d.index for d in got[sid]]}")
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v
    log(f"mesh (f) fleet: 2 local replicas with devices_per_replica=0 over "
        f"{meshes}, sessions on {sorted(replicas)}, 2 x 16 frames delivered in "
        f"{wall:.2f} s; {smi}")
    rows.append(dict(leg="f_cli_fleet", bench=out, serve_mesh_data2_rc=r.returncode,
                     fleet_replica_meshes=meshes, delivered=32, card=smi))
    return rows, total


def mesh_phase(dev):
    """Phase 15: legs (a)-(f) of the in-host mesh. Returns (rows, the
    summed launch counts of the counted runs)."""
    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi()
    log(f"mesh phase on {smi}")
    rows, total = [], {}
    for leg in (mesh_leg_cards, mesh_leg_virtual, mesh_leg_stateful,
                mesh_leg_equalize, mesh_leg_nets, mesh_leg_cli):
        t = time.perf_counter()
        new, delta = leg(dev, smi)
        for row in new:
            row["wall_s"] = time.perf_counter() - t
        rows.extend(new)
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
        log(f"mesh leg {leg.__name__}: {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total


def mesh_only() -> None:
    """The build and phase 15 alone (the in-host mesh):
    ``python3 -c 'import chip_smoke; chip_smoke.mesh_only()'``."""
    dev, _, _ = _only_setup()
    rows, _ = mesh_phase(dev)
    print(json.dumps({"mesh": rows}))


# ---------------------------------------------------------------------------
# Phase 16: the multi-process runtime (a 2-rank gloo group on the one card:
# MultiHostEngine with K1/K3 in each rank, the elastic kill, the fleet's
# multi-host replica) and the worker over a sharded batch (K5/K6 per block)
# ---------------------------------------------------------------------------

MP_RANKS = 2
MP_REPS = 5
MP_FILTERS = [("gaussian_blur", {"ksize": 9}, "sep_blur"),
              ("sobel_bilateral", {}, "sobel_bilateral")]
MP_KILL_STEPS, MP_KILL_AT = 8, 3
MP_FLEET_FRAMES = 32
MP_FLEET_CHAINS = [("invert", {}, "invert"),
                   ("gaussian_blur", {"ksize": 9}, "gaussian_blur(ksize=9)")]
MP_WORKER_MESHES = [{"data": 2}, {"data": 2, "space": 2}]
MP_TIMEOUT_S = 300


def _digests(rows) -> list:
    import hashlib

    return [hashlib.sha256(np.ascontiguousarray(r).tobytes()).hexdigest()[:16]
            for r in rows]


@functools.lru_cache(maxsize=1)
def _kill_base() -> np.ndarray:
    return _mesh_frames(MAIN_SHAPE, 160)


def _kill_frames(step: int) -> np.ndarray:
    """The global batch of the kill leg's step ``step`` (every rank
    derives the same frames)."""
    return np.roll(_kill_base(), step, axis=0)


def _rank_engine(rank: int) -> dict:
    """Leg (a) in one rank: MultiHostEngine per filter at the global
    MAIN_SHAPE batch, this rank's rows; the launch counts of one counted
    batch, its rows' digests, then ms per step and the lockstep
    all_reduce's ms."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.fleet.multiproc import MultiHostEngine
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.parallel.mesh import MeshConfig

    x = _mesh_frames(MAIN_SHAPE, 16)
    out = {}
    for name, kw, counter in MP_FILTERS:
        eng = MultiHostEngine(dvf_tpu_torch.get_filter(name, **kw),
                              MeshConfig(data=MP_RANKS))
        eng.compile(MAIN_SHAPE)
        rows = np.concatenate([x[a:b] for a, b in eng.intervals[rank]])
        torch.cuda.synchronize()
        tk.reset_launches()
        got = eng.submit_local(rows)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        ms, ar = [], []
        for _ in range(MP_REPS):
            t0 = time.perf_counter()
            eng.submit_local(rows)
            ms.append((time.perf_counter() - t0) * 1e3)
            ar.append(eng.last_all_reduce_ms)
        out[name] = dict(device=str(eng.device), intervals=eng.intervals[rank],
                         launches=launches, digests=_digests(got),
                         ms_per_step=ms, all_reduce_ms=ar)
        del eng
        torch.cuda.empty_cache()
    return out


def _rank_kill(rank: int, tmp: str) -> dict:
    """Leg (b) in one rank: an ElasticMeshRunner whose step is the uint8
    gaussian_blur(ksize=9) step per block and a lockstep all_reduce; rank
    1 exits at step MP_KILL_AT (its wall clock written first), rank 0
    degrades and carries on. Returns rank 0's row digests per step and
    the detection time."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.parallel.distributed import (
        ElasticMeshRunner, all_reduce, local_output_rows)
    from dvf_tpu_torch.parallel.mesh import MeshConfig
    from dvf_tpu_torch.runtime.engine import _build_step

    filt = dvf_tpu_torch.get_filter("gaussian_blur", ksize=9)
    dev = torch.device("cuda", rank % torch.cuda.device_count())

    def builder(mesh):
        step = _build_step(filt, True)

        def run(batch, state):
            out = batch.map(lambda t: step(t, None)[0])
            met = all_reduce(torch.ones(1, device=dev), mesh)
            return out, {"count": state["count"] + 1, "met": met}
        return run

    class Runner(ElasticMeshRunner):
        t_detect = None

        def _degrade(self):
            self.t_detect = time.time()
            super()._degrade()

    state0 = {"count": torch.zeros((), dtype=torch.int32), "met": torch.zeros(1)}
    runner = Runner(builder, state0, MeshConfig(data=MP_RANKS))
    digests, shapes, ms = {}, {}, {}
    rows_of = MAIN_SHAPE[0] // MP_RANKS
    for i in range(MP_KILL_STEPS):
        if rank == 1 and i == MP_KILL_AT:
            with open(os.path.join(tmp, "victim_exit"), "w") as f:
                f.write(repr(time.time()))
            sys.stdout.flush()
            os._exit(42)
        local = np.ascontiguousarray(
            _kill_frames(i)[rank * rows_of:(rank + 1) * rows_of])
        t0 = time.perf_counter()
        out = runner.submit_local(local)
        rows = local_output_rows(out)
        ms[i] = (time.perf_counter() - t0) * 1e3
        digests[i] = _digests(rows)
        shapes[i] = list(out.shape)
    with open(os.path.join(tmp, "victim_exit")) as f:
        t_exit = float(f.read())
    return dict(degraded=runner.degraded, dropped_on_loss=runner.dropped_on_loss,
                count=int(runner.state["count"]), digests=digests, shapes=shapes,
                ms=ms, detect_ms=(runner.t_detect - t_exit) * 1e3)


def mp_rank(argv) -> int:
    """One rank of phase 16's group: ``python3 -c 'import chip_smoke, sys;
    sys.exit(chip_smoke.mp_rank(sys.argv[1:]))' LEG RANK PORT TMP``. It
    joins the gloo group on ``cuda:{rank % device_count}`` and prints its
    result as one JSON line; it ends with ``os._exit`` (a group with a
    dead peer can hang in its shutdown)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dvf_tpu_torch.parallel.distributed import init_distributed

    leg, rank, port, tmp = argv[0], int(argv[1]), argv[2], argv[3]
    if not torch.cuda.is_available():
        print("mp_rank: no CUDA device is available", file=sys.stderr)
        return 2
    init_distributed(f"127.0.0.1:{port}", MP_RANKS, rank)
    res = _rank_engine(rank) if leg == "engine" else _rank_kill(rank, tmp)
    print(json.dumps(res), flush=True)
    sys.stdout.flush()
    os._exit(0)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(leg: str, tmp: str) -> list:
    """Start MP_RANKS ranks of ``leg`` together; returns [(rc, stdout,
    stderr)] in rank order. Every rank is killed on the way out."""
    root = os.path.dirname(os.path.abspath(__file__))
    port = str(_free_port())
    code = "import chip_smoke, sys; sys.exit(chip_smoke.mp_rank(sys.argv[1:]))"
    procs = [subprocess.Popen([sys.executable, "-c", code, leg, str(r), port, tmp],
                              cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, close_fds=False)
             for r in range(MP_RANKS)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=MP_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _rank_json(label: str, rc: int, out: str, err: str) -> dict:
    if rc != 0:
        raise AssertionError(f"{label}: exit {rc}:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def mp_leg_engine(dev, smi: str, tmp: str):
    """(a) A 2-rank gloo group on the card (both ranks on cuda:0): the
    multi-process engine with gaussian_blur(ksize=9) and sobel_bilateral
    at the global 16×1080×1920×3 batch, 8 rows per rank; every rank's
    rows bit-exact to the single-process Engine, K1/K3 once per rank per
    batch; ms per step and the lockstep all_reduce's ms."""
    import dvf_tpu_torch

    t = time.perf_counter()
    res = [_rank_json(f"multiproc (a) rank {r}", *o)
           for r, o in enumerate(_run_ranks("engine", tmp))]
    wall = time.perf_counter() - t
    x = _mesh_frames(MAIN_SHAPE, 16)
    rows, total = [], {}
    for name, kw, counter in MP_FILTERS:
        want = _digests(dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw),
                                             device=dev).submit(x).fetch())
        for r, got in enumerate(res):
            g = got[name]
            exp = [d for a, b in g["intervals"] for d in want[a:b]]
            if g["digests"] != exp:
                raise AssertionError(f"multiproc (a) {name} rank {r}: rows differ "
                                     f"from the single-process engine")
            if g["launches"][counter] != 1 or sum(g["launches"].values()) != 1:
                raise AssertionError(f"multiproc (a) {name} rank {r}: launches "
                                     f"{g['launches']}, want {counter} once")
            for k, v in g["launches"].items():
                total[k] = total.get(k, 0) + v
            log(f"multiproc (a) {name} {MAIN_SHAPE} rank {r} of {MP_RANKS} on "
                f"{g['device']} (gloo), rows {g['intervals']}: bit-exact vs one "
                f"process; {counter} once per rank per batch; ms per step "
                f"(submit_local: H2D, step, all_reduce, D2H of "
                f"{MAIN_SHAPE[0] // MP_RANKS} frames) "
                f"{[round(v, 3) for v in g['ms_per_step']]}, all_reduce ms "
                f"{[v if v is None else round(v, 4) for v in g['all_reduce_ms']]}; {smi}")
            rows.append(dict(leg="a_multihost_engine", filter=name, rank=r,
                             ranks=MP_RANKS, shape=list(MAIN_SHAPE),
                             rows=g["intervals"], bit_exact=True,
                             launches=g["launches"], ms_per_step=g["ms_per_step"],
                             all_reduce_ms=g["all_reduce_ms"], card=smi))
    log(f"multiproc (a): {wall:.1f} s wall (two rank processes, start-up included)")
    return rows, total


def mp_leg_kill(dev, smi: str, tmp: str):
    """(b) The elastic kill at 1080p: rank 1 exits at step 3 of 8; rank 0
    detects the peer loss, degrades to its local mesh, re-runs the batch
    and carries on; its rows after the loss equal a single-process run
    of the same frames; the time from the victim's exit to the
    survivor's degrade."""
    import dvf_tpu_torch

    outs = _run_ranks("kill", tmp)
    if outs[1][0] != 42:
        raise AssertionError(f"multiproc (b): the victim exited {outs[1][0]}:\n"
                             f"{outs[1][2][-2000:]}")
    g = _rank_json("multiproc (b) survivor", *outs[0])
    if not (g["degraded"] and g["dropped_on_loss"] == 1
            and g["count"] == MP_KILL_STEPS):
        raise AssertionError(f"multiproc (b): survivor {g['degraded']=}, "
                             f"{g['dropped_on_loss']=}, {g['count']=}")
    rows_of = MAIN_SHAPE[0] // MP_RANKS
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("gaussian_blur", ksize=9),
                               device=dev)
    for i in range(MP_KILL_STEPS):
        want = _digests(eng.submit(np.ascontiguousarray(
            _kill_frames(i)[:rows_of])).fetch())
        if g["digests"][str(i)] != want:
            raise AssertionError(f"multiproc (b): survivor's rows at step {i} "
                                 f"differ from one process")
        shape = [MAIN_SHAPE[0] if i < MP_KILL_AT else rows_of, *MAIN_SHAPE[1:]]
        if g["shapes"][str(i)] != shape:
            raise AssertionError(f"multiproc (b): step {i} global shape "
                                 f"{g['shapes'][str(i)]}, want {shape}")
    _kill_base.cache_clear()
    log(f"multiproc (b) elastic kill at {MAIN_SHAPE}: rank 1 exited at step "
        f"{MP_KILL_AT}; rank 0 degraded (dropped_on_loss 1, count "
        f"{g['count']}), its rows at every step bit-exact vs one process; "
        f"time to detect (victim exit to degrade) {g['detect_ms']:.1f} ms; ms per "
        f"step {json.dumps({k: round(v, 2) for k, v in g['ms'].items()})}; {smi}")
    return [dict(leg="b_elastic_kill", shape=list(MAIN_SHAPE), kill_at=MP_KILL_AT,
                 degraded=True, count=g["count"], detect_ms=g["detect_ms"],
                 ms_per_step=g["ms"], bit_exact=True, card=smi)], {}


def mp_leg_fleet(dev, smi: str):
    """(c) FleetFrontend(multihost_hosts=2) at 1080p: spawn the multi-host
    replica, 32 frames of invert and of gaussian_blur(ksize=9) through it,
    bit-exact and in order; retire drains the session back to r0;
    spawn-to-ready ms."""
    import dvf_tpu_torch
    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend, MultiHostReplica
    from dvf_tpu_torch.serve import ServeConfig

    h, w = MAIN_SHAPE[1:3]
    frames = list(_mesh_frames((MP_FLEET_FRAMES, h, w, 3), 17))
    rows = []
    for name, kw, chain in MP_FLEET_CHAINS:
        filt = dvf_tpu_torch.get_filter(name, **kw)
        one = dvf_tpu_torch.Engine(filt, device=dev)
        want = np.concatenate([one.submit(np.stack(frames[s:s + 16])).fetch()
                               for s in range(0, MP_FLEET_FRAMES, 16)])
        manifest = [{"op_chain": chain, "frame_shape": [h, w, 3], "dtype": "u8"}]
        fleet = FleetFrontend(filt, FleetConfig(
            replicas=1, mode="local", multihost_hosts=MP_RANKS, precompile=manifest,
            serve=ServeConfig(batch_size=MAIN_SHAPE[0], queue_size=64,
                              out_queue_size=64, slo_ms=60_000.0, max_sessions=8),
            drain_timeout_s=60.0, startup_timeout_s=MP_TIMEOUT_S), device=dev)
        with fleet:
            fleet.open_stream(op_chain=chain, frame_shape=(h, w, 3))
            t0 = time.perf_counter()
            rid = fleet.spawn_replica(flavor="multihost")
            spawn_ms = (time.perf_counter() - t0) * 1e3
            if not isinstance(fleet._replicas[rid], MultiHostReplica):
                raise AssertionError(f"multiproc (c) {chain}: {rid} is not the "
                                     f"multi-host flavor")
            sid = fleet.open_stream(op_chain=chain, frame_shape=(h, w, 3),
                                    frame_dtype="u8")
            if fleet.stats()["sessions"][sid]["replica"] != rid:
                raise AssertionError(f"multiproc (c) {chain}: the session did "
                                     f"not route to the group")
            t0 = time.perf_counter()
            for f in frames:
                fleet.submit(sid, f)
            got = []
            deadline = time.time() + MP_TIMEOUT_S
            while len(got) < MP_FLEET_FRAMES and time.time() < deadline:
                got.extend(fleet.poll(sid))
                time.sleep(0.005)
            serve_s = time.perf_counter() - t0
            if [d.index for d in got] != list(range(MP_FLEET_FRAMES)):
                raise AssertionError(f"multiproc (c) {chain}: delivered "
                                     f"{[d.index for d in got]}")
            n_diff = sum(not np.array_equal(d.frame, want[d.index]) for d in got)
            if n_diff:
                raise AssertionError(f"multiproc (c) {chain}: {n_diff} frames "
                                     f"differ from one process")
            engine_frames = fleet.stats()["replicas"][rid]["engine_frames"]
            if not fleet.retire_replica(rid):
                raise AssertionError(f"multiproc (c) {chain}: retire refused")
            for f in frames[:4]:
                fleet.submit(sid, f)
            after = []
            deadline = time.time() + MP_TIMEOUT_S
            while len(after) < 4 and time.time() < deadline:
                after.extend(fleet.poll(sid))
                time.sleep(0.005)
            st = fleet.stats()
        idx = [d.index for d in got + after]
        if (len(after) != 4 or idx != sorted(set(idx)) or st["order_violations"]
                or rid in st["replicas"]
                or not all(np.array_equal(d.frame, want[k])
                           for k, d in enumerate(after))):
            raise AssertionError(f"multiproc (c) {chain}: after retire: indices "
                                 f"{[d.index for d in after]}, order violations "
                                 f"{st['order_violations']}")
        log(f"multiproc (c) fleet multihost_hosts={MP_RANKS} {chain} at "
            f"{h}x{w}: spawn-to-ready {spawn_ms:.1f} ms; {MP_FLEET_FRAMES} of "
            f"{MP_FLEET_FRAMES} frames in order and bit-exact vs one process in "
            f"{serve_s:.2f} s ({MP_FLEET_FRAMES / serve_s:.1f} fps through the "
            f"RPC, group engine_frames {engine_frames}); retire drained the "
            f"session to r0 (4 more frames, bit-exact); {smi}")
        rows.append(dict(leg="c_fleet_multihost", chain=chain, geometry=[h, w, 3],
                         hosts=MP_RANKS, spawn_to_ready_ms=spawn_ms,
                         frames=MP_FLEET_FRAMES, delivered=MP_FLEET_FRAMES,
                         in_order=True, bit_exact=True, fps=MP_FLEET_FRAMES / serve_s,
                         retired_to_r0=True, card=smi))
    return rows, {}


def mp_leg_worker(dev, smi: str, have_jpeg: bool):
    """(d) The delta-wire worker over [cuda:0]*2 meshes (data=2; data=2,
    space=2) at 512² batch 8, 160 frames: the probe on the raw-inner
    wire (and the full transform on the JPEG wire where libjpeg is) with
    payloads byte-identical to the one-device worker, and Engine →
    FusedDeltaTransform with bitmaps and coefficient blocks identical;
    K5 and K6 once per block per batch."""
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    frames = wire_frames()
    nb = len(frames) // WIRE_BATCH
    legs = [("probe", "raw")] + ([("full", "jpeg")] if have_jpeg else [])
    rows, total, per_block = [], {}, {}
    for assist, inner in legs:
        enc = _delta_codec(inner)
        try:
            blobs = [enc.encode(f) for f in frames]
        finally:
            enc.close()
        one, _, _ = _run_worker(dev, blobs, assist, inner)
        for axes in MP_WORKER_MESHES:
            m = make_mesh(MeshConfig(**axes), devices=[dev] * int(np.prod(list(axes.values()))))
            blocks = m.size
            label = f"worker(delta/{inner}, {assist}) over {axes}"
            tk.reset_launches()
            sent, stats, secs = _run_worker(dev, blobs, assist, inner, mesh=m)
            delta = dict(tk.LAUNCHES)
            want = {k: 0 for k in delta}
            want["tile_maxdiff"] = nb * blocks
            if assist == "full":
                want["dct8x8_quant"] = nb * blocks
            if delta != want:
                raise AssertionError(f"{label}: launches {delta}, want {want}")
            if sent != one:
                raise AssertionError(f"{label}: payloads differ from the "
                                     f"one-device worker")
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
            per_block[f"{assist}/{','.join(f'{k}={v}' for k, v in axes.items())}"] = dict(
                blocks=blocks, batches=nb, launches=delta)
            log(f"multiproc (d) {label}: {len(frames)} frames, payloads "
                f"byte-identical to the one-device worker; launches {delta} "
                f"({blocks} blocks x {nb} batches); {len(frames) / secs:.1f} fps; {smi}")
            rows.append(dict(leg="d_worker_mesh", assist=assist, inner=inner,
                             mesh=axes, blocks=blocks, frames=len(frames),
                             launches=delta, payloads_differing=0,
                             fps=len(frames) / secs, card=smi))
    ref = _fused_pass(dev, frames)
    for axes in MP_WORKER_MESHES:
        m = make_mesh(MeshConfig(**axes), devices=[dev] * int(np.prod(list(axes.values()))))
        blocks = m.size
        label = f"engine(invert) -> FusedDeltaTransform over {axes}"
        tk.reset_launches()
        bms, dirty, first, _, secs, _, calls = _fused_pass(dev, frames, mesh=m)
        delta = dict(tk.LAUNCHES)
        want = {k: 0 for k in delta}
        want.update(tile_maxdiff=nb * blocks, dct8x8_quant=nb * blocks)
        if delta != want or calls != nb:
            raise AssertionError(f"{label}: launches {delta} in {calls} calls, "
                                 f"want {want}")
        same = (np.array_equal(bms, ref[0])
                and all(np.array_equal(a, b) for a, b in zip(first, ref[2]))
                and all(np.array_equal(a, b) for f, g in zip(dirty, ref[1])
                        for a, b in zip(f, g)))
        if not same:
            raise AssertionError(f"{label}: bitmaps or coefficient blocks differ "
                                 f"from the one-device transform")
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v
        per_block[f"fused/{','.join(f'{k}={v}' for k, v in axes.items())}"] = dict(
            blocks=blocks, batches=nb, launches=delta)
        log(f"multiproc (d) {label}: bitmaps and coefficient blocks identical to "
            f"one device; launches {delta} ({blocks} blocks x {nb} batches); "
            f"{len(frames) / secs:.1f} fps; {smi}")
        rows.append(dict(leg="d_fused_mesh", mesh=axes, blocks=blocks,
                         frames=len(frames), launches=delta, blocks_differing=0,
                         fps=len(frames) / secs, card=smi))
    return rows, total, per_block


def multiproc_phase(dev, have_jpeg: bool):
    """Phase 16: legs (a)-(d). Returns (rows, the summed launch counts of
    the counted runs, K1/K3's launches in the ranks, K5/K6's per-block
    counts)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi()
    log(f"multiproc phase on {smi}")
    rows, total = [], {}
    with tempfile.TemporaryDirectory(prefix="dvf-mp-") as tmp:
        for leg in (mp_leg_engine, mp_leg_kill):
            t = time.perf_counter()
            new, delta = leg(dev, smi, tmp)
            rows.extend(new)
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
            log(f"multiproc leg {leg.__name__}: {time.perf_counter() - t:.1f} s")
    ranks = dict(total)
    t = time.perf_counter()
    new, _ = mp_leg_fleet(dev, smi)
    rows.extend(new)
    log(f"multiproc leg mp_leg_fleet: {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    new, delta, per_block = mp_leg_worker(dev, smi, have_jpeg)
    rows.extend(new)
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v
    log(f"multiproc leg mp_leg_worker: {time.perf_counter() - t:.1f} s")
    log(f"multiproc phase: {time.perf_counter() - t0:.1f} s, launches {total}")
    return rows, total, ranks, per_block


def multiproc_only() -> None:
    """The build and phase 16 alone (the multi-process runtime and the
    worker over a sharded batch):
    ``python3 -c 'import chip_smoke; chip_smoke.multiproc_only()'``."""
    dev, _, env = _only_setup()
    rows, _, ranks, per_block = multiproc_phase(dev, env["libjpeg"])
    print(json.dumps({"multiproc": rows, "rank_launches": ranks,
                      "per_block": per_block}))


# ---------------------------------------------------------------------------
# Phase 17: the sharded train state (style and ESPCN steps over virtual
# meshes of the card, resume onto the mesh, the dry run, the engine's
# all-card default, train as a process)
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 10                  # timed steps per leg, after one checked step
MESH_TRAIN_STYLE = (("data=2,space=2,model=2", dict(data=2, space=2, model=2)),
                    ("model=2", dict(model=2)))
MESH_TRAIN_SR = (("model=2", dict(model=2)), ("data=2", dict(data=2)))
DEFAULT_ENGINE_SHAPE = MAIN_SHAPE      # (e): gaussian_blur(ksize=9) at 16 x 1080p


def _mu_gap(one, sharded) -> dict:
    """Adam's first moment (0.1 x the gradient after one step) of a
    sharded state against the one-device state's: the largest relative L2
    over the leaves whose exact gradient is not zero, and the least and
    largest projection ratio <mu_sharded, mu_one> / |mu_one|^2 over the
    weight leaves (2.0 would be the reference's model-axis scaling)."""
    from dvf_tpu_torch.train import optim

    mu1 = optim.adam_state(one.opt_state, one.params)[1]
    mu2 = optim.adam_state(sharded.opt_state, sharded.params)[1]
    gaps = {k: float((mu1[k] - mu2[k]).float().norm() / mu1[k].float().norm())
            for k in mu1 if not _zero_grad_leaf(k)}
    ratios = {k: float((mu2[k] * mu1[k]).sum() / (mu1[k] * mu1[k]).sum())
              for k in mu1 if k.endswith("/w")}
    worst = max(gaps, key=gaps.get)
    return dict(mu_rel_l2_max=gaps[worst], mu_rel_l2_max_leaf=worst,
                w_ratio_min=min(ratios.values()), w_ratio_max=max(ratios.values()))


def _copies_identical(state) -> int:
    """Every copy of every block equal to its master bit for bit (raises
    otherwise); returns how many copies there are beyond the masters (0
    on a virtual mesh: one device holds each block once)."""
    import torch

    extra = 0
    for k, _, copies in state.params.each_block():
        if not all(torch.equal(copies[0], t) for t in copies[1:]):
            raise AssertionError(f"train_mesh: the copies of {k} differ")
        extra += len(copies) - 1
    return extra


def _mesh_train_leg(dev, smi: str, family: str, label: str, axes: dict, cfg,
                    base, batch, one_ms: float, one_first):
    """One family over one virtual mesh of the card: a checked first step
    (donate=False) against the one-device step, then MESH_TRAIN_STEPS
    timed steps (CUDA events)."""
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from dvf_tpu_torch.train import sr as tsr
    from dvf_tpu_torch.train import style as tst

    mod = tst if family == "style" else tsr
    mcfg = MeshConfig(**axes)
    mesh = make_mesh(mcfg, devices=[dev] * mcfg.n_devices)
    state = mod.shard_train_state(base, mesh, cfg)
    step = mod.make_train_step(mesh, cfg, state_template=state)
    first, m = mod.make_train_step(mesh, cfg, state_template=state, donate=False)(state, batch)
    one_state, one_m = one_first
    loss, one_loss = float(m["loss"]), float(one_m["loss"])
    rel = abs(loss - one_loss) / abs(one_loss)
    gap = _mu_gap(one_state, first)
    extra = _copies_identical(first)
    del first
    state, ms, metrics, wall = _timed_steps(step, state, batch, MESH_TRAIN_STEPS)
    _copies_identical(state)
    med = statistics.median(ms[1:])
    losses = [x["loss"] for x in metrics]
    row = dict(leg=f"{'a' if family == 'style' else 'b'}_{family}_{label}", mesh=axes,
               card=smi, shape=list(batch.shape), first_loss=loss,
               first_loss_one_device=one_loss, first_loss_rel_err=rel, **gap,
               copies_beyond_masters=extra, step_ms_median=med,
               step_ms_one_device=one_ms, ratio_to_one_device=med / one_ms,
               host_wall_ms_per_step=wall * 1e3 / MESH_TRAIN_STEPS, losses=losses)
    log(f"train_mesh {row['leg']} on {smi}: step 1 loss {loss:.6f} vs one device "
        f"{one_loss:.6f} (rel {rel:.2e}); Adam mu vs one device: rel L2 max "
        f"{gap['mu_rel_l2_max']:.3e} ({gap['mu_rel_l2_max_leaf']}), w-leaf ratio "
        f"{gap['w_ratio_min']:.5f}..{gap['w_ratio_max']:.5f}; copies beyond the "
        f"masters {extra}; {med:.3f} ms/step median of steps 2-{MESH_TRAIN_STEPS} "
        f"(CUDA events) vs {one_ms:.3f} one device ({med / one_ms:.2f}x); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if not rel <= 5e-3:
        raise AssertionError(f"train_mesh {row['leg']}: loss {loss} vs {one_loss}")
    if not (abs(gap["w_ratio_min"] - 1) <= 0.05 and abs(gap["w_ratio_max"] - 1) <= 0.05
            and gap["mu_rel_l2_max"] <= 0.2):
        raise AssertionError(f"train_mesh {row['leg']}: gradient off the one-device "
                             f"step's: {gap}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_mesh {row['leg']}: losses {losses}")
    return row, mesh, state, step


def _one_device(mod, cfg, base, batch):
    """The one-device reference of a family: its first step (donate=False:
    base stays as it was) and its ms per step over MESH_TRAIN_STEPS."""
    step = mod.make_train_step(None, cfg, state_template=base)
    first = mod.make_train_step(None, cfg, state_template=base, donate=False)(base, batch)
    state = mod.copy_state(base)
    _, ms, _, _ = _timed_steps(step, state, batch, MESH_TRAIN_STEPS)
    return first, statistics.median(ms[1:])


def train_mesh_leg_steps(dev, smi: str):
    """(a) the default StyleTrainConfig (c 32, r 5, bf16) at 8 x 256 x 256
    on ``data=2, space=2, model=2`` and ``model=2`` meshes of the card;
    (b) ESPCN x2 at 16 x 128 x 128 HR on ``model=2`` and ``data=2``. Each
    against the one-device step from the same state and batch. Returns
    (rows, the model=2 style mesh, state and step for (c), the batch)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.cli import make_style_image
    from dvf_tpu_torch.train import sr as tsr
    from dvf_tpu_torch.train import style as tst

    rows = []
    b, h, w, _ = TRAIN_STYLE_SHAPE
    cfg = tst.StyleTrainConfig()
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(h, w, n_frames=b, seed=0)][:-1]
    batch = (torch.from_numpy(np.stack(frames).astype(np.float32) / 255.0)
             .pin_memory().to(dev, non_blocking=True))
    base = tst.init_train_state(0, make_style_image("stripes", h), cfg, device=dev)
    one_first, one_ms = _one_device(tst, cfg, base, batch)
    keep = None
    for label, axes in MESH_TRAIN_STYLE:
        row, mesh, state, step = _mesh_train_leg(dev, smi, "style", label, axes, cfg,
                                                 base, batch, one_ms, one_first)
        rows.append(row)
        keep = (mesh, state, step, batch)
        torch.cuda.empty_cache()
    del one_first
    b, h, w, _ = TRAIN_SR_SHAPE
    scfg = tsr.SrTrainConfig()
    hr = tsr.synthesize_structured_batch(np.random.default_rng(1), b, h)
    sbatch = (torch.from_numpy(hr.astype(np.float32) / 255.0).pin_memory()
              .to(dev, non_blocking=True))
    sbase = tsr.init_train_state(0, scfg, device=dev)
    s_first, s_ms = _one_device(tsr, scfg, sbase, sbatch)
    for label, axes in MESH_TRAIN_SR:
        row, *_ = _mesh_train_leg(dev, smi, "sr", label, axes, scfg, sbase, sbatch,
                                  s_ms, s_first)
        rows.append(row)
    return rows, keep


def train_mesh_leg_resume(dev, smi: str, keep, tmp: str):
    """(c) the model=2 style state of (a) saved, restored onto the mesh from
    a fresh template, and one more step of both (cuDNN's deterministic
    algorithms on): loss and params bit for bit. The checkpoint's files
    also against the same state restored whole and saved again."""
    import torch

    from dvf_tpu_torch.cli import make_style_image
    from dvf_tpu_torch.train import optim
    from dvf_tpu_torch.train import style as tst
    from dvf_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    mesh, state, _, batch = keep
    cfg = tst.StyleTrainConfig()
    step = tst.make_train_step(mesh, cfg, state_template=state, donate=False)
    t = time.perf_counter()
    path = save_checkpoint(os.path.join(tmp, "mesh", "final"), state)
    save_s = time.perf_counter() - t
    template = tst.init_train_state(1, make_style_image("stripes", TRAIN_STYLE_SHAPE[1]),
                                    cfg, device=dev)
    t = time.perf_counter()
    restored = restore_checkpoint(path, template, mesh=mesh, config=cfg)
    restore_s = time.perf_counter() - t
    whole = restore_checkpoint(path, template)
    path2 = save_checkpoint(os.path.join(tmp, "mesh", "whole"), whole)
    same_files = all(_npz_members(os.path.join(path, f)) == _npz_members(os.path.join(path2, f))
                     for f in ("params.npz", "state.npz"))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a, ma = step(state, batch)
        b, mb = step(restored, batch)
    finally:
        torch.backends.cudnn.deterministic = prev
    pa, pb = optim.flatten(optim.whole(a.params)), optim.flatten(optim.whole(b.params))
    n_diff = sum(int((pa[k] != pb[k]).sum()) for k in pa)
    same_loss = bool(torch.equal(ma["loss"], mb["loss"]))
    row = dict(leg="c_resume", mesh=dict(model=2), card=smi, step=int(b.step),
               restored_step=int(restored.step), save_s=save_s, restore_s=restore_s,
               next_step_loss_equal=same_loss, next_step_params_differing=n_diff,
               files_equal_whole_state=same_files)
    log(f"train_mesh (c) on {smi}: saved in {save_s:.2f} s, restored onto the mesh in "
        f"{restore_s:.2f} s at step {int(restored.step)}; step {int(b.step)} of the "
        f"restored vs the unrestored state: loss equal {same_loss}, params differing "
        f"{n_diff}; the sharded checkpoint's .npz members equal the whole state's "
        f"{same_files}")
    if not (same_loss and n_diff == 0 and same_files
            and int(restored.step) == int(state.step)):
        raise AssertionError(f"train_mesh (c): {row}")
    return row


def _npz_members(path: str) -> list:
    import zipfile

    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


def train_mesh_leg_dryrun(dev, smi: str):
    """(d) ``dvf_tpu_torch.dryrun``: ``entry()``'s forward on the card and
    ``dryrun_multichip(8)`` (one card: a virtual mesh of cuda:0 eight
    times), every sub-check at the reference's tolerance, with K3's and
    K4's launches per sub-check."""
    from dvf_tpu_torch import dryrun

    t = time.perf_counter()
    fn, args = dryrun.entry()
    out = fn(*args)
    if tuple(out.shape) != tuple(args[1].shape) or not bool(out.isfinite().all()):
        raise AssertionError(f"train_mesh (d): entry() gave {tuple(out.shape)}")
    sub = dryrun.dryrun_multichip(8)
    wall = time.perf_counter() - t
    by = {r["label"]: r for r in sub}
    k3 = by["engine-halo(sobel_bilateral)"]["launches"].get("sobel_bilateral", 0)
    k4 = by["engine-flow(flow_warp)"]["launches"].get("warp_bounded", 0)
    if not k3 or not k4:
        raise AssertionError(f"train_mesh (d): K3 {k3}, K4 {k4} launches")
    log(f"train_mesh (d) on {smi}: entry() {tuple(out.shape)}; dryrun_multichip(8) "
        f"{len(sub)} sub-checks in {wall:.1f} s: "
        + "; ".join(f"{r['label']} mesh {r['mesh']} "
                    + json.dumps({k: v for k, v in r.items()
                                  if k not in ("label", "mesh")}) for r in sub))
    return dict(leg="d_dryrun", card=smi, entry_shape=list(out.shape), subchecks=sub,
                wall_s_inner=wall)


def train_mesh_leg_engine(dev, smi: str, plain_of: dict):
    """(e) ``Engine(gaussian_blur(ksize=9))`` with neither device nor mesh
    at 16 x 1080 x 1920 against ``device="cuda:0"``: bit-equal, K1 once per
    batch; on one card no mesh (the single-device path)."""
    import torch

    import dvf_tpu_torch
    from dvf_tpu_torch.ops import kernels as tk
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    x = np.random.default_rng(5).integers(0, 255, DEFAULT_ENGINE_SHAPE, np.uint8)
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("gaussian_blur", ksize=9))
    pinned = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("gaussian_blur", ksize=9),
                                  device=dev)
    eng.compile(DEFAULT_ENGINE_SHAPE)
    pinned.compile(DEFAULT_ENGINE_SHAPE)
    before = tk.LAUNCHES["sep_blur"]
    got = eng.submit(x).fetch().copy()
    n = tk.LAUNCHES["sep_blur"] - before
    want = pinned.submit(x).fetch().copy()
    n_diff = int((got != want).sum())
    plain = to_uint8(plain_of["sep_blur"](to_float(torch.from_numpy(x).to(dev))))
    lsb = max_lsb(got, plain.cpu().numpy())
    n_cards = torch.cuda.device_count()
    row = dict(leg="e_engine_default", card=smi, cards=n_cards,
               meshed=bool(eng._meshed), mesh=None if eng.mesh is None else eng.mesh.shape,
               device=str(eng.device), launches_per_batch=n, elements_differing=n_diff,
               max_lsb_vs_plain=lsb)
    log(f"train_mesh (e) on {smi}: Engine(filt) with no device over {n_cards} card(s): "
        f"mesh {row['mesh']}, device {eng.device}; K1 {n} launch(es) per batch; "
        f"{n_diff} elements differ from device='cuda:0'; {lsb} LSB from the plain version")
    eng.free()
    pinned.free()
    if n != 1 or n_diff or lsb > 1 or (n_cards == 1 and eng._meshed):
        raise AssertionError(f"train_mesh (e): {row}")
    return row


def train_mesh_leg_cli(smi: str, tmp: str):
    """(f) ``python -m dvf_tpu_torch train --steps 4 --batch 2`` (its
    defaults otherwise: c 32, r 5, 64 x 64) as a process on the cards it
    finds (one card: data = gcd(2, 1) = 1, the one-device step)."""
    env = dict(os.environ)
    env.pop("DVF_FORCE_PLATFORM", None)
    res = _train_procs([("train", ["train", "--steps", "4", "--batch", "2",
                                   "--checkpoint-dir", os.path.join(tmp, "cli"),
                                   "--log-every", "2"])], env)
    j, err, wall = res["train"]
    if j["steps"] != 4 or not np.isfinite(j["final_loss"]):
        raise AssertionError(f"train_mesh (f): {j}; {err[-2000:]}")
    log(f"train_mesh (f) on {smi}: {json.dumps(j)} in {wall:.1f} s as a process")
    return dict(leg="f_cli", card=smi, result=j, wall_s_process=wall)


def train_mesh_phase(dev, plain_of: dict):
    """Phase 17: legs (a)-(f). Returns (rows, the launch counts of the
    phase: K1 from (e), K3 and K4 from (d)'s sub-checks)."""
    import tempfile

    import torch

    from dvf_tpu_torch.ops import kernels as tk

    t0 = time.perf_counter()
    smi = nvidia_smi()
    log(f"train_mesh phase on {smi}")
    tk.reset_launches()
    rows = []

    def timed(leg, *args):
        t = time.perf_counter()
        out = leg(*args)
        new = out[0] if isinstance(out, tuple) else out
        for row in new if isinstance(new, list) else [new]:
            row["wall_s"] = time.perf_counter() - t
            rows.append(row)
        log(f"train_mesh leg {leg.__name__}: {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
        return out

    with tempfile.TemporaryDirectory(prefix="dvf-train-mesh-") as tmp:
        _, keep = timed(train_mesh_leg_steps, dev, smi)
        timed(train_mesh_leg_resume, dev, smi, keep, tmp)
        del keep
        timed(train_mesh_leg_dryrun, dev, smi)
        timed(train_mesh_leg_engine, dev, smi, plain_of)
        timed(train_mesh_leg_cli, smi, tmp)
    delta = dict(tk.LAUNCHES)
    log(f"train_mesh phase: {time.perf_counter() - t0:.1f} s, launches {delta}")
    return rows, delta


def train_mesh_only() -> None:
    """The build and phase 17 alone (the sharded train state):
    ``python3 -c 'import chip_smoke; chip_smoke.train_mesh_only()'``."""
    dev, plain_of, _ = _only_setup()
    rows, delta = train_mesh_phase(dev, plain_of)
    print(json.dumps({"train_mesh": rows, "launches": delta}))


if __name__ == "__main__":
    sys.exit(main())
