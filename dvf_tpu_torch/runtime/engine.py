"""Device engine: batched filter execution on one device or over a mesh
(port of ``dvf_tpu.runtime.engine``).

``submit`` takes a uint8 NHWC batch from host memory (pinned, on the
pipeline's path) and:

1. copies it host→device on the engine's H2D stream (``non_blocking``)
   and records an event there;
2. on the submitting thread's current CUDA stream (the compute stream),
   waits for that event, casts to the filter's compute dtype, runs the
   filter and (``out_uint8``) casts back to uint8, and records the
   compute event;
3. unless ``fetch=False``, makes the engine's D2H stream wait for the
   compute event and copies the output into a host buffer (pinned) there;
4. returns a :class:`BatchResult` whose ``is_ready``/``fetch`` poll or
   wait on those events.

``submit_resident`` takes a batch already on the device (the streamed
ingest path copied it chunk by chunk on the H2D stream) and runs step 2
only; the egress fetcher then does step 3 into its own slabs. Only the two
copies run on side streams; the filter and every kernel wrapper launch on
the current stream. Events link the streams, never another thread's
current stream, and each device tensor a side stream touches is recorded
on the stream that reads it after (``record_stream``), so the caching
allocator cannot hand its memory to the next batch while a copy still
reads it.

uint8 crosses the host link in both directions (a quarter of float32's
bytes). Filter state stays on the device across batches; ``reset_state``
starts a new stream on the same engine, ``free`` drops the state,
``rebuild`` makes a fresh engine at the same signature (supervised
recovery). ``compile`` measures the reference's three calibrations:
``h2d_block_ms``, ``d2h_block_ms`` and ``step_block_ms``. It runs its
warm-up and calibration passes on the device's compile stream and waits
only on events recorded there, so a compile made beside live serving
(an admission, a hot swap's successor) never waits for other engines'
batches.

Multi-signature serving adds the double-buffered hot swap
(``prepare_swap`` compiles a successor aside, ``commit_swap`` adopts it
in place between ticks, ``abort_swap`` drops it) and the
:class:`ProgramPool`, a bounded LRU of compiled engines keyed by
canonical signature, with its registry of live pool engines and the
freed-bytes counter. The compile-cache helpers
(:func:`enable_compilation_cache`) arm the kernel-build cache, the port's
counterpart of XLA's persistent compilation cache. ``cost_analysis``
counts the compiled step's work from the filter and the signature
(``runtime.cost``).

``Engine(filt, mesh=m)`` spans a mesh (``parallel.mesh``) from one
process. ``compile`` asks the filter for its mesh body (``specialize``),
routes stencils through the explicit halo exchange on an H-sharded mesh
(``parallel.halo``) and picks the batch layout (``input_sharding``).
Each block of a batch crosses the host link on its own device's H2D
stream and the step runs per block on each device's current stream (or
inside the mesh body); the compute event is an ``EventGroup`` with one
event per device, and the output comes back per block on each device's
D2H stream. A filter's state is placed by its ``state_pspecs``; a state
carried through the batch in order, with no mesh body, keeps the batch
whole on the mesh's first device.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.obs.trace import ENGINE_LAUNCH
from dvf_tpu_torch.parallel.halo import spatial_filter
from dvf_tpu_torch.parallel import mesh as mesh_mod
from dvf_tpu_torch.parallel.mesh import NamedSharding, P, batch_pspec, batch_sharding
from dvf_tpu_torch.parallel.sharded import (
    EventGroup,
    PlacedTree,
    ShardedBatch,
    on_streams,
    place_tree,
    shard_batch,
)
from dvf_tpu_torch.utils.image import to_float, to_uint8

# compile()-time D2H and step calibrations are skipped above this size —
# the reference's cap; a 1080p batch-16 output (99.5 MB) is below it.
_D2H_CALIBRATION_CAP_BYTES = 128 * 1024 * 1024


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``None`` → ``cuda:0``. Raises when CUDA is asked for (or implied)
    and not available: the port never moves to the CPU on its own; the
    CPU is used only when the caller names it."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    return dev


def _torch_dtype(dtype) -> torch.dtype:
    dtype = np.dtype(dtype)
    if dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _torch_to_np(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a host array's memory (copied only when the
    array is not C-contiguous). numpy's bfloat16 (ml_dtypes), which
    ``torch.from_numpy`` refuses, crosses as its 16-bit pattern."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a CPU tensor (bfloat16 as ml_dtypes' bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_torch_to_np(t.dtype))
    return t.numpy()


def record_event(stream) -> Optional[torch.cuda.Event]:
    """An event recorded on ``stream`` now (None for no stream: the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a state pytree (dicts, lists, tuples, tensors, a
    mesh's placed tree), in a fixed order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "tensors"):  # parallel.sharded.PlacedTree
        return tree.tensors()
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _tensor_bytes(tree) -> int:
    """Summed nbytes of the tensors in a state pytree."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _build_step(filt: Filter, out_uint8: bool):
    """The per-batch program ``(batch, state) -> (out, state)``: cast to
    the filter's compute dtype, run the filter, cast back. It closes over
    the filter and the output policy only, never over an engine, so a
    program adopted by ``commit_swap`` does not reach back into the
    successor shell it was built on."""

    def step(x: torch.Tensor, state: Any):
        xin = x
        if x.dtype == torch.uint8 and not filt.uint8_ok:
            x = to_float(x, filt.compute_dtype)
        y, state = filt.fn(x, state)
        if out_uint8 and y.dtype != torch.uint8:
            y = to_uint8(y)
        if y.untyped_storage().data_ptr() == xin.untyped_storage().data_ptr():
            # A filter that hands back its input (identity): the input is
            # a staging buffer that is rewritten a few batches later, so
            # the output must own its bytes.
            y = y.clone()
        return y, state

    return step


def _build_mesh_step(filt: Filter, out_uint8: bool):
    """The per-batch program over a mesh: ``(ShardedBatch, state) ->
    (ShardedBatch, state)``, in the same layout. A mesh body (a filter
    with ``sharding``) takes the whole sharded batch; any other body runs
    once per block on the block's device — with the block's share of a
    placed state (``state_pspecs``), or with the whole state when the
    layout is a single block (a threaded state keeps the batch whole).
    The casts run per block; every block stays contiguous, as the kernel
    wrappers need."""

    def pre(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.uint8 and not filt.uint8_ok:
            return to_float(t, filt.compute_dtype)
        return t

    def step(xs: "ShardedBatch", state: Any):
        x = xs.map(pre)
        if filt.sharding is not None:
            y, state = filt.fn(x, state)
            outs = y.shards
        elif isinstance(state, PlacedTree):
            outs = [filt.fn(t, state.local(blk.pos))[0]
                    for blk, t in zip(x.blocks, x.shards)]
        else:
            outs = []
            for t in x.shards:
                o, state = filt.fn(t, state)
                outs.append(o)
        fixed = []
        for o, xin in zip(outs, xs.shards):
            if out_uint8 and o.dtype != torch.uint8:
                o = to_uint8(o)
            if o.untyped_storage().data_ptr() == xin.untyped_storage().data_ptr():
                o = o.clone()  # see _build_step: the input is a staging buffer
            fixed.append(o)
        return ShardedBatch(fixed, xs.sharding,
                            xs.sharding.global_shape(fixed[0].shape)), state

    return step


def _download(out, dst: torch.Tensor) -> None:
    """Copy a step's output into a host tensor on the current stream(s):
    one copy, or on a mesh one per block (a block whose rows are not
    contiguous in ``dst`` is copied blocking)."""
    if isinstance(out, torch.Tensor):
        dst.copy_(out, non_blocking=True)
        return
    for blk, t in zip(out.blocks, out.shards):
        view = dst[blk.index]
        view.copy_(t, non_blocking=view.is_contiguous())


def _side_stream(streams: Dict[torch.device, "torch.cuda.Stream"],
                 device: torch.device) -> Optional["torch.cuda.Stream"]:
    if device.type != "cuda":
        return None
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device)
    return s


# One compile stream per CUDA device, shared by every engine's compile:
# warm-up and calibration work runs there and compile() waits on events
# recorded there — never on the device as a whole, which would make a
# compile beside live serving wait for every other bucket's batches. One
# stream per device (not per engine) keeps the caching allocator's
# per-stream block pools from multiplying with engine churn.
_COMPILE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_COMPILE_STREAMS_LOCK = threading.Lock()


def _compile_stream(device: torch.device) -> "torch.cuda.Stream":
    with _COMPILE_STREAMS_LOCK:
        s = _COMPILE_STREAMS.get(device)
        if s is None:
            s = _COMPILE_STREAMS[device] = torch.cuda.Stream(device)
        return s


class BatchResult:
    """A submitted batch. ``device`` is the filter's output on the
    engine's device (stages appended after the filter, such as the codec
    assist, read it on the same stream); ``compute_event`` is recorded on
    the compute stream after the step (None on the CPU). The output lands
    in ``host`` (a CPU tensor) once ``event`` has completed; ``host`` is
    None when the batch was submitted with ``fetch=False`` (the egress
    fetcher or the coefficient wire then reads ``device``)."""

    def __init__(self, host: Optional[torch.Tensor],
                 event: Optional[torch.cuda.Event],
                 device: Optional[torch.Tensor] = None,
                 compute_event: Optional[torch.cuda.Event] = None):
        self.host = host
        self.device = device  # a ShardedBatch on a mesh engine
        self.compute_event = compute_event  # an EventGroup on a mesh
        self._event = event
        self.timing_start: Optional[torch.cuda.Event] = None  # traced
        #   batches: a timing event before the step; ``compute_event``
        #   then times too (Engine.settle_timing reads the pair)
        self._scatter: List[Tuple[torch.Tensor, torch.Tensor]] = []
        #   (host view, pinned staging) pairs of a mesh batch's blocks
        #   that are not contiguous in ``host`` (H-sharded): each block
        #   crossed the link into its own staging buffer and lands in its
        #   rows of ``host`` once the copies are done

    def is_ready(self) -> bool:
        ev = self._event if self.host is not None else self.compute_event
        return ev is None or ev.query()

    def wait_host(self) -> torch.Tensor:
        """Wait for the device→host copies and return ``host``, whole."""
        if self._event is not None:
            self._event.synchronize()
        for dst, staged in self._scatter:
            dst.copy_(staged)
        self._scatter = []
        return self.host

    def fetch(self) -> np.ndarray:
        """Wait for the device→host copy; the output as a numpy view of
        ``host``."""
        if self.host is None:
            raise RuntimeError("batch was submitted with fetch=False: no "
                               "host copy exists")
        return host_array(self.wait_host())


def wait_compute(result) -> None:
    """Wait until one batch's compute has finished on the device: a
    synchronize on that batch's own compute event (``BatchResult
    .compute_event``), never on a stream or the device. No event (the
    CPU) means the compute already ran when submit returned."""
    ev = getattr(result, "compute_event", None)
    if ev is not None:
        ev.synchronize()


@dataclasses.dataclass
class EngineStats:
    batches: int = 0
    frames: int = 0
    compile_count: int = 0
    device_ms: float = 0.0    # traced batches' step time on the device
    #   (CUDA events around the step), summed by Engine.settle_timing
    timed_batches: int = 0    # the batches device_ms covers


class Engine:
    """Runs one filter on one device, or over a mesh, at one batch
    signature.

    ``Engine(filt)``, with neither ``device`` nor ``mesh``, spans every
    attached card (``make_mesh()`` over ``parallel.mesh.local_devices()``,
    all ``data``, as the reference's default spans every device): on one
    card that is ``cuda:0`` with no mesh, the single-device path; with no
    card it raises. A ``device`` given alone is that one device.
    ``Engine(filt, mesh=m)`` spans ``m``: ``device`` is the mesh's first
    device, and a ``device`` given beside a mesh must be that device. A
    one-device mesh runs the single-device path."""

    def __init__(self, filt: Filter,
                 device: Union[None, str, torch.device] = None,
                 out_uint8: bool = True,
                 chaos=None,
                 calibration_seed: Optional[dict] = None,
                 op_chain: Optional[str] = None,
                 mesh=None):
        self.filter = filt
        if mesh is None and device is None:
            cards = mesh_mod.local_devices()
            if len(cards) > 1:
                mesh = mesh_mod.make_mesh(devices=cards)
            elif cards:
                device = cards[0]
        self.mesh = mesh
        if mesh is not None:
            first = mesh.first_device
            if device is not None and resolve_device(device) != first:
                raise ValueError(
                    f"device {device} and mesh disagree: the mesh's first "
                    f"device is {first}")
            self.device = resolve_device(first)
        else:
            self.device = resolve_device(device)
        self._meshed = mesh is not None and mesh.size > 1
        self._exec_filter: Filter = filt  # the body compile() picked:
        #   the filter, its mesh specialisation, or its halo wrapper
        self._sharding = None  # the batch layout over the mesh (None off
        #   a mesh), set by compile(): what the ingest lays its blocks out by
        self.out_uint8 = out_uint8
        self.op_chain = op_chain if op_chain is not None else filt.name
        #   the signature-key spelling of what this engine computes
        #   (runtime.signature.canonical_op_chain where parseable): what
        #   the program pool and the serving frontend key it by
        self.chaos = chaos  # resilience.chaos.FaultPlan: submit paths fire
        #   the "oom" and "compute" sites through it (nothing when None)
        self.calibration_seed = calibration_seed  # optional persisted
        #   {h2d_block_ms, d2h_block_ms, step_block_ms}: when it carries
        #   real h2d and step numbers, compile() adopts it and skips the
        #   blocking measurement passes (d2h may be None in a valid seed)
        self.calibration_seeded = False  # did the last compile() adopt it
        self.h2d_block_ms: Optional[float] = None  # one blocking pinned
        #   whole-batch host→device copy at the compiled signature (the
        #   second put, after the warm-up put): what the streamed ingest's
        #   overlap_efficiency and cheap-transfer gate are judged against
        self.d2h_block_ms: Optional[float] = None  # one blocking whole-
        #   batch device→host copy into a pre-touched pinned buffer: the
        #   egress mirror (None above _D2H_CALIBRATION_CAP_BYTES)
        self.step_block_ms: Optional[float] = None  # one blocking step
        #   after the warm-up (None above the cap)
        self.last_compile_ms: Optional[float] = None  # wall time of the
        #   last compile(): warm-up and calibrations included
        self.state_bytes: int = 0  # device bytes of the filter state
        self.stats = EngineStats()
        self.tracer = None  # obs.trace.Tracer: when enabled, each step
        #   records an engine.launch span on trace_track and, on one card,
        #   a pair of timing events (settle_timing)
        self.trace_track = 0
        self._signature: Optional[Tuple] = None
        self._state: Any = None
        self._step: Optional[Callable] = None  # the compiled per-batch
        #   program (_build_step), set by compile() and adopted by
        #   commit_swap: whatever runs per batch comes from the program
        #   that was compiled, so a rebuild replaces it whole
        self.freed = False  # set by free(): no state, no further submits
        self.out_shape: Optional[Tuple[int, ...]] = None  # set by compile()
        self.out_dtype: Optional[np.dtype] = None
        self._h2d: Dict[torch.device, torch.cuda.Stream] = {}
        self._d2h: Dict[torch.device, torch.cuda.Stream] = {}
        # The engine's copy stream on a device (None on the CPU), one per
        # device it spans. Plain functions over the stream tables, not
        # bound methods: the assemblers and fetchers that hold them must
        # not keep the engine (and its device state) alive.
        self.h2d_stream_for = functools.partial(_side_stream, self._h2d)
        self.d2h_stream_for = functools.partial(_side_stream, self._d2h)
        # Double-buffered hot swap: a successor compiled aside waits in
        # _staged until commit_swap adopts it; _preparing latches
        # concurrent prepares of one successor signature onto one compile.
        self._swap_lock = threading.Lock()
        self._staged: Optional["Engine"] = None
        self._preparing: Dict[Tuple, threading.Event] = {}
        self.swap_count = 0  # committed hot swaps
        self.last_swap: Optional[dict] = None  # {migrate_ms, stall_ms,
        #   migrated} of the last commit_swap
        self.last_prepare: Optional[dict] = None  # the last successor
        #   prepare_swap built: {compile_aside_ms, staged, cache}

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def signature(self) -> Optional[Tuple]:
        """The compiled ``((B, H, W, C), dtype)`` signature, or None before
        the first compile."""
        return self._signature

    @property
    def signature_key(self):
        """The canonical ``(op_chain, geometry, dtype)`` serving signature
        (runtime.signature.SignatureKey), or None before the first
        compile."""
        from dvf_tpu_torch.runtime.signature import engine_signature_key

        return engine_signature_key(self)

    @property
    def h2d_stream(self) -> Optional[torch.cuda.Stream]:
        """The engine's host→device copy stream (None on the CPU); on a
        mesh, its first device's (``h2d_stream_for`` gives the others)."""
        return self.h2d_stream_for(self.device)

    @property
    def d2h_stream(self) -> Optional[torch.cuda.Stream]:
        """The engine's device→host copy stream (None on the CPU)."""
        return self.d2h_stream_for(self.device)

    @property
    def placement(self):
        """Where a batch for this engine goes: its device, or on a mesh
        the compiled input sharding (what the streamed ingest and egress
        lay their blocks out by)."""
        return self._sharding if self._meshed else self.device

    @property
    def devices(self) -> List[torch.device]:
        """Every distinct device the engine spans."""
        return self.mesh.distinct_devices() if self._meshed else [self.device]

    @property
    def input_sharding(self):
        """The batch layout the compiled step expects (None off a mesh and
        before the first compile); may differ from the plain
        ``batch_sharding`` when H is replicated or a mesh body owns it."""
        return self._sharding if self._meshed else None

    @property
    def output_sharding(self):
        """The compiled step's output layout (the input's: blocks keep
        their place, a geometry-changing filter only scales them)."""
        return self.input_sharding

    def _compute_stream(self, device: Optional[torch.device] = None):
        device = self.device if device is None else device
        return torch.cuda.current_stream(device) if device.type == "cuda" else None

    def _mesh_exec_filter(self, shape: Tuple[int, ...]) -> Filter:
        """Choose the body and the batch layout for a signature on a mesh:
        the filter's own mesh specialisation first (a tensor-parallel
        forward on a model axis), then the H-axis halo routing."""

        self._sharding = batch_sharding(self.mesh, shape)
        base = self.filter
        if base.specialize is not None:
            specialized = base.specialize(self.mesh, shape)
            if specialized is not None:
                base = specialized
        ef = self._pick_exec_filter(base, shape)
        if ef.sharding is not None:
            self._sharding = ef.sharding
        elif ef.stateful and ef.state_pspecs is None:
            # A threaded state runs through the batch in order: the
            # batch stays one block, on the mesh's first device.

            print(f"[engine] filter {ef.name!r} carries its state through "
                  f"the batch in order and has no mesh body; the batch "
                  f"stays whole on {self.device}", file=sys.stderr)
            self._sharding = NamedSharding(self.mesh, P())
        return ef

    def _pick_exec_filter(self, filt: Filter, batch_shape) -> Filter:
        """Choose the executed filter and H-axis layout for this signature.

        On an H-sharded mesh stencil filters run through the explicit halo
        exchange (``parallel.halo.spatial_filter``). Pointwise filters
        (halo == 0) need no halo and keep H sharded; a mesh body owns its
        layout. Filters that cannot halo-exchange (stateful, unknown
        radius, slab thinner than the radius) keep H replicated, with a
        line on stderr."""

        pspec = batch_pspec(self.mesh, batch_shape)
        if filt.sharding is not None or pspec[1] != "space" or filt.halo == 0:
            return filt
        n_space = self.mesh.axis_size("space")
        can_halo = (
            not filt.stateful
            and filt.halo is not None
            and batch_shape[1] // n_space > filt.halo
        )
        if can_halo:
            return spatial_filter(filt, self.mesh,
                                  data_sharded=(pspec[0] == "data"))
        print(
            f"[engine] filter {filt.name!r} can't halo-shard H "
            f"(stateful={filt.stateful}, halo={filt.halo}, "
            f"H={batch_shape[1]}, space={n_space}); replicating H",
            file=sys.stderr,
        )
        self._sharding = NamedSharding(self.mesh, P(pspec[0], None, None, None))
        return filt

    def upload(self, host: torch.Tensor):
        """Host → device on the current stream(s): the whole batch, or on
        a mesh each block to its device."""
        if self._meshed:

            return shard_batch(host, self._sharding, non_blocking=True)
        return host.to(self.device, non_blocking=True)

    def _fresh_state(self, batch_shape, dtype) -> Any:
        f = self._exec_filter
        if not f.stateful:
            return None
        state_dtype = (f.compute_dtype
                       if np.dtype(dtype) == np.uint8 and not f.uint8_ok
                       else _torch_dtype(dtype))
        state = f.init_state(tuple(batch_shape), state_dtype, self.device)
        if self._meshed and f.state_pspecs is not None:

            state = place_tree(state, self.mesh, f.state_pspecs())
        return state

    def _put(self, host: torch.Tensor) -> torch.Tensor:
        """Host → device on the H2D stream; the compute stream waits for
        it. On the CPU the batch is used as it is. On a mesh each block
        crosses on its own device's H2D stream (a block whose rows are not
        contiguous in ``host`` is gathered into host memory first)."""
        if self._meshed:
            return self._put_blocks(host)
        if not self.on_cuda:
            return host
        h2d = self.h2d_stream
        with torch.cuda.stream(h2d):
            x = host.to(self.device, non_blocking=True)
        compute = self._compute_stream()
        compute.wait_event(record_event(h2d))
        x.record_stream(compute)
        return x

    def _put_blocks(self, host: torch.Tensor) -> ShardedBatch:
        out = []
        for blk in self._sharding.shards(host.shape):
            piece = host[blk.index]
            if not piece.is_contiguous():
                piece = piece.contiguous()
            dev = blk.device
            if dev.type != "cuda":
                out.append(piece if piece.device == dev else piece.to(dev))
                continue
            h2d = self.h2d_stream_for(dev)
            with torch.cuda.stream(h2d):
                x = piece.to(dev, non_blocking=True)
            compute = self._compute_stream(dev)
            compute.wait_event(record_event(h2d))
            x.record_stream(compute)
            out.append(x)
        return ShardedBatch(out, self._sharding, host.shape)

    def _copy_out_blocks(self, y, out: torch.Tensor, compute_event):
        """Device → host per block on each device's D2H stream after that
        device's compute event. Returns (event group, scatter pairs): a
        block whose rows are not contiguous in ``out`` (H-sharded) lands
        in a pinned staging buffer, one copy per block, and reaches
        ``out`` in ``BatchResult.wait_host``."""
        scatter = []
        for blk, t in zip(y.blocks, y.shards):
            view = out[blk.index]
            if t.device.type != "cuda":
                view.copy_(t)
                continue
            d2h = self.d2h_stream_for(t.device)
            d2h.wait_event(compute_event.on(t.device))
            t.record_stream(d2h)
            dst = view
            if not view.is_contiguous():
                dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                scatter.append((view, dst))
            with torch.cuda.stream(d2h):
                dst.copy_(t, non_blocking=True)
        return EventGroup.record([t.device for t in y.shards],
                                 self.d2h_stream_for), scatter

    def _copy_out(self, y: torch.Tensor, out: torch.Tensor,
                  compute_event) -> Optional[torch.cuda.Event]:
        """Device → host on the D2H stream after the compute event."""
        if not self.on_cuda:
            out.copy_(y)
            return None
        d2h = self.d2h_stream
        d2h.wait_event(compute_event)
        y.record_stream(d2h)
        with torch.cuda.stream(d2h):
            out.copy_(y, non_blocking=True)
        return record_event(d2h)

    def compile(self, batch_shape: Tuple[int, ...], dtype=np.uint8) -> None:
        """Prepare for a fixed (B, H, W, C) signature: build the state,
        make one warm-up call (so the kernel build and first launch fall
        outside the stream) and measure the calibrations as the reference
        does — a second, blocking pinned host→device copy after the
        warm-up put; a blocking device→host copy of the warm-up output
        into a pre-touched pinned buffer; one more blocking step — the
        last two skipped above ``_D2H_CALIBRATION_CAP_BYTES``. A
        ``calibration_seed`` with real h2d and step numbers replaces the
        measurements. The state is rebuilt after each step.

        On a card every pass runs on the device's compile stream and
        each blocking wait is an event recorded there after this
        compile's own work, so a compile beside live serving never waits
        for other engines' batches (its copies still share the host link
        with theirs). The final state is built on the caller's stream,
        the one that serves."""
        sig = (tuple(batch_shape), np.dtype(dtype))
        if sig == self._signature:
            return
        self._refuse_if_freed()
        t_compile0 = time.perf_counter()
        shape = tuple(batch_shape)
        zeros = torch.zeros(shape, dtype=_torch_dtype(dtype),
                            pin_memory=self.on_cuda)
        seed = self.calibration_seed
        seeded = (isinstance(seed, dict)
                  and isinstance(seed.get("h2d_block_ms"), (int, float))
                  and isinstance(seed.get("step_block_ms"), (int, float)))
        self.calibration_seeded = seeded
        if self._meshed:
            self._exec_filter = self._mesh_exec_filter(shape)
            self._step = _build_mesh_step(self._exec_filter, self.out_uint8)
        else:
            self._exec_filter = self.filter
            self._step = _build_step(self.filter, self.out_uint8)
        streams = [_compile_stream(d) for d in self.devices if d.type == "cuda"]

        def wait_own() -> None:
            for cs in streams:
                record_event(cs).synchronize()

        with torch.no_grad(), on_streams(streams):
            state = self._fresh_state(shape, dtype)
            warm = self.upload(zeros)
            wait_own()
            if seeded:
                self.h2d_block_ms = float(seed["h2d_block_ms"])
            else:
                del warm
                t0 = time.perf_counter()
                warm = self.upload(zeros)
                wait_own()
                self.h2d_block_ms = (time.perf_counter() - t0) * 1e3
            out, _ = self._step(warm, state)
            wait_own()
            self.out_shape = tuple(out.shape)
            self.out_dtype = _torch_to_np(out.dtype)
            nbytes = out.numel() * out.element_size()
            if seeded:
                d2h = seed.get("d2h_block_ms")
                self.d2h_block_ms = (float(d2h)
                                     if isinstance(d2h, (int, float)) else None)
            elif nbytes <= _D2H_CALIBRATION_CAP_BYTES:
                dst = torch.empty(out.shape, dtype=out.dtype,
                                  pin_memory=self.on_cuda)
                dst.fill_(0)
                t0 = time.perf_counter()
                _download(out, dst)
                wait_own()
                self.d2h_block_ms = (time.perf_counter() - t0) * 1e3
                del dst
            else:
                self.d2h_block_ms = None
            del out
            if seeded:
                self.step_block_ms = float(seed["step_block_ms"])
            elif zeros.numel() * zeros.element_size() <= _D2H_CALIBRATION_CAP_BYTES:
                state = self._fresh_state(shape, dtype)
                t0 = time.perf_counter()
                out2, _ = self._step(warm, state)
                wait_own()
                self.step_block_ms = (time.perf_counter() - t0) * 1e3
                del out2
            else:
                self.step_block_ms = None
            del warm, state
        self._state = self._fresh_state(shape, dtype)
        self._signature = sig
        self.stats.compile_count += 1
        self.last_compile_ms = (time.perf_counter() - t_compile0) * 1e3
        self.state_bytes = _tensor_bytes(self._state)

    def ensure_compiled(self, batch_shape: Tuple[int, ...], dtype=np.uint8) -> None:
        """Compile for a signature unless already compiled for it (what the
        pipeline calls before sizing its staging slots)."""
        self.compile(tuple(batch_shape), dtype)

    def _enter_submit(self, shape, dtype) -> None:
        self._refuse_if_freed()
        if self._signature != (tuple(shape), dtype):
            self.compile(tuple(shape), dtype)
        if self.chaos is not None:
            self.chaos.fire("oom")
            self.chaos.fire("compute")

    def _run(self, x: torch.Tensor, seq: Optional[int] = None):
        """The step on the compute stream; returns (output, compute event:
        on a mesh an EventGroup, one event per device; timing start event
        or None). With an enabled tracer the launch is an
        ``engine.launch`` span carrying ``seq``, and on one card the
        step sits between two timing events, the second the compute
        event."""
        tracer = self.tracer
        traced = tracer is not None and tracer.enabled
        t0 = time.perf_counter() if traced else 0.0
        start = self._timing_event() if traced else None
        y, self._state = self._step(x, self._state)
        self.stats.batches += 1
        self.stats.frames += x.shape[0]
        if self._meshed:
            cev = EventGroup.record(self.devices, self._compute_stream)
        elif start is not None:
            cev = self._timing_event()
        else:
            cev = record_event(self._compute_stream())
        if traced:
            tracer.complete(ENGINE_LAUNCH, t0, time.perf_counter(), self.trace_track, seq=seq)
        return y, cev, start

    def _timing_event(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the compute stream now; None on the
        CPU and on a mesh."""
        stream = None if self._meshed else self._compute_stream()
        if stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def settle_timing(self, result: BatchResult) -> None:
        """Add a traced batch's step time on the device to
        ``stats.device_ms``. Call once the host has waited for the
        batch's compute event, so reading the pair waits for nothing."""
        start, result.timing_start = result.timing_start, None
        if start is not None:
            self.stats.device_ms += start.elapsed_time(result.compute_event)
            self.stats.timed_batches += 1

    def submit(self, batch: Union[np.ndarray, torch.Tensor],
               out: Optional[torch.Tensor] = None,
               fetch: bool = True, seq: Optional[int] = None) -> BatchResult:
        """Dispatch one host batch; returns at once with a BatchResult.

        ``batch`` should sit in pinned memory for the copy to be
        asynchronous. ``out`` is the host buffer the output is copied into
        (pinned, shape ``out_shape``); None allocates one. ``fetch=False``
        skips the device→host copy (the egress fetcher or the coefficient
        wire reads ``BatchResult.device``). The caller must not rewrite
        ``batch`` or read ``out`` before the result is ready. ``seq``
        tags the traced launch.
        """
        host = batch if isinstance(batch, torch.Tensor) else host_tensor(
            batch)
        if host.device.type != "cpu":
            raise ValueError(f"submit takes a host batch, got one on {host.device}")
        self._enter_submit(host.shape, _torch_to_np(host.dtype))
        event = None
        scatter = []
        with torch.no_grad():
            y, cev, start = self._run(self._put(host), seq)
            if fetch:
                if out is None:
                    out = torch.empty(y.shape, dtype=y.dtype,
                                      pin_memory=self.on_cuda)
                if self._meshed:
                    event, scatter = self._copy_out_blocks(y, out, cev)
                else:
                    event = self._copy_out(y, out, cev)
            else:
                out = None
        result = BatchResult(out, event, device=y, compute_event=cev)
        result._scatter = scatter
        result.timing_start = start
        return result

    def submit_resident(self, batch: torch.Tensor,
                        ready: Optional[torch.cuda.Event] = None,
                        seq: Optional[int] = None) -> BatchResult:
        """Serving entry for a batch already on the device: the streamed
        ingest path copied its chunks on the H2D stream, so the copy of
        :meth:`submit` is skipped. ``ready`` is the event recorded after
        the last chunk's copy; the compute stream waits for it before the
        step reads ``batch``. State threading, chaos sites and stats are
        those of :meth:`submit`. The result carries no host copy.

        On a mesh ``batch`` is a ShardedBatch in the compiled input layout
        (``input_sharding``) and ``ready`` an EventGroup: each device's
        compute stream waits for its own event."""
        if self._meshed:
            return self._submit_resident_blocks(batch, ready, seq)
        if batch.device != self.device:
            raise ValueError(f"submit_resident takes a batch on {self.device}, "
                             f"got one on {batch.device}")
        self._enter_submit(batch.shape, _torch_to_np(batch.dtype))
        with torch.no_grad():
            if self.on_cuda:
                compute = self._compute_stream()
                if ready is not None:
                    compute.wait_event(ready)
                batch.record_stream(compute)
            y, cev, start = self._run(batch, seq)
        result = BatchResult(None, None, device=y, compute_event=cev)
        result.timing_start = start
        return result

    def _submit_resident_blocks(self, batch, ready, seq=None) -> BatchResult:
        if not isinstance(batch, ShardedBatch):
            raise ValueError("submit_resident on a mesh takes a ShardedBatch "
                             "in the engine's input_sharding")
        self._enter_submit(batch.shape, _torch_to_np(batch.dtype))
        if batch.sharding != self._sharding:
            raise ValueError(f"batch laid out as {batch.sharding.spec}, the "
                             f"compiled step takes {self._sharding.spec}")
        with torch.no_grad():
            for t in batch.shards:
                if t.device.type == "cuda":
                    compute = self._compute_stream(t.device)
                    ev = ready.on(t.device) if ready is not None else None
                    if ev is not None:
                        compute.wait_event(ev)
                    t.record_stream(compute)
            y, cev, _ = self._run(batch, seq)
        return BatchResult(None, None, device=y, compute_event=cev)

    def run_device_resident(self, batch: torch.Tensor,
                            ready: Optional[torch.cuda.Event] = None) -> BatchResult:
        """Alias of :meth:`submit_resident` (the reference's benchmark
        loops call it by this name)."""
        return self.submit_resident(batch, ready=ready)

    def run_probe(self, batch: np.ndarray) -> np.ndarray:
        """Run the compiled step on ``batch`` without touching serving
        state or stats: no state threading (stateless filters only), no
        batch/frame counters, no chaos sites. Blocking: returns the output
        as a fresh host array."""
        if self.freed:
            raise RuntimeError("cannot probe a freed engine")
        if self._signature is None:
            raise RuntimeError("cannot probe an uncompiled engine")
        if self.filter.stateful:
            raise ValueError(
                f"cannot probe stateful filter {self.filter.name!r}: "
                f"the probe would consume (donated) live temporal "
                f"state")
        if (tuple(batch.shape), np.dtype(batch.dtype)) != self._signature:
            raise ValueError(
                f"probe batch {batch.shape}/{batch.dtype} does not "
                f"match the compiled signature {self._signature}")
        host = host_tensor(batch)
        with torch.no_grad():
            if self._meshed:

                x = shard_batch(host, self._sharding)
            else:
                x = host.to(self.device)
            y, _ = self._step(x, None)
            return host_array(y.cpu())

    def cost_analysis(self) -> Optional[dict]:
        """The compiled step's work per batch, under the reference's keys:
        ``flops_per_batch`` and ``bytes_accessed_per_batch``. There is no
        compiler to ask, so both are counted (``runtime.cost``): the
        operations of the filter's definition, and the least bytes it
        must move — each input frame read once, each output frame written
        once, plus the device state as often as the filter moves it (a
        net's parameters once, a stateful window read and written).
        None before the first compile and for a filter with no count."""
        if self._signature is None or self.out_shape is None:
            return None
        from dvf_tpu_torch.runtime.cost import filter_cost

        shape, dtype = self._signature
        cost = filter_cost(self.filter, shape)
        if cost is None:
            return None
        nbytes = (int(np.prod(shape)) * dtype.itemsize
                  + int(np.prod(self.out_shape)) * np.dtype(self.out_dtype).itemsize
                  + cost.state_passes * self.state_bytes)
        return {"flops_per_batch": float(cost.flops),
                "bytes_accessed_per_batch": float(nbytes)}

    def rebuild(self) -> "Engine":
        """Fresh engine for supervised recovery: same filter, device and
        options, compiled at the old signature — the full compile() path,
        so the replacement is warmed and re-calibrated before it takes
        traffic. A stateful filter's state restarts fresh."""
        fresh = Engine(self.filter, device=self.device, out_uint8=self.out_uint8,
                       chaos=self.chaos, op_chain=self.op_chain,
                       mesh=self.mesh)
        fresh.tracer, fresh.trace_track = self.tracer, self.trace_track
        if self._signature is not None:
            shape, dtype = self._signature
            fresh.compile(shape, dtype)
        return fresh

    # -- double-buffered hot swap -----------------------------------------

    def prepare_swap(self, batch_shape: Tuple[int, ...], dtype=np.uint8,
                     force: bool = False) -> dict:
        """Compile the successor program for ``batch_shape``/``dtype``
        ASIDE — a fresh engine built, warmed and calibrated on THIS
        (background) thread while the live program keeps serving.
        Nothing the serving path reads is touched until
        :meth:`commit_swap` adopts the staged successor between ticks.

        ``force=True`` prepares even at the live signature (a fresh
        program and state at the same shape — the supervised-recovery
        rebuild, compiled aside instead of in place).

        Concurrent prepares for the same successor signature dedup onto
        one compile via a per-signature latch; a prepare for a DIFFERENT
        signature supersedes the previously staged successor (last
        prepare wins; the superseded one is freed).

        Returns ``{"compile_aside_ms", "staged", "cache"}``; ``staged``
        False means the live program already serves this signature and
        nothing was built. Raises on a compile failure (and on the chaos
        ``swap`` site) with the live program untouched.
        """
        if self.freed:
            raise RuntimeError("cannot prepare a swap on a freed engine")
        sig = (tuple(batch_shape), np.dtype(dtype))
        if sig == self._signature and not force:
            return {"compile_aside_ms": 0.0, "staged": False,
                    "cache": "live"}
        while True:
            with self._swap_lock:
                st = self._staged
                if st is not None and st._signature == sig and not force:
                    return {"compile_aside_ms": 0.0, "staged": True,
                            "cache": "staged"}
                latch = self._preparing.get(sig)
                if latch is None:
                    self._preparing[sig] = latch = threading.Event()
                    break
            # Another thread is building this successor: wait it out,
            # then re-check (it staged the program, or died and we build).
            latch.wait(timeout=300.0)
        t0 = time.perf_counter()
        try:
            if self.chaos is not None:
                self.chaos.fire("swap")  # injection site: aside-compile
                #   failure — the old program must keep serving
            succ = Engine(self.filter, device=self.device,
                          out_uint8=self.out_uint8, chaos=self.chaos,
                          op_chain=self.op_chain, mesh=self.mesh)
            succ.compile(tuple(batch_shape), dtype)
        except BaseException:
            with self._swap_lock:
                self._preparing.pop(sig, None)
            latch.set()
            raise
        ms = (time.perf_counter() - t0) * 1e3
        with self._swap_lock:
            old, self._staged = self._staged, succ
            self._preparing.pop(sig, None)
        latch.set()
        if old is not None and old is not succ:
            old.free()  # superseded staging
        self.last_prepare = {"compile_aside_ms": ms, "staged": True,
                             "cache": "miss"}
        return dict(self.last_prepare)

    @property
    def swap_staged(self) -> bool:
        """Whether a prepared successor is waiting for commit_swap."""
        with self._swap_lock:
            return self._staged is not None

    def commit_swap(self, migrate_state: bool = True) -> dict:
        """Adopt the staged successor program in place: one lock-guarded
        swing of the fields the serving and egress paths read — call it
        from the thread that owns submits (the serving dispatch thread),
        so a batch never straddles the old and new programs. Batches
        already submitted on the old program hold their own tensors and
        events and drain normally. The engine keeps its own H2D and D2H
        streams, so their events and ``record_stream`` marks stay valid.

        Device-resident filter state migrates with ``copy_`` on the
        current stream when the successor's state matches leaf for leaf
        (``migrate_state=True``); a geometry-changing swap (or
        ``migrate_state=False`` — supervised recovery, whose old state
        is suspect) keeps the successor's fresh state.

        Returns ``{"migrate_ms", "stall_ms", "migrated"}`` — stall_ms is
        the measured wall time of this call, the ONLY serving time the
        swap consumes. Raises (the chaos ``swap`` site mid-migrate, a
        failed copy) with the live program untouched and the staged
        successor freed.
        """
        with self._swap_lock:
            succ = self._staged
            if succ is None:
                raise RuntimeError(
                    "no staged successor program (prepare_swap first)")
            self._staged = None
            t0 = time.perf_counter()
            migrate_ms = 0.0
            migrated = False
            try:
                if self.chaos is not None:
                    self.chaos.fire("swap")  # injection site: mid-
                    #   migrate failure — abort, old program serving
                if migrate_state and self.filter.stateful \
                        and self._state is not None:
                    t_m = time.perf_counter()
                    migrated = self._migrate_state_to(succ)
                    if migrated:
                        migrate_ms = (time.perf_counter() - t_m) * 1e3
            except BaseException:
                succ.free()
                raise
            for name in ("_step", "_signature", "_state", "_exec_filter",
                         "_sharding", "out_shape",
                         "out_dtype", "h2d_block_ms", "d2h_block_ms",
                         "step_block_ms", "last_compile_ms", "state_bytes"):
                setattr(self, name, getattr(succ, name))
            self.stats.compile_count += succ.stats.compile_count
            # The successor shell's program and state now belong to this
            # engine: its free() must not count the state as freed.
            succ._step = None
            succ._state = None
            succ.state_bytes = 0
            succ.freed = True
            self.swap_count += 1
            stall_ms = (time.perf_counter() - t0) * 1e3
            self.last_swap = {"migrate_ms": round(migrate_ms, 3),
                              "stall_ms": round(stall_ms, 3),
                              "migrated": migrated}
            return dict(self.last_swap)

    def _migrate_state_to(self, succ: "Engine") -> bool:
        """Copy the live filter state into the successor's, leaf by leaf
        (``copy_`` on the current stream, ordered after the batches that
        wrote it) — only when the two trees match in structure, shapes
        and dtypes. False = they diverged (the successor keeps its fresh
        state; a geometry change resets temporal state by definition)."""
        old_leaves = _leaves(self._state)
        new_leaves = _leaves(succ._state)
        if len(old_leaves) != len(new_leaves):
            return False
        for a, b in zip(old_leaves, new_leaves):
            if a.shape != b.shape or a.dtype != b.dtype:
                return False
        with torch.no_grad():
            for a, b in zip(old_leaves, new_leaves):
                b.copy_(a)
        return True

    def abort_swap(self) -> bool:
        """Free a staged successor without adopting it. True when
        something was staged."""
        with self._swap_lock:
            succ, self._staged = self._staged, None
        if succ is not None:
            succ.free()
            return True
        return False

    def reset_state(self) -> None:
        """Start a new stream on this engine: rebuild a stateful filter's
        state for the compiled signature, so the next batch does not see
        the last stream's frames (flow_warp passes its first batch
        through again)."""
        self._refuse_if_freed()
        if self.filter.stateful and self._signature is not None:
            self._state = self._fresh_state(*self._signature)

    def free(self) -> None:
        """Drop the device state (and a staged successor's) and refuse
        further submits and compiles — the program pool's eviction path.
        Idempotent. The caller frees after the last result it wants has
        been fetched. The caching allocator keeps the blocks reserved;
        they are free once no tensor holds them (``memory_allocated``)."""
        if self.freed:
            return
        self.freed = True
        with self._swap_lock:
            staged, self._staged = self._staged, None
        if staged is not None:
            staged.free()  # an un-committed successor must not leak
        self._step = None
        self._state = None
        self._signature = None
        _note_freed_bytes(self.state_bytes)
        _unregister_pool_engine(self)

    def _refuse_if_freed(self) -> None:
        if self.freed:
            raise RuntimeError("engine was freed; build a new Engine")


# ---------------------------------------------------------------------------
# Compiled-program pool (multi-signature serving)
# ---------------------------------------------------------------------------

# Every engine currently holding device buffers under a ProgramPool's
# management. The port's serving tests walk this after each module: a
# pool engine still live after every frontend closed means some stop()
# path stopped freeing — a long-lived multi-tenant server would leak one
# compiled program (plus its device state) per churned signature forever.
_POOL_ENGINES: "set" = set()
_POOL_ENGINES_LOCK = threading.Lock()

# Freed device-memory accounting (obs.memory): Engine.free() folds the
# freed engine's measured state residency in here, so the scrape-time
# gauges can report eviction traffic as a monotone counter.
_FREED_DEVICE_BYTES = 0


def _note_freed_bytes(n: int) -> None:
    global _FREED_DEVICE_BYTES
    with _POOL_ENGINES_LOCK:
        _FREED_DEVICE_BYTES += int(n or 0)


def freed_device_bytes_total() -> int:
    """Monotone: device state bytes released by every ``Engine.free()``
    so far (pool evictions, frontend stops, recovery replacements) —
    the ``dvf_mem_engine_freed_bytes_total`` counter's source."""
    with _POOL_ENGINES_LOCK:
        return _FREED_DEVICE_BYTES


def _register_pool_engine(engine: "Engine") -> None:
    with _POOL_ENGINES_LOCK:
        _POOL_ENGINES.add(engine)


def _unregister_pool_engine(engine: "Engine") -> None:
    with _POOL_ENGINES_LOCK:
        _POOL_ENGINES.discard(engine)


def live_pool_engines() -> List["Engine"]:
    """Pool-managed engines whose device buffers are still live — the
    leak guards' registry."""
    with _POOL_ENGINES_LOCK:
        return [e for e in _POOL_ENGINES if not e.freed]


class ProgramPool:
    """Bounded LRU of live compiled Engines, keyed by canonical
    signature (runtime.signature.SignatureKey).

    N serving signatures time-share ONE device without N processes: a
    bucket *leases* its engine (refcounted — a leased program is never
    evicted out from under in-flight batches), releases it when the
    bucket retires, and the program stays WARM in the pool until LRU
    capacity pressure frees its device buffers (``Engine.free``).
    Re-admission of an evicted signature recompiles through ``build``
    (a fresh engine: warm-up and calibrations; the hand kernels' builds
    are cached per process, so nothing is compiled again by nvcc).

    ``hits``/``misses``/``evictions`` are the ``dvf_compile_cache_*`` /
    pool-eviction registry exports.
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError("pool capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        # key -> [engine, lease_count]; OrderedDict gives LRU order.
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._building: Dict[Any, threading.Event] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.closed = False
        self.observer: Optional[Callable] = None  # reconfiguration-
        #   ledger tap (duck-typed: observer(kind, **fields)): the owner
        #   wires it to record pool_acquire / compile / pool_evict
        #   events. Always called OUTSIDE the pool lock; exceptions are
        #   swallowed — accounting must never break a lease.

    def _notify(self, kind: str, **fields) -> None:
        obs = self.observer
        if obs is None:
            return
        try:
            obs(kind, **fields)
        except Exception:  # noqa: BLE001 — see observer comment
            pass

    def acquire(self, key, build: Callable[[], "Engine"],
                cause: Optional[str] = None) -> "Engine":
        """Lease the engine for ``key``: LRU hit (warm — milliseconds)
        or ``build()`` (cold — trace/compile; runs OUTSIDE the pool lock
        so one slow compile can't block every other bucket's lease, with
        a per-key latch so concurrent admits of the same signature
        compile once). ``cause`` labels the ledger event (admission /
        quality / precompile / …)."""
        while True:
            with self._lock:
                if self.closed:
                    raise RuntimeError("program pool is closed")
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    ent[1] += 1
                    self.hits += 1
                    engine = ent[0]
                    break
                latch = self._building.get(key)
                if latch is None:
                    self._building[key] = latch = threading.Event()
                    engine = None
                    break
            latch.wait(timeout=300.0)  # builder finished (or died): re-check
        if engine is not None:
            self._notify("pool_acquire", cause=cause, key=key,
                         cache="hit", engine=engine)
            return engine
        t_build = time.perf_counter()
        try:
            engine = build()
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            latch.set()
            raise
        build_ms = (time.perf_counter() - t_build) * 1e3
        with self._lock:
            if self.closed:
                # close() raced the build: the pool's free sweep already
                # ran, so inserting now would leak a live program that
                # nothing ever frees. Refuse (below, outside the lock,
                # after freeing what we built).
                self._building.pop(key, None)
                raced_close = True
            else:
                raced_close = False
                self.misses += 1
                self._entries[key] = [engine, 1]
                _register_pool_engine(engine)
                self._building.pop(key, None)
                evicted = self._evict_over_capacity_locked()
        latch.set()
        if raced_close:
            engine.free()
            raise RuntimeError("program pool is closed")
        self._notify("compile", cause=cause, key=key, cache="miss",
                     wall_ms=build_ms, engine=engine)
        self._free_evicted(evicted)
        return engine

    def adopt(self, key, engine: "Engine") -> None:
        """Insert an externally built engine as a leased entry — how the
        frontend's default bucket (whose engine may be caller-built and
        predate its key being known) joins the pool once pinned.
        Raises RuntimeError on a closed pool (adopt racing the owner's
        stop must not insert a program the close sweep already missed)."""
        with self._lock:
            if self.closed:
                raise RuntimeError("program pool is closed")
            if key in self._entries:
                ent = self._entries[key]
                if ent[0] is engine:
                    return
                raise ValueError(f"pool already holds a different engine "
                                 f"for {key}")
            self._entries[key] = [engine, 1]
            self._entries.move_to_end(key)
            _register_pool_engine(engine)
            evicted = self._evict_over_capacity_locked()
        self._free_evicted(evicted)

    def release(self, key) -> None:
        """Drop one lease. The program STAYS warm (that is the point —
        the next admit of this signature is a pool hit) until capacity
        pressure evicts it."""
        evicted = []
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return
            ent[1] = max(0, ent[1] - 1)
            evicted = self._evict_over_capacity_locked()
        self._free_evicted(evicted)

    def replace(self, key, engine: "Engine") -> None:
        """Swap the live engine under an existing lease (supervised
        recovery rebuilt it); the old engine's buffers are freed. On a
        closed pool the rebuilt engine is freed and the call raises —
        a recovery racing the owner's stop() must not insert a program
        the close sweep already missed. A concurrently-retired key
        re-enters WARM (lease 0): nothing holds it, so capacity
        pressure may evict it immediately."""
        old = None
        evicted: List[Tuple[Any, "Engine"]] = []
        with self._lock:
            if self.closed:
                raced_close = True
            else:
                raced_close = False
                ent = self._entries.get(key)
                if ent is None:
                    self._entries[key] = [engine, 0]
                    _register_pool_engine(engine)
                    evicted = self._evict_over_capacity_locked()
                else:
                    old = ent[0]
                    ent[0] = engine
                    _register_pool_engine(engine)
        if raced_close:
            engine.free()
            raise RuntimeError("program pool is closed")
        self._free_evicted(evicted)
        if old is not None and old is not engine:
            old.free()

    def _evict_over_capacity_locked(self) -> List[Tuple[Any, "Engine"]]:
        """Pop LRU un-leased entries while over capacity; leased entries
        are skipped (a live program can't be freed under its bucket), so
        the pool may transiently exceed capacity when every entry is
        leased — bounded by the frontend's max_buckets. Returns
        ``(key, engine)`` pairs for the caller to free (and ledger)
        outside the lock."""
        out: List[Tuple[Any, "Engine"]] = []
        if len(self._entries) <= self.capacity:
            return out
        for key in list(self._entries):
            if len(self._entries) <= self.capacity:
                break
            if self._entries[key][1] == 0:
                out.append((key, self._entries.pop(key)[0]))
                self.evictions += 1
        return out

    def _free_evicted(self, evicted: List[Tuple[Any, "Engine"]]) -> None:
        for key, e in evicted:
            e.free()
            self._notify("pool_evict", cause="capacity", key=key,
                         engine=e)

    def evict(self, key) -> bool:
        """Explicitly drop one un-leased entry (tests; manual cache
        control). False when absent or still leased."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or ent[1] > 0:
                return False
            engine = self._entries.pop(key)[0]
            self.evictions += 1
        engine.free()
        self._notify("pool_evict", cause="manual", key=key, engine=engine)
        return True

    def warm_keys(self) -> List:
        """Signatures this pool can serve without a compile — what
        admission-rejection messages enumerate and the fleet's
        warm-replica preference matches against."""
        with self._lock:
            return list(self._entries)

    def peek(self, key) -> Optional["Engine"]:
        """The warm engine under ``key`` WITHOUT taking a lease — the
        audit plane's divergence probe runs through it (a replica is
        'warm on a signature' whether the program is bucket-leased or
        pool-idle). None when absent; the caller must tolerate a
        concurrent eviction (the freed engine's probe raises, which the
        probe paths already contain as 'unprobeable')."""
        with self._lock:
            ent = self._entries.get(key)
            return ent[0] if ent is not None else None

    def close(self) -> None:
        """Free every entry (frontend stop): after this, no pool engine
        holds device buffers — pinned by the port's leak guards."""
        with self._lock:
            self.closed = True
            engines = [ent[0] for ent in self._entries.values()]
            self._entries.clear()
        for e in engines:
            e.free()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._entries),
                "capacity": self.capacity,
                "leased": sum(1 for ent in self._entries.values()
                              if ent[1] > 0),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


# ---------------------------------------------------------------------------
# Kernel-build cache (the counterpart of the reference's persistent
# compilation cache)
# ---------------------------------------------------------------------------

# The port compiles no XLA program: what it compiles is its CUDA kernels
# (ops/_build.py, nvcc) and its host shims (transport/_native.py, g++).
# Both build into one directory under names keyed by a hash of source and
# flags, so the directory is a cache: one serves every checkout state and
# every process. The environment variable (read when the two modules are
# imported) hands a chosen directory to child processes, as the fleet's
# process replicas get it through ``FleetConfig.replica_env``.
COMPILE_CACHE_ENV = "DVF_COMPILE_CACHE_DIR"
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
DEFAULT_COMPILE_CACHE_BYTES = 512 * 1024 * 1024


def prune_compilation_cache(cache_dir: str,
                            max_bytes: int = DEFAULT_COMPILE_CACHE_BYTES,
                            keep=()) -> int:
    """Bound the cache dir: delete oldest-mtime files until the total is
    under ``max_bytes``. Returns files removed. Files in ``keep``
    (absolute paths of loaded libraries) and the ``.tmp`` files of builds
    in flight are never deleted. Best-effort (a concurrent process may be
    writing)."""
    keep = {os.path.abspath(k) for k in keep}
    files = []
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    for name in names:
        path = os.path.join(cache_dir, name)
        if name.endswith(".tmp") or not os.path.isfile(path):
            continue
        try:
            st = os.stat(path)
        except OSError:
            continue
        files.append((st.st_mtime, st.st_size, path))
    total = sum(size for _, size, _ in files)
    removed = 0
    for _, size, path in sorted(files):
        if total <= max_bytes:
            break
        if os.path.abspath(path) in keep:
            continue
        try:
            os.remove(path)
            removed += 1
            total -= size
        except OSError:
            pass
    return removed


def enable_compilation_cache(
    cache_dir: Optional[str] = None,
    max_bytes: int = DEFAULT_COMPILE_CACHE_BYTES,
) -> str:
    """Point the kernel and shim builds at ``cache_dir`` (default: the
    ``DVF_COMPILE_CACHE_DIR`` variable, else ``dvf_tpu_torch/_build/``)
    and bound it by :func:`prune_compilation_cache`, oldest first.

    A library already loaded stays loaded as it is: it is neither
    reloaded from the new directory nor deleted by the prune. Later
    builds land in the new directory, and a library already built there
    loads without a build. Returns the directory used.
    """
    from pathlib import Path

    from dvf_tpu_torch.ops import _build
    from dvf_tpu_torch.transport import _native

    cache_dir = os.path.abspath(cache_dir
                                or os.environ.get(COMPILE_CACHE_ENV)
                                or DEFAULT_COMPILE_CACHE_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    prune_compilation_cache(cache_dir, max_bytes,
                            keep=_build.loaded_paths() | _native.loaded_paths())
    _build.BUILD_DIR = Path(cache_dir)
    _native.BUILD_DIR = Path(cache_dir)
    return cache_dir
