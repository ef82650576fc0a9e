"""Device engine: batched filter execution on one device (port of the
single-device path of ``dvf_tpu.runtime.engine``).

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
``h2d_block_ms``, ``d2h_block_ms`` and ``step_block_ms``. Not ported
yet: the mesh and halo routing, the compiled-program pool, hot swap
(``prepare_swap``/``commit_swap``), ``signature_key`` and XLA's
``cost_analysis``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
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
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _torch_to_np(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def record_event(stream) -> Optional[torch.cuda.Event]:
    """An event recorded on ``stream`` now (None for no stream: the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _tensor_bytes(tree) -> int:
    """Summed nbytes of the tensors in a state pytree (dicts, lists,
    tuples, tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


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
        self.device = device
        self.compute_event = compute_event
        self._event = event

    def is_ready(self) -> bool:
        ev = self._event if self.host is not None else self.compute_event
        return ev is None or ev.query()

    def fetch(self) -> np.ndarray:
        """Wait for the device→host copy; the output as a numpy view of
        ``host``."""
        if self.host is None:
            raise RuntimeError("batch was submitted with fetch=False: no "
                               "host copy exists")
        if self._event is not None:
            self._event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class EngineStats:
    batches: int = 0
    frames: int = 0
    compile_count: int = 0


class Engine:
    """Runs one filter on one device at one batch signature."""

    def __init__(self, filt: Filter,
                 device: Union[None, str, torch.device] = None,
                 out_uint8: bool = True,
                 chaos=None,
                 calibration_seed: Optional[dict] = None):
        self.filter = filt
        self.device = resolve_device(device)
        self.out_uint8 = out_uint8
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
        self._signature: Optional[Tuple] = None
        self._state: Any = None
        self.freed = False  # set by free(): no state, no further submits
        self.out_shape: Optional[Tuple[int, ...]] = None  # set by compile()
        self.out_dtype: Optional[np.dtype] = None
        self._h2d: Optional[torch.cuda.Stream] = None
        self._d2h: Optional[torch.cuda.Stream] = None

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def signature(self) -> Optional[Tuple]:
        """The compiled ``((B, H, W, C), dtype)`` signature, or None before
        the first compile."""
        return self._signature

    @property
    def h2d_stream(self) -> Optional[torch.cuda.Stream]:
        """The engine's host→device copy stream (None on the CPU)."""
        if self._h2d is None and self.on_cuda:
            self._h2d = torch.cuda.Stream(self.device)
        return self._h2d

    @property
    def d2h_stream(self) -> Optional[torch.cuda.Stream]:
        """The engine's device→host copy stream (None on the CPU)."""
        if self._d2h is None and self.on_cuda:
            self._d2h = torch.cuda.Stream(self.device)
        return self._d2h

    def _compute_stream(self):
        return torch.cuda.current_stream(self.device) if self.on_cuda else None

    def _fresh_state(self, batch_shape, dtype) -> Any:
        f = self.filter
        if not f.stateful:
            return None
        state_dtype = (f.compute_dtype
                       if np.dtype(dtype) == np.uint8 and not f.uint8_ok
                       else _torch_dtype(dtype))
        return f.init_state(tuple(batch_shape), state_dtype, self.device)

    def _step(self, x: torch.Tensor, state: Any):
        f = self.filter
        xin = x
        if x.dtype == torch.uint8 and not f.uint8_ok:
            x = to_float(x, f.compute_dtype)
        y, state = f.fn(x, state)
        if self.out_uint8 and y.dtype != torch.uint8:
            y = to_uint8(y)
        if y.untyped_storage().data_ptr() == xin.untyped_storage().data_ptr():
            # A filter that hands back its input (identity): the input is
            # a staging buffer that is rewritten a few batches later, so
            # the output must own its bytes.
            y = y.clone()
        return y, state

    def _put(self, host: torch.Tensor) -> torch.Tensor:
        """Host → device on the H2D stream; the compute stream waits for
        it. On the CPU the batch is used as it is."""
        if not self.on_cuda:
            return host
        h2d = self.h2d_stream
        with torch.cuda.stream(h2d):
            x = host.to(self.device, non_blocking=True)
        compute = self._compute_stream()
        compute.wait_event(record_event(h2d))
        x.record_stream(compute)
        return x

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

    def _sync(self) -> None:
        if self.on_cuda:
            torch.cuda.synchronize(self.device)

    def compile(self, batch_shape: Tuple[int, ...], dtype=np.uint8) -> None:
        """Prepare for a fixed (B, H, W, C) signature: build the state,
        make one warm-up call (so the kernel build and first launch fall
        outside the stream) and measure the calibrations as the reference
        does — a second, blocking pinned host→device copy after the
        warm-up put; a blocking device→host copy of the warm-up output
        into a pre-touched pinned buffer; one more blocking step — the
        last two skipped above ``_D2H_CALIBRATION_CAP_BYTES``. A
        ``calibration_seed`` with real h2d and step numbers replaces the
        measurements. The state is rebuilt after each step."""
        sig = (tuple(batch_shape), np.dtype(dtype))
        if sig == self._signature:
            return
        self._refuse_if_freed()
        t_compile0 = time.perf_counter()
        shape = tuple(batch_shape)
        self._state = self._fresh_state(shape, dtype)
        zeros = torch.zeros(shape, dtype=_torch_dtype(dtype),
                            pin_memory=self.on_cuda)
        seed = self.calibration_seed
        seeded = (isinstance(seed, dict)
                  and isinstance(seed.get("h2d_block_ms"), (int, float))
                  and isinstance(seed.get("step_block_ms"), (int, float)))
        self.calibration_seeded = seeded
        with torch.no_grad():
            warm = self._put(zeros)
            self._sync()
            if seeded:
                self.h2d_block_ms = float(seed["h2d_block_ms"])
            else:
                del warm
                t0 = time.perf_counter()
                warm = self._put(zeros)
                self._sync()
                self.h2d_block_ms = (time.perf_counter() - t0) * 1e3
            out, _ = self._step(warm, self._state)
            self._sync()
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
                ev = record_event(self._compute_stream())
                t0 = time.perf_counter()
                done = self._copy_out(out, dst, ev)
                if done is not None:
                    done.synchronize()
                self.d2h_block_ms = (time.perf_counter() - t0) * 1e3
                del dst
            else:
                self.d2h_block_ms = None
            del out
            self._state = self._fresh_state(shape, dtype)
            if seeded:
                self.step_block_ms = float(seed["step_block_ms"])
            elif zeros.numel() * zeros.element_size() <= _D2H_CALIBRATION_CAP_BYTES:
                t0 = time.perf_counter()
                out2, _ = self._step(warm, self._state)
                self._sync()
                self.step_block_ms = (time.perf_counter() - t0) * 1e3
                del out2
                self._state = self._fresh_state(shape, dtype)
            else:
                self.step_block_ms = None
        del warm
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

    def _run(self, x: torch.Tensor):
        """The step on the compute stream; returns (output, compute event)."""
        y, self._state = self._step(x, self._state)
        self.stats.batches += 1
        self.stats.frames += x.shape[0]
        return y, record_event(self._compute_stream())

    def submit(self, batch: Union[np.ndarray, torch.Tensor],
               out: Optional[torch.Tensor] = None,
               fetch: bool = True) -> BatchResult:
        """Dispatch one host batch; returns at once with a BatchResult.

        ``batch`` should sit in pinned memory for the copy to be
        asynchronous. ``out`` is the host buffer the output is copied into
        (pinned, shape ``out_shape``); None allocates one. ``fetch=False``
        skips the device→host copy (the egress fetcher or the coefficient
        wire reads ``BatchResult.device``). The caller must not rewrite
        ``batch`` or read ``out`` before the result is ready.
        """
        host = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(batch))
        if host.device.type != "cpu":
            raise ValueError(f"submit takes a host batch, got one on {host.device}")
        self._enter_submit(host.shape, _torch_to_np(host.dtype))
        event = None
        with torch.no_grad():
            y, cev = self._run(self._put(host))
            if fetch:
                if out is None:
                    out = torch.empty(y.shape, dtype=y.dtype,
                                      pin_memory=self.on_cuda)
                event = self._copy_out(y, out, cev)
            else:
                out = None
        return BatchResult(out, event, device=y, compute_event=cev)

    def submit_resident(self, batch: torch.Tensor,
                        ready: Optional[torch.cuda.Event] = None) -> BatchResult:
        """Serving entry for a batch already on the device: the streamed
        ingest path copied its chunks on the H2D stream, so the copy of
        :meth:`submit` is skipped. ``ready`` is the event recorded after
        the last chunk's copy; the compute stream waits for it before the
        step reads ``batch``. State threading, chaos sites and stats are
        those of :meth:`submit`. The result carries no host copy."""
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
            y, cev = self._run(batch)
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
        host = torch.from_numpy(np.ascontiguousarray(batch))
        with torch.no_grad():
            y, _ = self._step(host.to(self.device), None)
            return y.cpu().numpy()

    def rebuild(self) -> "Engine":
        """Fresh engine for supervised recovery: same filter, device and
        options, compiled at the old signature — the full compile() path,
        so the replacement is warmed and re-calibrated before it takes
        traffic. A stateful filter's state restarts fresh."""
        fresh = Engine(self.filter, device=self.device, out_uint8=self.out_uint8,
                       chaos=self.chaos)
        if self._signature is not None:
            shape, dtype = self._signature
            fresh.compile(shape, dtype)
        return fresh

    def reset_state(self) -> None:
        """Start a new stream on this engine: rebuild a stateful filter's
        state for the compiled signature, so the next batch does not see
        the last stream's frames (flow_warp passes its first batch
        through again)."""
        self._refuse_if_freed()
        if self.filter.stateful and self._signature is not None:
            self._state = self._fresh_state(*self._signature)

    def free(self) -> None:
        """Drop the device state and refuse further submits (and
        compiles). Idempotent. The caller frees after the last result it
        wants has been fetched."""
        self.freed = True
        self._state = None
        self._signature = None

    def _refuse_if_freed(self) -> None:
        if self.freed:
            raise RuntimeError("engine was freed; build a new Engine")
