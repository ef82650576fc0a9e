"""Device engine: batched filter execution on one device (port of the
single-device path of ``dvf_tpu.runtime.engine``).

``submit`` takes a uint8 NHWC batch from host memory (pinned, on the
pipeline's path) and, on the launching thread's current CUDA stream:

1. copies it host→device (``non_blocking``);
2. casts to the filter's compute dtype, runs the filter, casts back to
   uint8 — all on the device;
3. starts the device→host copy into a host output buffer (pinned);
4. records a CUDA event and returns a :class:`BatchResult` whose
   ``is_ready``/``fetch`` poll or wait on that event.

uint8 crosses the host link in both directions (a quarter of float32's
bytes). Filter state stays on the device across batches; ``reset_state``
starts a new stream on the same engine, ``free`` drops the state. The mesh and
halo routing, resident submission, probes, hot swap and the calibrations
of the reference wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.utils.image import to_float, to_uint8


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


class BatchResult:
    """A submitted batch. Its output lands in ``host`` (a CPU tensor)
    once ``event`` has completed; ``event`` is None on the CPU, where the
    output is already there."""

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event]):
        self.host = host
        self._event = event

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def fetch(self) -> np.ndarray:
        """Wait for the device→host copy; the output as a numpy view of
        ``host``."""
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
                 device: Union[None, str, torch.device] = None):
        self.filter = filt
        self.device = resolve_device(device)
        self.stats = EngineStats()
        self._signature: Optional[Tuple] = None
        self._state: Any = None
        self.freed = False  # set by free(): no state, no further submits
        self.out_shape: Optional[Tuple[int, ...]] = None  # set by compile()
        self.out_dtype: Optional[np.dtype] = None

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

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
        if x.dtype == torch.uint8 and not f.uint8_ok:
            x = to_float(x, f.compute_dtype)
        y, state = f.fn(x, state)
        if y.dtype != torch.uint8:
            y = to_uint8(y)
        return y, state

    def compile(self, batch_shape: Tuple[int, ...], dtype=np.uint8) -> None:
        """Prepare for a fixed (B, H, W, C) signature: build the state and
        make one warm-up call (so the kernel build and first launch fall
        outside the stream), then reset the state."""
        sig = (tuple(batch_shape), np.dtype(dtype))
        if sig == self._signature:
            return
        self._refuse_if_freed()
        self._state = self._fresh_state(batch_shape, dtype)
        zeros = torch.zeros(tuple(batch_shape), dtype=_torch_dtype(dtype),
                            pin_memory=self.on_cuda)
        with torch.no_grad():
            out, _ = self._step(zeros.to(self.device), self._state)
        if self.on_cuda:
            torch.cuda.synchronize(self.device)
        self.out_shape = tuple(out.shape)
        self.out_dtype = _torch_to_np(out.dtype)
        self._state = self._fresh_state(batch_shape, dtype)
        self._signature = sig
        self.stats.compile_count += 1

    def ensure_compiled(self, batch_shape: Tuple[int, ...], dtype=np.uint8) -> None:
        """Compile for a signature unless already compiled for it (what the
        pipeline calls before sizing its staging slots)."""
        self.compile(tuple(batch_shape), dtype)

    def submit(self, batch: Union[np.ndarray, torch.Tensor],
               out: Optional[torch.Tensor] = None) -> BatchResult:
        """Dispatch one host batch; returns at once with a BatchResult.

        ``batch`` should sit in pinned memory for the copy to be
        asynchronous. ``out`` is the host buffer the output is copied into
        (pinned, shape ``out_shape``); None allocates one. The caller must
        not rewrite ``batch`` or read ``out`` before the result is ready.
        """
        self._refuse_if_freed()
        host = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(batch))
        if host.device.type != "cpu":
            raise ValueError(f"submit takes a host batch, got one on {host.device}")
        if self._signature != (tuple(host.shape), _torch_to_np(host.dtype)):
            self.compile(tuple(host.shape), _torch_to_np(host.dtype))
        event = None
        with torch.no_grad():
            x = host.to(self.device, non_blocking=True)
            y, self._state = self._step(x, self._state)
            if out is None:
                out = torch.empty(y.shape, dtype=y.dtype, pin_memory=self.on_cuda)
            out.copy_(y, non_blocking=True)
            if self.on_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        self.stats.batches += 1
        self.stats.frames += host.shape[0]
        return BatchResult(out, event)

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


def _torch_to_np(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype
