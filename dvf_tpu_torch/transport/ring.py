"""ctypes binding for the port's native frame ring (``ring.cpp``, a copy of
the JAX package's), port of ``dvf_tpu/transport/ring.py``.

The source is built by :mod:`dvf_tpu_torch.transport._native` into the
git-ignored ``dvf_tpu_torch/_build/`` under a content-hashed name. A
missing g++ or a failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ring.cpp")
_LOAD_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        from dvf_tpu_torch.transport._native import load_native

        # PyDLL: keep the GIL across calls. Every ring op is sub-microsecond;
        # releasing and retaking the GIL per call (CDLL) makes producer and
        # consumer threads hand it back and forth at the interpreter's
        # switch interval (~5 ms a call). Processes sharing a shm ring do
        # not share a GIL at all.
        lib = load_native(_SRC, cdll_cls=ctypes.PyDLL)
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_uint64]
        lib.ring_create_shm.restype = ctypes.c_void_p
        lib.ring_create_shm.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.ring_push.restype = ctypes.c_int64
        lib.ring_push.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_double,
        ]
        lib.ring_pop.restype = ctypes.c_int64
        lib.ring_pop.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_double),
        ]
        for name in ("ring_approx_len", "ring_dropped", "ring_pushed",
                     "ring_popped", "ring_capacity"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        lib.ring_destroy.restype = None
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class FrameRing:
    """Bounded frame queue with drop-oldest overflow (the reference's
    ingest semantics, distributor.py:188-203), backed by the native ring.

    ``shm_name``: attach to or create a POSIX shared-memory ring for use
    across processes (camera process → framework process); None = a
    private ring for thread-to-thread handoff.
    """

    def __init__(
        self,
        capacity_bytes: int = 64 << 20,
        shm_name: Optional[str] = None,
        create: bool = True,
        max_frame_bytes: int = 32 << 20,
    ):
        lib = _load()
        if shm_name is not None:
            self._ptr = lib.ring_create_shm(
                shm_name.encode(), capacity_bytes, 1 if create else 0)
        else:
            self._ptr = lib.ring_create(capacity_bytes)
        if not self._ptr:
            raise OSError(f"failed to create frame ring (shm={shm_name!r})")
        self._lib = lib
        self._buf = ctypes.create_string_buffer(max_frame_bytes)

    def push(self, payload: bytes, frame_index: int, timestamp: float) -> int:
        """Returns how many old frames were evicted to make room."""
        if len(payload) > len(self._buf):
            # A record bigger than the pop buffer would enqueue and then
            # wedge the consumer (every pop would raise on the same head
            # record): oversized input fails at the producer.
            raise ValueError(
                f"frame of {len(payload)} bytes exceeds max_frame_bytes "
                f"{len(self._buf)}")
        n = self._lib.ring_push(self._live_ptr(), payload, len(payload),
                                frame_index, timestamp)
        if n < 0:
            raise ValueError(f"frame of {len(payload)} bytes exceeds ring capacity")
        return int(n)

    def pop(self) -> Optional[Tuple[bytes, int, float]]:
        """(payload, frame_index, timestamp) or None if empty."""
        idx = ctypes.c_uint64()
        ts = ctypes.c_double()
        n = self._lib.ring_pop(self._live_ptr(), self._buf, len(self._buf),
                               ctypes.byref(idx), ctypes.byref(ts))
        if n == 0:
            return None
        if n < 0:
            raise ValueError(f"frame needs {-n} bytes; raise max_frame_bytes")
        # string_at copies exactly n bytes (buf.raw would copy the whole
        # pop buffer for every record).
        return ctypes.string_at(self._buf, int(n)), int(idx.value), float(ts.value)

    def pop_up_to(self, n: int) -> list:
        """Pop up to n records in FIFO order (the batch drain of the
        pipeline's ring queue and the worker's ring)."""
        out = []
        for _ in range(n):
            rec = self.pop()
            if rec is None:
                break
            out.append(rec)
        return out

    def _live_ptr(self):
        if not self._ptr:
            # ctypes would pass NULL through to C and crash the
            # interpreter: use after close is a Python error instead.
            raise ValueError("FrameRing is closed")
        return self._ptr

    def __len__(self) -> int:
        return int(self._lib.ring_approx_len(self._live_ptr()))

    @property
    def dropped(self) -> int:
        return int(self._lib.ring_dropped(self._live_ptr()))

    @property
    def pushed(self) -> int:
        return int(self._lib.ring_pushed(self._live_ptr()))

    @property
    def popped(self) -> int:
        """Records consumed so far — across processes, the producer's sign
        that a consumer has attached and is draining."""
        return int(self._lib.ring_popped(self._live_ptr()))

    @property
    def capacity(self) -> int:
        return int(self._lib.ring_capacity(self._live_ptr()))

    def close(self) -> None:
        if getattr(self, "_ptr", None):
            self._lib.ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
