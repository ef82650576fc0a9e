"""Bounded frame queues with the reference's backpressure semantics (a
copy of ``dvf_tpu.sched.queues``, which the port may not import).

``DropOldestQueue`` ports the enqueue policy of
``Distributor.add_frame_for_distribution`` (distributor.py:173-203):
a bounded queue (reference maxsize=10, distributor.py:11) where an enqueue
into a full queue evicts the oldest entry and retries, and drops the new
frame only if the retry also fails. Freshness beats completeness — a live
video pipeline never blocks the producer.

Unlike the reference (which leans on the GIL), this is explicitly locked:
the framework's producers/consumers are real threads around a device
dispatch loop (SURVEY.md §5.2 calls out the races to make explicit).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Optional


class DropOldestQueue:
    """Bounded FIFO; `put` never blocks — it evicts the oldest when full."""

    def __init__(self, maxsize: int = 10):
        if maxsize <= 0:
            raise ValueError("maxsize must be positive")
        self.maxsize = maxsize
        self._dq: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.dropped = 0  # total evicted or rejected entries
        self.put_total = 0

    def put(self, item: Any) -> Optional[Any]:
        """Enqueue; returns the evicted item if one was displaced, else None."""
        with self._lock:
            evicted = None
            if len(self._dq) >= self.maxsize:
                evicted = self._dq.popleft()  # distributor.py:195-198
                self.dropped += 1
            self._dq.append(item)
            self.put_total += 1
            self._not_empty.notify()
            return evicted

    def get(self, timeout: Optional[float] = None) -> Any:
        """Dequeue oldest; raises TimeoutError on timeout, blocks if None."""
        with self._not_empty:
            if not self._dq:
                if not self._not_empty.wait_for(lambda: bool(self._dq), timeout):
                    raise TimeoutError("queue empty")
            return self._dq.popleft()

    def get_nowait(self) -> Any:
        with self._lock:
            if not self._dq:
                raise TimeoutError("queue empty")
            return self._dq.popleft()

    def pop_up_to(self, n: int) -> list:
        """Pop up to n oldest items in FIFO order (no dropping).

        The batch assembler consumes with this; freshness is enforced
        *only* by the queue bound (put-side drop-oldest), exactly where the
        reference enforces it (distributor.py:193-203) — staleness is
        bounded by maxsize frames regardless of consumer speed.
        """
        with self._lock:
            n = min(n, len(self._dq))
            return [self._dq.popleft() for _ in range(n)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)
