"""Window arithmetic and the two load shapes the drivers use.

- A rate is all the work completed inside the window over the window's
  whole length: a stall inside it lowers the rate, it is never cut out.
- A tail is a percentile over every sample due in the window; a sample
  that never came counts as beyond any limit (``inf``).
- The open loop stamps each item's due time from the schedule alone
  (``start + phase + k / rate``): a late generator never moves the
  schedule, and its lateness is measured apart.
- The closed loop holds the source while more than ``window`` items are
  between it and the sink, and never drops one.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence


def rate(times: Iterable[float], start: float, end: float) -> float:
    """Items whose completion time lies in ``[start, end]``, per second of
    the whole window."""
    if end <= start:
        raise ValueError("empty window")
    return sum(1 for t in times if start <= t <= end) / (end - start)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    closest ranks (numpy's default), over every value given; ``inf``
    entries (items that never came) sort last."""
    if not values:
        raise ValueError("no samples")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def due_times(start: float, phase: float, period: float, end: float) -> List[float]:
    """The open-loop schedule: every due time ``start + phase + k·period``
    that falls before ``end``."""
    out = []
    k = 0
    while True:
        t = start + phase + k * period
        if t >= end:
            return out
        out.append(t)
        k += 1


class OpenLoop:
    """Fire ``emit(k, due)`` for each due time in order, sleeping until it is
    due and never later shifting the schedule; records how late each call
    came (``late[k] = call time − due``). ``clock`` and ``sleep`` are
    injectable for tests."""

    def __init__(self, due: Sequence[float], emit: Callable[[int, float], None],
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 stop: Optional[threading.Event] = None):
        self.due = list(due)
        self.emit = emit
        self.clock = clock
        self.sleep = sleep
        self.stop = stop or threading.Event()
        self.late: List[float] = []

    def run(self) -> None:
        for k, t in enumerate(self.due):
            if self.stop.is_set():
                return
            now = self.clock()
            if now < t:
                self.sleep(t - now)
                now = self.clock()
            self.late.append(max(0.0, now - t))
            self.emit(k, t)


class ClosedLoop:
    """Admission for a closed-loop source: ``admit()`` blocks while more than
    ``window`` items are outstanding (admitted and not yet ``done``)."""

    def __init__(self, window: int):
        self.window = window
        self.admitted = 0
        self.done = 0
        self._cv = threading.Condition()

    def admit(self, stop: Optional[threading.Event] = None) -> bool:
        with self._cv:
            while self.admitted - self.done >= self.window:
                if stop is not None and stop.is_set():
                    return False
                self._cv.wait(0.05)
            self.admitted += 1
            return True

    def complete(self, n: int = 1) -> None:
        with self._cv:
            self.done += n
            self._cv.notify_all()

    def wait_done(self, n: int, timeout: float) -> bool:
        """Block until ``n`` items are done; False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.done < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
            return True
