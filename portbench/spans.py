"""The benchmark's own host spans, around its calls into each layer.

A span is ``(name, start, end)`` on ``time.perf_counter``; spans are kept
in memory per thread and read when the run ends. They name the idle gaps
of the device trace and feed span-based metrics (dispatch time per step,
the generator's lateness).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

Span = Tuple[str, float, float]


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self._by_thread: Dict[int, List[Span]] = {}

    def _list(self) -> List[Span]:
        tid = threading.get_ident()
        lst = self._by_thread.get(tid)
        if lst is None:
            with self._lock:
                lst = self._by_thread.setdefault(tid, [])
        return lst

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._list().append((name, t0, time.perf_counter()))

    def all(self) -> List[Span]:
        with self._lock:
            return sorted((s for lst in self._by_thread.values() for s in lst),
                          key=lambda s: s[1])

    def named(self, name: str, start: Optional[float] = None,
              end: Optional[float] = None) -> List[Span]:
        """Spans called ``name`` that start inside ``[start, end]``."""
        return [s for s in self.all() if s[0] == name
                and (start is None or s[1] >= start)
                and (end is None or s[1] <= end)]

    def at(self, t: float) -> str:
        """The innermost span open at host time ``t`` (the latest started),
        or ``outside_spans``."""
        best = None
        for s in self.all():
            if s[1] <= t <= s[2] and (best is None or s[1] > best[1]):
                best = s
        return best[0] if best is not None else "outside_spans"
