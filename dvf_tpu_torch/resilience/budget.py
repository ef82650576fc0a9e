"""Per-kind error budgets: bounded containment with drop → degrade → fail
(port of ``dvf_tpu.resilience.budget``).

Each :class:`~dvf_tpu_torch.resilience.faults.FaultKind` gets a budget of
N contained faults inside a sliding window of T seconds, and overflowing
the budget escalates instead of looping:

1. within budget  → ``"contain"`` — drop the frame/batch, count, continue;
2. first overflow → ``"degrade"`` — the site applies its degradation if it
   has one (streamed→monolithic ingest after repeated ``h2d`` faults,
   streamed→monolithic egress after repeated ``d2h`` faults) and the
   window restarts so the degraded configuration gets a fresh budget;
3. second overflow → ``"fail"`` — the degraded configuration is also
   broken; surface a hard error rather than shedding frames forever.

Sites with no degradation for a kind treat ``"degrade"`` as ``"fail"``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional


class ErrorBudget:
    """Sliding-window fault budget with a per-kind escalation ladder."""

    CONTAIN = "contain"
    DEGRADE = "degrade"
    FAIL = "fail"

    def __init__(self, limit: int = 16, window_s: float = 30.0,
                 limits: Optional[Dict[str, int]] = None):
        if limit < 1:
            raise ValueError("fault budget limit must be >= 1")
        self.limit = limit
        self.window_s = window_s
        self.limits = dict(limits) if limits else {}
        self._lock = threading.Lock()
        self._events: Dict[str, Deque[float]] = collections.defaultdict(
            collections.deque)
        self._level: Dict[str, int] = {}

    def record(self, kind: str, now: Optional[float] = None) -> str:
        """Count one contained fault of ``kind``; returns the action."""
        now = time.monotonic() if now is None else now
        limit = self.limits.get(kind, self.limit)
        with self._lock:
            dq = self._events[kind]
            dq.append(now)
            cutoff = now - self.window_s
            while dq and dq[0] < cutoff:
                dq.popleft()
            if len(dq) <= limit:
                return self.CONTAIN
            # Budget overflowed. Restart the window either way: the caller
            # is about to change something (degrade) or die (fail), and a
            # stale backlog must not instantly re-trip the fresh state.
            dq.clear()
            level = self._level.get(kind, 0)
            self._level[kind] = level + 1
            return self.DEGRADE if level == 0 else self.FAIL

    def level(self, kind: str) -> int:
        """0 = never overflowed, 1 = degraded once, >=2 = failed."""
        with self._lock:
            return self._level.get(kind, 0)

    def summary(self) -> dict:
        with self._lock:
            return {
                "limit": self.limit,
                "window_s": self.window_s,
                "escalations": dict(self._level),
            }


def escalate(budget: ErrorBudget, kind: str, degrade=None) -> str:
    """The shared containment ladder, one step: record a contained fault
    and resolve it to ``CONTAIN`` or ``FAIL``.

    Within budget → ``CONTAIN``. On the first overflow the site's
    ``degrade(kind)`` callback runs; a successful degradation folds back
    to ``CONTAIN`` (the degraded configuration gets the fresh window
    ``record`` started). Everything else → ``FAIL``. Sites whose normal
    containment already *is* the recovery (the worker's geometry
    re-probe, stall recovery) pass ``degrade=lambda kind: True`` so the
    first overflow keeps containing and only the second fails. One
    helper, three callers (pipeline, serve frontend, ZMQ worker) — the
    ladder can't drift between them.
    """
    action = budget.record(kind)
    if action == ErrorBudget.CONTAIN:
        return action
    if action == ErrorBudget.DEGRADE and degrade is not None and degrade(kind):
        return ErrorBudget.CONTAIN
    return ErrorBudget.FAIL
