"""Stall watchdog + supervised recovery (port of
``dvf_tpu.resilience.supervisor``).

The containment sites catch errors that raise. They are blind to the
silent failure modes: a device batch whose result never completes, a
collect thread wedged in a fetch, a thread that died without setting the
stop flag.

:class:`InflightWindow`
    Lock-protected registry of submitted-but-uncollected batches, keyed
    by dispatch sequence number, each carrying its submit time (monotonic
    clock) and an opaque payload. The age of the oldest entry is the
    watchdog signal.

:class:`Supervisor`
    A daemon thread polling the window age and registered thread
    heartbeats. On a stall it invokes the owner's ``on_stall`` callback
    synchronously (the callback performs recovery: shed the window,
    rebuild the engine) and only resumes watching when the callback
    returns, so one stall produces one recovery, not a storm.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class InflightWindow:
    """Submitted-but-uncollected batches, oldest-age queryable."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, Tuple[float, Any]] = {}

    def add(self, key: int, payload: Any = None) -> None:
        with self._lock:
            self._entries[key] = (time.monotonic(), payload)

    def remove(self, key: int) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def oldest_age(self, now: Optional[float] = None) -> Optional[float]:
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self._entries:
                return None
            return now - min(t for t, _ in self._entries.values())

    def drain(self) -> List[Tuple[int, Any]]:
        """Atomically empty the window; returns ``(key, payload)`` pairs
        (recovery sheds these — their results are written off)."""
        with self._lock:
            out = [(k, p) for k, (_, p) in self._entries.items()]
            self._entries.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class Supervisor:
    """Watchdog thread over an :class:`InflightWindow` + thread heartbeats.

    ``on_stall(reason)`` runs in the supervisor thread; it must be safe to
    call concurrently with the supervised threads (the serve/pipeline
    recovery procedures are written for exactly that).
    """

    def __init__(
        self,
        stall_timeout_s: float,
        on_stall: Callable[[str], None],
        poll_s: Optional[float] = None,
        name: str = "dvf-supervisor",
        window: Optional[InflightWindow] = None,
        on_trip: Optional[Callable[[str], None]] = None,
    ):
        if stall_timeout_s <= 0:
            raise ValueError("stall_timeout_s must be > 0")
        self.stall_timeout_s = stall_timeout_s
        self.on_stall = on_stall
        # Observability tap, fired BEFORE on_stall so it sees the wedged
        # state recovery is about to tear down (the serve frontend hangs
        # its flight-recorder dump here). Best-effort: its failure must
        # neither block nor abort the recovery itself.
        self.on_trip = on_trip
        self.poll_s = poll_s if poll_s is not None else min(
            0.25, stall_timeout_s / 4.0)
        self.name = name
        # The owner may share its own window (the serve frontend tracks
        # in-flight batches even with the watchdog off, so budget-driven
        # recovery can still shed them) — else the supervisor owns one.
        self.window = window if window is not None else InflightWindow()
        self.stalls = 0
        self._beats: Dict[str, float] = {}
        self._beats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration ----------------------------------------------------

    def beat(self, name: str) -> None:
        """Record liveness for one supervised loop (call every iteration
        — cheap: one dict store under a lock)."""
        with self._beats_lock:
            self._beats[name] = time.monotonic()

    def heartbeat_ages(self) -> Dict[str, float]:
        now = time.monotonic()
        with self._beats_lock:
            return {k: round(now - t, 3) for k, t in self._beats.items()}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Supervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._thread = threading.Thread(
            target=self._loop, name=self.name, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- watchdog --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            age = self.window.oldest_age()
            if age is not None and age > self.stall_timeout_s:
                self._trip(f"in-flight batch stalled {age:.2f}s "
                           f"(> {self.stall_timeout_s}s)")

    def _trip(self, reason: str) -> None:
        self.stalls += 1
        if self.on_trip is not None:
            try:
                self.on_trip(reason)
            except Exception as e:  # noqa: BLE001 — a broken observer
                import sys             # must never block recovery

                print(f"[supervisor] on_trip raised (ignored): {e!r}",
                      file=sys.stderr, flush=True)
        try:
            self.on_stall(reason)
        except Exception as e:  # noqa: BLE001 — a failed recovery must not
            # kill the watchdog; the next poll re-trips (and the owner's
            # error budget escalates to a hard fail).
            import sys

            print(f"[supervisor] recovery raised (will re-trip): {e!r}",
                  file=sys.stderr, flush=True)
