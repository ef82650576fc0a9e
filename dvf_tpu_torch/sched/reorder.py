"""Sink-side reorder / jitter buffer (a copy of ``dvf_tpu.sched.reorder``,
which the port may not import).

Ports the fully-specified invariants of the reference's reorder logic
(distributor.py:291-344) — the piece of the design that survives the TPU
re-architecture unchanged in *spec* but shrinks in *role*: batches complete
in submission order on the device, so out-of-order arrival only happens at
the edges (multi-host async mode, elastic CPU workers via the ZMQ ingress).
The buffer is the display sink's shock absorber either way.

Semantics preserved exactly (held to the reference on a seeded schedule in
tests/test_torch_pipeline.py):

- completed frames land keyed by index; ``latest`` is the max index seen
  (distributor.py:271-279);
- the display cursor lags ``latest`` by ``frame_delay`` frames
  (distributor.py:326-328; default 5, webcam_app.py:17);
- the cursor advances even when the target frame is missing — never stall
  on a lost frame (distributor.py:334-338);
- before the pipeline is ``frame_delay`` deep, the cursor tracks ``latest``
  directly (distributor.py:339-343);
- reads fall back to the closest available index (distributor.py:317-321);
- eviction: entries older than the cursor (distributor.py:293-299) and a
  hard capacity cap evicting oldest (default 50; distributor.py:23,302-307).

Thread-safe by lock, unlike the reference's GIL-reliant shared dict
(SURVEY.md §5.2).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class ReorderBuffer:
    def __init__(self, frame_delay: int = 5, capacity: int = 50):
        self.frame_delay = frame_delay
        self.capacity = capacity
        self._frames: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self.latest = -1          # latest_received_frame (ref inits 0; -1 = none seen)
        self.cursor = 0           # current_display_frame
        self.completed_total = 0
        self.evicted_total = 0

    # -- producer side -----------------------------------------------------

    def complete(self, index: int, payload: Any) -> None:
        """A processed frame arrived (collect path, distributor.py:269-282)."""
        with self._lock:
            self._frames[index] = payload
            self.latest = max(self.latest, index)
            self.completed_total += 1
            self._evict_locked()

    # -- consumer side -----------------------------------------------------

    def advance(self) -> bool:
        """Move the display cursor; returns True if it changed
        (update_display_frame, distributor.py:324-344)."""
        with self._lock:
            if self.latest >= self.frame_delay:
                target = self.latest - self.frame_delay
                # Advance whether or not the target exists — a missing frame
                # is dropped, not waited for (distributor.py:330-338). Unlike
                # the reference (whose `target in received_frames` disjunct
                # can replay old content by moving the cursor backwards), the
                # cursor here is strictly monotonic.
                if target >= self.cursor:
                    self.cursor = target
                    return True
                return False
            elif self.latest > 0:
                if self.cursor < self.latest:
                    self.cursor = self.latest  # distributor.py:339-343
                    return True
            return False

    def get(self) -> Optional[Any]:
        """Payload at the cursor, else closest available index, else None
        (get_frame_to_display, distributor.py:309-322)."""
        with self._lock:
            target = self.cursor
            if target in self._frames:
                return self._frames[target]
            if self._frames:
                closest = min(self._frames, key=lambda i: abs(i - target))
                return self._frames[closest]
            return None

    def pop_ready(self) -> list:
        """Drain all frames at or below the cursor in order (streaming-sink
        consumption — lets a non-display sink emit every frame exactly once,
        a mode the reference's display-only sink doesn't need)."""
        with self._lock:
            ready = sorted(i for i in self._frames if i <= self.cursor)
            return [(i, self._frames.pop(i)) for i in ready]

    # -- maintenance -------------------------------------------------------

    def flush(self) -> None:
        """End of stream: move the cursor to the newest frame so the tail
        (< frame_delay deep) can still be delivered via pop_ready()."""
        with self._lock:
            if self.latest > self.cursor:
                self.cursor = self.latest

    def _evict_locked(self) -> None:
        evicted = 0
        # Rule 1: older than the display cursor (distributor.py:293-299).
        for i in [i for i in self._frames if i < self.cursor]:
            del self._frames[i]
            evicted += 1
        # Rule 2: capacity cap, evict oldest (distributor.py:302-307).
        if len(self._frames) > self.capacity:
            for i in sorted(self._frames)[: len(self._frames) - self.capacity]:
                del self._frames[i]
                evicted += 1
        self.evicted_total += evicted

    def stats(self) -> Dict[str, int]:
        """get_frame_stats equivalent (distributor.py:346-354)."""
        with self._lock:
            return {
                "buffer_size": len(self._frames),
                "current_display_frame": self.cursor,
                "latest_received_frame": self.latest,
                "frame_delay": self.frame_delay,
                "completed_total": self.completed_total,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._frames)
