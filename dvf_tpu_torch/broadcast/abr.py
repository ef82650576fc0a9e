"""Broadcast ABR: per-subscriber tier ladder moves from egress pressure
(port of ``dvf_tpu.broadcast.abr``).

The serve control plane's quality discipline (control.controllers.
QualityController) applied to the broadcast ladder: deterministic
transducers — no wall clock, no randomness — that observe ONE
subscriber's own queue counters and emit at most one ladder step at a
time, with streak hysteresis and a dwell so a borderline watcher does
not flap between tiers. Pressure here is the subscriber's OWN
drop-oldest queue displacing frames (egress backpressure: the client
is not draining fast enough for the tier's payload rate) — never a
shared signal, so one slow watcher only ever moves itself.

Sampling is on channel frame sequence (every ``sample_every`` fanned
frames), which makes replay exact: the same delivery/drop pattern
always produces the same tier trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class BroadcastAbrConfig:
    sample_every: int = 8        # controller cadence, in fanned frames
    drop_frac_high: float = 0.25  # window drop fraction ≥ this = pressure
    down_after: int = 2          # pressured samples per downshift
    up_after: int = 6            # clean samples per upshift
    min_dwell: int = 4           # samples between opposite-direction moves

    def __post_init__(self):
        if self.sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if not (0.0 < self.drop_frac_high <= 1.0):
            raise ValueError("drop_frac_high must be in (0, 1]")


class SubscriberAbr:
    """One subscriber's ladder controller (single-owner: stepped only by
    the channel's fan-out thread, so no locking)."""

    def __init__(self, config: Optional[BroadcastAbrConfig] = None):
        self.config = config or BroadcastAbrConfig()
        self.samples = 0
        self.downshifts = 0
        self.upshifts = 0
        self._pressure_streak = 0
        self._clean_streak = 0
        self._last_move_sample = None   # (sample index, direction)
        self._last_offered = 0
        self._last_dropped = 0
        self._next_seq = None

    def _dwell_ok(self, direction: str) -> bool:
        if self._last_move_sample is None:
            return True
        at, last_dir = self._last_move_sample
        if last_dir == direction:
            return True  # same direction: the streaks already gate
        return (self.samples - at) >= self.config.min_dwell

    def step(self, sub, seq: int) -> Optional[str]:
        """Observe ``sub``'s lifetime queue counters at channel frame
        ``seq``; returns ``"down"`` / ``"up"`` / None. The window is the
        counter delta since the previous sample."""
        cfg = self.config
        if self._next_seq is None:
            self._next_seq = seq + cfg.sample_every
            self._last_offered = sub.offered
            self._last_dropped = sub.queue.dropped
            return None
        if seq < self._next_seq:
            return None
        self._next_seq = seq + cfg.sample_every
        self.samples += 1
        offered = sub.offered
        dropped = sub.queue.dropped
        d_off = offered - self._last_offered
        d_drop = dropped - self._last_dropped
        self._last_offered = offered
        self._last_dropped = dropped
        pressured = d_off > 0 and (d_drop / d_off) >= cfg.drop_frac_high
        if pressured:
            self._pressure_streak += 1
            self._clean_streak = 0
        else:
            self._clean_streak += 1
            self._pressure_streak = 0
        if (pressured and self._pressure_streak >= cfg.down_after
                and self._dwell_ok("down")):
            self._pressure_streak = 0
            self.downshifts += 1
            self._last_move_sample = (self.samples, "down")
            return "down"
        if (not pressured and self._clean_streak >= cfg.up_after
                and self._dwell_ok("up")):
            self._clean_streak = 0
            self.upshifts += 1
            self._last_move_sample = (self.samples, "up")
            return "up"
        return None

    def stats(self) -> dict:
        return {
            "samples": self.samples,
            "downshifts": self.downshifts,
            "upshifts": self.upshifts,
        }
