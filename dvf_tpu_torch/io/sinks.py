"""Frame sinks (port of ``dvf_tpu.io.sinks``): a null consumer that
records end-to-end latency, and a per-frame callback adapter."""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from dvf_tpu_torch.obs.metrics import LatencyStats


class NullSink:
    """Swallow frames; record per-frame end-to-end latency."""

    def __init__(self):
        self.stats = LatencyStats()

    @property
    def count(self) -> int:
        return self.stats.count

    def emit(self, index: int, frame: np.ndarray, capture_ts: float) -> None:
        self.stats.record(time.time() - capture_ts)

    def close(self) -> None:
        pass

    def fps(self) -> float:
        return self.stats.fps()

    def latency_percentiles(self, qs=(50, 90, 99)) -> dict:
        pct = self.stats.percentiles(qs)
        return {k.removesuffix("_ms"): v for k, v in pct.items()}


class CallbackSink:
    """Adapter: call a user function per delivered frame."""

    def __init__(self, fn: Callable[[int, np.ndarray, float], None]):
        self.fn = fn
        self.count = 0

    def emit(self, index: int, frame: np.ndarray, capture_ts: float) -> None:
        self.count += 1
        self.fn(index, frame, capture_ts)

    def close(self) -> None:
        pass
