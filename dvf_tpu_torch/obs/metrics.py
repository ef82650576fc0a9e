"""Streaming metrics: fps and latency percentiles (port of the
``LatencyStats`` and ``RateLogger`` parts of ``dvf_tpu.obs.metrics``)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np


class LatencyStats:
    """Streaming fps + latency percentiles.

    Bounded memory for indefinitely-running live streams: once the sample
    list hits ``max_samples`` it is decimated 2:1 and the recording stride
    doubles — percentiles stay representative at uniform coverage.
    """

    def __init__(self, max_samples: int = 200_000):
        self.max_samples = max_samples
        self.samples_ms: List[float] = []
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.count = 0
        self._stride = 1

    def record(self, latency_s: float) -> None:
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        self.t1 = now
        self.count += 1
        if (self.count - 1) % self._stride == 0:
            self.samples_ms.append(latency_s * 1e3)
            if len(self.samples_ms) >= self.max_samples:
                self.samples_ms = self.samples_ms[::2]
                self._stride *= 2

    def fps(self) -> float:
        if self.count < 2 or self.t1 is None or self.t1 == self.t0:
            return 0.0
        return (self.count - 1) / (self.t1 - self.t0)

    def percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        if not self.samples_ms:
            return {f"p{q}_ms": float("nan") for q in qs}
        arr = np.asarray(self.samples_ms)
        return {f"p{q}_ms": float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> Dict[str, float]:
        return {"fps": self.fps(), "count": self.count, **self.percentiles()}


class RateLogger:
    """Periodic rate printer (the reference's every-5 s fps prints)."""

    def __init__(self, name: str, interval_s: float = 5.0, quiet: bool = False):
        self.name = name
        self.interval_s = interval_s
        self.quiet = quiet
        self._count = 0
        self._last = time.perf_counter()

    def tick(self, n: int = 1) -> Optional[float]:
        self._count += n
        now = time.perf_counter()
        dt = now - self._last
        if dt >= self.interval_s:
            rate = self._count / dt
            if not self.quiet:
                print(f"[{self.name}] {rate:.1f} fps")
            self._count = 0
            self._last = now
            return rate
        return None
