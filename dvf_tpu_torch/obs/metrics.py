"""Streaming metrics: fps and latency percentiles, egress accounting (port
of the ``LatencyStats``, ``RateLogger`` and ``EgressStats`` parts of
``dvf_tpu.obs.metrics``)."""

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


class EgressStats:
    """Egress accounting of the ZMQ worker and its codec plane (port of the
    fields of ``dvf_tpu.obs.metrics.EgressStats`` that the plane and the
    worker write).

    ``d2h_wait_ms`` is how long the worker blocked on a batch's
    device→host pixel copy. ``encode_ms`` is the wall span of one batch's
    encode inside the codec pool (submit → last future done) and
    ``encode_wait_ms`` how long the delivery thread actually blocked
    draining it: a wait far below the span is encode running under the
    next batch's decode and compute. ``entropy_ms`` is the host
    entropy-coding time per batch on the coefficient wire, where it is the
    whole host codec cost.
    """

    def __init__(self, depth: int = 2):
        self.depth = depth               # encode-plane in-flight window
        self.batches = 0
        self.d2h_wait_ms_total = 0.0
        self.encode_batches = 0
        self.encode_ms_total = 0.0
        self.encode_wait_ms_total = 0.0
        self.entropy_batches = 0
        self.entropy_ms_total = 0.0
        self.send_batches = 0
        self.send_ms_total = 0.0

    def record_fetch(self, wait_ms: float) -> None:
        self.batches += 1
        self.d2h_wait_ms_total += wait_ms

    def record_encode(self, encode_ms: float, wait_ms: float) -> None:
        self.encode_batches += 1
        self.encode_ms_total += encode_ms
        self.encode_wait_ms_total += wait_ms

    def record_entropy(self, entropy_ms: float) -> None:
        self.entropy_batches += 1
        self.entropy_ms_total += entropy_ms

    def record_send(self, send_ms: float) -> None:
        self.send_batches += 1
        self.send_ms_total += send_ms

    def summary(self) -> Dict[str, object]:
        ne = max(1, self.encode_batches)
        return {
            "depth": self.depth,
            "batches": self.batches,
            "d2h_wait_ms": round(self.d2h_wait_ms_total / max(1, self.batches), 4),
            "encode_batches": self.encode_batches,
            "encode_ms": round(self.encode_ms_total / ne, 4),
            "encode_wait_ms": round(self.encode_wait_ms_total / ne, 4),
            "entropy_ms": round(self.entropy_ms_total
                                / max(1, self.entropy_batches), 4),
            "send_ms": round(self.send_ms_total / max(1, self.send_batches), 4),
        }
