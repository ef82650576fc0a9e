"""Streaming metrics: fps and latency percentiles (mergeable across
recorders), ingest and egress accounting (port of the ``LatencyStats``,
``RateLogger``, ``IngestStats`` and ``EgressStats`` parts of
``dvf_tpu.obs.metrics``)."""

from __future__ import annotations

import os
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

    def snapshot(self) -> Dict[str, object]:
        """One recorder's mergeable export: samples + decimation stride +
        time span, as plain JSON/pickle-safe values. This is what crosses
        a process boundary when a fleet replica ships its latency data to
        the front door (``LatencyStats.merge_snapshots`` on the other
        side) — the object form can't ride an RPC.

        The sample list is read ONCE (list() is atomic under the GIL):
        collect threads append — and decimate, swapping the list and
        doubling ``_stride`` — concurrently with this read. Pairing one
        list snapshot with one stride read keeps samples/weights the same
        length; a stride doubled between the two reads only skews
        weighting transiently, never crashes. ``pid`` tags the time base:
        ``t0``/``t1`` are ``perf_counter`` values, comparable only within
        one process.
        """
        return {
            "samples_ms": list(self.samples_ms),
            "stride": float(self._stride),
            "t0": self.t0,
            "t1": self.t1,
            "count": self.count,
            "pid": os.getpid(),
        }

    @classmethod
    def combined(cls, stats: "list[LatencyStats]") -> Dict[str, object]:
        """Many recorders → ONE snapshot (per-sample ``weights`` carry
        each recorder's stride) — the per-replica half of the fleet
        export: a frontend merges its sessions here, the fleet tier
        merges replicas' combined snapshots with ``merge_snapshots``."""
        stats = [s for s in stats if s.count]
        samples: List[float] = []
        weights: List[float] = []
        for s in stats:
            part = list(s.samples_ms)
            samples.extend(part)
            weights.extend([float(s._stride)] * len(part))
        live = [s for s in stats if s.t0 is not None]
        return {
            "samples_ms": samples,
            "weights": weights,
            "t0": min((s.t0 for s in live), default=None),
            "t1": max((s.t1 for s in live), default=None),
            "count": sum(s.count for s in stats),
            "pid": os.getpid(),
        }

    @classmethod
    def merge_snapshots(cls, snaps: "list[dict]",
                        qs=(50, 90, 99)) -> Dict[str, float]:
        """Weighted summary over :meth:`snapshot`/:meth:`combined`
        exports — the percentile/fps arithmetic behind :meth:`merged`,
        split out so it also works on data that crossed a process
        boundary (fleet replicas).

        Percentiles weight each sample by its recorder's decimation
        stride, so a long-running stream decimated 2:1 still counts each
        surviving sample for the ~stride deliveries it represents. fps
        is total deliveries over the union time span when every snapshot
        shares one time base (same ``pid`` — perf_counter origins are
        per-process); across processes it falls back to total deliveries
        over the LONGEST single span, which is the right wall-clock
        denominator for replicas that ran concurrently.
        """
        snaps = [s for s in snaps if s and s.get("count")]
        if not snaps:
            return {"fps": 0.0, "count": 0,
                    **{f"p{q}_ms": float("nan") for q in qs}}
        count = sum(int(s["count"]) for s in snaps)
        parts = []
        for s in snaps:
            arr = np.asarray(s["samples_ms"], dtype=float)
            if not len(arr):
                continue
            w = (np.asarray(s["weights"], dtype=float)
                 if s.get("weights") is not None
                 else np.full(len(arr), float(s.get("stride", 1.0))))
            parts.append((arr, w))
        if not parts:  # count incremented before the first append landed
            return {"fps": 0.0, "count": count,
                    **{f"p{q}_ms": float("nan") for q in qs}}
        samples = np.concatenate([a for a, _ in parts])
        weights = np.concatenate([w for _, w in parts])
        order = np.argsort(samples)
        cum = np.cumsum(weights[order])
        out: Dict[str, float] = {}
        for q in qs:
            k = int(np.searchsorted(cum, q / 100.0 * cum[-1]))
            out[f"p{q}_ms"] = float(samples[order][min(k, len(samples) - 1)])
        spans = [s for s in snaps
                 if s.get("t0") is not None and s.get("t1") is not None]
        fps = 0.0
        if spans and count > 1:
            if len({s.get("pid") for s in spans}) <= 1:
                dt = (max(s["t1"] for s in spans)
                      - min(s["t0"] for s in spans))
            else:
                dt = max(s["t1"] - s["t0"] for s in spans)
            if dt > 0:
                fps = (count - 1) / dt
        out["fps"] = fps
        out["count"] = count
        return out

    @classmethod
    def merged(cls, stats: "list[LatencyStats]",
               qs=(50, 90, 99)) -> Dict[str, float]:
        """Fleet-level summary across several recorders (the serving
        frontend's per-session stats → one aggregate p50/p99 export).
        Same-process sugar over :meth:`merge_snapshots`."""
        return cls.merge_snapshots(
            [s.snapshot() for s in stats if s.count], qs=qs)


class RateLogger:
    """Periodic rate printer (the reference's every-5 s fps prints).

    With a ``registry`` (obs.registry.MetricsRegistry) every computed
    rate also lands as the ``rate_fps`` gauge labeled ``{stage: name}``;
    ``quiet`` silences the print only."""

    def __init__(self, name: str, interval_s: float = 5.0,
                 quiet: bool = False, registry=None):
        self.name = name
        self.interval_s = interval_s
        self.quiet = quiet
        self.last_rate: Optional[float] = None
        self._gauge = (registry.gauge("rate_fps")
                       if registry is not None else None)
        self._count = 0
        self._last = time.perf_counter()

    def tick(self, n: int = 1) -> Optional[float]:
        self._count += n
        now = time.perf_counter()
        dt = now - self._last
        if dt >= self.interval_s:
            rate = self._count / dt
            self.last_rate = rate
            if self._gauge is not None:
                self._gauge.set(rate, labels={"stage": self.name})
            if not self.quiet:
                print(f"[{self.name}] {rate:.1f} fps")
            self._count = 0
            self._last = now
            return rate
        return None


class IngestStats:
    """Streamed-ingest accounting: how much H2D cost the pipeline actually
    *exposed* vs how much it hid under decode/compute.

    ``overlap_efficiency`` — the headline number (bench JSON, pipeline
    stats) — is the fraction of the batch's transfer cost hidden from the
    dispatch thread::

        efficiency = (h2d_block_ms − exposed_ms) / h2d_block_ms

    where ``h2d_block_ms`` is the calibrated cost of one BLOCKING
    whole-batch pinned host→device copy at this signature (measured once
    by ``Engine.compile`` on a second put after its warm-up put — the
    monolithic path's serialized transfer), and ``exposed_ms`` is the
    per-batch average host time the streamed path actually spent issuing
    copies (``put_ms``) plus blocked on the depth window (``wait_ms``).
    1.0 means every transfer microsecond ran under concurrent staging or
    compute; 0.0 means streaming hid nothing (e.g. the CPU, where the
    "copy" is synchronous). Reported as None when no calibration exists
    or the monolithic path ran (nothing is overlapped there by
    construction).
    """

    def __init__(self, requested_mode: str = "streamed", depth: int = 4,
                 h2d_block_ms: Optional[float] = None):
        self.requested_mode = requested_mode
        self.effective_mode = requested_mode
        self.fallback_reason: Optional[str] = None  # why streamed degraded
        #   ("cheap_transfer", "h2d_fault_budget"; the reference's
        #   sharding reasons cannot arise on one device)
        self.depth = depth
        self.h2d_block_ms = h2d_block_ms
        self.batches = 0
        self.pool_allocs = 0       # staging-pool constructions (the
        #   allocation-regression tests assert this stays at 1 across a
        #   steady-state run: slabs are reused, never reallocated)
        self.stage_ms_total = 0.0
        self.put_ms_total = 0.0
        self.wait_ms_total = 0.0
        self.span_ms_total = 0.0

    def record_batch(self, stage_ms: float, put_ms: float, wait_ms: float,
                     span_ms: float) -> None:
        self.batches += 1
        self.stage_ms_total += stage_ms
        self.put_ms_total += put_ms
        self.wait_ms_total += wait_ms
        self.span_ms_total += span_ms

    def overlap_efficiency(self) -> Optional[float]:
        if (self.effective_mode != "streamed" or self.batches == 0
                or not self.h2d_block_ms):
            return None
        exposed = (self.put_ms_total + self.wait_ms_total) / self.batches
        return max(0.0, min(1.0, (self.h2d_block_ms - exposed)
                            / self.h2d_block_ms))

    def summary(self) -> Dict[str, object]:
        n = max(1, self.batches)
        eff = self.overlap_efficiency()
        return {
            "mode": self.effective_mode,
            "requested_mode": self.requested_mode,
            "fallback_reason": self.fallback_reason,
            "depth": self.depth,
            "batches": self.batches,
            "stage_ms": round(self.stage_ms_total / n, 4),
            "h2d_put_ms": round(self.put_ms_total / n, 4),
            "h2d_wait_ms": round(self.wait_ms_total / n, 4),
            "span_ms": round(self.span_ms_total / n, 4),
            "h2d_block_ms": (round(self.h2d_block_ms, 4)
                             if self.h2d_block_ms else None),
            "overlap_efficiency": (round(eff, 4)
                                   if eff is not None else None),
            "pool_allocs": self.pool_allocs,
        }


class EgressStats:
    """Streamed-egress accounting — the delivery-side mirror of
    :class:`IngestStats`: how much D2H cost the collect path actually
    *exposed* vs how much the device→host copy started at submit (on the
    engine's copy stream) hid under the tail of compute, and how much
    encode time the asynchronous codec plane ran under the next batch's
    compute.

    ``overlap_efficiency`` mirrors the ingest formula::

        efficiency = (d2h_block_ms − exposed_ms) / d2h_block_ms

    where ``d2h_block_ms`` is the calibrated cost of one BLOCKING
    whole-batch device→host copy at this signature (measured once by
    ``Engine.compile`` into a pre-touched pinned host buffer — the
    serialized fetch) and ``exposed_ms`` is the per-batch average the
    streamed fetch actually spent blocked on the host copy
    (``d2h_wait_ms``) plus copying into the output slab (``copy_ms``; 0
    on a card, where the copy lands in the slab itself). None when no
    calibration exists or the monolithic path ran. On the monolithic path
    ``d2h_wait_ms`` is the blocking copy itself. ``span_ms`` is the whole
    fetch, the wait for the batch's compute included.

    The codec-plane half: ``encode_ms`` is the wall span of one batch's
    encode inside the pool (submit → last future done), ``encode_wait_ms``
    is how long the delivery thread actually *blocked* draining it — a
    wait far below the span is encode running under concurrent
    decode/compute, the "encode_ms no longer additive" evidence.
    """

    def __init__(self, requested_mode: str = "streamed", depth: int = 2,
                 d2h_block_ms: Optional[float] = None):
        self.requested_mode = requested_mode
        self.effective_mode = requested_mode
        self.fallback_reason: Optional[str] = None  # why streamed degraded
        #   ("zero_copy_backend", "cheap_transfer", "d2h_fault_budget")
        self.depth = depth               # encode-plane in-flight window
        self.d2h_block_ms = d2h_block_ms
        self.batches = 0
        self.pool_allocs = 0             # slab-pool constructions (stays 1
        #   across a steady-state run — the allocation-regression tests)
        self.d2h_wait_ms_total = 0.0     # blocked on shard host copies
        self.copy_ms_total = 0.0         # scatter into the output slab
        self.span_ms_total = 0.0
        self.encode_batches = 0
        self.encode_ms_total = 0.0       # in-pool wall span per batch
        self.encode_wait_ms_total = 0.0  # exposed drain wait per batch
        self.entropy_batches = 0
        self.entropy_ms_total = 0.0      # host entropy-coding CPU time
        #   per batch (full-transform assist: the ONLY host codec work —
        #   compare against encode_ms on the host-transform path)
        self.send_batches = 0
        self.send_ms_total = 0.0

    def record_fetch(self, wait_ms: float, copy_ms: float,
                     span_ms: float) -> None:
        self.batches += 1
        self.d2h_wait_ms_total += wait_ms
        self.copy_ms_total += copy_ms
        self.span_ms_total += span_ms

    def record_encode(self, encode_ms: float, wait_ms: float) -> None:
        self.encode_batches += 1
        self.encode_ms_total += encode_ms
        self.encode_wait_ms_total += wait_ms

    def record_entropy(self, entropy_ms: float) -> None:
        """Host entropy-coding time for one batch (full-transform assist:
        the device already did DCT+quant, so this is the whole host-side
        codec cost — the number that replaces ``encode_ms`` as the host
        roofline)."""
        self.entropy_batches += 1
        self.entropy_ms_total += entropy_ms

    def record_send(self, send_ms: float) -> None:
        self.send_batches += 1
        self.send_ms_total += send_ms

    def overlap_efficiency(self) -> Optional[float]:
        if (self.effective_mode != "streamed" or self.batches == 0
                or not self.d2h_block_ms):
            return None
        exposed = (self.d2h_wait_ms_total + self.copy_ms_total) / self.batches
        return max(0.0, min(1.0, (self.d2h_block_ms - exposed)
                            / self.d2h_block_ms))

    def summary(self) -> Dict[str, object]:
        n = max(1, self.batches)
        ne = max(1, self.encode_batches)
        eff = self.overlap_efficiency()
        return {
            "mode": self.effective_mode,
            "requested_mode": self.requested_mode,
            "fallback_reason": self.fallback_reason,
            "depth": self.depth,
            "batches": self.batches,
            "d2h_wait_ms": round(self.d2h_wait_ms_total / n, 4),
            "copy_ms": round(self.copy_ms_total / n, 4),
            "span_ms": round(self.span_ms_total / n, 4),
            "d2h_block_ms": (round(self.d2h_block_ms, 4)
                             if self.d2h_block_ms else None),
            "overlap_efficiency": (round(eff, 4)
                                   if eff is not None else None),
            "encode_batches": self.encode_batches,
            "encode_ms": round(self.encode_ms_total / ne, 4),
            "encode_wait_ms": round(self.encode_wait_ms_total / ne, 4),
            "entropy_ms": round(self.entropy_ms_total
                                / max(1, self.entropy_batches), 4),
            "send_ms": round(self.send_ms_total
                             / max(1, self.send_batches), 4),
            "pool_allocs": self.pool_allocs,
        }
