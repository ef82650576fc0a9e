"""Device & host memory accounting for the serving runtime (port of
``dvf_tpu.obs.memory``).

- **device**: :func:`device_live_stats` reads the CUDA caching
  allocator at scrape time (never on a hot path): bytes held by live
  tensors (``torch.cuda.memory_allocated``) and their count
  (``memory_stats()["active.all.current"]``) — the reference walks
  ``jax.live_arrays()`` for the same two numbers. On the CPU both are
  None (a gap, not a zero). Memory the allocator keeps reserved after
  tensors die is deliberately not counted: "released" means no live
  tensor holds it. :func:`pool_device_stats` sums the PER-ENGINE
  resident state bytes of every live pool-managed program
  (``runtime.engine.live_pool_engines``) plus the freed-bytes counter
  ``Engine.free()`` maintains, so eviction accounting is a counter,
  not a guess;
- **host**: the streamed ingest/egress modules register every live
  assembler/fetcher (`runtime.ingest.live_assemblers` /
  `runtime.egress.live_fetchers`); :func:`host_slab_stats` sums their
  occupied slab bytes. Both go to ZERO when every frontend has closed —
  the port's tests assert it after each serving module;
- **gauges**: :func:`attach_memory_provider` registers one scrape-time
  provider emitting the ``dvf_mem_*`` family (device allocator, pool
  residency, host slabs, per-bucket rows when an owner exposes them);
- **trend**: :class:`LeakTrendWatch` — a tiny monotone-growth detector
  an owner feeds from its telemetry ring; a sustained strictly-rising
  byte count past the threshold trips once per episode.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional

from dvf_tpu_torch.obs.registry import GAUGE, COUNTER, MetricSample


def device_live_stats() -> Dict[str, Optional[float]]:
    """Live device tensors of this process, summed over every card it
    sees (a meshed engine spans several), read from the caching
    allocator at scrape time: ``device_live_bytes`` (bytes held by live
    tensors) and ``device_live_buffers`` (their number). None values mean
    there is no CUDA device to read (the CPU) — a gap, not a zero."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {"device_live_bytes": None, "device_live_buffers": None}
        live, buffers = 0, None
        for i in range(torch.cuda.device_count()):
            live += torch.cuda.memory_allocated(i)
            n = torch.cuda.memory_stats(i).get("active.all.current")
            if n is not None:
                buffers = (buffers or 0) + n
    except Exception:  # noqa: BLE001 — accounting must never raise
        return {"device_live_bytes": None, "device_live_buffers": None}
    return {"device_live_bytes": float(live),
            "device_live_buffers": (float(buffers)
                                    if buffers is not None else None)}


def pool_device_stats() -> Dict[str, float]:
    """Pool-managed program residency: per-engine measured state bytes
    (``Engine.state_bytes``, captured at compile) summed over the live
    registry, plus the monotone freed-bytes counter ``Engine.free()``
    advances — the eviction/donation accounting half."""
    from dvf_tpu_torch.runtime.engine import (
        freed_device_bytes_total,
        live_pool_engines,
    )

    live = live_pool_engines()
    return {
        "pool_engines": float(len(live)),
        "pool_state_bytes": float(sum(
            getattr(e, "state_bytes", 0) or 0 for e in live)),
        "engine_freed_bytes_total": float(freed_device_bytes_total()),
    }


def host_slab_stats() -> Dict[str, float]:
    """Occupied host staging memory across every live streamed-ingest
    assembler and streamed-egress fetcher in the process (the
    registries in `runtime.ingest` / `runtime.egress`)."""
    from dvf_tpu_torch.runtime.egress import live_fetchers
    from dvf_tpu_torch.runtime.ingest import live_assemblers

    asm = live_assemblers()
    fet = live_fetchers()
    asm_bytes = sum(a.slab_bytes() for a in asm)
    fet_bytes = sum(f.slab_bytes() for f in fet)
    return {
        "host_slab_bytes": float(asm_bytes + fet_bytes),
        "host_ingest_slab_bytes": float(asm_bytes),
        "host_egress_slab_bytes": float(fet_bytes),
        "host_slab_owners": float(
            sum(1 for a in asm if a.slab_bytes())
            + sum(1 for f in fet if f.slab_bytes())),
    }


def memory_summary() -> Dict[str, Optional[float]]:
    """One flat dict: device allocator + pool residency + host slabs."""
    out: Dict[str, Optional[float]] = {}
    out.update(device_live_stats())
    out.update(pool_device_stats())
    out.update(host_slab_stats())
    return out


def attach_memory_provider(
    registry,
    bucket_rows_fn: Optional[Callable[[], List[dict]]] = None,
) -> None:
    """Register the ``dvf_mem_*`` gauge family on ``registry``.

    All values are computed at scrape time (the allocator read and slab
    sums never run on a serving path). ``bucket_rows_fn`` (optional)
    returns ``[{"bucket": label, "device_state_bytes": n,
    "host_slab_bytes": n}, ...]`` for per-bucket attribution — the
    serving frontend supplies one."""

    def provider() -> List[MetricSample]:
        out: List[MetricSample] = []
        for name, value in memory_summary().items():
            if value is None:
                continue
            kind = COUNTER if name.endswith("_total") else GAUGE
            out.append(MetricSample(f"mem_{name}", float(value), (), kind))
        if bucket_rows_fn is not None:
            for row in bucket_rows_fn():
                labels = (("bucket", str(row.get("bucket"))),)
                for key in ("device_state_bytes", "host_slab_bytes"):
                    v = row.get(key)
                    if v is not None:
                        out.append(MetricSample(
                            f"mem_bucket_{key}", float(v), labels, GAUGE))
        return out

    registry.register_provider(provider)


class LeakTrendWatch:
    """Monotone-growth detector over a periodically-sampled byte count.

    Feed it one ``observe(value)`` per telemetry sample. It trips when
    the last ``window`` samples are strictly increasing AND the total
    growth across them exceeds ``min_growth_bytes`` — a steady upward
    staircase, not noise around a plateau. One trip per episode: the
    watch re-arms only after a non-increasing sample.
    """

    def __init__(self, window: int = 8,
                 min_growth_bytes: float = 8 * 1024 * 1024):
        if window < 3:
            raise ValueError("leak-trend window must be >= 3")
        self.window = window
        self.min_growth_bytes = float(min_growth_bytes)
        self._values: "collections.deque[float]" = collections.deque(
            maxlen=window)
        self._tripped_episode = False
        self.trips_total = 0

    def observe(self, value: Optional[float]) -> Optional[str]:
        """Returns a trip reason string when this sample completes a
        leak trend, else None."""
        if value is None:
            return None
        v = float(value)
        if self._values and v <= self._values[-1]:
            # Plateau or shrink: the episode (if any) is over.
            self._tripped_episode = False
        self._values.append(v)
        if (len(self._values) < self.window or self._tripped_episode):
            return None
        vals = list(self._values)
        if any(b <= a for a, b in zip(vals, vals[1:])):
            return None
        growth = vals[-1] - vals[0]
        if growth < self.min_growth_bytes:
            return None
        self._tripped_episode = True
        self.trips_total += 1
        return (f"memory leak trend: {growth / 1e6:.1f} MB growth over "
                f"{self.window} consecutive rising samples "
                f"(now {vals[-1] / 1e6:.1f} MB)")
