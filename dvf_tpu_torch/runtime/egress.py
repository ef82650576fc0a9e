"""Asynchronous codec plane (port of ``AsyncCodecPlane`` and
``_EncodeEntry`` from ``dvf_tpu/runtime/egress.py``).

The delivery loop submits a batch's rows to the codec's thread pool and
returns to decoding and computing the NEXT batch while the pool encodes;
completed batches drain in submission order. The JAX package's
``ShardedBatchFetcher`` has no counterpart: the port's engine already
copies each batch into a pinned host buffer, and the coefficient wire
fetches no pixels at all.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from dvf_tpu_torch.obs.metrics import EgressStats


class _EncodeEntry:
    __slots__ = ("metas", "futures", "payloads", "t_submit", "t_done",
                 "_remaining", "_lock")

    def __init__(self, metas, futures, payloads, t_submit):
        self.metas = metas
        self.futures = futures      # None on the raw (no-encode) path
        self.payloads = payloads    # raw path: zero-copy memoryviews
        self.t_submit = t_submit
        self.t_done = t_submit
        self._remaining = len(futures) if futures else 0
        self._lock = threading.Lock()

    def mark_done(self) -> None:
        """Done-callback (pool thread): stamps the batch's encode span
        end when its last future completes."""
        with self._lock:
            self._remaining -= 1
            if self._remaining == 0:
                self.t_done = time.perf_counter()

    def done(self) -> bool:
        if self.futures is None:
            return True
        return all(f.done() for f in self.futures)

    def collect(self) -> List[Tuple[Any, Any, Optional[BaseException]]]:
        """(meta, payload, error) per row, in submission order; a failed
        encode surfaces as its row's error instead of poisoning the
        batch."""
        if self.futures is None:
            return [(m, p, None) for m, p in zip(self.metas, self.payloads)]
        out = []
        for meta, fut in zip(self.metas, self.futures):
            try:
                out.append((meta, fut.result(), None))
            except Exception as e:  # noqa: BLE001 — per-row containment
                out.append((meta, None, e))
        return out


class AsyncCodecPlane:
    """Bounded-window, order-preserving async encode over a codec pool.

    ``submit(rows, metas)`` hands one batch's rows to the codec's thread
    pool (``encode_batch_async``) and returns immediately; ``ready()``
    drains *completed head* batches — delivery order is submission order,
    never completion order. ``ready(block=True)`` (or ``flush``) waits
    for the head, which is how callers enforce the in-flight window:

        plane.submit(rows, metas)
        for batch in plane.ready(block=len(plane) > plane.depth):
            for meta, payload, err in batch: …send…

    The raw (``jpeg=False``) path skips the pool entirely and carries
    each row as a zero-copy memoryview over the caller's slab — valid
    until the slab slot is reused, which the window bound guarantees
    happens only after the send (zmq copies at send time).

    Thread contract: ``submit``/``ready``/``flush`` are called from one
    delivery thread; only the future done-callbacks run in pool threads.
    """

    def __init__(self, codec, jpeg: bool = True, depth: int = 2,
                 stats: Optional[EgressStats] = None):
        if depth < 1:
            raise ValueError("encode depth must be >= 1")
        self.codec = codec
        self.jpeg = jpeg
        self.depth = depth
        self.stats = stats
        self._pending: "deque[_EncodeEntry]" = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, rows: Sequence[np.ndarray], metas: Sequence[Any],
               bitmaps: Optional[Sequence[np.ndarray]] = None,
               coeffs: Optional[Sequence[Any]] = None) -> None:
        """``bitmaps`` (delta wire only): per-row device-computed dirty-
        tile reductions (runtime.codec_assist.DeviceDeltaProbe), handed
        through to ``DeltaCodec.encode_batch_async`` so the host skips
        its own change-detection pass. Ignored by full-frame codecs.

        ``coeffs`` (full-transform assist): per-row
        ``transport.codec.CoefficientFrame`` handles from the fused
        device pass — the codec entropy-codes device-quantized blocks
        and never touches pixels, so ``rows`` may be ``[None, ...]``."""
        t0 = time.perf_counter()
        if self.jpeg:
            if coeffs is not None:
                futures = self.codec.encode_batch_async(
                    rows, bitmaps=bitmaps, coeffs=coeffs)
            elif bitmaps is not None:
                futures = self.codec.encode_batch_async(rows,
                                                        bitmaps=bitmaps)
            else:
                futures = self.codec.encode_batch_async(rows)
            entry = _EncodeEntry(list(metas), futures, None, t0)
            for f in futures:
                f.add_done_callback(lambda _f, e=entry: e.mark_done())
        else:
            # Raw wire: zero-copy memoryviews over the staged slab rows
            # (flattened — the wire carries bytes, not shapes).
            payloads = [row.reshape(-1).data for row in rows]
            entry = _EncodeEntry(list(metas), None, payloads, t0)
        self._pending.append(entry)

    def ready(self, block: bool = False) -> List[list]:
        """Completed head batches, each a list of (meta, payload, error)
        rows. ``block=True`` waits for at least the head batch (the
        window-bound path); completed non-head batches always wait their
        turn — ordered delivery is the contract."""
        out = []
        while self._pending:
            entry = self._pending[0]
            if not entry.done():
                if not block:
                    break
                tw = time.perf_counter()
                if entry.futures is not None:
                    for f in entry.futures:
                        try:
                            f.exception()  # waits; result errors surface
                        except Exception:  # noqa: BLE001 — in collect()
                            pass
                wait_ms = (time.perf_counter() - tw) * 1e3
            else:
                wait_ms = 0.0
            self._pending.popleft()
            block = False  # only the head is owed a wait
            # Future.done() flips before done-callbacks run, so the batch
            # can be observed complete with t_done not yet stamped by
            # mark_done — stamp it here rather than record a 0 ms span.
            t_done = entry.t_done
            if entry.futures is not None and t_done <= entry.t_submit:
                entry.t_done = t_done = time.perf_counter()
            if self.stats is not None:
                self.stats.record_encode(
                    encode_ms=(t_done - entry.t_submit) * 1e3,
                    wait_ms=wait_ms)
                # Full-transform assist: drain the host entropy-coding
                # time the codec accumulated for this batch — on that
                # path it is the entire host codec cost (encode_ms wall
                # span still includes pool queueing / drain overlap).
                take = getattr(self.codec, "take_entropy_ms", None)
                if take is not None:
                    ms = take()
                    if ms > 0.0:
                        self.stats.record_entropy(ms)
            out.append(entry.collect())
        return out

    def flush(self) -> List[list]:
        """Drain everything, blocking until the pool finishes."""
        out = []
        while self._pending:
            out.extend(self.ready(block=True))
        return out
