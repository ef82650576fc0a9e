"""Channels, tiers, and the encode-once fan-out lanes
(port of ``dvf_tpu.broadcast.channel``).

Dataflow (one channel):

  publisher session → tap (one frame copy) → ingest queue (drop-oldest)
    → fan-out worker thread:  for each TIER LANE:
        downscale (tier geometry) → encode ONCE (the lane's closed-loop
        codec) → audit-stamp ONCE → put into EVERY subscriber's own
        drop-oldest queue (a bytes reference — no per-viewer copy)

The invariants this module owns:

- **Encode-once**: a lane's codec runs exactly once per offered frame
  regardless of subscriber count (``TierLane.encodes_total`` is the
  counter the tier-1 assert pins). Fan-out is reference distribution of
  immutable ``bytes`` — per-viewer cost is one queue append.
- **Isolation**: every subscriber owns a bounded drop-oldest queue. A
  slow consumer drops ITS OWN frames; one that stops draining entirely
  is evicted from the lane after ``evict_after`` consecutive displaced
  puts. Neither ever blocks the lane, the channel worker, the
  publisher, or any other subscriber — the other subscribers' payload
  sequences are bit-identical to a run where the slow peer never
  existed (pinned in tier-1).
- **Rate-limited re-key, per TIER**: a late joiner on a delta tier
  needs a keyframe to sync. The request goes through the lane's forced-
  keyframe limiter — the ring transport's eviction re-key discipline
  (transport.ring_queue): the first request re-keys immediately, then
  at most one forced keyframe per ``keyframe_interval // 2`` encodes.
  A 1k-subscriber join burst costs ONE keyframe per tier, not a
  keyframe storm (joiners wait in ``synced=False`` until it lands —
  delta frames before their first keyframe are skipped, not queued).
- **Closed-loop determinism**: the lane encodes every frame the worker
  hands it, in channel-sequence order, so a delta lane's payload stream
  is exactly what an identically-configured ``DeltaCodec`` produces
  over the publisher's own delivered frames — the byte-identical
  subscriber-vs-publisher property tier-1 pins.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from dvf_tpu_torch.obs.lineage import FrameLineage
from dvf_tpu_torch.sched.queues import DropOldestQueue
from dvf_tpu_torch.transport.codec import WIRE_MODES, make_wire_codec


@dataclasses.dataclass(frozen=True)
class Tier:
    """One broadcast rendition: (geometry, quality, wire).

    ``geometry`` is the delivered (h, w) — ``None`` means the
    publisher's native geometry (no resample). ``quality`` feeds the
    tier codec (ignored by the raw wire). ``wire`` is the payload
    format every subscriber on this tier receives
    (:data:`~dvf_tpu_torch.transport.codec.WIRE_MODES`).
    """

    geometry: Optional[Tuple[int, int]] = None
    quality: int = 90
    wire: str = "jpeg"

    def __post_init__(self):
        if self.wire not in WIRE_MODES:
            raise ValueError(
                f"tier wire must be one of {WIRE_MODES}, got {self.wire!r}")
        if self.geometry is not None:
            h, w = self.geometry
            if h <= 0 or w <= 0:
                raise ValueError(f"bad tier geometry {self.geometry}")
            object.__setattr__(self, "geometry", (int(h), int(w)))
        if not (1 <= int(self.quality) <= 100):
            raise ValueError(f"tier quality must be 1..100, "
                             f"got {self.quality!r}")

    def label(self) -> str:
        g = ("native" if self.geometry is None
             else f"{self.geometry[1]}x{self.geometry[0]}")
        return f"{g}/q{self.quality}/{self.wire}"

    @classmethod
    def parse(cls, spec: str) -> "Tier":
        """``"native/q90/jpeg"`` / ``"640x360/q60/delta"`` (WxH, the
        display convention) → Tier. Parts after the geometry may appear
        in any order; missing parts take the defaults."""
        geometry = None
        quality, wire = 90, "jpeg"
        for part in spec.strip().split("/"):
            part = part.strip()
            if not part or part == "native":
                continue
            if part.startswith("q") and part[1:].isdigit():
                quality = int(part[1:])
            elif part in WIRE_MODES:
                wire = part
            elif "x" in part:
                w_s, _, h_s = part.partition("x")
                geometry = (int(h_s), int(w_s))
            else:
                raise ValueError(f"unparseable tier component {part!r} "
                                 f"in {spec!r}")
        return cls(geometry=geometry, quality=quality, wire=wire)

    def cost_key(self) -> Tuple[float, int]:
        """Ladder ordering key: bigger = more expensive rendition.
        Native geometry sorts above every fixed geometry."""
        area = (float("inf") if self.geometry is None
                else float(self.geometry[0] * self.geometry[1]))
        return (area, int(self.quality))


def downscale(frame: np.ndarray, geometry: Tuple[int, int]) -> np.ndarray:
    """Deterministic nearest-neighbor resample to ``(h, w)`` — pure
    index arithmetic, no interpolation state, so the same frame always
    produces the same bytes (the closed-loop tier codec depends on
    that). Upscaling works too (repeated rows), though tiers normally
    go down the ladder."""
    h, w = geometry
    if frame.shape[:2] == (h, w):
        return frame
    ridx = (np.arange(h) * frame.shape[0]) // h
    cidx = (np.arange(w) * frame.shape[1]) // w
    return np.ascontiguousarray(frame[ridx][:, cidx])


class BroadcastDelivery(NamedTuple):
    """One payload popped from a subscription queue."""

    seq: int             # channel-wide frame sequence number
    payload: bytes       # tier wire bytes (audit-stamped when armed)
    capture_ts: float    # publisher delivery timestamp
    keyframe: bool       # self-contained payload (always True off-delta)
    lineage: Any = None  # FrameLineage when the plane armed lineage


class Subscription:
    """One watcher's attachment to a tier lane.

    The queue is the ONLY coupling to the lane: ``poll`` may be called
    from any client thread; the lane's fan-out worker only ever does a
    non-blocking put. ``tier`` mutates when ABR moves the subscription
    between lanes (the handle stays valid across moves).
    """

    def __init__(self, sub_id: str, channel: str, tier: Tier,
                 queue_size: int = 8, abr: Optional[Any] = None):
        self.id = sub_id
        self.channel = channel
        self.tier = tier
        self.queue = DropOldestQueue(maxsize=queue_size)
        self.abr = abr                 # SubscriberAbr when ABR is armed
        self.synced = tier.wire != "delta"  # delta joiners wait for a key
        self.offered = 0               # frames the lane showed this sub
        self.enqueued = 0              # frames that entered the queue
        self.skipped_unsynced = 0      # delta frames before the first key
        self.delivered = 0             # frames the client actually popped
        self.tier_shifts = 0           # ABR moves (both directions)
        self.evicted = False
        self._consecutive_drops = 0    # displaced puts since last poll
        self._lock = threading.Lock()

    # -- lane side (fan-out worker thread) ------------------------------

    def offer(self, d: BroadcastDelivery) -> int:
        """Non-blocking enqueue; returns the consecutive-drop streak
        (0 when the put displaced nothing)."""
        with self._lock:
            self.offered += 1
            if not self.synced:
                if not d.keyframe:
                    self.skipped_unsynced += 1
                    return 0
                self.synced = True
            evicted = self.queue.put(d)
            if evicted is not None:
                self._consecutive_drops += 1
            self.enqueued += 1
            return self._consecutive_drops

    # -- client side ----------------------------------------------------

    def poll(self, max_n: int = 64) -> List[BroadcastDelivery]:
        got = self.queue.pop_up_to(max_n)
        if got:
            now = time.time()
            with self._lock:
                self.delivered += len(got)
                self._consecutive_drops = 0
            for d in got:
                if d.lineage is not None:
                    d.lineage.mark("deliver", now)
        return got

    def stats(self) -> dict:
        with self._lock:
            return {
                "tier": self.tier.label(),
                "offered": self.offered,
                "enqueued": self.enqueued,
                "delivered": self.delivered,
                "dropped": self.queue.dropped,
                "skipped_unsynced": self.skipped_unsynced,
                "queue_depth": len(self.queue),
                "tier_shifts": self.tier_shifts,
                "synced": self.synced,
                "evicted": self.evicted,
            }


class TierLane:
    """One tier's encoder + subscriber set inside a channel.

    Single-writer: ``offer`` runs only on the owning channel's fan-out
    worker thread (or a relay's pump thread), so the codec needs no
    lock. ``subscribe``/``unsubscribe``/``request_keyframe`` may come
    from any thread and only touch lock-guarded subscriber/limiter
    state.
    """

    def __init__(self, tier: Tier, channel: str,
                 keyframe_interval: int = 16, delta_tile: int = 32,
                 codec_threads: int = 2, sub_queue: int = 8,
                 evict_after: int = 32, audit: Any = None,
                 lineage: bool = False):
        self.tier = tier
        self.channel = channel
        self.keyframe_interval = keyframe_interval
        self.delta_tile = delta_tile
        self.codec_threads = codec_threads
        self.sub_queue = sub_queue
        self.evict_after = max(1, evict_after)
        self.audit = audit             # obs.audit.WireAudit or None
        self.lineage = lineage
        self.codec = None              # built lazily at first offer (the
        #   raw wire and native geometry both need the frame shape)
        self.encodes_total = 0         # THE encode-once counter
        self.fanout_total = 0          # payload references distributed
        self.keyframe_requests = 0     # join/drop re-key asks (pre-limit)
        self.keyframes_forced = 0      # asks that got through the limiter
        self._subs: Dict[str, Subscription] = {}
        self._lock = threading.Lock()
        # The ring transport's eviction re-key discipline, scoped per
        # TIER: first request re-keys immediately; under a sustained
        # join/drop storm at most one forced key per interval/2 encodes.
        self._force_cooldown = max(4, keyframe_interval // 2)
        self._encodes_since_forced = self._force_cooldown
        self._rekey_pending = False
        # Lifetime floors: counters of subscribers that were evicted or
        # closed — the lane's totals stay monotone across churn (the registry's counter contract).
        self._gone_subs = 0
        self._gone_delivered = 0
        self._gone_dropped = 0
        self._evictions = 0

    # -- membership (any thread) ----------------------------------------

    def subscribe(self, sub: Subscription) -> None:
        sub.tier = self.tier
        sub.synced = self.tier.wire != "delta"
        with self._lock:
            self._subs[sub.id] = sub
        if self.tier.wire == "delta":
            self.request_keyframe()

    def unsubscribe(self, sub_id: str, evicted: bool = False) -> Optional[
            Subscription]:
        with self._lock:
            sub = self._subs.pop(sub_id, None)
            if sub is None:
                return None
            self._gone_subs += 1
            self._gone_delivered += sub.delivered
            self._gone_dropped += sub.queue.dropped
            if evicted:
                self._evictions += 1
                sub.evicted = True
        return sub

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def request_keyframe(self) -> bool:
        """Ask the closed-loop codec for a keyframe, through the per-tier
        limiter. Returns True when the request will be honored (the next
        encode re-keys); False when the cooldown suppressed it (a recent
        keyframe — or one already pending — covers this joiner)."""
        with self._lock:
            self.keyframe_requests += 1
            if self.tier.wire != "delta":
                return True  # every payload is already self-contained
            if self._rekey_pending:
                return False
            if self._encodes_since_forced < self._force_cooldown:
                return False
            self._rekey_pending = True
            return True

    # -- fan-out (single worker thread) ---------------------------------

    def _build_codec(self, shape: Tuple[int, ...]):
        t = self.tier
        kw = {}
        if t.wire == "delta":
            kw = {"tile": self.delta_tile,
                  "keyframe_interval": self.keyframe_interval}
        self.codec = make_wire_codec(
            t.wire, quality=t.quality, threads=self.codec_threads,
            raw_shape=shape, **kw)

    def offer(self, seq: int, frame: np.ndarray, ts: float,
              marks: Optional[list] = None) -> bytes:
        """Encode ``frame`` once and distribute the payload to every
        subscriber's queue; returns the wire payload (relays feed their
        forward path from it). ``marks`` is the upstream lineage trail
        (e.g. a relay hop) to prepend when lineage is armed."""
        t = self.tier
        if t.geometry is not None:
            frame = downscale(frame, t.geometry)
        if self.codec is None:
            self._build_codec(frame.shape)
        with self._lock:
            rekey = self._rekey_pending
            self._rekey_pending = False
        if rekey:
            self.codec.force_keyframe()
            self.keyframes_forced += 1
            self._encodes_since_forced = 0
        if t.wire == "raw":
            payload, was_key = frame.tobytes(), True
        elif t.wire == "delta":
            k0 = self.codec.keyframes
            payload = self.codec.encode(frame)
            was_key = self.codec.keyframes > k0
        else:
            payload, was_key = self.codec.encode(frame), True
        self.encodes_total += 1
        self._encodes_since_forced += 1
        if self.audit is not None:
            payload = self.audit.stamp(payload)
        lin = None
        if self.lineage:
            lin = FrameLineage(f"{self.channel}@{t.label()}", seq, ts)
            if marks:
                lin.marks.extend(marks)
            lin.mark("encode")
        with self._lock:
            subs = list(self._subs.values())
        evict = None
        for sub in subs:
            slin = lin
            if lin is not None and len(subs) > 1:
                # Lineage objects are mutated at deliver: each sub needs
                # its own copy (cheap: a list of 2-3 tuples).
                slin = FrameLineage(lin.session_id, seq, ts)
                slin.marks = list(lin.marks)
            streak = sub.offer(BroadcastDelivery(
                seq, payload, ts, was_key, slin))
            self.fanout_total += 1
            if streak >= self.evict_after:
                if evict is None:
                    evict = []
                evict.append(sub.id)
        if lin is not None:
            lin.mark("fanout")
        if evict:
            for sid in evict:
                self.unsubscribe(sid, evicted=True)
        return payload

    # -- observability / lifecycle --------------------------------------

    def stats(self) -> dict:
        with self._lock:
            subs = {s.id: s.stats() for s in self._subs.values()}
            live_delivered = sum(s.delivered for s in self._subs.values())
            live_dropped = sum(s.queue.dropped for s in self._subs.values())
            gone = (self._gone_subs, self._gone_delivered,
                    self._gone_dropped, self._evictions)
        depth = sum(s["queue_depth"] for s in subs.values())
        return {
            "tier": self.tier.label(),
            "wire": self.tier.wire,
            "subscribers": subs,
            "subscriber_count": len(subs),
            "queue_depth": depth,
            "encodes_total": self.encodes_total,
            "fanout_frames_total": self.fanout_total,
            "delivered_total": gone[1] + live_delivered,
            "dropped_total": gone[2] + live_dropped,
            "churned_subscribers_total": gone[0],
            "evicted_subscribers_total": gone[3],
            "keyframe_requests_total": self.keyframe_requests,
            "keyframes_forced_total": self.keyframes_forced,
            **({"codec": self.codec.stats()}
               if self.codec is not None and hasattr(self.codec, "stats")
               else {}),
            **({"audit": self.audit.stats()}
               if self.audit is not None else {}),
        }

    def close(self) -> None:
        with self._lock:
            subs = list(self._subs)
        for sid in subs:
            self.unsubscribe(sid)
        if self.codec is not None and hasattr(self.codec, "close"):
            self.codec.close()


class Channel:
    """One published stream's fan-out hub: the ingest queue the
    publisher's tap feeds, the fan-out worker thread, and the tier
    lanes. Construction and teardown belong to the
    :class:`~dvf_tpu_torch.broadcast.plane.BroadcastPlane`."""

    def __init__(self, name: str, publisher: str = "",
                 tiers: Sequence[Tier] = (), ingest_depth: int = 8,
                 keyframe_interval: int = 16, delta_tile: int = 32,
                 codec_threads: int = 2, sub_queue: int = 8,
                 evict_after: int = 32, audit_wire: bool = False,
                 chaos: Any = None, lineage: bool = False):
        self.name = name
        self.publisher = publisher
        self._lane_kw = dict(
            keyframe_interval=keyframe_interval, delta_tile=delta_tile,
            codec_threads=codec_threads, sub_queue=sub_queue,
            evict_after=evict_after, lineage=lineage)
        self.audit_wire = audit_wire
        self.chaos = chaos
        self.lineage = lineage
        self.sub_queue = sub_queue
        self._lanes: Dict[Tier, TierLane] = {}
        self._ingest = DropOldestQueue(maxsize=ingest_depth)
        self._lock = threading.Lock()
        self._seq = 0
        self._sub_seq = 0
        self.offered_total = 0
        self.fanned_out_total = 0
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._worker = threading.Thread(
            target=self._fanout_loop, name=f"dvf-bcast-{name}", daemon=True)
        self._worker.start()
        for t in tiers:
            self.add_tier(t)

    # -- tiers ----------------------------------------------------------

    def _make_audit(self, tier: Tier):
        if not self.audit_wire:
            return None
        from dvf_tpu_torch.obs.audit import WireAudit

        return WireAudit(f"broadcast:{self.name}/{tier.label()}",
                         chaos=self.chaos)

    def add_tier(self, tier: Tier) -> TierLane:
        with self._lock:
            lane = self._lanes.get(tier)
            if lane is None:
                lane = TierLane(tier, self.name, audit=self._make_audit(tier),
                                **self._lane_kw)
                self._lanes[tier] = lane
            return lane

    def ladder(self) -> List[Tier]:
        """Registered tiers, most expensive first — the ABR ladder
        (downshift moves toward the end)."""
        with self._lock:
            return sorted(self._lanes, key=Tier.cost_key, reverse=True)

    # -- publish side ----------------------------------------------------

    def offer(self, index: int, frame: np.ndarray, ts: float) -> None:
        """Publisher tap: ONE frame copy (the publisher's client may
        mutate the delivered array after poll), one bounded enqueue.
        Never blocks — under fan-out pressure the ingest queue drops its
        oldest, which every lane simply never sees (delta lanes are
        unaffected: their closed loop only advances on encoded frames)."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        self.offered_total += 1
        self._ingest.put((seq, np.array(frame, copy=True), ts))
        self._idle.clear()

    # -- subscribe side --------------------------------------------------

    def subscribe(self, tier: Optional[Tier] = None,
                  queue_size: Optional[int] = None,
                  abr: Optional[Any] = None,
                  sub_id: Optional[str] = None) -> Subscription:
        ladder = self.ladder()
        if tier is None:
            if not ladder:
                raise ValueError(f"channel {self.name!r} has no tiers")
            tier = ladder[-1] if abr is not None else ladder[0]
        lane = self.add_tier(tier)
        if sub_id is None:
            with self._lock:
                sub_id = f"{self.name}-sub-{self._sub_seq}"
                self._sub_seq += 1
        sub = Subscription(sub_id, self.name, tier,
                           queue_size=queue_size or self.sub_queue,
                           abr=abr)
        lane.subscribe(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            lane = self._lanes.get(sub.tier)
        if lane is not None:
            lane.unsubscribe(sub.id)

    def move_subscription(self, sub: Subscription, target: Tier) -> bool:
        """ABR actuator: detach from the current lane, join ``target``
        (late-join discipline: delta targets wait for a rate-limited
        keyframe). The handle's queue survives the move — frames already
        queued at the old tier drain normally."""
        with self._lock:
            src = self._lanes.get(sub.tier)
        if src is None or target == sub.tier:
            return False
        if src.unsubscribe(sub.id) is None:
            return False  # concurrently evicted
        lane = self.add_tier(target)
        sub.tier_shifts += 1
        lane.subscribe(sub)
        return True

    # -- fan-out worker ---------------------------------------------------

    def _fanout_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._ingest.get(timeout=0.05)
            except TimeoutError:
                self._idle.set()
                continue
            items = [item] + self._ingest.pop_up_to(len(self._ingest))
            with self._lock:
                lanes = list(self._lanes.values())
            for seq, frame, ts in items:
                for lane in lanes:
                    lane.offer(seq, frame, ts)
                self.fanned_out_total += 1
                self._abr_tick(lanes, seq)
            if len(self._ingest) == 0:
                self._idle.set()

    def _abr_tick(self, lanes: List[TierLane], seq: int) -> None:
        """Drive every ABR-armed subscriber's controller off its own
        queue counters (deterministic: sampled on channel sequence, no
        wall clock). Runs on the fan-out thread, so tier moves never
        race the lanes' single-writer contract."""
        moves = []
        for lane in lanes:
            with lane._lock:
                subs = [s for s in lane._subs.values() if s.abr is not None]
            for sub in subs:
                want = sub.abr.step(sub, seq)
                if want is not None:
                    moves.append((sub, want))
        if not moves:
            return
        ladder = self.ladder()
        for sub, direction in moves:
            try:
                i = ladder.index(sub.tier)
            except ValueError:
                continue
            j = i + 1 if direction == "down" else i - 1
            if 0 <= j < len(ladder):
                self.move_subscription(sub, ladder[j])

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every offered frame has been fanned out (tests and
        graceful teardown); True on quiescence within ``timeout``."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self._ingest) == 0 and self._idle.wait(0.02):
                return True
        return False

    # -- observability / lifecycle ----------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lanes = dict(self._lanes)
        return {
            "publisher": self.publisher,
            "offered_total": self.offered_total,
            "fanned_out_total": self.fanned_out_total,
            "ingest_depth": len(self._ingest),
            "ingest_dropped_total": self._ingest.dropped,
            "tier_count": len(lanes),
            "tiers": {t.label(): lane.stats() for t, lane in lanes.items()},
        }

    def close(self, timeout: float = 5.0) -> None:
        self.flush(timeout=min(1.0, timeout))
        self._stop.set()
        self._worker.join(timeout=timeout)
        with self._lock:
            lanes = list(self._lanes.values())
            self._lanes.clear()
        for lane in lanes:
            lane.close()
