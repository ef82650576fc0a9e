"""Relay nodes: egress replicas that fan out without filter compute
(port of ``dvf_tpu.broadcast.relay``).

A relay subscribes UPSTREAM (to a channel on another plane — the
device-owning serving box) and re-fans what it receives to its OWN
subscriber set. Two paths per relay:

- **Forward (same tier)** — the relay-only hot path: the upstream
  payload ``bytes`` are distributed verbatim to this relay's
  subscribers. No decode, no re-encode, ``encodes_total`` stays 0 —
  and the audit envelope (stamped once, at the upstream tier
  encoder) survives the hop untouched, so the FINAL subscriber's
  verify still proves end-to-end integrity across the relay. A
  ``chaos`` plan arms the ``corrupt_wire`` bit-flip ON the hop
  (after upstream stamping, before fan-out) — the injected corruption
  the downstream envelope check must catch.
- **Derived tiers** (optional) — the relay decodes the source tier
  once and feeds ordinary :class:`~dvf_tpu_torch.broadcast.channel.TierLane`
  encoders, so a relay can also serve cheaper renditions without
  touching the upstream box (encode cost lands on the relay, still
  once per tier).

A watcher's latency through a relay still decomposes additively: the
relay appends a ``relay`` lineage mark to every forwarded delivery
(when the upstream plane armed lineage), so
``FrameLineage.components_ms()`` splits encode / fanout / relay /
deliver and sums to the end-to-end total (the lineage invariant).

Relays register in a module-level registry (``live_relay_nodes``) the
conftest session-end guard sweeps — a relay outliving its plane is a
leaked pump thread plus a pinned upstream subscription.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence

from dvf_tpu_torch.broadcast.channel import (
    BroadcastDelivery,
    Subscription,
    Tier,
    TierLane,
)
from dvf_tpu_torch.obs.audit import is_stamped, verify_wire
from dvf_tpu_torch.transport.codec import make_wire_codec

_LIVE_RELAYS: "weakref.WeakSet" = weakref.WeakSet()


def live_relay_nodes() -> list:
    """Relay nodes whose pump thread is still alive (conftest guard)."""
    return [r for r in _LIVE_RELAYS if r.alive()]


class _ForwardLane:
    """The relay-only lane: per-subscriber queues, zero codec state.
    Single-writer (the relay pump thread), same locking discipline as
    :class:`TierLane` but with nothing to encode."""

    def __init__(self, tier: Tier, sub_queue: int, evict_after: int):
        self.tier = tier
        self.sub_queue = sub_queue
        self.evict_after = max(1, evict_after)
        self.forwarded_total = 0
        self._subs: Dict[str, Subscription] = {}
        self._lock = threading.Lock()
        self._gone_subs = 0
        self._gone_delivered = 0
        self._gone_dropped = 0
        self._evictions = 0

    def subscribe(self, sub: Subscription) -> None:
        # Forwarded payloads are whatever the upstream lane emitted —
        # including delta frames this joiner cannot composite without a
        # keyframe. The relay cannot force one (it owns no encoder);
        # joiners wait unsynced for the upstream cadence keyframe, the
        # same bounded staleness as a suppressed re-key upstream.
        sub.tier = self.tier
        sub.synced = self.tier.wire != "delta"
        with self._lock:
            self._subs[sub.id] = sub

    def unsubscribe(self, sub_id: str, evicted: bool = False):
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

    def forward(self, d: BroadcastDelivery) -> None:
        with self._lock:
            subs = list(self._subs.values())
        evict = None
        for sub in subs:
            streak = sub.offer(d)
            self.forwarded_total += 1
            if streak >= self.evict_after:
                if evict is None:
                    evict = []
                evict.append(sub.id)
        if evict:
            for sid in evict:
                self.unsubscribe(sid, evicted=True)

    def stats(self) -> dict:
        with self._lock:
            subs = {s.id: s.stats() for s in self._subs.values()}
            live_delivered = sum(s.delivered for s in self._subs.values())
            live_dropped = sum(s.queue.dropped for s in self._subs.values())
            gone = (self._gone_subs, self._gone_delivered,
                    self._gone_dropped, self._evictions)
        return {
            "tier": self.tier.label(),
            "subscribers": subs,
            "subscriber_count": len(subs),
            "forwarded_total": self.forwarded_total,
            "encodes_total": 0,  # the relay-only claim, as a datum
            "delivered_total": gone[1] + live_delivered,
            "dropped_total": gone[2] + live_dropped,
            "churned_subscribers_total": gone[0],
            "evicted_subscribers_total": gone[3],
        }

    def close(self) -> None:
        with self._lock:
            subs = list(self._subs)
        for sid in subs:
            self.unsubscribe(sid)


class RelayNode:
    """One egress replica: upstream subscription in, tiers out."""

    def __init__(self, relay_id: str, upstream, channel: str,
                 source_tier: Tier, tiers: Sequence[Tier] = (),
                 sub_queue: int = 8, evict_after: int = 32,
                 upstream_queue: int = 32, chaos: Any = None,
                 codec_threads: int = 2, keyframe_interval: int = 16,
                 delta_tile: int = 32):
        self.id = relay_id
        self.channel = channel
        self.source_tier = source_tier
        self.chaos = chaos
        self.relayed_total = 0        # upstream deliveries pumped
        self.corrupted_on_hop = 0     # chaos flips actually applied
        self._upstream_sub = upstream.subscribe(
            channel, tier=source_tier, queue_size=upstream_queue,
            sub_id=f"relay-{relay_id}")
        self.forward_lane = _ForwardLane(source_tier, sub_queue, evict_after)
        self._derived: Dict[Tier, TierLane] = {}
        self._decoder = None
        for t in tiers:
            if t != source_tier:
                self._derived[t] = TierLane(
                    t, f"{channel}~{relay_id}", sub_queue=sub_queue,
                    evict_after=evict_after, codec_threads=codec_threads,
                    keyframe_interval=keyframe_interval,
                    delta_tile=delta_tile)
        if self._derived:
            st = source_tier
            if st.wire == "raw":
                # A raw payload carries no geometry; the relay would be
                # guessing shapes. Derive from a self-describing wire.
                raise ValueError(
                    "derived relay tiers need a jpeg/delta source tier "
                    "(raw payloads are shapeless on the wire)")
            kw = ({"tile": delta_tile, "keyframe_interval": keyframe_interval,
                   "on_gap": "composite"} if st.wire == "delta" else {})
            self._decoder = make_wire_codec(
                st.wire, quality=st.quality, threads=codec_threads, **kw)
        self._sub_seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._pump = threading.Thread(
            target=self._pump_loop, name=f"dvf-bcast-relay-{relay_id}",
            daemon=True)
        self._pump.start()
        _LIVE_RELAYS.add(self)

    def alive(self) -> bool:
        return self._pump.is_alive()

    # -- subscriber side -------------------------------------------------

    def subscribe(self, tier: Optional[Tier] = None,
                  queue_size: Optional[int] = None) -> Subscription:
        tier = tier or self.source_tier
        with self._lock:
            sub_id = f"{self.id}-sub-{self._sub_seq}"
            self._sub_seq += 1
        sub = Subscription(sub_id, self.channel, tier,
                           queue_size=queue_size or self.forward_lane.sub_queue)
        if tier == self.source_tier:
            self.forward_lane.subscribe(sub)
        else:
            lane = self._derived.get(tier)
            if lane is None:
                raise ValueError(
                    f"relay {self.id} does not serve tier {tier.label()} "
                    f"(source {self.source_tier.label()}, derived "
                    f"{[t.label() for t in self._derived]})")
            lane.subscribe(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        if sub.tier == self.source_tier:
            self.forward_lane.unsubscribe(sub.id)
        else:
            lane = self._derived.get(sub.tier)
            if lane is not None:
                lane.unsubscribe(sub.id)

    # -- pump -------------------------------------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            got = self._upstream_sub.poll(64)
            if not got:
                self._stop.wait(0.005)
                continue
            for d in got:
                self.relayed_total += 1
                payload = d.payload
                if self.chaos is not None:
                    flipped = self.chaos.flip_bit("corrupt_wire", payload)
                    if flipped is not payload:
                        self.corrupted_on_hop += 1
                    payload = flipped
                marks = None
                lin = d.lineage
                if lin is not None:
                    lin.mark("relay")
                    marks = list(lin.marks)
                self.forward_lane.forward(BroadcastDelivery(
                    d.seq, payload, d.capture_ts, d.keyframe, lin))
                if self._derived:
                    self._feed_derived(d, payload, marks)

    def _feed_derived(self, d: BroadcastDelivery, payload: bytes,
                      marks) -> None:
        """Decode the source payload once, feed every derived lane. A
        payload that fails envelope verification or decode is dropped
        here (the forward path already carried the corrupt bytes to
        ITS subscribers' verifiers — derived tiers must not re-encode
        garbage into fresh, validly-stamped frames)."""
        try:
            inner = payload
            if is_stamped(inner):
                inner = verify_wire(inner, hop=f"relay:{self.id}")
            frame = self._decoder.decode(inner)
        except Exception:  # noqa: BLE001 — corrupt hop payload: contained
            return
        for lane in self._derived.values():
            lane.offer(d.seq, frame, d.capture_ts, marks=marks)

    # -- observability / lifecycle ----------------------------------------

    def stats(self) -> dict:
        return {
            "channel": self.channel,
            "source_tier": self.source_tier.label(),
            "relayed_total": self.relayed_total,
            "corrupted_on_hop_total": self.corrupted_on_hop,
            "upstream_dropped_total": self._upstream_sub.queue.dropped,
            "forward": self.forward_lane.stats(),
            **({"tiers": {t.label(): lane.stats()
                          for t, lane in self._derived.items()}}
               if self._derived else {}),
        }

    def close(self, upstream=None, timeout: float = 5.0) -> None:
        self._stop.set()
        self._pump.join(timeout=timeout)
        if upstream is not None:
            upstream.unsubscribe(self._upstream_sub)
        self.forward_lane.close()
        for lane in self._derived.values():
            lane.close()
        if self._decoder is not None and hasattr(self._decoder, "close"):
            self._decoder.close()
        _LIVE_RELAYS.discard(self)
