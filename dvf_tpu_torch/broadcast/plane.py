"""BroadcastPlane — the channel registry + the fan-out front doors
(port of ``dvf_tpu.broadcast.plane``).

One plane per serving frontend (serve or fleet): it owns every
published channel, the relay nodes spawned off this box, and the
optional ZMQ gate remote watchers attach through. Everything exports
through the registry's discipline:

- ``signals()`` — flat ``broadcast_*`` series with MONOTONE lifetime
  floors: a closed channel / evicted subscriber / retired relay folds
  its totals into ``_closed_totals`` first, so ``broadcast_*_total``
  never decreases across churn (the scrape-side rate() contract);
- ``stats()`` — the nested per-channel/tier/subscriber rows (dynamic
  keys, registered in ``obs.registry.DYNAMIC_KEY_PARENTS``).
"""

from __future__ import annotations

import json
import threading
import weakref
from typing import Any, Dict, Optional, Sequence, Union

from dvf_tpu_torch.broadcast.abr import BroadcastAbrConfig, SubscriberAbr
from dvf_tpu_torch.broadcast.channel import Channel, Subscription, Tier
from dvf_tpu_torch.broadcast.relay import RelayNode
from dvf_tpu_torch.resilience.continuity import ContinuityStats, LivenessMonitor

_LIVE_GATES: "weakref.WeakSet" = weakref.WeakSet()


def live_broadcast_sockets() -> list:
    """ZMQ gate endpoints still open (conftest session-end guard): a
    gate outliving its plane pins a bound socket + server thread."""
    return [g for g in _LIVE_GATES if not g.closed]


_FLOOR_KEYS = (
    "encodes", "fanout_frames", "delivered", "dropped", "ingest_dropped",
    "churned_subscribers", "evicted_subscribers", "keyframes_forced",
    "relayed", "relay_forwarded", "relay_corrupted_on_hop",
)


class BroadcastPlane:
    """Channel/relay registry for one serving frontend."""

    def __init__(self, audit_wire: bool = False, chaos: Any = None,
                 ingest_depth: int = 8, sub_queue: int = 8,
                 evict_after: int = 32, keyframe_interval: int = 16,
                 delta_tile: int = 32, codec_threads: int = 2,
                 lineage: bool = False,
                 abr_config: Optional[BroadcastAbrConfig] = None):
        self.audit_wire = audit_wire
        self.chaos = chaos
        self.lineage = lineage
        self.abr_config = abr_config or BroadcastAbrConfig()
        self._channel_kw = dict(
            ingest_depth=ingest_depth, keyframe_interval=keyframe_interval,
            delta_tile=delta_tile, codec_threads=codec_threads,
            sub_queue=sub_queue, evict_after=evict_after,
            audit_wire=audit_wire, chaos=chaos, lineage=lineage)
        self._channels: Dict[str, Channel] = {}
        self._relays: Dict[str, RelayNode] = {}
        self._relay_seq = 0
        self._lock = threading.Lock()
        self._closed_totals = {k: 0 for k in _FLOOR_KEYS}
        self._stopped = False

    # -- publish ---------------------------------------------------------

    def publish(self, name: str, publisher: str = "",
                tiers: Sequence[Union[Tier, str]] = ()) -> Channel:
        tiers = [Tier.parse(t) if isinstance(t, str) else t for t in tiers]
        with self._lock:
            if self._stopped:
                raise RuntimeError("broadcast plane is stopped")
            if name in self._channels:
                raise ValueError(f"channel {name!r} is already published "
                                 f"(one publisher per channel)")
            ch = Channel(name, publisher=publisher, tiers=tiers,
                         **self._channel_kw)
            self._channels[name] = ch
            return ch

    def channel(self, name: str) -> Channel:
        with self._lock:
            ch = self._channels.get(name)
        if ch is None:
            raise KeyError(f"no published channel {name!r} "
                           f"(live: {sorted(self._channels)})")
        return ch

    def tap(self, name: str):
        """The publisher-session hook: a callable the session's delivery
        loop invokes per delivered frame (serve.session.StreamSession
        ``tap``)."""
        return self.channel(name).offer

    def unpublish(self, name: str, timeout: float = 5.0) -> None:
        with self._lock:
            ch = self._channels.pop(name, None)
        if ch is None:
            return
        ch.flush(timeout=min(1.0, timeout))
        self._absorb_channel(ch)
        ch.close(timeout=timeout)

    # -- subscribe -------------------------------------------------------

    def subscribe(self, channel: str, tier: Union[Tier, str, None] = None,
                  queue_size: Optional[int] = None, abr: bool = False,
                  sub_id: Optional[str] = None) -> Subscription:
        if isinstance(tier, str):
            tier = Tier.parse(tier)
        controller = SubscriberAbr(self.abr_config) if abr else None
        return self.channel(channel).subscribe(
            tier=tier, queue_size=queue_size, abr=controller, sub_id=sub_id)

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            ch = self._channels.get(sub.channel)
        if ch is not None:
            ch.unsubscribe(sub)

    # -- relays ----------------------------------------------------------

    def spawn_relay(self, channel: str,
                    source_tier: Union[Tier, str, None] = None,
                    tiers: Sequence[Union[Tier, str]] = (),
                    chaos: Any = None, relay_id: Optional[str] = None,
                    upstream: Optional["BroadcastPlane"] = None,
                    **relay_kw) -> RelayNode:
        """Grow an egress replica off ``channel``. ``upstream`` defaults
        to THIS plane (the device box fans out to its own relays); a
        relay-only host passes the remote/front plane it subscribes
        through. ``chaos`` arms the corrupt-the-hop flip."""
        up = upstream or self
        if isinstance(source_tier, str):
            source_tier = Tier.parse(source_tier)
        if source_tier is None:
            ladder = up.channel(channel).ladder()
            if not ladder:
                raise ValueError(f"channel {channel!r} has no tiers to relay")
            source_tier = ladder[0]
        tiers = [Tier.parse(t) if isinstance(t, str) else t for t in tiers]
        with self._lock:
            if relay_id is None:
                relay_id = f"relay-{self._relay_seq}"
                self._relay_seq += 1
            if relay_id in self._relays:
                raise ValueError(f"relay {relay_id!r} already live")
        node = RelayNode(relay_id, up, channel, source_tier, tiers=tiers,
                         chaos=chaos, **relay_kw)
        node._upstream_plane = up
        with self._lock:
            self._relays[relay_id] = node
        return node

    def retire_relay(self, relay_id: str, timeout: float = 5.0) -> bool:
        with self._lock:
            node = self._relays.pop(relay_id, None)
        if node is None:
            return False
        self._absorb_relay(node)
        node.close(upstream=getattr(node, "_upstream_plane", None),
                   timeout=timeout)
        return True

    def relay(self, relay_id: str) -> RelayNode:
        with self._lock:
            return self._relays[relay_id]

    def relay_count(self) -> int:
        with self._lock:
            return len(self._relays)

    # -- lifetime floors -------------------------------------------------

    def _absorb_channel(self, ch: Channel) -> None:
        """Fold a closing channel's totals into the monotone floor —
        read BEFORE close() (close unsubscribes everyone, and the
        still-attached subscribers count as churn here)."""
        row = ch.stats()
        t = self._closed_totals
        t["ingest_dropped"] += row["ingest_dropped_total"]
        for lane in row["tiers"].values():
            t["encodes"] += lane["encodes_total"]
            t["fanout_frames"] += lane["fanout_frames_total"]
            t["delivered"] += lane["delivered_total"]
            t["dropped"] += lane["dropped_total"]
            t["churned_subscribers"] += (lane["churned_subscribers_total"]
                                         + lane["subscriber_count"])
            t["evicted_subscribers"] += lane["evicted_subscribers_total"]
            t["keyframes_forced"] += lane["keyframes_forced_total"]

    def _absorb_relay(self, node: RelayNode) -> None:
        row = node.stats()
        t = self._closed_totals
        t["relayed"] += row["relayed_total"]
        t["relay_corrupted_on_hop"] += row["corrupted_on_hop_total"]
        fwd = row["forward"]
        t["relay_forwarded"] += fwd["forwarded_total"]
        t["delivered"] += fwd["delivered_total"]
        t["dropped"] += fwd["dropped_total"]
        t["churned_subscribers"] += (fwd["churned_subscribers_total"]
                                     + fwd["subscriber_count"])
        t["evicted_subscribers"] += fwd["evicted_subscribers_total"]
        for lane in row.get("tiers", {}).values():
            t["encodes"] += lane["encodes_total"]
            t["fanout_frames"] += lane["fanout_frames_total"]
            t["delivered"] += lane["delivered_total"]
            t["dropped"] += lane["dropped_total"]
            t["churned_subscribers"] += (lane["churned_subscribers_total"]
                                         + lane["subscriber_count"])
            t["evicted_subscribers"] += lane["evicted_subscribers_total"]
            t["keyframes_forced"] += lane["keyframes_forced_total"]

    # -- observability ---------------------------------------------------

    def signals(self) -> Dict[str, float]:
        """Flat scrape series. Gauges reflect live state; ``*_total``
        counters are lifetime-monotone: the floor (closed channels /
        relays / churned subscribers) plus every live object's count."""
        with self._lock:
            channels = list(self._channels.values())
            relays = list(self._relays.values())
            floor = dict(self._closed_totals)
        subs = tiers = depth = 0
        enc = fan = deliv = drop = ingest_drop = churn = evic = keys = 0
        for ch in channels:
            row = ch.stats()
            ingest_drop += row["ingest_dropped_total"]
            for lane in row["tiers"].values():
                tiers += 1
                subs += lane["subscriber_count"]
                depth += lane["queue_depth"]
                enc += lane["encodes_total"]
                fan += lane["fanout_frames_total"]
                deliv += lane["delivered_total"]
                drop += lane["dropped_total"]
                churn += lane["churned_subscribers_total"]
                evic += lane["evicted_subscribers_total"]
                keys += lane["keyframes_forced_total"]
        relayed = fwd = hop_corrupt = 0
        for node in relays:
            row = node.stats()
            relayed += row["relayed_total"]
            hop_corrupt += row["corrupted_on_hop_total"]
            f = row["forward"]
            fwd += f["forwarded_total"]
            subs += f["subscriber_count"]
            deliv += f["delivered_total"]
            drop += f["dropped_total"]
            churn += f["churned_subscribers_total"]
            evic += f["evicted_subscribers_total"]
            for lane in row.get("tiers", {}).values():
                tiers += 1
                subs += lane["subscriber_count"]
                enc += lane["encodes_total"]
                deliv += lane["delivered_total"]
                drop += lane["dropped_total"]
                churn += lane["churned_subscribers_total"]
                evic += lane["evicted_subscribers_total"]
        return {
            "broadcast_channels": float(len(channels)),
            "broadcast_tiers": float(tiers),
            "broadcast_relays": float(len(relays)),
            "broadcast_subscribers": float(subs),
            "broadcast_queue_depth": float(depth),
            "broadcast_encodes_total": float(floor["encodes"] + enc),
            "broadcast_fanout_frames_total": float(
                floor["fanout_frames"] + fan),
            "broadcast_delivered_total": float(floor["delivered"] + deliv),
            "broadcast_dropped_total": float(floor["dropped"] + drop),
            "broadcast_ingest_dropped_total": float(
                floor["ingest_dropped"] + ingest_drop),
            "broadcast_churned_subscribers_total": float(
                floor["churned_subscribers"] + churn),
            "broadcast_evicted_subscribers_total": float(
                floor["evicted_subscribers"] + evic),
            "broadcast_keyframes_forced_total": float(
                floor["keyframes_forced"] + keys),
            "broadcast_relayed_total": float(floor["relayed"] + relayed),
            "broadcast_relay_forwarded_total": float(
                floor["relay_forwarded"] + fwd),
            "broadcast_relay_corrupted_on_hop_total": float(
                floor["relay_corrupted_on_hop"] + hop_corrupt),
        }

    def stats(self) -> dict:
        with self._lock:
            channels = dict(self._channels)
            relays = dict(self._relays)
        return {
            "channels": {n: ch.stats() for n, ch in channels.items()},
            "relays": {r: node.stats() for r, node in relays.items()},
            "channel_count": len(channels),
            "relay_count": len(relays),
        }

    # -- lifecycle -------------------------------------------------------

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            relays = list(self._relays)
            channels = list(self._channels)
        for rid in relays:
            self.retire_relay(rid, timeout=timeout)
        for name in channels:
            self.unpublish(name, timeout=timeout)


# ---------------------------------------------------------------------------
# ZMQ gate: the remote-subscriber front door
# ---------------------------------------------------------------------------


class ZmqBroadcastGate:
    """One ROUTER socket remote watchers attach through.

    Protocol (client side is ``dvf_tpu subscribe``): a DEALER connects
    and sends one JSON hello ``{"op": "hello", "channel": c,
    "tier": spec, "queue": n}``; the gate registers a plane
    subscription and replies with the tier's wire config (the client
    needs the codec parameters + whether payloads are audit-stamped).
    From then on the gate's server thread drains that subscription's
    drop-oldest queue and ships ``[header-json, payload]`` pairs.
    Sends are non-blocking: a peer whose socket buffer is full drops
    frames at the gate (counted), and one that stops reading entirely
    is evicted by the lane like any local subscriber — remote watchers
    get the exact isolation contract local ones do. ``{"op": "bye"}``
    detaches.

    Liveness (resilience.continuity): ``{"op": "hb"}`` is answered with
    a pong, and EVERY control message beats the sender's liveness
    clock. With ``liveness_timeout_s > 0`` the serve loop reaps
    subscribers silent beyond the timeout — a watcher that vanished
    without a bye (crash, partition) stops pinning a lane slot and is
    counted as a partition instead of lingering forever. 0 keeps the
    legacy posture (eviction by send-pressure only)."""

    def __init__(self, plane: BroadcastPlane, endpoint: str,
                 name: str = "gate", liveness_timeout_s: float = 0.0):
        import zmq

        self._zmq = zmq
        self.plane = plane
        self.name = name
        self.closed = False
        self.send_drops = 0
        self.hellos = 0
        self.continuity = ContinuityStats()
        self._liveness = (LivenessMonitor(liveness_timeout_s)
                          if liveness_timeout_s > 0 else None)
        self._subs: Dict[bytes, Subscription] = {}
        self._lock = threading.Lock()
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.ROUTER)
        self._sock.linger = 0
        self._sock.bind(endpoint)
        self.endpoint = endpoint
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve_loop, name=f"dvf-bcast-gate-{name}",
            daemon=True)
        self._thread.start()
        _LIVE_GATES.add(self)

    def _handle_hello(self, ident: bytes, msg: dict) -> None:
        ch = self.plane.channel(msg["channel"])
        tier = Tier.parse(msg["tier"]) if msg.get("tier") else None
        sub = self.plane.subscribe(
            msg["channel"], tier=tier, queue_size=msg.get("queue"),
            abr=bool(msg.get("abr")))
        with self._lock:
            self._subs[ident] = sub
        self.hellos += 1
        t = sub.tier
        meta = {"ok": True, "sub": sub.id, "tier": t.label(),
                "wire": t.wire, "quality": t.quality,
                "geometry": t.geometry, "audit": ch.audit_wire,
                "keyframe_interval": ch._lane_kw["keyframe_interval"],
                "delta_tile": ch._lane_kw["delta_tile"]}
        self._sock.send_multipart(
            [ident, json.dumps(meta).encode()], flags=self._zmq.NOBLOCK)

    def _serve_loop(self) -> None:
        zmq = self._zmq
        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        while not self._stop.is_set():
            for _ in range(16):  # drain control traffic first
                if not poller.poll(0):
                    break
                parts = self._sock.recv_multipart()
                ident, body = parts[0], parts[-1]
                try:
                    if self._liveness is not None:
                        self._liveness.beat(ident)
                    msg = json.loads(body)
                    if msg.get("op") == "hello":
                        self._handle_hello(ident, msg)
                    elif msg.get("op") == "hb":
                        # Heartbeat pong: the quiet-link liveness beat
                        # (data frames also count — the client only
                        # needs hb when it is not being shipped frames).
                        self.continuity.inc("heartbeats")
                        self._sock.send_multipart(
                            [ident, json.dumps(
                                {"ok": True, "op": "hb"}).encode()],
                            flags=zmq.NOBLOCK)
                    elif msg.get("op") == "bye":
                        with self._lock:
                            sub = self._subs.pop(ident, None)
                        if self._liveness is not None:
                            self._liveness.forget(ident)
                        if sub is not None:
                            self.plane.unsubscribe(sub)
                except Exception as e:  # noqa: BLE001 — one bad peer
                    try:
                        self._sock.send_multipart(
                            [ident, json.dumps(
                                {"ok": False, "error": repr(e)}).encode()],
                            flags=zmq.NOBLOCK)
                    except zmq.ZMQError:
                        pass
            with self._lock:
                live = list(self._subs.items())
            shipped = 0
            for ident, sub in live:
                if sub.evicted:
                    with self._lock:
                        self._subs.pop(ident, None)
                    continue
                for d in sub.poll(16):
                    head = json.dumps({
                        "seq": d.seq, "ts": d.capture_ts,
                        "key": bool(d.keyframe)}).encode()
                    try:
                        self._sock.send_multipart(
                            [ident, head, d.payload], flags=zmq.NOBLOCK)
                        shipped += 1
                    except zmq.ZMQError:
                        self.send_drops += 1
            if self._liveness is not None:
                # Reap watchers silent beyond the liveness timeout: a
                # peer that crashed (or partitioned) without a bye must
                # not pin its lane slot until send-pressure eviction
                # happens to notice. Clients of an armed gate beat with
                # {"op": "hb"} — receiving frames is not proof the peer
                # still exists (ROUTER sends never block on a ghost).
                for ident in self._liveness.dead():
                    self._liveness.forget(ident)
                    with self._lock:
                        sub = self._subs.pop(ident, None)
                    if sub is not None:
                        self.plane.unsubscribe(sub)
                        self.continuity.inc("partitions")
            if not shipped:
                self._stop.wait(0.005)

    def stats(self) -> dict:
        with self._lock:
            n = len(self._subs)
        return {"endpoint": self.endpoint, "remote_subscribers": n,
                "hellos_total": self.hellos,
                "send_drops_total": self.send_drops,
                "continuity": self.continuity.summary()}

    def close(self, timeout: float = 5.0) -> None:
        if self.closed:
            return
        self.closed = True
        self._stop.set()
        self._thread.join(timeout=timeout)
        with self._lock:
            subs = list(self._subs.values())
            self._subs.clear()
        for sub in subs:
            self.plane.unsubscribe(sub)
        self._sock.close(0)
        _LIVE_GATES.discard(self)
