"""Broadcast plane: one stream in, tens of thousands of watchers out
(port of ``dvf_tpu.broadcast``).

The serving tier below this package delivers every processed frame to
exactly ONE session — delivery cost scales 1:1 with viewers × codec
work, the reference's strictly-1:1 capture→display shape
(webcam_app.py). This package is the subscription layer ABOVE that
per-session delivery (ROADMAP item 2):

- a published session's output becomes a named **channel**;
- subscribers attach to a channel at a **tier** = (geometry, quality,
  wire) — each tier owns ONE closed-loop encoder (per-tier
  ``DeltaCodec`` state at the delta codec's seam), so encode cost is per-tier,
  never per-viewer (the encode-once invariant, pinned by counter
  asserts in tier-1);
- frames fan out through per-subscriber drop-oldest queues: a slow or
  dead subscriber is evicted from its OWN queue and can never stall
  the tier, the publisher, or the serving hot path;
- a **relay** node subscribes upstream and re-fans tiers to its own
  subscriber set without running any filter compute — fan-out capacity
  scales independently of device capacity, and the audit
  envelope (stamped once, at the tier encoder) survives the relay hop
  verbatim to the final subscriber.
"""

from dvf_tpu_torch.broadcast.abr import BroadcastAbrConfig, SubscriberAbr
from dvf_tpu_torch.broadcast.channel import (
    BroadcastDelivery,
    Channel,
    Subscription,
    Tier,
    TierLane,
)
from dvf_tpu_torch.broadcast.plane import BroadcastPlane, live_broadcast_sockets
from dvf_tpu_torch.broadcast.relay import RelayNode, live_relay_nodes

__all__ = [
    "BroadcastAbrConfig",
    "BroadcastDelivery",
    "BroadcastPlane",
    "Channel",
    "RelayNode",
    "SubscriberAbr",
    "Subscription",
    "Tier",
    "TierLane",
    "live_broadcast_sockets",
    "live_relay_nodes",
]
