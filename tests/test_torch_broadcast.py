"""Broadcast plane on the port (counterpart of ``tests/test_broadcast.py``,
its fleet-tier class included).

The reference's tests run against ``dvf_tpu_torch.broadcast`` and the
port's frontend on the CPU, where the native JPEG shim builds (the delta
and jpeg tiers are held here; a card without libjpeg runs raw tiers
only). Where the reference computes values the port is held to it
exactly: ``Tier.parse`` / ``label`` / ``cost_key`` and ``downscale`` are
bit-exact, and a raw and a delta lane emit the reference lane's payload
bytes for the same frames. The conftest's session guard looks at
``dvf_tpu.broadcast``'s registries only, so this module has its own
guard over the port's (``live_broadcast_sockets``,
``live_relay_nodes``) and the ``dvf-bcast*`` threads.
"""

import socket
import threading
import time

import numpy as np
import pytest

import dvf_tpu
from dvf_tpu.broadcast import BroadcastPlane as JaxBroadcastPlane
from dvf_tpu.broadcast import Tier as JaxTier
from dvf_tpu.broadcast.channel import downscale as jax_downscale
from dvf_tpu.serve import ServeConfig as JaxServeConfig
from dvf_tpu.serve import ServeFrontend as JaxServeFrontend
from dvf_tpu_torch.broadcast import (
    BroadcastAbrConfig,
    BroadcastPlane,
    SubscriberAbr,
    Tier,
)
from dvf_tpu_torch.broadcast import plane as plane_mod
from dvf_tpu_torch.broadcast import relay as relay_mod
from dvf_tpu_torch.broadcast.channel import downscale
from dvf_tpu_torch.obs.audit import WireIntegrityError, is_stamped, verify_wire
from dvf_tpu_torch.obs.registry import check_metric_name, walk_export
from dvf_tpu_torch.resilience.chaos import FaultPlan
from dvf_tpu_torch.transport.codec import make_wire_codec
from torch_ring_util import jax_native_isolated  # noqa: F401
from torch_serve_util import (  # noqa: F401
    FleetFrontend,
    ServeFrontend,
    port_fleet_guard,
    port_leak_guard,
)

pytestmark = pytest.mark.broadcast


@pytest.fixture(scope="module", autouse=True)
def port_broadcast_released():
    """Every gate socket, relay node and fan-out thread the module's
    port planes started is gone by the module's end (10 s grace)."""
    yield
    deadline = time.time() + 10.0

    def residual():
        out = {}
        gates = plane_mod.live_broadcast_sockets()
        if gates:
            out["gates"] = [g.endpoint for g in gates]
        relays = relay_mod.live_relay_nodes()
        if relays:
            out["relays"] = [r.id for r in relays]
        threads = sorted(t.name for t in threading.enumerate()
                         if t.name.startswith("dvf-bcast") and t.is_alive())
        if threads:
            out["threads"] = threads
        return out

    leaked = residual()
    while leaked and time.time() < deadline:
        time.sleep(0.1)
        leaked = residual()
    assert not leaked, f"the port's broadcast plane leaked: {leaked}"

H, W = 32, 48

JPEG = "native/q90/jpeg"
JPEG_SMALL = "24x16/q60/jpeg"
DELTA = "native/q80/delta"


def frames(n: int, h: int = H, w: int = W, seed: int = 0):
    """Deterministic pseudo-video: smooth motion so delta tiers produce
    real inter-frame payloads, seeded so every run sees equal bytes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    out = []
    for i in range(n):
        f = np.roll(base, shift=i, axis=1).copy()
        f[0, 0] = i % 251  # every frame distinct
        out.append(f)
    return out


def plane(**kw) -> BroadcastPlane:
    """A plane sized for lossless asserts (queues >> frame counts)."""
    kw.setdefault("ingest_depth", 512)
    kw.setdefault("sub_queue", 512)
    return BroadcastPlane(**kw)


def offer_all(ch, fs, t0: float = 1000.0) -> None:
    for i, f in enumerate(fs):
        ch.offer(i, f, t0 + i / 30.0)
    assert ch.flush(), "fan-out worker did not quiesce"


def poll_until(sub, want: int, deadline_s: float = 10.0):
    """Drain a subscription until ``want`` deliveries (relay pumps run
    on their own thread, so arrival lags flush())."""
    got = []
    deadline = time.time() + deadline_s
    while len(got) < want and time.time() < deadline:
        fresh = sub.poll(256)
        if fresh:
            got.extend(fresh)
        else:
            time.sleep(0.002)
    return got


# ---------------------------------------------------------------------------
# Tier algebra
# ---------------------------------------------------------------------------


class TestTier:
    def test_parse_roundtrip_and_label(self):
        t = Tier.parse("640x360/q60/delta")
        assert t.geometry == (360, 640)  # stored (h, w), displayed WxH
        assert t.quality == 60 and t.wire == "delta"
        assert t.label() == "640x360/q60/delta"
        assert Tier.parse(t.label()) == t

    def test_parse_parts_order_free_with_defaults(self):
        assert Tier.parse("delta/q50") == Tier(None, 50, "delta")
        assert Tier.parse("native") == Tier(None, 90, "jpeg")
        with pytest.raises(ValueError):
            Tier.parse("native/q90/mp3")

    def test_ladder_sorts_most_expensive_first(self):
        a, b, c = (Tier.parse(JPEG), Tier.parse(JPEG_SMALL),
                   Tier.parse("24x16/q30/jpeg"))
        assert sorted([c, b, a], key=Tier.cost_key, reverse=True) == [
            a, b, c]

    def test_downscale_deterministic(self):
        f = frames(1)[0]
        g = downscale(f, (16, 24))
        assert g.shape == (16, 24, 3)
        assert np.array_equal(g, downscale(f, (16, 24)))


# ---------------------------------------------------------------------------
# Encode-once fan-out
# ---------------------------------------------------------------------------


class TestEncodeOnce:
    def test_encode_cost_scales_with_tiers_not_viewers(self):
        """THE counter assert: N frames × T tiers × S subscribers runs
        the codecs exactly N×T times; fan-out is S×N references."""
        n_frames, n_subs = 20, 16
        pl = plane()
        try:
            ch = pl.publish("cam", tiers=[JPEG, JPEG_SMALL])
            subs = [pl.subscribe("cam", tier=[JPEG, JPEG_SMALL][i % 2])
                    for i in range(n_subs)]
            offer_all(ch, frames(n_frames))
            st = ch.stats()
            for lane in st["tiers"].values():
                assert lane["encodes_total"] == n_frames
            assert sum(l["fanout_frames_total"]
                       for l in st["tiers"].values()) == n_subs * n_frames
            sig = pl.signals()
            assert sig["broadcast_encodes_total"] == 2 * n_frames
            assert sig["broadcast_subscribers"] == n_subs
            for s in subs:
                assert len(poll_until(s, n_frames)) == n_frames
        finally:
            pl.stop()

    def test_same_tier_subscribers_get_identical_bytes(self):
        """Every subscriber on one tier receives the same object's
        bytes — and a delta tier's stream is exactly what a fresh
        identically-configured closed-loop codec produces over the
        publisher's frames (closed-loop determinism across fan-out)."""
        fs = frames(24)
        pl = plane(keyframe_interval=8, delta_tile=16)
        try:
            ch = pl.publish("cam", tiers=[DELTA, JPEG_SMALL])
            subs = [pl.subscribe("cam", tier=DELTA) for _ in range(4)]
            small = pl.subscribe("cam", tier=JPEG_SMALL)
            offer_all(ch, fs)
            got = [poll_until(s, len(fs)) for s in subs]
            for g in got:
                assert [d.seq for d in g] == list(range(len(fs)))
            for g in got[1:]:
                assert [d.payload for d in g] == [d.payload for d in got[0]]

            # Re-encode the publisher's frames through a fresh codec
            # with the tier's exact configuration: byte equality is the
            # encode-once proof (one closed loop, shared by everyone).
            t = Tier.parse(DELTA)
            codec = make_wire_codec("delta", quality=t.quality, threads=2,
                                    tile=16, keyframe_interval=8)
            try:
                codec.force_keyframe()  # the first join's honored re-key
                expect = [codec.encode(f) for f in fs]
            finally:
                codec.close()
            assert [d.payload for d in got[0]] == expect

            # Geometry tier: same discipline through the downscaler.
            ts = Tier.parse(JPEG_SMALL)
            jc = make_wire_codec("jpeg", quality=ts.quality, threads=2)
            try:
                expect_small = [jc.encode(downscale(f, ts.geometry))
                                for f in fs]
            finally:
                if hasattr(jc, "close"):
                    jc.close()
            gs = poll_until(small, len(fs))
            assert [d.payload for d in gs] == expect_small
        finally:
            pl.stop()


# ---------------------------------------------------------------------------
# Slow-subscriber isolation
# ---------------------------------------------------------------------------


class TestIsolation:
    def _run(self, with_slow: bool):
        fs = frames(30, seed=3)
        pl = plane(evict_after=4, keyframe_interval=8)
        try:
            ch = pl.publish("cam", tiers=[DELTA, JPEG])
            fast = [pl.subscribe("cam", tier=t) for t in (DELTA, JPEG)]
            slow = (pl.subscribe("cam", tier=DELTA, queue_size=2)
                    if with_slow else None)
            offer_all(ch, fs)  # slow never polls
            got = [[d.payload for d in poll_until(s, len(fs))]
                   for s in fast]
            st = ch.stats()
            return got, st, (slow.stats() if slow else None)
        finally:
            pl.stop()

    def test_slow_subscriber_evicted_without_perturbing_anyone(self):
        """A/B: the run WITH a never-polling slow watcher is
        bit-identical for every other subscriber and for the publisher
        counters; the slow peer is evicted from its own queue only."""
        got_a, st_a, _ = self._run(with_slow=False)
        got_b, st_b, slow = self._run(with_slow=True)
        assert got_b == got_a  # fast watchers: byte-identical streams
        assert st_b["offered_total"] == st_a["offered_total"]
        assert st_b["fanned_out_total"] == st_a["fanned_out_total"]
        for label in st_a["tiers"]:
            assert (st_b["tiers"][label]["encodes_total"]
                    == st_a["tiers"][label]["encodes_total"])
        assert slow["evicted"] is True
        lane = st_b["tiers"][Tier.parse(DELTA).label()]
        assert lane["evicted_subscribers_total"] == 1
        assert lane["churned_subscribers_total"] == 1
        # The clean run evicted nobody.
        assert all(l["evicted_subscribers_total"] == 0
                   for l in st_a["tiers"].values())


# ---------------------------------------------------------------------------
# Late-join re-key limiter
# ---------------------------------------------------------------------------


class TestLateJoin:
    def test_join_burst_forces_at_most_one_keyframe_per_window(self):
        """1000 simultaneous joiners on a delta tier: one forced
        keyframe per tier per interval/2 encodes, not one per joiner
        (the regression pin for the per-tier re-key limiter)."""
        interval = 16
        pl = plane(keyframe_interval=interval)
        try:
            ch = pl.publish("cam", tiers=[DELTA])
            lane = ch.add_tier(Tier.parse(DELTA))
            anchor = pl.subscribe("cam", tier=DELTA)
            offer_all(ch, frames(interval))  # past the initial cooldown
            forced0 = lane.keyframes_forced
            req0 = lane.keyframe_requests

            joiners = [pl.subscribe("cam", tier=DELTA)
                       for _ in range(1000)]
            assert lane.keyframe_requests - req0 == 1000
            offer_all(ch, frames(interval // 2, seed=9),
                      t0=2000.0)  # one limiter window
            assert lane.keyframes_forced - forced0 == 1

            # Every joiner synced on that single key: first delivery is
            # the keyframe, nothing unsynced leaked through.
            for s in joiners[:50]:
                got = poll_until(s, 1)
                assert got and got[0].keyframe
            assert anchor.stats()["skipped_unsynced"] == 0
        finally:
            pl.stop()

    def test_first_join_rekeys_immediately(self):
        """The limiter's other half: a lone late joiner is served a
        keyframe on the next encode, not after a cold cooldown."""
        pl = plane(keyframe_interval=16)
        try:
            ch = pl.publish("cam", tiers=[DELTA])
            lane = ch.add_tier(Tier.parse(DELTA))
            warm = pl.subscribe("cam", tier=DELTA)
            offer_all(ch, frames(10))
            forced0 = lane.keyframes_forced
            late = pl.subscribe("cam", tier=DELTA)
            offer_all(ch, frames(1, seed=5), t0=3000.0)
            assert lane.keyframes_forced - forced0 == 1
            got = poll_until(late, 1)
            assert got and got[0].keyframe
            assert len(poll_until(warm, 11)) == 11
        finally:
            pl.stop()

    def test_non_delta_tier_never_forces(self):
        pl = plane()
        try:
            ch = pl.publish("cam", tiers=[JPEG])
            lane = ch.add_tier(Tier.parse(JPEG))
            for _ in range(50):
                assert lane.request_keyframe()  # always self-contained
            assert lane.keyframes_forced == 0
        finally:
            pl.stop()


# ---------------------------------------------------------------------------
# Relays: forward verbatim, audit end-to-end, chaos on the hop
# ---------------------------------------------------------------------------


class TestRelay:
    def test_forward_verbatim_audit_survives_hop(self):
        """The stamped payload a relay subscriber receives is the SAME
        bytes the origin's direct subscriber got — stamped once at the
        tier encoder, verified after two hops, zero relay encodes."""
        fs = frames(12)
        pl = plane(audit_wire=True)
        try:
            ch = pl.publish("cam", tiers=[JPEG])
            direct = pl.subscribe("cam")
            node = pl.spawn_relay("cam", sub_queue=512,
                                  upstream_queue=512)
            rsub = node.subscribe()
            offer_all(ch, fs)
            got_d = poll_until(direct, len(fs))
            got_r = poll_until(rsub, len(fs))
            assert [d.payload for d in got_r] == [
                d.payload for d in got_d]
            for d in got_r:
                assert is_stamped(d.payload)
                verify_wire(d.payload, hop="subscriber")  # no raise
            st = node.stats()
            assert st["forward"]["encodes_total"] == 0  # relay-only
            assert st["relayed_total"] >= len(fs)
            assert st["corrupted_on_hop_total"] == 0
        finally:
            pl.stop()

    @pytest.mark.chaos
    def test_corrupt_wire_on_relay_hop_caught_by_envelope(self):
        """A chaos bit-flip on the relay hop: the final subscriber's
        verifier catches exactly the flipped frame; upstream (direct)
        subscribers are untouched; the relay's derived lane drops the
        corrupt frame instead of re-stamping garbage."""
        fs = frames(8)
        chaos = FaultPlan(seed=7).add("corrupt_wire", at=(2,))
        pl = plane(audit_wire=True)
        try:
            ch = pl.publish("cam", tiers=[JPEG])
            direct = pl.subscribe("cam")
            node = pl.spawn_relay(
                "cam", tiers=["24x16/q50/jpeg"], chaos=chaos,
                sub_queue=512, upstream_queue=512)
            rsub = node.subscribe()
            dsub = node.subscribe(tier=Tier.parse("24x16/q50/jpeg"))
            offer_all(ch, fs)
            got = poll_until(rsub, len(fs))
            assert len(got) == len(fs)

            bad = []
            for d in got:
                assert is_stamped(d.payload)  # still parses as stamped
                try:
                    verify_wire(d.payload, hop="subscriber")
                except WireIntegrityError:
                    bad.append(d.seq)
            assert bad == [2]
            assert node.stats()["corrupted_on_hop_total"] == 1

            # Upstream stream never saw the flip.
            for d in poll_until(direct, len(fs)):
                verify_wire(d.payload, hop="direct")

            # Derived lane: 7 clean frames re-encoded, the corrupt one
            # contained (dropped, never re-stamped as valid).
            dgot = poll_until(dsub, len(fs) - 1)
            assert [d.seq for d in dgot] == [s for s in range(len(fs))
                                             if s != 2]
        finally:
            pl.stop()

    def test_derived_tiers_from_raw_source_rejected(self):
        pl = plane()
        try:
            pl.publish("cam", tiers=["native/q90/raw"])
            with pytest.raises(ValueError, match="raw"):
                pl.spawn_relay("cam", tiers=[JPEG_SMALL])
        finally:
            pl.stop()

    def test_retire_folds_totals_into_monotone_floor(self):
        fs = frames(10)
        pl = plane()
        try:
            ch = pl.publish("cam", tiers=[JPEG])
            node = pl.spawn_relay("cam", sub_queue=512,
                                  upstream_queue=512)
            rsub = node.subscribe()
            offer_all(ch, fs)
            assert len(poll_until(rsub, len(fs))) == len(fs)
            before = pl.signals()
            assert before["broadcast_relayed_total"] >= len(fs)
            assert pl.retire_relay(node.id) is True
            assert pl.retire_relay(node.id) is False
            after = pl.signals()
            assert after["broadcast_relays"] == 0.0
            for k, v in before.items():
                if k.endswith("_total"):
                    assert after[k] >= v, k
        finally:
            pl.stop()


# ---------------------------------------------------------------------------
# Broadcast ABR
# ---------------------------------------------------------------------------


class _FakeSub:
    """Counter carrier for deterministic SubscriberAbr unit stepping."""

    class _Q:
        dropped = 0

    def __init__(self):
        self.offered = 0
        self.queue = self._Q()


class TestAbr:
    def test_controller_hysteresis_deterministic(self):
        """Pure counter transducer: pressured windows downshift after
        ``down_after``, calm windows upshift after ``up_after``, dwell
        respected — twice over the same tape, identical decisions."""
        cfg = BroadcastAbrConfig(sample_every=4, drop_frac_high=0.25,
                                 down_after=2, up_after=3, min_dwell=1)

        def tape():
            abr, sub = SubscriberAbr(cfg), _FakeSub()
            out = []
            for step in range(24):
                sub.offered += 4
                if step < 8:
                    sub.queue.dropped += 2  # 50% drop: pressured
                out.append(abr.step(sub, seq=step * 4))
            return out

        a, b = tape(), tape()
        assert a == b
        moves = [m for m in a if m]
        assert moves and moves[0] == "down"
        assert "up" in moves

    def test_pressured_subscriber_downshifts_to_cheaper_tier(self):
        """Integration: an ABR watcher with a tiny queue that never
        polls slides down the ladder; the move is a lane move (handle
        stays valid, shifts counted)."""
        pl = plane(abr_config=BroadcastAbrConfig(
            sample_every=4, drop_frac_high=0.25, down_after=2,
            up_after=1000, min_dwell=1))
        try:
            ch = pl.publish("cam", tiers=[JPEG, JPEG_SMALL])
            top = Tier.parse(JPEG)
            sub = pl.subscribe("cam", tier=top, queue_size=2, abr=True)
            assert sub.tier == top
            offer_all(ch, frames(40))
            assert sub.tier == Tier.parse(JPEG_SMALL)
            assert sub.stats()["tier_shifts"] >= 1
        finally:
            pl.stop()

    def test_abr_default_join_is_cheapest_rung(self):
        pl = plane()
        try:
            pl.publish("cam", tiers=[JPEG, JPEG_SMALL])
            cautious = pl.subscribe("cam", abr=True)
            eager = pl.subscribe("cam")
            assert cautious.tier == Tier.parse(JPEG_SMALL)
            assert eager.tier == Tier.parse(JPEG)
        finally:
            pl.stop()


# ---------------------------------------------------------------------------
# Signals: schema + monotone lifetime floors
# ---------------------------------------------------------------------------


class TestSignals:
    def test_names_conformant_and_floors_survive_churn(self):
        """Every scrape key passes the metric naming contract, the stats
        tree walks clean, and *_total series never move backward
        through subscribe/evict/retire/unpublish churn."""
        pl = plane(evict_after=2)
        try:
            ch = pl.publish("cam", tiers=[DELTA, JPEG])
            subs = [pl.subscribe("cam") for _ in range(5)]
            slow = pl.subscribe("cam", tier=DELTA, queue_size=1)
            node = pl.spawn_relay("cam", sub_queue=512,
                                  upstream_queue=512)
            rsub = node.subscribe()
            offer_all(ch, frames(16))
            poll_until(rsub, 16)

            sig1 = pl.signals()
            bad = [(k, why) for k in sig1
                   if (why := check_metric_name(k))]
            assert not bad, bad
            assert walk_export(pl.stats()) == []
            assert sig1["broadcast_evicted_subscribers_total"] >= 1
            assert slow.evicted

            for s in subs:
                pl.unsubscribe(s)
            pl.retire_relay(node.id)
            pl.unpublish("cam")
            sig2 = pl.signals()
            for k, v in sig1.items():
                if k.endswith("_total"):
                    assert sig2[k] >= v, (
                        f"{k} moved backward across churn: {v} -> "
                        f"{sig2[k]}")
            assert sig2["broadcast_channels"] == 0.0
            assert sig2["broadcast_subscribers"] == 0.0
        finally:
            pl.stop()


# ---------------------------------------------------------------------------
# Lineage across the broadcast plane
# ---------------------------------------------------------------------------


@pytest.mark.lineage
class TestBroadcastLineage:
    def test_decomposition_additive_through_fanout(self):
        pl = plane(lineage=True)
        try:
            ch = pl.publish("cam", tiers=[JPEG])
            sub = pl.subscribe("cam")
            offer_all(ch, frames(6), t0=time.time())
            got = poll_until(sub, 6)
            for d in got:
                lin = d.lineage
                assert lin is not None
                comps = lin.components_ms()
                assert "encode" in comps and "deliver" in comps
                assert sum(comps.values()) == pytest.approx(
                    lin.total_ms(), abs=1e-6)
        finally:
            pl.stop()

    def test_relay_hop_lands_in_decomposition(self):
        """The relay stage is one more additive component: p99 across
        the broadcast path decomposes encode → … → relay → deliver."""
        pl = plane(lineage=True)
        try:
            ch = pl.publish("cam", tiers=[JPEG])
            node = pl.spawn_relay("cam", sub_queue=512,
                                  upstream_queue=512)
            rsub = node.subscribe()
            offer_all(ch, frames(6), t0=time.time())
            got = poll_until(rsub, 6)
            assert got
            for d in got:
                comps = d.lineage.components_ms()
                assert "encode" in comps and "relay" in comps
                assert "deliver" in comps
                assert sum(comps.values()) == pytest.approx(
                    d.lineage.total_ms(), abs=1e-6)
        finally:
            pl.stop()


# ---------------------------------------------------------------------------
# Relay axis on the elasticity controller
# ---------------------------------------------------------------------------


@pytest.mark.elastic
class TestRelayAxis:
    def _drive(self):
        from dvf_tpu_torch.control.fleet_elastic import (
            ElasticConfig,
            FleetElasticityController,
        )

        cfg = ElasticConfig(relay_subscribers_high=100,
                            relay_out_after=2, relay_in_after=3,
                            relay_cooldown=1, max_relays=2)
        ctl = FleetElasticityController(cfg)
        relays, prev, log = 0, None, []
        for step in range(24):
            subs = 300.0 if step < 10 else 0.0
            row = {"broadcast_subscribers": subs,
                   "relays_live": float(relays),
                   "broadcast_dropped_total": 0.0}
            for a in ctl.step(row, prev):
                if a.kind in ("relay_out", "relay_in"):
                    log.append((a.kind, a.target, a.value))
                    relays = int(a.value)
            prev = row
        return log

    def test_relay_out_in_deterministic_replay(self):
        log = self._drive()
        kinds = [k for k, _, _ in log]
        assert kinds == ["relay_out", "relay_out", "relay_in",
                         "relay_in"]
        assert [v for _, _, v in log] == [1, 2, 1, 0]
        assert all(t == "relay" for _, t, _ in log[:2])
        assert log == self._drive()  # byte-identical replay

    def test_axis_disabled_by_default(self):
        from dvf_tpu_torch.control.fleet_elastic import (
            ElasticConfig,
            relay_pressure,
        )

        row = {"broadcast_subscribers": 1e6, "relays_live": 0.0}
        assert relay_pressure(row, None, ElasticConfig()) is None


# ---------------------------------------------------------------------------
# ZMQ gate (remote subscribers)
# ---------------------------------------------------------------------------


class TestZmqGate:
    def test_remote_subscriber_round_trip(self):
        zmq = pytest.importorskip("zmq")
        import json

        from dvf_tpu_torch.broadcast.plane import ZmqBroadcastGate

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        pl = plane()
        gate = None
        sock = None
        try:
            ch = pl.publish("cam", tiers=[JPEG])
            gate = ZmqBroadcastGate(pl, f"tcp://127.0.0.1:{port}")
            ctx = zmq.Context.instance()
            sock = ctx.socket(zmq.DEALER)
            sock.linger = 0
            sock.connect(gate.endpoint)
            sock.send_json({"op": "hello", "channel": "cam",
                            "tier": JPEG})
            assert sock.poll(5000), "no hello reply"
            meta = json.loads(sock.recv_multipart()[-1])
            assert meta["ok"] and meta["wire"] == "jpeg"
            assert meta["tier"] == JPEG

            fs = frames(4)
            got = []
            deadline = time.time() + 10.0
            while len(got) < 3 and time.time() < deadline:
                offer_all(ch, fs)
                while sock.poll(50):
                    parts = sock.recv_multipart()
                    head = json.loads(parts[0])
                    got.append((head["seq"], parts[1]))
            assert len(got) >= 3
            jc = make_wire_codec("jpeg", quality=90, threads=2)
            try:
                expect = jc.encode(fs[0])
            finally:
                if hasattr(jc, "close"):
                    jc.close()
            first_seq = [p for s0, p in got if s0 % len(fs) == 0]
            assert first_seq and all(p == expect for p in first_seq)
            sock.send_json({"op": "bye"})
            assert gate.stats()["hellos_total"] == 1
        finally:
            if sock is not None:
                sock.close(0)
            if gate is not None:
                gate.close()
            pl.stop()


# ---------------------------------------------------------------------------
# Serve-tier integration (publish at admission, in-process tap)
# ---------------------------------------------------------------------------


class TestServeIntegration:
    def _frontend(self):
        from dvf_tpu_torch.ops import get_filter
        from dvf_tpu_torch.serve import ServeConfig

        return ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=4, queue_size=1000,
                        out_queue_size=1000, slo_ms=60_000.0,
                        broadcast_ingest_depth=512,
                        broadcast_sub_queue=512))

    def test_publish_subscribe_tees_exact_delivery(self):
        """The channel carries exactly what the publisher's client
        polls: same frames, tier-encoded once, regardless of watcher
        count — and the serve scrape stays schema-conformant."""
        n = 12
        fe = self._frontend()
        with fe:
            sid = fe.open_stream(publish="cam", publish_tiers=[JPEG])
            subs = [fe.subscribe("cam") for _ in range(5)]
            fs = frames(n, h=16, w=24)
            for f in fs:
                fe.submit(sid, f)
            delivered = []
            deadline = time.time() + 20.0
            while len(delivered) < n and time.time() < deadline:
                delivered.extend(fe.poll(sid))
                time.sleep(0.002)
            assert len(delivered) == n
            assert fe.broadcast.channel("cam").flush()

            codec = make_wire_codec("jpeg", quality=90, threads=2)
            try:
                expect = [codec.encode(d.frame) for d in delivered]
            finally:
                if hasattr(codec, "close"):
                    codec.close()
            for s in subs:
                got = poll_until(s, n)
                assert [d.payload for d in got] == expect
            lane = fe.stats()["broadcast"]["channels"]["cam"][
                "tiers"][JPEG]
            assert lane["encodes_total"] == n  # 5 watchers, n encodes
            sig = fe.signals()
            assert sig["broadcast_channels"] == 1.0
            bad = [(k, why) for k in sig
                   if (why := check_metric_name(k))]
            assert not bad, bad

    def test_publish_unknown_session_rolls_back(self):
        from dvf_tpu_torch.serve import ServeError

        fe = self._frontend()
        with fe:
            fe.open_stream()
            with pytest.raises(ServeError, match="no open session"):
                fe.publish_stream("nope", "cam", tiers=[JPEG])
            # The half-registered channel was rolled back: the name is
            # free for the next publisher.
            sid = fe.open_stream()
            fe.publish_stream(sid, "cam", tiers=[JPEG])


# ---------------------------------------------------------------------------
# Parity with dvf_tpu.broadcast
# ---------------------------------------------------------------------------

_SPECS = ["640x360/q60/delta", "delta/q50", "native", "native/q90/raw",
          "24x16/q30/jpeg", "1920x1080/raw", "q75/jpeg/96x54",
          "960x540/raw"]


class TestParity:
    @pytest.mark.parametrize("spec", _SPECS)
    def test_tier_parse_label_cost_equal(self, spec):
        t, j = Tier.parse(spec), JaxTier.parse(spec)
        assert (t.geometry, t.quality, t.wire) == (j.geometry, j.quality,
                                                   j.wire)
        assert t.label() == j.label()
        assert t.cost_key() == j.cost_key()

    def test_ladder_order_equal(self):
        port = sorted((Tier.parse(s) for s in _SPECS), key=Tier.cost_key,
                      reverse=True)
        ref = sorted((JaxTier.parse(s) for s in _SPECS),
                     key=JaxTier.cost_key, reverse=True)
        assert [t.label() for t in port] == [t.label() for t in ref]

    @pytest.mark.parametrize("geometry", [(16, 24), (11, 7), (32, 48),
                                          (540, 960), (360, 640)])
    def test_downscale_bit_exact(self, geometry):
        src = (H, W) if geometry[0] < 100 else (1080, 1920)
        f = frames(1, h=src[0], w=src[1], seed=4)[0]
        a, b = downscale(f, geometry), jax_downscale(f, geometry)
        assert a.dtype == b.dtype == np.uint8
        assert np.array_equal(a, b)

    @pytest.mark.parametrize("tiers", [
        ["native/q90/raw", "24x16/raw"],
        ["native/q80/delta", "24x16/q60/delta"],
        ["native/q90/jpeg"],
    ])
    def test_lane_payloads_equal_reference(self, tiers):
        """The same frames offered on both packages' planes: every tier's
        subscriber receives the reference's payload bytes."""
        fs = frames(20, seed=6)
        out = []
        for cls in (BroadcastPlane, JaxBroadcastPlane):
            pl = cls(ingest_depth=512, sub_queue=512, keyframe_interval=8,
                     delta_tile=16)
            try:
                ch = pl.publish("cam", tiers=tiers)
                subs = [pl.subscribe("cam", tier=t) for t in tiers]
                offer_all(ch, fs)
                out.append([[(d.seq, d.keyframe, d.payload)
                             for d in poll_until(s, len(fs))]
                            for s in subs])
                encodes = {k: v["encodes_total"]
                           for k, v in ch.stats()["tiers"].items()}
                out.append(encodes)
            finally:
                pl.stop()
        port, port_enc, ref, ref_enc = out
        assert port_enc == ref_enc == {
            Tier.parse(t).label(): len(fs) for t in tiers}
        for a, b in zip(port, ref):
            assert len(a) == len(b) == len(fs)
            assert a == b

    def test_published_session_channel_equals_reference(self):
        """A published serving session on both frontends: the channel's
        raw payloads are the publisher's delivered frames, equal across
        the packages (invert: bit-exact)."""
        n = 8
        fs = frames(n, h=16, w=24, seed=8)
        out = []
        for frontend, config, filt in (
                (ServeFrontend, None, None),
                (JaxServeFrontend, JaxServeConfig, dvf_tpu.get_filter)):
            if config is None:
                from dvf_tpu_torch.ops import get_filter
                from dvf_tpu_torch.serve import ServeConfig as config
                filt = get_filter
            fe = frontend(filt("invert"), config(
                batch_size=4, queue_size=1000, out_queue_size=1000,
                slo_ms=60_000.0, broadcast_ingest_depth=512,
                broadcast_sub_queue=512))
            with fe:
                sid = fe.open_stream(publish="cam",
                                     publish_tiers=["native/raw",
                                                    "12x8/raw"])
                subs = [fe.subscribe("cam", tier=t)
                        for t in ("native/raw", "12x8/raw")]
                for f in fs:
                    fe.submit(sid, f)
                got = []
                deadline = time.time() + 20.0
                while len(got) < n and time.time() < deadline:
                    got.extend(fe.poll(sid))
                    time.sleep(0.002)
                assert len(got) == n
                assert fe.broadcast.channel("cam").flush()
                out.append([[d.payload for d in poll_until(s, n)]
                            for s in subs])
        assert out[0] == out[1]
        assert out[0][0] == [(255 - f).tobytes() for f in fs]


# ---------------------------------------------------------------------------
# Fleet-tier integration (publish pump + relay actuators)
# ---------------------------------------------------------------------------


@pytest.mark.fleet
class TestFleetIntegration:
    def _fleet(self):
        from dvf_tpu_torch.fleet import FleetConfig
        from dvf_tpu_torch.ops import get_filter
        from dvf_tpu_torch.serve import ServeConfig

        return FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=1, mode="local",
                        serve=ServeConfig(
                            batch_size=4, queue_size=1000,
                            out_queue_size=1000, slo_ms=60_000.0,
                            broadcast_ingest_depth=512,
                            broadcast_sub_queue=512)))

    def test_publish_pump_relay_spawn_retire(self):
        """Fleet front door: the publish pump owns polling the
        published session, watchers and a relay-only egress replica
        both see the stream, and the relay actuators land in signals
        and the reconfiguration ledger."""
        from dvf_tpu_torch.obs import ledger as ledger_mod

        n = 10
        fleet = self._fleet()
        with fleet:
            sid = fleet.open_stream()
            fleet.publish_stream(sid, "cam", tiers=[JPEG])
            sub = fleet.subscribe("cam")
            for f in frames(n, h=16, w=24):
                fleet.submit(sid, f)
            got = poll_until(sub, n, deadline_s=20.0)
            assert [d.seq for d in got] == list(range(n))

            node = fleet.spawn_broadcast_relay()  # busiest channel
            rsub = node.subscribe()
            for f in frames(4, h=16, w=24, seed=2):
                fleet.submit(sid, f)
            rgot = poll_until(rsub, 4, deadline_s=20.0)
            assert len(rgot) == 4

            sig = fleet.signals()
            assert sig["relay_spawns_total"] == 1.0
            assert sig["broadcast_pump_errors_total"] == 0.0
            assert fleet.retire_broadcast_relay(node.id) is True
            assert fleet.signals()["relay_retires_total"] == 1.0
            kinds = fleet.stats()["ledger"]["by_kind"]
            assert kinds.get(ledger_mod.RELAY_SPAWN) == 1
            assert kinds.get(ledger_mod.RELAY_RETIRE) == 1
            ev = fleet.elastic_view()
            assert ev["broadcast_subscribers"] >= 1.0
            assert ev["relays_live"] == 0.0
            assert walk_export(fleet.stats()) == []
