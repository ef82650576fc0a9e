"""Load-adaptive control plane on the port (counterpart of
``tests/test_control.py`` without its soak-bench class, whose writer is
a bench of the JAX package).

The reference's tests run against ``dvf_tpu_torch.control`` and the
port's frontend on the CPU. Where the reference computes values, the
port is held to it exactly: the same seeded telemetry windows replayed
through both packages' control planes give identical action sequences,
and a downshifted session's frames equal the reference frontend's for
the same input (uint8 from the same program: bit-exact).
"""

import time

import numpy as np
import pytest

import dvf_tpu
from dvf_tpu.control import ControlConfig as JaxControlConfig
from dvf_tpu.control import ControlPlane as JaxControlPlane
from dvf_tpu.serve import ServeConfig as JaxServeConfig
from dvf_tpu.serve import ServeFrontend as JaxServeFrontend
from dvf_tpu_torch.control import (
    TIER_BATCH,
    TIER_INTERACTIVE,
    TIER_STANDARD,
    ControlConfig,
    ControlPlane,
    is_pressure,
)
from dvf_tpu_torch.obs.registry import TimeSeriesRing, walk_export
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.serve import AdmissionError, ServeConfig
from torch_serve_util import ServeFrontend, port_leak_guard  # noqa: F401

pytestmark = pytest.mark.control

H, W = 16, 24


def drain(fe, sid, want, deadline_s=60.0):
    got = []
    deadline = time.time() + deadline_s
    while len(got) < want and time.time() < deadline:
        got.extend(fe.poll(sid))
        time.sleep(0.002)
    got.extend(fe.poll(sid))
    return got


def wait_for(pred, deadline_s=20.0, period=0.01):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(period)
    return pred()


class _FakeActuator:
    """Records every actuation; accepts everything."""

    def __init__(self):
        self.calls = []

    def control_view(self):
        return {}

    def request_batch_size(self, label, n, reason=None):
        self.calls.append(("resize", label, n))
        return True

    def set_tick_interval(self, t):
        self.calls.append(("tick", t))

    def request_session_quality(self, sid, level, reason=None):
        self.calls.append(("quality", sid, level))
        return True

    def set_admission_tier_floor(self, floor):
        self.calls.append(("floor", floor))

    def flight_trip(self, reason):
        self.calls.append(("flight", reason))


def _cfg(**kw) -> ControlConfig:
    base = dict(down_after=2, up_after=2, overload_after=3, min_dwell=4,
                resize_hold=2, resize_cooldown=3, saturate_after=4,
                batch_max=16)
    base.update(kw)
    return ControlConfig(**base)


def _window(seed=7, n=48):
    """One seeded synthetic telemetry window: pressure epochs, bucket
    occupancy drift, sessions across all three tiers."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        pressured = (i % 13) < 7
        rows.append({
            "open_sessions": 3.0,
            "queue_depth": float(20 + rng.integers(0, 30))
                if pressured else float(rng.integers(0, 2)),
            "slo_headroom_ms": -5.0 if pressured else 40.0,
            "shed_total": float(i // 6),
            "dropped_at_ingress_total": 0.0,
            "buckets": [{
                "label": "x",
                "batch_size": 8,
                "mean_valid_rows": 1.5 + float(i % 3),
                "queue_depth": 25.0 if pressured else 0.0,
            }],
            "sessions": [
                {"sid": "a", "tier": TIER_BATCH,
                 "level": 1 if 9 < i < 22 else 0, "downshiftable": True},
                {"sid": "b", "tier": TIER_INTERACTIVE, "level": 0,
                 "downshiftable": True},
            ],
        })
    return rows


# ------------------------------------------------ deterministic controllers


class TestControllerDeterminism:
    def test_same_window_replayed_twice_identical_actions(self):
        """The same ring window replayed through a FRESH
        plane yields a byte-identical actuation sequence — no
        wall-clock, no randomness in any decision."""
        def run_once():
            plane = ControlPlane(_FakeActuator(), _cfg())
            seq = []
            for row in _window():
                for a in plane.decide(dict(row)):
                    seq.append((a.kind, a.target, a.value, a.reason))
            return seq

        first, second = run_once(), run_once()
        assert first == second
        assert len(first) > 5  # the window actually exercises the loop

    def test_pressure_predicate(self):
        cfg = _cfg()
        calm = {"open_sessions": 2.0, "queue_depth": 0.0,
                "slo_headroom_ms": 40.0}
        assert not is_pressure(calm, None, cfg)
        assert is_pressure(dict(calm, queue_depth=6.0), None, cfg)
        assert is_pressure(dict(calm, slo_headroom_ms=-1.0), None, cfg)
        # Sheds advancing since the previous row = pressure.
        assert is_pressure(dict(calm, shed_total=3.0),
                           dict(calm, shed_total=1.0), cfg)
        assert not is_pressure(dict(calm, shed_total=3.0),
                               dict(calm, shed_total=3.0), cfg)

    def test_tier_ordering_batch_sheds_first_interactive_recovers_first(self):
        plane = ControlPlane(_FakeActuator(), _cfg())
        sess = [
            {"sid": "i", "tier": TIER_INTERACTIVE, "level": 0,
             "downshiftable": True},
            {"sid": "s", "tier": TIER_STANDARD, "level": 0,
             "downshiftable": True},
        ]
        press = {"open_sessions": 2.0, "queue_depth": 50.0,
                 "slo_headroom_ms": -1.0, "buckets": [], "sessions": sess}
        downs = []
        for _ in range(4):
            downs += [a for a in plane.decide(dict(press))
                      if a.kind == "downshift"]
        # The standard-tier session sheds before the interactive one.
        assert downs and downs[0].target == "s"
        # Recovery: interactive (lowest tier value) upshifts first.
        plane2 = ControlPlane(_FakeActuator(), _cfg(min_dwell=0))
        calm = {"open_sessions": 2.0, "queue_depth": 0.0,
                "slo_headroom_ms": 40.0, "buckets": [],
                "sessions": [
                    {"sid": "i", "tier": TIER_INTERACTIVE, "level": 1,
                     "downshiftable": True},
                    {"sid": "bt", "tier": TIER_BATCH, "level": 1,
                     "downshiftable": True},
                ]}
        ups = []
        for _ in range(4):
            ups += [a for a in plane2.decide(dict(calm))
                    if a.kind == "upshift"]
        assert ups and ups[0].target == "i"

    def test_quality_no_oscillation_within_dwell(self):
        """Hysteresis: after a downshift, an upshift for the SAME
        session cannot fire within ``min_dwell`` samples even if the
        window flaps pressure every sample."""
        plane = ControlPlane(_FakeActuator(),
                             _cfg(down_after=1, up_after=1, min_dwell=10))
        sess = [{"sid": "a", "tier": TIER_BATCH, "level": 0,
                 "downshiftable": True}]
        moves = []  # (sample_idx, kind)
        for i in range(12):
            pressured = i < 2   # brief burst, then calm flapping
            row = {"open_sessions": 1.0,
                   "queue_depth": 50.0 if pressured else 0.0,
                   "slo_headroom_ms": -1.0 if pressured else 40.0,
                   "buckets": [],
                   "sessions": [dict(sess[0],
                                     level=1 if moves else 0)]}
            for a in plane.decide(row):
                if a.kind in ("downshift", "upshift"):
                    moves.append((i, a.kind))
        assert moves[0][1] == "downshift"
        ups = [m for m in moves if m[1] == "upshift"]
        assert all(u[0] - moves[0][0] >= 10 for u in ups)

    def test_tier_floor_ladder_and_release(self):
        plane = ControlPlane(_FakeActuator(), _cfg())
        press = {"open_sessions": 1.0, "queue_depth": 50.0,
                 "slo_headroom_ms": -1.0, "buckets": [], "sessions": []}
        calm = {"open_sessions": 1.0, "queue_depth": 0.0,
                "slo_headroom_ms": 40.0, "buckets": [], "sessions": []}
        floors = []
        for _ in range(7):
            floors += [a.value for a in plane.decide(dict(press))
                       if a.kind == "tier_floor"]
        # overload_after=3 → refuse batch (floor STANDARD); 2× → only
        # interactive admits.
        assert floors == [TIER_STANDARD, TIER_INTERACTIVE]
        # Stepwise release, one tier per calm run (up_after=2): standard
        # is re-admitted first; batch only after the window stays calm
        # WITH standard traffic back — never the whole backlog at once.
        for _ in range(5):
            floors += [a.value for a in plane.decide(dict(calm))
                       if a.kind == "tier_floor"]
        assert floors == [TIER_STANDARD, TIER_INTERACTIVE, TIER_STANDARD,
                          None]

    def test_batch_resize_from_occupancy_with_hold_and_cooldown(self):
        plane = ControlPlane(_FakeActuator(), _cfg())
        row = {"open_sessions": 1.0, "queue_depth": 0.0,
               "slo_headroom_ms": 40.0, "sessions": [],
               "buckets": [{"label": "x", "batch_size": 8,
                            "mean_valid_rows": 1.2, "queue_depth": 0.0}]}
        resizes = []
        for _ in range(4):
            resizes += [a for a in plane.decide(dict(row))
                        if a.kind == "resize"]
        # Occupancy 1.2 × headroom 1.3 → ladder fit 2; ONE resize
        # after resize_hold agreeing samples, then cooldown holds the
        # (still-unapplied) wish through the remaining samples.
        assert [(-1 if a.target != "x" else a.value)
                for a in resizes] == [2]
        # Closed loop: once the actuator applied it (the row now says
        # batch_size=2), the controller converges — no more resizes.
        applied = dict(row, buckets=[dict(row["buckets"][0],
                                          batch_size=2)])
        for _ in range(6):
            assert not [a for a in plane.decide(dict(applied))
                        if a.kind == "resize"]
        # No measured occupancy → never act on a guess.
        plane2 = ControlPlane(_FakeActuator(), _cfg())
        row2 = dict(row, buckets=[{"label": "x", "batch_size": 8,
                                   "mean_valid_rows": None,
                                   "queue_depth": 0.0}])
        for _ in range(6):
            assert not [a for a in plane2.decide(dict(row2))
                        if a.kind == "resize"]

    def test_shrink_refused_for_interactive_bucket_and_raised_floor(self):
        """With resizes riding the stall-free hot swap, an interactive
        tenant no longer blocks a shrink — the swap costs the bucket ~0
        serving time, so reclaiming padded-row compute is safe under a
        tier-0 session. Only an overload episode (pressure or a raised
        floor — floor-up calm is fake calm) still refuses it."""
        calm = {"open_sessions": 1.0, "queue_depth": 0.0,
                "slo_headroom_ms": 40.0, "sessions": [],
                "buckets": [{"label": "x", "batch_size": 8,
                             "mean_valid_rows": 1.2, "queue_depth": 0.0,
                             "min_tier": TIER_INTERACTIVE}]}
        plane = ControlPlane(_FakeActuator(), _cfg())
        resizes = []
        for _ in range(4):
            resizes += [a for a in plane.decide(dict(calm))
                        if a.kind == "resize"]
        assert [a.value for a in resizes] == [2]
        # Batch-only bucket: the shrink fires exactly the same way.
        plane2 = ControlPlane(_FakeActuator(), _cfg())
        row2 = dict(calm, buckets=[dict(calm["buckets"][0],
                                        min_tier=TIER_BATCH)])
        resizes = []
        for _ in range(4):
            resizes += [a for a in plane2.decide(dict(row2))
                        if a.kind == "resize"]
        assert [a.value for a in resizes] == [2]
        # Raised floor blocks the shrink even for a batch-only bucket:
        # with a long-calm release posture (up_after), the floor stays
        # up through the calm window and no shrink fires in it.
        plane3 = ControlPlane(_FakeActuator(),
                              _cfg(overload_after=2, up_after=20))
        press = {"open_sessions": 1.0, "queue_depth": 50.0,
                 "slo_headroom_ms": -1.0, "sessions": [], "buckets": []}
        for _ in range(4):
            plane3.decide(dict(press))   # trip the floor
        assert plane3.tiers.floor is not None
        for _ in range(6):               # calm rows, floor still raised
            assert not [a for a in plane3.decide(dict(row2))
                        if a.kind == "resize"]
        assert plane3.tiers.floor is not None

    def test_resize_direction_flip_waits_out_dwell(self):
        """After a grow, the opposite-direction shrink waits out
        ``resize_flip_dwell`` samples — the anti-limit-cycle bound."""
        plane = ControlPlane(_FakeActuator(),
                             _cfg(resize_flip_dwell=12, resize_cooldown=2))
        grow = {"open_sessions": 1.0, "queue_depth": 40.0,
                "slo_headroom_ms": 40.0, "sessions": [],
                "buckets": [{"label": "x", "batch_size": 4,
                             "mean_valid_rows": 4.0, "queue_depth": 40.0,
                             "min_tier": TIER_BATCH}]}
        grows = []
        for _ in range(4):
            grows += [a for a in plane.decide(dict(grow))
                      if a.kind == "resize"]
        assert grows and all(a.value > 4 for a in grows)
        # Immediately calm at low occupancy: the shrink must wait.
        shrink = dict(grow, queue_depth=0.0,
                      buckets=[dict(grow["buckets"][0],
                                    batch_size=grows[-1].value,
                                    mean_valid_rows=1.0, queue_depth=0.0)])
        early = []
        for _ in range(5):
            early += [a for a in plane.decide(dict(shrink))
                      if a.kind == "resize"]
        assert early == []
        late = []
        for _ in range(12):
            late += [a for a in plane.decide(dict(shrink))
                     if a.kind == "resize"]
        # Fires once the dwell is out (and re-fires each cooldown while
        # the fake actuator leaves the wish unapplied) — always the
        # shrink target, never another grow.
        assert late and {a.value for a in late} == {2}

    def test_saturation_emits_one_flight_action_per_episode(self):
        plane = ControlPlane(_FakeActuator(), _cfg(saturate_after=3))
        press = {"open_sessions": 1.0, "queue_depth": 50.0,
                 "slo_headroom_ms": -1.0, "buckets": [],
                 "sessions": [{"sid": "a", "tier": TIER_BATCH,
                               "level": 1, "downshiftable": True}]}
        flights = []
        for _ in range(10):   # max_level=1: nothing left to give
            flights += [a for a in plane.decide(dict(press))
                        if a.kind == "flight"]
        assert len(flights) == 1
        assert "saturated" in flights[0].reason


# ------------------------------------------------- ring hook containment


class TestRingHookContainment:
    def test_raising_hook_counted_and_sampling_continues(self):
        """A raising ``on_sample`` hook must not kill the
        sampling thread — the error is counted (hook_errors_total) and
        the ring keeps appending rows."""
        calls = []

        def bad_hook(prev, cur):
            calls.append(cur)
            raise RuntimeError("broken controller")

        ring = TimeSeriesRing(lambda: {"x": 1.0}, interval_s=0.02,
                              on_sample=bad_hook).start()
        try:
            assert wait_for(lambda: len(ring) >= 3, deadline_s=10.0)
            assert ring._thread.is_alive()   # sampler survived
        finally:
            ring.stop()
        st = ring.series()
        assert st["hook_errors_total"] >= 3
        assert len(st["rows"]) >= 3
        assert len(calls) == st["hook_errors_total"]  # hook ran each tick
        assert st["sample_errors"] == 0  # hook errors are not sample errors


# ------------------------------------------------- live quality actuation


class TestQualityActuation:
    def _frontend(self, **kw):
        base = dict(batch_size=2, queue_size=200, out_queue_size=500,
                    slo_ms=60_000.0, control=True,
                    control_config=ControlConfig(interval_s=30.0),
                    telemetry_sample_s=30.0)   # manual decide() only —
        #   the loop itself is pinned deterministic above
        base.update(kw)
        return ServeFrontend(get_filter("invert"), ServeConfig(**base))

    def test_downshift_full_res_delivery_and_bit_identical_recovery(self):
        """Acceptance: a downshifted session still delivers
        FULL-resolution frames (the sr upscale return path);
        bit-exactness is waived only while downshifted; a recovered
        session returns to bit-identical full-quality output."""
        fe = self._frontend()
        rng = np.random.default_rng(3)
        with fe:
            sid = fe.open_stream(tier=TIER_INTERACTIVE)
            f0 = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
            fe.submit(sid, f0)
            full = drain(fe, sid, 1)
            assert len(full) == 1
            assert np.array_equal(full[0].frame, 255 - f0)  # bit-exact

            assert fe.request_session_quality(sid, 1)
            assert wait_for(lambda: fe.stats()["sessions"][sid]
                            ["quality_level"] == 1)
            f1 = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
            fe.submit(sid, f1)
            down = drain(fe, sid, 1)
            assert len(down) == 1
            # STILL full resolution: decimated ×2 at the door, served
            # by the |upscale(scale=2) bucket.
            assert down[0].frame.shape == (H, W, 3)
            expect = np.repeat(np.repeat(255 - f1[::2, ::2], 2, axis=0),
                               2, axis=1)
            assert np.array_equal(down[0].frame, expect)
            # The downshift bucket exists beside the base bucket.
            assert any("upscale" in label
                       for label in fe.stats()["buckets"])

            assert fe.request_session_quality(sid, 0)
            assert wait_for(lambda: fe.stats()["sessions"][sid]
                            ["quality_level"] == 0)
            f2 = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
            fe.submit(sid, f2)
            rec = drain(fe, sid, 1)
            assert len(rec) == 1
            assert np.array_equal(rec[0].frame, 255 - f2)  # bit-exact again
            st = fe.stats()["sessions"][sid]
            assert st["quality_shifts"] == 2
            assert st["tier"] == TIER_INTERACTIVE

    def test_quality_refused_on_indivisible_geometry(self):
        """A session whose pinned geometry doesn't divide by 2^level
        cannot downshift — the request returns False and nothing
        changes (the controller counts it and re-decides later)."""
        fe = self._frontend()
        with fe:
            sid = fe.open_stream(op_chain="invert", frame_shape=(15, 9, 3))
            fe.submit(sid, np.zeros((15, 9, 3), dtype=np.uint8))
            assert len(drain(fe, sid, 1)) == 1
            assert not fe.request_session_quality(sid, 1)
            assert fe.stats()["sessions"][sid]["quality_level"] == 0
        # And a session that never flowed has no geometry to shift.
        fe2 = self._frontend()
        with fe2:
            sid2 = fe2.open_stream()
            assert not fe2.request_session_quality(sid2, 1)

    def test_control_decisions_observable(self):
        """Acceptance: decision counters on /metrics (registry scrape),
        per-session tier+quality in stats(), live actuation state."""
        fe = self._frontend()
        with fe:
            sid = fe.open_stream(tier=TIER_BATCH)
            fe.submit(sid, np.zeros((H, W, 3), dtype=np.uint8))
            drain(fe, sid, 1)
            # Drive one decision through the plane (manual sample: the
            # cadence is armed at 30 s so the test owns the clock).
            fe.control_plane.on_sample(
                None, dict(fe.signals(), **fe.control_view()))
            prom = fe.registry.to_prometheus()
            for series in ("dvf_serve_control_actions_total",
                           "dvf_serve_control_downshifts_total",
                           "dvf_serve_control_tier_floor_changes_total",
                           "dvf_serve_dispatch_tick_s"):
                assert series in prom, series
            st = fe.stats()
            assert st["control"]["actions_total"] >= 1   # the tick action
            assert st["sessions"][sid]["tier"] == TIER_BATCH
            assert st["sessions"][sid]["quality_level"] == 0
            assert isinstance(st["control"]["decisions"], list)
            assert not walk_export(st)   # schema-conformant export

    def test_batch_resize_applies_when_bucket_idle(self):
        """request_batch_size lands once nothing is in flight; the
        bucket's staging rebuilds at the new shape and frames keep
        flowing correctly."""
        fe = self._frontend(batch_size=4)
        with fe:
            sid = fe.open_stream(op_chain="invert", frame_shape=(H, W, 3))
            fr = np.arange(H * W * 3, dtype=np.uint8).reshape(H, W, 3)
            fe.submit(sid, fr)
            assert len(drain(fe, sid, 1)) == 1
            label = next(iter(fe.stats()["buckets"]))
            assert fe.request_batch_size(label, 2)
            assert wait_for(
                lambda: fe.stats()["buckets"][label]["batch_size"] == 2)
            for _ in range(3):
                fe.submit(sid, fr)
            got = drain(fe, sid, 3)
            assert len(got) == 3
            assert all(np.array_equal(d.frame, 255 - fr) for d in got)
            # Unknown bucket label: the bucket retired between decide
            # and apply — refused, not crashed.
            assert not fe.request_batch_size("no|such|bucket", 2)


# ------------------------------------------------- priority tiers


class TestPriorityTiers:
    def test_admission_floor_refuses_high_tiers_only(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, slo_ms=60_000.0))
        with fe:
            fe.set_admission_tier_floor(TIER_STANDARD)
            sid = fe.open_stream(tier=TIER_INTERACTIVE)   # admitted
            sid2 = fe.open_stream(tier=TIER_STANDARD)     # admitted
            with pytest.raises(AdmissionError, match="not admitted"):
                fe.open_stream(tier=TIER_BATCH)
            before = fe.stats()["admission_rejections"]
            assert before >= 1
            fe.set_admission_tier_floor(None)
            sid3 = fe.open_stream(tier=TIER_BATCH)        # floor released
            assert {sid, sid2, sid3} <= set(fe.stats()["sessions"])

    def test_batcher_prefers_lower_tier_when_oversubscribed(self):
        """Tier-then-EDF: with more queued frames than slots, the
        interactive session's frames win the batch; batch-tier frames
        age (and shed first). Pinned at the batcher unit level."""
        from dvf_tpu_torch.serve.batcher import ContinuousBatcher
        from dvf_tpu_torch.serve.session import SessionConfig, StreamSession

        batcher = ContinuousBatcher(batch_size=2)
        now = time.time()
        lo = StreamSession("lo", SessionConfig(slo_ms=1000.0,
                                               tier=TIER_BATCH))
        hi = StreamSession("hi", SessionConfig(slo_ms=1000.0,
                                               tier=TIER_INTERACTIVE))
        frame = np.zeros((H, W, 3), dtype=np.uint8)
        # The batch-tier frames are OLDER (earlier deadlines): pure EDF
        # would pick them; the tier sort must override it.
        lo.submit(frame, ts=now - 0.5)
        lo.submit(frame, ts=now - 0.5)
        hi.submit(frame, ts=now)
        hi.submit(frame, ts=now)
        chosen = batcher.select([lo, hi], now)
        assert [s.session.id for s in chosen] == ["hi", "hi"]
        # With spare slots every tier rides along (the first pick
        # claimed hi's two frames; re-queue two more).
        hi.submit(frame, ts=now)
        hi.submit(frame, ts=now)
        chosen2 = batcher.select([lo, hi], now, limit=4)
        assert sorted(s.session.id for s in chosen2) == \
            ["hi", "hi", "lo", "lo"]  # lo's 2 queued frames still there

    def test_open_stream_rejects_negative_tier(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2))
        with pytest.raises(ValueError):
            fe.open_stream(tier=-1)
        fe.pool.close()
        fe.engine.free()


# ------------------------------------------------- bf16 signature mix


class TestBf16SignatureMix:
    def test_bf16_aliases_canonical(self):
        from dvf_tpu_torch.runtime.signature import canonical_dtype, make_key

        ml_dtypes = pytest.importorskip("ml_dtypes")
        assert canonical_dtype("bf16") == np.dtype(ml_dtypes.bfloat16)
        assert make_key("invert", (4, 4, 3), "bf16") == \
            make_key("invert", (4, 4, 3), "bfloat16")
        assert make_key("invert", (4, 4, 3), "bf16") != \
            make_key("invert", (4, 4, 3), "f16")

    def test_mixed_uint8_bf16_buckets_bit_identical_to_dedicated(self):
        """One frontend serving a uint8
        session and a bf16 session concurrently — distinct buckets, and
        each session's deliveries bit-identical to a dedicated
        single-signature frontend fed the same frames."""
        ml_dtypes = pytest.importorskip("ml_dtypes")
        n = 6
        rng = np.random.default_rng(11)
        frames_u8 = [rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
                     for _ in range(n)]
        frames_bf = [rng.random((H, W, 3), dtype=np.float32)
                     .astype(ml_dtypes.bfloat16) for _ in range(n)]

        def run_one(declares):
            fe = ServeFrontend(get_filter("invert"),
                               ServeConfig(batch_size=2, queue_size=500,
                                           out_queue_size=500,
                                           slo_ms=60_000.0,
                                           max_buckets=4))
            out = {}
            with fe:
                sids = {name: fe.open_stream(op_chain="invert",
                                             frame_shape=(H, W, 3),
                                             frame_dtype=dt)
                        for name, dt in declares}
                for name, _ in declares:
                    for f in (frames_u8 if name == "u8" else frames_bf):
                        fe.submit(sids[name], f)
                for name, _ in declares:
                    out[name] = [d.frame
                                 for d in drain(fe, sids[name], n)]
                buckets = list(fe.stats()["buckets"])
            return out, buckets

        golden_u8, _ = run_one([("u8", "u8")])
        golden_bf, _ = run_one([("bf", "bf16")])
        mixed, buckets = run_one([("u8", "u8"), ("bf", "bf16")])
        assert len(buckets) == 2   # dtype alone forks the bucket
        assert any("bfloat16" in b for b in buckets)
        assert len(mixed["u8"]) == n and len(mixed["bf"]) == n
        for a, b in zip(mixed["u8"], golden_u8["u8"]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(mixed["bf"], golden_bf["bf"]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------- flight recorder byte cap


class TestFlightRecorderByteCap:
    def _recorder(self, tmp_path, cap):
        from dvf_tpu_torch.obs.export import FlightRecorder

        blob = {"pad": "x" * 4096}   # ~4 KB stats.json per dump
        return FlightRecorder(str(tmp_path), min_interval_s=0.0,
                              max_dumps=32, stats_fn=lambda: blob,
                              max_total_bytes=cap)

    def test_oldest_dumps_evicted_past_byte_cap(self, tmp_path):
        """The dump dir is bounded by BYTES, not just count
        — past ``max_total_bytes`` the oldest dumps are deleted from
        disk; the newest always survives."""
        rec = self._recorder(tmp_path, cap=10_000)   # fits ~2 dumps
        dirs = [rec.trigger(f"trip {i}") for i in range(4)]
        assert all(dirs)
        st = rec.stats()
        assert st["evicted_dumps"] >= 2
        assert st["total_bytes"] <= 10_000
        assert len(rec.dumps) + st["evicted_dumps"] == 4
        import os
        survivors = {os.path.basename(d) for d in rec.dumps}
        on_disk = {p.name for p in tmp_path.iterdir()}
        assert on_disk == survivors           # evicted dirs really gone
        assert os.path.basename(dirs[-1]) in survivors  # newest lives
        assert not walk_export(st)

    def test_cap_smaller_than_one_dump_keeps_latest_only(self, tmp_path):
        rec = self._recorder(tmp_path, cap=1)
        a = rec.trigger("first")
        b = rec.trigger("second")
        assert a and b
        assert rec.dumps == [b]
        assert rec.stats()["evicted_dumps"] == 1

    def test_no_cap_means_count_bound_only(self, tmp_path):
        rec = self._recorder(tmp_path, cap=None)
        for i in range(3):
            rec.trigger(f"t{i}")
        assert rec.stats()["evicted_dumps"] == 0
        assert len(rec.dumps) == 3


# ------------------------------------------------- parity with dvf_tpu


def _replay(plane_cls, cfg, rows):
    """Every action (kind, target, value, reason) and the decision log
    of one plane over ``rows``."""
    plane = plane_cls(_FakeActuator(), cfg)
    seq = []
    for row in rows:
        for a in plane.decide(dict(row)):
            seq.append((a.kind, a.target, a.value, a.reason))
    return seq, list(plane.decisions)


_CFG_KW = dict(down_after=2, up_after=2, overload_after=3, min_dwell=4,
               resize_hold=2, resize_cooldown=3, saturate_after=4,
               batch_max=16)


class TestParityWithReference:
    """The controllers are copies of the reference's: the same seeded
    window through both packages' planes gives identical actions (exact
    equality, reasons included)."""

    @pytest.mark.parametrize("seed,n", [(7, 48), (11, 96), (23, 64)])
    @pytest.mark.parametrize("variant", [
        {}, {"down_after": 1, "up_after": 1, "min_dwell": 0},
        {"overload_after": 2, "up_after": 6, "max_level": 2},
    ])
    def test_seeded_window_same_actions_as_reference(self, seed, n,
                                                     variant):
        kw = dict(_CFG_KW, **variant)
        rows = _window(seed=seed, n=n)
        port = _replay(ControlPlane, ControlConfig(**kw), rows)
        ref = _replay(JaxControlPlane, JaxControlConfig(**kw), rows)
        assert port == ref
        assert len(port[0]) > 3

    def test_envelope_then_window_same_actions_as_reference(self):
        env = {"batch_ladder": (1, 2, 4), "batch_max": 4,
               "tick_busy_s": 0.002}
        out = []
        for cls, ccls in ((ControlPlane, ControlConfig),
                          (JaxControlPlane, JaxControlConfig)):
            plane = cls(_FakeActuator(), ccls(**_CFG_KW))
            plane.apply_envelope(env, reason="plan")
            seq = [(a.kind, a.target, a.value, a.reason)
                   for row in _window(seed=5)
                   for a in plane.decide(dict(row))]
            out.append((seq, list(plane.decisions), plane.config))
        assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
        assert out[0][2].batch_ladder == out[1][2].batch_ladder == (1, 2, 4)

    @pytest.mark.parametrize("chain,atol", [("invert", 0),
                                            ("gaussian_blur(ksize=5)", 1)])
    def test_downshift_frames_equal_reference(self, chain, atol):
        """The same frames through a downshift and a recovery on both
        frontends: the port's deliveries equal the reference's (invert
        bit-exact; the float blur within 1 LSB, the cross-package bar
        of the port's serving tests)."""
        rng = np.random.default_rng(5)
        fs = [rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
              for _ in range(3)]

        def run(frontend, config, filt):
            fe = frontend(filt, config(
                batch_size=2, queue_size=200, out_queue_size=500,
                slo_ms=60_000.0, control=True,
                control_config=(JaxControlConfig if frontend is
                                JaxServeFrontend else ControlConfig)(
                    interval_s=30.0),
                telemetry_sample_s=30.0))
            out = []
            with fe:
                sid = fe.open_stream(op_chain=chain, frame_shape=(H, W, 3))
                for level, f in zip((0, 1, 0), fs):
                    if level != fe._session(sid).quality_level:
                        assert fe.request_session_quality(sid, level)
                        assert wait_for(lambda: fe._session(sid)
                                        .quality_level == level)
                    fe.submit(sid, f)
                    got = drain(fe, sid, 1)
                    assert len(got) == 1
                    out.append(got[0].frame)
                labels = sorted(fe.stats()["buckets"])
            return out, labels

        port, port_labels = run(ServeFrontend, ServeConfig,
                                get_filter("invert"))
        ref, ref_labels = run(JaxServeFrontend, JaxServeConfig,
                              dvf_tpu.get_filter("invert"))
        assert port_labels == ref_labels
        for a, b in zip(port, ref):
            assert a.shape == b.shape == (H, W, 3)
            d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max()
            assert d <= atol
