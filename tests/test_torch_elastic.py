"""The port's elastic fleet (``dvf_tpu_torch.fleet.elastic``) on the CPU:
counterparts of ``tests/test_elastic.py``'s ``TestStandbyPool``,
``TestElasticFleetLocal`` and ``TestScaleInChaos``. The controller's
own cases are in ``tests/test_torch_planner.py``, the multi-host flavor's
(``TestMultiHostFlavor``) in ``tests/test_torch_fleet_multiproc.py``; the
elastic bench is not ported yet (ROADMAP Queue 1 item 4).

The warm standby pool makes ``spawn_replica`` an adoption instead of a
cold spawn, refusal pressure grows the fleet and sustained calm shrinks
it back with sessions migrated off the retiring replica, a rolling
rollout replaces every replica with no frame lost, and a SIGKILL during
a scale-in drain degrades to at-most-once salvage while the surviving
replica's sessions stay bit-identical.
"""

import threading
import time

import numpy as np
import pytest

from dvf_tpu_torch.control import ElasticConfig
from dvf_tpu_torch.fleet import FleetConfig, StandbyPool
from dvf_tpu_torch.fleet.elastic import live_standby_handles
from dvf_tpu_torch.fleet.replica import HEALTHY, ReplicaHandle
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.serve import AdmissionError, ServeConfig
from torch_serve_util import (  # noqa: F401
    FleetFrontend,
    port_fleet_guard,
    port_leak_guard,
)

pytestmark = pytest.mark.elastic

H, W = 16, 24


def tagged_frame(session_no: int, frame_no: int) -> np.ndarray:
    f = np.full((H, W, 3), 7, np.uint8)
    f[0] = session_no
    f[1] = frame_no % 251
    return f


def serve_cfg(**kw) -> ServeConfig:
    base = dict(batch_size=4, queue_size=1000, out_queue_size=1000,
                slo_ms=60_000.0)
    base.update(kw)
    return ServeConfig(**base)


def wait_for(pred, deadline_s=30.0, period=0.02):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(period)
    return pred()


def _ecfg(**kw) -> ElasticConfig:
    base = dict(min_replicas=1, max_replicas=3, out_after=2,
                out_cooldown=4, in_after=5, in_cooldown=2,
                in_occupancy_frac=0.6, saturate_after=4, interval_s=0.1)
    base.update(kw)
    return ElasticConfig(**base)


class _FakeReplica(ReplicaHandle):
    """Start/stop-tracked stand-in (the pool's contract is lifecycle
    only — transports are tested through the fleet below)."""

    START_DELAY_S = 0.0
    FAILURES = []  # mutable: pop-to-fail injection

    def __init__(self, rid):
        super().__init__(rid)
        self.stopped = False

    def start(self):
        if _FakeReplica.FAILURES:
            raise _FakeReplica.FAILURES.pop()
        time.sleep(_FakeReplica.START_DELAY_S)
        self.state = HEALTHY
        self.started_at = time.monotonic()
        return self

    def stop(self, timeout=10.0):
        self.stopped = True
        self.state = "dead"


class TestStandbyPool:
    def _pool(self, target=2):
        ids = iter(range(100))
        return StandbyPool(lambda: _FakeReplica(f"sb{next(ids)}"),
                           warm_target=target)

    def test_warms_takes_refills_and_stops(self):
        _FakeReplica.FAILURES = []
        pool = self._pool(2).start()
        taken = None
        try:
            assert wait_for(lambda: pool.warm_count == 2)
            assert live_standby_handles()  # guard registry sees them
            taken = pool.take()
            assert taken is not None and taken.state == HEALTHY
            # Refill replaces the taken standby.
            assert wait_for(lambda: pool.warm_count == 2)
            st = pool.stats()
            assert st["taken_total"] == 1 and st["spawned_total"] >= 3
            warm = pool.peek()
        finally:
            pool.stop()
        assert all(r.stopped for r in warm)
        assert pool.warm_count == 0
        assert not any(p.id.startswith("sb")
                       for p in live_standby_handles())
        assert not taken.stopped  # the adopted one belongs to its taker
        taken.stop()

    def test_failed_spawns_counted_and_recovered(self):
        _FakeReplica.FAILURES = [RuntimeError("boom")]
        pool = self._pool(1).start()
        try:
            assert wait_for(lambda: pool.warm_count == 1, deadline_s=10)
            assert pool.spawn_errors_total == 1
        finally:
            pool.stop()

    def test_dry_pool_returns_none(self):
        _FakeReplica.FAILURES = []
        pool = self._pool(1)  # never started: permanently dry
        assert pool.take() is None
        pool.stop()



class TestElasticFleetLocal:
    def _fleet(self, **kw):
        base = dict(
            replicas=1, mode="local",
            serve=serve_cfg(max_sessions=4),
            autoscale=(1, 3), standby_warm=1,
            elastic=_ecfg(), health_poll_s=0.05)
        base.update(kw)
        return FleetFrontend(get_filter("invert"), FleetConfig(**base))

    def test_autoscale_out_and_back_in(self):
        """The whole loop on one box: refusal pressure grows the fleet
        (warm adoption), new sessions land on the spawned replica and
        serve bit-exact, sustained calm shrinks it back with the
        retiring replica's sessions migrated — zero order violations
        end to end, and every stage observable in signals()/stats()."""
        fleet = self._fleet()
        deliveries: dict = {}
        with fleet:
            persistent = [fleet.open_stream() for _ in range(2)]
            # Saturate r0's admission gate and keep knocking: refusals
            # are the controller's leading signal.
            extras = [fleet.open_stream() for _ in range(2)]
            refused = 0

            def knock():
                nonlocal refused
                try:
                    extras.append(fleet.open_stream())
                except AdmissionError:
                    refused += 1
                return fleet.signals()["replicas_live"] >= 2

            assert wait_for(knock, deadline_s=60.0, period=0.05), \
                fleet.stats()
            assert refused >= 1
            sig = fleet.signals()
            assert sig["scale_out_total"] >= 1
            assert sig["admission_refusals_total"] >= 1
            # Satellite: refusal counters (incl. per-tier) ride the
            # telemetry ring, not just rejection strings.
            assert wait_for(lambda: (fleet.telemetry.latest() or {})
                            .get("replicas_live", 0) >= 2)
            row = fleet.telemetry.latest()
            assert row["admission_refusals_total"] >= 1
            assert row["admission_refusals_standard_total"] >= 1
            assert "replicas_desired" in row and "standby_warm" in row
            # New opens land on the spawned replica and serve.
            moved = fleet.open_stream()
            extras.append(moved)
            st = fleet.stats()
            assert st["sessions"][moved]["replica"] != "r0"
            for j in range(4):
                fleet.submit(moved, tagged_frame(9, j))
            deliveries.setdefault(moved, [])
            deadline = time.time() + 30
            while len(deliveries.get(moved, [])) < 4 \
                    and time.time() < deadline:
                deliveries.setdefault(moved, []).extend(fleet.poll(moved))
                time.sleep(0.01)
            got = deliveries[moved]
            assert [d.index for d in got] == list(range(4))
            for d in got:
                np.testing.assert_array_equal(
                    d.frame, 255 - tagged_frame(9, d.index))
            # Calm: close everything but the persistent pair → the
            # fleet shrinks back to min and their service continues.
            for sid in extras:
                fleet.close(sid, drain=True)
            # live dips the moment the victim flips DRAINING, before
            # the retire finishes its bookkeeping — converge on both.
            assert wait_for(
                lambda: (fleet.signals()["replicas_live"] == 1
                         and fleet.signals()["scale_in_total"] >= 1),
                deadline_s=60.0), fleet.stats()
            for j in range(3):
                for k, sid in enumerate(persistent):
                    fleet.submit(sid, tagged_frame(k, j))
            for sid in persistent:
                deadline = time.time() + 30
                while len(deliveries.get(sid, [])) < 3 \
                        and time.time() < deadline:
                    deliveries.setdefault(sid, []).extend(fleet.poll(sid))
                    time.sleep(0.01)
            st = fleet.stats()
        for k, sid in enumerate(persistent):
            got = deliveries[sid]
            idxs = [d.index for d in got]
            assert idxs == sorted(set(idxs)), (sid, idxs)
            assert len(got) >= 3
            for d in got:
                np.testing.assert_array_equal(
                    d.frame, 255 - tagged_frame(k, d.index))
        assert st["order_violations"] == 0
        assert st["replicas_live"] == 1
        assert st["scale_outs"] >= 1 and st["scale_ins"] >= 1
        assert st["standby"]["taken_total"] >= 1
        assert st["elastic"]["decisions"], "decision log empty"
        assert st["rejections_by_tier"].get(1, 0) >= 1

    def test_metrics_endpoint_gauges(self):
        """Satellite: /metrics walks the elastic gauges + counters."""
        fleet = self._fleet(standby_warm=0, autoscale=None)
        with fleet:
            text = fleet.registry.to_prometheus()
        for name in ("dvf_fleet_replicas_live",
                     "dvf_fleet_replicas_desired",
                     "dvf_fleet_standby_warm",
                     "dvf_fleet_scale_out_total",
                     "dvf_fleet_scale_in_total"):
            assert f"{name} " in text, f"{name} missing from scrape"

    def test_manual_spawn_and_retire_seams(self):
        """The actuator seams work without the controller (operator /
        bench use): spawn_replica adds a serving replica, retire_replica
        gracefully migrates its sessions and forgets it — the retired
        session's tail stays pollable and service continues."""
        fleet = self._fleet(standby_warm=0, autoscale=None)
        with fleet:
            fleet.open_stream()  # load r0 so the next open prefers rid
            rid = fleet.spawn_replica()
            assert fleet.signals()["replicas_live"] == 2
            # Land a session on the new replica (it is least-loaded).
            sid = fleet.open_stream()
            assert fleet.stats()["sessions"][sid]["replica"] == rid
            for j in range(6):
                fleet.submit(sid, tagged_frame(3, j))
            got = []
            deadline = time.time() + 30
            while len(got) < 6 and time.time() < deadline:
                got.extend(fleet.poll(sid))
                time.sleep(0.01)
            assert fleet.retire_replica(rid) is True
            assert rid not in fleet.stats()["replicas"]
            # The session survived the retire on a new replica; more
            # frames flow with indices continuing monotonically.
            for j in range(6, 9):
                fleet.submit(sid, tagged_frame(3, j))
            deadline = time.time() + 30
            while len(got) < 9 and time.time() < deadline:
                got.extend(fleet.poll(sid))
                time.sleep(0.01)
            idxs = [d.index for d in got]
            assert idxs == sorted(set(idxs))
            assert idxs[:6] == list(range(6))  # pre-retire: zero loss
            assert idxs[-1] >= 6               # service resumed after
            for d in got:
                np.testing.assert_array_equal(
                    d.frame, 255 - tagged_frame(3, d.index))
            assert fleet.stats()["sessions"][sid]["migrations"] == 1
            # Unknown / already-gone replica: a clean False, no throw.
            assert fleet.retire_replica(rid) is False
            assert fleet.retire_replica("nope") is False
            assert fleet.stats()["order_violations"] == 0

    def test_rolling_rollout_zero_downtime(self):
        """rolling_rollout replaces every live replica spawn-
        before-retire while interactive traffic flows. Every replica id
        changes, sessions keep streaming across their migration with
        indices exactly 0..N-1 and content bit-exact (the interactive
        SLO: no loss, no reorder, no outage window), and the summary
        ``swap`` ledger event (cause=rollout) reports the fleet-level
        substitution."""
        fleet = self._fleet(replicas=2, autoscale=None, standby_warm=1,
                            serve=serve_cfg(max_sessions=4, ledger=True))
        n_frames = 24
        deliveries: dict = {}
        with fleet:
            sids = [fleet.open_stream() for _ in range(2)]
            before = set(fleet.stats()["replicas"])
            stop = threading.Event()
            errors: list = []

            def pump():
                try:
                    j = 0
                    while j < n_frames and not stop.is_set():
                        for k, sid in enumerate(sids):
                            fleet.submit(sid, tagged_frame(k, j))
                        j += 1
                        time.sleep(0.01)  # paced interactive cadence
                except Exception as e:  # noqa: BLE001 — fail the test
                    errors.append(e)

            t = threading.Thread(target=pump, daemon=True)
            t.start()
            try:
                report = fleet.rolling_rollout(reason="version bump")
            finally:
                t.join(timeout=60)
                stop.set()
            assert not errors, errors
            deadline = time.time() + 60
            while time.time() < deadline and not all(
                    len(deliveries.get(s, [])) >= n_frames for s in sids):
                for sid in sids:
                    deliveries.setdefault(sid, []).extend(fleet.poll(sid))
                time.sleep(0.005)
            st = fleet.stats()
            ledger_doc = fleet.ledger.document()

        # Every incumbent was replaced; the fleet still holds 2 live.
        assert report["aborted"] is None, report
        assert len(report["swapped"]) == len(before) == 2, report
        after = set(st["replicas"])
        assert after.isdisjoint(before), (before, after)
        assert len(after) == 2
        # Interactive SLO across the rollout: all frames delivered, in
        # order, bit-exact — the sessions only saw graceful migrations.
        for k, sid in enumerate(sids):
            got = deliveries[sid]
            assert [d.index for d in got] == list(range(n_frames)), (
                f"session {sid}: {[d.index for d in got]}")
            for d in got:
                np.testing.assert_array_equal(
                    d.frame, 255 - tagged_frame(k, d.index))
            assert st["sessions"][sid]["migrations"] >= 1
        assert st["order_violations"] == 0
        assert st["rollouts"] == 1
        assert st["rollout_swaps"] == 2
        # Ledger: the rollout summary rides the swap kind, and the per-
        # replica spawn/retire events carry cause=rollout.
        events = ledger_doc["events"]
        swaps = [e for e in events if e["kind"] == "swap"
                 and e.get("cause") == "rollout"]
        assert len(swaps) == 1 and swaps[0]["swapped"] == 2, events
        assert not swaps[0].get("aborted")
        spawn_causes = [e.get("cause") for e in events
                        if e["kind"] == "replica_spawn"]
        retire_causes = [e.get("cause") for e in events
                         if e["kind"] == "replica_retire"]
        assert spawn_causes.count("rollout") == 2, events
        assert retire_causes.count("rollout") == 2, events



class TestScaleInChaos:
    def test_sigkill_during_scale_in_survivors_bit_identical(self):
        """The draining replica is SIGKILLed mid-retire: the retire
        degrades to at-most-once salvage for ITS sessions (monotone,
        no duplicates), while sessions on the surviving replica deliver
        every frame bit-identical to the fault-free expectation — a
        scale-in can never hurt tenants it isn't migrating."""
        cfg = FleetConfig(
            replicas=2, mode="process", filter_spec=("invert", {}),
            serve=serve_cfg(), health_poll_s=0.1, max_restarts=1,
            startup_timeout_s=180.0, drain_timeout_s=20.0)
        fleet = FleetFrontend(config=cfg)
        deliveries = {"A": [], "B": []}
        with fleet:
            a = fleet.open_stream("A")
            b = fleet.open_stream("B")
            rb = fleet.stats()["sessions"]["B"]["replica"]
            assert fleet.stats()["sessions"]["A"]["replica"] != rb
            for j in range(10):
                fleet.submit(a, tagged_frame(0, j))
                fleet.submit(b, tagged_frame(1, j))
            # Let some frames land, then retire B's replica while
            # killing it mid-drain: submit a burst right before so the
            # drain-to-quiet loop is genuinely mid-flight when the
            # SIGKILL lands.
            deadline = time.time() + 60
            while len(deliveries["B"]) < 10 and time.time() < deadline:
                for sid in ("A", "B"):
                    deliveries[sid].extend(fleet.poll(sid))
                time.sleep(0.01)
            for j in range(10, 30):
                fleet.submit(b, tagged_frame(1, j))
            victim = fleet._replicas[rb]
            done = threading.Event()
            result = {}

            def retire():
                result["ok"] = fleet.retire_replica(rb)
                done.set()

            t = threading.Thread(target=retire, daemon=True)
            t.start()
            time.sleep(0.15)   # into the drain window
            victim.kill()      # real SIGKILL on the process group
            assert done.wait(60.0), "retire wedged after SIGKILL"
            # The survivor serves on, untouched: every frame delivers
            # bit-identical to the fault-free expectation.
            for j in range(10, 20):
                fleet.submit(a, tagged_frame(0, j))
            deadline = time.time() + 60
            while len(deliveries["A"]) < 20 and time.time() < deadline:
                for sid in ("A", "B"):
                    deliveries[sid].extend(fleet.poll(sid))
                time.sleep(0.01)
            # B's binding settled (migrated or orphaned — the kill
            # races the rebind); either way its record is consistent
            # and the fleet still admits new work.
            c = fleet.open_stream("C")
            fleet.submit(c, tagged_frame(2, 0))
            got_c = []
            deadline = time.time() + 60
            while not got_c and time.time() < deadline:
                got_c = fleet.poll(c)
                time.sleep(0.02)
            st = fleet.stats()

        assert result["ok"] is True
        assert [d.index for d in deliveries["A"]] == list(range(20))
        for d in deliveries["A"]:
            np.testing.assert_array_equal(
                d.frame, 255 - tagged_frame(0, d.index))
        bi = [d.index for d in deliveries["B"]]
        assert bi == sorted(set(bi)), f"B not monotone: {bi}"
        assert bi[:10] == list(range(10))  # pre-retire frames intact
        for d in deliveries["B"]:
            np.testing.assert_array_equal(
                d.frame, 255 - tagged_frame(1, d.index))
        assert got_c and got_c[0].index == 0
        assert st["order_violations"] == 0
        assert rb not in st["replicas"]  # the retire completed its
        #   bookkeeping even though the victim died under it


class TestGracefulDrain:
    def test_retire_waits_for_a_slow_batch(self):
        """A retiring replica whose batch outlasts the reference's
        drain-to-quiet window (five empty polls, ~100 ms) still hands
        every queued frame over: the graceful salvage ends when the
        replica-side session has finalized, so indices stay exactly
        0..N-1 across the migration (the race behind the reference's
        unsteady rolling-rollout test)."""
        from dvf_tpu_torch.api.filter import stateless

        slow = threading.Event()

        def fn(x):
            if slow.is_set():
                time.sleep(0.4)   # a batch slower than the quiet window
            return 255 - x

        filt = stateless("invert", fn, uint8_ok=True, halo=0)
        fleet = FleetFrontend(filt, FleetConfig(
            replicas=2, mode="local", serve=serve_cfg(),
            health_poll_s=0.05))
        got = []
        with fleet:
            sid = fleet.open_stream()
            rid = fleet._sessions[sid].replica_id
            slow.set()
            for j in range(8):
                fleet.submit(sid, tagged_frame(4, j))
            try:
                assert fleet.retire_replica(rid) is True
            finally:
                slow.clear()
            for j in range(8, 12):
                fleet.submit(sid, tagged_frame(4, j))
            deadline = time.time() + 30
            while len(got) < 12 and time.time() < deadline:
                got.extend(fleet.poll(sid))
                time.sleep(0.01)
            st = fleet.stats()
        assert [d.index for d in got] == list(range(12))
        for d in got:
            np.testing.assert_array_equal(
                d.frame, 255 - tagged_frame(4, d.index))
        assert st["sessions"][sid]["migrations"] == 1
        assert st["order_violations"] == 0
