"""The port's fleet tier (``dvf_tpu_torch.fleet``) on the CPU:
counterparts of ``tests/test_fleet.py``'s ``TestLocalFleet`` and its
process-replica kill test, parity with the JAX package's fleet (both in
local mode on the CPU, the same ``FleetConfig``), and the port's
deliberate differences: the device (``cuda:0`` unless the caller names
the CPU, carried to process replicas by the wire config's ``device``
key), and ``devices_per_replica > 1`` / the multi-host flavor, which
raise ``NotImplementedError``.

``test_two_replica_scaling`` runs the port's bench harness
(``dvf_tpu_torch.benchmarks.bench_fleet_scaling``), capacity-gated as the
reference's is.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch

from dvf_tpu_torch.fleet import (
    HEALTHY,
    FleetConfig,
    ProcessReplica,
    ReplicaLostError,
)
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.serve import AdmissionError, ServeConfig
from torch_serve_util import (  # noqa: F401
    FleetFrontend,
    port_fleet_guard,
    port_leak_guard,
)

pytestmark = pytest.mark.fleet

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


def drain_fleet(fleet, sids, deliveries, want, deadline_s=60.0,
                grace_s=3.0):
    """Poll every session until each has ``want`` deliveries (or no
    movement for ``grace_s``)."""
    deadline = time.time() + deadline_s
    last_move = time.time()
    while time.time() < deadline and time.time() - last_move < grace_s:
        moved = 0
        for sid in sids:
            got = fleet.poll(sid)
            deliveries.setdefault(sid, []).extend(got)
            moved += len(got)
        if moved:
            last_move = time.time()
        if all(len(deliveries.get(sid, [])) >= want for sid in sids):
            return
        time.sleep(0.005)


class TestLocalFleet:
    def test_affinity_ordered_no_leakage(self):
        """4 sessions over 2 replicas: sessions spread, every delivery
        comes from the session's own replica, indices exactly 0..N-1 in
        order, content bit-exact."""
        n_sessions, n_frames = 4, 16
        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=2, mode="local", serve=serve_cfg()))
        deliveries: dict = {}
        with fleet:
            sids = [fleet.open_stream() for _ in range(n_sessions)]
            by_replica: dict = {}
            st = fleet.stats()
            for sid in sids:
                by_replica.setdefault(
                    st["sessions"][sid]["replica"], []).append(sid)
            assert sorted(len(v) for v in by_replica.values()) == [2, 2]
            for j in range(n_frames):
                for k, sid in enumerate(sids):
                    fleet.submit(sid, tagged_frame(k, j))
            drain_fleet(fleet, sids, deliveries, n_frames)
            st = fleet.stats()

        for k, sid in enumerate(sids):
            got = deliveries[sid]
            assert [d.index for d in got] == list(range(n_frames)), (
                f"session {sid}: {[d.index for d in got]}")
            for d in got:
                np.testing.assert_array_equal(
                    d.frame, 255 - tagged_frame(k, d.index),
                    err_msg=f"session {sid} frame {d.index}: wrong "
                            f"content (cross-replica leakage?)")
        for rid, row in st["replicas"].items():
            expected = len(by_replica.get(rid, [])) * n_frames
            assert row["engine_frames"] >= expected
        assert st["order_violations"] == 0
        assert st["replica_losses"] == 0
        assert st["faults"]["by_kind"] == {}

    def test_spillover_and_full_fleet_rejection(self):
        """A replica-side admission refusal spills the open to the next
        replica; when every replica refuses, the fleet rejects."""
        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=2, mode="local",
                        serve=serve_cfg(max_sessions=1)))
        with fleet:
            a = fleet.open_stream()
            b = fleet.open_stream()
            st = fleet.stats()
            assert (st["sessions"][a]["replica"]
                    != st["sessions"][b]["replica"])
            with pytest.raises(AdmissionError):
                fleet.open_stream()
            assert fleet.stats()["rejections"] == 1
            ra = fleet._sessions[a].replica_id
            rb = fleet._sessions[b].replica_id
            fleet.close(b, drain=True)
            deadline = time.time() + 20
            while (fleet._replicas[rb].frontend.open_count() > 0
                   and time.time() < deadline):
                time.sleep(0.01)
            with fleet._lock:
                fleet._load[ra] = 0
            c = fleet.open_stream()
            st = fleet.stats()
            assert st["sessions"][c]["replica"] == rb
            assert st["spillovers"] == 1

    def test_declared_signature_passthrough(self):
        """Signature-aware admission: a follow-up open of the same
        declared signature goes to the replica that compiled it, a new
        signature cold-admits on the other, and a third (both buckets
        busy) is refused fleet-wide with the warm signatures listed."""
        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=2, mode="local",
                        serve=serve_cfg(max_buckets=1)))
        with fleet:
            a = fleet.open_stream(frame_shape=(H, W, 3))
            fleet.submit(a, tagged_frame(0, 0))
            b = fleet.open_stream(frame_shape=(H, W, 3))
            st = fleet.stats()
            assert (st["sessions"][a]["replica"]
                    == st["sessions"][b]["replica"])
            assert st["warm_placements"] >= 1
            c = fleet.open_stream(frame_shape=(H + 2, W, 3))
            st = fleet.stats()
            assert (st["sessions"][c]["replica"]
                    != st["sessions"][a]["replica"])
            with pytest.raises(AdmissionError,
                               match=r"warm signatures.*invert\|16x24x3"):
                fleet.open_stream(frame_shape=(H + 4, W, 3))

    def test_fleet_precompile_warms_every_replica(self):
        """FleetConfig.precompile: each replica compiles the manifest at
        start, so the first admission of the signature is a pool hit."""
        manifest = [{"op_chain": "grayscale",
                     "frame_shape": [H, W, 3], "dtype": "u8"}]
        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=2, mode="local", serve=serve_cfg(),
                        precompile=manifest))
        with fleet:
            key = f"grayscale|{H}x{W}x3|uint8"
            for r in fleet._replicas.values():
                assert key in r.health()["warm_signatures"]
            sid = fleet.open_stream(op_chain="grayscale",
                                    frame_shape=(H, W, 3))
            rid = fleet._sessions[sid].replica_id
            st = fleet._replicas[rid].frontend.stats()
            assert st["pool"]["hits"] >= 1
            assert st["pool"]["misses"] == 1  # the precompile itself

    def test_chaos_replica_loss_migrate_restart(self):
        """Deterministic replica-loss injection (chaos site 'replica'):
        the victim's sessions migrate with indices monotone, the loss is
        replica-attributed, the replica restarts and rejoins, and new
        sessions are admitted after the loss."""
        from dvf_tpu_torch.resilience import FaultPlan

        chaos = FaultPlan(seed=3).add("replica", at=(20,), count=1)
        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=2, mode="local", serve=serve_cfg(),
                        health_poll_s=0.05, max_restarts=2, chaos=chaos))
        deliveries: dict = {}
        with fleet:
            sids = [fleet.open_stream() for _ in range(2)]
            for j in range(30):
                for k, sid in enumerate(sids):
                    fleet.submit(sid, tagged_frame(k, j))
                time.sleep(0.02)
            drain_fleet(fleet, sids, deliveries, 1)
            st = fleet.stats()
            extra = fleet.open_stream()
            fleet.submit(extra, tagged_frame(9, 0))
            drain_fleet(fleet, [extra], deliveries, 1, grace_s=15.0)

        assert st["replica_losses"] >= 1
        assert st["faults"]["by_kind"].get("replica", 0) >= 1
        assert "r0" in st["faults"]["by_replica"]
        assert st["replicas"]["r0"]["restarts"] >= 1
        assert st["replicas"]["r0"]["state"] == HEALTHY
        assert st["migrated_sessions"] >= 1
        assert st["order_violations"] == 0
        for k, sid in enumerate(sids):
            idxs = [d.index for d in deliveries[sid]]
            assert idxs == sorted(set(idxs)), f"{sid} indices {idxs}"
            for d in deliveries[sid]:
                np.testing.assert_array_equal(
                    d.frame, 255 - tagged_frame(k, d.index))
        assert len(deliveries[extra]) == 1


class TestProcessFleet:
    """Real worker subprocesses (one torch runtime each)."""

    def _run_scenario(self, kill_victim: bool):
        cfg = FleetConfig(
            replicas=2, mode="process", filter_spec=("invert", {}),
            serve=serve_cfg(), health_poll_s=0.1, max_restarts=1,
            startup_timeout_s=180.0)
        fleet = FleetFrontend(config=cfg)
        deliveries: dict = {"A": [], "B": []}
        with fleet:
            a = fleet.open_stream("A")
            b = fleet.open_stream("B")
            rb = fleet.stats()["sessions"]["B"]["replica"]
            assert fleet.stats()["sessions"]["A"]["replica"] != rb
            for j in range(10):
                fleet.submit(a, tagged_frame(0, j))
                fleet.submit(b, tagged_frame(1, j))
            drain_fleet(fleet, ["A", "B"], deliveries, 10, grace_s=20.0)
            if kill_victim:
                fleet._replicas[rb].kill()  # real SIGKILL
                for j in range(10, 20):
                    fleet.submit(a, tagged_frame(0, j))
                    fleet.submit(b, tagged_frame(1, j))
                    time.sleep(0.02)
                deadline = time.time() + 60
                while (fleet.stats()["migrated_sessions"] < 1
                       and time.time() < deadline):
                    time.sleep(0.05)
                start = 20
            else:
                start = 10
            for j in range(start, 40):
                fleet.submit(a, tagged_frame(0, j))
                fleet.submit(b, tagged_frame(1, j))
                time.sleep(0.02)
            drain_fleet(fleet, ["A", "B"], deliveries, 40, grace_s=20.0)
            c = fleet.open_stream("C")
            fleet.submit(c, tagged_frame(2, 0))
            deliveries["C"] = []
            drain_fleet(fleet, ["C"], deliveries, 1, grace_s=20.0)
            if kill_victim:
                deadline = time.time() + 60
                while (time.time() < deadline
                       and not any(row["restarts"] >= 1
                                   and row["state"] == HEALTHY
                                   for row in fleet.stats()
                                   ["replicas"].values())):
                    time.sleep(0.1)
            stats = fleet.stats()
        return deliveries, stats

    def test_two_replica_scaling(self):
        """≥1.8× aggregate 2-session throughput at 2 replicas vs one —
        the linear-scaling acceptance bar, gated exactly as the
        reference's test is: replicas are core-pinned, so the claim is
        only falsifiable on a host with ≥ 3 CPUs (2 pinned replicas + the
        front door) and a measured parallel capacity ≥ 1.8. The capacity is
        read before and after the measurement, on the two cores the
        replicas are pinned to (the probe's processes inherit this
        thread's affinity): other work on the host can take one of those
        cores while the 2-replica round runs, and then the bar is not
        falsifiable in that window either."""
        from dvf_tpu_torch.benchmarks import (
            bench_fleet_scaling,
            measure_parallel_capacity,
        )

        if (os.cpu_count() or 1) < 3:
            pytest.skip("needs >= 3 CPUs (2 pinned replicas + front door)")
        replica_cores = set(sorted(os.sched_getaffinity(0))[:2])

        def capacity() -> float:
            mine = os.sched_getaffinity(0)
            os.sched_setaffinity(0, replica_cores)
            try:
                return measure_parallel_capacity(2)
            finally:
                os.sched_setaffinity(0, mine)

        before = capacity()
        r = bench_fleet_scaling(sessions=2, frames_per_session=200,
                                device="cpu")
        after = capacity()
        assert r["rounds"]["2"]["delivered"] == r["rounds"]["2"]["expected"]
        if min(before, after) < 1.8:
            pytest.skip(f"host parallel capacity {before} before and {after} "
                        f"after the measurement, one < 1.8 (oversubscribed); "
                        f"scaling bar not falsifiable")
        assert r["scaling"]["2"] >= 1.8, r

    def test_kill_one_replica_survivor_bit_identical(self):
        """SIGKILL one replica mid-run: the surviving replica's session
        delivers a stream bit-identical to a fault-free run, the
        victim's session migrates (monotone, at-most-once), the loss is
        replica-attributed, the victim restarts, and the fleet keeps
        admitting."""
        clean, clean_stats = self._run_scenario(kill_victim=False)
        faulted, stats = self._run_scenario(kill_victim=True)

        assert [d.index for d in clean["A"]] == list(range(40))
        assert [d.index for d in clean["B"]] == list(range(40))
        assert clean_stats["faults"]["by_kind"] == {}
        assert clean_stats["replica_losses"] == 0

        assert [d.index for d in faulted["A"]] == list(range(40))
        for d_clean, d_fault in zip(clean["A"], faulted["A"]):
            np.testing.assert_array_equal(d_clean.frame, d_fault.frame)

        bi = [d.index for d in faulted["B"]]
        assert bi == sorted(set(bi))
        assert bi[:10] == list(range(10))
        assert bi[-1] >= 30
        for d in faulted["B"]:
            np.testing.assert_array_equal(
                d.frame, 255 - tagged_frame(1, d.index))

        assert len(faulted["C"]) == 1

        assert stats["replica_losses"] == 1
        assert stats["faults"]["by_kind"].get("replica", 0) >= 1
        assert stats["migrated_sessions"] == 1
        assert stats["order_violations"] == 0
        assert stats["sessions"]["B"]["migrations"] == 1
        restarted = [rid for rid, row in stats["replicas"].items()
                     if row["restarts"] >= 1]
        diag = (stats["replicas"], stats["faults"]["last"])
        assert len(restarted) == 1, diag
        assert stats["replicas"][restarted[0]]["state"] == HEALTHY, diag


# ---------------------------------------------------------------------------
# Parity with the JAX package's fleet (both local, on the CPU, 32 x 32)
# ---------------------------------------------------------------------------

PH, PW = 32, 32
# (op_chain, bar): invert bit-exact, the float stencils within 1 LSB.
PARITY_CHAINS = [("invert", 0), ("gaussian_blur(ksize=9)", 1),
                 ("sobel_bilateral", 1)]
PARITY_SESSIONS = 2   # per chain
PARITY_FRAMES = 6


def _parity_frames(seed: int = 17) -> dict:
    rng = np.random.default_rng(seed)
    return {(c, k): [rng.integers(0, 256, (PH, PW, 3), dtype=np.uint8)
                     for _ in range(PARITY_FRAMES)]
            for c in range(len(PARITY_CHAINS))
            for k in range(PARITY_SESSIONS)}


def _fleet_config(pkg: str, **kw):
    """The same FleetConfig in either package."""
    if pkg == "port":
        scfg, fcfg = ServeConfig, FleetConfig
    else:
        from dvf_tpu.fleet import FleetConfig as fcfg
        from dvf_tpu.serve import ServeConfig as scfg
    serve = scfg(batch_size=4, queue_size=200, out_queue_size=200,
                 slo_ms=60_000.0, max_buckets=3, pool_capacity=3,
                 **kw.pop("serve", {}))
    return fcfg(replicas=2, mode="local", serve=serve, **kw)


def _make_fleet(pkg: str, **kw):
    if pkg == "port":
        return FleetFrontend(get_filter("invert"), _fleet_config(pkg, **kw))
    import dvf_tpu
    from dvf_tpu.fleet import FleetFrontend as JaxFleet

    return JaxFleet(dvf_tpu.get_filter("invert"), _fleet_config(pkg, **kw))


def _drive_parity(fleet, frames: dict):
    """Open one declared session per (chain, session) in a fixed order,
    submit every frame, poll all out. Returns ({ck: [Delivery]},
    {ck: replica id}, stats)."""
    got, placed = {}, {}
    with fleet:
        sids = {}
        for ck in sorted(frames):
            sids[ck] = fleet.open_stream(
                session_id=f"s{ck[0]}{ck[1]}",
                op_chain=PARITY_CHAINS[ck[0]][0], frame_shape=(PH, PW, 3))
        for j in range(PARITY_FRAMES):
            for ck, sid in sids.items():
                fleet.submit(sid, frames[ck][j])
        deadline = time.time() + 90.0
        while (sum(len(v) for v in got.values())
               < PARITY_FRAMES * len(sids) and time.time() < deadline):
            for ck, sid in sids.items():
                got.setdefault(ck, []).extend(fleet.poll(sid))
            time.sleep(0.005)
        st = fleet.stats()
        placed = {ck: st["sessions"][sid]["replica"]
                  for ck, sid in sids.items()}
    return got, placed, st


def test_placements_and_frames_match_reference():
    """The same seeded frames through both fleets (2 local replicas, the
    same FleetConfig): the same session → replica placements, the same
    delivered indices, invert bit-exact and the stencils within 1 LSB of
    the reference's frame of the same (session, index)."""
    frames = _parity_frames()
    got, placed, st = _drive_parity(_make_fleet("port"), frames)
    ref, ref_placed, ref_st = _drive_parity(_make_fleet("jax"), frames)
    assert placed == ref_placed
    assert set(placed.values()) == {"r0", "r1"}
    assert st["order_violations"] == ref_st["order_violations"] == 0
    for ck in frames:
        bar = PARITY_CHAINS[ck[0]][1]
        assert [d.index for d in got[ck]] == list(range(PARITY_FRAMES)), ck
        assert [d.index for d in ref[ck]] == [d.index for d in got[ck]], ck
        for d, r in zip(got[ck], ref[ck]):
            assert d.frame.dtype == np.uint8 and d.frame.shape == (PH, PW, 3)
            diff = np.abs(d.frame.astype(np.int16) - r.frame.astype(np.int16))
            assert int(diff.max()) <= bar, (ck, d.index, int(diff.max()))
            if bar == 0:
                np.testing.assert_array_equal(
                    d.frame, 255 - frames[ck][d.index])


def _key_tree(doc, depth=0):
    """Key sets of a document, nested dicts included to depth 3, with
    the dynamic keys (session ids, replica ids, bucket labels) kept: both
    fleets name them the same way."""
    if not isinstance(doc, dict) or depth > 3:
        return None
    return {str(k): _key_tree(v, depth + 1) for k, v in doc.items()}


def _surfaces(fleet, path):
    frame = np.zeros((PH, PW, 3), np.uint8)
    with fleet:
        sid = fleet.open_stream(session_id="s0", frame_shape=(PH, PW, 3))
        fleet.submit(sid, frame)
        deadline = time.time() + 60.0
        while not fleet.poll(sid) and time.time() < deadline:
            time.sleep(0.005)
        fleet.snapshot_now()
        from dvf_tpu_torch.resilience.continuity import load_json

        return (fleet.stats(), fleet.signals(), fleet.elastic_view(),
                load_json(path))


# Keys whose rows differ by design: the replica's serve stats carry the
# port's own engine and device rows, checked by the serving parity tests.
_FLEET_SURFACE_SKIP = {"replicas"}


def test_surface_key_sets_match_reference(tmp_path):
    """stats(), signals(), elastic_view() and the snapshot document of
    a port fleet carry the reference's keys."""
    pp, jp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    st, si, ev, doc = _surfaces(
        _make_fleet("port", state_path=pp, snapshot_interval_s=60.0,
                    serve={"ledger": True}), pp)
    rst, rsi, rev, rdoc = _surfaces(
        _make_fleet("jax", state_path=jp, snapshot_interval_s=60.0,
                    serve={"ledger": True}), jp)
    assert set(si) == set(rsi)
    assert set(ev) == set(rev)
    assert set(st) == set(rst)
    assert ({k: v for k, v in _key_tree(st).items()
             if k not in _FLEET_SURFACE_SKIP}
            == {k: v for k, v in _key_tree(rst).items()
                if k not in _FLEET_SURFACE_SKIP})
    assert set(st["replicas"]) == set(rst["replicas"]) == {"r0", "r1"}
    for rid in st["replicas"]:
        assert set(st["replicas"][rid]) == set(rst["replicas"][rid])
    assert doc is not None and rdoc is not None
    assert _key_tree(doc, depth=1) == _key_tree(rdoc, depth=1)
    assert set(doc["sessions"]["s0"]) == set(rdoc["sessions"]["s0"])
    for rid in doc["replicas"]:
        assert set(doc["replicas"][rid]) == set(rdoc["replicas"][rid])


def test_fleet_samples_names_match_reference():
    """The fleet scrape names the reference's metrics, labels included."""
    from dvf_tpu.obs.export import fleet_samples as ref_samples

    from dvf_tpu_torch.obs.export import fleet_samples

    def names(fleet, fn):
        with fleet:
            sid = fleet.open_stream(frame_shape=(PH, PW, 3))
            fleet.submit(sid, np.zeros((PH, PW, 3), np.uint8))
            deadline = time.time() + 60.0
            while not fleet.poll(sid) and time.time() < deadline:
                time.sleep(0.005)
            return {(s.name, tuple(k for k, _ in s.labels))
                    for s in fn(fleet)}

    assert (names(_make_fleet("port"), fleet_samples)
            == names(_make_fleet("jax"), ref_samples))


class _Handle:
    def __init__(self, rid, state=HEALTHY, restarts=0):
        self.id, self.state, self.restarts = rid, state, restarts


def test_admission_and_stats_merges_match_reference():
    """SpilloverAdmission ranks, counts and the fleet/stats.py merges give
    the reference's results on the same inputs."""
    from dvf_tpu.fleet import admission as ref_adm
    from dvf_tpu.fleet import stats as ref_stats

    from dvf_tpu_torch.fleet import admission, stats

    rng = np.random.default_rng(5)
    for trial in range(40):
        n = int(rng.integers(1, 6))
        reps = [_Handle(f"r{i}", state=HEALTHY if rng.random() < 0.8
                        else "draining") for i in range(n)]
        load = {r.id: int(rng.integers(0, 4)) for r in reps}
        warm = {r.id: (["k"] if rng.random() < 0.5 else []) for r in reps}
        kw = dict(exclude={"r1"} if trial % 3 == 0 else None,
                  warm=warm, key="k" if trial % 2 else None,
                  prefer_packed=bool(trial % 4 == 1))
        a, b = admission.SpilloverAdmission(), ref_adm.SpilloverAdmission()
        assert ([r.id for r in a.candidates(reps, load, **kw)]
                == [r.id for r in b.candidates(reps, load, **kw)])
        for adm in (a, b):
            adm.record_spillover(2)
            adm.record_rejection(tier=trial % 3)
            adm.record_rejection()
            adm.record_tier_rejection()
            adm.record_warm_placement()
        assert a.stats() == b.stats()

    from dvf_tpu.resilience.faults import FaultStats as RefFaults

    from dvf_tpu_torch.resilience.faults import FaultStats

    def summaries(cls):
        own = cls()
        own.record("replica", "lost", replica="r1")
        per = {}
        for rid, kinds in (("r0", ("compute", "compute", "h2d")),
                           ("r1", ("stall",)), ("r2", ())):
            f = cls()
            for k in kinds:
                f.record(k, "x")
            per[rid] = f.summary()
        per["r3"] = None
        return own.summary(), per

    own, per = summaries(FaultStats)
    r_own, r_per = summaries(RefFaults)

    def strip(doc):   # wall-clock stamps differ between the two runs
        return {k: v for k, v in doc.items() if k not in ("last",)}

    assert (strip(stats.merge_fault_summaries(own, per))
            == strip(ref_stats.merge_fault_summaries(r_own, r_per)))

    def snapshot(seed, pid):
        r = np.random.default_rng(seed)
        lat = [float(x) for x in r.uniform(1, 50, 30)]
        return {"samples_ms": lat, "stride": float(1 + seed % 2),
                "t0": 0.0, "t1": 2.0 + seed, "count": 30 * (1 + seed % 2),
                "pid": pid}

    for pids in ((1, 1, 1), (1, 2, 3)):   # one time base, then three
        per_lat = {f"r{i}": snapshot(i, pid) for i, pid in enumerate(pids)}
        per_lat["r9"] = None
        assert (stats.merge_latency_snapshots(per_lat)
                == ref_stats.merge_latency_snapshots(per_lat))

    export = {"stats": {"engine_batches": 3, "engine_frames": 12,
                        "open_sessions": 2, "queue_depth": 1, "errors": 0,
                        "recoveries": 0, "faults": {"by_kind": {"h2d": 1}},
                        "aggregate": {"p50_ms": 1.0},
                        "attribution": {"dominant": "device"}},
              "signals": {"delivered_total": 12.0}}
    for e in (export, None):
        assert (stats.replica_row(_Handle("r0", restarts=1), e, 2)
                == ref_stats.replica_row(_Handle("r0", restarts=1), e, 2))


def test_send_msg_framing_matches_reference():
    """The RPC frame (a ``!I`` length prefix, then pickle at
    HIGHEST_PROTOCOL) is byte-equal to the reference's for the same
    tuple of plain values, and each side reads the other's."""
    from dvf_tpu.fleet import replica as ref_replica

    from dvf_tpu_torch.fleet import replica

    msg = ("submit1", "fs0", np.arange(12, dtype=np.uint8).reshape(2, 2, 3),
           1234.5, (7, None))
    plain = ("open", "fs1", 60_000.0, (16, 24, 3), "uint8", "invert", 1)

    def wire(send, obj):
        a, b = socket.socketpair()
        try:
            send(a, obj)
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                c = b.recv(65536)
                if not c:
                    return b"".join(chunks)
                chunks.append(c)
        finally:
            a.close()
            b.close()

    for obj in (plain, ("ok", {"a": [1, 2.5, None]}), ("stop",)):
        assert wire(replica.send_msg, obj) == wire(ref_replica.send_msg, obj)
    a, b = socket.socketpair()
    try:
        ref_replica.send_msg(a, msg)
        got = replica.recv_msg(b)
        replica.send_msg(a, plain)
        assert ref_replica.recv_msg(b) == plain
    finally:
        a.close()
        b.close()
    assert got[:2] == msg[:2] and got[3:] == msg[3:]
    np.testing.assert_array_equal(got[2], msg[2])
    assert replica._WIRE_ERRORS.keys() == ref_replica._WIRE_ERRORS.keys()


# ---------------------------------------------------------------------------
# The port's deliberate differences
# ---------------------------------------------------------------------------


def test_default_device_is_the_card_and_raises_without_cuda():
    """With no ``device`` the fleet runs on ``cuda:0`` and raises where
    there is no CUDA; it never picks the CPU itself."""
    from dvf_tpu_torch.fleet import FleetFrontend as PortFleet

    if torch.cuda.is_available():
        fleet = PortFleet(get_filter("invert"), FleetConfig(replicas=1))
        assert fleet.device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortFleet(get_filter("invert"), FleetConfig(replicas=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortFleet(config=FleetConfig(mode="process",
                                     filter_spec=("invert", {})))


def test_wire_config_carries_the_device():
    """A process replica's wire config names its device (the reference
    has no such key), and the child's environment is the caller's plus
    PYTHONPATH and replica_env: no device runtime is steered by it."""
    import dvf_tpu
    from dvf_tpu.fleet import FleetConfig as JaxConfig
    from dvf_tpu.fleet import FleetFrontend as JaxFleet

    cfg = dict(replicas=2, mode="process", filter_spec=("invert", {}),
               replica_env={"DVF_TEST_MARK": "1"})
    port = FleetFrontend(config=FleetConfig(**cfg))
    ref = JaxFleet(dvf_tpu.get_filter("invert"), JaxConfig(**cfg))
    h, rh = port._make_replica("r0", 0), ref._make_replica("r0", 0)
    assert h._wire_config["device"] == "cpu"
    assert "device" not in rh._wire_config
    assert ({k for k in h._wire_config if k != "device"}
            == set(rh._wire_config))
    env = h._child_env()
    assert env["DVF_TEST_MARK"] == "1"
    for k in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES",
              "CUDA_VISIBLE_DEVICES"):
        assert env.get(k) == os.environ.get(k), k
    assert env["PYTHONPATH"].split(os.pathsep)[0] == os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))


def test_replica_device_slice(monkeypatch):
    """Local replica i runs on ``cuda:{i % device_count}`` (one card:
    all on ``cuda:0``); a process replica with its card named in
    replica_env sees one device, ``cuda:0``; on the CPU every replica
    runs on the CPU."""
    fleet = FleetFrontend(get_filter("invert"),
                          FleetConfig(replicas=3, mode="local"))
    assert [str(fleet._replica_device(i)) for i in range(3)] == ["cpu"] * 3
    fleet.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(fleet._replica_device(i)) for i in range(3)] == [
        "cuda:0", "cuda:1", "cuda:0"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert {str(fleet._replica_device(i)) for i in range(3)} == {"cuda:0"}
    proc = FleetFrontend(config=FleetConfig(
        replicas=2, mode="process", filter_spec=("invert", {}),
        replica_env={"CUDA_VISIBLE_DEVICES": "1"}))
    proc.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert proc._make_replica("r1", 1)._wire_config["device"] == "cuda:0"


def test_local_replicas_partition_the_cards(monkeypatch):
    """Local replicas take slices of the local cards as the reference's
    do: ``per = devices_per_replica or max(1, cards // replicas)`` from a
    start index that wraps; a slice asking for more cards than there are
    raises instead of spanning fewer."""
    fleet = FleetFrontend(get_filter("invert"),
                          FleetConfig(replicas=2, mode="local"))
    fleet.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert [fleet._replica_devices(i) for i in range(2)] == [cuda[:2], cuda[2:]]
    fleet.config.devices_per_replica = 3
    assert fleet._replica_devices(1) == [cuda[3], cuda[0], cuda[1]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    fleet.config.devices_per_replica = 2
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        fleet._replica_devices(0)


@pytest.mark.parametrize("kw", [{"devices_per_replica": 2},
                                {"multihost_hosts": 2}],
                         ids=["devices_per_replica", "multihost"])
def test_multi_device_replicas_not_ported(kw):
    """``devices_per_replica=2`` builds each local replica's engines over
    a two-device mesh (on the CPU, the CPU twice: a virtual mesh) and
    serves bit-exactly; ``multihost_hosts=2`` arms the multi-host flavor,
    whose elastic view is available once a manifest names the signature
    the group compiles (and not before, as in the reference), and the
    fleet package exports its engine and replica (its spawn and serving:
    tests/test_torch_fleet_multiproc.py)."""
    if "multihost_hosts" in kw:
        import dvf_tpu_torch.fleet as fleet_pkg
        from dvf_tpu.fleet import FleetConfig as RefFleetConfig
        from dvf_tpu.fleet import FleetFrontend as RefFleetFrontend
        from dvf_tpu.ops import get_filter as ref_get_filter

        manifest = [{"op_chain": "invert", "frame_shape": [16, 24, 3],
                     "dtype": "u8"}]
        for precompile, want in ((None, False), (manifest, True)):
            fleet = FleetFrontend(get_filter("invert"),
                                  FleetConfig(replicas=1, precompile=precompile, **kw))
            ref = RefFleetFrontend(ref_get_filter("invert"),
                                   RefFleetConfig(replicas=1, precompile=precompile, **kw))
            assert fleet.elastic_view()["multihost_available"] is want
            assert ref.elastic_view()["multihost_available"] is want
        assert fleet._multihost_key.render() == ref._multihost_key.render()
        assert fleet_pkg.MultiHostEngine.__module__ == "dvf_tpu_torch.fleet.multiproc"
        assert fleet_pkg.MultiHostReplica.__module__ == "dvf_tpu_torch.fleet.multihost"
        return
    fleet = FleetFrontend(get_filter("invert"),
                          FleetConfig(replicas=2, mode="local",
                                      serve=serve_cfg(), **kw))
    assert fleet._replica_devices(1) == [torch.device("cpu")] * 2
    deliveries: dict = {}
    with fleet:
        meshes = [r.frontend.engine.mesh for r in fleet._replicas.values()]
        assert [m.shape for m in meshes] == [
            {"data": 2, "space": 1, "model": 1}] * 2
        sids = [fleet.open_stream() for _ in range(2)]
        for j in range(8):
            for k, sid in enumerate(sids):
                fleet.submit(sid, tagged_frame(k, j))
        drain_fleet(fleet, sids, deliveries, 8)
    for k, sid in enumerate(sids):
        got = deliveries[sid]
        assert [d.index for d in got] == list(range(8))
        for d in got:
            np.testing.assert_array_equal(d.frame, 255 - tagged_frame(k, d.index))


def test_child_without_cuda_fails_start():
    """A child asked for the card on a machine without CUDA answers
    ("err", ...): start() raises ReplicaLostError, and the child is gone
    (it never carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("the CPU-only case: this machine has CUDA")
    h = ProcessReplica("r0", {"filter": ("invert", {}),
                              "serve": {"batch_size": 2},
                              "device": "cuda:0"},
                       startup_timeout_s=120.0)
    with pytest.raises(ReplicaLostError, match="no CUDA device"):
        h.start()
    proc = h._proc
    h.stop(timeout=10.0)
    assert proc.poll() is not None


def test_pinned_spawn_starts_the_child_on_its_core():
    """pin_replicas_to_cores: the child runs on its one core from its
    first instruction (spawned from a thread pinned to it), so torch's
    thread pools size themselves to that core."""
    if not hasattr(os, "sched_getaffinity"):
        pytest.skip("no sched_getaffinity on this platform")
    core = sorted(os.sched_getaffinity(0))[0]
    h = ProcessReplica("r0", {"filter": ("invert", {}),
                              "serve": {"batch_size": 2},
                              "device": "cpu", "cpu_affinity": [core]},
                       startup_timeout_s=120.0)
    before = os.sched_getaffinity(0)
    h.start()
    try:
        assert os.sched_getaffinity(h.pid) == {core}
        assert os.sched_getaffinity(0) == before   # the caller's stays
        assert h.health()["ok"] is True
    finally:
        h.stop(timeout=10.0)


def test_cli_fleet_demo(capsys):
    """`python -m dvf_tpu_torch fleet --mode local` runs the multi-replica
    demo end to end: sessions spread over replicas, everything delivered,
    one JSON line out with fleet-level accounting."""
    import json

    from dvf_tpu_torch.cli import main

    rc = main([
        "fleet", "--mode", "local", "--replicas", "2", "--sessions", "4",
        "--filter", "invert", "--height", str(H), "--width", str(W),
        "--frames", "10", "--rate", "120", "--batch", "4",
        "--queue-size", "1000", "--slo-ms", "60000", "--platform", "cpu",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["replicas"]) == 2
    assert len(out["sessions"]) == 4
    assert {s["replica"] for s in out["sessions"].values()} == {"r0", "r1"}
    for sid, n in out["polled"].items():
        assert n == 10, (sid, out["polled"])
    assert out["aggregate"]["count"] == 40
    assert out["order_violations"] == 0
    assert out["replica_losses"] == 0
    assert out["faults"] == {}
