"""The port's multi-stream serving frontend (``dvf_tpu_torch.serve``)
on the CPU: counterparts of ``tests/test_serve.py`` (all but the CLI
demo, which waits for the port's CLI), plus parity with the JAX
package's frontend on the same seeded frames.

N tenant sessions share one engine with per-session in-order delivery,
zero cross-session frame leakage, SLO-based shedding under
oversubscription, admission control at the session cap, and clean
per-session teardown while other streams keep flowing.
"""

import threading
import time

import numpy as np
import pytest

from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.serve import (
    AdmissionError,
    ServeConfig,
    SessionClosedError,
)
from torch_serve_util import Engine, ServeFrontend, port_leak_guard  # noqa: F401

H, W = 16, 24


def tagged_frame(session_no: int, frame_no: int) -> np.ndarray:
    """A frame whose content encodes (session, index): row 0 carries the
    session number, row 1 the frame number — invert maps v → 255 - v, so
    any cross-session or cross-index mixup is detectable per pixel."""
    f = np.full((H, W, 3), 7, np.uint8)
    f[0] = session_no
    f[1] = frame_no % 251
    return f


def drain(frontend, sids, deliveries, deadline_s=30.0, until_closed=False):
    """Poll every session until all streams are retired (or quiescent)."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        moved = 0
        for sid in sids:
            got = frontend.poll(sid)
            deliveries.setdefault(sid, []).extend(got)
            moved += len(got)
        stats = frontend.stats()
        if until_closed:
            if stats["open_sessions"] == 0:
                break
        else:
            sess = stats["sessions"]
            done = all(
                sess[sid]["delivered"] + sess[sid]["shed"]
                + sess[sid]["failed"] + sess[sid]["dropped_at_ingress"]
                >= sess[sid]["submitted"]
                and sess[sid]["inflight"] == 0
                for sid in sids)
            if done and moved == 0:
                break
        time.sleep(0.005)
    # Final sweep: anything that landed between the last poll and the
    # quiescence snapshot.
    for sid in sids:
        deliveries.setdefault(sid, []).extend(frontend.poll(sid))


class TestMultiSessionCorrectness:
    def test_four_sessions_ordered_no_leakage(self):
        """≥4 concurrent streams at different rates through one engine:
        every session sees exactly its own frames, in order, exactly
        once, with correct numerics."""
        n_sessions, n_frames = 4, 24
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=4, queue_size=1000, slo_ms=60_000.0),
        )
        deliveries: dict = {}
        with fe:
            sids = [fe.open_stream() for _ in range(n_sessions)]

            def drive(k: int) -> None:
                period = 0.001 * (k + 1)  # different per-stream cadence
                for j in range(n_frames):
                    fe.submit(sids[k], tagged_frame(k, j))
                    time.sleep(period)

            threads = [threading.Thread(target=drive, args=(k,))
                       for k in range(n_sessions)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            drain(fe, sids, deliveries)
            stats = fe.stats()

        for k, sid in enumerate(sids):
            got = deliveries[sid]
            # Exactly once, in order (huge queues + huge SLO: no drops).
            assert [d.index for d in got] == list(range(n_frames)), (
                f"session {k}: indices {[d.index for d in got]}")
            for d in got:
                expected = 255 - tagged_frame(k, d.index)
                np.testing.assert_array_equal(
                    d.frame, expected,
                    err_msg=f"session {k} frame {d.index}: wrong content "
                            f"(cross-session leakage?)")
        assert stats["shed_total"] == 0
        # One shared engine compiled once, batches mixed across sessions.
        assert fe.engine.stats.compile_count == 1
        assert stats["engine_batches"] >= n_sessions * n_frames / 4 / 2

    def test_per_session_index_spaces_independent(self):
        """Both sessions' first frame is index 0 — private index spaces."""
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, slo_ms=60_000.0))
        deliveries: dict = {}
        with fe:
            a, b = fe.open_stream(), fe.open_stream()
            assert fe.submit(a, tagged_frame(0, 0)) == 0
            assert fe.submit(b, tagged_frame(1, 0)) == 0
            assert fe.submit(b, tagged_frame(1, 1)) == 1
            drain(fe, [a, b], deliveries)
        assert [d.index for d in deliveries[a]] == [0]
        assert [d.index for d in deliveries[b]] == [0, 1]


class TestSloShedding:
    def test_sheds_under_oversubscription(self):
        """A throttled engine + tight SLOs: frames that blow their budget
        before reaching a device slot are shed, not processed — and the
        frontend keeps delivering fresh frames throughout."""
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=2, max_inflight=1, queue_size=500,
                        slo_ms=60.0),
        )
        orig_submit = fe.engine.submit

        def slow_submit(batch, **kw):
            time.sleep(0.03)  # ~15 fps device vs ~hundreds offered
            return orig_submit(batch, **kw)

        fe.engine.submit = slow_submit
        deliveries: dict = {}
        with fe:
            sids = [fe.open_stream() for _ in range(4)]
            for j in range(40):
                for k, sid in enumerate(sids):
                    fe.submit(sid, tagged_frame(k, j))
                time.sleep(0.002)
            drain(fe, sids, deliveries, deadline_s=20.0)
            stats = fe.stats()

        assert stats["shed_total"] > 0, "oversubscription never shed"
        total_delivered = sum(len(v) for v in deliveries.values())
        assert total_delivered > 0, "shedding starved delivery entirely"
        for sid in sids:
            s = stats["sessions"][sid]
            assert (s["delivered"] + s["shed"] + s["failed"]
                    + s["dropped_at_ingress"] == s["submitted"]), s
            # Order survives shedding (gaps allowed, regressions not).
            idxs = [d.index for d in deliveries[sid]]
            assert idxs == sorted(idxs)

    def test_no_shedding_when_undersubscribed(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=4, queue_size=100,
                                       slo_ms=60_000.0))
        deliveries: dict = {}
        with fe:
            sid = fe.open_stream()
            for j in range(12):
                fe.submit(sid, tagged_frame(0, j))
            drain(fe, [sid], deliveries)
            assert fe.stats()["shed_total"] == 0
        assert len(deliveries[sid]) == 12


class TestAdmissionControl:
    def test_session_cap_rejects(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(max_sessions=2))
        a = fe.open_stream()
        fe.open_stream()
        with pytest.raises(AdmissionError):
            fe.open_stream()
        assert fe.stats()["admission_rejections"] == 1
        # Closing one readmits (the cap counts OPEN sessions).
        fe.close(a, drain=False)
        fe._finalize_drained()
        fe.open_stream()

    def test_duplicate_session_id_rejected(self):
        from dvf_tpu_torch.serve import ServeError

        fe = ServeFrontend(get_filter("invert"))
        fe.open_stream(session_id="cam0")
        with pytest.raises(ServeError, match="already exists"):
            fe.open_stream(session_id="cam0")

    def test_stateful_filter_rejected(self):
        """Temporal state would thread across tenants' batch rows."""
        filt = get_filter("flow_warp", levels=1, win_size=7, n_iters=1,
                          flow_scale=1)
        with pytest.raises(ValueError, match="stateful"):
            ServeFrontend(filt)

    def test_geometry_mismatch_rejected(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2))
        with fe:
            sid = fe.open_stream()
            fe.submit(sid, tagged_frame(0, 0))
            with pytest.raises(ValueError, match="pinned signature"):
                fe.submit(sid, np.zeros((H + 4, W, 3), np.uint8))


class TestSessionTeardown:
    def test_close_one_session_others_keep_flowing(self):
        n_frames = 16
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=4, queue_size=1000, slo_ms=60_000.0),
        )
        deliveries: dict = {}
        with fe:
            sids = [fe.open_stream() for _ in range(3)]
            # First half everywhere, then close stream 0 mid-flight.
            for j in range(n_frames // 2):
                for k, sid in enumerate(sids):
                    fe.submit(sid, tagged_frame(k, j))
            fe.close(sids[0], drain=True)
            with pytest.raises(SessionClosedError):
                fe.submit(sids[0], tagged_frame(0, 99))
            for j in range(n_frames // 2, n_frames):
                for k, sid in enumerate(sids[1:], start=1):
                    fe.submit(sid, tagged_frame(k, j))
            drain(fe, sids, deliveries)
            stats = fe.stats()

        # Graceful close: everything queued before close was delivered.
        assert [d.index for d in deliveries[sids[0]]] == list(range(n_frames // 2))
        assert stats["sessions"][sids[0]]["state"] == "closed"
        # Survivors were untouched: full ordered streams.
        for k, sid in enumerate(sids[1:], start=1):
            assert [d.index for d in deliveries[sid]] == list(range(n_frames))
            for d in deliveries[sid]:
                np.testing.assert_array_equal(
                    d.frame, 255 - tagged_frame(k, d.index))

    def test_retired_retention_bound_and_release(self):
        """Closed sessions stay poll-able only up to max_retired (oldest
        evicted), and release() forgets one explicitly."""
        from dvf_tpu_torch.serve import ServeError

        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(max_sessions=100, max_retired=2))
        ids = []
        for _ in range(4):
            sid = fe.open_stream()
            fe.close(sid, drain=False)
            fe._finalize_drained()
            ids.append(sid)
        assert fe.stats()["retired_sessions"] == 2
        with pytest.raises(KeyError):
            fe.poll(ids[0])         # oldest: evicted by the bound
        assert fe.poll(ids[-1]) == []   # newest: still poll-able
        fe.release(ids[-1])
        with pytest.raises(KeyError):
            fe.poll(ids[-1])
        open_sid = fe.open_stream()
        with pytest.raises(ServeError, match="still open"):
            fe.release(open_sid)

    def test_stop_finalizes_all_sessions(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, slo_ms=60_000.0))
        fe.start()
        sid = fe.open_stream()
        for j in range(6):
            fe.submit(sid, tagged_frame(0, j))
        # Let the engine finish what it can, then stop: the tail in the
        # reorder buffer must be flushed out, not dropped.
        deadline = time.time() + 10.0
        while time.time() < deadline:
            if fe.stats()["sessions"][sid]["inflight"] == 0 and \
                    len(fe._session(sid).ingress) == 0 and \
                    not fe._session(sid).pending:
                break
            time.sleep(0.005)
        fe.stop()
        got = fe.poll(sid)
        assert [d.index for d in got] == list(range(6))
        assert fe.stats()["sessions"][sid]["state"] == "closed"


class TestTenantIsolation:
    def test_raising_sink_contained_per_tenant(self):
        """One tenant's dying sink must not kill the shared frontend:
        its frames are dropped and counted, the other stream flows."""
        class ExplodingSink:
            def emit(self, index, frame, ts):
                raise RuntimeError("boom")

            def close(self):
                pass

        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, queue_size=100,
                                       slo_ms=60_000.0))
        deliveries: dict = {}
        with fe:
            bad = fe.open_stream(sink=ExplodingSink())
            good = fe.open_stream()
            for j in range(8):
                fe.submit(bad, tagged_frame(0, j))
                fe.submit(good, tagged_frame(1, j))
            drain(fe, [good], deliveries)
            stats = fe.stats()
        assert [d.index for d in deliveries[good]] == list(range(8))
        assert stats["sessions"][bad]["sink_errors"] == 8
        assert stats["errors"] == 0  # contained at the session, not fatal

    def test_non_monotonic_ts_keeps_order_exact_once(self):
        """Client capture timestamps can jitter backwards; deadlines are
        clamped monotonic so EDF never duplicates or drops a frame."""
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, queue_size=100,
                                       slo_ms=60_000.0))
        deliveries: dict = {}
        with fe:
            sid = fe.open_stream()
            base = time.time()
            jitter = [0.0, -2.5, 1.0, -4.0, 0.5, -1.0]
            for j, dt in enumerate(jitter):
                fe.submit(sid, tagged_frame(0, j), ts=base + dt)
            drain(fe, [sid], deliveries)
        assert [d.index for d in deliveries[sid]] == list(range(len(jitter)))


class TestObservability:
    def test_per_session_and_aggregate_latency_export(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, queue_size=100,
                                       slo_ms=60_000.0))
        deliveries: dict = {}
        with fe:
            sids = [fe.open_stream() for _ in range(2)]
            for j in range(8):
                for k, sid in enumerate(sids):
                    fe.submit(sid, tagged_frame(k, j))
            drain(fe, sids, deliveries)
            stats = fe.stats()
        for sid in sids:
            s = stats["sessions"][sid]
            assert s["count"] == 8
            assert s["p50_ms"] > 0 and s["p99_ms"] >= s["p50_ms"]
        agg = stats["aggregate"]
        assert agg["count"] == 16
        assert agg["p50_ms"] > 0 and agg["p99_ms"] >= agg["p50_ms"]
        # The merged percentiles select actual samples (no interpolation),
        # so they must land inside the union of per-session extremes.
        lo = min(min(stats["sessions"][s]["p50_ms"] for s in sids),
                 min(min(fe._session(s).latency.samples_ms) for s in sids))
        hi = max(max(fe._session(s).latency.samples_ms) for s in sids)
        assert lo <= agg["p50_ms"] <= agg["p99_ms"] <= hi + 1e-9

    def test_merged_latency_stats_weighting(self):
        from dvf_tpu_torch.obs.metrics import LatencyStats

        a, b = LatencyStats(), LatencyStats()
        for v in (1.0, 2.0, 3.0):
            a.record(v / 1e3)
        for v in (100.0,):
            b.record(v / 1e3)
        m = LatencyStats.merged([a, b])
        assert m["count"] == 4
        assert 1.0 <= m["p50_ms"] <= 3.0
        assert m["p99_ms"] == 100.0
        assert LatencyStats.merged([])["count"] == 0


def test_zmq_bridge_reference_framing():
    """A reference-style app (ROUTER fan-out + PULL collect, the exact
    distributor.py framing) drives one frontend session through the
    ZmqStreamBridge: READY-credit requests in, results echoing the APP's
    frame indices out, while the session rides the shared batcher."""
    zmq = pytest.importorskip("zmq")

    from benchtools import free_port
    from dvf_tpu_torch.serve import ZmqStreamBridge

    p_dist, p_coll = free_port(), free_port()
    ctx = zmq.Context()
    router = ctx.socket(zmq.ROUTER)
    router.bind(f"tcp://127.0.0.1:{p_dist}")
    pull = ctx.socket(zmq.PULL)
    pull.bind(f"tcp://127.0.0.1:{p_coll}")

    fe = ServeFrontend(
        get_filter("invert"),
        ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0),
    )
    n, size = 6, 16  # the reference's raw wire is square (inverter.py:34)
    rng = np.random.default_rng(3)
    frames = {100 + j: rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
              for j in range(n)}
    got = {}
    try:
        with fe:
            bridge = ZmqStreamBridge(
                fe, host="127.0.0.1", distribute_port=p_dist,
                collect_port=p_coll, use_jpeg=False, raw_size=size)
            bt = threading.Thread(target=bridge.run,
                                  kwargs={"max_frames": n}, daemon=True)
            bt.start()
            pending = sorted(frames)  # app-side index space starts at 100
            deadline = time.time() + 20.0
            while len(got) < n and time.time() < deadline:
                # App side: answer each READY with one [idx, bytes] frame.
                if router.poll(10):
                    ident, payload = router.recv_multipart()
                    assert payload == b"READY"
                    if pending:
                        idx = pending.pop(0)
                        router.send_multipart(
                            [ident, str(idx).encode(), frames[idx].tobytes()])
                while pull.poll(0):
                    idx_b, _pid, _t0, _t1, result = pull.recv_multipart()
                    got[int(idx_b.decode())] = np.frombuffer(
                        result, np.uint8).reshape(size, size, 3)
            bridge.stop()
            bt.join(timeout=5.0)
            bridge.close()
    finally:
        router.close(0)
        pull.close(0)
        ctx.term()

    assert sorted(got) == sorted(frames), "bridge lost or renumbered frames"
    for idx, frame in got.items():
        np.testing.assert_array_equal(frame, 255 - frames[idx])


class TestAdmissionSignatureCheck:
    """A geometry/dtype declared at open_stream ROUTES the session: a
    declaration matching a live bucket joins it, a new signature admits
    by creating a bucket (its program compiled at admission, never as a
    JIT stall on the serving path), and only past ``max_buckets`` is the
    open refused — with the warm-signature list in the message
    (tests/test_multitenant.py covers the multi-bucket matrix)."""

    def test_mismatched_declaration_routes_to_new_bucket(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, slo_ms=60_000.0))
        with fe:
            a = fe.open_stream(frame_shape=(H, W, 3))
            fe.submit(a, tagged_frame(0, 0))
            before = fe.stats()
            b = fe.open_stream(frame_shape=(H + 8, W, 3))
            c = fe.open_stream(frame_shape=(H, W, 3),
                               frame_dtype=np.float32)
            stats = fe.stats()
            assert stats["admission_rejections"] == \
                before["admission_rejections"]
            assert stats["open_buckets"] == 3
            # Each declared signature got its own compiled program.
            assert stats["pool"]["misses"] == 2
            assert b != c

    def test_bucket_cap_refusal_enumerates_warm_signatures(self):
        """At max_buckets with no idle bucket, the refusal names what
        the pool CAN serve cheaply (satellite: actionable rejections)."""
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, max_buckets=1,
                                       slo_ms=60_000.0))
        with fe:
            a = fe.open_stream(frame_shape=(H, W, 3))
            assert a
            with pytest.raises(AdmissionError,
                               match=r"warm signatures.*invert\|16x24x3"):
                fe.open_stream(frame_shape=(H + 8, W, 3))
            st = fe.stats()
            assert st["admission_rejections"] == 1
            # The refusal happened BEFORE any compile: a full frontend
            # must not pay (and pool) seconds of JIT just to say no.
            assert st["pool"]["misses"] == 0

    def test_matching_declaration_joins_precompiled_engine(self):
        """A caller-built engine arrives already compiled: a matching
        declaration joins its bucket (no second program), a mismatch
        forks a new bucket."""
        filt = get_filter("invert")
        engine = Engine(filt)
        engine.compile((2, H, W, 3), np.uint8)
        fe = ServeFrontend(filt, ServeConfig(batch_size=2), engine=engine)
        with fe:
            sid = fe.open_stream(frame_shape=(H, W, 3))  # match: joins
            assert sid
            assert fe.stats()["open_buckets"] == 1
            assert fe.stats()["pool"]["misses"] == 0
            fe.open_stream(frame_shape=(H * 2, W, 3))    # fork
            assert fe.stats()["open_buckets"] == 2

    def test_declaration_pins_default_bucket(self):
        """First declaration pins the default bucket: a later submit at
        a different geometry on THAT session gets the pinned-signature
        ValueError (per-stream geometry is still fixed)."""
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2))
        with fe:
            sid = fe.open_stream(frame_shape=(H, W, 3))
            with pytest.raises(ValueError, match="pinned signature"):
                fe.submit(sid, np.zeros((H + 2, W, 3), np.uint8))


class TestReplicaLifecycleHooks:
    """Satellite: the fleet-facing drain/health hooks on the frontend."""

    def test_begin_drain_refuses_new_sessions(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, slo_ms=60_000.0))
        with fe:
            a = fe.open_stream()
            fe.begin_drain()
            with pytest.raises(AdmissionError, match="draining"):
                fe.open_stream()
            # Existing sessions keep flowing while draining.
            fe.submit(a, tagged_frame(0, 0))
            deadline = time.time() + 20
            got = []
            while not got and time.time() < deadline:
                got = fe.poll(a)
                time.sleep(0.005)
            assert [d.index for d in got] == [0]
            assert fe.stats()["draining"] is True

    def test_drain_serves_tails_and_retires_everything(self):
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, slo_ms=60_000.0))
        with fe:
            sids = [fe.open_stream() for _ in range(3)]
            for j in range(4):
                for sid in sids:
                    fe.submit(sid, tagged_frame(0, j))
            assert fe.drain(timeout=30.0) is True
            assert fe.open_count() == 0
            # drained ≠ dropped: every queued frame was served and is
            # still poll-able off the retired sessions.
            for sid in sids:
                assert [d.index for d in fe.poll(sid)] == list(range(4))
            health = fe.health()
            assert health["ok"] and health["draining"]

    def test_latency_snapshot_matches_merged_aggregate(self):
        from dvf_tpu_torch.obs.metrics import LatencyStats

        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, slo_ms=60_000.0))
        with fe:
            sid = fe.open_stream()
            for j in range(6):
                fe.submit(sid, tagged_frame(0, j))
            deadline = time.time() + 20
            n = 0
            while n < 6 and time.time() < deadline:
                n += len(fe.poll(sid))
                time.sleep(0.005)
            snap = fe.latency_snapshot()
            agg = fe.stats()["aggregate"]
        merged = LatencyStats.merge_snapshots([snap])
        assert merged["count"] == agg["count"] == 6
        assert merged["p50_ms"] == pytest.approx(agg["p50_ms"])


# ---------------------------------------------------------------------------
# Parity with the JAX package's frontend (both on the CPU)
# ---------------------------------------------------------------------------

PH, PW = 24, 32
# (op_chain, sessions, bar): the pipeline's own bars — invert bit-exact,
# the float stencils within 1 LSB of the reference.
PARITY_CHAINS = [("invert", 2, 0), ("gaussian_blur(ksize=9)", 2, 1),
                 ("sobel_bilateral", 2, 1)]


def _parity_frames(n_frames: int, seed: int = 11) -> dict:
    """Seeded frames per (chain index, session number): the same bytes go
    through both packages."""
    rng = np.random.default_rng(seed)
    return {(c, k): [rng.integers(0, 256, (PH, PW, 3), dtype=np.uint8)
                     for _ in range(n_frames)]
            for c, (_, n, _) in enumerate(PARITY_CHAINS) for k in range(n)}


def _serve_mixed(fe, frames, n_frames):
    """Open one declared session per (chain, session), submit every
    frame, poll until all are delivered; {(c, k): [Delivery...]}."""
    got = {}
    with fe:
        sids = {ck: fe.open_stream(op_chain=PARITY_CHAINS[ck[0]][0],
                                   frame_shape=(PH, PW, 3))
                for ck in frames}
        for j in range(n_frames):
            for ck, sid in sids.items():
                fe.submit(sid, frames[ck][j])
        deadline = time.time() + 60.0
        while (sum(len(v) for v in got.values()) < n_frames * len(sids)
               and time.time() < deadline):
            for ck, sid in sids.items():
                got.setdefault(ck, []).extend(fe.poll(sid))
            time.sleep(0.005)
        stats = fe.stats()
    return got, stats


def test_mixed_signature_frames_match_reference():
    """The same seeded frames through both packages' frontends, three
    signatures in three buckets: per (session, index) the port's frame
    equals the reference's (invert bit-exact, the stencils within 1 LSB),
    every session complete and in order."""
    import dvf_tpu
    from dvf_tpu.serve import ServeConfig as JaxConfig
    from dvf_tpu.serve import ServeFrontend as JaxFrontend

    n_frames = 6
    frames = _parity_frames(n_frames)
    cfg = dict(batch_size=4, queue_size=100, slo_ms=60_000.0)
    got, stats = _serve_mixed(
        ServeFrontend(get_filter("invert"), ServeConfig(**cfg)),
        frames, n_frames)
    ref, ref_stats = _serve_mixed(
        JaxFrontend(dvf_tpu.get_filter("invert"), JaxConfig(**cfg)),
        frames, n_frames)
    assert sorted(stats["buckets"]) == sorted(ref_stats["buckets"])
    assert stats["open_buckets"] == ref_stats["open_buckets"] == 3
    for ck in frames:
        bar = PARITY_CHAINS[ck[0]][2]
        assert [d.index for d in got[ck]] == list(range(n_frames)), ck
        assert [d.index for d in ref[ck]] == list(range(n_frames)), ck
        for d, r in zip(got[ck], ref[ck]):
            assert d.frame.dtype == np.uint8
            assert d.frame.shape == (PH, PW, 3)
            diff = np.abs(d.frame.astype(np.int16) - r.frame.astype(np.int16))
            assert diff.max() <= bar, (ck, d.index, int(diff.max()))
    inv = [ck for ck in frames if ck[0] == 0]
    for ck in inv:   # and invert against its own input, byte for byte
        for d in got[ck]:
            np.testing.assert_array_equal(d.frame, 255 - frames[ck][d.index])


def _key_tree(doc, depth=0):
    """Key sets of a stats document, nested dicts included (dynamic keys —
    session ids, bucket labels — collapse to their rows' key sets)."""
    if not isinstance(doc, dict) or depth > 3:
        return None
    return {k: _key_tree(v, depth + 1) for k, v in doc.items()}


def _default_surfaces(fe, frame):
    with fe:
        sid = fe.open_stream(session_id="s0")
        fe.submit(sid, frame)
        deadline = time.time() + 30.0
        while not fe.poll(sid) and time.time() < deadline:
            time.sleep(0.005)
        return fe.stats(), fe.health(), fe.signals()


# stats()/signals() keys of the reference's default-config frontend that
# belong to planes the port has not ported yet. Empty: the default
# config arms none of them (the ledger, registry, continuity, streamed
# ingest/egress, resilient mode and the watchdog are all ported).
UNPORTED_DEFAULT_KEYS: set = set()


def test_default_frontend_surfaces_match_reference():
    """stats(), health() and signals() of a default-config frontend carry
    the reference's keys, nested rows included."""
    import dvf_tpu
    from dvf_tpu.serve import ServeFrontend as JaxFrontend

    frame = tagged_frame(0, 0)
    st, he, si = _default_surfaces(ServeFrontend(get_filter("invert")), frame)
    rst, rhe, rsi = _default_surfaces(
        JaxFrontend(dvf_tpu.get_filter("invert")), frame)
    assert set(he) == set(rhe)
    assert set(si) == set(rsi) - UNPORTED_DEFAULT_KEYS
    # The port's ingest and egress rows add the mean span the reference
    # sums and never reports (``span_ms``), wherever they appear.
    ours = _key_tree(st)
    rows = [ours] + list(ours["buckets"].values())
    assert all(row[part].pop("span_ms", 0) is None
               for row in rows for part in ("ingest", "egress"))
    assert ours == {k: v for k, v in _key_tree(rst).items()
                    if k not in UNPORTED_DEFAULT_KEYS}


def _bridge_payloads(pkg: str, wire: str, frames: list, size: int) -> list:
    """One reference-style app (ROUTER fan-out + PULL collect) drives one
    session of ``pkg``'s frontend through its ZmqStreamBridge on ``wire``;
    returns the result payload bytes in the app's index order."""
    import zmq

    from benchtools import free_port

    if pkg == "port":
        from dvf_tpu_torch.serve import ZmqStreamBridge
        from dvf_tpu_torch.transport.codec import make_wire_codec
        fe = ServeFrontend(get_filter("invert"),
                           ServeConfig(batch_size=2, queue_size=100,
                                       slo_ms=60_000.0))
    else:
        import dvf_tpu
        from dvf_tpu.serve import ServeConfig as JaxConfig
        from dvf_tpu.serve import ServeFrontend as JaxFrontend
        from dvf_tpu.serve import ZmqStreamBridge
        from dvf_tpu.transport.codec import make_wire_codec
        fe = JaxFrontend(dvf_tpu.get_filter("invert"),
                         JaxConfig(batch_size=2, queue_size=100,
                                   slo_ms=60_000.0))
    # The app side encodes with the same package's codec (the bytes in
    # are equal either way: the delta/JPEG encoders are byte-identical).
    app = (None if wire == "raw" else
           make_wire_codec(wire, quality=90, threads=1, tile=16,
                           keyframe_interval=4)
           if wire == "delta" else make_wire_codec(wire, quality=90,
                                                   threads=1))
    p_dist, p_coll = free_port(), free_port()
    ctx = zmq.Context()
    router = ctx.socket(zmq.ROUTER)
    router.bind(f"tcp://127.0.0.1:{p_dist}")
    pull = ctx.socket(zmq.PULL)
    pull.bind(f"tcp://127.0.0.1:{p_coll}")
    n = len(frames)
    got = {}
    try:
        with fe:
            bridge = ZmqStreamBridge(
                fe, host="127.0.0.1", distribute_port=p_dist,
                collect_port=p_coll, wire=wire, raw_size=size,
                codec_threads=1, delta_tile=16, delta_keyframe_interval=4)
            bt = threading.Thread(target=bridge.run,
                                  kwargs={"max_frames": n}, daemon=True)
            bt.start()
            pending = list(range(n))
            deadline = time.time() + 30.0
            while len(got) < n and time.time() < deadline:
                if router.poll(10):
                    ident, _ready = router.recv_multipart()
                    if pending:
                        idx = pending.pop(0)
                        blob = (frames[idx].tobytes() if app is None
                                else app.encode(frames[idx]))
                        router.send_multipart(
                            [ident, str(idx).encode(), blob])
                while pull.poll(0):
                    idx_b, _pid, _t0, _t1, result = pull.recv_multipart()
                    got[int(idx_b.decode())] = bytes(result)
            bridge.stop()
            bt.join(timeout=5.0)
            bridge.close()
    finally:
        if app is not None:
            app.close()
        router.close(0)
        pull.close(0)
        ctx.term()
    assert sorted(got) == list(range(n)), f"{pkg} bridge lost frames"
    return [got[i] for i in range(n)]


@pytest.mark.parametrize("wire", ["raw", "delta", "jpeg"])
def test_bridge_wire_bytes_match_reference(wire):
    """The same app traffic through both packages' ZmqStreamBridge: the
    result payloads are byte-identical on the raw, delta and JPEG wires
    (the latter two need the libjpeg shim, which builds here)."""
    pytest.importorskip("zmq")
    size = 32
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    frames = []
    for j in range(8):   # a moving block: the delta wire sends few tiles
        f = base.copy()
        f[4 + j:12 + j, 8:16] = 255 - f[4 + j:12 + j, 8:16]
        frames.append(f)
    port = _bridge_payloads("port", wire, frames, size)
    ref = _bridge_payloads("ref", wire, frames, size)
    assert port == ref
    if wire == "raw":
        for f, p in zip(frames, port):
            assert p == (255 - f).tobytes()


def test_bridge_audit_wire_and_lineage():
    """The bridge's planes: an audit-stamped app wire (one frame flipped
    on its way in is caught at the ``bridge_ingress`` hop and dropped,
    the rest decode), results stamped on the way out, and each delivery's
    lineage extended by ``encode`` and ``send`` into the frontend's wire
    attribution window."""
    zmq = pytest.importorskip("zmq")

    from benchtools import free_port
    from dvf_tpu_torch.obs.audit import WireAudit
    from dvf_tpu_torch.resilience import FaultPlan
    from dvf_tpu_torch.serve import ZmqStreamBridge

    p_dist, p_coll = free_port(), free_port()
    ctx = zmq.Context()
    router = ctx.socket(zmq.ROUTER)
    router.bind(f"tcp://127.0.0.1:{p_dist}")
    pull = ctx.socket(zmq.PULL)
    pull.bind(f"tcp://127.0.0.1:{p_coll}")
    fe = ServeFrontend(
        get_filter("invert"),
        ServeConfig(batch_size=2, queue_size=100, slo_ms=60_000.0,
                    audit=True, audit_sample_every=2, lineage=True))
    n, size = 6, 16
    rng = np.random.default_rng(4)
    frames = {j: rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
              for j in range(n)}
    app_out = WireAudit("app_egress",
                        chaos=FaultPlan(seed=1).add("corrupt_wire", at=(2,)))
    app_in = WireAudit("app_ingress")
    got = {}
    try:
        with fe:
            bridge = ZmqStreamBridge(
                fe, host="127.0.0.1", distribute_port=p_dist,
                collect_port=p_coll, use_jpeg=False, raw_size=size,
                audit_wire=True)
            bt = threading.Thread(target=bridge.run,
                                  kwargs={"max_frames": n - 1}, daemon=True)
            bt.start()
            pending = sorted(frames)
            deadline = time.time() + 30.0
            while len(got) < n - 1 and time.time() < deadline:
                if router.poll(10):
                    ident, _ready = router.recv_multipart()
                    if pending:
                        idx = pending.pop(0)
                        router.send_multipart(
                            [ident, str(idx).encode(),
                             app_out.stamp(frames[idx].tobytes())])
                while pull.poll(0):
                    idx_b, _pid, _t0, _t1, result = pull.recv_multipart()
                    got[int(idx_b.decode())] = np.frombuffer(
                        app_in.verify(result), np.uint8).reshape(
                            size, size, 3)
            bridge.stop()
            bt.join(timeout=10.0)
            assert fe.audit.drain(30.0)
            st = fe.stats()
            bridge.close()
    finally:
        router.close(0)
        pull.close(0)
        ctx.term()
    assert sorted(got) == [0, 1, 3, 4, 5]   # frame 2 was flipped in flight
    for idx, frame in got.items():
        np.testing.assert_array_equal(frame, 255 - frames[idx])
    hops = {h["hop"]: h for h in st["audit"]["wire_hops"]}
    assert hops["bridge_ingress"]["mismatches_total"] == 1
    assert hops["bridge_ingress"]["verified_total"] == n - 1
    assert hops["bridge_egress"]["stamped_total"] == n - 1
    assert st["audit"]["wire_mismatches_total"] == 1
    assert app_in.mismatches == 0
    wire = st["attribution"]["wire"]
    assert set(wire["components"]) == {"encode", "send"}
    assert wire["count"] == n - 1


def test_cli_serve_multi_demo(capsys):
    """`python -m dvf_tpu_torch serve --sessions 4` runs the local
    multi-stream demo end to end: 4 synthetic streams at different rates
    through one shared engine, one JSON line out."""
    import json

    from dvf_tpu_torch.cli import main

    rc = main([
        "serve", "--sessions", "4", "--filter", "invert",
        "--height", str(H), "--width", str(W), "--frames", "12",
        "--rate", "120", "--batch", "4", "--queue-size", "1000",
        "--slo-ms", "60000", "--quiet", "--platform", "cpu",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["sessions"]) == 4
    assert len(set(out["rates"].values())) == 4  # genuinely different rates
    for sid, s in out["sessions"].items():
        assert s["submitted"] == 12
        assert s["delivered"] == 12          # big queues + big SLO: lossless
        assert out["polled"][sid] == 12
    assert out["aggregate"]["count"] == 48
    assert out["admission_rejections"] == 0
    assert out["errors"] == 0
