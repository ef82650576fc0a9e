"""The port's session-continuity plane (``dvf_tpu_torch.resilience.
continuity``) on the CPU: counterparts of ``tests/test_continuity.py``
(its fleet, subscribe and worker-SIGTERM cases included), plus parity
of the tokens and backoff ladder with the JAX package.
"""

import os
import threading
import time
import types

import numpy as np
import pytest

from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.resilience.chaos import ChaosFault, FaultPlan
from dvf_tpu_torch.resilience.continuity import (
    ContinuityStats,
    HeartbeatConfig,
    LivenessMonitor,
    ReconnectPolicy,
    ReplayRing,
    ResumableStream,
    atomic_write_json,
    check_resume_token,
    load_json,
    make_resume_token,
    new_secret,
)
from dvf_tpu_torch.serve import ServeConfig, ServeError
from torch_serve_util import (  # noqa: F401
    FleetFrontend,
    ServeFrontend,
    port_fleet_guard,
    port_leak_guard,
)

H, W = 16, 24


def tagged_frame(session_no: int, frame_no: int) -> np.ndarray:
    f = np.full((H, W, 3), 7, np.uint8)
    f[0] = session_no
    f[1] = frame_no % 251
    return f


def serve_cfg(**kw) -> ServeConfig:
    base = dict(batch_size=2, queue_size=1000, out_queue_size=1000,
                slo_ms=60_000.0)
    base.update(kw)
    return ServeConfig(**base)


# -- primitives -----------------------------------------------------------


class TestReplayRing:
    def test_keys_by_index_not_arrival(self):
        ring = ReplayRing(capacity=8)
        for i in (3, 1, 2, 0):   # net_reorder arrival
            ring.push(i, f"f{i}")
        assert ring.replay_from(0) == [
            (0, "f0"), (1, "f1"), (2, "f2"), (3, "f3")]
        assert ring.replay_from(2) == [(2, "f2"), (3, "f3")]
        assert ring.oldest() == 0 and ring.latest() == 3

    def test_duplicate_keeps_first(self):
        ring = ReplayRing(capacity=4)
        ring.push(5, "first")
        ring.push(5, "second")
        assert ring.replay_from(0) == [(5, "first")]
        assert ring.pushed == 1

    def test_capacity_evicts_oldest(self):
        ring = ReplayRing(capacity=3)
        for i in range(6):
            ring.push(i, i)
        assert len(ring) == 3
        assert ring.evicted == 3
        assert [i for i, _ in ring.replay_from(0)] == [3, 4, 5]
        assert ring.replay_from(10) == []


class TestReconnectPolicy:
    def test_deterministic_and_bounded(self):
        cfg = HeartbeatConfig(backoff_base_s=0.05, backoff_max_s=1.0,
                              backoff_jitter=0.25)
        a = [ReconnectPolicy(cfg, seed=7).next_delay() for _ in range(1)]
        b = [ReconnectPolicy(cfg, seed=7).next_delay() for _ in range(1)]
        assert a == b, "same seed must reproduce the reconnect timeline"
        p = ReconnectPolicy(cfg, seed=7)
        delays = [p.next_delay() for _ in range(10)]
        assert all(d > 0 for d in delays)
        assert max(delays) <= cfg.backoff_max_s * (1 + cfg.backoff_jitter)
        # The ladder grows: late attempts sit at the (jittered) cap.
        assert delays[-1] > delays[0]

    def test_reset_counts_successful_reconnects(self):
        p = ReconnectPolicy(HeartbeatConfig(), seed=0)
        p.reset()                      # no attempt yet: not a reconnect
        assert p.reconnects == 0
        p.next_delay()
        p.next_delay()
        p.reset()
        assert p.reconnects == 1 and p.attempt == 0

    def test_heartbeat_config_validates(self):
        with pytest.raises(ValueError):
            HeartbeatConfig(interval_s=2.0, timeout_s=1.0).validate()
        assert HeartbeatConfig().validate() is not None


class TestLivenessMonitor:
    def test_beat_alive_dead_forget(self):
        m = LivenessMonitor(timeout_s=1.0)
        m.beat("a", now=100.0)
        m.beat("b", now=100.0)
        assert m.alive("a", now=100.5)
        assert m.silence_s("a", now=100.5) == pytest.approx(0.5)
        assert m.silence_s("zzz") is None
        assert not m.alive("zzz")
        m.beat("b", now=101.0)
        assert sorted(m.dead(now=101.5)) == ["a"]
        m.forget("a")
        assert m.dead(now=101.5) == []
        assert m.peers() == ["b"]


class TestResumeTokens:
    def test_roundtrip_and_epoch(self):
        secret = new_secret()
        tok = make_resume_token("s-1", 3, secret)
        assert tok.startswith("ct1.3.")
        assert check_resume_token(tok, "s-1", secret) == 3

    def test_rejections_never_raise(self):
        secret = new_secret()
        tok = make_resume_token("s-1", 0, secret)
        assert check_resume_token(tok, "s-2", secret) is None
        assert check_resume_token(tok, "s-1", new_secret()) is None
        assert check_resume_token("garbage", "s-1", secret) is None
        assert check_resume_token("ct2.0.00", "s-1", secret) is None
        assert check_resume_token("", "s-1", secret) is None


class TestSnapshotIO:
    def test_atomic_roundtrip_no_tmp_left(self, tmp_path):
        path = str(tmp_path / "state.json")
        atomic_write_json(path, {"version": 1, "x": [1, 2]})
        atomic_write_json(path, {"version": 2})
        assert load_json(path) == {"version": 2}
        assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []

    def test_load_degrades_to_none(self, tmp_path):
        assert load_json(str(tmp_path / "missing.json")) is None
        bad = tmp_path / "torn.json"
        bad.write_bytes(b'{"version": 1, "ses')
        assert load_json(str(bad)) is None
        notdict = tmp_path / "list.json"
        notdict.write_text("[1, 2]")
        assert load_json(str(notdict)) is None


def test_continuity_stats_signals_prefix():
    st = ContinuityStats()
    st.inc("partitions")
    st.inc("replayed_frames", 5)
    assert st.get("partitions") == 1
    assert st.summary()["replayed_frames"] == 5
    sig = st.signals()
    assert sig["dvf_continuity_partitions"] == 1.0
    assert all(k.startswith("dvf_continuity_") for k in sig)


class TestResumableStream:
    @staticmethod
    def _d(index):
        return types.SimpleNamespace(index=index)

    def test_dedup_and_assembly(self):
        rs = ResumableStream()
        for i in range(4):
            rs.note_submit(10 + i, i)
        d1 = self._d(10)
        fresh = rs.absorb([d1, d1, self._d(12)])   # net_dup noise
        assert [n for n, _ in fresh] == [0, 2]
        assert rs.dup_drops == 1
        assert rs.missing(4) == [1, 3]
        rs.absorb([self._d(11), self._d(13)])
        assert rs.missing(4) == []
        assert [d.index for d in rs.assembled()] == [10, 11, 12, 13]

    def test_resubmit_new_index_same_source(self):
        rs = ResumableStream()
        rs.note_submit(0, 0)
        rs.note_submit(7, 0)                # frame 0 resubmitted as idx 7
        assert rs.submitted == 2 and rs.resubmitted == 1
        rs.absorb([self._d(7)])
        assert rs.missing(1) == []
        # The original retry's late arrival is a counted duplicate.
        rs.absorb([self._d(0)])
        assert rs.dup_drops == 1 and rs.delivered_count() == 1

    def test_unknown_delivery_counted(self):
        rs = ResumableStream()
        rs.absorb([self._d(99)])
        assert rs.unknown_drops == 1 and rs.delivered_count() == 0


class TestChaosWireSites:
    def test_parse_and_partition_fires(self):
        plan = FaultPlan.parse("net_partition:every=2:count=1", seed=3)
        fired = 0
        for _ in range(6):
            try:
                plan.fire("net_partition")
            except ChaosFault:
                fired += 1
        assert fired == 1
        assert any(k.startswith("net_partition:")
                   for k in plan.summary()["fired"])

    def test_dup_and_reorder_deterministic(self):
        plan = FaultPlan.parse("net_dup:every=1,net_reorder:every=1")
        assert plan.dup("net_dup", [1, 2]) == [1, 1, 2]
        assert plan.dup("net_dup", []) == []
        assert plan.reorder("net_reorder", [1, 2, 3]) == [2, 3, 1]
        assert plan.reorder("net_reorder", [1]) == [1]
        quiet = FaultPlan.parse("net_dup:at=5")
        assert quiet.dup("net_dup", [1, 2]) == [1, 2]

    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError):
            FaultPlan.parse("net_bogus:every=2")


# -- serve-level resume ---------------------------------------------------


def test_serve_resume_stream_replays_tail():
    fe = ServeFrontend(get_filter("invert"),
                       serve_cfg(replay_window=64))
    n = 6
    with fe:
        sid = fe.open_stream()
        token = fe.resume_token(sid)
        for j in range(n):
            fe.submit(sid, tagged_frame(1, j))
        got = []
        deadline = time.time() + 30.0
        while len(got) < n and time.time() < deadline:
            got.extend(fe.poll(sid))
            time.sleep(0.005)
        assert [d.index for d in got] == list(range(n))

        replayed = fe.resume_stream(sid, token, from_index=2)
        assert [d.index for d in replayed] == [2, 3, 4, 5]
        for d in replayed:
            np.testing.assert_array_equal(
                d.frame, 255 - tagged_frame(1, d.index))
        assert fe.continuity.get("resumes") == 1
        assert fe.continuity.get("replayed_frames") == 4

        with pytest.raises(ServeError):
            fe.resume_stream(sid, "ct1.0.deadbeef", from_index=0)
        assert fe.continuity.get("resume_rejected") == 1
        ghost = make_resume_token("no-such-session", 0, fe._token_secret)
        with pytest.raises(KeyError):
            fe.resume_stream("no-such-session", ghost)


# -- bridge: zmq.Again back-off re-sends, never re-encodes (satellite) ----


def test_zmq_bridge_send_retry_reuses_encoded_payload():
    """A stalled PULL peer (``zmq.Again`` on send) must increment
    ``send_retries`` and re-send the SAME encoded payload next
    iteration: every app frame is encoded exactly once and still
    arrives bit-correct."""
    zmq = pytest.importorskip("zmq")

    from benchtools import free_port
    from dvf_tpu_torch.serve import ZmqStreamBridge

    class FlakyPush:
        """Raises zmq.Again on the first ``fail`` send attempts, then
        delegates to the real PUSH socket."""

        def __init__(self, real, fail):
            self._real = real
            self.remaining = fail
            self.raised = 0

        def send_multipart(self, parts, **kw):
            if self.remaining > 0:
                self.remaining -= 1
                self.raised += 1
                raise zmq.Again()
            return self._real.send_multipart(parts, **kw)

        def __getattr__(self, name):
            return getattr(self._real, name)

    p_dist, p_coll = free_port(), free_port()
    ctx = zmq.Context()
    router = ctx.socket(zmq.ROUTER)
    router.bind(f"tcp://127.0.0.1:{p_dist}")
    pull = ctx.socket(zmq.PULL)
    pull.bind(f"tcp://127.0.0.1:{p_coll}")

    fe = ServeFrontend(get_filter("invert"), serve_cfg())
    n, size, retries = 5, 16, 3
    rng = np.random.default_rng(9)
    frames = {100 + j: rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
              for j in range(n)}
    got = {}
    encoded = []
    try:
        with fe:
            bridge = ZmqStreamBridge(
                fe, host="127.0.0.1", distribute_port=p_dist,
                collect_port=p_coll, use_jpeg=False, raw_size=size)
            bridge.push = FlakyPush(bridge.push, fail=retries)
            real_submit = bridge.plane.submit

            def counting_submit(batch_frames, deliveries):
                encoded.extend(int(d.tag[0]) for d in deliveries)
                return real_submit(batch_frames, deliveries)

            bridge.plane.submit = counting_submit
            bt = threading.Thread(target=bridge.run,
                                  kwargs={"max_frames": n}, daemon=True)
            bt.start()
            pending = sorted(frames)
            deadline = time.time() + 25.0
            while len(got) < n and time.time() < deadline:
                if router.poll(10):
                    ident, payload = router.recv_multipart()
                    assert payload == b"READY"
                    if pending:
                        idx = pending.pop(0)
                        router.send_multipart(
                            [ident, str(idx).encode(),
                             frames[idx].tobytes()])
                while pull.poll(0):
                    idx_b, _pid, _t0, _t1, result = pull.recv_multipart()
                    got[int(idx_b.decode())] = np.frombuffer(
                        result, np.uint8).reshape(size, size, 3)
            retry_count = bridge.stats()["send_retries"]
            raised = bridge.push.raised
            bridge.stop()
            bt.join(timeout=5.0)
            bridge.close()
    finally:
        router.close(0)
        pull.close(0)
        ctx.term()

    assert sorted(got) == sorted(frames), "bridge lost frames across retries"
    for idx, frame in got.items():
        np.testing.assert_array_equal(frame, 255 - frames[idx])
    assert raised == retries, "stub never exercised the Again path"
    assert retry_count == retries
    assert sorted(encoded) == sorted(frames), (
        f"retries must re-send the cached payload, not re-encode: "
        f"{sorted(encoded)}")


# -- parity with the JAX package ------------------------------------------


def test_tokens_and_backoff_match_reference():
    """Resume tokens under one secret, their verdicts, and the seeded
    reconnect backoff ladder are equal across packages."""
    from dvf_tpu.resilience import continuity as ref

    secret = b"0123456789abcdef"
    for sid, epoch in (("s0", 0), ("cam-7", 3)):
        tok = make_resume_token(sid, epoch, secret)
        assert tok == ref.make_resume_token(sid, epoch, secret)
        assert check_resume_token(tok, sid, secret) == \
            ref.check_resume_token(tok, sid, secret)
        assert check_resume_token(tok, "other", secret) is None
    cfg, rcfg = HeartbeatConfig(), ref.HeartbeatConfig()
    a, b = ReconnectPolicy(cfg, seed=5), ref.ReconnectPolicy(rcfg, seed=5)
    assert [a.next_delay() for _ in range(8)] == \
        [b.next_delay() for _ in range(8)]


# -- fleet-level continuity ----------------------------------------------


@pytest.mark.fleet
def test_fleet_net_chaos_exactly_once_assembly():
    """Seeded net chaos on the fleet poll path (dup + reorder +
    partition): a ``ResumableStream`` client still assembles the stream
    gap-free and bit-identical, with zero order violations charged."""
    from dvf_tpu_torch.fleet import FleetConfig

    n = 20
    plan = FaultPlan.parse(
        "net_partition:every=7,net_dup:every=3,net_reorder:every=4",
        seed=11)
    fleet = FleetFrontend(
        get_filter("invert"),
        FleetConfig(replicas=2, mode="local", serve=serve_cfg(),
                    chaos=plan))
    rs = ResumableStream()
    src = {j: tagged_frame(2, j) for j in range(n)}
    with fleet:
        sid = fleet.open_stream()
        for j in range(n):
            rs.note_submit(fleet.submit(sid, src[j]), j)
        deadline = time.time() + 30.0
        last_move = time.time()
        # Two deliveries a poll: at least ten polls whatever the timing,
        # so the seeded partition (every 7th poll) always fires — the
        # port's replicas can deliver all 20 frames within 6 polls.
        while time.time() < deadline and rs.delivered_count() < n:
            if rs.absorb(fleet.poll(sid, max_items=2)):
                last_move = time.time()
            elif time.time() - last_move > 2.0:
                for j in rs.missing(n):   # partition-window loss, if any
                    rs.note_submit(fleet.submit(sid, src[j]), j)
                last_move = time.time()
            time.sleep(0.005)
        st = fleet.stats()

        assert rs.missing(n) == [], f"gaps after chaos: {rs.missing(n)}"
        for j, d in enumerate(rs.assembled()):
            np.testing.assert_array_equal(d.frame, 255 - src[j])
        assert st["order_violations"] == 0
        fired = plan.summary()["fired"]
        assert any(k.startswith("net_partition:") for k in fired), fired

        token = fleet.resume_token(sid)
        replayed = fleet.resume_stream(sid, token, from_index=0)
        assert replayed, "replay ring retained nothing"
        idxs = [d.index for d in replayed]
        assert idxs == sorted(idxs)
        assert rs.absorb(replayed) == []
        assert fleet.continuity.get("resumes") == 1

        with pytest.raises(ServeError):
            fleet.resume_stream(sid, "ct1.0.deadbeef")
        assert fleet.continuity.get("resume_rejected") == 1


@pytest.mark.fleet
def test_fleet_snapshot_document(tmp_path):
    """``snapshot_now`` writes a crash-consistent document carrying
    everything resume needs: session registry (placement, indices),
    replica incarnations and the token-signing secret."""
    from dvf_tpu_torch.fleet import FleetConfig

    path = str(tmp_path / "fleet_state.json")
    fleet = FleetFrontend(
        get_filter("invert"),
        FleetConfig(replicas=2, mode="local", serve=serve_cfg(),
                    state_path=path, snapshot_interval_s=60.0))
    with fleet:
        sid = fleet.open_stream()
        rs = ResumableStream()
        rs.note_submit(fleet.submit(sid, tagged_frame(0, 0)), 0)
        deadline = time.time() + 30.0
        while time.time() < deadline and rs.delivered_count() < 1:
            rs.absorb(fleet.poll(sid))
            time.sleep(0.005)
        token = fleet.resume_token(sid)
        assert fleet.snapshot_now() == path
        assert fleet.continuity.get("snapshots") >= 1

    doc = load_json(path)
    assert doc is not None and doc["version"] == 1
    assert sid in doc["sessions"]
    row = doc["sessions"][sid]
    assert row["replica_id"] in doc["replicas"]
    assert row["next_index"] >= 1
    assert check_resume_token(token, sid,
                              bytes.fromhex(doc["secret"])) is not None
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


@pytest.mark.fleet
@pytest.mark.slow
def test_fleet_process_crash_resume(tmp_path):
    """Front-door kill -9 (``crash()`` abandons live workers) followed
    by ``resume_state=True``: the still-live process replica is
    re-adopted, the open session survives with monotone indices, and
    the pre-crash resume token still verifies."""
    import dataclasses

    from dvf_tpu_torch.fleet import FleetConfig

    path = str(tmp_path / "fleet_state.json")
    cfg = FleetConfig(
        replicas=1, mode="process", filter_spec=("invert", {}),
        serve=serve_cfg(), state_path=path, snapshot_interval_s=0.05,
        reattach_grace_s=30.0, startup_timeout_s=120.0)
    f1 = FleetFrontend(get_filter("invert"), cfg)
    f2 = None
    rs = ResumableStream()
    n_warm = 4
    try:
        f1.start()
        sid = f1.open_stream()
        for j in range(n_warm):
            rs.note_submit(f1.submit(sid, tagged_frame(3, j)), j)
        deadline = time.time() + 60.0
        while time.time() < deadline and rs.delivered_count() < n_warm:
            rs.absorb(f1.poll(sid))
            time.sleep(0.01)
        assert rs.missing(n_warm) == []
        pre_max = max(d.index for d in rs.assembled())
        token = f1.resume_token(sid)
        time.sleep(0.3)   # let the snapshot thread catch the traffic
        f1.crash()        # front door dies; the worker process lives on

        f2 = FleetFrontend(get_filter("invert"),
                           dataclasses.replace(cfg, resume_state=True))
        f2.start()
        assert f2.continuity.get("adopted_replicas") == 1
        assert f2.continuity.get("adopted_sessions") == 1
        for j in range(n_warm, n_warm + 2):
            rs.note_submit(f2.submit(sid, tagged_frame(3, j)), j)
        deadline = time.time() + 60.0
        while time.time() < deadline and rs.delivered_count() < n_warm + 2:
            rs.absorb(f2.poll(sid))
            time.sleep(0.01)
        assert rs.missing(n_warm + 2) == []
        post = [d.index for d in rs.assembled()[n_warm:]]
        assert min(post) > pre_max, (pre_max, post)
        for j, d in enumerate(rs.assembled()):
            np.testing.assert_array_equal(d.frame, 255 - tagged_frame(3, j))
        assert f2.resume_stream(sid, token, from_index=0) is not None
    finally:
        if f2 is not None:
            f2.stop()
        else:
            f1.stop()


# -- CLI surfaces ---------------------------------------------------------


def test_subscribe_dead_gate_exits_3():
    """A gate that answers the hello then goes silent is declared dead
    after --idle-timeout: exit 3, promptly — not a zero-frame success
    after the full --timeout deadline."""
    import json

    zmq = pytest.importorskip("zmq")

    from benchtools import free_port
    from dvf_tpu_torch.cli import main as cli_main

    port = free_port()
    ctx = zmq.Context()
    router = ctx.socket(zmq.ROUTER)
    router.bind(f"tcp://127.0.0.1:{port}")
    done = threading.Event()

    def gate():
        if not router.poll(10_000):
            return
        ident, payload = router.recv_multipart()
        assert json.loads(payload)["op"] == "hello"
        router.send_multipart([ident, json.dumps(
            {"ok": True, "wire": "raw", "quality": 0,
             "tier": "native/q0/raw"}).encode()])
        while not done.is_set():   # swallow heartbeats, answer nothing
            if router.poll(50):
                router.recv_multipart()

    gt = threading.Thread(target=gate, daemon=True)
    gt.start()
    t0 = time.time()
    try:
        rc = cli_main([
            "subscribe", f"tcp://127.0.0.1:{port}", "--channel", "demo",
            "--frames", "3", "--timeout", "30", "--idle-timeout", "0.6"])
    finally:
        done.set()
        gt.join(timeout=5.0)
        router.close(0)
        ctx.term()
    assert rc == 3
    assert time.time() - t0 < 15.0, "exit 3 must beat the --timeout deadline"


def test_worker_sigterm_graceful_stats_line():
    """SIGTERM on `python -m dvf_tpu_torch worker`: the run loop drains
    the egress plane and the final stats JSON lands on stdout with exit
    0 — a supervisor's kill gets the same accounting as a max_frames
    exit."""
    import json
    import signal
    import subprocess
    import sys

    pytest.importorskip("zmq")

    from benchtools import free_port

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dvf_tpu_torch", "worker", "--filter", "invert",
         "--platform", "cpu", "--distribute-port", str(free_port()),
         "--collect-port", str(free_port())],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ready = False
        deadline = time.time() + 90.0
        while time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            if "serving" in line:
                ready = True
                break
        assert ready, "worker never reached the serving banner"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60.0)
    except Exception:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"worker exit {proc.returncode}: {err}"
    assert "draining" in err
    stats_lines = [ln for ln in out.splitlines() if ln.strip()]
    assert stats_lines, f"no stats line on stdout; stderr: {err}"
    stats = json.loads(stats_lines[-1])
    assert "frames_processed" in stats
    assert stats["errors"] == 0
