"""The port's audit plane (``dvf_tpu_torch.obs.audit``) on the CPU:
counterparts of ``tests/test_audit.py`` (its fleet-divergence case
included; its bench case waits for the benchmark harness, the quality
rebind leg of its swap-guard case for the control plane), plus the
cross-package checks: wire envelopes, digests and probe frames byte-equal
to ``dvf_tpu``'s, and the eager golden equal to the JAX golden within
``audit_tolerance`` (bit-exact for ``uint8_ok`` chains).
"""

import contextlib
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dvf_tpu_torch.obs import audit as audit_mod
from dvf_tpu_torch.obs.audit import (
    AuditPlane,
    DivergenceDetector,
    WireAudit,
    WireIntegrityError,
    frame_digest,
    frames_match,
    golden_execute,
    probe_frame,
    stamp_wire,
    verify_wire,
)
from dvf_tpu_torch.obs.registry import walk_export
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.resilience.chaos import FaultPlan
from dvf_tpu_torch.resilience.faults import FaultKind
from dvf_tpu_torch.serve import ServeConfig
from torch_serve_util import (  # noqa: F401
    Engine,
    FleetFrontend,
    ServeFrontend,
    port_fleet_guard,
    port_leak_guard,
)

pytestmark = pytest.mark.audit


def _rng_frame(shape=(32, 32, 3), seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, shape, dtype=np.uint8)


def _drain_session(fe, sid, want, deadline_s=30.0):
    got = []
    deadline = time.time() + deadline_s
    while len(got) < want and time.time() < deadline:
        got += fe.poll(sid)
        time.sleep(0.002)
    return got


@contextlib.contextmanager
def _dispatch_parked(fe):
    """Hold the dispatch thread at the top of its loop (the park it takes
    during a recovery) while a round is submitted, so the next batch
    holds the whole round in submission order."""
    fe._recovering.set()
    try:
        deadline = time.time() + 30.0
        while not fe._dispatch_parked.is_set():
            assert time.time() < deadline, "dispatch never parked"
            time.sleep(0.001)
        yield
    finally:
        fe._recovering.clear()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


# ---------------------------------------------------------------------------
# Wire integrity — unit + property layer
# ---------------------------------------------------------------------------


class TestWireEnvelope:
    def test_roundtrip_and_strictness(self):
        payload = b"the pixels themselves"
        env = stamp_wire(payload)
        assert verify_wire(env) == payload
        with pytest.raises(WireIntegrityError):
            verify_wire(payload, hop="h", strict=True)
        assert verify_wire(payload, hop="h", strict=False) == payload
        with pytest.raises(WireIntegrityError):
            verify_wire(env[:6], hop="h")

    def test_wire_audit_counters(self):
        wa = WireAudit("hoptest")
        env = wa.stamp(b"abc")
        assert wa.verify(env) == b"abc"
        bad = env[:-1] + bytes([env[-1] ^ 0x10])
        with pytest.raises(WireIntegrityError) as ei:
            wa.verify(bad)
        assert ei.value.hop == "hoptest"
        assert ei.value.kind == FaultKind.INTEGRITY
        st = wa.stats()
        assert st["stamped_total"] == 1
        assert st["verified_total"] == 1
        assert st["mismatches_total"] == 1

    def _payloads(self):
        """One payload per wire: raw, a delta keyframe and a dirty-tile
        delta frame (the real codec over the raw inner wire)."""
        from dvf_tpu_torch.transport.codec import DeltaCodec, RawCodec

        out = {"raw": _rng_frame((32, 32, 3), seed=2).tobytes()}
        f0 = _rng_frame((64, 64, 3), seed=1)
        f1 = f0.copy()
        f1[8:24, 8:24] ^= 0xFF
        codec = DeltaCodec(RawCodec(64, 64), tile=16)
        try:
            out["delta_keyframe"] = codec.encode(f0)
            out["delta_tiles"] = codec.encode(f1)
        finally:
            codec.close()
        return out

    def test_single_byte_corruption_detected_all_wires(self):
        """Flipping ANY single byte of a stamped envelope is detected,
        on every wire (the digest covers the complete framed payload,
        delta tile payloads included)."""
        for mode, payload in self._payloads().items():
            env = stamp_wire(payload)
            step = max(1, len(env) // 512)
            positions = list(range(0, len(env), step)) + [len(env) - 1]
            for pos in positions:
                bad = bytearray(env)
                bad[pos] ^= 0x01
                with pytest.raises(WireIntegrityError):
                    verify_wire(bytes(bad), hop=mode)
            assert verify_wire(env, hop=mode) == payload

    @pytest.mark.parametrize("seed", [0, 1, 7])
    def test_envelope_bytes_match_reference(self, seed):
        """Cross-package: the same payload stamps to the same envelope
        bytes, and the same seeded corrupt_wire plan flips the same bit
        in both packages."""
        from dvf_tpu.obs.audit import stamp_wire as jax_stamp
        from dvf_tpu.resilience.chaos import FaultPlan as JaxPlan

        payloads = list(self._payloads().values()) + [b"", b"x"]
        for p in payloads:
            assert stamp_wire(p) == jax_stamp(p)
        ours = FaultPlan(seed=seed).add("corrupt_wire", every=2)
        ref = JaxPlan(seed=seed).add("corrupt_wire", every=2)
        got = [stamp_wire(p, chaos=ours) for p in payloads]
        want = [jax_stamp(p, chaos=ref) for p in payloads]
        assert got == want
        assert any(g != stamp_wire(p) for g, p in zip(got, payloads))

    def test_digest_and_probe_frame_match_reference(self):
        from dvf_tpu.obs import audit as ref

        for shape, dtype, tag in [((8, 8, 3), np.uint8, "sig"),
                                  ((16, 24, 3), np.uint8, "invert"),
                                  ((4, 4, 1), np.float32, ""),
                                  ((6, 5, 3), np.uint16, "x|y")]:
            a = probe_frame(shape, dtype, tag=tag)
            b = ref.probe_frame(shape, dtype, tag=tag)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            assert frame_digest(a) == ref.frame_digest(b)
            assert frame_digest(a.tobytes()) == ref.frame_digest(b.tobytes())
        nc = _rng_frame((8, 12, 3))[:, ::2]   # non-contiguous
        assert frame_digest(nc) == ref.frame_digest(nc)
        assert audit_mod.AUDIT_WIRE_MAGIC == ref.AUDIT_WIRE_MAGIC
        assert audit_mod.TRACK_AUDIT == ref.TRACK_AUDIT
        assert audit_mod.WIRE_HEADER_LEN == ref.WIRE_HEADER_LEN

    def test_ring_queue_bit_flip_attributed_to_ring_hop(self):
        from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

        frame = _rng_frame()
        staging = np.empty((4, 32, 32, 3), np.uint8)
        plan = FaultPlan(seed=1).add("corrupt_wire", at=(1,))
        q = RingFrameQueue((32, 32, 3), capacity_frames=8, wire="raw",
                           audit_wire=True, chaos=plan)
        try:
            for i in range(3):
                q.put((i, frame, time.time()))
            items = q.pop_up_to(3)
            with pytest.raises(WireIntegrityError) as ei:
                q.decode_into(items, staging)
            assert ei.value.hop == "ring"
            assert q.wire_stats()["audit"]["mismatches_total"] == 1
        finally:
            q.close()

    def test_ring_queue_clean_roundtrip_all_wires(self):
        from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

        frame = _rng_frame((64, 64, 3), seed=3)
        for wire in ("raw", "delta"):
            staging = np.empty((2, 64, 64, 3), np.uint8)
            q = RingFrameQueue((64, 64, 3), capacity_frames=8, wire=wire,
                               audit_wire=True, codec_threads=1)
            try:
                q.put((0, frame, time.time()))
                q.put((1, frame, time.time()))
                q.decode_into(q.pop_up_to(2), staging)
                if wire == "raw":
                    assert (staging == frame).all()
                assert q.wire_stats()["audit"]["verified_total"] == 2
                assert q.wire_stats()["audit"]["mismatches_total"] == 0
            finally:
                q.close()

    def test_worker_ingress_verify(self):
        """The worker's decode hop: a stamped raw payload processes; a
        corrupted one raises the integrity fault from ``process_batch``
        (the socket loop's containment classifies it)."""
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        frame = _rng_frame()
        worker = ZmqWorker(get_filter("invert"), batch_size=2,
                           use_jpeg=False, raw_size=32, audit_wire=True,
                           device="cpu", connect=False)
        sent = []
        try:
            good = stamp_wire(frame.tobytes())
            worker.process_batch([(0, good), (1, good)],
                                 lambda i, t0, t1, p: sent.append((i, p)))
            worker.drain_egress()
            assert worker.frames_processed == 2
            # Results leave stamped (the zmq_egress hop) and decode to
            # the inverted frame.
            assert [i for i, _ in sent] == [0, 1]
            out = np.frombuffer(verify_wire(sent[0][1]), np.uint8)
            assert np.array_equal(out.reshape(frame.shape), 255 - frame)
            bad = bytearray(good)
            bad[-1] ^= 0x01
            with pytest.raises(WireIntegrityError) as ei:
                worker.process_batch([(2, bytes(bad))],
                                     lambda i, t0, t1, p: None)
            assert ei.value.hop == "zmq_ingress"
            doc = worker.audit_document()
            assert doc["wire_mismatches_total"] == 1
            assert worker.stats()["audit"]["wire_enabled"] is True
            assert worker.ledger.summary()["by_kind"].get("compile") == 1
        finally:
            worker.close()

    def test_worker_egress_flip_caught_downstream(self):
        """The corrupt_wire site on the worker's stamp side: the flipped
        result is caught by the receiving hop, never decoded."""
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        frame = _rng_frame()
        plan = FaultPlan(seed=3).add("corrupt_wire", at=(1,))
        worker = ZmqWorker(get_filter("invert"), batch_size=2,
                           use_jpeg=False, raw_size=32, audit_wire=True,
                           chaos=plan, device="cpu", connect=False)
        sent = []
        try:
            good = stamp_wire(frame.tobytes())
            worker.process_batch([(0, good), (1, good)],
                                 lambda i, t0, t1, p: sent.append(p))
            worker.drain_egress()
            app = WireAudit("app_ingress")
            assert app.verify(sent[0]) is not None
            with pytest.raises(WireIntegrityError) as ei:
                app.verify(sent[1])
            assert ei.value.hop == "app_ingress"
            assert worker.audit_document()["wire_hops"][1][
                "stamped_total"] == 2
        finally:
            worker.close()


# ---------------------------------------------------------------------------
# Golden path + plane unit layer
# ---------------------------------------------------------------------------


class TestGoldenAndPlane:
    def test_probe_frame_deterministic(self):
        a = probe_frame((8, 8, 3), np.uint8, tag="sig")
        b = probe_frame((8, 8, 3), np.uint8, tag="sig")
        c = probe_frame((8, 8, 3), np.uint8, tag="other")
        assert np.array_equal(a, b)
        assert not np.array_equal(a, c)

    def test_frames_match_tolerance(self):
        a = np.zeros((4, 4), np.uint8)
        b = a.copy()
        b[0, 0] = 2
        assert frames_match(a, a, 0) == (True, 0.0)
        ok, diff = frames_match(a, b, 1)
        assert not ok and diff == 2.0
        ok, _ = frames_match(a, b, 2)
        assert ok
        assert frames_match(a, np.zeros((2, 2), np.uint8), 99)[0] is False

    def test_golden_matches_engine(self):
        filt = get_filter("invert")
        eng = Engine(filt)
        eng.compile((2, 16, 16, 3), np.uint8)
        frame = _rng_frame((16, 16, 3), seed=4)
        batch = np.zeros((2, 16, 16, 3), np.uint8)
        batch[0] = frame
        served = eng.run_probe(batch)[0]
        golden = golden_execute(filt, frame)
        assert np.array_equal(served, golden)
        assert eng.stats.batches == 0
        eng.free()

    @pytest.mark.parametrize("chain", [
        "invert", "grayscale", "gaussian_blur(ksize=9)", "sobel_bilateral",
        "box_blur(ksize=3)|invert",
    ])
    def test_golden_matches_reference_golden(self, chain):
        """Cross-package: the port's eager golden on a seeded frame equals
        the JAX golden within the plane's tolerance — bit-exact where the
        chain stays in uint8 (``uint8_ok``)."""
        import dvf_tpu.runtime.signature as jsig
        from dvf_tpu.obs.audit import golden_execute as jax_golden
        from dvf_tpu.obs.audit import replay_tolerance as jax_tol
        from dvf_tpu_torch.runtime.signature import build_filter

        ours = build_filter(chain)
        ref = jsig.build_filter(chain)
        frame = _rng_frame((24, 32, 3), seed=9)
        got = golden_execute(ours, frame)
        want = jax_golden(ref, frame)
        tol = audit_mod.replay_tolerance(ours, frame.dtype, 2.0)
        assert tol == jax_tol(ref, frame.dtype, 2.0)
        ok, diff = frames_match(got, want, tol)
        assert ok, (chain, diff, tol)
        if ours.uint8_ok:
            assert tol == 0.0 and np.array_equal(got, want)

    def test_golden_refuses_stateful(self):
        with pytest.raises(ValueError, match="stateful"):
            golden_execute(get_filter("flow_warp"), _rng_frame())

    def test_stream_is_none_off_the_card(self):
        plane = AuditPlane()
        assert plane.stream(None) is None
        assert plane.stream("cpu") is None

    def test_sampler_deterministic_and_bounded_queue(self):
        p1 = AuditPlane(sample_every=4, seed=1, queue_depth=2)
        p2 = AuditPlane(sample_every=4, seed=1, queue_depth=2)
        seq1 = [p1.want_sample() for _ in range(16)]
        seq2 = [p2.want_sample() for _ in range(16)]
        assert seq1 == seq2
        assert sum(seq1) == 4
        filt = get_filter("invert")
        f = _rng_frame((8, 8, 3))
        for _ in range(5):
            p1.submit_replay(filt, f, f)
        assert p1.replays_dropped == 3
        assert p1.stats()["replays_sampled_total"] == 5
        p1._enqueue(("guard", {"marker": True}))
        p1.submit_replay(filt, f, f)
        p1.submit_replay(filt, f, f)
        with p1._cv:
            kinds = [it[0] for it in p1._q]
        assert kinds.count("guard") == 1
        assert p1.replays_dropped == 6

    def test_sampler_and_counters_match_reference(self):
        """Cross-package: the same sampler phase sequence and the same
        queue accounting (stats() minus its event ring) as dvf_tpu's
        plane for one scripted sequence."""
        import dvf_tpu
        from dvf_tpu.obs.audit import AuditPlane as JaxPlane

        ours = AuditPlane(sample_every=3, seed=2, queue_depth=3)
        ref = JaxPlane(sample_every=3, seed=2, queue_depth=3)
        assert ([ours.want_sample() for _ in range(20)]
                == [ref.want_sample() for _ in range(20)])
        f = _rng_frame((8, 8, 3))
        for plane, filt in ((ours, get_filter("invert")),
                            (ref, dvf_tpu.get_filter("invert"))):
            for _ in range(5):
                plane.submit_replay(filt, f, f)
        a, b = ours.stats(), ref.stats()
        a.pop("events")
        b.pop("events")
        assert a == b
        assert set(ours.signals()) == set(ref.signals())

    def test_swap_guard_flags_wrong_program(self):
        eng = Engine(get_filter("invert"))
        eng.compile((2, 16, 16, 3), np.uint8)
        plane = AuditPlane(sample_every=4)
        ev = plane.swap_guard(engine=eng, filt=get_filter("grayscale"),
                              kind="batch_resize", cause="resize",
                              signature="rigged", bucket="rigged")
        assert ev["verdict"] == "mismatch"
        assert plane.swap_guard_mismatches == 1
        assert plane.confirmed_corruptions == 1
        ev = plane.swap_guard(engine=eng, filt=get_filter("invert"),
                              kind="batch_resize", cause="resize",
                              signature="ok", bucket="ok")
        assert ev["verdict"] == "match"
        assert ev["digest_new"] == ev["digest_golden"]
        eng.free()

    def test_swap_guard_digest_matches_reference(self):
        """The probe digest of one compiled signature is the same in both
        packages (what a mixed fleet's divergence check would compare)."""
        import dvf_tpu
        from dvf_tpu.obs.audit import engine_probe_row as jax_probe_row
        from dvf_tpu.runtime.engine import Engine as JaxEngine

        ours = Engine(get_filter("invert"))
        ours.compile((2, 16, 16, 3), np.uint8)
        ref = JaxEngine(dvf_tpu.get_filter("invert"))
        ref.compile((2, 16, 16, 3), np.uint8)
        a = audit_mod.engine_probe_row(ours)
        b = jax_probe_row(ref)
        assert frame_digest(a) == frame_digest(b)
        ours.free()


# ---------------------------------------------------------------------------
# Serve: shadow replay + chaos acceptance
# ---------------------------------------------------------------------------


def _serve(audit=True, chaos=None, sample_every=1, filt_name="invert", **kw):
    cfg = ServeConfig(batch_size=2, queue_size=64, slo_ms=60_000.0,
                      audit=audit, audit_sample_every=sample_every,
                      chaos=chaos, **kw)
    return ServeFrontend(get_filter(filt_name), cfg).start()


class TestShadowReplay:
    def test_clean_run_zero_corruptions_and_schema(self):
        fe = _serve()
        try:
            sid = fe.open_stream()
            frame = _rng_frame()
            for _ in range(8):
                fe.submit(sid, frame)
            assert len(_drain_session(fe, sid, 8)) == 8
            assert fe.audit.drain(30.0)
            st = fe.stats()["audit"]
            assert st["replays_sampled_total"] >= 8
            assert st["replays_ok_total"] == st["replays_sampled_total"]
            assert st["replay_mismatches_total"] == 0
            assert st["confirmed_corruptions_total"] == 0
            assert st["replay_errors_total"] == 0
            assert walk_export({"audit": st}) == []
            sig = fe.signals()
            assert sig["audit_replays_total"] >= 8
            assert sig["audit_confirmed_corruptions_total"] == 0
            names = {s.name for s in fe.registry.collect()}
            assert "audit_replays_total" in names
        finally:
            fe.stop()

    @pytest.mark.parametrize("filt_name", ["gaussian_blur",
                                           "sobel_bilateral"])
    def test_float_chain_within_tolerance(self, filt_name):
        fe = _serve(filt_name=filt_name)
        try:
            sid = fe.open_stream()
            frame = _rng_frame()
            for _ in range(6):
                fe.submit(sid, frame)
            assert len(_drain_session(fe, sid, 6)) == 6
            assert fe.audit.drain(30.0)
            st = fe.stats()["audit"]
            assert st["replays_sampled_total"] >= 6
            assert st["replay_mismatches_total"] == 0
            assert st["replay_errors_total"] == 0
        finally:
            fe.stop()

    def test_chaos_device_corruption_acceptance(self, tmp_path):
        """Injected device corruption is caught by shadow replay,
        attributed to its bucket and session, classified ``integrity``,
        trips a flight dump holding ``audit.json`` — and the non-faulted
        session's deliveries stay bit-identical to a fault-free run."""
        rng_a = _rng_frame((32, 32, 3), seed=10)
        rng_b = _rng_frame((32, 32, 3), seed=11)

        def run(chaos, flight_dir=None):
            fe = _serve(chaos=chaos, sample_every=1, flight_dir=flight_dir,
                        flight_min_interval_s=0.0)
            try:
                sa = fe.open_stream(session_id="victim")
                sb = fe.open_stream(session_id="control")
                outs_b = {}
                for _ in range(8):
                    with _dispatch_parked(fe):   # one batch [A, B]
                        fe.submit(sa, rng_a)
                        fe.submit(sb, rng_b)
                    got_a = _drain_session(fe, sa, 1)
                    got_b = _drain_session(fe, sb, 1)
                    assert len(got_a) == 1 and len(got_b) == 1
                    outs_b[got_b[0].index] = got_b[0].frame.copy()
                assert fe.audit.drain(30.0)
                return fe, outs_b
            except BaseException:
                fe.stop()
                raise

        fe, clean_b = run(None)
        assert fe.stats()["audit"]["confirmed_corruptions_total"] == 0
        fe.stop()
        plan = FaultPlan(seed=7).add("corrupt_device", every=2)
        fdir = str(tmp_path / "flight")
        fe, chaos_b = run(plan, flight_dir=fdir)
        try:
            st = fe.stats()["audit"]
            assert st["confirmed_corruptions_total"] >= 1
            assert st["replay_mismatches_total"] >= 1
            ev = [e for e in st["events"] if e["kind"] == "shadow_replay"]
            assert ev
            assert ev[0]["session"] == "victim"
            assert ev[0]["bucket"]
            assert "ledger_tail" in ev[0]
            assert fe.stats()["faults"]["by_kind"][FaultKind.INTEGRITY] >= 1
            assert set(chaos_b) == set(clean_b)
            for idx, f in chaos_b.items():
                assert np.array_equal(f, clean_b[idx])
            deadline = time.time() + 30.0
            dump = None
            while time.time() < deadline and dump is None:
                dumps = sorted(os.listdir(fdir)) if os.path.isdir(fdir) else []
                for d in dumps:
                    if os.path.exists(os.path.join(fdir, d, "audit.json")):
                        dump = os.path.join(fdir, d)
                        break
                time.sleep(0.05)
            assert dump is not None
            with open(os.path.join(dump, "audit.json")) as f:
                doc = json.load(f)
            assert doc["confirmed_corruptions_total"] >= 1
            assert any(e["kind"] == "shadow_replay" for e in doc["events"])
            from dvf_tpu_torch.obs.viewer import render_text, summarize_dump

            summary = summarize_dump(dump)
            assert summary["audit"]["confirmed_corruptions_total"] >= 1
            text = render_text(summary)
            assert "audit verdicts" in text
            assert "shadow_replay" in text
        finally:
            fe.stop()


# ---------------------------------------------------------------------------
# Program-swap equivalence guard
# ---------------------------------------------------------------------------


class TestSwapGuardCoverage:
    def test_resize_and_recovery_audited(self):
        """A batch resize (hot swap) and a recovery rebuild each ledger a
        swap_guard verdict; the resize also proves old-program
        bit-identity. (The quality-rebind leg needs the control plane.)"""
        fe = _serve(sample_every=4)
        try:
            sid = fe.open_stream()
            frame = _rng_frame((32, 32, 3), seed=5)
            for _ in range(4):
                fe.submit(sid, frame)
            assert len(_drain_session(fe, sid, 4)) == 4
            label = next(iter(fe.stats()["buckets"]))
            assert fe.request_batch_size(label, 3, reason="test")
            deadline = time.time() + 30.0
            while time.time() < deadline:
                b = next(iter(fe.stats()["buckets"].values()))
                if b["batch_size"] == 3:
                    break
                time.sleep(0.01)
            with fe._lock:
                bucket = fe._buckets[0]
            fe._recover("audit coverage test", kind=FaultKind.COMPUTE,
                        bucket=bucket)
            assert fe.audit.drain(30.0)
            events = fe.ledger.snapshot()
            subs = [e for e in events
                    if e["kind"] in ("swap", "engine_rebuild")]
            guards = [e for e in events if e["kind"] == "swap_guard"]
            assert {e["kind"] for e in subs} == {"swap", "engine_rebuild"}
            assert {"batch_resize", "engine_rebuild"} <= {
                e["swap_kind"] for e in guards}
            assert len(guards) >= len(subs)
            assert all(e["verdict"] in ("match", "skipped")
                       for e in guards), guards
            assert fe.stats()["audit"]["swap_guard_mismatches_total"] == 0
            rg = [e for e in guards if e["swap_kind"] == "batch_resize"]
            assert rg and rg[0].get("old_program_match") is True
            rb = [e for e in guards if e["swap_kind"] == "engine_rebuild"]
            assert rb and rb[0].get("old_program_match") is True
        finally:
            fe.stop()

    def test_resize_quality_recovery_all_audited(self):
        """One audited run exercising all three live-path recompiles —
        every substitution must have a swap_guard verdict in the
        ledger (the acceptance bar item 1's hot swap inherits)."""
        fe = _serve(sample_every=4, control=True)
        try:
            sid = fe.open_stream()
            frame = _rng_frame((32, 32, 3), seed=5)
            for _ in range(4):
                fe.submit(sid, frame)
            assert len(_drain_session(fe, sid, 4)) == 4
            label = next(iter(fe.stats()["buckets"]))
            # (1) batch resize.
            assert fe.request_batch_size(label, 3, reason="test")
            deadline = time.time() + 30.0
            while time.time() < deadline:
                b = next(iter(fe.stats()["buckets"].values()))
                if b["batch_size"] == 3:
                    break
                time.sleep(0.01)
            # (2) quality rebind (control armed → submit decimates).
            assert fe.request_session_quality(sid, 1, reason="test")
            deadline = time.time() + 30.0
            while fe.quality_rebinds < 1 and time.time() < deadline:
                time.sleep(0.01)
            assert fe.quality_rebinds == 1
            # (3) recovery rebuild (deterministic direct invocation —
            # the chaos-driven path is pinned in test_chaos).
            with fe._lock:
                bucket = fe._buckets[0]
            fe._recover("audit coverage test",
                        kind=FaultKind.COMPUTE, bucket=bucket)
            assert fe.audit.drain(30.0)
            events = fe.ledger.snapshot()
            # The resize substitution now lands as a hot-swap event
            # (kind=swap, cause=resize); rebind and rebuild keep their
            # kinds. Every one still carries a swap_guard verdict.
            subs = [e for e in events if e["kind"] in
                    ("swap", "quality_rebind", "engine_rebuild")]
            guards = [e for e in events if e["kind"] == "swap_guard"]
            kinds = {e["kind"] for e in subs}
            assert kinds == {"swap", "quality_rebind",
                             "engine_rebuild"}
            # ZERO unaudited substitutions: every substitution kind has
            # a guard verdict, and no guard mismatched on this clean
            # run.
            guard_kinds = {e["swap_kind"] for e in guards}
            assert {"batch_resize", "quality_rebind",
                    "engine_rebuild"} <= guard_kinds
            assert len(guards) >= len(subs)
            assert all(e["verdict"] in ("match", "skipped")
                       for e in guards), guards
            st = fe.stats()["audit"]
            assert st["swap_guard_mismatches_total"] == 0
            # Resize guard also proved old-program bit-identity.
            rg = [e for e in guards if e["swap_kind"] == "batch_resize"]
            assert rg and rg[0].get("old_program_match") is True
        finally:
            fe.stop()

    def test_morph_audited(self):
        """A live morph's adopted program gets its verdict against the
        golden of its own chain."""
        fe = _serve(sample_every=4)
        try:
            sid = fe.open_stream(op_chain="invert", frame_shape=(32, 32, 3))
            fe.submit(sid, _rng_frame())
            assert len(_drain_session(fe, sid, 1)) == 1
            fe.morph_stream(sid, "invert|invert")
            deadline = time.time() + 30.0
            while fe.morphs < 1 and time.time() < deadline:
                time.sleep(0.01)
            assert fe.morphs == 1
            assert fe.audit.drain(30.0)
            guards = [e for e in fe.ledger.snapshot()
                      if e["kind"] == "swap_guard"]
            assert [e["swap_kind"] for e in guards] == ["morph"]
            assert guards[0]["verdict"] == "match"
        finally:
            fe.stop()


# ---------------------------------------------------------------------------
# Cross-replica divergence (the detector; its fleet wiring waits)
# ---------------------------------------------------------------------------


class TestDivergence:
    def test_detector_verdicts(self):
        det = DivergenceDetector()
        ev = det.check({"r0": {"digest": "aa"}, "r1": {"digest": "aa"}},
                       signature="s")
        assert ev["verdict"] == "match"
        ev = det.check({"r0": {"digest": "aa"}, "r1": {"digest": "aa"},
                        "r2": {"digest": "bb"}}, signature="s")
        assert ev["verdict"] == "mismatch"
        assert ev["divergent"] == ["r2"]
        ev = det.check({"r0": {"digest": "aa"}, "r1": {"digest": "bb"}},
                       signature="s")
        assert ev["verdict"] == "mismatch" and ev["divergent"] == []
        ev = det.check({"r0": {"digest": "aa"}, "r1": None}, signature="s")
        assert ev["verdict"] == "skipped"
        assert ev["unreachable"] == ["r1"]
        st = det.stats()
        assert st["checks_total"] == 4
        assert st["divergences_total"] == 2
        assert walk_export({"audit": st}) == []

    def test_detector_quarantine_cb(self):
        retired = []
        det = DivergenceDetector(
            quarantine_cb=lambda rid: retired.append(rid) or True)
        det.check({"r0": {"digest": "aa"}, "r1": {"digest": "aa"},
                   "r2": {"digest": "bb"}}, signature="s", quarantine=True)
        assert retired == ["r2"]
        assert det.stats()["quarantined_total"] == 1

    def test_detector_matches_reference(self):
        from dvf_tpu.obs.audit import DivergenceDetector as JaxDetector

        script = [
            {"r0": {"digest": "aa"}, "r1": {"digest": "aa"}},
            {"r0": {"digest": "aa"}, "r1": {"digest": "bb"},
             "r2": {"digest": "bb"}},
            {"r0": None, "r1": {"digest": "cc"}},
        ]
        ours, ref = DivergenceDetector(), JaxDetector()
        for probes in script:
            a = ours.check(probes, signature="s")
            b = ref.check(probes, signature="s")
            a.pop("t")
            b.pop("t")
            assert a == b
        assert ours.signals() == ref.signals()

    def test_serve_audit_probe_digest(self):
        """The frontend's probe: the digest of its compiled program's
        probe row, the same for every frontend serving the signature."""
        digests = []
        for _ in range(2):
            fe = _serve(audit=False)
            try:
                sid = fe.open_stream(op_chain="invert",
                                     frame_shape=(32, 32, 3))
                fe.submit(sid, _rng_frame())
                _drain_session(fe, sid, 1)
                doc = fe.audit_probe()
                assert doc["signature"] == "invert|32x32x3|uint8"
                digests.append(doc["digest"])
                with pytest.raises(Exception, match="no compiled program"):
                    fe.audit_probe("grayscale|8x8x3|uint8")
            finally:
                fe.stop()
        assert digests[0] == digests[1] and len(digests[0]) == 16


# ---------------------------------------------------------------------------
# Endpoints
# ---------------------------------------------------------------------------


class TestEndpoints:
    def test_serve_audit_endpoint(self):
        from dvf_tpu_torch.obs.export import MetricsExporter

        fe = _serve(sample_every=2)
        ex = None
        try:
            sid = fe.open_stream()
            frame = _rng_frame()
            for _ in range(4):
                fe.submit(sid, frame)
            _drain_session(fe, sid, 4)
            fe.audit.drain(30.0)
            ex = MetricsExporter(fe.registry, port=0,
                                 audit_fn=fe.audit.document).start()
            doc = _get_json(f"{ex.url}/audit")
            assert doc["replays_sampled_total"] >= 1
            assert doc["label"].startswith("serve")
            with urllib.request.urlopen(f"{ex.url}/metrics", timeout=10) as r:
                text = r.read().decode()
            assert "dvf_audit_replays_total" in text
        finally:
            if ex is not None:
                ex.stop()
            fe.stop()

    def test_worker_endpoint_parity_ledger_and_audit(self):
        from dvf_tpu_torch.obs.export import MetricsExporter
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        worker = ZmqWorker(get_filter("invert"), batch_size=2,
                           use_jpeg=False, raw_size=32, audit_wire=True,
                           device="cpu", connect=False)
        ex = None
        try:
            payload = stamp_wire(_rng_frame().tobytes())
            worker.process_batch([(0, payload)], lambda *a: None)
            worker.drain_egress()
            ex = MetricsExporter(worker.registry, port=0,
                                 ledger_fn=worker.ledger.document,
                                 audit_fn=worker.audit_document).start()
            led = _get_json(f"{ex.url}/ledger")
            assert led["by_kind"].get("compile") == 1
            aud = _get_json(f"{ex.url}/audit")
            assert aud["wire_enabled"] is True
            assert aud["wire_hops"][0]["verified_total"] == 1
        finally:
            if ex is not None:
                ex.stop()
            worker.close()

    def test_audit_endpoint_404_when_unarmed(self):
        from dvf_tpu_torch.obs.export import MetricsExporter
        from dvf_tpu_torch.obs.registry import MetricsRegistry

        ex = MetricsExporter(MetricsRegistry(), port=0).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get_json(f"{ex.url}/audit")
            assert ei.value.code == 404
        finally:
            ex.stop()

    def test_audit_off_zero_surface(self):
        fe = _serve(audit=False)
        try:
            sid = fe.open_stream()
            fe.submit(sid, _rng_frame())
            _drain_session(fe, sid, 1)
            assert fe.audit is None
            assert "audit" not in fe.stats()
            assert not any(k.startswith("audit_") for k in fe.signals())
        finally:
            fe.stop()

    def test_document_keys_match_reference(self):
        """The /audit document of an audited frontend has the reference
        frontend's keys, for the same traffic."""
        import dvf_tpu
        from dvf_tpu.serve import ServeConfig as JaxConfig
        from dvf_tpu.serve import ServeFrontend as JaxFrontend

        def keys(fe):
            try:
                sid = fe.open_stream()
                for _ in range(4):
                    fe.submit(sid, _rng_frame())
                _drain_session(fe, sid, 4)
                assert fe.audit.drain(30.0)
                doc = fe.audit.document()
                return (set(doc), doc["replays_sampled_total"],
                        {e["kind"] for e in doc["events"]},
                        set(fe.signals()) & {k for k in fe.signals()
                                             if k.startswith("audit_")})
            finally:
                fe.stop()

        kw = dict(batch_size=2, queue_size=64, slo_ms=60_000.0, audit=True,
                  audit_sample_every=2)
        ours = keys(_serve(sample_every=2))
        ref = keys(JaxFrontend(dvf_tpu.get_filter("invert"),
                               JaxConfig(**kw)).start())
        assert ours == ref


@pytest.mark.fleet
def test_fleet_divergence_and_quarantine():
    """3 local replicas serving one signature: identical probes match; a
    rigged replica is flagged by majority vote and, quarantine armed,
    retired through the scale-in seam."""
    from dvf_tpu_torch.fleet import FleetConfig

    cfg = FleetConfig(
        replicas=3, mode="local", audit_quarantine=True,
        serve=ServeConfig(batch_size=2, queue_size=64, slo_ms=60_000.0))
    fl = FleetFrontend(get_filter("invert"), cfg).start()
    try:
        frame = _rng_frame()
        for i in range(6):
            fl.open_stream(frame_shape=(32, 32, 3), frame_dtype="uint8",
                           session_id=f"s{i}")
        for _ in range(3):
            for i in range(6):
                fl.submit(f"s{i}", frame)
        deadline = time.time() + 30.0
        while time.time() < deadline:
            ev = fl.audit_divergence_check()
            if ev["replicas_probed"] == 3:
                break
            time.sleep(0.2)
        assert ev["verdict"] == "match", ev
        assert ev["replicas_probed"] == 3
        victim = sorted(fl._replicas)[-1]
        fl._replicas[victim].audit_probe = (
            lambda sig=None: {"signature": sig,
                              "digest": "deadbeefdeadbeef"})
        ev = fl.audit_divergence_check()
        assert ev["verdict"] == "mismatch"
        assert ev["divergent"] == [victim]
        st = fl.stats()["audit"]
        assert st["divergences_total"] == 1
        assert st["quarantined_total"] == 1
        assert victim not in fl._replicas  # retired for real
        assert fl.signals()["audit_divergences_total"] == 1.0
    finally:
        fl.stop()
