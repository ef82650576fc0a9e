"""Chaos matrix on the port (counterpart of ``tests/test_chaos.py``'s
serve and worker classes): the port's ``ServeFrontend`` on the CPU under
seeded, event-indexed fault plans, and the port's worker under decode
corruption.

Where the reference test compares against a value (the non-faulted
session against a fault-free run), the port is held to the JAX package's
fault-free run on the same frames.
"""

import threading
import time

import numpy as np
import pytest

import dvf_tpu
from dvf_tpu.serve import ServeConfig as JaxServeConfig
from dvf_tpu.serve import ServeFrontend as JaxServeFrontend
from dvf_tpu_torch import get_filter
from dvf_tpu_torch.resilience import FaultKind, FaultPlan
from dvf_tpu_torch.serve import ServeConfig, ServeError
from torch_serve_util import ServeFrontend, port_leak_guard  # noqa: F401

H, W = 16, 24

pytestmark = pytest.mark.chaos


def tagged_frame(session_no: int, frame_no: int) -> np.ndarray:
    f = np.full((H, W, 3), 11, np.uint8)
    f[0] = session_no
    f[1] = frame_no % 251
    return f


def _drive_sync(fe, sid, frame, deadline_s=30.0):
    """Submit one frame and wait for it to resolve (delivered or failed):
    each batch carries exactly one frame, so chaos event indices map 1:1
    onto submitted frames."""
    s = fe._session(sid)
    before = s.delivered + s.failed
    fe.submit(sid, frame)
    deadline = time.time() + deadline_s
    while s.delivered + s.failed < before + 1:
        assert time.time() < deadline, "serve path deadlocked"
        time.sleep(0.002)


def _run_two_session_matrix(frontend, config, chaos, n_each=6, mesh=None):
    """Alternate frames A,B,A,B… with one frame per batch; poll
    everything; return (deliveries_by_sid, stats, sids). ``mesh``: the
    port's engine spans it."""
    filt = (get_filter("invert") if frontend is ServeFrontend
            else dvf_tpu.get_filter("invert"))
    engine = None
    if mesh is not None:
        from dvf_tpu_torch.runtime.engine import Engine

        engine = Engine(filt, mesh=mesh)
    fe = frontend(filt,
                  config(batch_size=8, queue_size=1000, slo_ms=60_000.0,
                         stall_timeout_s=0.0, chaos=chaos),
                  **({"engine": engine} if engine is not None else {}))
    deliveries = {}
    with fe:
        a, b = fe.open_stream(), fe.open_stream()
        for j in range(n_each):
            _drive_sync(fe, a, tagged_frame(0, j))
            _drive_sync(fe, b, tagged_frame(1, j))
        for sid in (a, b):
            deliveries[sid] = fe.poll(sid)
        stats = fe.stats()
    return deliveries, stats, (a, b)


@pytest.fixture(scope="module")
def jax_fault_free():
    """The JAX frontend's fault-free run: session A's deliveries."""
    ref, stats, (ra, _rb) = _run_two_session_matrix(
        JaxServeFrontend, JaxServeConfig, None)
    assert stats["faults"]["by_kind"] == {}
    return ref[ra]


class TestServeChaosMatrix:
    """Each engine-path FaultKind injected into the port's serve path:
    exact counts, no deadlock, the non-faulted session bit-identical to
    the JAX package's fault-free run.

    Event math: one frame per batch, streams alternate A,B,A,B…, so batch
    2j is A's frame j and 2j+1 is B's frame j. The rules fault B's frames
    0, 1 and 2 and never touch A."""

    def _check(self, kind, chaos_builder, jax_ref, mesh=None):
        got, stats, (a, b) = _run_two_session_matrix(
            ServeFrontend, ServeConfig, chaos_builder(), mesh=mesh)
        assert stats["faults"]["by_kind"] == {kind: 3}
        assert stats["errors"] == 3
        sess = stats["sessions"]
        assert sess[b]["faults"] == {kind: 3}
        assert sess[b]["failed"] == 3
        assert sess[b]["delivered"] == 3
        assert sess[a]["faults"] == {}
        assert sess[a]["delivered"] == 6
        assert [d.index for d in got[a]] == [d.index for d in jax_ref]
        for d_got, d_ref in zip(got[a], jax_ref):
            np.testing.assert_array_equal(d_got.frame, d_ref.frame)
        for sid in (a, b):
            idx = [d.index for d in got[sid]]
            assert idx == sorted(idx) and len(set(idx)) == len(idx)

    def test_compute_faults(self, jax_fault_free):
        self._check(FaultKind.COMPUTE,
                    lambda: FaultPlan().add("compute", at=(1, 3, 5)),
                    jax_fault_free)

    def test_oom_faults(self, jax_fault_free):
        self._check(FaultKind.OOM,
                    lambda: FaultPlan().add("oom", at=(1, 3, 5)),
                    jax_fault_free)

    def test_h2d_faults(self, monkeypatch, jax_fault_free):
        import dvf_tpu_torch.runtime.ingest as ingest_mod

        monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
        # The event indices differ from the reference's (8 * (1, 3, 5)):
        # the reference streams a batch of 8 as one row chunk per device
        # of its 8-way data mesh, 8 h2d events per batch; the port has one
        # device and streams the batch in ingest_depth = 4 row chunks, 4
        # h2d events per batch. Batches 1, 3 and 5 are B's frames 0–2.
        self._check(FaultKind.H2D,
                    lambda: FaultPlan().add("h2d", at=(4 * 1, 4 * 3, 4 * 5)),
                    jax_fault_free)

    def test_h2d_faults_over_an_8_way_data_mesh(self, monkeypatch,
                                                jax_fault_free):
        """The reference's own case: over an 8-way data mesh (here eight
        virtual devices) a batch of 8 streams as one 1-row chunk per
        device, 8 h2d events per batch, so B's frames 0–2 are events 8,
        24 and 40."""
        import torch

        import dvf_tpu_torch.runtime.ingest as ingest_mod
        from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh

        monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
        mesh = make_mesh(MeshConfig(data=8), devices=[torch.device("cpu")] * 8)
        self._check(FaultKind.H2D,
                    lambda: FaultPlan().add("h2d", at=(8 * 1, 8 * 3, 8 * 5)),
                    jax_fault_free, mesh=mesh)


class TestServeSupervision:
    def test_stall_watchdog_recovers_frozen_collect(self):
        """A frozen collect thread wedges the in-flight window; the
        watchdog trips, sheds the window, rebuilds the engine and replaces
        the consumer — the session survives and later frames flow, indices
        monotone across the recovery."""
        chaos = FaultPlan().add("freeze", at=(3,), delay_s=1.5)
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=4, queue_size=1000, slo_ms=60_000.0,
                        stall_timeout_s=0.35, chaos=chaos))
        deliveries = []
        with fe:
            sid = fe.open_stream()
            s = fe._session(sid)
            i = 0
            deadline = time.time() + 20.0
            while fe.recoveries < 1:
                assert time.time() < deadline, "watchdog never tripped"
                fe.submit(sid, tagged_frame(0, i))
                i += 1
                deliveries.extend(fe.poll(sid))
                time.sleep(0.01)
            delivered_before = s.delivered
            deadline = time.time() + 20.0
            while s.delivered <= delivered_before:
                assert time.time() < deadline, "no delivery after recovery"
                fe.submit(sid, tagged_frame(0, i))
                i += 1
                deliveries.extend(fe.poll(sid))
                time.sleep(0.01)
            deliveries.extend(fe.poll(sid))
            stats = fe.stats()

        assert stats["recoveries"] >= 1
        assert stats["faults"]["by_kind"].get("stall", 0) >= 1
        assert stats["sessions"][sid]["state"] == "open"
        idx = [d.index for d in deliveries]
        assert idx == sorted(idx) and len(set(idx)) == len(idx), (
            "frame indices regressed across supervisor recovery")
        assert stats["sessions"][sid]["failed"] >= 1
        for d in deliveries:
            np.testing.assert_array_equal(d.frame, 255 - tagged_frame(0, d.index))
        assert fe._error is None

    def test_engine_death_recovery_sessions_survive(self):
        """Forced engine death: repeated compute faults overflow the
        budget once → the supervised rebuild replaces the broken program;
        the open session survives with monotone indices. The live engine's
        step is replaced on the instance, as in the reference: the rebuild
        must adopt the successor's program, not keep the broken one."""
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=4, queue_size=1000, slo_ms=60_000.0,
                        stall_timeout_s=0.0, fault_budget=2))
        deliveries = []
        with fe:
            sid = fe.open_stream()
            for j in range(2):  # healthy warm-up
                _drive_sync(fe, sid, tagged_frame(0, j))

            def dead_step(*a, **k):
                raise RuntimeError("engine died (forced)")

            fe.engine._step = dead_step
            # Faults 1 and 2 are contained; the 3rd overflows the budget
            # and triggers the rebuild, whose program works.
            for j in range(2, 5):
                _drive_sync(fe, sid, tagged_frame(0, j))
            deadline = time.time() + 10.0
            while fe.recoveries < 1:
                assert time.time() < deadline, "rebuild never happened"
                time.sleep(0.002)
            assert fe.recoveries == 1
            assert fe.engine._step is not dead_step
            _drive_sync(fe, sid, tagged_frame(0, 5))  # rebuilt engine serves
            deliveries.extend(fe.poll(sid))
            stats = fe.stats()

        sess = stats["sessions"][sid]
        assert stats["faults"]["by_kind"] == {"compute": 3}
        assert sess["faults"] == {"compute": 3}
        assert sess["delivered"] == 3  # frames 0, 1 and 5
        idx = [d.index for d in deliveries]
        assert idx == [0, 1, 5]
        for d in deliveries:
            np.testing.assert_array_equal(d.frame, 255 - tagged_frame(0, d.index))
        assert fe._error is None

    def test_permanently_broken_engine_surfaces_serve_error(self):
        """An engine that still faults after its rebuild exhausts the
        budget ladder and surfaces ServeError instead of serving 0 fps
        silently."""
        chaos = FaultPlan().add("compute", every=1)
        fe = ServeFrontend(
            get_filter("invert"),
            ServeConfig(batch_size=4, queue_size=1000, slo_ms=60_000.0,
                        stall_timeout_s=0.0, fault_budget=2, chaos=chaos))
        fe.start()
        try:
            sid = fe.open_stream()
            s = fe._session(sid)
            deadline = time.time() + 30.0
            with pytest.raises(ServeError, match="budget exhausted"):
                while True:
                    assert time.time() < deadline, "never escalated"
                    before = s.delivered + s.failed
                    fe.submit(sid, tagged_frame(0, 0))
                    while (s.delivered + s.failed < before + 1
                           and fe._error is None):
                        assert time.time() < deadline
                        time.sleep(0.002)
            assert fe.recoveries == 1
            assert isinstance(fe._error, ServeError)
        finally:
            with pytest.raises(ServeError):
                fe.stop()


def test_engine_commit_swap_adopts_the_successor_program():
    """The engine-level fault under the supervision case: a forced
    rebuild (prepare_swap(force=True) + commit_swap) replaces an
    instance override of the step with the successor's program and
    leaves the successor shell without one."""
    from torch_serve_util import Engine

    eng = Engine(get_filter("invert"))
    x = np.arange(2 * 4 * 6 * 3, dtype=np.uint8).reshape(2, 4, 6, 3)
    eng.compile(x.shape)

    def dead_step(*a, **k):
        raise RuntimeError("engine died (forced)")

    eng._step = dead_step
    with pytest.raises(RuntimeError, match="died"):
        eng.submit(x).fetch()
    eng.prepare_swap(x.shape, np.uint8, force=True)
    succ = eng._staged
    eng.commit_swap(migrate_state=False)
    assert eng._step is not dead_step and succ._step is None
    np.testing.assert_array_equal(eng.submit(x).fetch(), 255 - x)
    eng.free()
    assert eng._step is None


class TestWorkerChaos:
    """decode FaultKind on its natural path: the port's ZMQ worker."""

    @pytest.fixture
    def app(self):
        pytest.importorskip("zmq")
        import zmq

        class _App:
            def __init__(self):
                self.ctx = zmq.Context()
                self.router = self.ctx.socket(zmq.ROUTER)
                self.dist_port = self.router.bind_to_random_port(
                    "tcp://127.0.0.1")
                self.pull = self.ctx.socket(zmq.PULL)
                self.coll_port = self.pull.bind_to_random_port(
                    "tcp://127.0.0.1")

            def close(self):
                self.router.close(0)
                self.pull.close(0)
                self.ctx.term()

        a = _App()
        yield a
        a.close()

    def test_decode_corruption_counted_and_contained(self, app):
        from dvf_tpu_torch.transport.codec import make_codec
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        rng = np.random.default_rng(0)
        codec = make_codec()
        frames = [rng.integers(0, 255, (16, 16, 3), np.uint8)
                  for _ in range(6)]
        payloads = codec.encode_batch(frames)
        codec.close()
        # Decode events count per blob in arrival order however batches
        # split, so event 3 is always frame 3's decode. A corrupt JPEG
        # drops its whole batch, so which other frame is lost depends on
        # the split: the flush timer outlasts the test, so the worker
        # always batches the pairs (0, 1), (2, 3), (4, 5), whatever the
        # arrival times (a frame 1 that arrived after the default 10 ms
        # timer shipped frame 0 alone and paired 3 with 4:
        # test_decode_corruption_drops_its_batch_however_it_splits).
        chaos = FaultPlan().add("decode", at=(3,))
        worker = ZmqWorker(
            get_filter("invert"), host="127.0.0.1",
            distribute_port=app.dist_port, collect_port=app.coll_port,
            batch_size=2, use_jpeg=True, chaos=chaos, device="cpu",
            assemble_timeout_s=60.0)
        t = threading.Thread(target=worker.run, daemon=True)
        t.start()
        sent, results = 0, {}
        deadline = time.time() + 30.0

        def done(r):
            return {0, 1, 4, 5} <= set(r) and worker.faults.count("decode") == 1

        while not done(results) and time.time() < deadline:
            if sent < len(payloads) and app.router.poll(5):
                client = app.router.recv_multipart()[0]
                app.router.send_multipart(
                    [client, str(sent).encode(), payloads[sent]])
                sent += 1
            if app.pull.poll(5):
                parts = app.pull.recv_multipart()
                results[int(parts[0])] = parts[4]
        worker.stop()
        t.join(timeout=10)
        worker.close()
        assert done(results), "timed out before the expected frames landed"
        # Frame 3 (the corrupted blob) is always lost; frame 2 only when it
        # shared frame 3's batch. Everything else serves.
        assert 3 not in results
        assert worker.faults.summary()["by_kind"] == {"decode": 1}
        assert worker.errors == 1

    @pytest.mark.parametrize("split,lost", [
        ([[0, 1], [2, 3], [4, 5]], {2, 3}),
        ([[0], [1, 2], [3, 4], [5]], {3, 4}),
        ([[0], [1], [2], [3], [4], [5]], {3}),
    ])
    def test_decode_corruption_drops_its_batch_however_it_splits(
            self, split, lost):
        """The batch step without sockets, at each way the socket loop
        may split six frames into batches of at most two: the corrupt
        frame 3 takes exactly its own batch down (the reference's
        contract: a corrupt JPEG drops the batch), counted once; every
        other frame is served, inverted. A frame 1 that reaches the
        worker after its flush timer ships frame 0 alone and pairs 3
        with 4 (the second split), which a socket test expecting frame
        4 can then never see."""
        from dvf_tpu_torch.transport.codec import make_codec
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        rng = np.random.default_rng(0)
        codec = make_codec()
        frames = [rng.integers(0, 255, (16, 16, 3), np.uint8)
                  for _ in range(6)]
        payloads = codec.encode_batch(frames)
        worker = ZmqWorker(get_filter("invert"), batch_size=2, use_jpeg=True,
                           chaos=FaultPlan().add("decode", at=(3,)),
                           device="cpu", connect=False)
        got = {}
        try:
            for part in split:
                worker.process_batch(
                    [(i, payloads[i]) for i in part],
                    lambda i, t0, t1, p: got.__setitem__(i, p))
            worker.drain_egress()
            served = {i: codec.decode(p).astype(np.float64)
                      for i, p in got.items()}
            want = [255.0 - codec.decode(p) for p in payloads]
        finally:
            worker.close()
            codec.close()
        assert set(got) == set(range(6)) - lost
        assert worker.faults.summary()["by_kind"] == {"decode": 1}
        assert worker.errors == 1
        for i, out in served.items():
            # Each payload is frame i inverted (through one more JPEG
            # round trip of noise): nearest its own inverted input.
            dist = [np.abs(out - w).mean() for w in want]
            assert int(np.argmin(dist)) == i, dist

    def test_close_releases_the_workers_slabs(self):
        """close() releases the worker's staging and delivery slabs at
        once, while the worker object is still referenced."""
        import gc

        from dvf_tpu_torch.runtime import egress, ingest
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        # Collect what earlier modules left for the collector (a
        # test_torch_stream.py pipeline's slabs wait in a reference
        # cycle): the checks below are process-wide, and no collection
        # runs between close() and them.
        gc.collect()
        assert ingest.occupied_slab_bytes() == 0
        assert egress.occupied_slab_bytes() == 0
        worker = ZmqWorker(get_filter("invert"), batch_size=2,
                           use_jpeg=False, raw_size=16, device="cpu",
                           connect=False)
        frame = np.full((16, 16, 3), 9, np.uint8)
        got = []
        worker.process_batch([(0, frame.tobytes()), (1, frame.tobytes())],
                             lambda i, t0, t1, p: got.append(i))
        worker.drain_egress()
        assert got == [0, 1]
        assert worker._asm is not None and worker._asm.slab_bytes() > 0
        asm, fetcher = worker._asm, worker._fetcher
        worker.close()
        assert asm.slab_bytes() == 0
        assert fetcher is None or fetcher.slab_bytes() == 0
        assert worker._asm is None and worker._fetcher is None
        del asm, fetcher
        assert ingest.occupied_slab_bytes() == 0
        assert egress.occupied_slab_bytes() == 0
