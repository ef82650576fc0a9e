"""The port's worker survives what the reference survives (counterpart of
``tests/test_resilience.py``'s worker and shm-source cases): idle gaps
with silently consumed READYs (distributor.py:226-244), malformed
messages, poison frames, a pad-unsafe stateful filter, a mid-stream
geometry change, the ``delay_s`` knob, and a shared-memory producer that
dies without its end-of-stream sentinel. Each worker case runs on both
``transport="list"`` and ``transport="ring"``."""

import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

pytest.importorskip("zmq")

TRANSPORTS = ["list", "ring"]


class _Sockets:
    """App-side ROUTER + PULL pair on random ports."""

    def __init__(self):
        import zmq

        self.ctx = zmq.Context()
        self.router = self.ctx.socket(zmq.ROUTER)
        self.dist_port = self.router.bind_to_random_port("tcp://127.0.0.1")
        self.pull = self.ctx.socket(zmq.PULL)
        self.coll_port = self.pull.bind_to_random_port("tcp://127.0.0.1")

    def close(self):
        self.router.close(0)
        self.pull.close(0)
        self.ctx.term()


@pytest.fixture
def app():
    a = _Sockets()
    yield a
    a.close()


def _mk_worker(app, **kw):
    from dvf_tpu_torch import get_filter
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    defaults = dict(host="127.0.0.1", distribute_port=app.dist_port,
                    collect_port=app.coll_port, batch_size=4,
                    use_jpeg=False, raw_size=16, device="cpu")
    defaults.update(kw)
    return ZmqWorker(get_filter("invert"), **defaults)


def _serve(app, frames_by_index, want, deadline_s=15.0, meta=False):
    """Answer READYs with the given (index → payload) frames in order and
    collect results until ``want`` of them arrived."""
    pending = list(frames_by_index.items())
    results = {}
    deadline = time.time() + deadline_s
    while len(results) < want and time.time() < deadline:
        if pending and app.router.poll(5):
            client = app.router.recv_multipart()[0]
            idx, payload = pending.pop(0)
            app.router.send_multipart([client, str(idx).encode(), payload])
        if app.pull.poll(5):
            parts = app.pull.recv_multipart()
            results[int(parts[0])] = ((float(parts[2]), float(parts[3]), parts[4])
                                      if meta else parts[4])
    return results


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_credit_expiry_survives_silent_ready_consumption(app, rng, transport):
    """The distributor consumes a READY and replies nothing whenever it
    has no fresh frame: credits must expire and be re-issued, or the
    worker deadlocks after one idle gap."""
    worker = _mk_worker(app, transport=transport)
    t = threading.Thread(target=worker.run, kwargs={"max_frames": 4}, daemon=True)
    t.start()
    deadline = time.time() + 0.3
    consumed = 0
    while time.time() < deadline:
        if app.router.poll(10):
            app.router.recv_multipart()
            consumed += 1
    assert consumed >= 4  # the whole initial credit window was eaten
    frames = [rng.integers(0, 255, (16, 16, 3), np.uint8) for _ in range(4)]
    results = _serve(app, {i: f.tobytes() for i, f in enumerate(frames)}, 4)
    worker.stop()
    t.join(timeout=5)
    assert len(results) == 4, "worker deadlocked after silent READY consumption"
    for i in range(4):
        out = np.frombuffer(results[i], np.uint8).reshape(16, 16, 3)
        np.testing.assert_array_equal(out, 255 - frames[i])
    worker.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_worker_survives_malformed_and_poison_messages(app, rng, transport):
    """A malformed message or an undecodable frame is dropped and
    counted; the worker keeps serving (worker.py:71-76)."""
    worker = _mk_worker(app, transport=transport)
    t = threading.Thread(target=worker.run, kwargs={"max_frames": 8}, daemon=True)
    t.start()

    def await_ready(timeout=10.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if app.router.poll(10):
                return app.router.recv_multipart()[0]
        raise TimeoutError("worker never sent READY")

    client = await_ready()
    app.router.send_multipart([client, b"a", b"b", b"c"])
    client = await_ready()
    app.router.send_multipart([client, b"notanint", b"payload"])
    client = await_ready()
    app.router.send_multipart([client, b"0", b"short"])  # poison payload
    time.sleep(0.1)  # > assemble_timeout_s: the poison batch flushes alone
    frames = [rng.integers(0, 255, (16, 16, 3), np.uint8) for _ in range(8)]
    results = _serve(app, {10 + i: f.tobytes() for i, f in enumerate(frames)}, 8)
    worker.stop()
    t.join(timeout=5)
    assert len(results) == 8, "worker died after malformed/poison input"
    for i in range(8):
        out = np.frombuffer(results[10 + i], np.uint8).reshape(16, 16, 3)
        np.testing.assert_array_equal(out, 255 - frames[i])
    assert worker.errors >= 3
    worker.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_worker_delay_fault_injection(app, rng, transport):
    """``delay_s`` (the reference's --delay, inverter.py:37-38,55-56):
    injected latency slows batches down without breaking the protocol, and
    shows in the worker's self-reported span (worker.py:47,59)."""
    worker = _mk_worker(app, delay_s=0.05, batch_size=2, transport=transport)
    t = threading.Thread(target=worker.run, kwargs={"max_frames": 2}, daemon=True)
    t.start()
    frames = [rng.integers(0, 255, (16, 16, 3), np.uint8) for _ in range(2)]
    results = _serve(app, {i: f.tobytes() for i, f in enumerate(frames)}, 2,
                     meta=True)
    worker.stop()
    t.join(timeout=5)
    assert len(results) == 2
    t_start, t_end, payload = results[0]
    assert t_end - t_start >= 0.05
    np.testing.assert_array_equal(
        np.frombuffer(payload, np.uint8).reshape(16, 16, 3), 255 - frames[0])
    worker.close()


def test_stateful_pad_unsafe_filter_rejected(app):
    """A stateful filter that is not pad-safe is refused (repeat-last
    padding would corrupt its temporal state)."""
    from dvf_tpu_torch.api.filter import Filter
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    running_mean = Filter(
        name="running_mean",
        fn=lambda b, s: (b, s + b.float().mean()),
        init_state=lambda shape, dtype, device: torch.zeros((), device=device),
        pad_safe=False)
    with pytest.raises(ValueError, match="pad-safe"):
        ZmqWorker(running_mean, host="127.0.0.1",
                  distribute_port=app.dist_port, collect_port=app.coll_port,
                  device="cpu")


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_geometry_reprobe_releases_slabs_and_counts_fault(app, rng, transport):
    """A mid-stream geometry change: the worker re-probes and keeps
    serving; the abandoned assembler's slabs are released eagerly and the
    event lands under the ``geometry`` fault kind, not as an error."""
    from dvf_tpu_torch.transport.codec import make_codec

    worker = _mk_worker(app, use_jpeg=True, batch_size=2, transport=transport)
    codec = make_codec()
    small = [rng.integers(0, 255, (16, 16, 3), np.uint8) for _ in range(2)]
    large = [rng.integers(0, 255, (24, 24, 3), np.uint8) for _ in range(2)]
    payloads = codec.encode_batch(small) + codec.encode_batch(large)
    t = threading.Thread(target=worker.run, kwargs={"max_frames": 4}, daemon=True)
    t.start()
    results = _serve(app, {0: payloads[0], 1: payloads[1]}, 2, deadline_s=30)
    assert len(results) == 2
    old_asm = worker._asm
    results.update(_serve(app, {2: payloads[2], 3: payloads[3]}, 2,
                          deadline_s=30))
    worker.stop()
    t.join(timeout=10)
    assert sorted(results) == [0, 1, 2, 3], "re-probe lost frames"
    assert worker.faults.summary()["by_kind"] == {"geometry": 1}
    assert worker.errors == 0
    assert old_asm is not None and old_asm is not worker._asm
    assert old_asm._chunks == [] and old_asm._host is None
    assert worker._asm.batch_shape == (2, 24, 24, 3)
    for i, frame in enumerate(small + large):
        assert codec.probe(results[i]) == frame.shape[:2]
    codec.close()
    worker.close()


def test_shm_ring_source_detects_producer_death():
    """ShmRingSource: a producer that dies without pushing the end
    sentinel ends the stream by the idle timeout — served frames intact,
    no hang."""
    from dvf_tpu_torch.io import ShmRingSource
    from dvf_tpu_torch.transport import FrameRing

    name = f"dvf_torch_pdeath_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    frame = (np.arange(16 * 16 * 3, dtype=np.uint32) % 251).astype(np.uint8)
    frame = frame.reshape(16, 16, 3)
    ring = FrameRing(capacity_bytes=1 << 20, shm_name=name, create=True,
                     max_frame_bytes=16 * 16 * 3 + 64)
    try:
        ring.push(frame.tobytes(), 0, time.time())
        src = ShmRingSource(name, (16, 16, 3), attach_timeout_s=5.0,
                            idle_timeout_s=0.3)
        got = []
        t0 = time.time()
        for f, _ts in src:
            if f is None:
                break
            got.append(np.array(f))
        wall = time.time() - t0
        assert len(got) == 1
        np.testing.assert_array_equal(got[0], frame)
        assert wall < 5.0, "producer-death detection hung"
    finally:
        ring.close()


def test_shm_ring_source_sentinel_geometry_and_attach_timeout():
    """The end sentinel ends the stream; a geometry mismatch raises with
    the fix; no producer raises after the attach timeout."""
    from dvf_tpu_torch.io import ShmRingSource
    from dvf_tpu_torch.transport import FrameRing

    name = f"dvf_torch_sentinel_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    ring = FrameRing(capacity_bytes=1 << 20, shm_name=name, create=True,
                     max_frame_bytes=1 << 16)
    try:
        frames = [np.full((8, 8, 3), i, np.uint8) for i in range(3)]
        for i, f in enumerate(frames):
            ring.push(f.tobytes(), i, float(i))
        ring.push(b"\0", 3, 3.0)  # end-of-stream sentinel
        got = [(f, ts) for f, ts in ShmRingSource(name, (8, 8, 3),
                                                  idle_timeout_s=5.0)]
        assert got[-1][0] is None
        assert [ts for _, ts in got[:-1]] == [0.0, 1.0, 2.0]
        for (f, _), want in zip(got, frames):
            np.testing.assert_array_equal(f, want)
        ring.push(np.zeros((12, 12, 3), np.uint8).tobytes(), 4, 4.0)
        with pytest.raises(ValueError, match=r"12x12"):
            list(ShmRingSource(name, (8, 8, 3), idle_timeout_s=5.0))
    finally:
        ring.close()
    with pytest.raises(TimeoutError, match="no producer"):
        list(ShmRingSource(f"dvf_torch_absent_{uuid.uuid4().hex[:8]}",
                           (8, 8, 3), attach_timeout_s=0.1))
