"""The port's host transport (counterpart of ``tests/test_transport.py``):
the native frame ring (``dvf_tpu_torch/transport/ring.cpp``, the port's
own copy), the cv2 and native JPEG codecs, the ring ingest queue
(``RingFrameQueue``), and the worker on the reference's socket pair over
both of its transports, with its heartbeat/partition path.

Parity with the JAX package: the same seeded push/pop schedule gives
bit-identical payloads, indices, timestamps and evictions from both
rings; both packages attach to each other's shared-memory rings; the raw,
jpeg and delta ring wires carry byte-identical payloads; the two workers
answer the same stream with identical payloads and re-partition the same
number of times with the same backoff delays.
"""

import os
import threading
import time
import uuid

import numpy as np
import pytest

from torch_ring_util import jax_native_isolated  # noqa: F401

from dvf_tpu_torch.transport import FrameRing, JpegCodec


# ---------------------------------------------------------------- ring

def test_ring_fifo_roundtrip():
    ring = FrameRing(capacity_bytes=1 << 16)
    for i in range(5):
        assert ring.push(bytes([i]) * (i + 1), i, 100.0 + i) == 0
    assert len(ring) == 5
    for i in range(5):
        payload, idx, ts = ring.pop()
        assert payload == bytes([i]) * (i + 1)
        assert idx == i
        assert ts == pytest.approx(100.0 + i)
    assert ring.pop() is None
    ring.close()


def test_ring_drop_oldest_on_overflow():
    ring = FrameRing(capacity_bytes=1 << 12)  # 4 KiB
    payload = b"x" * 1000
    drops = [ring.push(payload, i, float(i)) for i in range(8)]
    assert sum(drops) > 0
    got = []
    while (item := ring.pop()) is not None:
        got.append(item[1])
    assert got == sorted(got)
    assert got[-1] == 7
    assert ring.dropped == sum(drops)
    assert ring.pushed == 8
    ring.close()


def test_ring_rejects_oversized_frame():
    ring = FrameRing(capacity_bytes=1 << 10)
    with pytest.raises(ValueError):
        ring.push(b"y" * (1 << 11), 0, 0.0)
    ring.close()
    # Above the pop buffer, the push fails at the producer, not at pop.
    ring = FrameRing(capacity_bytes=1 << 16, max_frame_bytes=64)
    with pytest.raises(ValueError, match="max_frame_bytes"):
        ring.push(b"z" * 65, 0, 0.0)
    assert len(ring) == 0
    ring.close()


def test_ring_use_after_close_is_a_python_error():
    ring = FrameRing(capacity_bytes=1 << 12)
    ring.close()
    ring.close()  # idempotent
    with pytest.raises(ValueError, match="closed"):
        ring.push(b"a", 0, 0.0)
    with pytest.raises(ValueError, match="closed"):
        len(ring)


def test_ring_spsc_threaded():
    ring = FrameRing(capacity_bytes=1 << 20)
    n = 2000
    got = []

    def produce():
        for i in range(n):
            ring.push(i.to_bytes(4, "little"), i, time.time())

    def consume():
        deadline = time.time() + 10
        while len(got) < n and time.time() < deadline:
            item = ring.pop()
            if item is None:
                time.sleep(0.0001)
                continue
            got.append(int.from_bytes(item[0], "little"))

    t1 = threading.Thread(target=produce)
    t2 = threading.Thread(target=consume)
    t1.start(); t2.start(); t1.join(); t2.join()
    assert got == list(range(n))
    assert ring.dropped == 0
    ring.close()


_SHM_CHILD = r"""
import ctypes, sys
lib = ctypes.PyDLL(sys.argv[1])
lib.ring_create_shm.restype = ctypes.c_void_p
lib.ring_create_shm.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
lib.ring_pop.restype = ctypes.c_int64
lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                         ctypes.POINTER(ctypes.c_uint64),
                         ctypes.POINTER(ctypes.c_double)]
lib.ring_destroy.argtypes = [ctypes.c_void_p]
ptr = lib.ring_create_shm(sys.argv[2].encode(), 1 << 16, 0)
buf = ctypes.create_string_buffer(64)
idx, ts = ctypes.c_uint64(), ctypes.c_double()
n = lib.ring_pop(ptr, buf, 64, ctypes.byref(idx), ctypes.byref(ts))
ok = ptr and n == 5 and buf.raw[:5] == b"hello" and idx.value == 42
lib.ring_destroy(ptr)
sys.exit(0 if ok else 1)
"""


def test_ring_shared_memory_cross_process():
    """Another process (a fresh interpreter that loads only the built
    library with ctypes: no fork of this threaded process) attaches to the
    shm ring and consumes the parent's record; the parent waits for it
    with a deadline."""
    import subprocess
    import sys

    from dvf_tpu_torch.transport import _native, ring as ring_mod

    name = f"/dvf_torch_test_{uuid.uuid4().hex[:8]}"
    ring = FrameRing(capacity_bytes=1 << 16, shm_name=name, create=True)
    try:
        ring.push(b"hello", 42, 1.5)
        lib = str(_native.library_path(ring_mod._SRC))
        child = subprocess.run([sys.executable, "-c", _SHM_CHILD, lib, name],
                               capture_output=True, text=True, timeout=60)
        assert child.returncode == 0, child.stderr
        assert ring.pop() is None  # consumed by the child through shm
        assert ring.popped == 1
    finally:
        ring.close()


def test_ring_attach_to_missing_shm_raises():
    with pytest.raises(OSError):
        FrameRing(shm_name=f"/dvf_torch_absent_{uuid.uuid4().hex[:8]}",
                  create=False)


def test_failed_ring_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A ring source that does not compile raises with g++'s output and
    leaves no library (or temp file) behind."""
    from dvf_tpu_torch.transport import _native, ring as ring_mod

    bad = tmp_path / "ring.cpp"
    bad.write_text("#error deliberate failure\n")
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(ring_mod, "_SRC", str(bad))
    monkeypatch.setattr(ring_mod, "_lib", None)
    with pytest.raises(RuntimeError, match="deliberate failure"):
        FrameRing(capacity_bytes=1 << 12)
    assert not list((tmp_path / "_build").glob("*"))


def test_ring_entry_points_default_to_cuda(monkeypatch):
    """With no device, the pipeline over a ring and the worker over the
    ring ask for cuda:0 and raise where there is none."""
    import torch

    import dvf_tpu_torch as dt
    from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = RingFrameQueue((8, 8, 3), capacity_frames=2)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dt.Pipeline(dt.SyntheticSource(8, 8, n_frames=1), dt.get_filter("invert"),
                        dt.NullSink(), queue=q)
    finally:
        q.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.ZmqWorker(dt.get_filter("invert"), transport="ring", connect=False)


def test_make_codec_never_falls_back_to_cv2(monkeypatch):
    """A native shim that cannot be built raises out of make_codec (and
    so out of every wire codec built from it); the cv2 codec is built only
    when a caller asks for it."""
    from dvf_tpu_torch.transport import codec as tc

    def broken():
        raise RuntimeError("jpeg_shim build failed: no libjpeg")

    monkeypatch.setattr(tc, "_load_shim", broken)
    with pytest.raises(RuntimeError, match="jpeg_shim"):
        tc.make_codec()
    with pytest.raises(RuntimeError, match="jpeg_shim"):
        tc.make_wire_codec("delta")
    c = JpegCodec()
    assert c.config()["backend"] == "cv2"
    c.close()


# ------------------------------------------------ ring parity with dvf_tpu

def _schedule(seed: int):
    """A seeded push/pop schedule over a small ring: random payload sizes,
    overflow, bursts of pops."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(400):
        n = int(rng.integers(1, 900))
        ops.append(("push", rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
                    i, float(rng.uniform(0, 1e6))))
        if rng.random() < 0.3:
            ops.append(("pop", int(rng.integers(1, 6))))
    return ops


def _play(ring, ops):
    trace = []
    for op in ops:
        if op[0] == "push":
            trace.append(("evicted", ring.push(op[1], op[2], op[3])))
        else:
            trace.append(("popped", ring.pop_up_to(op[1])))
        trace.append(("len", len(ring), ring.dropped, ring.pushed, ring.popped))
    trace.append(("drain", ring.pop_up_to(10_000)))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_bit_exact_with_jax_package(seed):
    """Payloads, indices, timestamps, eviction counts and counters: the
    port's ring and the JAX package's ring give the same trace."""
    from dvf_tpu.transport.ring import FrameRing as JaxFrameRing

    ops = _schedule(seed)
    a = FrameRing(capacity_bytes=6 << 10, max_frame_bytes=4096)
    b = JaxFrameRing(capacity_bytes=6 << 10, max_frame_bytes=4096)
    try:
        ta, tb = _play(a, ops), _play(b, ops)
        assert ta == tb
        assert a.capacity == b.capacity
        assert sum(t[1] for t in ta if t[0] == "evicted") > 0  # overflowed
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("producer", ["port", "jax"])
def test_ring_shared_memory_across_packages(producer):
    """Both packages' rings share one shared-memory layout: either side
    creates the ring, the other attaches, and the records match."""
    from dvf_tpu.transport.ring import FrameRing as JaxFrameRing

    mk_prod, mk_cons = ((FrameRing, JaxFrameRing) if producer == "port"
                        else (JaxFrameRing, FrameRing))
    name = f"/dvf_torch_x_{uuid.uuid4().hex[:8]}"
    prod = mk_prod(capacity_bytes=1 << 14, shm_name=name, create=True,
                   max_frame_bytes=4096)
    try:
        cons = mk_cons(capacity_bytes=1 << 14, shm_name=name, create=False,
                       max_frame_bytes=4096)
        ops = [op for op in _schedule(5) if op[0] == "push"][:60]
        evicted = [prod.push(p, i, ts) for _, p, i, ts in ops]
        got = cons.pop_up_to(1000)
        survivors = ops[sum(evicted):]
        assert [(p, i, ts) for _, p, i, ts in survivors] == got
        assert cons.dropped == prod.dropped == sum(evicted)
        cons.close()
    finally:
        prod.close()


# --------------------------------------------------------------- codec

def test_jpeg_roundtrip_tolerance(frame_u8):
    codec = JpegCodec(quality=95)
    out = codec.decode(codec.encode(frame_u8))
    assert out.shape == frame_u8.shape and out.dtype == np.uint8
    assert float(np.mean(np.abs(out.astype(int) - frame_u8.astype(int)))) < 6.0
    codec.close()


def test_jpeg_batch_into_staging(frame_u8):
    codec = JpegCodec()
    blobs = codec.encode_batch([frame_u8] * 4)
    out = np.empty((4,) + frame_u8.shape, np.uint8)
    got = codec.decode_batch(blobs, out=out)
    assert got is out
    assert got.shape == (4,) + frame_u8.shape
    codec.close()


def test_cv2_codec_bytes_match_jax_package(frame_u8):
    """The port's cv2 codec is the JAX package's: the same bytes, the same
    decode, the same geometry error, the same provenance keys."""
    from dvf_tpu.transport.codec import JpegCodec as JaxJpegCodec

    a, b = JpegCodec(quality=80, threads=2), JaxJpegCodec(quality=80, threads=2)
    try:
        blobs = a.encode_batch([frame_u8, 255 - frame_u8])
        assert blobs == b.encode_batch([frame_u8, 255 - frame_u8])
        np.testing.assert_array_equal(a.decode_batch(blobs), b.decode_batch(blobs))
        assert a.probe(blobs[0]) == b.probe(blobs[0])
        assert a.config() == b.config()
        wrong = np.zeros((2, 8, 8, 3), np.uint8)
        with pytest.raises(ValueError, match="staging row"):
            a.decode_batch(blobs, out=wrong)
    finally:
        a.close()
        b.close()


@pytest.fixture(scope="module")
def native_codec():
    from dvf_tpu_torch.transport.codec import NativeJpegCodec

    try:
        codec = NativeJpegCodec(quality=95)
    except RuntimeError as e:  # no g++ / libjpeg here
        pytest.skip(f"native jpeg shim unavailable: {e}")
    yield codec
    codec.close()


def test_native_jpeg_roundtrip_and_cv2_interop(native_codec, frame_u8):
    cv2_codec = JpegCodec(quality=95)
    for enc, dec in ((native_codec, cv2_codec), (cv2_codec, native_codec)):
        out = dec.decode(enc.encode(frame_u8))
        assert out.shape == frame_u8.shape and out.dtype == np.uint8
        assert float(np.mean(np.abs(out.astype(int) - frame_u8.astype(int)))) < 6.0
    cv2_codec.close()


def test_native_jpeg_zero_copy_batch_staging(native_codec, frame_u8):
    blobs = [native_codec.encode(frame_u8)] * 6
    staging = np.zeros((6,) + frame_u8.shape, np.uint8)
    got = native_codec.decode_batch(blobs, out=staging)
    assert got is staging
    ref = native_codec.decode(blobs[0])
    for i in range(6):
        assert np.array_equal(staging[i], ref)


def test_native_jpeg_geometry_mismatch_rejected(native_codec, frame_u8):
    blob = native_codec.encode(frame_u8)
    wrong = np.zeros((frame_u8.shape[0] // 2, frame_u8.shape[1], 3), np.uint8)
    with pytest.raises(ValueError, match="staging row"):
        native_codec.decode_into(blob, wrong)


def test_native_jpeg_corrupt_stream_rejected(native_codec):
    with pytest.raises(ValueError):
        native_codec.decode(b"\xff\xd8 not a real jpeg payload")
    with pytest.raises(ValueError):
        native_codec.decode_into(b"\xff\xd8 not a real jpeg payload",
                                 np.zeros((64, 64, 3), np.uint8))


def test_make_codec_is_native_and_never_cv2(native_codec):
    from dvf_tpu_torch.transport.codec import NativeJpegCodec, make_codec

    codec = make_codec()
    try:
        assert isinstance(codec, NativeJpegCodec)
    finally:
        codec.close()


@pytest.mark.parametrize("mode", ["cycle", "pool"])
def test_measure_codec_fps_and_budget_match_the_jax_schema(mode,
                                                          native_codec):
    """The codec-rate probe and the wire budget: the JAX package's
    arithmetic and keys, on this host's rates."""
    from dvf_tpu.transport.codec import jpeg_wire_budget as jax_budget
    from dvf_tpu_torch.transport.codec import (jpeg_wire_budget,
                                               measure_codec_fps)

    enc, dec = measure_codec_fps(32, 48, samples=2, mode=mode, threads=2)
    assert enc > 0 and dec > 0
    with pytest.raises(ValueError, match="mode"):
        measure_codec_fps(32, 48, mode="burst")
    got = jpeg_wire_budget(32, 48, threads=2, expected_dirty_ratio=0.05)
    want = jax_budget(32, 48, threads=2, expected_dirty_ratio=0.05)
    assert set(got) == set(want)
    assert got["codec_workers"] == min(os.cpu_count() or 1, 2)
    assert got["capacity_fps"] == pytest.approx(
        got["codec_workers"] / (1 / got["per_core_encode_fps"]
                                + 1 / got["per_core_decode_fps"]), rel=0.01)
    assert got["wire_mode"] in ("jpeg", "delta")


# -------------------------------------------------------- RingFrameQueue

def _queue_frames(n=24, h=32, w=48, seed=0):
    """Frames with a moving dirty patch (the delta wire sends tiles)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w, 3), np.uint8)
    out = []
    for k in range(n):
        f = base.copy()
        f[(k * 3) % (h - 8):(k * 3) % (h - 8) + 8, 8:24] = rng.integers(
            0, 255, (8, 16, 3), np.uint8)
        out.append(f)
    return out


def _drive_queue(q, frames, pops):
    """Put every frame; pop (and decode) in the given burst sizes in
    between; return the trace of evictions, popped records and decoded
    rows."""
    trace = []
    pops = list(pops)
    for i, f in enumerate(frames):
        trace.append(("put", q.put((i, f, float(i)))))
        if pops and i % 3 == 2:
            items = q.pop_up_to(pops.pop(0))
            staging = np.zeros((len(items),) + q.frame_shape, np.uint8)
            q.decode_into(items, staging)
            trace.append(("pop", [(i, p, ts) for i, p, ts in items],
                          staging.tobytes()))
    items = q.pop_up_to(1000)
    staging = np.zeros((len(items),) + q.frame_shape, np.uint8)
    q.decode_into(items, staging)
    trace.append(("drain", items, staging.tobytes(), q.dropped, q.put_total))
    return trace


@pytest.mark.parametrize("wire", ["raw", "jpeg", "delta"])
def test_ring_queue_wire_bytes_match_jax_package(wire, native_codec):
    """The same frames through both packages' ring queues, with eviction
    (a 4-frame ring): the same evictions, the same payload bytes per
    index (raw, jpeg and delta, forced keyframes included) and the same
    decoded rows."""
    from dvf_tpu.transport.ring_queue import RingFrameQueue as JaxRingFrameQueue
    from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

    frames = _queue_frames()
    kw = dict(capacity_frames=4, wire=wire, codec_threads=1, delta_tile=16,
              delta_keyframe_interval=8)
    pops = [1, 2, 3, 1, 2, 1]
    a = RingFrameQueue(frames[0].shape, **kw)
    b = JaxRingFrameQueue(frames[0].shape, **kw)
    try:
        ta, tb = _drive_queue(a, frames, pops), _drive_queue(b, frames, pops)
        assert ta == tb
        assert a.dropped > 0
        sa, sb = a.wire_stats(), b.wire_stats()
        assert sa["wire"] == sb["wire"] == wire
        if wire == "delta":
            assert sa["encode"] == sb["encode"]
            assert sa["encode"]["keyframes"] >= 2  # forced after eviction
    finally:
        a.close()
        b.close()
    assert a.dropped == b.dropped and a.put_total == b.put_total == len(frames)
    assert len(a) == 0  # closed: counters snapshotted, ring freed


def test_ring_queue_contract():
    from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

    q = RingFrameQueue((8, 8, 3), capacity_frames=2)
    try:
        assert q.wire == "raw" and q.codec is None
        with pytest.raises(ValueError, match="fixed"):
            q.put((0, np.zeros((4, 4, 3), np.uint8), 0.0))
        assert q.put((0, np.zeros((8, 8, 3), np.uint8), 0.0)) is None
        assert len(q) == 1
    finally:
        q.close()
    q.close()  # idempotent
    with pytest.raises(ValueError, match="wire"):
        RingFrameQueue((8, 8, 3), wire="png")
    # The audit envelope: stamped at put, verified and stripped at decode.
    q = RingFrameQueue((8, 8, 3), capacity_frames=2, audit_wire=True)
    try:
        frame = np.arange(192, dtype=np.uint8).reshape(8, 8, 3)
        q.put((0, frame, 0.0))
        staging = np.zeros((1, 8, 8, 3), np.uint8)
        q.decode_into(q.pop_up_to(1), staging)
        assert (staging[0] == frame).all()
        assert q.wire_stats()["audit"]["verified_total"] == 1
    finally:
        q.close()


# ---------------------------------------------------- zmq wire protocol

class MiniApp:
    """App-side harness: ROUTER hands out indexed frames one per READY,
    PULL collects 5-part results — the reference's socket pair."""

    def __init__(self, frames):
        import zmq

        self.ctx = zmq.Context()
        self.router = self.ctx.socket(zmq.ROUTER)
        self.dist_port = self.router.bind_to_random_port("tcp://127.0.0.1")
        self.pull = self.ctx.socket(zmq.PULL)
        self.coll_port = self.pull.bind_to_random_port("tcp://127.0.0.1")
        self.frames = list(enumerate(frames))
        self.results = {}
        self.result_meta = {}

    def serve(self, timeout_s=20.0, n_total=None, quiet_s=None):
        """Until ``n_total`` results arrived, or (``quiet_s``) every frame
        was handed out and no result came for that long."""
        deadline = time.time() + timeout_s
        n_total = len(self.frames) if n_total is None else n_total
        last = (0, time.time())
        while len(self.results) < n_total and time.time() < deadline:
            if quiet_s is not None:
                if len(self.results) != last[0]:
                    last = (len(self.results), time.time())
                elif not self.frames and time.time() - last[1] > quiet_s:
                    break
            if self.router.poll(5):
                client = self.router.recv_multipart()[0]
                if self.frames:
                    idx, blob = self.frames.pop(0)
                    self.router.send_multipart([client, str(idx).encode(), blob])
            if self.pull.poll(5):
                idx_b, pid_b, t0_b, t1_b, payload = self.pull.recv_multipart()
                idx = int(idx_b.decode())
                self.results[idx] = payload
                self.result_meta[idx] = (int(pid_b), float(t0_b), float(t1_b))

    def close(self):
        self.router.close(0)
        self.pull.close(0)
        self.ctx.term()


@pytest.mark.parametrize("transport", ["list", "ring"])
def test_zmq_ingress_serves_reference_protocol(rng, transport):
    pytest.importorskip("zmq")
    from dvf_tpu_torch import get_filter
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    n = 12
    frames = [rng.integers(0, 255, (32, 32, 3), np.uint8) for _ in range(n)]
    app = MiniApp([f.tobytes() for f in frames])
    worker = ZmqWorker(get_filter("invert"), host="127.0.0.1",
                       distribute_port=app.dist_port, collect_port=app.coll_port,
                       batch_size=4, use_jpeg=False, raw_size=32,
                       transport=transport, device="cpu")
    t = threading.Thread(target=worker.run, kwargs={"max_frames": n}, daemon=True)
    t.start()
    app.serve()
    worker.stop()
    t.join(timeout=10)
    assert len(app.results) == n
    for i in range(n):
        out = np.frombuffer(app.results[i], np.uint8).reshape(32, 32, 3)
        np.testing.assert_array_equal(out, 255 - frames[i])
        pid, t0, t1 = app.result_meta[i]
        assert pid > 0 and t1 >= t0
    st = worker.stats()
    assert st["transport"] == transport
    if transport == "ring":
        assert st["ring_dropped"] == 0
        assert worker.signals()["queue_depth"] == 0.0
    else:
        assert worker.signals()["queue_depth"] is None
    worker.close()
    app.close()


@pytest.mark.parametrize("transport", ["list", "ring"])
def test_zmq_ingress_jpeg_geometry_follows_stream(transport, native_codec):
    """JPEG mode stages to the stream's geometry and survives the app
    changing size mid-run (JpegGeometryError → re-probe → retry)."""
    pytest.importorskip("zmq")
    from dvf_tpu_torch import get_filter
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    def smooth(s):
        y, x = np.mgrid[0:s, 0:s]
        return np.stack([(x * 3) % 256, (y * 3) % 256, (x + y) % 256], -1).astype(np.uint8)

    frames = [smooth(48)] * 6 + [smooth(24)] * 6
    blobs = [native_codec.encode(f) for f in frames]
    app = MiniApp(blobs)
    worker = ZmqWorker(get_filter("invert"), host="127.0.0.1",
                       distribute_port=app.dist_port, collect_port=app.coll_port,
                       batch_size=4, use_jpeg=True, assemble_timeout_s=0.05,
                       raw_size=48, transport=transport, device="cpu")
    t = threading.Thread(target=worker.run, kwargs={"max_frames": len(frames)},
                         daemon=True)
    t.start()
    app.serve(timeout_s=15.0, quiet_s=3.0)
    worker.stop()
    t.join(timeout=10)
    # At-most-once: a batch straddling the change mixes sizes and drops.
    assert len(app.results) >= len(frames) - worker.batch_size
    assert worker.errors <= 1
    shapes_seen = set()
    for i, payload in app.results.items():
        out = native_codec.decode(payload)
        f = frames[i]
        assert out.shape == f.shape
        shapes_seen.add(out.shape)
        assert np.abs(out.astype(int) - (255 - f).astype(int)).mean() < 8
    assert shapes_seen == {(48, 48, 3), (24, 24, 3)}
    worker.close()
    app.close()


def _worker_run(kind, blobs, n, **kw):
    """Serve ``blobs`` through the port's worker or the JAX package's;
    returns (results by index, worker stats)."""
    app = MiniApp(blobs)
    common = dict(host="127.0.0.1", distribute_port=app.dist_port,
                  collect_port=app.coll_port, **kw)
    if kind == "port":
        from dvf_tpu_torch import get_filter
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        worker = ZmqWorker(get_filter("invert"), device="cpu", **common)
    else:
        from dvf_tpu.ops import get_filter
        from dvf_tpu.transport.zmq_ingress import TpuZmqWorker

        worker = TpuZmqWorker(get_filter("invert"), **common)
    try:
        t = threading.Thread(target=worker.run, kwargs={"max_frames": n},
                             daemon=True)
        t.start()
        app.serve(timeout_s=30.0)
        worker.stop()
        t.join(timeout=20)
        assert not t.is_alive()
        stats = worker.stats()
    finally:
        worker.close()
        app.close()
    return app.results, stats


def test_worker_ring_payloads_match_list_and_jax_package(native_codec):
    """The delta wire with the device probe, app-side delta frames in:
    the port's worker over the ring gives the payloads it gives over the
    list, byte for byte, and those of the JAX package's worker over its
    ring."""
    pytest.importorskip("zmq")
    from dvf_tpu_torch.transport.codec import DeltaCodec, make_codec

    frames = _queue_frames(n=12, h=32, w=64, seed=3)
    enc = DeltaCodec(make_codec(threads=1), tile=16, keyframe_interval=6)
    blobs = [enc.encode(f) for f in frames]
    enc.close()
    kw = dict(batch_size=4, wire="delta", delta_tile=16, codec_threads=1,
              codec_assist="probe", raw_size=64)
    ring, st = _worker_run("port", blobs, 12, transport="ring", **kw)
    listed, _ = _worker_run("port", blobs, 12, transport="list", **kw)
    jax, _ = _worker_run("jax", blobs, 12, transport="ring", **kw)
    assert sorted(ring) == list(range(12))
    assert ring == listed == jax
    assert st["transport"] == "ring" and st["ring_dropped"] == 0


@pytest.mark.parametrize("inner", ["raw", "jpeg"])
def test_worker_receive_next_batch_ring_matches_list(inner, native_codec):
    """The socket-less drive of the worker's wire (what the card check
    runs): frames staged with receive() into the ring or the list, taken
    with next_batch(), run by process_batch. The same payloads either
    way; the ring counts its records and drops none."""
    from dvf_tpu_torch import get_filter
    from dvf_tpu_torch.transport.codec import DeltaCodec, NativeJpegCodec, RawCodec
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    frames = _queue_frames(n=20, h=32, w=32, seed=4)

    def codec(**kw):
        base = RawCodec(32, 32) if inner == "raw" else NativeJpegCodec(90, threads=1)
        return DeltaCodec(base, tile=16, keyframe_interval=6, **kw)

    app = codec()
    blobs = [app.encode(f) for f in frames]
    app.close()
    out = {}
    for transport in ("ring", "list"):
        w = ZmqWorker(get_filter("invert"), wire="delta", batch_size=8,
                      delta_tile=16, codec_assist="probe", raw_size=32,
                      transport=transport, codec=codec(on_gap="raise"),
                      device="cpu", connect=False)
        sent = []
        for s in range(0, len(blobs), 8):
            for i in range(s, min(s + 8, len(blobs))):
                w.receive(i, blobs[i])
            assert w.backlog() == min(8, len(blobs) - s)
            w.process_batch(w.next_batch(), lambda i, t0, t1, p: sent.append((i, p)))
            assert w.backlog() == 0
        w.drain_egress()
        st = w.stats()
        if transport == "ring":
            assert st["ring_dropped"] == 0 and w._ring.pushed == len(blobs)
        w.close()
        out[transport] = sent
    assert [i for i, _ in out["ring"]] == list(range(len(frames)))
    assert out["ring"] == out["list"]


def test_worker_options_and_planes():
    """The worker's constructor options against the JAX package's: the
    legacy ``use_jpeg`` flag, the tracer lane, the ledger's compile event,
    the signal row with its batch attribution, and the audit document."""
    from dvf_tpu_torch import get_filter
    from dvf_tpu_torch.obs.trace import Tracer
    from dvf_tpu_torch.transport.codec import RawCodec
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    inv = get_filter("invert")
    w = ZmqWorker(inv, device="cpu", connect=False)
    assert w.wire == "jpeg"  # no arguments: the wire it always picked
    w.close()
    w = ZmqWorker(inv, use_jpeg=False, device="cpu", connect=False)
    assert w.wire == "raw" and w.codec is None
    w.close()
    with pytest.raises(TypeError, match="use_jpeg"):  # a wire name there
        ZmqWorker(inv, "localhost", 5555, 5556, 8, 0.01, "raw",
                  device="cpu", connect=False)
    w = ZmqWorker(inv, audit_wire=True, device="cpu", connect=False)
    assert w.audit_document()["wire_enabled"] is True
    w.close()
    with pytest.raises(ValueError, match="transport"):
        ZmqWorker(inv, transport="pipe", device="cpu", connect=False)

    tracer = Tracer(enabled=True, process_name="worker")
    w = ZmqWorker(inv, wire="delta", batch_size=2, raw_size=16,
                  codec=__import__("dvf_tpu_torch").DeltaCodec(
                      RawCodec(16, 16), tile=8),
                  tracer=tracer, device="cpu", connect=False)
    frames = [np.full((16, 16, 3), i, np.uint8) for i in range(4)]
    enc = __import__("dvf_tpu_torch").DeltaCodec(RawCodec(16, 16), tile=8)
    blobs = [enc.encode(f) for f in frames]
    sent = []
    for s in (0, 2):
        w.process_batch([(i, blobs[i]) for i in range(s, s + 2)],
                        lambda i, t0, t1, p: sent.append(i))
    w.drain_egress()
    assert sent == [0, 1, 2, 3]
    names = {e.get("name") for e in tracer.snapshot()["events"]}
    assert {"batch_complete", "egress_encode", "egress_send"} <= names
    st = w.stats()
    assert st["ledger"]["by_kind"] == {"compile": 1}
    sig = w.signals()
    assert sig["frames_total"] == 4.0 and sig["batches_total"] == 2.0
    assert sig["queue_depth"] is None
    assert "dvf_continuity_partitions" in sig
    # Batch attribution rides every batch; no envelope without audit_wire.
    assert {"attr_assemble_h2d_p99_ms", "attr_device_p99_ms",
            "attr_d2h_p99_ms"} <= set(sig)
    assert w.audit_document() == {"label": "worker", "wire_enabled": False,
                                  "wire_hops": [],
                                  "wire_mismatches_total": 0}
    samples = w.registry.collect()
    assert any(s.name == "worker_frames_total" for s in samples)
    w.close()
    enc.close()


# ------------------------------------------------- heartbeat / partition

def _partition_run(kind, hb, frames):
    """Serve 4 frames, go silent until the worker has re-partitioned
    twice, then serve 4 more. Returns (delays drawn, stats, results)."""
    import zmq  # noqa: F401

    app = MiniApp([f.tobytes() for f in frames])
    common = dict(host="127.0.0.1", distribute_port=app.dist_port,
                  collect_port=app.coll_port, batch_size=2, use_jpeg=False,
                  raw_size=16, heartbeat=hb, assemble_timeout_s=0.005)
    if kind == "port":
        from dvf_tpu_torch import get_filter
        from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

        worker = ZmqWorker(get_filter("invert"), device="cpu", **common)
    else:
        from dvf_tpu.ops import get_filter
        from dvf_tpu.transport.zmq_ingress import TpuZmqWorker

        worker = TpuZmqWorker(get_filter("invert"), **common)
    # Compiled before the clock starts: a first-batch compile would hold
    # the loop past the liveness timeout and count as a partition.
    worker.engine.compile((2, 16, 16, 3))
    delays = []
    draw = worker._reconnect.next_delay

    def recorded():
        d = draw()
        delays.append(d)
        return d

    worker._reconnect.next_delay = recorded
    t = threading.Thread(target=worker.run, daemon=True)
    t.start()
    try:
        first, rest = app.frames[:4], app.frames[4:]
        app.frames = first
        app.serve(timeout_s=20.0, n_total=4)
        assert len(app.results) == 4
        deadline = time.time() + 20.0
        while worker.continuity.get("partitions") < 2:
            assert time.time() < deadline, "worker never re-partitioned"
            if app.router.poll(5):
                app.router.recv_multipart()  # silent: READYs unanswered
        app.frames = rest
        app.serve(timeout_s=20.0, n_total=len(frames))
        worker.stop()
        t.join(timeout=10)
        assert not t.is_alive()
        stats = worker.stats()
    finally:
        worker.close()
        app.close()
    return delays, stats, app.results


def test_worker_heartbeat_partition_matches_jax_package(rng):
    """Both workers against an app that goes silent past the heartbeat's
    timeout: each re-partitions twice (a budgeted ``partition`` fault, a
    ledger event, a rebuilt DEALER), reconnects once traffic returns, and
    serves every frame; the backoff delays are the same seeded draws and
    stay inside the shared policy's bounds."""
    pytest.importorskip("zmq")
    from dvf_tpu.resilience.continuity import HeartbeatConfig as JaxHeartbeat
    from dvf_tpu_torch.resilience.continuity import HeartbeatConfig

    cfg = dict(interval_s=0.25, timeout_s=1.0, backoff_base_s=0.05,
               backoff_max_s=0.08, backoff_jitter=0.25)
    frames = [rng.integers(0, 255, (16, 16, 3), np.uint8) for _ in range(8)]
    port = _partition_run("port", HeartbeatConfig(**cfg), frames)
    jax = _partition_run("jax", JaxHeartbeat(**cfg), frames)
    for delays, stats, results in (port, jax):
        assert stats["continuity"]["partitions"] == 2
        assert stats["continuity"]["reconnects"] == 1
        assert stats["faults"]["by_kind"] == {"partition": 2}
        assert stats["ledger"]["by_kind"].get("partition") == 2
        assert sorted(results) == list(range(8))
        for a, d in enumerate(delays):
            base = min(cfg["backoff_max_s"], cfg["backoff_base_s"] * 2 ** a)
            assert base * (1 - cfg["backoff_jitter"]) <= d
            assert d <= base * (1 + cfg["backoff_jitter"])
    assert port[0] == jax[0]  # the same seeded draws
    for i in range(8):
        assert port[2][i] == jax[2][i] == (255 - frames[i]).tobytes()


# ------------------------------------------- ring property test (hypothesis)

try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False


if _HAVE_HYPOTHESIS:
    @given(payload_sizes=st.lists(st.integers(1, 600), min_size=1, max_size=80),
           capacity_kb=st.integers(1, 4),
           pop_every=st.integers(1, 8))
    @settings(max_examples=150, deadline=None)
    def test_ring_conservation_and_order_under_random_schedules(
            payload_sizes, capacity_kb, pop_every):
        """pushed == popped + dropped + still queued; consumed indices
        strictly increase (drop-oldest never reorders); every surviving
        payload is intact byte for byte; the newest record survives."""
        ring = FrameRing(capacity_bytes=capacity_kb << 10)
        try:
            popped = []
            for i, n in enumerate(payload_sizes):
                ring.push(bytes([i % 256]) * n, i, float(i))
                if (i + 1) % pop_every == 0:
                    item = ring.pop()
                    if item is not None:
                        popped.append(item)
            while (item := ring.pop()) is not None:
                popped.append(item)
            assert len(ring) == 0
            assert ring.pushed == len(payload_sizes)
            assert ring.pushed == len(popped) + ring.dropped
            indices = [idx for _, idx, _ in popped]
            assert indices == sorted(indices)
            assert len(indices) == len(set(indices))
            for payload, idx, ts in popped:
                assert payload == bytes([idx % 256]) * payload_sizes[idx]
                assert ts == float(idx)
            assert indices and indices[-1] == len(payload_sizes) - 1
        finally:
            ring.close()
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_ring_conservation_and_order_under_random_schedules():
        pass
