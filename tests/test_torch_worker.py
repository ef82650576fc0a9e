"""The port's ZMQ worker (``ZmqWorker(device="cpu")``) against the JAX
package's ``TpuZmqWorker`` over localhost, on the temporal-delta wire:
the same app-side stream in, the result payloads compared per index.

With ``codec_assist`` "none" and "probe" the payloads are byte-identical.
With "full" the coefficient path differs only where the fused transform's
K6 coefficients differ (the JAX golden's CPU ties, see
tests/test_torch_codec.py): the test states how many payloads differ and
holds every decoded result to the coefficient wire's one-generation bound
against the expected frame.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from dvf_tpu.ops import get_filter as jax_filter
from dvf_tpu.transport.codec import _DELTA_FLAG_KEY, _DELTA_HEADER
from dvf_tpu.transport.codec import DeltaCodec, make_codec

import dvf_tpu_torch


def _mini_app(frames_blobs):
    """A copy of tests/test_delta_wire.py's app: ROUTER hands out one blob
    per READY in order, PULL collects the results."""
    import zmq

    class MiniApp:
        def __init__(self, blobs):
            self.ctx = zmq.Context()
            self.router = self.ctx.socket(zmq.ROUTER)
            self.dist_port = self.router.bind_to_random_port("tcp://127.0.0.1")
            self.pull = self.ctx.socket(zmq.PULL)
            self.coll_port = self.pull.bind_to_random_port("tcp://127.0.0.1")
            self.blobs = list(enumerate(blobs))
            self.results = {}

        def serve(self, n_expect, timeout_s=60.0, quiet_s=None):
            deadline = time.time() + timeout_s
            last_progress = time.time()
            last_n = -1
            while len(self.results) < n_expect and time.time() < deadline:
                if self.router.poll(5):
                    client, _ = self.router.recv_multipart()[:2]
                    if self.blobs:
                        idx, blob = self.blobs.pop(0)
                        self.router.send_multipart([client, str(idx).encode(), blob])
                if self.pull.poll(5):
                    idx_b, *_mid, payload = self.pull.recv_multipart()
                    self.results[int(idx_b.decode())] = payload
                if quiet_s is not None:
                    if len(self.results) != last_n:
                        last_n = len(self.results)
                        last_progress = time.time()
                    elif not self.blobs and time.time() - last_progress > quiet_s:
                        break

        def close(self):
            self.router.close(0)
            self.pull.close(0)
            self.ctx.term()

    return MiniApp(frames_blobs)


def _smooth_stream(n, h=32, w=64):
    """Smooth gradient frames with a moving smooth patch (JPEG-friendly, so
    decode bounds measure the path, not content entropy)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([(x * 3) % 256, (y * 2) % 256, (x + y) % 256], -1).astype(np.uint8)
    out = [base.copy()]
    for k in range(1, n):
        f = out[-1].copy()
        f[8:24, 16:48] = np.stack([((x + 5 * k) % 256)[8:24, 16:48],
                                   ((y + 3 * k) % 256)[8:24, 16:48],
                                   ((x * 2 + k) % 256)[8:24, 16:48]], -1).astype(np.uint8)
        out.append(f)
    return out


def _noise_stream(rng, n, h=32, w=64):
    base = rng.integers(0, 255, (h, w, 3), np.uint8)
    out = [base.copy()]
    for _ in range(1, n):
        f = out[-1].copy()
        f[16:32, 16:48] = rng.integers(0, 255, (16, 32, 3), np.uint8)
        out.append(f)
    return out


def _run(kind, blobs, n, quiet_s=None, **kw):
    """Serve ``blobs`` (``[(index, payload)]``) through one worker; returns
    (results by index, stats)."""
    pytest.importorskip("zmq")
    app = _mini_app([])
    app.blobs = list(blobs)
    common = dict(host="127.0.0.1", distribute_port=app.dist_port,
                  collect_port=app.coll_port, batch_size=4, wire="delta",
                  delta_tile=16, codec_threads=1, **kw)
    if kind == "port":
        worker = dvf_tpu_torch.ZmqWorker(dvf_tpu_torch.get_filter("invert"),
                                         device="cpu", **common)
    else:
        from dvf_tpu.transport.zmq_ingress import TpuZmqWorker

        worker = TpuZmqWorker(jax_filter("invert"), **common)
    try:
        t = threading.Thread(target=worker.run, kwargs={"max_frames": n}, daemon=True)
        t.start()
        app.serve(n_expect=n, timeout_s=30.0, quiet_s=quiet_s)
        worker.stop()
        t.join(timeout=20)
        assert not t.is_alive()
        stats = worker.stats()
    finally:
        worker.close()
        app.close()
    return dict(app.results), stats


def _app_codecs(interval):
    enc = DeltaCodec(make_codec(threads=1), tile=16, keyframe_interval=interval)
    dec = DeltaCodec(make_codec(threads=1), tile=16)
    return enc, dec


def _decode_in_wire_order(results, codec):
    by_seq = sorted(results.items(), key=lambda kv: _DELTA_HEADER.unpack_from(kv[1])[3])
    return {i: codec.decode(b) for i, b in by_seq}


@pytest.mark.parametrize("assist", ["none", "probe"])
def test_worker_payloads_byte_identical(assist):
    n = 8
    frames = _noise_stream(np.random.default_rng(0), n)
    enc, dec = _app_codecs(8)
    try:
        blobs = list(enumerate(enc.encode(f) for f in frames))
        port, ps = _run("port", blobs, n, delta_keyframe_interval=8, codec_assist=assist)
        ref, rs = _run("ref", blobs, n, delta_keyframe_interval=8, codec_assist=assist)
    finally:
        enc.close()
    try:
        assert ps["errors"] == 0 and rs["errors"] == 0
        assert sorted(port) == sorted(ref) == list(range(n))
        for i in range(n):
            assert port[i] == ref[i], i
        assert ps["delta"]["device_probe"] is (assist == "probe")
        assert ps["delta"]["dirty_ratio"] == rs["delta"]["dirty_ratio"]
        assert ps["delta"]["keyframes"] == rs["delta"]["keyframes"]
        got = _decode_in_wire_order(port, dec)
        for i in range(n):
            assert got[i].shape == (32, 64, 3)
    finally:
        dec.close()


# Payloads of the "full" leg that differ from the reference's: the fused
# transform's K6 coefficients at the JAX golden's CPU rounding ties.
_FULL_DIFFERING = 0


def test_worker_full_assist_matches_reference():
    n = 8
    frames = _smooth_stream(n)
    enc, dec = _app_codecs(8)
    try:
        blobs = list(enumerate(enc.encode(f) for f in frames))
        inputs = _decode_in_wire_order(dict(blobs), dec)   # what the workers see
        port, ps = _run("port", blobs, n, delta_keyframe_interval=8, codec_assist="full")
        ref, rs = _run("ref", blobs, n, delta_keyframe_interval=8, codec_assist="full")
    finally:
        enc.close()
        dec.close()
    d = ps["delta"]
    assert ps["errors"] == 0 and rs["errors"] == 0
    assert d["assist"] == "full-transform" and d["fused_transform"] is True
    assert d["fused_dispatches"] == ps["batches"]
    assert d["coef_frames"] == ps["frames_processed"] == n
    assert ps["egress"]["entropy_ms"] > 0
    assert sorted(port) == sorted(ref) == list(range(n))
    differing = sum(port[i] != ref[i] for i in range(n))
    assert differing == _FULL_DIFFERING
    pdec = DeltaCodec(make_codec(threads=1), tile=16)
    try:
        got = _decode_in_wire_order(port, pdec)
    finally:
        pdec.close()
    for i in range(n):
        err = np.abs(got[i].astype(int) - (255 - inputs[i]).astype(int))
        # one 4:2:0 q90 JPEG generation on smooth content
        # (tests/test_delta_wire.py's coefficient-wire bound)
        assert err.max() <= 32 and err.mean() < 2.0


def test_dropped_delta_frame_contained_and_recovers():
    """The app drops one encoded delta frame: the worker contains the gap
    as a transport fault, drops to the next keyframe, and serves
    everything from it onward."""
    n = 12
    frames = _noise_stream(np.random.default_rng(1), n)
    enc, dec = _app_codecs(4)
    try:
        blobs = [enc.encode(f) for f in frames]
        served = [(i, b) for i, b in enumerate(blobs) if i != 2]
        results, stats = _run("port", served, n - 1, quiet_s=1.5,
                              delta_keyframe_interval=4)
        assert stats["faults"]["by_kind"].get("transport", 0) >= 1
        # keyframes at 0, 5, 10 (interval 4): everything from the first
        # keyframe after the gap is served
        assert {10, 11} <= set(results)
        decoded = _decode_in_wire_order(results, dec)
        plain = make_codec(threads=1)
        try:
            result10 = 255 - plain.decode(plain.encode(frames[10]))
            if _DELTA_HEADER.unpack_from(results[10])[2] & _DELTA_FLAG_KEY:
                assert np.array_equal(decoded[10], plain.decode(plain.encode(result10)))
            else:
                assert np.array_equal(decoded[10][16:32, 16:48], result10[16:32, 16:48])
        finally:
            plain.close()
    finally:
        enc.close()
        dec.close()


def test_batch_step_without_sockets():
    """``connect=False``: no zmq, the batch step driven by hand with a send
    callable; results come out in order and equal the socket worker's."""
    n = 8
    frames = _noise_stream(np.random.default_rng(2), n)
    enc, dec = _app_codecs(8)
    got = []
    worker = dvf_tpu_torch.ZmqWorker(dvf_tpu_torch.get_filter("invert"), device="cpu",
                                     batch_size=4, wire="delta", delta_tile=16,
                                     delta_keyframe_interval=8, codec_threads=1,
                                     codec_assist="probe", connect=False)
    try:
        blobs = [enc.encode(f) for f in frames]
        for s in (0, 4):
            worker.process_batch(list(enumerate(blobs))[s:s + 4],
                                 lambda i, t0, t1, p: got.append((i, p)))
        worker.drain_egress()
        assert [i for i, _ in got] == list(range(n))
        sock, _ = _run("port", list(enumerate(blobs)), n, delta_keyframe_interval=8,
                       codec_assist="probe")
        assert [p for _, p in got] == [sock[i] for i in range(n)]
        with pytest.raises(RuntimeError, match="no sockets"):
            worker.run()
        s = worker.stats()
        assert s["batches"] == 2 and s["delta"]["device_probe"]
    finally:
        worker.close()
        enc.close()
        dec.close()
