"""The port's ZMQ worker over a sharded batch: ``ZmqWorker(engine=
Engine(filt, mesh=m))`` on ``[cpu] * 8`` meshes (data=2; data=2, space=2;
data=8) with the delta wire's codec assist, probe and fused, at 64×64
batch 8. Its wire bytes equal the port's one-device worker's and the JAX
package's ``TpuZmqWorker`` over the same mesh on its 8 virtual CPU
devices; the probe and the fused transform run their kernels once per
block and come back in global row order. Where the blocks split H off
the tile grid, the batch is assembled on the mesh's first device and
runs once (a divergence of the port, pinned here)."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch as dt
from dvf_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from dvf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from dvf_tpu.runtime.engine import Engine as RefEngine
from dvf_tpu_torch.ops import kernels as tk
from dvf_tpu_torch.parallel.mesh import MeshConfig, batch_sharding, make_mesh
from dvf_tpu_torch.parallel.sharded import shard_batch
from dvf_tpu_torch.runtime.codec_assist import DeviceDeltaProbe, FusedDeltaTransform
from dvf_tpu_torch.runtime.engine import Engine
from dvf_tpu_torch.transport.codec import DeltaCodec, NativeJpegCodec

CPU8 = [torch.device("cpu")] * 8
HW, BATCH, N, TILE = 64, 8, 24, 16
MESHES = [dict(data=2), dict(data=2, space=2), dict(data=8)]


def _ids(axes):
    return ",".join(f"{k}={v}" for k, v in axes.items())


def _stream():
    """Smooth frames with a moving patch (JPEG-friendly content: the fused
    transform's coefficients have no rounding ties against the JAX
    golden on it, tests/test_torch_worker.py)."""
    y, x = np.mgrid[0:HW, 0:HW].astype(np.float32)
    base = np.stack([(x * 3) % 256, (y * 2) % 256, (x + y) % 256], -1).astype(np.uint8)
    out = [base.copy()]
    for k in range(1, N):
        f = out[-1].copy()
        f[8:40, 16:48] = np.stack([((x + 5 * k) % 256)[8:40, 16:48],
                                   ((y + 3 * k) % 256)[8:40, 16:48],
                                   ((x * 2 + k) % 256)[8:40, 16:48]], -1).astype(np.uint8)
        out.append(f)
    return out


@pytest.fixture(scope="module")
def blobs():
    enc = DeltaCodec(NativeJpegCodec(90, threads=1), tile=TILE, keyframe_interval=8)
    try:
        return [enc.encode(f) for f in _stream()]
    finally:
        enc.close()


COMMON = dict(batch_size=BATCH, wire="delta", delta_tile=TILE,
              delta_keyframe_interval=8, codec_threads=1)


def _port(blobs, assist, axes=None):
    """The port's worker, batch step by hand: payloads in send order and
    the worker's stats."""
    f = dt.get_filter("invert")
    eng = (Engine(f, mesh=make_mesh(MeshConfig(**axes), devices=CPU8)) if axes
           else Engine(f, device="cpu"))
    w = dt.ZmqWorker(f, engine=eng, device="cpu", codec_assist=assist,
                     connect=False, **COMMON)
    got = []
    try:
        for s in range(0, N, BATCH):
            w.process_batch(list(enumerate(blobs))[s:s + BATCH],
                            lambda i, t0, t1, p: got.append((i, p)))
        w.drain_egress()
        stats = w.stats()
    finally:
        w.close()
    return got, stats


def _ref(blobs, assist, axes):
    """The JAX worker over its mesh on the 8 virtual CPU devices, over
    localhost: payloads by index."""
    zmq = pytest.importorskip("zmq")
    from dvf_tpu.transport.zmq_ingress import TpuZmqWorker

    ctx = zmq.Context()
    router, pull = ctx.socket(zmq.ROUTER), ctx.socket(zmq.PULL)
    dist_port = router.bind_to_random_port("tcp://127.0.0.1")
    coll_port = pull.bind_to_random_port("tcp://127.0.0.1")
    f = dvf_tpu.get_filter("invert")
    worker = TpuZmqWorker(f, engine=RefEngine(f, mesh=ref_make_mesh(RefMeshConfig(**axes))),
                          host="127.0.0.1", distribute_port=dist_port,
                          collect_port=coll_port, codec_assist=assist,
                          assemble_timeout_s=60.0, **COMMON)
    pending, results = list(enumerate(blobs)), {}
    t = threading.Thread(target=worker.run, kwargs={"max_frames": N}, daemon=True)
    try:
        t.start()
        deadline = time.time() + 60
        while len(results) < N and time.time() < deadline:
            if router.poll(5):
                client = router.recv_multipart()[0]
                if pending:
                    idx, blob = pending.pop(0)
                    router.send_multipart([client, str(idx).encode(), blob])
            if pull.poll(5):
                idx_b, *_mid, payload = pull.recv_multipart()
                results[int(idx_b.decode())] = payload
        worker.stop()
        t.join(timeout=20)
        assert not t.is_alive()
        assert worker.stats()["errors"] == 0
    finally:
        worker.close()
        router.close(0)
        pull.close(0)
        ctx.term()
    return results


@pytest.mark.parametrize("assist", ["probe", "full"])
@pytest.mark.parametrize("axes", MESHES, ids=_ids)
def test_worker_over_a_mesh_sends_the_one_device_bytes(blobs, axes, assist):
    one, s1 = _port(blobs, assist)
    got, sm = _port(blobs, assist, axes)
    assert [i for i, _ in got] == list(range(N))
    assert sm["errors"] == 0 and s1["errors"] == 0
    assert [p for _, p in got] == [p for _, p in one]
    assert sm["delta"]["keyframes"] == s1["delta"]["keyframes"]
    if assist == "full":
        assert sm["delta"]["fused_dispatches"] == N // BATCH
    ref = _ref(blobs, assist, axes)
    assert sorted(ref) == list(range(N))
    assert [p for _, p in got] == [ref[i] for i in range(N)]


def _batches(n_batches, shape, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.integers(0, 255, shape, np.uint8)
        x[:, : shape[1] // 2] = 7   # clean tiles in the top half
        out.append(torch.from_numpy(x))
    return out


@pytest.mark.parametrize("axes", MESHES + [dict(data=2, space=4)], ids=_ids)
def test_probe_and_fused_per_block_equal_the_whole_batch(axes):
    """Bitmaps and coefficient frames from a ShardedBatch equal the whole
    batch's, across batches (row 0 of each data block diffs against the
    previous block's last row, row 0 of a batch against the last batch);
    the kernels run once per block where the blocks tile the frame, and
    once on the mesh's first device where they do not (space=4 of H 64
    at tile 32: 16-row blocks)."""
    m = make_mesh(MeshConfig(**axes), devices=CPU8)
    shape = (BATCH, HW, HW, 3)
    pw, pm = DeviceDeltaProbe(32), DeviceDeltaProbe(32)
    fw, fm = FusedDeltaTransform(32), FusedDeltaTransform(32)
    calls = []
    real = (tk.tile_maxdiff, tk.dct8x8_quant_planes)
    import dvf_tpu_torch.runtime.codec_assist as ca

    for x in _batches(3, shape, 5):
        sb = shard_batch(x, batch_sharding(m, shape))
        want_bm = pw.bitmaps(x)
        want_fbm, want_f = fw.process(x)
        ca.tile_maxdiff = lambda a, b, t: calls.append(("k5", a.shape)) or real[0](a, b, t)
        ca.dct8x8_quant_planes = (lambda p, q: calls.append(("k6", p[0].shape))
                                  or real[1](p, q))
        try:
            got_bm = pm.bitmaps(sb)
            got_fbm, got_f = fm.process(sb)
        finally:
            ca.tile_maxdiff, ca.dct8x8_quant_planes = real
        np.testing.assert_array_equal(got_bm, want_bm)
        np.testing.assert_array_equal(got_fbm, want_fbm)
        for a, b in zip(got_f, want_f):
            for p, q in ((a.yq, b.yq), (a.cbq, b.cbq), (a.crq, b.crq)):
                assert torch.equal(p, q)
    per_block = (HW // m.axis_size("space")) % 32 == 0
    n_blocks = len(sb.shards) if per_block else 1
    assert [k for k, _ in calls].count("k5") == 3 * 2 * n_blocks
    assert [k for k, _ in calls].count("k6") == 3 * n_blocks
    rows = BATCH // m.axis_size("data") if per_block else BATCH
    assert all(s[0] == rows for _, s in calls)
