"""The port's multi-process engine and the fleet's multi-host replica
(``dvf_tpu_torch.fleet.multiproc``, ``fleet.multihost``,
``fleet._mh_worker``) held to the reference's: counterparts of
tests/test_fleet_multiproc.py (two processes in a torch gloo group on the
CPU: per-process ingest rows, one program, per-process egress rows; the
single-process egress stitching and dedupe) and of tests/test_elastic.py's
TestMultiHostFlavor (spawn, serve and retire through the fleet), with the
rows held to the JAX package's ``MultiHostEngine`` on the same frames
(invert bit-exact, gaussian_blur within 1 LSB), the per-submit lockstep
``all_reduce`` pinned, and a peer killed inside a serving group."""

import json
import textwrap
import time

import numpy as np
import pytest
import torch

import dvf_tpu
from dvf_tpu.fleet.multiproc import MultiHostEngine as RefMultiHostEngine
from dvf_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from dvf_tpu_torch.fleet import FleetConfig, MultiHostEngine, MultiHostReplica
from dvf_tpu_torch.fleet.replica import HEALTHY
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.parallel.mesh import MeshConfig
from dvf_tpu_torch.serve import ServeConfig
from torch_mp_util import run_group
from torch_serve_util import (  # noqa: F401
    FleetFrontend,
    port_fleet_guard,
    port_leak_guard,
)

pytestmark = pytest.mark.fleet

CPU = torch.device("cpu")

WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    pid, port = int(sys.argv[1]), sys.argv[2]
    from dvf_tpu_torch.fleet.multiproc import MultiHostEngine
    from dvf_tpu_torch.ops import get_filter
    from dvf_tpu_torch.parallel.distributed import all_reduce, init_distributed
    from dvf_tpu_torch.parallel.mesh import MeshConfig

    assert init_distributed(f"127.0.0.1:{port}", 2, pid, device="cpu")
    calls = []
    real = dist.all_reduce
    dist.all_reduce = lambda t, *a, **k: calls.append(t.numel()) or real(t, *a, **k)

    engine = MultiHostEngine(get_filter("invert"), MeshConfig(data=2))
    assert engine.process_count == 2 and engine.process_index == pid
    engine.compile((4, 8, 8, 3))
    # Per-process ingest share: half the global batch each.
    assert engine.local_batch_size == 2, engine.local_batch_size
    assert engine.intervals == {0: [(0, 2)], 1: [(2, 4)]}, engine.intervals
    n0 = len(calls)
    for step in range(3):
        local = np.full((2, 8, 8, 3), 10 * (pid + 1) + step, np.uint8)
        out = engine.submit_local(local)
        assert out.shape == (2, 8, 8, 3), out.shape
        np.testing.assert_array_equal(out, 255 - local)
    assert engine.stats.batches == 3
    assert engine.stats.local_frames == 6
    # The lockstep: one one-element all_reduce per submit_local.
    assert calls[n0:] == [1, 1, 1], calls
    # A cross-process reduce over the last result: both processes ran
    # ONE group (per-process math alone could fake the asserts above).
    part = torch.tensor([float((255 - local.astype(np.float64)).sum())])
    gsum = float(all_reduce(part, engine.mesh))
    want = float(sum((255 - (10 * (h + 1) + 2)) * 2 * 8 * 8 * 3 for h in (0, 1)))
    assert gsum == want, (gsum, want)
    print(f"fleet-multiproc ok pid={pid} gsum={gsum}", flush=True)
    sys.stdout.flush()
    os._exit(0)
    """
)


def test_two_process_multihost_engine_bringup(tmp_path):
    script = tmp_path / "fleet_mh_worker.py"
    script.write_text(WORKER)
    for pid, (rc, out) in enumerate(run_group(script, 2)):
        assert rc == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"fleet-multiproc ok pid={pid}" in out


ROWS_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np

    pid, port, name, kw, src, dst = sys.argv[1:7]
    pid = int(pid)
    from dvf_tpu_torch.fleet.multiproc import MultiHostEngine
    from dvf_tpu_torch.ops import get_filter
    from dvf_tpu_torch.parallel.distributed import init_distributed
    from dvf_tpu_torch.parallel.mesh import MeshConfig

    assert init_distributed(f"127.0.0.1:{port}", 2, pid, device="cpu")
    x = np.load(src)
    engine = MultiHostEngine(get_filter(name, **json.loads(kw)), MeshConfig(data=2))
    engine.compile(x.shape)
    rows = np.concatenate([x[a:b] for a, b in engine.intervals[pid]])
    np.save(dst.format(pid), engine.submit_local(rows))
    print(json.dumps(engine.intervals[pid]), flush=True)
    os._exit(0)
    """
)


@pytest.mark.parametrize("name,kw,tol", [("invert", {}, 0),
                                         ("gaussian_blur", {"ksize": 5}, 1)],
                         ids=["invert", "gaussian_blur"])
def test_multihost_engine_rows_match_the_reference(tmp_path, name, kw, tol):
    """Each process's rows of one global batch equal the JAX package's
    MultiHostEngine on the same frames (one process over its 8 virtual
    devices, data=2): invert bit for bit, gaussian_blur within 1 LSB."""
    x = np.random.default_rng(11).integers(0, 255, (4, 24, 32, 3), np.uint8)
    src = tmp_path / "x.npy"
    np.save(src, x)
    script = tmp_path / "rows_worker.py"
    script.write_text(ROWS_WORKER)
    dst = str(tmp_path / "rows{}.npy")
    res = run_group(script, 2, name, json.dumps(kw), src, dst)
    ref = RefMultiHostEngine(dvf_tpu.get_filter(name, **kw), RefMeshConfig(data=2))
    ref.compile(x.shape)
    want = ref.submit_local(x)
    for pid, (rc, out) in enumerate(res):
        assert rc == 0, f"proc {pid} failed:\n{out[-3000:]}"
        intervals = json.loads(out.strip().splitlines()[-1])
        assert intervals == [[2 * pid, 2 * pid + 2]]
        got = np.load(dst.format(pid))
        exp = np.concatenate([want[a:b] for a, b in intervals])
        assert got.shape == exp.shape
        err = np.abs(got.astype(int) - exp.astype(int)).max()
        assert err <= tol, (pid, err)


def test_local_output_rows_space_sharded_single_process():
    """Egress stitching: an H-sharded ('space' axis) output comes back as
    whole rows in order, as the reference's does."""
    x = np.arange(4 * 16 * 8 * 3, dtype=np.uint8).reshape(4, 16, 8, 3)
    e = MultiHostEngine(get_filter("invert"), MeshConfig(data=2, space=2),
                        devices=[CPU] * 4)
    e.compile((4, 16, 8, 3))
    assert e.local_batch_size == 4  # single process: all rows local
    out = e.submit_local(x)
    ref = RefMultiHostEngine(dvf_tpu.get_filter("invert"),
                             RefMeshConfig(data=2, space=2))
    ref.compile((4, 16, 8, 3))
    np.testing.assert_array_equal(out, ref.submit_local(x))
    np.testing.assert_array_equal(out, 255 - x)


def test_local_output_rows_replicated_dedupes():
    """A replicated layout (several positions holding the same rows)
    returns each row exactly once."""
    e = MultiHostEngine(get_filter("invert"), MeshConfig(data=2),
                        devices=[CPU] * 2)
    # Batch 3 does not divide the 2-way data axis: batch_pspec replicates.
    e.compile((3, 8, 8, 3))
    assert e.intervals == {0: [(0, 3)]}
    x = np.random.default_rng(0).integers(0, 255, (3, 8, 8, 3), np.uint8)
    out = e.submit_local(x)
    assert out.shape == x.shape, out.shape
    np.testing.assert_array_equal(out, 255 - x)


def test_multihost_engine_errors_are_the_references():
    with pytest.raises(ValueError, match="stateful"):
        MultiHostEngine(get_filter("flow_warp"), devices=[CPU])
    with pytest.raises(ValueError, match="stateful"):
        RefMultiHostEngine(dvf_tpu.get_filter("flow_warp"))
    e = MultiHostEngine(get_filter("invert"), MeshConfig(data=2), devices=[CPU] * 2)
    with pytest.raises(ValueError, match="compile"):
        e.submit_local(np.zeros((2, 8, 8, 3), np.uint8))
    e.compile((2, 8, 8, 3))
    with pytest.raises(ValueError, match="does not match"):
        e.submit_local(np.zeros((1, 8, 8, 3), np.uint8))
    # Without a device list the mesh is the visible cards: none here.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiHostEngine(get_filter("invert"))


# ------------------------------------------- the bigger-replica flavor

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


def _poll_until(fleet, sid, got: list, n: int, deadline_s: float = 60.0):
    deadline = time.time() + deadline_s
    while len(got) < n and time.time() < deadline:
        got.extend(fleet.poll(sid))
        time.sleep(0.01)


class TestMultiHostFlavor:
    def test_multihost_spawn_serve_and_retire(self):
        """spawn_replica(flavor='multihost') brings up a 2-process gloo
        group serving ONE program behind the standard replica RPC:
        declared opens route to it (warm for the manifest signature),
        frames come back bit-exact and ordered through the fleet index
        space, and retire_replica drains it back onto the single-process
        replica."""
        manifest = [{"op_chain": "invert", "frame_shape": [H, W, 3],
                     "dtype": "u8"}]
        fleet = FleetFrontend(
            get_filter("invert"),
            FleetConfig(replicas=1, mode="local",
                        serve=serve_cfg(max_sessions=8),
                        multihost_hosts=2, precompile=manifest,
                        drain_timeout_s=20.0))
        with fleet:
            assert fleet.elastic_view()["multihost_available"] is True
            fleet.open_stream(op_chain="invert", frame_shape=(H, W, 3))
            rid = fleet.spawn_replica(flavor="multihost")
            assert isinstance(fleet._replicas[rid], MultiHostReplica)
            sig = f"invert|{H}x{W}x3|uint8"
            assert sig in fleet._replicas[rid].health()["warm_signatures"]
            sid = fleet.open_stream(op_chain="invert",
                                    frame_shape=(H, W, 3),
                                    frame_dtype="u8")
            assert fleet.stats()["sessions"][sid]["replica"] == rid
            for j in range(6):
                fleet.submit(sid, tagged_frame(5, j))
            got = []
            _poll_until(fleet, sid, got, 6)
            assert [d.index for d in got] == list(range(6))
            for d in got:
                np.testing.assert_array_equal(
                    d.frame, 255 - tagged_frame(5, d.index))
            row = fleet.stats()["replicas"][rid]
            assert row["state"] == HEALTHY
            assert row["engine_frames"] >= 6
            assert fleet._replicas[rid].stats_full()["stats"]["hosts"] == 2
            # Retire the group: the session drains back to r0 and keeps
            # serving.
            assert fleet.retire_replica(rid) is True
            for j in range(6, 9):
                fleet.submit(sid, tagged_frame(5, j))
            _poll_until(fleet, sid, got, 9)
            idxs = [d.index for d in got]
            assert idxs == sorted(set(idxs))
            assert idxs[:6] == list(range(6))
            assert idxs[-1] >= 6
            st = fleet.stats()
        assert st["order_violations"] == 0
        assert rid not in st["replicas"]

    def test_unconfigured_multihost_falls_back_to_default_flavor(self):
        """Without a manifest the flavor has no signature to pin: the
        view says unavailable and a multihost spawn is the default
        flavor, as in the reference."""
        fleet = FleetFrontend(get_filter("invert"),
                              FleetConfig(replicas=1, mode="local",
                                          serve=serve_cfg(), multihost_hosts=2))
        with fleet:
            assert fleet.elastic_view()["multihost_available"] is False
            rid = fleet.spawn_replica(flavor="multihost")
            assert not isinstance(fleet._replicas[rid], MultiHostReplica)

    def test_peer_loss_marks_the_leader_unhealthy(self):
        """A member of the group dies: the leader's next batch fails on
        the dead peer, the leader reports itself unhealthy with the
        error marked as a peer loss, and the replica is not alive (the
        group lives and dies as a unit)."""
        rep = MultiHostReplica("r9", op_chain="invert", frame_shape=(H, W, 3),
                               hosts=2, batch_size=2, device="cpu",
                               startup_timeout_s=120.0)
        try:
            rep.start()
            assert rep.health()["ok"] is True
            rep._group[1].kill()
            rep._group[1].wait(timeout=30)
            assert rep.alive() is False
            sid = rep.open_stream("s0", frame_shape=(H, W, 3))
            for j in range(4):
                rep.submit(sid, tagged_frame(1, j))
            deadline = time.time() + 60
            h = rep.health()
            while h["ok"] and time.time() < deadline:
                time.sleep(0.05)
                h = rep.health()
            assert h["ok"] is False
            assert "[peer loss]" in h["error"], h["error"]
        finally:
            rep.kill()
            rep.stop(timeout=5.0)
