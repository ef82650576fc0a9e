"""The port's multi-process runtime (``dvf_tpu_torch.parallel.distributed``)
held to the reference's: counterparts of tests/test_distributed.py (two
processes joined in a torch gloo group on the CPU, the global 4-frame
invert and its sum; a rank killed mid-stream and the survivor's degrade),
the peer-loss classification, ``init_distributed`` without a coordinator
and with torchrun's environment, and ``local_output_rows`` /
``host_local_batch`` against the JAX functions on the reference's 8
virtual CPU devices (counterparts of tests/test_fleet_multiproc.py's
single-process cases)."""

import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import dvf_tpu.parallel.distributed as ref_dist
from dvf_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from dvf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from dvf_tpu_torch.parallel import distributed as D
from dvf_tpu_torch.parallel.mesh import MeshConfig
from torch_mp_util import ROOT, child_env, run_group

CPU8 = [torch.device("cpu")] * 8

WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch

    pid, port = int(sys.argv[1]), sys.argv[2]
    from dvf_tpu_torch.ops import get_filter
    from dvf_tpu_torch.parallel.distributed import (
        all_reduce, global_mesh, host_local_batch, init_distributed)
    from dvf_tpu_torch.parallel.mesh import MeshConfig

    assert init_distributed(f"127.0.0.1:{port}", 2, pid, device="cpu")
    mesh = global_mesh(MeshConfig(data=2))
    assert mesh.process_count == 2 and mesh.process_id == pid
    assert len(mesh.distinct_devices()) == 1   # this process's one device
    # Each process contributes its own 2 frames of the global 4-frame batch.
    local = np.full((2, 8, 8, 3), 10 * (pid + 1), np.uint8)
    batch = host_local_batch(mesh, local)
    assert tuple(batch.shape) == (4, 8, 8, 3), batch.shape
    assert [b.index[0] for b in batch.blocks] == [slice(2 * pid, 2 * pid + 2)]

    f = get_filter("invert")
    out = batch.map(lambda t: f.fn(t, None)[0])
    part = sum(t.to(torch.float32).sum() for t in out.shards).reshape(1)
    total = all_reduce(part, mesh)
    want = ((255 - 10) + (255 - 20)) * 2 * 8 * 8 * 3
    assert float(total) == want, (float(total), want)
    print(f"dist-smoke ok pid={pid} sum={float(total)}", flush=True)
    sys.stdout.flush()
    os._exit(0)
    """
)


def test_two_process_distributed_mesh(tmp_path):
    script = tmp_path / "dist_worker.py"
    script.write_text(WORKER)
    for pid, (rc, out) in enumerate(run_group(script, 2)):
        assert rc == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"dist-smoke ok pid={pid}" in out


ELASTIC_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch

    pid, port = int(sys.argv[1]), sys.argv[2]
    from dvf_tpu_torch.parallel.distributed import (
        ElasticMeshRunner, all_reduce, init_distributed)
    from dvf_tpu_torch.parallel.mesh import MeshConfig

    assert init_distributed(f"127.0.0.1:{port}", 2, pid, device="cpu")

    def builder(mesh):
        def step(batch, state):
            out = batch.map(lambda t: 255 - t)
            # The global sum is a cross-process all_reduce every batch —
            # the collective that detects peer loss.
            part = sum(t.to(torch.float32).sum() for t in batch.shards)
            total = all_reduce(part.reshape(1), mesh)
            return out, {"count": state["count"] + 1,
                         "total": state["total"] + total}
        return step

    state0 = {"count": torch.zeros((), dtype=torch.int32),
              "total": torch.zeros(1)}
    runner = ElasticMeshRunner(builder, state0, MeshConfig(data=2))

    for step_i in range(8):
        if pid == 1 and step_i == 3:
            os._exit(42)   # abrupt process death, mid-stream
        local = np.full((2, 8, 8, 3), pid + step_i, np.uint8)
        out = runner.submit_local(local)
        shard_shape = out.sharding.shard_shape(out.shape)
        print(f"[{pid}] step {step_i} gshape={tuple(out.shape)} "
              f"lshape={shard_shape} degraded={runner.degraded}", flush=True)
        np.testing.assert_array_equal(
            np.concatenate([t.numpy() for t in out.shards]), 255 - local)

    if pid == 0:
        count = int(runner.state["count"])
        assert runner.degraded, "survivor never degraded"
        assert runner.dropped_on_loss == 1
        # Filter state carried across the mesh swap: 8 committed batches,
        # no reset (the failed attempt re-ran on the local mesh).
        assert count == 8, count
        print(f"elastic-smoke ok pid=0 count={count} degraded={runner.degraded}",
              flush=True)
    # A group with a dead peer can hang in its shutdown: exit hard.
    sys.stdout.flush()
    os._exit(0)
    """
)


def test_survivor_degrades_to_local_mesh_on_peer_death(tmp_path):
    """Kill one of two gloo processes mid-stream: the survivor detects the
    peer-loss collective failure, rebuilds on its local mesh, and
    continues from the carried filter state."""
    script = tmp_path / "elastic_worker.py"
    script.write_text(ELASTIC_WORKER)
    (rc0, out0), (rc1, out1) = run_group(script, 2)
    assert rc1 == 42, f"victim exited oddly:\n{out1[-2000:]}"
    assert rc0 == 0, f"survivor failed:\n{out0[-3000:]}"
    assert "elastic-smoke ok pid=0 count=8 degraded=True" in out0
    # Before the kill the batch is global (4 frames over 2 processes);
    # after degradation it is this process's local 2 frames.
    assert "step 2 gshape=(4, 8, 8, 3)" in out0
    assert "step 3 gshape=(2, 8, 8, 3)" in out0
    assert "step 7 gshape=(2, 8, 8, 3)" in out0
    assert "[elastic] peer loss: degraded to local mesh" in out0


# ------------------------------------------------------- peer loss


# The survivor's error when its gloo peer is killed (torch 2.x, CPU).
GLOO_RESET = ("[../third_party/gloo/gloo/transport/tcp/pair.cc:537] Read error "
              "[127.0.0.1]:54938: Connection reset by peer")


def test_peer_loss_markers_are_the_references():
    """The markers are the reference's, unchanged: gloo's text for a
    killed peer already carries one of them."""
    assert D._PEER_LOSS_MARKERS == ref_dist._PEER_LOSS_MARKERS


@pytest.mark.parametrize("exc,loss", [
    (RuntimeError(GLOO_RESET), True),
    (RuntimeError("Connection closed by peer [127.0.0.1]:29500"), True),
    (RuntimeError("The size of tensor a (4) must match the size of tensor b "
                  "(2) at non-singleton dimension 0"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     False),
    (RuntimeError("Gloo connectFullMesh failed"), False),
    (ValueError("local batch (3, 8, 8, 3) does not match"), False),
], ids=["gloo-reset", "closed", "shape", "oom", "bare-gloo", "value"])
def test_is_peer_loss(exc, loss):
    assert D.is_peer_loss(exc) is loss
    assert ref_dist.is_peer_loss(exc) is loss


@pytest.mark.parametrize("exc", [
    RuntimeError("The size of tensor a (4) must match the size of tensor b (2)"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
], ids=["shape", "oom"])
def test_non_peer_errors_reraise_and_never_degrade(exc):
    """A shape bug or an OOM in the step re-raises as it is: the runner
    neither degrades nor counts a dropped batch."""
    calls = []

    def builder(mesh):
        def step(batch, state):
            calls.append(mesh)
            raise exc
        return step

    runner = D.ElasticMeshRunner(builder, {"n": torch.zeros(())},
                                 MeshConfig(data=2), devices=CPU8[:2])
    with pytest.raises(type(exc)):
        runner.submit_local(np.zeros((2, 4, 4, 3), np.uint8))
    assert not runner.degraded and runner.dropped_on_loss == 0
    assert len(calls) == 1


# ------------------------------------------------------- init_distributed


def test_init_distributed_without_coordinator_returns_false(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed() is False
    assert ref_dist.init_distributed() is False
    assert D.process_count() == 1 and D.process_index() == 0


_TORCHRUN_PROBE = """
import os, sys, torch
import torch.distributed as dist
from dvf_tpu_torch.parallel.distributed import init_distributed, process_count, rank_device
for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
    os.environ.pop(k, None)
assert init_distributed(device="cpu") is True
assert dist.get_backend() == "gloo", dist.get_backend()
assert process_count() == 1 and dist.get_rank() == 0
try:
    rank_device(0)
except RuntimeError as e:
    assert "no CUDA device" in str(e)
else:
    assert torch.cuda.is_available()
print("torchrun-env ok", flush=True)
os._exit(0)
"""


def test_init_distributed_reads_torchruns_environment():
    """Divergence from the reference (which reads ``JAX_COORDINATOR_
    ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``): the port reads
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``, and the group is gloo. A rank asked for a card where there
    is none raises."""
    from torch_mp_util import free_port

    env = child_env()
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="1", RANK="0")
    out = subprocess.run([sys.executable, "-c", _TORCHRUN_PROBE], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "torchrun-env ok" in out.stdout


# -------------------------------------- egress and ingest rows vs the JAX side


LAYOUTS = [dict(data=2, space=4), dict(data=8), dict(data=4, space=2),
           dict(data=2, space=2, model=2)]


@pytest.mark.parametrize("axes", LAYOUTS, ids=lambda a: ",".join(
    f"{k}={v}" for k, v in a.items()))
def test_host_local_batch_and_local_output_rows_match_the_reference(axes):
    """One process over 8 devices: the global batch assembled from the
    local rows, and the rows brought back, equal the reference's on its 8
    virtual devices (every row is local in one process)."""
    x = np.random.default_rng(3).integers(0, 255, (8, 16, 8, 3), np.uint8)
    ref_mesh = ref_make_mesh(RefMeshConfig(**axes))
    ref_b = ref_dist.host_local_batch(ref_mesh, x)
    ref_rows = ref_dist.local_output_rows(jax.jit(lambda a: 255 - a)(ref_b))
    mesh = D.global_mesh(MeshConfig(**axes), devices=CPU8)
    b = D.host_local_batch(mesh, x)
    assert tuple(b.shape) == tuple(ref_b.shape)
    assert b.sharding.shard_shape(b.shape) == tuple(
        ref_b.sharding.shard_shape(ref_b.shape))
    rows = D.local_output_rows(b.map(lambda t: 255 - t))
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(rows, 255 - x)


def test_local_output_rows_refuses_partial_rows():
    """A layout whose H blocks of a row are not all local is an error,
    not a garbled frame (here: the second H block's owner is another
    process)."""
    from dvf_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from dvf_tpu_torch.parallel.sharded import shard_batch

    mesh = make_mesh(MeshConfig(data=1, space=2), devices=CPU8[:2],
                     processes=[0, 1], process_id=0)
    x = torch.zeros((2, 8, 4, 3), dtype=torch.uint8)
    b = shard_batch(x, batch_sharding(mesh, x.shape))
    assert len(b.shards) == 1   # this process holds one H block
    with pytest.raises(ValueError, match="only partially addressable"):
        D.local_output_rows(b)


def test_global_mesh_puts_processes_outermost_on_data():
    """Process p's devices are the p-th run of the flat device list, so a
    data-first layout splits the batch at the process boundary."""
    from dvf_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    mesh = make_mesh(MeshConfig(data=2, space=2), devices=CPU8[:4],
                     processes=[0, 0, 1, 1], process_id=1)
    iv = D.process_row_intervals(batch_sharding(mesh, (4, 8, 4, 3)), (4, 8, 4, 3))
    assert iv == {0: [(0, 2)], 1: [(2, 4)]}
    assert mesh.process_count == 2 and mesh.distinct_devices() == [CPU8[0]]
    b = D.host_local_batch(mesh, np.arange(2 * 8 * 4 * 3, dtype=np.uint8)
                           .reshape(2, 8, 4, 3))
    assert tuple(b.shape) == (4, 8, 4, 3)
    assert [blk.index[:2] for blk in b.blocks] == [
        (slice(2, 4), slice(0, 4)), (slice(2, 4), slice(4, 8))]
    assert D.all_reduce(torch.ones(1), D.local_mesh(devices=CPU8[:1])).item() == 1


def test_ranks_share_the_card_over_gloo(monkeypatch):
    """Divergence from the reference (one device per process, XLA's
    collectives): rank r drives ``cuda:{r % device_count}``, so on a
    one-card machine every rank shares cuda:0, and the group is gloo
    (NCCL refuses two ranks on one card); gloo's all_reduce takes the
    CUDA tensor, so nothing moves to the CPU. The CPU only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [D.rank_device(r) for r in range(3)] == [torch.device("cuda", 0)] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [D.rank_device(r) for r in range(3)] == [
        torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 0)]
    assert D.rank_device(1, "cuda:1") == torch.device("cuda", 1)
    assert D.rank_device(1, "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.rank_device(0)
    import inspect

    assert '"gloo"' in inspect.getsource(D.init_distributed)
