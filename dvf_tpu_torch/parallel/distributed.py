"""Multi-process initialization and mesh construction (port of
``dvf_tpu.parallel.distributed``), on ``torch.distributed``.

One process per rank, joined in a gloo process group. Each rank drives
one card (``cuda:{rank % device_count}``; on a one-card machine every
rank shares ``cuda:0``, the process counterpart of a virtual mesh), and
:func:`global_mesh` lays the world's devices out with ``data`` outermost
across processes, so the only cross-process traffic a frame batch needs
is its own rows. The reference's SPMD program makes its cross-process
reductions implicitly; here they are explicit: a step calls
:func:`all_reduce` (the process counterpart of ``parallel.sharded``'s
sum across a model axis).
Frame rows never cross the group: a caller ships them itself, as the
fleet's multi-host replica does over sockets.

The group is gloo and never NCCL: NCCL refuses two ranks on one card,
and gloo's ``all_reduce`` and ``broadcast`` take CUDA tensors, so the
tensors stay on the card. A rank asked for a card where there is none
raises; nothing here carries on on the CPU unless the caller named it.

Fault model: a peer that dies mid-collective surfaces on the survivors
as an error :func:`is_peer_loss` recognises (gloo: "Connection reset by
peer"); a peer that hangs surfaces as the group's ``timeout``. The
:class:`ElasticMeshRunner` then rebuilds the step on the local devices
and carries on from the last host-synced state; the frames that were on
the lost peer are gone (the reference's at-most-once semantics).
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from dvf_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    NamedSharding,
    auto_mesh_config,
    batch_pspec,
    batch_sharding,
    local_devices,
    make_mesh,
)
from dvf_tpu_torch.parallel.sharded import ShardedBatch, shard_batch

DEFAULT_TIMEOUT_S = 60.0  # a collective with a silent peer raises after this

_rank_device: Optional[torch.device] = None  # this rank's device, set by
#   init_distributed


def rank_device(rank: int, device: Union[None, str, torch.device] = None) -> torch.device:
    """The device a rank drives: ``cuda:{rank % device_count}`` unless
    the caller names one (``"cpu"``, or ``"cuda"`` for that default).
    Raises where a card is asked for and there is none."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the rank on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[None, str, torch.device] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the process group when running multi-process.

    Arguments default from torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), where the reference reads
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``. With no coordinator this is a no-op returning
    False, so one entry point serves one process and a group.
    ``coordinator_address`` is ``host:port`` or a ``tcp://`` URL.
    ``device`` is this rank's device (:func:`rank_device`); ``timeout_s``
    bounds every collective, so a dead peer raises instead of hanging."""
    global _rank_device
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    dev = rank_device(process_id, device)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        "gloo", init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device = dev
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_devices() -> List[torch.device]:
    """The devices this process contributes to a mesh: its rank's device
    in a group, else every card it sees (none without CUDA)."""
    if dist.is_initialized() and _rank_device is not None:
        return [_rank_device]
    return local_devices()


def _peer_device(local: torch.device, peer: int, j: int, n_local: int) -> torch.device:
    """The label of a peer's ``j``-th device: the group's own convention
    (``cuda:{k % device_count}`` for its ``k``-th position)."""
    if local.type != "cuda":
        return local
    return torch.device("cuda", (peer * n_local + j) % torch.cuda.device_count())


def global_mesh(config: Optional[MeshConfig] = None, prefer: str = "data",
                devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """Mesh over ALL processes' devices (this process's and its peers').

    Axis order puts ``data`` outermost: process *p*'s devices are the
    *p*-th run of the flat device list, so on a ``data``-first layout the
    process boundary falls between data blocks and the only
    cross-process traffic is batch rows, while ``space``/``model``
    exchanges stay inside a process — the reference's layout rule.
    ``devices`` overrides this process's devices (every process of the
    group must give as many)."""
    local = [torch.device(d) for d in devices] if devices is not None else rank_devices()
    if not local:
        raise RuntimeError("no CUDA device is available; give global_mesh "
                           "a list of CPU devices to run on the CPU")
    n_proc, me = process_count(), process_index()
    world, owner = [], []
    for p in range(n_proc):
        for j, d in enumerate(local):
            world.append(d if p == me else _peer_device(d, p, j, len(local)))
            owner.append(p)
    if config is None:
        config = auto_mesh_config(len(world), prefer=prefer)
    return make_mesh(config, devices=world, processes=owner, process_id=me)


def local_mesh(prefer: str = "data",
               devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A mesh over this process's devices only (what a survivor degrades
    to): no position belongs to a peer, so no collective leaves the
    process."""
    local = [torch.device(d) for d in devices] if devices is not None else rank_devices()
    me = process_index()
    return make_mesh(auto_mesh_config(len(local), prefer=prefer), devices=local,
                     processes=[me] * len(local), process_id=me)


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the processes of ``mesh``: the explicit form
    of the cross-process reduction the reference's program makes
    implicitly. Each process hands in its own partial (already summed
    over its own blocks) and gets the total back on ``t``'s device. A
    mesh of one process returns ``t``; no collective runs."""
    if mesh.process_count <= 1:
        return t
    out = t.clone()
    dist.all_reduce(out)
    return out


# Connection-level signatures of "a peer process is gone" in collective
# errors (gloo: the survivor's error on a killed peer is "Read error
# [...]: Connection reset by peer"). Deliberately NARROW — a bare "Gloo"
# match would classify size-mismatch and config bugs as peer loss and
# silently split a healthy group into isolated single-process pipelines.
# Everything non-connection — shape bugs, OOM, build errors — must NOT be
# treated as elastic and re-raises.
_PEER_LOSS_MARKERS = (
    "Connection reset by peer",
    "Connection refused",
    "Connection closed",
    "Socket closed",
    "heartbeat timeout",
    "remote task has failed",
)


def is_peer_loss(exc: BaseException) -> bool:
    msg = str(exc)
    return any(m in msg for m in _PEER_LOSS_MARKERS)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _place(state, device: torch.device):
    return _tree_map(lambda t: t.to(device).clone(), state)


def _to_host(state):
    return _tree_map(lambda t: t.detach().to("cpu", copy=True), state)


def _block_until_ready(out) -> None:
    shards = out.shards if isinstance(out, ShardedBatch) else [out]
    for d in {t.device for t in shards if isinstance(t, torch.Tensor)}:
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()


class ElasticMeshRunner:
    """Run a per-mesh-built step with peer-loss degradation.

    ``step_builder(mesh)`` returns ``(batch, state) -> (out, state)`` for
    that mesh, where ``batch`` and ``out`` are sharded batches
    (:class:`ShardedBatch`) of this process's blocks and a cross-process sum is
    :func:`all_reduce` over ``mesh``. It is called once for the global
    mesh and again for the local fallback mesh after degradation, so
    every mesh dependency is rebuilt rather than patched.

    State contract: the carried filter state is REPLICATED across
    processes (every rank holds a full copy on its device, and a step
    keeps the copies equal by reducing what it adds), so degradation is
    lossless: the survivor re-places the last host-synced state on its
    local mesh and keeps going. ``sync_every`` controls how often the
    host copy refreshes (1 = every batch: the state is at most one batch
    old when a peer dies).

    Batches: before degradation each process feeds its LOCAL rows of the
    global batch (:func:`host_local_batch`); after, the same local rows
    are the whole batch. In-flight frames on dead peers are dropped,
    never retried — the reference's at-most-once semantics.
    """

    def __init__(
        self,
        step_builder: Callable[[Mesh], Callable],
        state: Any,
        config: Optional[MeshConfig] = None,
        prefer: str = "data",
        sync_every: int = 1,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        self._builder = step_builder
        self._prefer = prefer
        self._devices = devices
        self.mesh = global_mesh(config, prefer=prefer, devices=devices)
        self._step = step_builder(self.mesh)
        self.state = _place(state, self.mesh.first_device)
        self.state_host = _to_host(state)
        self.sync_every = max(1, sync_every)
        self.degraded = False
        self.batches = 0
        self.dropped_on_loss = 0

    def _degrade(self) -> None:
        self.mesh = local_mesh(self._prefer, devices=self._devices)
        self._step = self._builder(self.mesh)
        self.state = _place(self.state_host, self.mesh.first_device)
        self.degraded = True
        print(
            f"[elastic] peer loss: degraded to local mesh "
            f"({self.mesh.size} devices), resuming from filter state of "
            f"batch {self.batches}",
            file=sys.stderr, flush=True,
        )

    def submit_local(self, local_batch: np.ndarray) -> ShardedBatch:
        """Contribute this process's frames; returns the (sharded) output.

        On the first peer-loss failure the batch is re-run on the local
        mesh — the local rows were this process's anyway, so no frame it
        owns is lost; the peers' frames die with them.
        """
        try:
            if self.degraded:
                batch = shard_batch(
                    local_batch, batch_sharding(self.mesh, local_batch.shape))
            else:
                batch = host_local_batch(self.mesh, local_batch)
            with torch.no_grad():
                out, self.state = self._step(batch, self.state)
            # Wait NOW: with queued launches a peer loss would otherwise
            # surface on a later (innocent) call.
            _block_until_ready(out)
        except Exception as e:  # noqa: BLE001 — filtered just below
            if self.degraded or not is_peer_loss(e):
                raise
            self.dropped_on_loss += 1
            self._degrade()
            return self.submit_local(local_batch)
        self.batches += 1
        if self.batches % self.sync_every == 0:
            self.state_host = _to_host(self.state)
        return out


def _bounds(sl: slice, n: int):
    return (sl.start or 0, n if sl.stop is None else sl.stop)


def local_output_rows(out: ShardedBatch) -> np.ndarray:
    """This process's egress rows of a global result: the batch rows its
    blocks hold, reassembled in global row order.

    The delivery-side mirror of :func:`host_local_batch` — each process
    brings back ONLY the rows it addresses (device→host over its own
    link, no cross-process gather). Replicated blocks are deduped by
    index so a value comes back exactly once, and non-batch sharding (a
    ``space`` axis splitting H) is stitched back together per batch
    interval — a row is returned whole or not at all: if this process
    holds only part of a row's pieces (a layout that shards H *across*
    processes, inverting the data-outermost rule), that is an error, not
    a silently garbled frame."""
    seen = {}
    for blk, t in zip(out.blocks, out.shards):
        key = tuple(_bounds(sl, out.shape[d]) for d, sl in enumerate(blk.index))
        if key not in seen:
            seen[key] = t.detach().cpu().numpy()
    intervals = sorted({key[0] for key in seen})
    dtype = next(iter(seen.values())).dtype
    parts = []
    for b0, b1 in intervals:
        buf = np.empty((b1 - b0, *out.shape[1:]), dtype)
        filled = 0
        for key, data in seen.items():
            if key[0] != (b0, b1):
                continue
            rest = tuple(slice(lo, hi) for lo, hi in key[1:])
            buf[(slice(0, b1 - b0), *rest)] = data
            filled += data.size
        if filled != buf.size:
            raise ValueError(
                f"rows [{b0}:{b1}) are only partially addressable from "
                f"this process ({filled}/{buf.size} elements) — per-process "
                f"egress needs every non-batch shard of a local row to "
                f"be local (keep the data axis outermost across processes)")
        parts.append(buf)
    return np.concatenate(parts, axis=0)


def process_row_intervals(sharding: NamedSharding, shape: Sequence[int]) -> dict:
    """Per-process batch-row intervals under ``sharding`` — computed from
    the layout, never assumed. Distinct positions holding one interval
    dedupe (replicated layouts); intervals come back sorted, so slicing is
    in global row order."""
    mesh = sharding.mesh
    by_proc: dict = {int(p): set() for p in set(mesh.processes.flat)}
    for pos, idx in sharding.devices_indices_map(tuple(shape)).items():
        by_proc[int(mesh.processes[pos])].add(_bounds(idx[0], shape[0]))
    return {pid: sorted(iv) for pid, iv in by_proc.items()}


def host_local_batch(mesh: Mesh, local_batch: Union[np.ndarray, torch.Tensor]) -> ShardedBatch:
    """Assemble the GLOBAL sharded frame batch from this process's frames.

    Multi-process ingestion: each process captures/decodes only its own
    frames (its rows of the global batch on the ``data`` axis) and
    contributes them as the blocks it addresses — no process ever
    materialises the full batch. The global batch has the local rows
    times the share of ``data`` blocks this process holds; every other
    dimension must be whole in each process (data outermost)."""
    if isinstance(local_batch, np.ndarray):
        local_batch = torch.from_numpy(np.ascontiguousarray(local_batch))
    sharding = NamedSharding(mesh, batch_pspec(mesh, None))
    own_blocks = {sharding._block(pos, 0) for pos in np.ndindex(*mesh.devices.shape)
                  if mesh.owns(pos)}
    parts = sharding.parts(0)
    if local_batch.shape[0] % len(own_blocks):
        raise ValueError(f"{local_batch.shape[0]} local rows do not divide "
                         f"into this process's {len(own_blocks)} batch blocks")
    rows = local_batch.shape[0] // len(own_blocks)
    shape = (rows * parts, *local_batch.shape[1:])
    owned = sorted({_bounds(idx[0], shape[0])
                    for pos, idx in sharding.devices_indices_map(shape).items()
                    if mesh.owns(pos)})
    offset, cursor = {}, 0
    for b0, b1 in owned:
        offset[b0] = cursor
        cursor += b1 - b0
    out = []
    for blk in sharding.shards(shape):
        b0, b1 = _bounds(blk.index[0], shape[0])
        lo = offset[b0]
        piece = local_batch[(slice(lo, lo + b1 - b0), *blk.index[1:])]
        if piece.device != blk.device:
            piece = piece.to(blk.device)
        out.append(piece.contiguous())
    return ShardedBatch(out, sharding, shape)
