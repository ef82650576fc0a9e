"""The multi-process engine path: ONE replica spanning processes (port of
``dvf_tpu.fleet.multiproc``).

``runtime.engine.Engine`` is single-process: ``compile()`` warms up with
a full batch and ``submit()`` stages the whole batch. In a process group
(one process per rank, joined by ``parallel.distributed.
init_distributed``) each process touches only its own rows.

:class:`MultiHostEngine` is the engine for that shape:

- **bring-up**: ``init_distributed()`` (env-driven, no-op in one
  process) then ``global_mesh`` over ALL processes' devices, data axis
  outermost so the only cross-process traffic is batch rows;
- **per-process ingest rows**: each process stages only its own rows —
  the union of its blocks' intervals under ``batch_sharding``, computed
  from the layout, never assumed;
- **the single-card engine's uint8 step on the rank's device**: the
  rows run through an ``Engine`` on the rank's device (cast fused on the
  device, uint8 both directions), so the filter's hand kernel runs in
  every rank, once per batch (``gaussian_blur`` launches K1);
- **per-process egress rows**: each process brings back only its local
  output rows, over its own link;
- **lockstep**: one tiny ``all_reduce`` per :meth:`submit_local` stands
  in for the SPMD program's lockstep, so every rank meets every batch
  and a dead peer surfaces here, as the errors
  ``parallel.distributed.is_peer_loss`` classifies. (The reference's
  program has no such collective for a pointwise filter; this is a
  divergence, pinned by the tests.)

A fleet replica that spans processes runs this engine in each member of
its group (``fleet._mh_worker``); a peer loss inside the replica is
``parallel.distributed`` elasticity territory (``ElasticMeshRunner``),
while whole-replica loss stays the fleet router's drain/migrate/restart
domain. Serving multiplexes stateless filters only, and so does this
engine — temporal state would additionally need the cross-process
replication discipline ``ElasticMeshRunner`` documents.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.parallel.distributed import (
    all_reduce,
    global_mesh,
    init_distributed,
    process_row_intervals,
)
from dvf_tpu_torch.parallel.mesh import MeshConfig, batch_sharding
from dvf_tpu_torch.runtime.engine import Engine


@dataclasses.dataclass
class MultiHostStats:
    batches: int = 0
    local_frames: int = 0
    compile_count: int = 0


class MultiHostEngine:
    """One filter program across every process of a group.

    Call :func:`parallel.distributed.init_distributed` (or construct
    with ``auto_init=True``) before building: the mesh must see every
    process's devices. All processes must construct with the same
    config and call :meth:`compile`/:meth:`submit_local` in lockstep —
    a missing participant is a hang until the group's timeout, and a
    dead one surfaces as the collective errors
    ``parallel.distributed.is_peer_loss`` classifies.

    ``devices`` are this process's devices (default: its rank's card; in
    one process every card); the rows run on the first of them.
    """

    def __init__(
        self,
        filt: Filter,
        config: Optional[MeshConfig] = None,
        prefer: str = "data",
        out_uint8: bool = True,
        auto_init: bool = False,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        if filt.stateful:
            raise ValueError(
                f"filter {filt.name!r} is stateful; the multi-process "
                f"serving engine runs stateless filters only (temporal "
                f"state needs the ElasticMeshRunner replication "
                f"discipline)")
        if auto_init:
            init_distributed()
        self.filter = filt
        self.out_uint8 = out_uint8
        self.mesh = global_mesh(config, prefer=prefer, devices=devices)
        self.process_count = self.mesh.process_count
        self.process_index = self.mesh.process_id
        self.device = self.mesh.first_device
        self.stats = MultiHostStats()
        self.engine = Engine(filt, device=self.device, out_uint8=out_uint8)
        self._sharding = None
        self._signature: Optional[Tuple] = None
        self.intervals: Optional[dict] = None  # process -> its row intervals
        self.local_batch_size: Optional[int] = None
        self.out_local_shape: Optional[Tuple[int, ...]] = None
        self.last_all_reduce_ms: Optional[float] = None

    def compile(self, global_batch_shape: Tuple[int, ...],
                dtype=np.uint8) -> None:
        """Build + warm for a fixed GLOBAL (B,H,W,C) signature. Every
        process passes the same global shape; ``local_batch_size`` comes
        back as the rows THIS process contributes per submit."""
        sig = (tuple(global_batch_shape), np.dtype(dtype))
        if sig == self._signature:
            return
        shape = tuple(global_batch_shape)
        self._sharding = batch_sharding(self.mesh, shape)
        # Rows this process feeds: the union of the batch-axis intervals
        # its positions hold under the chosen sharding (replicated batch
        # axis ⇒ every process feeds all rows; distinct positions holding
        # the same interval dedupe).
        self.intervals = process_row_intervals(self._sharding, shape)
        self.local_batch_size = sum(
            stop - start for start, stop in self.intervals[self.process_index])
        self.engine.compile((self.local_batch_size, *shape[1:]), dtype)
        self._signature = sig
        self.stats.compile_count += 1
        # Warm with this process's zero rows (and meet the peers once) so
        # the first real batch pays neither.
        warm = self.submit_local(
            np.zeros((self.local_batch_size, *shape[1:]), dtype=dtype),
            _warm=True)
        self.out_local_shape = tuple(warm.shape)

    def _lockstep(self) -> None:
        """The per-batch meeting point: every process adds one."""
        if self.process_count <= 1:
            return
        t = torch.ones(1, dtype=torch.int32, device=self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        got = int(all_reduce(t, self.mesh).item())
        if cuda:
            ev[1].record(stream)
            ev[1].synchronize()
            self.last_all_reduce_ms = ev[0].elapsed_time(ev[1])
        if got != self.process_count:
            raise RuntimeError(f"lockstep all_reduce gave {got}, want "
                               f"{self.process_count}: the group is out of step")

    def submit_local(self, local_batch: np.ndarray,
                     _warm: bool = False) -> np.ndarray:
        """Contribute this process's rows of the global batch; returns
        this process's rows of the result (blocking — serving overlap
        belongs to the caller's threads, as in the worker loop)."""
        if not _warm:
            if self._signature is None:
                raise ValueError("compile(global_shape) first — every "
                                 "process submits its fixed local share")
            want = (self.local_batch_size, *self._signature[0][1:])
            if tuple(local_batch.shape) != want:
                raise ValueError(
                    f"local batch {tuple(local_batch.shape)} does not "
                    f"match this process's compiled local signature {want}")
        result = self.engine.submit(np.ascontiguousarray(local_batch))
        self._lockstep()
        rows = result.fetch()
        if not _warm:
            self.stats.batches += 1
            self.stats.local_frames += local_batch.shape[0]
        return rows
