"""Sharded batches and the collectives between their shards.

One process drives the whole mesh, so a sharded batch is a list of
per-block tensors in mesh order, each contiguous on its own device
(:class:`ShardedBatch`), and a collective is a copy between such lists:
boundary rows to a neighbour (``parallel.halo``), a sum across the ranks
of an axis (:class:`RankGroup`), an activation to the next stage
(``parallel.pp``). Every cross-device copy is PyTorch's own
(``Tensor.to(device, non_blocking=True)``), which orders itself against
the current streams of both devices, so nothing here synchronises the
host per shard.

A filter's state on a mesh is either threaded (a list of local states,
one per ``space`` block, carried across the data blocks in order) or
placed by the filter's ``state_pspecs`` (:func:`place_tree`: one local
tree per mesh position, each holding that position's block of every
leaf).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.parallel.mesh import Mesh, NamedSharding, PartitionSpec, Shard


class ShardedBatch:
    """A global array laid out by ``sharding``: ``shards[i]`` is the
    contiguous block ``blocks[i].index`` on ``blocks[i].device``."""

    def __init__(self, shards: Sequence[torch.Tensor], sharding: NamedSharding,
                 shape: Sequence[int]):
        self.shards = list(shards)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.blocks: List[Shard] = sharding.shards(self.shape)
        if len(self.blocks) != len(self.shards):
            raise ValueError(f"{len(self.shards)} shards for "
                             f"{len(self.blocks)} blocks of {sharding}")

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The first block's device (the mesh's first device)."""
        return self.shards[0].device

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedBatch":
        """Apply a per-block function; the global shape follows the
        blocks' new shape (a ×2 upscale doubles H and W)."""
        out = [fn(t) for t in self.shards]
        return ShardedBatch(out, self.sharding,
                            self.sharding.global_shape(out[0].shape))

    def grid(self) -> List[List[int]]:
        """The block indices as rows, one per data block (blocks sharing
        their B rows: one ``space`` ring), in B order, each row in H
        order."""
        rows: Dict[int, List[int]] = {}
        for i, blk in enumerate(self.blocks):
            rows.setdefault(blk.index[0].start, []).append(i)
        return [sorted(ix, key=lambda i: self.blocks[i].index[1].start)
                for _, ix in sorted(rows.items())]

    def cpu(self) -> torch.Tensor:
        """The whole array in host memory (blocks copied one by one)."""
        return assemble(self, torch.device("cpu"))

    def reshard(self, sharding: NamedSharding) -> "ShardedBatch":
        """The same array under another block layout: each new block is
        cut from the old blocks that overlap it and joined on its device."""
        if sharding == self.sharding:
            return self
        out = []
        for blk in sharding.shards(self.shape):
            rows = []
            for src_blk, src in zip(self.blocks, self.shards):
                cut = _overlap(src_blk.index, blk.index)
                if cut is not None:
                    rows.append((cut, src[cut[1]].to(blk.device, non_blocking=True)))
            out.append(_join(rows, blk.index))
        return ShardedBatch(out, sharding, self.shape)

    def __repr__(self) -> str:
        return (f"ShardedBatch(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, shards={len(self.shards)})")


def _overlap(a: Tuple[slice, ...], b: Tuple[slice, ...]):
    """Where block ``a`` meets block ``b``: (global slices, slices local
    to ``a``), or None."""
    glob, loc = [], []
    for sa, sb in zip(a, b):
        lo, hi = max(sa.start, sb.start), min(sa.stop, sb.stop)
        if lo >= hi:
            return None
        glob.append(slice(lo, hi))
        loc.append(slice(lo - sa.start, hi - sa.start))
    return tuple(glob), tuple(loc)


def _join(pieces, index: Tuple[slice, ...]) -> torch.Tensor:
    """Join pieces (each ``((global slices, _), tensor)``) that tile the
    block ``index`` of a block layout: along dim 1 within a row band,
    then the bands along dim 0."""
    bands: Dict[int, List] = {}
    for (glob, _), t in pieces:
        bands.setdefault(glob[0].start, []).append((glob[1].start if len(glob) > 1 else 0, t))
    rows = []
    for start in sorted(bands):
        parts = [t for _, t in sorted(bands[start], key=lambda p: p[0])]
        rows.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=1))
    out = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
    return out.contiguous()


def shard_batch(x: Union[torch.Tensor, np.ndarray], sharding: NamedSharding,
                non_blocking: bool = False) -> ShardedBatch:
    """Lay a whole array out over the mesh: each block cut from ``x`` and
    copied, contiguous, to its device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    out = []
    for blk in sharding.shards(x.shape):
        piece = x[blk.index]
        if piece.device != blk.device:
            piece = piece.to(blk.device, non_blocking=non_blocking)
        out.append(piece.contiguous())
    return ShardedBatch(out, sharding, x.shape)


def assemble(sb: ShardedBatch, device: Union[str, torch.device]) -> torch.Tensor:
    """The whole array on one device."""
    device = torch.device(device)
    out = torch.empty(tuple(sb.shape), dtype=sb.dtype, device=device)
    for blk, t in zip(sb.blocks, sb.shards):
        out[blk.index].copy_(t)
    return out


def as_sharded(x: Union[torch.Tensor, ShardedBatch],
               sharding: NamedSharding) -> Tuple[ShardedBatch, bool]:
    """``x`` under ``sharding`` (resharded or laid out as needed), and
    whether it came in whole: a mesh body called on a whole tensor hands
    back a whole tensor on that tensor's device."""
    if isinstance(x, ShardedBatch):
        return x.reshard(sharding), False
    return shard_batch(x, sharding), True


def finish(out: ShardedBatch, whole: bool, like) -> Union[torch.Tensor, ShardedBatch]:
    """The other half of :func:`as_sharded`: a mesh body's output, whole
    on ``like``'s device when its input came in whole."""
    if not whole:
        return out
    return assemble(out, like.device)


class EventGroup:
    """Events recorded on several devices' streams, one per device: the
    mesh counterpart of one CUDA event."""

    def __init__(self, events: Dict[torch.device, torch.cuda.Event]):
        self.events = events

    def query(self) -> bool:
        return all(ev.query() for ev in self.events.values())

    def synchronize(self) -> None:
        for ev in self.events.values():
            ev.synchronize()

    def on(self, device: torch.device) -> Optional[torch.cuda.Event]:
        return self.events.get(torch.device(device))

    @classmethod
    def record(cls, devices: Sequence[torch.device],
               stream_of: Callable[[torch.device], Any]) -> Optional["EventGroup"]:
        """One event on ``stream_of(device)`` per CUDA device (None when
        every device is the CPU)."""
        events = {}
        for d in devices:
            if d.type == "cuda" and d not in events:
                ev = torch.cuda.Event()
                ev.record(stream_of(d))
                events[d] = ev
        return cls(events) if events else None


# ---------------------------------------------------------------------------
# Placed state (the filter's state_pspecs)
# ---------------------------------------------------------------------------

def _spec_leaf(x) -> bool:
    return isinstance(x, PartitionSpec)


def tree_map_specs(fn, tree, specs):
    """Map ``fn(leaf, spec)`` over a tree of tensors and its spec tree
    (dicts and lists; a spec may stand for a whole subtree)."""
    if _spec_leaf(specs):
        if isinstance(tree, dict):
            return {k: tree_map_specs(fn, v, specs) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tree_map_specs(fn, v, specs) for v in tree)
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_specs(fn, v, s) for v, s in zip(tree, specs))
    raise TypeError(f"spec tree does not match the state tree at {type(tree)}")


class PlacedTree:
    """A state tree placed over a mesh by a spec tree: ``local(pos)`` is
    the tree of blocks the device at mesh position ``pos`` holds. Blocks
    equal in device and slice are one tensor."""

    def __init__(self, tree, mesh: Mesh, specs):
        self.mesh = mesh
        self.specs = specs
        cache: Dict[Tuple, torch.Tensor] = {}
        self._locals: Dict[Tuple[int, ...], Any] = {}

        for pos in np.ndindex(*mesh.devices.shape):
            dev = mesh.devices[pos]

            def cut(leaf, spec, pos=pos, dev=dev):
                if not isinstance(leaf, torch.Tensor):
                    return leaf
                idx = NamedSharding(mesh, spec).index_of(pos, leaf.shape)
                key = (id(leaf), str(dev),
                       tuple((s.start, s.stop) for s in idx))
                t = cache.get(key)
                if t is None:
                    t = cache[key] = leaf[idx].to(dev).contiguous()
                return t

            self._locals[pos] = tree_map_specs(cut, tree, specs)
        self._tensors = list(cache.values())

    def local(self, pos: Tuple[int, ...]) -> Any:
        return self._locals[tuple(pos)]

    def tensors(self) -> List[torch.Tensor]:
        """Every distinct block (what the state occupies on the devices)."""
        return list(self._tensors)


def place_tree(tree, mesh: Mesh, specs) -> PlacedTree:
    return PlacedTree(tree, mesh, specs)


# ---------------------------------------------------------------------------
# Ranks of one axis running in lockstep (tensor parallelism)
# ---------------------------------------------------------------------------

def current_streams(devices: Sequence[torch.device]) -> List[Any]:
    """The calling thread's current stream on each CUDA device of
    ``devices`` (each device once)."""
    out, seen = [], set()
    for d in devices:
        if d.type == "cuda" and d not in seen:
            seen.add(d)
            out.append(torch.cuda.current_stream(d))
    return out


def on_streams(streams: Sequence[Any]) -> contextlib.ExitStack:
    """Make ``streams`` current in this thread (a thread starts on each
    device's default stream): work a helper thread issues then stays
    ordered with the caller's."""
    stack = contextlib.ExitStack()
    for s in streams:
        stack.enter_context(torch.cuda.stream(s))
    return stack


def rank_sum(ts: Sequence[torch.Tensor], home: Union[str, torch.device]) -> torch.Tensor:
    """The tensors added in rank order on ``home``, half precision in
    float32 and rounded once to the first tensor's dtype (as one conv over
    all the channels would round): the same bits however the devices'
    streams or threads interleave."""
    dtype = ts[0].dtype
    wide = torch.float32 if dtype in (torch.float16, torch.bfloat16) else dtype
    acc = ts[0].to(home, non_blocking=True).to(wide)
    for t in ts[1:]:
        acc = acc + t.to(home, non_blocking=True).to(wide)
    return acc.to(dtype)


class RankGroup:
    """The ranks of one mesh axis running one body together, one thread
    each, as the reference's all-manual ``shard_map`` runs it on every
    device of the axis. ``psum`` is the collective they meet at: every
    rank hands in its partial, the sum is formed once in rank order on
    rank 0's device (in float32 for half-precision partials) and each
    rank gets it back on its own device, so all ranks hold the same
    bits."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.n = len(self.devices)
        self._barrier = threading.Barrier(self.n) if self.n > 1 else None
        self._slots: List[Optional[torch.Tensor]] = [None] * self.n
        self._sum: Optional[torch.Tensor] = None

    def psum(self, rank: int, y: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return y
        self._slots[rank] = y
        self._barrier.wait()
        if rank == 0:
            self._sum = rank_sum(self._slots, self.devices[0])
        self._barrier.wait()
        out = self._sum.to(self.devices[rank], non_blocking=True)
        self._barrier.wait()
        return out

    def run(self, body: Callable[[int], Any]) -> List[Any]:
        """``body(rank)`` on every rank; returns the results in rank
        order. A rank that raises breaks the others' waits, and the first
        error is re-raised here."""
        if self.n == 1:
            return [body(0)]
        results: List[Any] = [None] * self.n
        errors: List[BaseException] = []
        streams = current_streams(self.devices)

        def worker(rank: int) -> None:
            try:
                with torch.no_grad(), on_streams(streams):
                    results[rank] = body(rank)
            except threading.BrokenBarrierError as e:
                errors.append(e)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.insert(0, e)
                self._barrier.abort()

        threads = [threading.Thread(target=worker, args=(r,), daemon=True,
                                    name=f"dvf-rank{r}")
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


def model_groups(mesh: Mesh, pos: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """The mesh positions of the ``model`` ranks beside ``pos``, in rank
    order."""
    i = mesh.axis_names.index("model")
    return [tuple(m if a == i else p for a, p in enumerate(pos))
            for m in range(mesh.devices.shape[i])]


# ---------------------------------------------------------------------------
# Ranks of one axis in lockstep, as one autograd graph (training)
# ---------------------------------------------------------------------------
#
# The train step's tensor-parallel body runs every rank's program
# (``models.layers`` rank programs) from the calling thread, and each
# collective is one autograd node with one output per rank, so the
# gradient is the one-device gradient by construction (Megatron's
# conjugate pairs: the sum of the ranks' partials forward is the sum's
# gradient handed to every partial backward; the copies handed to the
# ranks forward are their gradients summed backward). Every sum runs in
# rank order on rank 0's device, in float32 for half-precision tensors,
# so it is the same bits however the device threads of a backward
# interleave. No barrier and no helper thread: nothing waits inside a
# backward.

def _fan_out(x: torch.Tensor, devices: Sequence[torch.device]) -> Tuple[torch.Tensor, ...]:
    """``x`` (on rank 0's device) once per rank: itself for rank 0, a copy
    on its device for every other rank."""
    return (x,) + tuple(x.to(d, non_blocking=True, copy=True) for d in devices[1:])


def _grads_home(ctx, grads) -> Optional[torch.Tensor]:
    """The ranks' gradients of a fanned-out tensor, summed in rank order
    on rank 0's device (None when no rank's copy reached the loss)."""
    present = [g for g in grads if g is not None]
    return rank_sum(present, ctx.home) if present else None


class _AllReduce(torch.autograd.Function):
    """Partial sums (one per rank, on its device) → their sum, once per
    rank."""

    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.home = devices[0]
        ctx.devices = [p.device for p in parts]
        ctx.set_materialize_grads(False)
        return _fan_out(rank_sum(parts, devices[0]), devices)

    @staticmethod
    def backward(ctx, *grads):
        g = _grads_home(ctx, grads)
        if g is None:
            return (None,) * (1 + len(ctx.devices))
        return (None,) + tuple(g.to(d, non_blocking=True) for d in ctx.devices)


class _AllGather(torch.autograd.Function):
    """Channel slices (one per rank, on its device) → joined on the last
    dimension, once per rank."""

    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.home = devices[0]
        ctx.devices = [p.device for p in parts]
        ctx.widths = [p.shape[-1] for p in parts]
        ctx.set_materialize_grads(False)
        whole = torch.cat([p.to(devices[0], non_blocking=True) for p in parts], dim=-1)
        return _fan_out(whole, devices)

    @staticmethod
    def backward(ctx, *grads):
        g = _grads_home(ctx, grads)
        if g is None:
            return (None,) * (1 + len(ctx.devices))
        return (None,) + tuple(s.to(d, non_blocking=True)
                               for s, d in zip(g.split(ctx.widths, dim=-1), ctx.devices))


def collective(kind: str, parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> Sequence[torch.Tensor]:
    """One rank program request answered for every rank at once:
    ``"sum"`` or ``"gather"`` (``models.layers.SUM`` / ``GATHER``)."""
    if len(parts) == 1:
        return list(parts)
    if kind == "sum":
        return _AllReduce.apply(list(devices), *parts)
    if kind == "gather":
        return _AllGather.apply(list(devices), *parts)
    raise ValueError(f"unknown collective {kind!r}")


def lockstep(programs: Sequence[Any], devices: Sequence[torch.device]) -> List[Any]:
    """Run one rank program per rank of a model axis (rank r's on
    ``devices[r]``) from this thread: every program up to its next
    request, the collective formed once for all (:func:`collective`),
    each program resumed with its result. Returns the programs' values
    in rank order. The programs are the same program on other blocks,
    so they request the same collectives in the same order and end
    together; anything else raises."""
    n = len(programs)

    def advance(r: int, value, first: bool):
        try:
            return False, (next(programs[r]) if first else programs[r].send(value))
        except StopIteration as stop:
            return True, stop.value

    state = [advance(r, None, True) for r in range(n)]
    while True:
        done = {d for d, _ in state}
        if done == {True}:
            return [v for _, v in state]
        kinds = {v[0] for d, v in state if not d}
        if len(done) != 1 or len(kinds) != 1:
            raise RuntimeError(f"the ranks' programs diverged: {state!r}")
        outs = collective(kinds.pop(), [v[1] for _, v in state], devices)
        state = [advance(r, outs[r], False) for r in range(n)]
