"""Sharded batches and the collectives between their shards.

One process drives the whole mesh, so a sharded batch is a list of
per-block tensors in mesh order, each contiguous on its own device
(:class:`ShardedBatch`), and a collective is a copy between such lists:
boundary rows to a neighbour (``parallel.halo``), a sum across the ranks
of an axis (:func:`lockstep`), an activation to the next stage
(``parallel.pp``). Every cross-device copy is PyTorch's own
(``Tensor.to(device, non_blocking=True)``), which orders itself against
the current streams of both devices, so nothing here synchronises the
host per shard.

A filter's state on a mesh is either threaded (a list of local states,
one per ``space`` block, carried across the data blocks in order) or
placed by the filter's ``state_pspecs`` (:func:`place_tree`: one local
tree per mesh position, each holding that position's block of every
leaf).

A net's serving body over the ``model`` axis (:func:`model_axis_filter`)
folds the batch over the other axes and runs each block on the ``model``
ranks beside it: the tensor-parallel body (:func:`tp_filter`) drives the
net's rank programs with :func:`lockstep`, as the train step does; the
layer pipeline hands the block to ``parallel.pp``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.models.layers import exact_f32_convs
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
# Streams, sums and the ranks of one model axis
# ---------------------------------------------------------------------------

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


def model_groups(mesh: Mesh, pos: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """The mesh positions of the ``model`` ranks beside ``pos``, in rank
    order."""
    i = mesh.axis_names.index("model")
    return [tuple(m if a == i else p for a, p in enumerate(pos))
            for m in range(mesh.devices.shape[i])]


# ---------------------------------------------------------------------------
# Ranks of one axis in lockstep, as one autograd graph
# ---------------------------------------------------------------------------
#
# A tensor-parallel body, served or trained, runs every rank's program
# (``models.layers`` rank programs) from the calling thread, and each
# collective is one autograd node with one output per rank. Under
# ``no_grad`` (serving) the node is only the copies; in the train step the
# gradient is the one-device gradient by construction (Megatron's
# conjugate pairs: the sum of the ranks' partials forward is the sum's
# gradient handed to every partial backward; the copies handed to the
# ranks forward are their gradients summed backward). Every sum runs in
# rank order on rank 0's device, in float32 for half-precision tensors,
# so every rank gets the same bits, however the device threads of a
# backward interleave. No barrier and no helper thread: nothing waits,
# forward or backward.

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
    together; anything else raises. When a program raises, or the
    programs diverge, every program is closed (its ``finally`` blocks
    run, last rank first) before the error reaches the caller."""
    n = len(programs)

    def advance(r: int, value, first: bool):
        try:
            return False, (next(programs[r]) if first else programs[r].send(value))
        except StopIteration as stop:
            return True, stop.value

    try:
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
    except BaseException:
        for p in reversed(programs):
            p.close()
        raise


# ---------------------------------------------------------------------------
# Model-axis serving bodies
# ---------------------------------------------------------------------------

def fold_sharding(mesh: Mesh, batch_shape: Sequence[int]) -> NamedSharding:
    """The batch layout of a model-parallel body: B folded over (data,
    space) on dim 0, replicated over ``model`` (whose ranks own weight
    blocks). Degrades to whatever the batch divides: data+space → data →
    one block."""
    b = batch_shape[0]
    d, s = mesh.axis_size("data"), mesh.axis_size("space")
    if b % (d * s) == 0:
        spec = PartitionSpec(("data", "space"))
    elif b % d == 0:
        spec = PartitionSpec("data")
    else:
        spec = PartitionSpec(None)
    return NamedSharding(mesh, spec)


def model_axis_filter(name: str, run_group: Callable[..., torch.Tensor], specs,
                      init_state, model_dtype: torch.dtype, mesh: Mesh,
                      batch_shape: Sequence[int]) -> Filter:
    """A net's mesh body over the ``model`` axis: the batch folded by
    :func:`fold_sharding`, and each block run by the ``model`` ranks
    beside it as ``run_group(states, x, devices)`` (the ranks' local
    states placed by ``specs``, the block on rank 0's device, the ranks'
    devices), whose output stays on rank 0's device."""
    sharding = fold_sharding(mesh, batch_shape)

    def sharded_fn(batch, state):
        sb, whole = as_sharded(batch, sharding)
        out = []
        for blk, x in zip(sb.blocks, sb.shards):
            ranks = model_groups(mesh, blk.pos)
            # The rank programs' own exact_f32_convs blocks interleave
            # under lockstep and unwind out of order; this one holds the
            # flag for the whole group and restores the caller's.
            with exact_f32_convs(model_dtype):
                out.append(run_group([state.local(p) for p in ranks], x,
                                     [mesh.devices[p] for p in ranks]))
        res = ShardedBatch(out, sharding, sharding.global_shape(out[0].shape))
        return finish(res, whole, batch), state

    return Filter(name=name, fn=sharded_fn, init_state=init_state,
                  compute_dtype=torch.float32, state_pspecs=lambda: specs,
                  sharding=sharding)


def tp_filter(name: str, program: Callable[..., Any], specs, init_state,
              model_dtype: torch.dtype, mesh: Mesh, batch_shape: Sequence[int]) -> Filter:
    """The tensor-parallel mesh body of a net (``tp(name)``): every rank
    runs ``program(local_params, block)`` (the net's ``tp_inner_steps``)
    on its weight blocks, driven by :func:`lockstep`, the row-parallel
    partial outputs summed across the ranks. Every rank ends with the
    same output; rank 0's hands it on."""

    def run_group(states, x, devices):
        return lockstep([program(s, x.to(d, non_blocking=True))
                         for s, d in zip(states, devices)], devices)[0]

    return model_axis_filter(f"tp({name})", run_group, specs, init_state,
                             model_dtype, mesh, batch_shape)
