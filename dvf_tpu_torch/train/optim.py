"""The optimizer and the param-tree helpers both train families share.

The reference optimizes with ``optax.adam(lr)``. The port uses
``torch.optim.Adam`` with optax's defaults (betas 0.9 / 0.999, eps 1e-8,
no weight decay): its two bias corrections reduce to optax's update, so
one step from the same state agrees to float32 rounding. Its state is
the optimizer's own per-parameter ``exp_avg`` (optax's ``mu``),
``exp_avg_sq`` (``nu``) and ``step`` (``count``, shared by every leaf);
:func:`adam` fills it at construction (zero moments, count 0), so a fresh
state checkpoints like optax's initial one.

Param trees are nested dicts of tensors, keyed like the reference's;
:func:`flatten` names each leaf by its path ("<layer>/<leaf>"), the key of
the ``.npz`` checkpoints.

Over a mesh a param tree is a :class:`MeshParams`: each leaf cut into the
blocks its PartitionSpec names, each block held once per device that
needs it (a "copy"; the first, in mesh order, is the block's "master").
The optimizer holds the masters, so Adam runs once per distinct block
and its moments take the leaf's spec. A step sums every block's copies'
gradients into its master in mesh order before the update and copies
the master back over the others after it, so every copy holds the same
bits.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dvf_tpu_torch.models.layers import exact_f32_convs
from dvf_tpu_torch.obs.trace import TRAIN_BACKWARD, TRAIN_FORWARD, TRAIN_OPTIM, TRAIN_STEP

BETAS = (0.9, 0.999)
EPS = 1e-8


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict → {"a/b": leaf}, in the dict's own order."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b": leaf} → nested dict (the inverse of :func:`flatten`)."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        *parents, name = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return tree


class MeshParams:
    """A param tree placed over a mesh by a spec tree (the reference's
    ``NamedSharding``-placed param tree). ``local(pos)`` is the tree of
    blocks the device at mesh position ``pos`` computes with. A block is
    one tensor per distinct device holding it (a leaf requiring grad when
    ``requires_grad``); positions on one device share it."""

    def __init__(self, tree: Any, mesh, specs: Any, requires_grad: bool):
        from dvf_tpu_torch.parallel.mesh import NamedSharding
        from dvf_tpu_torch.parallel.sharded import tree_map_specs

        self.mesh = mesh
        self.specs = specs
        flat = flatten(tree)
        flat_specs = flatten(tree_map_specs(lambda _leaf, spec: spec, tree, specs))
        self.shapes = {k: tuple(v.shape) for k, v in flat.items()}
        # leaf path → {block key: (index, {device: tensor})}, in mesh order
        self.blocks: Dict[str, Dict[Tuple, Tuple[Tuple[slice, ...], Dict]]] = {
            k: {} for k in flat}
        self._locals: Dict[Tuple[int, ...], Any] = {}
        for pos in np.ndindex(*mesh.devices.shape):
            dev = mesh.devices[pos]
            local = {}
            for k, leaf in flat.items():
                idx = NamedSharding(mesh, flat_specs[k]).index_of(pos, leaf.shape)
                key = tuple((s.start, s.stop) for s in idx)
                copies = self.blocks[k].setdefault(key, (idx, {}))[1]
                if dev not in copies:
                    copies[dev] = (torch.as_tensor(leaf).detach()[idx].to(dev)
                                   .clone().requires_grad_(requires_grad))
                local[k] = copies[dev]
            self._locals[pos] = unflatten(local)

    def local(self, pos: Tuple[int, ...]) -> Any:
        return self._locals[tuple(pos)]

    def each_block(self):
        """(leaf path, index, copies in mesh order) per distinct block."""
        for k, blocks in self.blocks.items():
            for idx, copies in blocks.values():
                yield k, idx, list(copies.values())

    def masters(self) -> List[torch.Tensor]:
        """Every block's first copy, leaf by leaf: what the optimizer
        steps."""
        return [copies[0] for _, _, copies in self.each_block()]

    def tensors(self) -> List[torch.Tensor]:
        """Every copy of every block."""
        return [t for _, _, copies in self.each_block() for t in copies]

    def assemble(self, of: Callable[[torch.Tensor], torch.Tensor],
                 device=None) -> Dict[str, torch.Tensor]:
        """{leaf path: the whole leaf}, each block ``of(master)`` (the
        master itself, or e.g. its Adam moment), joined on ``device``
        (the mesh's first device by default)."""
        device = device if device is not None else self.mesh.first_device
        out: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for k, idx, copies in self.each_block():
                block = of(copies[0]).detach()
                if k not in out:
                    out[k] = torch.empty(self.shapes[k], dtype=block.dtype, device=device)
                out[k][idx] = block.to(device)
        return out

    def cut(self, flat: Dict[str, Any]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(master, its block of ``flat[path]``) per distinct block."""
        return [(copies[0], torch.as_tensor(flat[k])[idx])
                for k, idx, copies in self.each_block()]

    def zero_grad(self) -> None:
        for t in self.tensors():
            t.grad = None

    def reduce_grads(self) -> None:
        """Each master's gradient := the sum of its copies' gradients, in
        mesh order, on the master's device (a copy no loss reached adds
        nothing)."""
        from dvf_tpu_torch.parallel.sharded import rank_sum

        for _, _, copies in self.each_block():
            grads = [t.grad for t in copies if t.grad is not None]
            if len(copies) > 1 and grads:
                copies[0].grad = rank_sum(grads, copies[0].device)

    def broadcast(self) -> None:
        """Copy every master over its other copies."""
        with torch.no_grad():
            for _, _, copies in self.each_block():
                for t in copies[1:]:
                    t.copy_(copies[0], non_blocking=True)


def whole(params: Union[Dict[str, Any], MeshParams]) -> Dict[str, Any]:
    """A param tree with every leaf whole: the tree itself, or a
    :class:`MeshParams` assembled on its mesh's first device."""
    if isinstance(params, MeshParams):
        return unflatten(params.assemble(lambda t: t))
    return params


def _masters(params) -> List[torch.Tensor]:
    if isinstance(params, MeshParams):
        return params.masters()
    return list(flatten(params).values())


def trainable(params: Any, device: torch.device) -> Dict[str, Any]:
    """An owned copy of a param tree on ``device``, each leaf a float
    tensor that requires grad (the reference's layout, so
    ``convert.from_jax`` output and checkpoints drop in)."""
    return unflatten({k: torch.as_tensor(v).detach().to(device).clone()
                      .requires_grad_(True) for k, v in flatten(params).items()})


def adam(params: Any, learning_rate: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over the leaves of ``params`` with optax's
    defaults, its state filled as optax's ``init`` fills it."""
    opt = torch.optim.Adam(_masters(params), lr=learning_rate,
                           betas=BETAS, eps=EPS, weight_decay=0.0)
    for p in opt.param_groups[0]["params"]:
        opt.state[p] = {"step": torch.tensor(0.0, dtype=torch.float32),
                        "exp_avg": torch.zeros_like(p.detach()),
                        "exp_avg_sq": torch.zeros_like(p.detach())}
    return opt


def adam_state(opt: torch.optim.Adam, params: Any
               ) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(count, first moments, second moments), the moments keyed by leaf
    path (whole leaves, assembled from the blocks over a mesh). The count
    is read from a CPU tensor: no device sync."""
    count = int(opt.state[_masters(params)[0]]["step"])
    if isinstance(params, MeshParams):
        return (count, params.assemble(lambda p: opt.state[p]["exp_avg"]),
                params.assemble(lambda p: opt.state[p]["exp_avg_sq"]))
    leaves = flatten(params)
    states = [opt.state[p] for p in leaves.values()]
    return (count, {k: s["exp_avg"] for k, s in zip(leaves, states)},
            {k: s["exp_avg_sq"] for k, s in zip(leaves, states)})


def set_adam_state(opt: torch.optim.Adam, params: Any, count: int,
                   mu: Dict[str, Any], nu: Dict[str, Any]) -> None:
    """Put optax's (count, mu, nu) into ``opt``: each moment copied onto
    its leaf's device and dtype; ``step`` a CPU float32 tensor, as
    ``torch.optim.Adam`` keeps it when it is neither capturable nor
    fused. Over a mesh each master takes its block of the whole
    moments."""
    keys = (set(params.shapes) if isinstance(params, MeshParams)
            else set(flatten(params)))
    if set(mu) != keys or set(nu) != keys:
        raise KeyError(f"adam moments {sorted(set(mu) ^ keys)} do not "
                       f"match the params")
    if isinstance(params, MeshParams):
        pairs = zip(params.cut(mu), params.cut(nu))
        blocks = [(p, m, v) for (p, m), (_, v) in pairs]
    else:
        blocks = [(p, mu[k], nu[k]) for k, p in flatten(params).items()]
    for p, m, v in blocks:
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.as_tensor(m).detach().to(p.device, p.dtype).clone(),
            "exp_avg_sq": torch.as_tensor(v).detach().to(p.device, p.dtype).clone(),
        }


def place(params: Any, mesh, specs: Any) -> MeshParams:
    """A whole param tree as trainable blocks over ``mesh`` by ``specs``."""
    return MeshParams(params, mesh, specs, requires_grad=True)


def clone(params: Any, opt: torch.optim.Adam) -> Tuple[Any, torch.optim.Adam]:
    """Independent copies of a param tree (one device's or a mesh's) and
    of its optimizer (its learning rate, moments and count)."""
    if isinstance(params, MeshParams):
        new = place(whole(params), params.mesh, params.specs)
    else:
        new = trainable(params, next(iter(flatten(params).values())).device)
    new_opt = adam(new, opt.param_groups[0]["lr"])
    set_adam_state(new_opt, new, *adam_state(opt, params))
    return new, new_opt


class _PhaseMarks:
    """A traced step's phase boundaries: a host stamp at each, and on one
    card a timing event on the current stream, emitted to the tracer as
    ``train.step`` holding ``train.optim`` (``zero_grad``),
    ``train.forward``, ``train.backward`` and ``train.optim`` (the
    update), each tagged with the step's number and, on a card, timed on
    the device too (``Tracer.device_span``)."""

    PHASES = (TRAIN_OPTIM, TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_OPTIM)

    def __init__(self, tracer, step: int, device: Optional[torch.device]):
        self.tracer, self.step = tracer, step
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None and device.type == "cuda" else None)
        self.t: List[float] = []
        self.ev: List[torch.cuda.Event] = []
        self.mark()

    def mark(self) -> None:
        self.t.append(time.perf_counter())
        if self.stream is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            self.ev.append(ev)

    def close(self) -> None:
        self.mark()
        tr, t, step = self.tracer, self.t, self.step
        tr.complete(TRAIN_STEP, t[0], t[-1], step=step)
        for k, name in enumerate(self.PHASES):
            tr.complete(name, t[k], t[k + 1], step=step)
            if self.ev:
                tr.device_span(name, self.ev[k], self.ev[k + 1], step=step)


def descend(opt: torch.optim.Adam, loss_fn: Callable[[], Tuple[torch.Tensor, dict]],
            dtypes, params: Any = None, tracer=None, step: int = 0) -> dict:
    """One optimizer step on ``loss_fn()``'s loss: forward AND backward run
    with cuDNN's TF32 off where one of ``dtypes`` (the nets' compute
    dtypes) is float32 — a backward outside the block would convolve in
    TF32 on a card. With ``params`` a :class:`MeshParams` the copies'
    gradients are summed into the masters before the update and the
    masters copied back after it. Returns the loss function's metrics,
    detached 0-d tensors on the device (nothing here waits for the
    device). An enabled ``tracer`` gets the step's phases as spans tagged
    with ``step`` (:class:`_PhaseMarks`; host spans alone over a mesh)."""
    placed = isinstance(params, MeshParams)
    marks = None
    if tracer is not None and tracer.enabled:
        first = opt.param_groups[0]["params"][0]
        marks = _PhaseMarks(tracer, step, None if placed else first.device)
    if placed:
        params.zero_grad()
    else:
        opt.zero_grad(set_to_none=True)
    if marks is not None:
        marks.mark()
    with contextlib.ExitStack() as stack:
        for dtype in dtypes:
            stack.enter_context(exact_f32_convs(dtype))
        loss, metrics = loss_fn()
        if marks is not None:
            marks.mark()
        loss.backward()
    if marks is not None:
        marks.mark()
    if placed:
        params.reduce_grads()
    opt.step()
    if placed:
        params.broadcast()
    if marks is not None:
        marks.close()
    return {k: v.detach() for k, v in metrics.items()}


def group_mean(mesh, sharding, batch, group_loss) -> Tuple[torch.Tensor, dict]:
    """The loss of a batch over a mesh: the batch cut by ``sharding`` (one
    block per ``data`` × ``space`` group), ``group_loss(ranks, block)``
    per block on the block's ``model`` ranks (mesh positions, rank order),
    and the mean of the groups' losses and metrics, formed in group order
    on the mesh's first device (the reference's ``pmean``)."""
    from dvf_tpu_torch.parallel.sharded import as_sharded, model_groups, rank_sum

    sb, _ = as_sharded(batch, sharding)
    results = [group_loss(model_groups(mesh, blk.pos), x)
               for blk, x in zip(sb.blocks, sb.shards)]

    def mean(ts):
        return rank_sum(ts, mesh.first_device) / len(ts)

    loss = mean([r[0] for r in results])
    return loss, {k: mean([r[1][k] for r in results]) for k in results[0][1]}


def check_placed(state, mesh) -> None:
    """A sharded step takes a state placed on its own mesh."""
    placed = getattr(state.params, "mesh", None)
    if placed != mesh:
        raise ValueError(
            f"the state is placed on {placed!r}, the step's mesh is {mesh!r} "
            f"(shard_train_state(state, mesh, config) places it)")
