"""Spatial parallelism with explicit halo exchange (port of
``dvf_tpu.parallel.halo``).

One frame is sharded across devices on the H axis, and each stencil op
needs its neighbours' boundary rows: the halo. The exchange is explicit:
every ``space`` block receives ``r`` rows from each ring neighbour (a copy
from the neighbour's device), runs the unmodified filter body on the
extended slab, and discards the outer ``r`` output rows. The filter's own
reflect padding only ever touches rows that get discarded, so any
stencil filter of radius ≤ r composes with this wrapper unchanged. The
global top/bottom blocks substitute reflect-101 rows (cv2's default
border, matching the unsharded ops) for the missing neighbour.

Every extended slab is a fresh contiguous tensor on its block's device,
so the hand kernels (K1–K3), which take only contiguous NHWC tensors,
run on it once per block.

Chains: for a FilterChain, halos are exchanged **per stage**. A single
summed-radius exchange around the fused chain is NOT exact at the global
top/bottom border: edge blocks would compute stage2(stage1(reflect(x)))
where the unsharded chain computes stage2(reflect(stage1(x))) — these
differ whenever a stage's intermediate is not reflection-symmetric (e.g.
a directional gradient). Per-stage exchange reproduces the unsharded
border semantics exactly; pass ``per_stage=False`` to get the cheaper
fused exchange when you know every intermediate is symmetric.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
from dvf_tpu_torch.parallel.sharded import ShardedBatch, as_sharded, finish


def halo_exchange_rows(slabs: Sequence[torch.Tensor], r: int) -> List[torch.Tensor]:
    """Extend each (B, H_local, W, C) slab of one ``space`` ring (in ring
    order, each on its own device) by ``r`` rows from each neighbour.

    The first/last slabs use reflect-101 of their own edge instead of the
    ring wrap, so the joined result matches reflect-padded single-device
    semantics. Each returned slab is contiguous on its input's device."""
    n = len(slabs)
    for x in slabs:
        if x.shape[1] <= r:
            raise ValueError(
                f"local slab has {x.shape[1]} rows but the stencil radius is {r}; "
                f"use fewer 'space' shards (or taller frames) so each shard owns "
                f"more than r rows"
            )
    out = []
    for i, x in enumerate(slabs):
        if i == 0:
            top = x[:, 1:r + 1].flip(1)   # reflect-101: edge row not repeated
        else:
            top = slabs[i - 1][:, -r:].to(x.device, non_blocking=True)
        if i == n - 1:
            bot = x[:, -r - 1:-1].flip(1)
        else:
            bot = slabs[i + 1][:, :r].to(x.device, non_blocking=True)
        out.append(torch.cat([top, x, bot], dim=1))
    return out


def _stage(slabs: List[torch.Tensor], f: Filter, r: int) -> List[torch.Tensor]:
    """One overlap-and-discard stage over one ring."""
    if r > 0:
        ext = halo_exchange_rows(slabs, r)
        return [f.fn(x, None)[0][:, r:-r].contiguous() for x in ext]
    return [f.fn(x, None)[0] for x in slabs]


def spatial_filter(
    filt: Filter,
    mesh: Mesh,
    halo: Optional[int] = None,
    data_sharded: bool = True,
    per_stage: Optional[bool] = None,
) -> Filter:
    """Wrap a stateless stencil filter for H-sharded execution.

    The returned Filter's body takes a batch laid out ``P('data',
    'space')`` over ``mesh`` (``P(None, 'space')`` with
    ``data_sharded=False``, when the batch does not divide the data
    axis): each block halo-exchanges ``r`` rows, applies the original
    filter body to the extended slab, and drops the halo rows of the
    output. Called on a whole tensor it lays it out first and hands back
    a whole tensor. Requires ``filt.halo`` (stencil radius in rows) or an
    explicit ``halo=``; stateful filters are not supported (state
    row-sharding is filter-specific).

    ``per_stage`` (default: auto — on when the filter is a chain with
    per-member halos): exchange halos per chain member for exact global-
    border semantics (module docstring). ``False`` forces one fused
    summed-radius exchange (cheaper, assumes reflection-symmetric
    intermediates).
    """
    if filt.stateful:
        raise ValueError("spatial_filter supports stateless filters only")

    members = filt.members
    if per_stage is None:
        per_stage = (
            members is not None
            and all(not m.stateful and m.halo is not None for m in members)
        )
    r = halo if halo is not None else filt.halo
    if r is None:
        raise ValueError(
            f"filter {filt.name!r} has no halo radius; pass halo= explicitly"
        )

    if mesh.axis_size("space") == 1:
        return Filter(
            name=f"spatial({filt.name})",
            fn=filt.fn,
            compute_dtype=filt.compute_dtype,
            uint8_ok=filt.uint8_ok,
            halo=filt.halo,
        )

    sharding = NamedSharding(mesh, P("data" if data_sharded else None, "space"))
    stages = [(m, m.halo) for m in members] if per_stage else [(filt, r)]

    def fn(batch: Any, state):
        sb, whole = as_sharded(batch, sharding)
        out: List[Optional[torch.Tensor]] = [None] * len(sb.shards)
        for ring in sb.grid():
            slabs = [sb.shards[i] for i in ring]
            for f, fr in stages:
                slabs = _stage(slabs, f, fr)
            for i, y in zip(ring, slabs):
                out[i] = y
        res = ShardedBatch(out, sharding, sharding.global_shape(out[0].shape))
        return finish(res, whole, batch), state

    return Filter(
        name=f"spatial({filt.name})",
        fn=fn,
        compute_dtype=filt.compute_dtype,
        uint8_ok=filt.uint8_ok,
        halo=filt.halo,
        sharding=sharding,
    )
