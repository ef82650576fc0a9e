"""The Filter protocol — pure batch→batch functions with optional state.

Port of ``dvf_tpu.api.filter``: a filter maps a whole NHWC batch at once,
as ``(batch, state) -> (batch, state)``. State (e.g. a temporal window)
stays on the device across batches, threaded through the call by the
engine. The mesh hooks (``state_pspecs``, ``specialize``) let a filter
place its state over a mesh and swap in a mesh body; a mesh body names
the layout it takes in ``sharding``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

# A filter body maps (batch, state) -> (batch, state). ``state`` is any
# nesting of tensors (None for stateless filters).
FilterFn = Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Any]]


@dataclasses.dataclass(frozen=True)
class Filter:
    """A named, pure, batched frame filter.

    Attributes:
      name: registry name plus config, e.g. ``gaussian_blur(k=9,s=0.0)``.
      fn: ``(batch, state) -> (batch, state)`` over float NHWC in [0, 1].
      init_state: optional ``(batch_shape, dtype, device) -> state``
        building the initial device state.
      compute_dtype: dtype the engine casts uint8 frames to before ``fn``.
      uint8_ok: ``fn`` consumes uint8 batches directly (invert = 255 - x)
        and the engine skips the float round trip.
      halo: stencil radius in pixels (0 = pointwise, None = unknown).
      pad_safe: repeat-last-frame batch padding keeps the state right; the
        pipeline pads short batches, so it refuses stateful filters that
        are not pad-safe.
      clip: each output frame depends on every frame of its batch, so a
        batch must be consecutive frames of one stream, cut only where the
        stream ends: the pipeline never launches such a batch short while
        its source is live, and frontends that would cut or split it (the
        ZMQ worker, a mesh with a ``data`` or ``space`` axis) refuse it.
      members: the composed stages of a FilterChain, in order.
      state_pspecs: ``() -> PartitionSpec tree`` matching ``init_state``'s
        tree. On a mesh the engine places the state by these specs (a
        neural filter's weights sharded over ``model``: tensor
        parallelism; specs naming a size-1 axis replicate) and hands each
        block of the batch the state its device holds. Without them the
        state is threaded: one copy per ``space`` block, carried across
        the data blocks in batch order.
      specialize: ``(mesh, batch_shape) -> Filter | None``, called once
        per compile signature on a mesh; a Filter returned swaps in a
        mesh-aware body (style transfer's tensor-parallel forward when the
        mesh has a model axis). None keeps the generic body.
      sharding: set on a mesh body (``parallel.mesh.NamedSharding``):
        ``fn`` takes a ``ShardedBatch`` laid out so and returns one in the
        same layout (or, given a whole tensor, lays it out and returns a
        whole tensor). None: ``fn`` works on one device's tensor, and the
        engine runs it per block.
    """

    name: str
    fn: FilterFn
    init_state: Optional[Callable[[Sequence[int], Any, torch.device], Any]] = None
    compute_dtype: torch.dtype = torch.float32
    uint8_ok: bool = False
    halo: Optional[int] = None
    pad_safe: bool = True
    clip: bool = False
    members: Optional[Tuple["Filter", ...]] = None
    state_pspecs: Optional[Callable[[], Any]] = None
    specialize: Optional[Callable[[Any, Tuple[int, ...]], Optional["Filter"]]] = None
    sharding: Any = None

    @property
    def stateful(self) -> bool:
        return self.init_state is not None

    def __call__(self, batch: torch.Tensor, state: Any = None) -> Tuple[torch.Tensor, Any]:
        return self.fn(batch, state)


def stateless(name: str, fn: Callable[[torch.Tensor], torch.Tensor], **kw) -> Filter:
    """Wrap a plain ``batch -> batch`` function as a stateless Filter."""

    def wrapped(batch: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
        return fn(batch), state

    return Filter(name=name, fn=wrapped, **kw)


def FilterChain(*filters: Filter, name: Optional[str] = None) -> Filter:
    """Compose filters left-to-right into one Filter; state is the tuple
    of the member states."""
    chain_name = name or "|".join(f.name for f in filters)
    # Stencil radii compose additively along a chain; unknown taints all.
    halos = [f.halo for f in filters]
    chain_halo = sum(halos) if all(h is not None for h in halos) else None

    def fn(batch: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
        state = state if state is not None else tuple(None for _ in filters)
        new_states = []
        for f, s in zip(filters, state):
            batch, s2 = f.fn(batch, s)
            new_states.append(s2)
        return batch, tuple(new_states)

    init_state = None
    if any(f.stateful for f in filters):
        def init_state(batch_shape, dtype, device):  # noqa: F811
            return tuple(
                f.init_state(batch_shape, dtype, device) if f.stateful else None
                for f in filters
            )

    return Filter(
        name=chain_name,
        fn=fn,
        init_state=init_state,
        compute_dtype=filters[0].compute_dtype if filters else torch.float32,
        uint8_ok=all(f.uint8_ok for f in filters) if filters else False,
        halo=chain_halo,
        pad_safe=all(f.pad_safe for f in filters) if filters else True,
        clip=any(f.clip for f in filters),
        members=tuple(filters),
    )
