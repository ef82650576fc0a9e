"""Layer pipeline parallelism (GPipe schedule) over a homogeneous stack
(port of ``dvf_tpu.parallel.pp``).

Each device along the mesh's ``model`` axis holds a contiguous slice of a
homogeneous layer stack (one stage), activations hop stage→stage with one
copy per tick, and microbatches keep every stage busy outside the
(S-1)-tick fill/drain bubble.

Schedule (S stages, M microbatches, T = M + S - 1 ticks):

    tick t:  stage 0 takes microbatch t (t < M)
             every stage s with a microbatch (0 <= t - s < M) applies its
             L/S resident layers on its own device
             activations move to the next stage's device
             stage S-1's result for microbatch t-(S-1) is final

One process issues the whole schedule: each stage's work goes onto its
own device's current stream, and the hop is PyTorch's cross-device copy,
ordered against both devices' streams, so the stages of one tick overlap
on distinct devices without any host synchronisation. The reference fills
the bubble with zeros and masks them out of a final ``psum``; here the
bubble is simply not issued, and the result is gathered back to stage
0's device.

This is parameter-partitioned pipelining: each device only ever holds
its own L/S layers' weights. Heterogeneous prologs/epilogs (a net's
stem/decoder) stay outside the pipelined stack (see
models.style_transfer's ``parallel="pp"`` wiring).
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from dvf_tpu_torch.parallel.mesh import P


def stack_layer_params(params_list: Sequence[Any]) -> Any:
    """Stack per-layer param trees (same structure: nested dicts of
    tensors) along a new leading axis: L trees → one tree whose leaves
    have leading dim L."""
    first = params_list[0]
    if isinstance(first, dict):
        return {k: stack_layer_params([p[k] for p in params_list]) for k in first}
    return torch.stack(list(params_list), dim=0)


def pipeline_stage_specs(pspec_axis: str, params_stacked: Any) -> Any:
    """PartitionSpec tree placing the stacked-layer leading dim on
    ``pspec_axis`` (each device holds its stage's contiguous layer slice)."""
    if isinstance(params_stacked, dict):
        return {k: pipeline_stage_specs(pspec_axis, v)
                for k, v in params_stacked.items()}
    return P(pspec_axis, *([None] * (params_stacked.dim() - 1)))


def _layer(stacked: Any, i: int) -> Any:
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _n_layers(stacked: Any) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def run_stage(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
              stage_params: Any, x: torch.Tensor) -> torch.Tensor:
    """Apply a stage's stacked layers in order."""
    for i in range(_n_layers(stage_params)):
        x = layer_fn(_layer(stage_params, i), x)
    return x


def microbatches(b: int, s: int, n_microbatches: int = 0) -> int:
    """``n_microbatches`` when given (> 1; must divide ``b``), else the
    largest divisor of ``b`` not exceeding ``s`` — enough to fill the
    pipeline when ``b`` allows, and always legal (b=6 over S=4 picks m=3
    rather than failing on min(b, s)=4)."""
    if n_microbatches and n_microbatches > 1:
        if b % n_microbatches != 0:
            raise ValueError(f"microbatches {n_microbatches} must divide batch {b}")
        return n_microbatches
    return next(d for d in range(min(b, s), 0, -1) if b % d == 0)


def pipeline_apply(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Sequence[Any],
    x: torch.Tensor,
    devices: Sequence[torch.device],
    n_microbatches: int = 0,
) -> torch.Tensor:
    """Apply L stacked layers to ``x`` with a pipeline schedule.

    ``stage_params[s]`` is stage s's slice of the stacked params (leaves
    of shape (L/S, ...)) on ``devices[s]``; ``x`` is the activation batch
    (B, ...). Returns layer_fn composed L times over x, on ``x``'s device.

    ``n_microbatches``: 0/1 → auto (:func:`microbatches`); otherwise must
    divide B.
    """
    s = len(stage_params)
    b = x.shape[0]
    m = microbatches(b, s, n_microbatches)
    if s == 1:
        return run_stage(layer_fn, stage_params[0], x)
    mb = b // m
    inbox: List[List[Any]] = [[None] * m for _ in range(s)]
    for k in range(m):
        inbox[0][k] = x[k * mb:(k + 1) * mb].to(devices[0], non_blocking=True)
    done: List[Any] = [None] * m
    for t in range(m + s - 1):
        # Later stages first within a tick: each consumes what the stage
        # before it produced on an earlier tick.
        for st in range(s - 1, -1, -1):
            k = t - st
            if not 0 <= k < m:
                continue
            act = run_stage(layer_fn, stage_params[st], inbox[st][k])
            inbox[st][k] = None
            if st == s - 1:
                done[k] = act.to(x.device, non_blocking=True)
            else:
                inbox[st + 1][k] = act.to(devices[st + 1], non_blocking=True)
    return torch.cat(done, dim=0) if m > 1 else done[0]
