"""Device-mesh arithmetic (port of the arithmetic half of
``dvf_tpu.parallel.mesh``).

A mesh names three axes: ``data`` (batch-axis data parallelism),
``space`` (the H axis of one frame split across devices, with halo
exchange) and ``model`` (tensor parallelism over filter-internal
channels). :class:`MeshConfig` and :func:`auto_mesh_config` are pure
arithmetic over a device count: the command line's ``--mesh`` parser and
``doctor``'s ``mesh_suggestions`` use them. Building a mesh over devices
(``make_mesh``) and its canonical shardings (``batch_pspec``,
``batch_sharding``, ``replicated``, ``pad_batch_size``) wait for the
multi-GPU piece of the port; until then every engine runs on one device.
"""

from __future__ import annotations

import dataclasses

AXES = ("data", "space", "model")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    space: int = 1
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.space * self.model


def auto_mesh_config(n_devices: int, prefer: str = "data") -> MeshConfig:
    """Factor ``n_devices`` into mesh axes.

    Default policy is all-``data`` (batch DP): for the pointwise/stencil
    filter families, per-frame work fits one device comfortably and batch
    DP has zero collective traffic — the fastest layout, mirroring the
    reference's choice of pure inter-frame parallelism. ``prefer="space"``
    splits a factor of 2 onto the spatial axis (large-frame configs),
    ``prefer="model"`` onto TP (style-transfer config).
    """
    if prefer == "data" or n_devices == 1:
        return MeshConfig(data=n_devices)
    half = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // half
    if prefer == "space":
        return MeshConfig(data=rest, space=half)
    if prefer == "model":
        return MeshConfig(data=rest, model=half)
    raise ValueError(f"unknown preference {prefer!r}")
