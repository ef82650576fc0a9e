"""Device meshes and canonical shardings (port of
``dvf_tpu.parallel.mesh``).

A mesh names three axes over an array of devices: ``data`` (batch-axis
data parallelism), ``space`` (the H axis of one frame split across
devices, with halo exchange) and ``model`` (tensor or pipeline
parallelism over a neural filter's channels or layers).

One process drives every device of its mesh: a :class:`Mesh` is an
array of ``torch.device`` shaped ``(data, space, model)``. The device list
may repeat a device. That is how the CPU tests get eight devices out of
torch's one CPU device, and how a ``space=4`` mesh runs on one card:
shards that share a device run one after another on its current stream.
(The reference forbids duplicate devices; its CPU gets eight from an XLA
flag.) A mesh over a process group (``parallel.distributed``) records
which rank owns each position; a process addresses only its own.

A sharding (:class:`NamedSharding`) lays a batch out over the mesh by a
:class:`PartitionSpec` that names, per dimension, the mesh axes that split
it. Only block layouts exist: every split is even (``batch_pspec`` leaves
an axis that does not divide replicated), and the model axis only
partitions a filter's parameters. Sharded batches themselves
(``parallel.sharded``) keep one tensor per distinct block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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


def local_devices() -> List[torch.device]:
    """Every card this process sees, ``cuda:0`` first; empty without CUDA.
    The one device list the command line and the fleet's local replicas
    build meshes from (tests substitute a list of CPU entries here)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An array of devices with named axes (``AXES``).

    A mesh may span processes (``parallel.distributed.global_mesh``):
    ``processes`` is then the rank that owns each position, and
    ``process_id`` the rank of the process holding this object. Only the
    positions it owns are addressable here; the devices at the others are
    labels (the group's convention for its peers' cards), never touched.
    A mesh of one process owns every position."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXES,
                 processes: Optional[np.ndarray] = None, process_id: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = (np.full(devices.shape, process_id, dtype=np.int64)
                          if processes is None
                          else np.asarray(processes, dtype=np.int64).reshape(devices.shape))
        self.process_id = int(process_id)

    @property
    def process_count(self) -> int:
        """How many processes own positions of the mesh."""
        return len(set(self.processes.flat))

    def owns(self, pos: Tuple[int, ...]) -> bool:
        """Whether the position at ``pos`` is this process's."""
        return int(self.processes[pos]) == self.process_id

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """The device at this process's first position (of a mesh of one
        process: the first position)."""
        return self.distinct_devices()[0]

    def distinct_devices(self) -> List[torch.device]:
        """The devices of the mesh this process owns, each once, in mesh
        order."""
        out: List[torch.device] = []
        for pos in np.ndindex(*self.devices.shape):
            d = self.devices[pos]
            if self.owns(pos) and d not in out:
                out.append(d)
        return out

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat)
                and np.array_equal(self.processes, other.processes)
                and self.process_id == other.process_id)

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.flat)))

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.devices.flat]})"


def _check_device(dev: Union[str, torch.device]) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; give make_mesh a list of CPU "
                "devices to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} does not exist: "
                             f"{torch.cuda.device_count()} CUDA devices")
    elif dev.type != "cpu":
        raise ValueError(f"mesh devices must be CUDA devices or 'cpu', got {dev}")
    return dev


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    processes: Optional[Sequence[int]] = None,
    process_id: int = 0,
) -> Mesh:
    """Build a Mesh with axes ('data', 'space', 'model').

    ``devices`` defaults to every visible card (:func:`local_devices`);
    without CUDA that list is empty and the call raises. The list may
    repeat a device (virtual meshes). ``processes`` (one rank per entry
    of ``devices``) and ``process_id`` describe a mesh over a process
    group (:class:`Mesh`)."""
    devices = list(devices if devices is not None else local_devices())
    if config is None:
        config = auto_mesh_config(max(1, len(devices)))
    if config.n_devices > len(devices):
        raise ValueError(
            f"mesh {config} needs {config.n_devices} devices, have {len(devices)}"
        )
    devices = [_check_device(d) for d in devices[: config.n_devices]]
    arr = np.empty(config.n_devices, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    shape = (config.data, config.space, config.model)
    procs = (None if processes is None
             else np.asarray(list(processes)[: config.n_devices]).reshape(shape))
    return Mesh(arr.reshape(shape), AXES, processes=procs, process_id=process_id)


class PartitionSpec(tuple):
    """Per dimension: None (not split), an axis name, or a tuple of axis
    names (split over their product, the first outermost). Dimensions past
    the spec's length are not split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class Shard(NamedTuple):
    """One distinct block of a sharded array: where it lives (the first
    mesh position that holds it, in mesh order) and which slice of the
    global array it is."""
    pos: Tuple[int, ...]
    device: torch.device
    index: Tuple[slice, ...]


class NamedSharding:
    """A layout of arrays over a mesh by a PartitionSpec."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        for entry in self.spec:
            for ax in _axes_of(entry):
                if ax not in mesh.axis_names:
                    raise ValueError(f"unknown mesh axis {ax!r} in {self.spec}")

    def parts(self, dim: int) -> int:
        """How many blocks dimension ``dim`` is cut into."""
        if dim >= len(self.spec):
            return 1
        return math.prod(self.mesh.axis_size(a) for a in _axes_of(self.spec[dim]))

    def _block(self, pos: Tuple[int, ...], dim: int) -> int:
        """The block of dimension ``dim`` the device at ``pos`` holds."""
        if dim >= len(self.spec):
            return 0
        k = 0
        for ax in _axes_of(self.spec[dim]):
            i = self.mesh.axis_names.index(ax)
            k = k * self.mesh.devices.shape[i] + pos[i]
        return k

    def index_of(self, pos: Tuple[int, ...], shape: Sequence[int]) -> Tuple[slice, ...]:
        out = []
        for dim, n in enumerate(shape):
            parts = self.parts(dim)
            if n % parts:
                raise ValueError(
                    f"dimension {dim} of {tuple(shape)} does not divide into "
                    f"{parts} blocks ({self.spec})")
            step = n // parts
            k = self._block(pos, dim)
            out.append(slice(k * step, (k + 1) * step))
        return tuple(out)

    def devices_indices_map(self, shape: Sequence[int]) -> Dict[Tuple[int, ...], Tuple[slice, ...]]:
        """Every mesh position → the slice of the global array it holds.
        Keyed by mesh position, not by device: a virtual mesh repeats
        devices (``Mesh.devices[pos]`` is the device)."""
        return {pos: self.index_of(pos, shape)
                for pos in np.ndindex(*self.mesh.devices.shape)}

    def shards(self, shape: Sequence[int]) -> List[Shard]:
        """The distinct blocks this process addresses, in mesh order, each
        on the first of its positions that holds it (replicas are not
        materialised)."""
        seen = {}
        for pos, idx in self.devices_indices_map(shape).items():
            if not self.mesh.owns(pos):
                continue
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen[key] = Shard(pos, self.mesh.devices[pos], idx)
        return list(seen.values())

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n // self.parts(d) for d, n in enumerate(shape))

    def global_shape(self, local: Sequence[int]) -> Tuple[int, ...]:
        """The global shape whose blocks have shape ``local``."""
        return tuple(n * self.parts(d) for d, n in enumerate(local))

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and tuple(self.spec) == tuple(other.spec))

    def __hash__(self) -> int:
        return hash((self.mesh, tuple(self.spec)))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def batch_pspec(mesh: Mesh, batch_shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """PartitionSpec for an NHWC frame batch: B over data, H over space.

    C stays replicated — channel counts (3) are far below tile widths; the
    ``model`` axis only shards filter-internal tensors (style net weights).
    If ``batch_shape`` is given, an axis is only sharded when its dimension
    divides evenly (a 4-frame batch on an 8-way data mesh replicates rather
    than erroring — correctness first, the engine logs the inefficiency).
    """
    b_ax = mesh.axis_size("data")
    h_ax = mesh.axis_size("space")
    b = "data" if b_ax > 1 else None
    h = "space" if h_ax > 1 else None
    if batch_shape is not None:
        if b and batch_shape[0] % b_ax != 0:
            b = None
        if h and batch_shape[1] % h_ax != 0:
            h = None
    return P(b, h, None, None)


def batch_sharding(mesh: Mesh, batch_shape: Optional[Sequence[int]] = None) -> NamedSharding:
    return NamedSharding(mesh, batch_pspec(mesh, batch_shape))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch_size(b: int, mesh: Mesh) -> int:
    """Round batch up to a multiple of the data-axis size."""
    d = mesh.axis_size("data")
    return int(math.ceil(b / d) * d)
