"""Fleet tier: N engine replicas behind one front door (port of
``dvf_tpu.fleet``).

The scale-out layer above ``dvf_tpu_torch/serve``. One ``FleetFrontend``
routes client sessions across N complete replicas (each a
``ServeFrontend`` + engine, in-process on one device or in its own
process) with session affinity, spillover admission, replica health
tracking with drain → migrate → restart, and fleet-merged stats.

The multi-host flavor (``MultiHostEngine``, ``MultiHostReplica``) is one
replica spanning a process group, on ``parallel.distributed``.
"""

from dvf_tpu_torch.fleet.admission import SpilloverAdmission
from dvf_tpu_torch.fleet.elastic import (
    ElasticFleetPlane,
    StandbyPool,
    live_standby_handles,
)
from dvf_tpu_torch.fleet.multihost import MultiHostReplica
from dvf_tpu_torch.fleet.multiproc import MultiHostEngine
from dvf_tpu_torch.fleet.replica import (
    DEAD,
    DRAINING,
    HEALTHY,
    RESTARTING,
    LocalReplica,
    ProcessReplica,
    ReplicaHandle,
    ReplicaLostError,
)
from dvf_tpu_torch.fleet.router import FLEET_MODES, FleetConfig, FleetFrontend

__all__ = [
    "DEAD",
    "DRAINING",
    "ElasticFleetPlane",
    "FLEET_MODES",
    "FleetConfig",
    "FleetFrontend",
    "HEALTHY",
    "LocalReplica",
    "MultiHostEngine",
    "MultiHostReplica",
    "ProcessReplica",
    "RESTARTING",
    "ReplicaHandle",
    "ReplicaLostError",
    "SpilloverAdmission",
    "StandbyPool",
    "live_standby_handles",
]
