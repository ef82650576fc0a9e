"""Parallelism over an in-host device mesh (port of ``dvf_tpu.parallel``):
the mesh and its shardings (``mesh``), sharded batches and their
collectives (``sharded``), halo-exchanged spatial sharding (``halo``) and
the layer pipeline (``pp``). One process drives every device of its
mesh. The multi-process runtime (``distributed``) is not ported yet
(ROADMAP Queue 1 item 4c)."""

from dvf_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    auto_mesh_config,
    batch_pspec,
    batch_sharding,
    make_mesh,
    replicated,
)
from dvf_tpu_torch.parallel.halo import halo_exchange_rows, spatial_filter  # noqa: F401
