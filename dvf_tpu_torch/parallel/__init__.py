"""Parallelism over an in-host device mesh (port of ``dvf_tpu.parallel``):
the mesh and its shardings (``mesh``), sharded batches and their
collectives (``sharded``), halo-exchanged spatial sharding (``halo``) and
the layer pipeline (``pp``). One process drives every device of its
mesh; the multi-process runtime (``distributed``) joins processes in a
torch.distributed group, one mesh over all of them."""

from dvf_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    auto_mesh_config,
    batch_pspec,
    batch_sharding,
    make_mesh,
    replicated,
)
from dvf_tpu_torch.parallel.halo import halo_exchange_rows, spatial_filter  # noqa: F401
