"""Parallelism helpers (port of ``dvf_tpu.parallel``). Ported: the mesh
arithmetic of ``mesh.py`` (``MeshConfig``, ``auto_mesh_config``) and the
layer stacking of ``pp.py``. Building meshes over devices, the shardings,
halo exchange, the pipeline schedule and the distributed runtime wait for
the multi-GPU slice."""

from dvf_tpu_torch.parallel.mesh import MeshConfig, auto_mesh_config  # noqa: F401
