"""Parallelism helpers (port of ``dvf_tpu.parallel``). Only the layer
stacking of ``pp.py`` is ported; the meshes, halo exchange, the pipeline
schedule and the distributed runtime wait for the multi-GPU slice."""
