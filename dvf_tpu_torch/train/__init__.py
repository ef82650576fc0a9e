"""Training subsystem (port of ``dvf_tpu.train``). Ported so far: the
inference-side checkpoint loaders (``checkpoint.py``) and the SR family's
data helpers (``sr.py``). The train steps, the optimizers and the VGG
perceptual loss wait for the training slice."""
