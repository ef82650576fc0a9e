"""Training subsystem (port of ``dvf_tpu.train``): the style net's
perceptual-loss step with its VGG encoder (``style.py``), the ESPCN
self-supervised step (``sr.py``), checkpoint and resume over ``.npz``
files (``checkpoint.py``) and the optimizer they share (``optim.py``).
Each step runs on the state's device, or over a mesh (batch data-parallel
over ``data`` × ``space``, params tensor-parallel over ``model``) once
the state is placed there by its family's ``shard_train_state``."""

from dvf_tpu_torch.train.style import (  # noqa: F401
    StyleTrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
    style_loss_fn,
)
from dvf_tpu_torch.train.sr import (  # noqa: F401
    SrTrainConfig,
    SrTrainState,
)
