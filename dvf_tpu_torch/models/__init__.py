"""Neural filter models (port of ``dvf_tpu.models``): the feed-forward
style-transfer net (BASELINE.json configs[4]) and the ESPCN
super-resolution net, as functional ``init(seed, config) -> params`` and
``apply(params, batch) -> batch``. The VGG encoder serves only training
and waits for the training slice."""

from dvf_tpu_torch.models.style_transfer import (  # noqa: F401
    StyleNetConfig,
    init_style_net,
    apply_style_net,
)
from dvf_tpu_torch.models.espcn import (  # noqa: F401
    EspcnConfig,
    apply_espcn,
    init_espcn,
)
