"""Neural filter models (port of ``dvf_tpu.models``): the feed-forward
style-transfer net (BASELINE.json configs[4]), the small VGG encoder that
gives its training perceptual features, the ESPCN super-resolution net
and HAT-SRx4 (the port's own; the JAX package has none), as functional
``init(seed, config) -> params`` and ``apply(params, batch) -> batch``,
with the spec trees of their tensor parallelism over a mesh's ``model``
axis (``param_pspecs``)."""

from dvf_tpu_torch.models.style_transfer import (  # noqa: F401
    StyleNetConfig,
    init_style_net,
    apply_style_net,
    param_pspecs,
)
from dvf_tpu_torch.models.espcn import (  # noqa: F401
    EspcnConfig,
    apply_espcn,
    init_espcn,
)
from dvf_tpu_torch.models.hat import HatConfig, apply_hat, init_hat  # noqa: F401
from dvf_tpu_torch.models.vgg import VGGConfig, init_vgg, vgg_features  # noqa: F401
