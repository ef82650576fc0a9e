"""Image dtype helpers."""

from dvf_tpu_torch.utils.image import (  # noqa: F401
    center_crop,
    to_float,
    to_uint8,
    rgb_to_gray,
)
