"""The Filter contract."""

from dvf_tpu_torch.api.filter import Filter, FilterChain  # noqa: F401
