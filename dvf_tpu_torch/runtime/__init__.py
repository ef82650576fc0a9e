"""Device engine and the single-stream pipeline."""

from dvf_tpu_torch.runtime.engine import Engine  # noqa: F401
from dvf_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig  # noqa: F401
