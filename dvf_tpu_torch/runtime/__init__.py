"""Device engine, streamed ingest and egress, and the single-stream
pipeline (the exports of ``dvf_tpu.runtime``)."""

from dvf_tpu_torch.runtime.egress import (  # noqa: F401
    AsyncCodecPlane,
    ShardedBatchFetcher,
)
from dvf_tpu_torch.runtime.engine import Engine  # noqa: F401
from dvf_tpu_torch.runtime.ingest import ShardedBatchAssembler  # noqa: F401
from dvf_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig  # noqa: F401
