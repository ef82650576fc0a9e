"""Frame sources and sinks."""

from dvf_tpu_torch.io.sources import (  # noqa: F401
    ShmRingSource,
    SyntheticSource,
    VideoFileSource,
    WebcamSource,
)
from dvf_tpu_torch.io.sinks import CallbackSink, NullSink  # noqa: F401
