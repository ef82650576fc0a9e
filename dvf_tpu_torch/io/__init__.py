"""Frame sources and sinks."""

from dvf_tpu_torch.io.sources import ShmRingSource, SyntheticSource  # noqa: F401
from dvf_tpu_torch.io.sinks import CallbackSink, NullSink  # noqa: F401
