"""Streaming metrics, the frame-lifecycle tracer, the metrics registry
and scrape endpoint, the reconfiguration ledger and memory accounting
(the ported part of ``dvf_tpu.obs``'s exports; the lineage, audit,
viewer and flight-recorder planes are not ported yet)."""

from dvf_tpu_torch.obs.metrics import LatencyStats  # noqa: F401
from dvf_tpu_torch.obs.trace import Tracer, merge_tracer_snapshots  # noqa: F401
from dvf_tpu_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    TimeSeriesRing,
    check_metric_name,
    walk_export,
)
from dvf_tpu_torch.obs.export import (  # noqa: F401
    MetricsExporter,
    attach_signal_provider,
    samples_from_signals,
)
from dvf_tpu_torch.obs.ledger import ReconfigLedger  # noqa: F401
from dvf_tpu_torch.obs.memory import (  # noqa: F401
    LeakTrendWatch,
    attach_memory_provider,
    memory_summary,
)
