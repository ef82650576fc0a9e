"""Streaming metrics, the frame-lifecycle tracer and its device-trace
merge, the metrics registry and scrape endpoint, the flight recorder,
frame lineage, the reconfiguration ledger, memory accounting and the
audit plane (the port of ``dvf_tpu.obs``'s exports)."""

from dvf_tpu_torch.obs.trace import Tracer, merge_tracer_snapshots  # noqa: F401
from dvf_tpu_torch.obs.metrics import LatencyStats  # noqa: F401
from dvf_tpu_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    TimeSeriesRing,
    check_metric_name,
    walk_export,
)
from dvf_tpu_torch.obs.export import (  # noqa: F401
    FlightRecorder,
    MetricsExporter,
    attach_signal_provider,
    samples_from_signals,
)
from dvf_tpu_torch.obs.lineage import (  # noqa: F401
    AttributionAggregate,
    AttributionPlane,
    FrameLineage,
    load_stage_profile,
    save_stage_profile,
)
from dvf_tpu_torch.obs.ledger import ReconfigLedger  # noqa: F401
from dvf_tpu_torch.obs.memory import (  # noqa: F401
    LeakTrendWatch,
    attach_memory_provider,
    memory_summary,
)
