"""Streaming metrics and the frame-lifecycle tracer (the ported part of
``dvf_tpu.obs``'s exports; the registry, export, lineage, ledger and
memory planes are not ported yet)."""

from dvf_tpu_torch.obs.metrics import LatencyStats  # noqa: F401
from dvf_tpu_torch.obs.trace import Tracer, merge_tracer_snapshots  # noqa: F401
