"""Host-side scheduling: drop-oldest ingest queue and reorder buffer."""

from dvf_tpu_torch.sched.reorder import ReorderBuffer  # noqa: F401
from dvf_tpu_torch.sched.queues import DropOldestQueue  # noqa: F401
