"""dvf_tpu_torch — the PyTorch/CUDA port of :mod:`dvf_tpu`.

The package mirrors ``dvf_tpu/`` module for module, so each counterpart
is found by its path (``dvf_tpu_torch/ops/bilateral.py`` ports
``dvf_tpu/ops/bilateral.py``). It imports torch, numpy and the standard
library only — never jax, never ``dvf_tpu``.

Conventions kept from the reference so the two packages compare like with
like: NHWC at every public function, float32 in [0, 1] inside filter
bodies, uint8 on the wire; the same registered filter names and ``impl``
labels. In this package ``impl="pallas"`` (and the ``*_pallas`` filter
names) denotes the hand-written Hopper CUDA kernel in
``dvf_tpu_torch/csrc/`` that replaces the TPU's Pallas kernel.

Entry points (``Engine``, ``Pipeline``, ``ZmqWorker``, ``ServeFrontend``)
run on ``cuda:0`` unless the caller passes ``device="cpu"``; they never
fall back to the CPU on their own.
"""

__version__ = "0.1.0"

from dvf_tpu_torch.api.filter import Filter, FilterChain  # noqa: F401
from dvf_tpu_torch.ops import get_filter, list_filters, register_filter  # noqa: F401
from dvf_tpu_torch.runtime.engine import Engine  # noqa: F401
from dvf_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig  # noqa: F401
from dvf_tpu_torch.serve import ServeConfig, ServeFrontend  # noqa: F401
from dvf_tpu_torch.runtime.ingest import ShardedBatchAssembler  # noqa: F401
from dvf_tpu_torch.runtime.egress import ShardedBatchFetcher  # noqa: F401
from dvf_tpu_torch.obs.trace import Tracer  # noqa: F401
from dvf_tpu_torch.resilience import FaultPlan  # noqa: F401
from dvf_tpu_torch.io.sources import SyntheticSource  # noqa: F401
from dvf_tpu_torch.io.sinks import CallbackSink, NullSink  # noqa: F401
from dvf_tpu_torch.sched.reorder import ReorderBuffer  # noqa: F401
from dvf_tpu_torch.sched.queues import DropOldestQueue  # noqa: F401
from dvf_tpu_torch.runtime.codec_assist import (  # noqa: F401
    DeviceDeltaProbe,
    FusedDeltaTransform,
)
from dvf_tpu_torch.transport import (  # noqa: F401
    DeltaCodec,
    NativeJpegCodec,
    RawCodec,
    ZmqWorker,
    make_codec,
    make_wire_codec,
)
