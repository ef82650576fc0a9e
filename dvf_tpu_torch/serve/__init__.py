"""Multi-stream serving frontend: N tenant streams, one shared engine
(port of ``dvf_tpu.serve``).

The layer between the single-stream pipeline (`runtime.pipeline`) and
the north star's many-clients workload: per-stream sessions with their
own index space, ingress bound, and latency SLO (`serve.session`); a
continuous cross-session batcher with EDF scheduling and SLO-headroom
shedding (`serve.batcher`); the admission-controlled front door with the
in-process open/submit/poll/close API and the reference-wire ZMQ bridge
(`serve.server`); and the result router that demultiplexes shared
batches back to per-session reorder buffers (`serve.router`).
"""

from dvf_tpu_torch.serve.batcher import BatchPlan, ContinuousBatcher
from dvf_tpu_torch.serve.router import ResultRouter
from dvf_tpu_torch.serve.server import ServeConfig, ServeFrontend, ZmqStreamBridge
from dvf_tpu_torch.serve.session import (
    AdmissionError,
    Delivery,
    ServeError,
    SessionClosedError,
    SessionConfig,
    StreamSession,
)

__all__ = [
    "AdmissionError",
    "BatchPlan",
    "ContinuousBatcher",
    "Delivery",
    "ResultRouter",
    "ServeConfig",
    "ServeError",
    "ServeFrontend",
    "SessionClosedError",
    "SessionConfig",
    "StreamSession",
    "ZmqStreamBridge",
]
