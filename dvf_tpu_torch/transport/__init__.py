"""Host transport of the port: the JPEG codec and the temporal-delta wire
(``codec``), and the card-backed worker on the reference's ZMQ wire
(``zmq_ingress``). Importing the package needs neither ``zmq`` nor a built
JPEG shim: both are loaded at first use."""

from dvf_tpu_torch.transport.codec import (  # noqa: F401
    WIRE_MODES,
    CoefficientFrame,
    DeltaCodec,
    DeltaResyncError,
    DeltaWireError,
    JpegGeometryError,
    NativeJpegCodec,
    RawCodec,
    make_codec,
    make_wire_codec,
)
from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker  # noqa: F401
