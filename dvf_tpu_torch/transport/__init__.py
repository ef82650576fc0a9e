"""Host transport of the port: the native frame ring (``ring``, and the
pipeline's ring queue in ``ring_queue``), the JPEG codecs and the
temporal-delta wire (``codec``), and the card-backed worker on the
reference's ZMQ wire (``zmq_ingress``). Importing the package needs
neither ``zmq`` nor a built native shim: both are loaded at first use."""

from dvf_tpu_torch.transport.ring import FrameRing  # noqa: F401
from dvf_tpu_torch.transport.codec import (  # noqa: F401
    WIRE_MODES,
    CoefficientFrame,
    DeltaCodec,
    DeltaResyncError,
    DeltaWireError,
    JpegCodec,
    JpegGeometryError,
    NativeJpegCodec,
    RawCodec,
    make_codec,
    make_wire_codec,
)
from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker  # noqa: F401
