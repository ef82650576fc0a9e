"""The port's WebcamSource with a mocked cv2.VideoCapture (counterpart of
tests/test_webcam_source.py, with the same FakeCapture).

The capture leg of the reference's use case (webcam_app.py:67-116)
cannot run without a camera, so these tests pin the contract with a fake
driver: capture settings applied, BGR->RGB + center-crop per
frame, release() on every exit path, dead-camera termination without a
hang, and the full Pipeline running end-to-end on the mocked camera.
"""

from __future__ import annotations

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from dvf_tpu_torch.io.sources import WebcamSource  # noqa: E402


class FakeCapture:
    """Stands in for cv2.VideoCapture: serves BGR gradient frames."""

    instances: list = []

    def __init__(self, device, n_frames=6, frame_hw=(720, 1280), ok=True):
        self.device = device
        self.n_frames = n_frames
        self.frame_hw = frame_hw
        self.ok = ok
        self.reads = 0
        self.released = False
        self.props = {}
        FakeCapture.instances.append(self)

    def set(self, prop, value):
        self.props[prop] = value
        return True

    def read(self):
        if not self.ok or self.reads >= self.n_frames:
            return False, None
        h, w = self.frame_hw
        frame = np.zeros((h, w, 3), np.uint8)
        frame[..., 0] = 255            # pure blue in BGR
        frame[..., 2] = self.reads     # frame index in the red channel
        self.reads += 1
        return True, frame

    def release(self):
        self.released = True


@pytest.fixture(autouse=True)
def _fresh_instances():
    FakeCapture.instances = []


def test_webcam_source_settings_crop_and_color(monkeypatch):
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda device: FakeCapture(device))
    src = WebcamSource(device=3, target_size=256)
    frames = list(src)
    cap = FakeCapture.instances[0]
    assert cap.device == 3
    # The reference's capture settings (webcam_app.py:69-75).
    assert cap.props[cv2.CAP_PROP_FRAME_WIDTH] == 1280
    assert cap.props[cv2.CAP_PROP_FRAME_HEIGHT] == 720
    assert cap.props[cv2.CAP_PROP_FPS] == 30
    assert cap.props[cv2.CAP_PROP_BUFFERSIZE] == 1
    assert cap.released
    # 6 frames + the end-of-stream sentinel.
    assert len(frames) == 7 and frames[-1][0] is None
    f0, ts0 = frames[0]
    assert f0.shape == (256, 256, 3)       # center-cropped
    assert ts0 > 0
    # BGR blue -> RGB: blue must land in channel 2.
    assert int(f0[..., 2].max()) == 255 and int(f0[..., 0].max()) <= 5


def test_webcam_source_dead_camera_terminates(monkeypatch):
    """A camera whose read() fails immediately (unplugged, permissions)
    must yield only the sentinel and still release the driver."""
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda device: FakeCapture(device, ok=False))
    frames = list(WebcamSource())
    assert len(frames) == 1 and frames[0][0] is None
    assert FakeCapture.instances[0].released


def test_webcam_source_undersized_driver_frames(monkeypatch):
    """A camera that ignores the capture-size request and delivers small
    frames must still produce target_size^2 output (center_square
    upscales) so fixed-geometry consumers don't die."""
    monkeypatch.setattr(
        cv2, "VideoCapture",
        lambda device: FakeCapture(device, frame_hw=(120, 160)))
    frames = [f for f, _ in WebcamSource(target_size=256) if f is not None]
    assert frames and all(f.shape == (256, 256, 3) for f in frames)


def test_webcam_source_release_on_consumer_abort(monkeypatch):
    """The finally-release path: a consumer that stops iterating mid-
    stream (pipeline abort) must not leak the camera handle."""
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda device: FakeCapture(device, n_frames=100))
    it = iter(WebcamSource(target_size=64))
    next(it), next(it)
    it.close()                              # generator GC path
    assert FakeCapture.instances[0].released


def test_webcam_source_through_pipeline(monkeypatch):
    """The reference's actual topology, mocked at the driver boundary:
    camera -> pipeline -> filter -> ordered sink, every frame delivered."""
    from dvf_tpu_torch.io import NullSink
    from dvf_tpu_torch.ops import get_filter
    from dvf_tpu_torch.runtime import Pipeline, PipelineConfig

    monkeypatch.setattr(
        cv2, "VideoCapture",
        lambda device: FakeCapture(device, n_frames=12, frame_hw=(96, 128)))
    sink = NullSink()
    stats = Pipeline(
        WebcamSource(target_size=64),
        get_filter("invert"),
        sink,
        PipelineConfig(batch_size=4, queue_size=100),
        device="cpu",
    ).run()
    assert stats["delivered"] == 12
    assert FakeCapture.instances[0].released
