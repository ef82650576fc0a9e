"""The port's display and lifecycle (counterpart of tests/test_display.py):
side-by-side composition (webcam_app.py:118-150), graceful stop
mid-stream with stats + trace export (webcam_app.py:166-180 →
distributor.py:356-376), CLI serve wiring; on the CPU. The panes are also
held to the JAX package's sink on the same frames."""

import json
import os
import threading
import time

import numpy as np

from dvf_tpu_torch.io.display import LiveTap, SideBySideSink


def test_live_tap_passthrough_and_latest():
    frames = [(np.full((4, 4, 3), i, np.uint8), float(i)) for i in range(3)]
    frames.append((None, 3.0))
    tap = LiveTap(frames)
    seen = list(tap)
    assert len(seen) == 4
    # latest holds the newest non-None frame
    np.testing.assert_array_equal(tap.latest, frames[2][0])


def test_side_by_side_composition_headless():
    tap = LiveTap([])
    tap.latest = np.full((8, 6, 3), 10, np.uint8)
    sink = SideBySideSink(tap, headless=True)
    processed = np.full((8, 6, 3), 200, np.uint8)
    sink.emit(0, processed, time.time())
    pane = sink.last_pane
    assert pane.shape == (8, 12, 3)  # live | processed, 2x wide
    np.testing.assert_array_equal(pane[:, :6], tap.latest)
    np.testing.assert_array_equal(pane[:, 6:], processed)
    sink.close()


def test_side_by_side_letterboxes_mismatched_live():
    """Smaller live frame scales up (aspect-preserving) to fill the pane."""
    tap = LiveTap([])
    live = np.zeros((4, 3, 3), np.uint8)
    live[0, 0] = 200  # marker at top-left
    live[3, 2] = 100  # marker at bottom-right
    tap.latest = live
    sink = SideBySideSink(tap, headless=True)
    processed = np.zeros((8, 6, 3), np.uint8)
    sink.emit(0, processed, time.time())
    pane = sink.last_pane
    assert pane.shape == (8, 12, 3)
    # 4x3 scales exactly 2x into the 8x6 pane: markers land scaled, not
    # corner-cropped.
    assert pane[0, 0, 0] == 200 and pane[1, 1, 0] == 200
    assert pane[7, 5, 0] == 100 and pane[6, 4, 0] == 100


def test_side_by_side_downscales_larger_live_not_crop():
    """A live feed LARGER than the processed pane must be scaled down to
    fit (showing the whole frame), never corner-cropped."""
    tap = LiveTap([])
    live = np.zeros((16, 12, 3), np.uint8)
    live[15, 11] = 250  # bottom-right content — a crop would lose this
    tap.latest = live
    sink = SideBySideSink(tap, headless=True)
    processed = np.zeros((8, 6, 3), np.uint8)
    sink.emit(0, processed, time.time())
    pane = sink.last_pane
    assert pane.shape == (8, 12, 3)
    left = pane[:, :6]
    # The bottom-right marker survives somewhere in the scaled pane.
    assert left.max() == 250
    assert left[7, 5, 0] == 250


def test_esc_invokes_stop_callback(monkeypatch):
    """The ESC branch must call stop_cb — drive emit with a fake cv2."""
    import sys
    import types

    calls = []
    fake_cv2 = types.SimpleNamespace(
        imshow=lambda *a: None,
        waitKey=lambda *_: 27,
        cvtColor=lambda img, _: img,
        COLOR_RGB2BGR=0,
        destroyWindow=lambda *_: None,
    )
    monkeypatch.setitem(sys.modules, "cv2", fake_cv2)
    tap = LiveTap([])
    sink = SideBySideSink(tap, headless=False, stop_cb=lambda: calls.append(1))
    sink.emit(0, np.zeros((4, 4, 3), np.uint8), time.time())
    assert calls == [1]
    sink.close()


def test_pipeline_graceful_stop_mid_stream(tmp_path, monkeypatch):
    """stop() from another thread (what SIGINT/ESC call) ends the run
    cleanly: delivered subset, stats returned, trace exported."""
    from dvf_tpu_torch.io.sinks import NullSink
    from dvf_tpu_torch.io.sources import SyntheticSource
    from dvf_tpu_torch.ops import get_filter
    from dvf_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig

    monkeypatch.chdir(tmp_path)
    sink = NullSink()
    pipe = Pipeline(
        SyntheticSource(height=16, width=16, n_frames=100_000, rate=200.0),
        get_filter("invert"),
        sink,
        PipelineConfig(batch_size=4, frame_delay=0, queue_size=64, trace=True),
        device="cpu",
    )

    def stopper():
        deadline = time.time() + 30
        while sink.count < 8 and time.time() < deadline:
            time.sleep(0.01)
        pipe.stop()

    t = threading.Thread(target=stopper, daemon=True)
    t.start()
    stats = pipe.run()
    t.join(timeout=5)
    assert 8 <= stats["delivered"] < 100_000
    assert os.path.exists("dvf_frame_timing.pftrace")


def test_cli_serve_display_headless(capsys):
    from dvf_tpu_torch.cli import main

    rc = main([
        "serve", "--filter", "invert", "--source", "synthetic",
        "--height", "16", "--width", "16", "--frames", "24",
        "--batch", "4", "--frame-delay", "0", "--queue-size", "64",
        "--display", "--headless", "--quiet", "--platform", "cpu",
    ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    stats = json.loads(out)
    assert stats["delivered"] == 24


def test_panes_equal_the_references():
    """The same live/processed pairs compose to the same panes in both
    packages' sinks (equal geometry, letterboxed up and down)."""
    from dvf_tpu.io import display as ref

    rng = np.random.default_rng(0)
    for live_hw in ((8, 6), (4, 3), (16, 12), (5, 9)):
        live = rng.integers(0, 255, live_hw + (3,), np.uint8)
        processed = rng.integers(0, 255, (8, 6, 3), np.uint8)
        panes = []
        for mod in (ref, None):
            tap = (ref.LiveTap if mod else LiveTap)([])
            tap.latest = live
            sink = (ref.SideBySideSink if mod else SideBySideSink)(
                tap, headless=True)
            sink.emit(0, processed, time.time())
            panes.append(sink.last_pane)
            sink.close()
        np.testing.assert_array_equal(panes[0], panes[1])
    from dvf_tpu_torch.io.display import letterbox_geometry

    for args in ((4, 3, 8, 6), (16, 12, 8, 6), (20, 20, 32, 64), (1, 100, 7, 7)):
        assert letterbox_geometry(*args) == ref.letterbox_geometry(*args)
