"""The port's GL texture-blit display sink (counterpart of
tests/test_gl_display.py; reference draw-path parity).

The reference renders live|processed as two GL texture blits inside a
pyglet window (webcam_app.py:118-150); dvf_tpu runs the same GL call
sequence against a surfaceless EGL context and reads the canvas back.
These tests drive the real GL stack (Mesa llvmpipe) — they skip only if
no surfaceless EGL context can come up on the host.
"""

import json

import numpy as np
import pytest


def _renderer(w, h):
    from dvf_tpu_torch.io.gl_display import GLRenderer, GLUnavailable

    try:
        return GLRenderer(w, h)
    except GLUnavailable as e:
        pytest.skip(f"no surfaceless EGL/GL stack: {e}")


def test_gl_blit_pair_exact_at_native_geometry():
    """At 1:1 geometry the textured-quad blit must reproduce both frames
    exactly (LINEAR sampling lands on texel centers)."""
    rng = np.random.default_rng(0)
    r = _renderer(48, 32)
    try:
        live = rng.integers(0, 255, (32, 48, 3), np.uint8)
        proc = rng.integers(0, 255, (32, 48, 3), np.uint8)
        pane = r.blit_pair(live, proc)
        assert pane.shape == (32, 96, 3)
        np.testing.assert_array_equal(pane[:, :48], live)
        np.testing.assert_array_equal(pane[:, 48:], proc)
    finally:
        r.close()


def test_gl_blit_letterboxes_mismatched_live():
    """A live feed of another geometry scales aspect-preserving into its
    pane (black letterbox bars, never a crash or a stretch)."""
    r = _renderer(64, 32)  # pane 64x32; live is square 20x20
    try:
        live = np.full((20, 20, 3), 200, np.uint8)
        proc = np.full((32, 64, 3), 50, np.uint8)
        pane = r.blit_pair(live, proc)
        assert pane.shape == (32, 128, 3)
        # Processed pane intact.
        np.testing.assert_array_equal(pane[:, 64:], proc)
        # Live pane: a centered 32x32 bright block, black bars either side.
        left = pane[:, :64]
        assert left[:, :10].max() == 0 and left[:, -10:].max() == 0
        center = left[8:-8, 24:40]
        assert center.min() >= 190  # scaled live content
    finally:
        r.close()


def test_gl_blit_without_live_frame():
    """Before the first capture lands, the live pane is black."""
    r = _renderer(16, 16)
    try:
        proc = np.full((16, 16, 3), 99, np.uint8)
        pane = r.blit_pair(None, proc)
        assert pane[:, :16].max() == 0
        np.testing.assert_array_equal(pane[:, 16:], proc)
    finally:
        r.close()


def test_serve_display_backend_gl(capsys):
    """End-to-end: serve --display --display-backend gl delivers frames
    through the GL sink (offscreen) and exits cleanly. frame-delay 2
    forces the reorder buffer's tail flush onto the MAIN thread while the
    earlier frames rendered on the collect thread — both must work."""
    from dvf_tpu_torch.cli import main
    from dvf_tpu_torch.io.gl_display import GLRenderer, GLUnavailable

    try:
        GLRenderer(8, 8).close()
    except GLUnavailable as e:
        pytest.skip(f"no surfaceless EGL/GL stack: {e}")

    rc = main([
        "serve", "--filter", "invert", "--source", "synthetic",
        "--height", "24", "--width", "32", "--frames", "8", "--batch", "4",
        "--frame-delay", "2", "--queue-size", "64",
        "--display", "--display-backend", "gl", "--platform", "cpu",
    ])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["delivered"] == 8


def test_gl_blit_odd_width_readback():
    """3*width not divisible by 4 exercises GL_PACK_ALIGNMENT=1 on the
    readback — the default pack alignment of 4 would pad rows and skew
    (or over-size) the canvas."""
    rng = np.random.default_rng(2)
    r = _renderer(33, 17)
    try:
        live = rng.integers(0, 255, (17, 33, 3), np.uint8)
        proc = rng.integers(0, 255, (17, 33, 3), np.uint8)
        pane = r.blit_pair(live, proc)
        assert pane.shape == (17, 66, 3)
        np.testing.assert_array_equal(pane[:, :33], live)
        np.testing.assert_array_equal(pane[:, 33:], proc)
    finally:
        r.close()


def test_gl_blit_across_threads():
    """EGL contexts are thread-affine, and the pipeline delivers from the
    collect thread during the run but flushes tail frames from the MAIN
    thread — blit_pair must re-bind per call so both work."""
    import threading

    rng = np.random.default_rng(3)
    r = _renderer(24, 16)
    try:
        live = rng.integers(0, 255, (16, 24, 3), np.uint8)
        proc = rng.integers(0, 255, (16, 24, 3), np.uint8)
        results = {}

        def worker():
            results["worker"] = r.blit_pair(live, proc)

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        results["main"] = r.blit_pair(live, proc)
        np.testing.assert_array_equal(results["worker"], results["main"])
        np.testing.assert_array_equal(results["main"][:, 24:], proc)
    finally:
        r.close()


def test_gl_blit_equals_the_references():
    """The port's renderer and the JAX package's compose the same pairs
    to the same canvases (native geometry and a letterboxed live pane).
    One renderer at a time: both bind the process's one EGL display."""
    from dvf_tpu.io.gl_display import GLRenderer as RefRenderer

    rng = np.random.default_rng(4)
    live = rng.integers(0, 255, (20, 20, 3), np.uint8)
    proc = rng.integers(0, 255, (24, 40, 3), np.uint8)
    pairs = ((live, proc), (proc, proc), (None, proc))
    canvases = []
    for make in (_renderer, RefRenderer):
        r = make(40, 24)
        try:
            canvases.append([r.blit_pair(*pair) for pair in pairs])
        finally:
            r.close()
    for ours, ref in zip(*canvases):
        assert ours.shape == (24, 80, 3)
        np.testing.assert_array_equal(ours, ref)
