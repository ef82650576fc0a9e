"""OpenGL texture-blit display sink — the reference's literal draw path.

webcam_app.py:118-150 renders the live and processed streams as two GL
textures blitted side by side (pyglet supplies the GL context + window;
the drawing itself is plain GL texture upload + quad blit). The GL path
does not need pyglet: this module creates a
**surfaceless EGL** context (Mesa, software rasterizer on a headless
host) and renders the same two-texture side-by-side composition into an
offscreen framebuffer — the identical GL call sequence the reference's
window receives (glTexImage2D upload, textured-quad blit per pane),
readable back for tests, recording, or piping to any presenter.

So the display layer has two interchangeable sinks:

- :class:`dvf_tpu_torch.io.display.SideBySideSink` — cv2 window (interactive
  ESC handling); numpy composition.
- :class:`GLSideBySideSink` (here) — GL texture-blit composition,
  offscreen; the literal-parity path (``serve --display-backend gl``).

Both consume the same :class:`~dvf_tpu_torch.io.display.LiveTap` and
expose the same emit/count/last_pane surface, so the pipeline does not
care which one it feeds.

Port of ``dvf_tpu.io.gl_display``. Frames reach the renderer as host
uint8 arrays, as in the reference: there is no CUDA–GL interop, and the
GL context is Mesa's, not the card's.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, Callable, Optional

import numpy as np

from dvf_tpu_torch.io.display import letterbox_geometry
from dvf_tpu_torch.obs.metrics import RateLogger

# Mesa's surfaceless platform (EGL_PLATFORM_SURFACELESS_MESA): a context
# with no native windowing system at all — exactly right for a headless
# server. The llvmpipe software rasterizer draws on the CPU.
_EGL_PLATFORM_SURFACELESS_MESA = 0x31DD


class GLUnavailable(RuntimeError):
    """Raised when no surfaceless EGL/GL stack can be initialized."""


class GLRenderer:
    """Owns one surfaceless EGL context + FBO; blits frame pairs.

    ``blit_pair(live, processed)`` uploads both RGB uint8 frames as GL
    textures, draws them as textured quads into the left/right halves of
    a (2*width, height) offscreen framebuffer (aspect-preserving
    letterbox for the live pane, like the cv2 sink), and returns the
    composed canvas read back from the GPU-side framebuffer — the
    reference's per-frame draw (webcam_app.py:118-150) minus the window.
    """

    def __init__(self, width: int, height: int):
        self.w, self.h = int(width), int(height)
        self.canvas_w = 2 * self.w
        os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
        os.environ.setdefault("EGL_PLATFORM", "surfaceless")
        # Software rasterizer: deterministic and present on headless hosts.
        os.environ.setdefault("LIBGL_ALWAYS_SOFTWARE", "1")
        try:
            from OpenGL import EGL, GL  # noqa: N811
        except Exception as e:  # noqa: BLE001 — any import failure = no GL
            raise GLUnavailable(f"PyOpenGL/EGL import failed: {e!r}") from e
        self._EGL, self._GL = EGL, GL

        try:
            get_dpy = EGL.eglGetPlatformDisplayEXT
        except AttributeError as e:
            raise GLUnavailable("EGL_EXT_platform_base missing") from e
        self._dpy = get_dpy(_EGL_PLATFORM_SURFACELESS_MESA, None, None)
        major, minor = ctypes.c_long(), ctypes.c_long()
        if not EGL.eglInitialize(self._dpy, major, minor):
            raise GLUnavailable("eglInitialize failed (surfaceless Mesa)")
        # Every failure past eglInitialize must eglTerminate
        # before re-raising — cmd_serve probes a throwaway GLRenderer on
        # every gl-backend start, and a partial GL stack (config/context/
        # makeCurrent/FBO failures) would otherwise leak one EGL display
        # per attempt.
        try:
            EGL.eglBindAPI(EGL.EGL_OPENGL_API)
            attribs = (ctypes.c_int * 5)(EGL.EGL_SURFACE_TYPE, 0,
                                         EGL.EGL_RENDERABLE_TYPE,
                                         EGL.EGL_OPENGL_BIT, EGL.EGL_NONE)
            cfgs = (EGL.EGLConfig * 1)()
            n = ctypes.c_long()
            if not EGL.eglChooseConfig(self._dpy, attribs, cfgs, 1, n) or not n.value:
                raise GLUnavailable("no EGL config for surfaceless OpenGL")
            self._ctx = EGL.eglCreateContext(self._dpy, cfgs[0],
                                             EGL.EGL_NO_CONTEXT, None)
            if not self._ctx:
                raise GLUnavailable("eglCreateContext failed")
            if not EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE,
                                      EGL.EGL_NO_SURFACE, self._ctx):
                raise GLUnavailable("eglMakeCurrent failed "
                                    "(EGL_KHR_surfaceless_context missing?)")

            # Two streaming textures (live, processed) + one FBO-attached
            # color texture as the composition canvas.
            self._tex = [GL.glGenTextures(1) for _ in range(2)]
            for t in self._tex:
                GL.glBindTexture(GL.GL_TEXTURE_2D, t)
                # LINEAR: the reference scales panes to the window; filtered
                # sampling is what a window blit does.
                GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER,
                                   GL.GL_LINEAR)
                GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER,
                                   GL.GL_LINEAR)
            self._fbo = GL.glGenFramebuffers(1)
            GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self._fbo)
            self._canvas_tex = GL.glGenTextures(1)
            GL.glBindTexture(GL.GL_TEXTURE_2D, self._canvas_tex)
            GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_RGB, self.canvas_w,
                            self.h, 0, GL.GL_RGB, GL.GL_UNSIGNED_BYTE, None)
            GL.glFramebufferTexture2D(GL.GL_FRAMEBUFFER,
                                      GL.GL_COLOR_ATTACHMENT0,
                                      GL.GL_TEXTURE_2D, self._canvas_tex, 0)
            if (GL.glCheckFramebufferStatus(GL.GL_FRAMEBUFFER)
                    != GL.GL_FRAMEBUFFER_COMPLETE):
                raise GLUnavailable("offscreen framebuffer incomplete")
            GL.glEnable(GL.GL_TEXTURE_2D)
            # Release the context from the constructing thread: blit_pair
            # re-binds per call (the pipeline may construct on one thread
            # and deliver on another), and a context left current here
            # would make that bind fail with EGL_BAD_ACCESS.
            EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE,
                               EGL.EGL_NO_SURFACE, EGL.EGL_NO_CONTEXT)
        except Exception:
            try:
                EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE,
                                   EGL.EGL_NO_SURFACE, EGL.EGL_NO_CONTEXT)
                EGL.eglTerminate(self._dpy)
            except Exception:  # noqa: BLE001 — already failing; don't mask
                pass
            raise
        self._closed = False

    # ------------------------------------------------------------------

    def _upload(self, slot: int, frame: np.ndarray) -> None:
        GL = self._GL
        frame = np.ascontiguousarray(frame)
        GL.glBindTexture(GL.GL_TEXTURE_2D, self._tex[slot])
        # Rows are tightly packed uint8 RGB; width need not be 4-aligned.
        GL.glPixelStorei(GL.GL_UNPACK_ALIGNMENT, 1)
        GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_RGB, frame.shape[1],
                        frame.shape[0], 0, GL.GL_RGB, GL.GL_UNSIGNED_BYTE,
                        frame)

    def _draw_pane(self, slot: int, x0: int, src_h: int, src_w: int) -> None:
        """Blit texture ``slot`` into the w×h pane at canvas x-offset
        ``x0``, aspect-preserving (letterboxed on the pane's black)."""
        GL = self._GL
        dh, dw = letterbox_geometry(src_h, src_w, self.h, self.w)
        # The viewport IS the letterbox: GL scales the full texture into
        # it with LINEAR sampling (what a window blit does).
        GL.glViewport(x0 + (self.w - dw) // 2, (self.h - dh) // 2, dw, dh)
        GL.glBindTexture(GL.GL_TEXTURE_2D, self._tex[slot])
        GL.glBegin(GL.GL_QUADS)
        # Texture row 0 is the image's TOP row, but GL's v=0 is the
        # framebuffer BOTTOM — flip v so the readback (row-flipped again)
        # returns image orientation.
        for u, v, x, y in ((0, 1, -1, -1), (1, 1, 1, -1),
                           (1, 0, 1, 1), (0, 0, -1, 1)):
            GL.glTexCoord2f(u, v)
            GL.glVertex2f(x, y)
        GL.glEnd()

    def blit_pair(self, live: Optional[np.ndarray],
                  processed: np.ndarray) -> np.ndarray:
        """Compose live | processed on the GL canvas; return it (H,2W,3).

        Safe from ANY (single) calling thread: an EGL context is
        thread-affine, and the pipeline delivers from the collect thread
        during the run but flushes the tail of the reorder buffer from
        the MAIN thread at end-of-stream — so the context is re-bound to
        the calling thread here and released on exit."""
        if self._closed:
            raise RuntimeError("GLRenderer is closed")
        EGL, GL = self._EGL, self._GL
        if not EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE,
                                  EGL.EGL_NO_SURFACE, self._ctx):
            raise RuntimeError("eglMakeCurrent failed in blit_pair")
        try:
            return self._blit_pair_bound(live, processed)
        finally:
            EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE,
                               EGL.EGL_NO_SURFACE, EGL.EGL_NO_CONTEXT)

    def _blit_pair_bound(self, live: Optional[np.ndarray],
                         processed: np.ndarray) -> np.ndarray:
        GL = self._GL
        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self._fbo)
        GL.glViewport(0, 0, self.canvas_w, self.h)
        GL.glClearColor(0.0, 0.0, 0.0, 1.0)
        GL.glClear(GL.GL_COLOR_BUFFER_BIT)
        if live is not None:
            self._upload(0, live)
            self._draw_pane(0, 0, live.shape[0], live.shape[1])
        self._upload(1, processed)
        self._draw_pane(1, self.w, processed.shape[0], processed.shape[1])
        GL.glViewport(0, 0, self.canvas_w, self.h)
        # Tight rows on readback too: the default PACK alignment of 4
        # pads every row when 3*canvas_w is not 4-aligned (any odd
        # width), skewing or over-sizing the reshaped array.
        GL.glPixelStorei(GL.GL_PACK_ALIGNMENT, 1)
        out = GL.glReadPixels(0, 0, self.canvas_w, self.h, GL.GL_RGB,
                              GL.GL_UNSIGNED_BYTE)
        pane = np.frombuffer(out, np.uint8).reshape(self.h, self.canvas_w, 3)
        return pane[::-1].copy()  # GL rows are bottom-up

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        EGL = self._EGL
        EGL.eglMakeCurrent(self._dpy, EGL.EGL_NO_SURFACE, EGL.EGL_NO_SURFACE,
                           EGL.EGL_NO_CONTEXT)
        EGL.eglDestroyContext(self._dpy, self._ctx)
        EGL.eglTerminate(self._dpy)


class GLSideBySideSink:
    """GL-rendered live | processed sink (reference draw-path parity).

    Same surface as :class:`dvf_tpu_torch.io.display.SideBySideSink` (emit/
    count/last_pane/stats_fn/telemetry) so serve can swap it in via
    ``--display-backend gl``; the composition runs through the GL
    texture-blit path instead of numpy/cv2. Offscreen by design — the
    composed canvas lands in ``last_pane`` (tests, recorders, external
    presenters)."""

    def __init__(
        self,
        live_tap: Any,
        stop_cb: Optional[Callable[[], None]] = None,
        stats_fn: Optional[Callable[[], dict]] = None,
        telemetry_interval_s: float = 5.0,
    ):
        self.live_tap = live_tap
        self.stop_cb = stop_cb
        self.stats_fn = stats_fn
        self.count = 0
        self.last_pane: Optional[np.ndarray] = None
        self._renderer: Optional[GLRenderer] = None
        self._telemetry = telemetry_interval_s > 0
        self._rate = RateLogger(
            "draw(gl)", telemetry_interval_s if self._telemetry else 5.0,
            quiet=True)

    def emit(self, index: int, processed: np.ndarray,
             capture_ts: float) -> None:
        self.count += 1
        if self._renderer is None:
            self._renderer = GLRenderer(processed.shape[1],
                                        processed.shape[0])
        self.last_pane = self._renderer.blit_pair(self.live_tap.latest,
                                                  processed)
        rate = self._rate.tick()
        if rate is not None and self._telemetry:
            import sys

            stats = self.stats_fn() if self.stats_fn else {}
            # Same brief subset as the cv2 sink — backends must not
            # change the telemetry shape.
            keys = ("buffered", "display_cursor", "latest_received",
                    "delivered", "dropped_at_ingest")
            brief = {k: stats[k] for k in keys if k in stats}
            print(f"[display:gl] {rate:.1f} fps {brief}",
                  file=sys.stderr, flush=True)

    def close(self) -> None:
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None
