"""Side-by-side live | processed display — the reference's product UX.

webcam_app.py:118-150 renders the live camera feed and the filtered stream
next to each other in one window (live left, processed right, 2×target
wide) and prints draw-FPS + buffer stats every 5 s (:152-163). This module
is that surface for the pipeline:

- :class:`LiveTap` wraps any source and stashes the newest captured frame
  (the reference's ``self.frame_data`` hand-off between capture thread and
  draw loop, webcam_app.py:105-106,122-130 — here an explicit lock-free
  single-cell swap instead of a GIL-tolerated race, SURVEY.md §5.2);
- :class:`SideBySideSink` composes ``hstack(live, processed)`` per
  delivered frame, shows it via cv2 (`headless=True` skips the window for
  tests/CI), maps ESC to the pipeline's graceful stop
  (webcam_app.py:166-170), and prints the 5 s draw-FPS + stats line.

Port of ``dvf_tpu.io.display``: the same host code over the port's
``obs.metrics.RateLogger``. Frames reach the sink as host uint8 arrays
(the pipeline's delivered frames), so nothing here touches a device.

The processed pane lags the live pane by the pipeline's frame_delay — the
same visual behavior the reference's reorder buffer produces.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Iterator, Optional

import numpy as np

from dvf_tpu_torch.obs.metrics import RateLogger


def letterbox_geometry(src_h: int, src_w: int, dst_h: int, dst_w: int):
    """Aspect-preserving fit of src into dst: ``(fit_h, fit_w)``, each ≥1.

    Shared by the cv2 and GL display backends so their panes scale
    identically."""
    scale = min(dst_h / src_h, dst_w / src_w)
    return (max(1, int(round(src_h * scale))),
            max(1, int(round(src_w * scale))))


class LiveTap:
    """Source wrapper: passes frames through, keeping the newest one."""

    def __init__(self, source: Any):
        self.source = source
        self.latest: Optional[np.ndarray] = None

    def __iter__(self) -> Iterator:
        for frame, ts in self.source:
            if frame is not None:
                self.latest = frame  # atomic ref swap under the GIL
            yield frame, ts


class SideBySideSink:
    """live | processed window (reference parity: webcam_app.py:118-164).

    ``stop_cb`` is called on ESC — wire it to ``Pipeline.stop`` for the
    reference's key-press shutdown (webcam_app.py:166-170). ``stats_fn``
    (e.g. ``pipeline.stats``) feeds the periodic print.
    """

    def __init__(
        self,
        live_tap: LiveTap,
        window: str = "dvf_tpu_torch (live | processed)",
        stop_cb: Optional[Callable[[], None]] = None,
        stats_fn: Optional[Callable[[], dict]] = None,
        telemetry_interval_s: float = 5.0,
        headless: bool = False,
    ):
        self.live_tap = live_tap
        self.window = window
        self.stop_cb = stop_cb
        self.stats_fn = stats_fn
        self.headless = headless
        self.count = 0
        self.last_pane: Optional[np.ndarray] = None
        # interval <= 0 disables telemetry entirely (RateLogger with a 0
        # interval would fire on every tick, so give it a real interval
        # and gate the print instead).
        self._telemetry = telemetry_interval_s > 0
        self._rate = RateLogger(
            "draw", telemetry_interval_s if self._telemetry else 5.0, quiet=True
        )
        self._window_up = False

    # ------------------------------------------------------------------

    def _compose(self, processed: np.ndarray) -> np.ndarray:
        live = self.live_tap.latest
        if live is None:
            live = np.zeros_like(processed)
        if live.shape != processed.shape:
            # Letterbox the live feed into the processed geometry so the
            # panes always tile (the reference sidesteps this by using one
            # target_size for both, webcam_app.py:27-31): scale preserving
            # aspect, centered on a black canvas — never corner-crop, which
            # would misrepresent a larger live feed in the comparison.
            h, w = processed.shape[:2]
            sh, sw = letterbox_geometry(live.shape[0], live.shape[1], h, w)
            if (sh, sw) != live.shape[:2]:
                # Centered nearest-neighbor (sample at pixel centers, not
                # top-left corners — corner sampling never reads the last
                # row/col when downscaling); no cv2 dependency.
                ri = ((np.arange(sh) + 0.5) * live.shape[0] / sh).astype(np.intp)
                ci = ((np.arange(sw) + 0.5) * live.shape[1] / sw).astype(np.intp)
                live = live[np.minimum(ri, live.shape[0] - 1)][
                    :, np.minimum(ci, live.shape[1] - 1)]
            boxed = np.zeros_like(processed)
            y0, x0 = (h - sh) // 2, (w - sw) // 2
            boxed[y0:y0 + sh, x0:x0 + sw] = live
            live = boxed
        return np.hstack([live, processed])

    def emit(self, index: int, processed: np.ndarray, capture_ts: float) -> None:
        self.count += 1
        pane = self._compose(processed)
        self.last_pane = pane
        if not self.headless:
            import cv2

            cv2.imshow(self.window, cv2.cvtColor(pane, cv2.COLOR_RGB2BGR))
            self._window_up = True
            if cv2.waitKey(1) & 0xFF == 27 and self.stop_cb is not None:
                self.stop_cb()  # ESC → graceful stop (webcam_app.py:166-170)
        rate = self._rate.tick()
        if rate is not None and self._telemetry:
            stats = self.stats_fn() if self.stats_fn is not None else {}
            keys = ("buffered", "display_cursor", "latest_received",
                    "delivered", "dropped_at_ingest")
            brief = {k: stats[k] for k in keys if k in stats}
            print(f"[display] {rate:.1f} fps {brief}", file=sys.stderr, flush=True)

    def close(self) -> None:
        if self._window_up:
            import cv2

            cv2.destroyWindow(self.window)
            self._window_up = False
