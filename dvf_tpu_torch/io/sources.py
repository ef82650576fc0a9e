"""Frame sources (port of ``dvf_tpu.io.sources``).

A source yields ``(frame_u8, timestamp)``; a ``None`` frame ends the
stream. ``SyntheticSource`` is a copy of the reference's: the same seed
gives the same bytes. ``VideoFileSource`` and ``WebcamSource`` decode
through cv2, which each imports when it is iterated, so importing this
module needs no cv2; both are host code and touch no device.
``ShmRingSource`` reads frames another process pushes into a
shared-memory ring.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

import numpy as np

Frame = Tuple[Optional[np.ndarray], float]


def _pace(next_t: float, period: float) -> float:
    """Sleep until ``next_t``; return the following due time.

    Drift-free on the normal path (the schedule advances by exactly one
    period, using the PRE-sleep clock — a post-sleep reading would
    accumulate sleep overshoot and systematically under-deliver at high
    rates) — but with no catch-up burst after a consumer stall
    (backpressure, jit warm-up): the next frame is due one full period
    after the LATER of the schedule and now, never immediately. Bursting
    to repay a stall would congest the very stream bench_e2e_latency is
    rate-controlling."""
    now = time.perf_counter()
    if now < next_t:
        time.sleep(next_t - now)
    return max(next_t, now) + period


class SyntheticSource:
    """Procedural moving-gradient frames — deterministic, camera-free.

    ``rate``: target frames/sec; 0 = unthrottled (benchmark mode, the
    analog of measuring pure pipeline capacity rather than the reference's
    30fps camera ceiling, webcam_app.py:14).

    ``motion`` selects the temporal structure, which is what the
    temporal-delta wire's dirty ratio is a function of:

    - ``True`` / ``"roll"`` — every pixel changes every frame (cyclic
      roll); the full-motion worst case (dirty ratio ≈ 1).
    - ``"block"`` — a small moving block over a STATIC background, the
      webcam-like low-motion workload (a subject moving against a fixed
      scene): per-frame change is ~2 block footprints, a few % of the
      frame, which is the regime the delta wire's order-of-magnitude
      codec saving is claimed for (benchmarks/DELTA_BENCH.json).
    - ``False`` / ``"none"`` — a fully static stream (dirty ratio 0;
      the bit-identity equivalence tests).
    """

    def __init__(
        self,
        height: int = 1080,
        width: int = 1920,
        channels: int = 3,
        n_frames: int = 300,
        rate: float = 0.0,
        seed: int = 0,
        motion: bool = True,
        texture: str = "noise",
    ):
        self.height, self.width, self.channels = height, width, channels
        self.n_frames = n_frames
        self.rate = rate
        self.motion = motion
        rng = np.random.default_rng(seed)
        # One textured base frame; per-frame variation is a cyclic roll +
        # brightness ramp. The rolls are PRE-COMPUTED (a small cycle of
        # distinct frames served round-robin as read-only views): an
        # unthrottled 1080p source doing a fresh 6 MB np.roll copy per frame
        # burns ~1 GB/s of host bandwidth + GIL inside the ingest thread and
        # becomes the pipeline bottleneck it exists to measure around.
        #
        # ``texture``: "noise" (default — iid noise + ramp; maximally
        # incompressible, the bench workload) or "structured" (gratings,
        # rings, and hard-edged blocks; spatially coherent content with
        # real edges — what super-resolution training needs, since iid
        # noise is information-destroyed by downscaling and unlearnable).
        if texture == "structured":
            yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
            rad = np.hypot(yy - height / 2.0, xx - width / 2.0)
            ch = [
                127.5 + 127.5 * np.sin(2 * np.pi * xx / 17.0),        # grating
                127.5 + 127.5 * np.sin(rad / 5.0),                    # rings
                ((xx // 11).astype(int) + (yy // 11).astype(int)) % 2 * 255.0,  # checker
            ]
            base = np.stack([ch[i % 3] for i in range(channels)], axis=-1)
            # hard-edged diagonal blocks for step edges in every channel
            block = (((xx + yy) // 23).astype(int) % 3 == 0)[..., None] * 60.0
            self._base = np.clip(base * 0.75 + block, 0, 255).astype(np.uint8)
        elif texture == "noise":
            base = rng.integers(0, 255, size=(height, width, channels), dtype=np.uint8)
            ramp = np.linspace(0, 255, width, dtype=np.uint8)[None, :, None]
            self._base = (base // 2 + ramp // 2).astype(np.uint8)
        else:
            raise ValueError(f"texture must be 'noise' or 'structured', got {texture!r}")
        if motion is True:
            motion = "roll"
        elif motion is False:
            motion = "none"
        if motion not in ("roll", "block", "none"):
            raise ValueError(
                f"motion must be 'roll', 'block', 'none' (or a bool), "
                f"got {motion!r}")
        self.motion = motion
        n_cycle = min(16, n_frames) if motion != "none" else 1
        if motion == "block":
            # Low-motion: invert a block (~1/6 of each linear dim → ~3%
            # of the area) walking a precomputed cycle of positions over
            # the static base. Same read-only-view serving discipline as
            # the roll cycle — the source must never become the
            # bottleneck it exists to measure around.
            bh, bw = max(8, height // 6), max(8, width // 6)
            self._cycle = []
            for i in range(n_cycle):
                f = self._base.copy()
                y0 = (i * max(1, (height - bh) // max(1, n_cycle - 1))
                      ) % max(1, height - bh + 1)
                x0 = (i * max(1, (width - bw) // max(1, n_cycle - 1))
                      ) % max(1, width - bw + 1)
                f[y0: y0 + bh, x0: x0 + bw] = 255 - f[y0: y0 + bh,
                                                      x0: x0 + bw]
                self._cycle.append(f)
        else:
            self._cycle = [
                np.roll(self._base, (i * 2) % self.width, axis=1)
                for i in range(n_cycle)
            ]
        for f in self._cycle:
            f.setflags(write=False)  # served as shared views — keep them immutable

    def __iter__(self) -> Iterator[Frame]:
        period = 1.0 / self.rate if self.rate > 0 else 0.0
        next_t = time.perf_counter()
        n_cycle = len(self._cycle)
        for i in range(self.n_frames):
            if period:
                next_t = _pace(next_t, period)
            yield self._cycle[i % n_cycle], time.time()
        yield None, time.time()


def center_square(frame: "np.ndarray", size: int) -> "np.ndarray":
    """Center-crop to ``size``² (the reference's crop, webcam_app.py:97-101),
    upscaling first when the frame is smaller than the target so any input
    geometry yields the fixed shape consumers like the ring transport need."""
    import cv2

    h, w = frame.shape[:2]
    if h < size or w < size:
        scale = max(size / h, size / w)
        frame = cv2.resize(
            frame, (int(np.ceil(w * scale)), int(np.ceil(h * scale))))
        h, w = frame.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return frame[top: top + size, left: left + size]


class VideoFileSource:
    """Decode a video file via cv2 (RGB uint8).

    ``target_size`` center-crops every frame to a fixed square — required
    for fixed-geometry consumers (``--transport ring``); None yields the
    file's native geometry.
    """

    def __init__(self, path: str, loop: bool = False, rate: float = 0.0,
                 target_size: Optional[int] = None):
        self.path = path
        self.loop = loop
        self.rate = rate
        self.target_size = target_size

    def __iter__(self) -> Iterator[Frame]:
        import cv2

        period = 1.0 / self.rate if self.rate > 0 else 0.0
        next_t = time.perf_counter()
        while True:
            cap = cv2.VideoCapture(self.path)
            ok, frame = cap.read()
            while ok:
                if period:
                    next_t = _pace(next_t, period)
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if self.target_size:
                    rgb = center_square(rgb, self.target_size)
                yield rgb, time.time()
                ok, frame = cap.read()
            cap.release()
            if not self.loop:
                break
        yield None, time.time()


class WebcamSource:
    """Live webcam capture — the reference's source (webcam_app.py:67-116).

    Same settings: 1280x720@30 with a 1-frame driver buffer to minimize
    latency (webcam_app.py:69-75), optional center-crop to ``target_size``²
    (webcam_app.py:97-101), BGR→RGB (webcam_app.py:102).
    """

    def __init__(
        self,
        device: int = 0,
        capture_size: Tuple[int, int] = (1280, 720),
        fps: int = 30,
        target_size: Optional[int] = 512,
    ):
        self.device = device
        self.capture_size = capture_size
        self.fps = fps
        self.target_size = target_size

    def __iter__(self) -> Iterator[Frame]:
        import cv2

        cap = cv2.VideoCapture(self.device)
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.capture_size[0])
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.capture_size[1])
        cap.set(cv2.CAP_PROP_FPS, self.fps)
        cap.set(cv2.CAP_PROP_BUFFERSIZE, 1)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if self.target_size:
                    # center_square also upscales when the camera ignores
                    # the capture-size request and delivers smaller frames
                    # — a naive negative-offset crop would emit wrong-shape
                    # frames and kill fixed-geometry consumers (ring).
                    frame = center_square(frame, self.target_size)
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB), time.time()
        finally:
            cap.release()
        yield None, time.time()


class ShmRingSource:
    """Consume frames that a separate process pushes into a POSIX
    shared-memory :class:`~dvf_tpu_torch.transport.ring.FrameRing` — the
    camera process → framework process boundary, with the native ring in
    place of the reference's ZMQ sockets. Drop-oldest freshness is
    enforced inside the ring by the producer's push.

    Wire format: raw uint8 frames of ``frame_shape``; a 1-byte payload is
    the end-of-stream sentinel (a real frame is always H·W·3 > 1 bytes).
    ``attach_timeout_s`` bounds the wait for the producer to create the
    ring; ``idle_timeout_s`` (None = forever) bounds the wait for the next
    frame once attached, which is how a producer that died without its
    sentinel ends the stream.
    """

    def __init__(
        self,
        shm_name: str,
        frame_shape: Tuple[int, int, int],
        attach_timeout_s: float = 10.0,
        idle_timeout_s: Optional[float] = 30.0,
        poll_s: float = 0.002,
    ):
        self.shm_name = shm_name
        self.frame_shape = tuple(frame_shape)
        self.attach_timeout_s = attach_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self.poll_s = poll_s

    def __iter__(self) -> Iterator[Frame]:
        from dvf_tpu_torch.transport.ring import FrameRing

        expected = int(np.prod(self.frame_shape))
        deadline = time.perf_counter() + self.attach_timeout_s
        ring = None
        while ring is None:
            try:
                # A pop buffer well beyond the expected frame, so a
                # geometry mismatch raises the explanatory error below
                # rather than a pop-buffer one.
                ring = FrameRing(shm_name=self.shm_name, create=False,
                                 max_frame_bytes=max(4 * expected, 8 << 20))
            except OSError:
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"no producer created shm ring {self.shm_name!r} "
                        f"within {self.attach_timeout_s:.0f}s")
                time.sleep(0.05)
        try:
            idle_since = time.perf_counter()
            while True:
                rec = ring.pop()
                if rec is None:
                    if (self.idle_timeout_s is not None
                            and time.perf_counter() - idle_since > self.idle_timeout_s):
                        break  # producer stalled or died: end the stream
                    time.sleep(self.poll_s)
                    continue
                idle_since = time.perf_counter()
                payload, _idx, ts = rec
                if len(payload) <= 1:
                    break  # end-of-stream sentinel
                if len(payload) != expected:
                    # The two processes disagree about geometry: say how
                    # to fix it. A square producer is recognizable from
                    # the byte count.
                    side = int(round((len(payload) / 3) ** 0.5))
                    hint = (f" (producer frames look like a {side}x{side} "
                            f"square — pass frame_shape=({side}, {side}, 3))"
                            if side * side * 3 == len(payload) else "")
                    raise ValueError(
                        f"shm producer pushed {len(payload)}-byte frames; "
                        f"this consumer expects {self.frame_shape} = "
                        f"{expected} bytes{hint}")
                yield (np.frombuffer(payload, np.uint8)
                       .reshape(self.frame_shape), ts)
        finally:
            ring.close()
        yield None, time.time()
