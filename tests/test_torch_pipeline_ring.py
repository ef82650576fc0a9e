"""The port's pipeline over the native ring (counterpart of
``tests/test_pipeline.py``'s ``TestRingTransportPipeline``, the ring cases
of ``TestStreamedIngest`` and ``test_paced_source_does_not_burst_after_stall``).

The port's pipeline fed through its ``RingFrameQueue`` is held to the JAX
package's pipeline over the JAX package's own ring on the same frames:
``invert`` exact, ``gaussian_blur(ksize=9)`` and ``sobel_bilateral``
within 1 LSB, on the raw, jpeg and delta wires.
"""

import time

import numpy as np
import pytest

from torch_ring_util import jax_native_isolated  # noqa: F401

import dvf_tpu
import dvf_tpu_torch as dt
from dvf_tpu_torch.transport.ring_queue import RingFrameQueue

H, W = 24, 32


def _source_frames(n, h=H, w=W):
    out = {}
    for i, (f, _) in enumerate(dt.SyntheticSource(height=h, width=w, n_frames=n)):
        if f is None:
            break
        out[i] = f
    return out


def _run_port(filt, n_frames=30, batch=4, queue_frames=100, sink=None,
              wire="raw", h=H, w=W, **cfg):
    delivered = {}
    order = []

    def emit(index, frame, ts):
        delivered[index] = frame.copy()
        order.append(index)

    queue = RingFrameQueue((h, w, 3), capacity_frames=queue_frames, wire=wire,
                           codec_threads=1, delta_tile=8)
    pipe = dt.Pipeline(dt.SyntheticSource(height=h, width=w, n_frames=n_frames),
                       filt, sink if sink is not None else dt.CallbackSink(emit),
                       dt.PipelineConfig(batch_size=batch, queue_size=queue_frames,
                                         **cfg),
                       device="cpu", queue=queue)
    stats = pipe.run()
    return delivered, order, stats, queue


def _run_jax(filt, n_frames=30, batch=4, queue_frames=100, wire="raw",
             h=H, w=W, **cfg):
    from dvf_tpu.io import CallbackSink, SyntheticSource
    from dvf_tpu.runtime import Pipeline, PipelineConfig
    from dvf_tpu.transport.ring_queue import RingFrameQueue as JaxRingFrameQueue

    delivered = {}
    queue = JaxRingFrameQueue((h, w, 3), capacity_frames=queue_frames,
                              wire=wire, codec_threads=1, delta_tile=8)
    pipe = Pipeline(SyntheticSource(height=h, width=w, n_frames=n_frames), filt,
                    CallbackSink(lambda i, f, ts: delivered.__setitem__(i, f.copy())),
                    PipelineConfig(batch_size=batch, queue_size=queue_frames, **cfg),
                    queue=queue)
    stats = pipe.run()
    return delivered, stats


class TestRingTransportPipeline:
    """The native ring on the pipeline's path (the reference's transport
    sits on its hot path, distributor.py:27-35)."""

    def test_raw_wire_exact_ordered(self):
        delivered, order, stats, queue = _run_port(dt.get_filter("invert"))
        src = _source_frames(30)
        assert stats["transport"] == "RingFrameQueue"
        assert stats["dropped_at_ingest"] == 0
        assert order == sorted(order) == list(range(30))
        for i, frame in delivered.items():
            np.testing.assert_array_equal(frame, 255 - src[i])
        assert queue._closed_counts == (0, 30)  # closed at the end of run()

    def test_jpeg_wire_roundtrip_tolerance(self):
        delivered, _, stats, _ = _run_port(dt.get_filter("invert"), wire="jpeg")
        src = _source_frames(30)
        assert stats["dropped_at_ingest"] == 0
        assert len(delivered) == 30
        for i, frame in delivered.items():
            err = np.abs(frame.astype(np.int16) - (255 - src[i]).astype(np.int16))
            # Half of each synthetic frame is noise, JPEG's worst case; the
            # bound catches wiring bugs (wrong rows or channels), not loss.
            assert err.mean() < 35.0, f"frame {i}: mean JPEG error {err.mean()}"

    def test_ring_drop_counter_surfaces_in_stats(self):
        """A slow sink backs the pipeline up; the ring's native drop
        counter is what stats() reports as dropped_at_ingest."""
        class SlowSink(dt.NullSink):
            def emit(self, index, frame, ts):
                super().emit(index, frame, ts)
                time.sleep(0.02)

        _, _, stats, queue = _run_port(dt.get_filter("invert"), n_frames=400,
                                       batch=2, queue_frames=4, sink=SlowSink())
        assert stats["dropped_at_ingest"] > 0
        assert stats["dropped_at_ingest"] == queue.dropped
        assert (stats["delivered"] + stats["dropped_at_ingest"]
                <= stats["frames_produced_total"])

    @pytest.mark.parametrize("name,kw,lsb", [
        ("invert", {}, 0),
        ("gaussian_blur", {"ksize": 9}, 1),
        ("sobel_bilateral", {}, 1),
    ], ids=["invert", "gaussian_blur9", "sobel_bilateral"])
    @pytest.mark.parametrize("wire", ["raw", "jpeg", "delta"])
    def test_matches_jax_pipeline_over_its_ring(self, name, kw, lsb, wire):
        """The same stream through both packages' pipelines, each over its
        own ring: the same frames delivered, in order, within ``lsb``."""
        got, order, stats, _ = _run_port(dt.get_filter(name, **kw), n_frames=20,
                                         wire=wire, frame_delay=0)
        want, jstats = _run_jax(dvf_tpu.get_filter(name, **kw), n_frames=20,
                                wire=wire, frame_delay=0)
        assert stats["dropped_at_ingest"] == jstats["dropped_at_ingest"] == 0
        assert order == list(range(20)) and sorted(want) == order
        for i in order:
            diff = np.abs(got[i].astype(np.int16) - want[i].astype(np.int16))
            assert int(diff.max()) <= lsb, (name, wire, i, int(diff.max()))


class TestStreamedIngestRing:
    """Streamed ingest over the ring: the payloads decode window by window
    into the staging slab, and the result is byte-identical to the
    monolithic path, in the same order."""

    @pytest.fixture(autouse=True)
    def _force_streaming(self, monkeypatch):
        from dvf_tpu_torch.runtime import ingest as ingest_mod

        monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)

    def _capture(self, ingest, wire):
        delivered, order, stats, _ = _run_port(
            dt.get_filter("invert"), n_frames=26, batch=4, queue_frames=1000,
            wire=wire, frame_delay=0, ingest=ingest, ingest_depth=2)
        assert stats["delivered"] == 26, (ingest, wire, stats)
        assert stats["ingest"]["mode"] == ingest
        return delivered, order

    @pytest.mark.parametrize("wire", ["raw", "jpeg"])
    def test_streamed_matches_monolithic_ring(self, wire):
        d_m, o_m = self._capture("monolithic", wire)
        d_s, o_s = self._capture("streamed", wire)
        assert o_s == o_m == sorted(o_m)
        for i in d_m:
            np.testing.assert_array_equal(d_s[i], d_m[i])


def test_paced_source_does_not_burst_after_stall():
    """A consumer stall must not be repaid by an unthrottled catch-up
    burst of the paced source."""
    rate = 50.0  # 20 ms period
    it = iter(dt.SyntheticSource(height=8, width=8, n_frames=12, rate=rate))
    for _ in range(3):
        next(it)
    time.sleep(0.25)  # a stall of ~12 periods
    next(it)          # resumes at once (the frame was already due)
    t0 = time.perf_counter()
    next(it)          # must wait ~one period, not arrive in a burst
    gap = time.perf_counter() - t0
    assert gap >= 0.5 / rate, f"catch-up burst after stall: gap={gap*1e3:.1f}ms"
