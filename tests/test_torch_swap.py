"""The port's hot swap (``dvf_tpu_torch``) on the CPU: counterparts of
``tests/test_swap.py`` (all but the swap bench).

The engine's double buffer: ``prepare_swap`` compiles a successor aside
while the live program serves, ``commit_swap`` swings the fields in
place between ticks (state migrates with ``copy_`` when it matches leaf
for leaf), ``abort_swap`` drops it, and the chaos ``swap`` site fails
either half with the old program serving. On the frontend: a batch
resize lands as a hot swap under in-flight traffic, bit-exact, with no
stall window, and ``morph_stream`` swaps a session's chain mid-stream
with monotone indices.
"""

import threading
import time

import numpy as np
import pytest

from dvf_tpu_torch.obs import ledger as ledger_mod
from dvf_tpu_torch.ops import get_filter
from dvf_tpu_torch.resilience import FaultPlan
from dvf_tpu_torch.serve import ServeConfig
from dvf_tpu_torch.serve.session import ServeError
from torch_serve_util import Engine, ServeFrontend, port_leak_guard  # noqa: F401

H, W = 16, 24


def tagged_frame(session_no: int, frame_no: int) -> np.ndarray:
    f = np.full((H, W, 3), 9, np.uint8)
    f[0] = session_no
    f[1] = frame_no % 251
    return f


def drain(fe, sids, deliveries, want=None, deadline_s=30.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        moved = 0
        for sid in sids:
            got = fe.poll(sid)
            deliveries.setdefault(sid, []).extend(got)
            moved += len(got)
        if want is not None and all(
                len(deliveries.get(s, [])) >= want for s in sids):
            return
        if want is None and not moved and fe.stats()["queued"] == 0:
            return
        time.sleep(0.005)


def _swap_events(fe, cause=None, aborted=None, deadline_s=20.0):
    """Ledgered swap events, optionally filtered, waiting for at least
    one match (swap commits and guards land asynchronously)."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        evs = [e for e in fe.ledger.document()["events"]
               if e["kind"] == ledger_mod.SWAP
               and (cause is None or e.get("cause") == cause)
               and (aborted is None
                    or bool(e.get("aborted")) is aborted)]
        if evs:
            return evs
        time.sleep(0.01)
    return []


# ------------------------------------------------------ engine layer


class TestEngineSwap:
    def test_prepare_commit_adopts_successor(self):
        """The double-buffer lifecycle: prepare compiles ASIDE (the
        live program still serves its signature), commit swings the
        fields in place — same Engine object, new program — and the
        engine serves the new signature bit-exactly."""
        rng = np.random.default_rng(0)
        eng = Engine(get_filter("invert"))
        x4 = rng.integers(0, 255, (4, H, W, 3), np.uint8)
        eng.compile(x4.shape, np.uint8)
        np.testing.assert_array_equal(eng.submit(x4).fetch(),
                                      255 - x4)
        prep = eng.prepare_swap((2, H, W, 3))
        assert prep["staged"] is True
        assert prep["compile_aside_ms"] > 0
        # Live program untouched until commit.
        assert eng.signature[0] == (4, H, W, 3)
        np.testing.assert_array_equal(eng.submit(x4).fetch(),
                                      255 - x4)
        assert eng.swap_staged
        res = eng.commit_swap()
        assert res["stall_ms"] >= 0
        assert eng.swap_count == 1
        assert eng.signature[0] == (2, H, W, 3)
        x2 = x4[:2]
        np.testing.assert_array_equal(eng.submit(x2).fetch(),
                                      255 - x2)
        eng.free()

    def test_prepare_at_live_signature_is_noop_unless_forced(self):
        eng = Engine(get_filter("invert"))
        eng.compile((2, H, W, 3), np.uint8)
        prep = eng.prepare_swap((2, H, W, 3))
        assert prep["staged"] is False and prep["cache"] == "live"
        # force=True builds a fresh program at the live signature —
        # the supervised-recovery rebuild, compiled aside.
        prep = eng.prepare_swap((2, H, W, 3), force=True)
        assert prep["staged"] is True
        assert eng.commit_swap(migrate_state=False)["stall_ms"] >= 0
        eng.free()

    def test_concurrent_prepare_dedups_onto_one_compile(self):
        """Satellite 4: two concurrent prepares for the SAME successor
        signature ride one per-signature latch — exactly one compiles
        (cache="miss"), the other adopts the staged program
        (cache="staged"), and one commit serves both."""
        eng = Engine(get_filter("invert"))
        eng.compile((4, H, W, 3), np.uint8)
        results = []
        lock = threading.Lock()

        def prep():
            r = eng.prepare_swap((8, H, W, 3))
            with lock:
                results.append(r)

        threads = [threading.Thread(target=prep) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        caches = sorted(r["cache"] for r in results)
        assert caches == ["miss", "staged"], results
        eng.commit_swap()
        assert eng.signature[0] == (8, H, W, 3)
        assert eng.swap_count == 1
        eng.free()

    def test_prepare_supersedes_staged_last_wins(self):
        eng = Engine(get_filter("invert"))
        eng.compile((2, H, W, 3), np.uint8)
        eng.prepare_swap((4, H, W, 3))
        eng.prepare_swap((8, H, W, 3))  # supersedes: 4-batch freed
        eng.commit_swap()
        assert eng.signature[0] == (8, H, W, 3)
        eng.free()

    def test_abort_swap_keeps_live_program(self):
        rng = np.random.default_rng(1)
        eng = Engine(get_filter("invert"))
        x = rng.integers(0, 255, (2, H, W, 3), np.uint8)
        eng.compile(x.shape, np.uint8)
        eng.prepare_swap((4, H, W, 3))
        assert eng.abort_swap() is True
        assert not eng.swap_staged
        assert eng.abort_swap() is False
        assert eng.signature[0] == (2, H, W, 3)
        np.testing.assert_array_equal(eng.submit(x).fetch(), 255 - x)
        eng.free()

    def test_stateful_swap_migrates_device_state(self):
        """Same-geometry swap of a STATEFUL filter migrates the live
        temporal state device-to-device: the swapped engine's output
        continues the EMA exactly where an unswapped reference is."""
        rng = np.random.default_rng(2)
        batches = [rng.integers(0, 255, (2, H, W, 3), np.uint8)
                   for _ in range(4)]
        eng = Engine(get_filter("ema_smooth", alpha=0.5))
        ref = Engine(get_filter("ema_smooth", alpha=0.5))
        eng.compile(batches[0].shape, np.uint8)
        ref.compile(batches[0].shape, np.uint8)
        for b in batches[:2]:
            np.testing.assert_array_equal(eng.submit(b).fetch(),
                                          ref.submit(b).fetch())
        eng.prepare_swap((2, H, W, 3), force=True)
        res = eng.commit_swap()
        assert res["migrated"] is True
        assert res["migrate_ms"] >= 0
        for b in batches[2:]:
            np.testing.assert_array_equal(eng.submit(b).fetch(),
                                          ref.submit(b).fetch())
        eng.free()
        ref.free()

    def test_stateful_batch_resize_carries_state(self):
        """ema_smooth state is per-FRAME (h, w, c) — batch-size
        independent — so a batch resize migrates it device-to-device:
        the EMA continues across the resize instead of resetting."""
        rng = np.random.default_rng(3)
        eng = Engine(get_filter("ema_smooth", alpha=0.5))
        b4 = rng.integers(0, 255, (4, H, W, 3), np.uint8)
        eng.compile(b4.shape, np.uint8)
        eng.submit(b4)
        eng.prepare_swap((2, H, W, 3))
        assert eng.commit_swap()["migrated"] is True
        eng.free()

    def test_stateful_spatial_change_resets_state(self):
        """A SPATIAL geometry change diverges the state tree's leaf
        shapes, so the old state cannot carry: the successor keeps its
        fresh init state — temporal reset by definition."""
        rng = np.random.default_rng(3)
        eng = Engine(get_filter("ema_smooth", alpha=0.5))
        b = rng.integers(0, 255, (2, H, W, 3), np.uint8)
        eng.compile(b.shape, np.uint8)
        eng.submit(b)
        eng.prepare_swap((2, H // 2, W, 3))
        assert eng.commit_swap()["migrated"] is False
        eng.free()

    def test_chaos_prepare_failure_leaves_live_serving(self):
        """Chaos site ``swap`` event 0 = aside-compile failure: the
        prepare raises, nothing is staged, the live program serves."""
        from dvf_tpu_torch.resilience import ChaosFault

        rng = np.random.default_rng(4)
        eng = Engine(get_filter("invert"),
                     chaos=FaultPlan.parse("swap:at=0", seed=7))
        x = rng.integers(0, 255, (2, H, W, 3), np.uint8)
        eng.compile(x.shape, np.uint8)
        with pytest.raises(ChaosFault):
            eng.prepare_swap((4, H, W, 3))
        assert not eng.swap_staged
        np.testing.assert_array_equal(eng.submit(x).fetch(), 255 - x)
        # The latch was released on failure: a retry compiles fine.
        assert eng.prepare_swap((4, H, W, 3))["staged"] is True
        eng.commit_swap()
        assert eng.signature[0] == (4, H, W, 3)
        eng.free()

    def test_chaos_commit_failure_leaves_live_serving(self):
        """Chaos site ``swap`` event 1 = mid-migrate failure: commit
        raises, the staged successor is freed, the OLD program keeps
        serving bit-exactly."""
        from dvf_tpu_torch.resilience import ChaosFault

        rng = np.random.default_rng(5)
        eng = Engine(get_filter("invert"),
                     chaos=FaultPlan.parse("swap:at=1", seed=7))
        x = rng.integers(0, 255, (2, H, W, 3), np.uint8)
        eng.compile(x.shape, np.uint8)
        eng.prepare_swap((4, H, W, 3))  # event 0: passes
        with pytest.raises(ChaosFault):
            eng.commit_swap()           # event 1: fires mid-commit
        assert not eng.swap_staged
        assert eng.swap_count == 0
        assert eng.signature[0] == (2, H, W, 3)
        np.testing.assert_array_equal(eng.submit(x).fetch(), 255 - x)
        eng.free()


# ----------------------------------------------------- serving layer


class TestServeHotSwap:
    def _cfg(self, **kw):
        base = dict(batch_size=4, queue_size=500, slo_ms=60_000.0)
        base.update(kw)
        return ServeConfig(**base)

    def test_resize_swap_during_inflight_bit_identity(self):
        """The tentpole end to end: a batch resize lands as a hot swap
        while frames are in flight — every delivery bit-exact, indices
        exactly 0..N-1, ZERO ledger stall events, the swap event
        carrying compile_aside_ms / migrate_ms / measured stall_ms (the
        reference's swap-guard and shadow-replay legs wait for the
        audit plane)."""
        n_frames = 48
        fe = ServeFrontend(get_filter("invert"), self._cfg())
        deliveries: dict = {}
        with fe:
            sid = fe.open_stream()
            for j in range(8):
                fe.submit(sid, tagged_frame(0, j))
            # Resize mid-stream, submits continuing while the aside
            # compile runs and the commit lands between ticks.
            label = next(iter(fe.stats()["buckets"]))
            assert fe.request_batch_size(label, 2, reason="test swap")
            for j in range(8, n_frames):
                fe.submit(sid, tagged_frame(0, j))
                time.sleep(0.002)
            drain(fe, [sid], deliveries, want=n_frames)
            swaps = _swap_events(fe, cause=ledger_mod.CAUSE_RESIZE)
            assert swaps, "no swap event ledgered"
            sw = swaps[0]
            # Event schema: the satellite-1 contract.
            assert sw["compile_aside_ms"] > 0
            assert sw["migrate_ms"] >= 0
            assert 0 <= sw["stall_ms"] < 1000.0
            assert sw["batch_size"] == 2
            assert sw["reason"] == "test swap"
            assert not sw.get("aborted")
            # Measured stall rides the EVENT, never a stall window.
            assert fe.ledger.summary()["stall_events_total"] == 0
            assert fe.swaps >= 1 and fe.swap_aborts == 0
            # /metrics: the swap histogram observed the commit.
            text = fe.registry.to_prometheus()
            assert "dvf_swap_stall_ms" in text
            st = fe.stats()
            assert st["swaps"] == fe.swaps

        got = deliveries[sid]
        assert [d.index for d in got] == list(range(n_frames))
        for d in got:
            np.testing.assert_array_equal(
                d.frame, 255 - tagged_frame(0, d.index),
                err_msg=f"frame {d.index} wrong across the swap")

    def test_chaos_aside_compile_failure_contained(self):
        """Chaos-armed resize: the aside compile fails on its
        background thread — the OLD program keeps serving every frame,
        the abort is ledgered (aborted=True, its own error budget), and
        a retry (chaos exhausted) completes the swap."""
        fe = ServeFrontend(
            get_filter("invert"),
            self._cfg(chaos=FaultPlan.parse("swap:at=0", seed=3)))
        deliveries: dict = {}
        with fe:
            sid = fe.open_stream()
            for j in range(8):
                fe.submit(sid, tagged_frame(0, j))
            label = next(iter(fe.stats()["buckets"]))
            assert fe.request_batch_size(label, 2, reason="doomed")
            aborted = _swap_events(fe, aborted=True)
            assert aborted, "abort never ledgered"
            assert "aside compile failed" in aborted[0]["reason"]
            assert fe.swap_aborts == 1 and fe.swaps == 0
            # Old program serving: traffic keeps flowing.
            for j in range(8, 24):
                fe.submit(sid, tagged_frame(0, j))
            drain(fe, [sid], deliveries, want=24)
            # Contained: the frontend is healthy, nothing recovered.
            assert fe.stats()["recoveries"] == 0
            # Retry: the chaos event is spent, the swap lands. (The
            # label re-fetch: it pins to the shape on first traffic.)
            label = next(iter(fe.stats()["buckets"]))
            assert fe.request_batch_size(label, 2, reason="retry")
            ok = _swap_events(fe, cause=ledger_mod.CAUSE_RESIZE,
                              aborted=False)
            assert ok and fe.swaps == 1

        got = deliveries[sid]
        assert [d.index for d in got] == list(range(24))
        for d in got:
            np.testing.assert_array_equal(
                d.frame, 255 - tagged_frame(0, d.index))

    def test_chaos_commit_failure_contained(self):
        """Chaos event 1 = the COMMIT fails mid-migrate: the staged
        successor is freed, the old program keeps serving, the abort is
        ledgered — and the bucket is re-swappable afterwards."""
        fe = ServeFrontend(
            get_filter("invert"),
            self._cfg(chaos=FaultPlan.parse("swap:at=1", seed=3)))
        deliveries: dict = {}
        with fe:
            sid = fe.open_stream()
            for j in range(8):
                fe.submit(sid, tagged_frame(0, j))
            label = next(iter(fe.stats()["buckets"]))
            assert fe.request_batch_size(label, 2, reason="doomed")
            aborted = _swap_events(fe, aborted=True)
            assert aborted
            assert "commit failed" in aborted[0]["reason"]
            assert fe.swap_aborts == 1
            for j in range(8, 24):
                fe.submit(sid, tagged_frame(0, j))
            drain(fe, [sid], deliveries, want=24)
            assert fe.stats()["recoveries"] == 0

        got = deliveries[sid]
        assert [d.index for d in got] == list(range(24))
        for d in got:
            np.testing.assert_array_equal(
                d.frame, 255 - tagged_frame(0, d.index))


# -------------------------------------------------- mid-stream morph


class TestMorphStream:
    def _cfg(self, **kw):
        base = dict(batch_size=2, queue_size=500, slo_ms=60_000.0,
                    max_buckets=4)
        base.update(kw)
        return ServeConfig(**base)

    def test_morph_mid_stream_equivalence_vs_close_reopen(self):
        """``morph_stream`` swaps a session's filter chain mid-stream:
        frames before the ledgered cutover_index come from the OLD
        chain, frames at/after it from the NEW — bit-identical to
        closing and reopening on the new chain, but with ONE session
        and monotone indices 0..N-1 (close/reopen restarts at 0)."""
        k, n_frames = 8, 20
        frames = [tagged_frame(0, j) for j in range(n_frames)]
        fe = ServeFrontend(get_filter("invert"), self._cfg())
        deliveries: dict = {}
        with fe:
            sid = fe.open_stream(op_chain="invert",
                                 frame_shape=(H, W, 3))
            for j in range(k):
                fe.submit(sid, frames[j])
            drain(fe, [sid], deliveries, want=k)
            # Queue drained → the cutover lands exactly at k.
            assert fe.morph_stream(sid, "invert|invert",
                                   reason="test morph") is True
            morphs = _swap_events(fe, cause=ledger_mod.CAUSE_MORPH)
            assert morphs, "morph never ledgered"
            ev = morphs[0]
            assert ev["session"] == sid
            assert ev["cutover_index"] == k
            assert 0 <= ev["stall_ms"] < 1000.0
            assert fe.morphs == 1
            for j in range(k, n_frames):
                fe.submit(sid, frames[j])
            drain(fe, [sid], deliveries, want=n_frames)
            assert fe.ledger.summary()["stall_events_total"] == 0

        # The close/reopen baseline: same frames, two sessions.
        fe2 = ServeFrontend(get_filter("invert"), self._cfg())
        base: dict = {}
        with fe2:
            a = fe2.open_stream(op_chain="invert",
                                frame_shape=(H, W, 3))
            for j in range(k):
                fe2.submit(a, frames[j])
            drain(fe2, [a], base, want=k)
            fe2.close(a, drain=True)
            b = fe2.open_stream(op_chain="invert|invert",
                                frame_shape=(H, W, 3))
            for j in range(k, n_frames):
                fe2.submit(b, frames[j])
            drain(fe2, [b], base, want=n_frames - k)

        got = deliveries[sid]
        assert [d.index for d in got] == list(range(n_frames))
        reopened = base[a] + base[b]
        for d, r in zip(got, reopened):
            np.testing.assert_array_equal(
                d.frame, r.frame,
                err_msg=f"morphed frame {d.index} diverges from the "
                        f"close/reopen baseline")
        # And the content is what each chain computes.
        for d in got[:k]:
            np.testing.assert_array_equal(d.frame,
                                          255 - frames[d.index])
        for d in got[k:]:
            np.testing.assert_array_equal(d.frame, frames[d.index])
        # close/reopen restarted indices; the morph did not.
        assert [d.index for d in base[b]] == list(range(n_frames - k))

    def test_morph_same_chain_is_noop_true(self):
        fe = ServeFrontend(get_filter("invert"), self._cfg())
        with fe:
            sid = fe.open_stream(op_chain="invert",
                                 frame_shape=(H, W, 3))
            fe.submit(sid, tagged_frame(0, 0))
            d: dict = {}
            drain(fe, [sid], d, want=1)
            assert fe.morph_stream(sid, " invert ") is True
            assert fe.morphs == 0

    def test_morph_malformed_chain_raises(self):
        fe = ServeFrontend(get_filter("invert"), self._cfg())
        with fe:
            sid = fe.open_stream(op_chain="invert",
                                 frame_shape=(H, W, 3))
            with pytest.raises(ServeError, match="bad op_chain"):
                fe.morph_stream(sid, "no_such_filter_xyz(a=")

    def test_morph_unknown_session_false(self):
        fe = ServeFrontend(get_filter("invert"), self._cfg())
        with fe:
            assert fe.morph_stream("nope", "invert") is False
