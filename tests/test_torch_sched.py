"""The port's reorder buffer and drop-oldest queue (counterpart of
``tests/test_sched.py``), imported through ``dvf_tpu_torch.sched`` so the
package's exports are what is tested.

The invariants come from distributor.py:173-203 (queue) and
distributor.py:291-344 (reorder). The last class drives both packages'
classes through one seeded schedule and holds the port's every
observable to the JAX package's.
"""

import random
import threading

import pytest

from dvf_tpu.sched import DropOldestQueue as JaxDropOldestQueue
from dvf_tpu.sched import ReorderBuffer as JaxReorderBuffer
from dvf_tpu_torch.sched import DropOldestQueue, ReorderBuffer


class TestDropOldestQueue:
    def test_fifo(self):
        q = DropOldestQueue(maxsize=4)
        for i in range(3):
            q.put(i)
        assert [q.get_nowait() for _ in range(3)] == [0, 1, 2]

    def test_evicts_oldest_when_full(self):
        q = DropOldestQueue(maxsize=3)
        evicted = [q.put(i) for i in range(5)]
        # puts 3,4 evicted 0,1 (distributor.py:195-198 semantics)
        assert evicted == [None, None, None, 0, 1]
        assert [q.get_nowait() for _ in range(3)] == [2, 3, 4]
        assert q.dropped == 2

    def test_pop_up_to_fifo(self):
        q = DropOldestQueue(maxsize=10)
        for i in range(7):
            q.put(i)
        assert q.pop_up_to(4) == [0, 1, 2, 3]  # oldest first, no drops
        assert q.pop_up_to(10) == [4, 5, 6]
        assert q.pop_up_to(4) == []
        assert q.dropped == 0

    def test_producer_never_blocks(self):
        q = DropOldestQueue(maxsize=2)
        done = threading.Event()

        def producer():
            for i in range(10_000):
                q.put(i)
            done.set()

        t = threading.Thread(target=producer)
        t.start()
        t.join(timeout=5)
        assert done.is_set()

    def test_get_timeout(self):
        q = DropOldestQueue(maxsize=2)
        with pytest.raises(TimeoutError):
            q.get(timeout=0.01)


class TestReorderBuffer:
    def test_cursor_lags_latest_by_delay(self):
        rb = ReorderBuffer(frame_delay=5)
        for i in range(20):
            rb.complete(i, f"frame{i}")
        rb.advance()
        assert rb.cursor == 19 - 5
        assert rb.get() == "frame14"

    def test_warmup_tracks_latest(self):
        """Below frame_delay depth the cursor follows latest (distributor.py:339-343)."""
        rb = ReorderBuffer(frame_delay=5)
        rb.complete(3, "f3")
        assert rb.advance()
        assert rb.cursor == 3

    def test_advances_past_missing(self):
        """A lost frame never stalls the cursor (distributor.py:334-338)."""
        rb = ReorderBuffer(frame_delay=2)
        for i in [0, 1, 2, 3, 5, 6, 7]:  # 4 lost
            rb.complete(i, i)
        rb.advance()
        assert rb.cursor == 5  # 7 - 2, even though 4 was never received

    def test_closest_fallback(self):
        """Missing cursor target falls back to nearest index (distributor.py:317-321)."""
        rb = ReorderBuffer(frame_delay=0)
        rb.complete(10, "f10")
        rb.complete(14, "f14")
        rb.cursor = 11
        assert rb.get() == "f10"  # |10-11| < |14-11|
        rb.cursor = 13
        assert rb.get() == "f14"

    def test_empty_returns_none(self):
        rb = ReorderBuffer()
        assert rb.get() is None
        assert not rb.advance()

    def test_eviction_below_cursor(self):
        rb = ReorderBuffer(frame_delay=2)
        for i in range(10):
            rb.complete(i, i)
            rb.advance()
        # eviction runs on the receive path (distributor.py:282), so frames
        # below the cursor disappear on the *next* complete
        rb.complete(10, 10)
        rb.advance()          # cursor -> 8; frame 7 still present (faithful)
        rb.complete(11, 11)   # receive-path eviction clears < 8
        assert all(i >= 8 for i in rb._frames)

    def test_capacity_cap_evicts_oldest(self):
        rb = ReorderBuffer(frame_delay=1000, capacity=10)  # delay huge: cursor stays 0
        for i in range(25):
            rb.complete(i, i)
        assert len(rb) == 10
        assert min(rb._frames) == 15  # oldest evicted (distributor.py:302-307)

    def test_out_of_order_completion(self):
        rb = ReorderBuffer(frame_delay=3)
        order = list(range(30))
        random.Random(0).shuffle(order)
        for i in order:
            rb.complete(i, i)
        rb.advance()
        assert rb.cursor == 29 - 3
        assert rb.get() == 26

    def test_pop_ready_exactly_once(self):
        rb = ReorderBuffer(frame_delay=2)
        seen = []
        for i in range(10):
            rb.complete(i, i)
            rb.advance()
            seen.extend(idx for idx, _ in rb.pop_ready())
        assert seen == sorted(set(seen))  # no duplicates, ordered
        assert seen[-1] == 7  # 9 - delay

    def test_stats_shape(self):
        rb = ReorderBuffer(frame_delay=5)
        rb.complete(0, "x")
        s = rb.stats()
        assert set(s) == {
            "buffer_size", "current_display_frame", "latest_received_frame",
            "frame_delay", "completed_total",
        }

    def test_concurrent_complete_and_advance(self):
        """collect-thread vs display-thread interleaving (SURVEY.md §5.2)."""
        rb = ReorderBuffer(frame_delay=5, capacity=50)
        stop = threading.Event()

        def completer():
            for i in range(5000):
                rb.complete(i, i)
            stop.set()

        errors = []

        def consumer():
            while not stop.is_set():
                try:
                    rb.advance()
                    rb.get()
                except Exception as e:  # pragma: no cover
                    errors.append(e)

        t1 = threading.Thread(target=completer)
        t2 = threading.Thread(target=consumer)
        t1.start(); t2.start()
        t1.join(timeout=10); t2.join(timeout=10)
        assert not errors
        rb.advance()
        assert rb.cursor == 4999 - 5


class TestParityWithJaxPackage:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_reorder_schedule_matches(self, seed):
        """A seeded schedule of completions (jittered, with losses),
        advances, gets and drains: the same observations from both."""
        rng = random.Random(seed)
        order = sorted(range(200), key=lambda i: i + rng.uniform(0, 6))
        order = [i for i in order if rng.random() > 0.15]
        bufs = [ReorderBuffer(frame_delay=4, capacity=20),
                JaxReorderBuffer(frame_delay=4, capacity=20)]
        seen = [[], []]
        for k, idx in enumerate(order):
            for b, out in zip(bufs, seen):
                b.complete(idx, idx)
                if k % 3 == 0:
                    out.append(("adv", b.advance(), b.cursor))
                out.append(("get", b.get(), len(b)))
                if k % 5 == 0:
                    out.append(("pop", [i for i, _ in b.pop_ready()]))
        for b, out in zip(bufs, seen):
            b.flush()
            out.append(("flush", [i for i, _ in b.pop_ready()], b.stats()))
        assert seen[0] == seen[1]

    def test_queue_schedule_matches(self):
        rng = random.Random(7)
        qs = [DropOldestQueue(maxsize=5), JaxDropOldestQueue(maxsize=5)]
        seen = [[], []]
        for i in range(300):
            op = rng.random()
            n = rng.randint(1, 4)
            for q, out in zip(qs, seen):
                if op < 0.6:
                    out.append(("put", q.put(i)))
                else:
                    out.append(("pop", q.pop_up_to(n)))
                out.append((len(q), q.dropped))
        assert seen[0] == seen[1]
