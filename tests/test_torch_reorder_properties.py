"""Property-based tests for the port's reorder buffer (hypothesis;
counterpart of ``tests/test_reorder_properties.py``, imported through
``dvf_tpu_torch.sched``).

The example-based invariant tests live in tests/test_torch_sched.py; these
drive the same spec (distributor.py:291-344 semantics, as documented in
sched/reorder.py) under RANDOM completion orders, drops, jitter, and
interleavings of advance/get/pop_ready — the adversarial schedules a
threaded collector can actually produce.

Two spec subtleties these properties encode (both inherited from the
reference):

- eviction is LAZY — it runs inside complete() (the reference's
  cleanup_old_frames is called from the collect loop, distributor.py:282),
  so between an advance() and the next completion, entries below the new
  cursor may linger;
- a frame completing BELOW the current cursor is dropped-by-lateness
  (distributor.py:293-299) — at-most-once delivery, never replay.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from dvf_tpu_torch.sched import ReorderBuffer


@st.composite
def jittered_stream(draw):
    """A plausible collector arrival stream: indices 0..n-1, each delayed
    by a bounded random amount (out-of-order completion), a random subset
    dropped entirely (lost frames)."""
    n = draw(st.integers(min_value=1, max_value=60))
    jitter = draw(st.integers(min_value=0, max_value=8))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    order = np.argsort(np.arange(n) + rng.uniform(0, jitter + 1e-9, n))
    dropped = set(rng.choice(n, size=int(n * draw(st.floats(0, 0.4))),
                             replace=False).tolist())
    return [int(i) for i in order if int(i) not in dropped]


@given(stream=jittered_stream(),
       frame_delay=st.integers(0, 7),
       capacity=st.integers(1, 50),
       advance_every=st.integers(1, 5))
@settings(max_examples=200, deadline=None)
def test_invariants_under_random_schedules(stream, frame_delay, capacity,
                                           advance_every):
    buf = ReorderBuffer(frame_delay=frame_delay, capacity=capacity)
    prev_cursor = 0
    for k, idx in enumerate(stream):
        buf.complete(idx, payload=idx)
        # Post-complete (eviction just ran against the CURRENT cursor):
        # capacity cap holds and nothing below the cursor is retained.
        assert len(buf) <= capacity
        assert all(i >= buf.cursor for i in buf._frames)
        if (k + 1) % advance_every == 0:
            buf.advance()
        # Cursor is strictly monotonic (never replays old content, unlike
        # the reference's backward-moving closest fallback) and never
        # outruns the newest completion.
        assert buf.cursor >= prev_cursor
        prev_cursor = buf.cursor
        assert buf.cursor <= max(buf.latest, 0)
        # get() returns the cursor frame when present, else the closest
        # held index, else None (distributor.py:309-322).
        got = buf.get()
        if buf.cursor in buf._frames:
            assert got == buf.cursor
        elif len(buf):
            assert abs(got - buf.cursor) == min(
                abs(i - buf.cursor) for i in buf._frames)
        else:
            assert got is None
    # Once deep enough, the cursor lag is AT MOST frame_delay — not
    # exactly: the shallow-phase rule (cursor tracks latest while
    # latest < frame_delay, distributor.py:339-343) can put the cursor
    # ahead of latest-delay, and monotonicity then keeps it there (the
    # reference would move it backwards; ours deliberately doesn't).
    buf.advance()
    if buf.latest >= frame_delay:
        assert buf.latest - frame_delay <= buf.cursor <= buf.latest
    assert buf.completed_total == len(stream)


@given(stream=jittered_stream(), frame_delay=st.integers(0, 7))
@settings(max_examples=100, deadline=None)
def test_streaming_drain_is_ordered_unique_and_complete_modulo_lateness(
        stream, frame_delay):
    """pop_ready() (the non-display sink mode) must deliver indices in
    strictly increasing order with no duplicates; with unbounded capacity
    and a final flush, every frame that completed AT OR ABOVE the cursor
    of its completion moment is delivered exactly once — frames arriving
    below the cursor are dropped-by-lateness per the reference spec."""
    buf = ReorderBuffer(frame_delay=frame_delay, capacity=10**9)
    delivered, expected = [], []
    for idx in stream:
        if idx >= buf.cursor:
            expected.append(idx)
        buf.complete(idx, payload=idx)
        buf.advance()
        delivered.extend(i for i, _ in buf.pop_ready())
    buf.flush()
    delivered.extend(i for i, _ in buf.pop_ready())
    assert delivered == sorted(delivered)
    assert len(delivered) == len(set(delivered))
    assert sorted(delivered) == sorted(expected)
