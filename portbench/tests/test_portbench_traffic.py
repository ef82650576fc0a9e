"""The generator and the window arithmetic, on synthetic clocks and on a
tiny closed-loop stream through the port's CPU pipeline."""

import math
import threading

import pytest
import torch

from portbench import run as runmod
from portbench import window


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def test_open_loop_stamps_due_times_and_never_slips():
    clock = FakeClock()
    due = window.due_times(start=10.0, phase=0.01, period=0.1, end=11.0)
    assert due == pytest.approx([10.01 + 0.1 * k for k in range(10)])
    sent = []

    def emit(k, t):
        sent.append((k, t, clock()))
        if k == 2:
            clock.t += 0.35          # a stall while sending frame 2

    loop = window.OpenLoop(due, emit, clock=clock, sleep=clock.sleep)
    loop.run()
    # Every frame keeps its own due time; those after the stall go late
    # instead of the schedule moving.
    assert [t for _, t, _ in sent] == due
    assert loop.late[:3] == pytest.approx([0.0, 0.0, 0.0])
    assert loop.late[3] == pytest.approx(0.25)
    assert loop.late[4] == pytest.approx(0.15)
    assert loop.late[6] == pytest.approx(0.0)


def test_closed_loop_holds_the_source_at_its_window():
    loop = window.ClosedLoop(3)
    for _ in range(3):
        assert loop.admit()
    blocked = threading.Thread(target=loop.admit)
    blocked.start()
    blocked.join(0.2)
    assert blocked.is_alive()
    loop.complete()
    blocked.join(2.0)
    assert not blocked.is_alive() and loop.admitted == 4


def test_rate_is_all_work_over_the_whole_window_with_a_stall():
    # 10 items a second for 2 s, then a 2 s stall, then 10 a second again.
    times = [0.1 * k for k in range(20)] + [4.0 + 0.1 * k for k in range(10)]
    assert window.rate(times, 0.0, 5.0) == pytest.approx(30 / 5.0)
    assert window.rate(times, 1.0, 4.45) == pytest.approx(15 / 3.45)


def test_tail_is_over_every_sample_and_counts_missing_ones():
    lat = [10.0] * 90 + [500.0] * 10                 # the stall's ten frames
    assert window.percentile(lat, 95) == pytest.approx(500.0)
    assert window.percentile(lat, 50) == pytest.approx(10.0)
    lost = [10.0] * 94 + [math.inf] * 6              # six never came
    assert window.percentile(lost, 95) == math.inf


STREAM_TINY = {"height": 32, "width": 48, "batch": 4, "cycle": 8, "outstanding": 8,
               "queue_size": 12, "warmup_frames": 8, "sample": 8, "expected_fps": 40}


def test_closed_loop_stream_never_drops_a_frame():
    res = runmod.run_cell("style.stream720", 2**31 + 12345, 1.5, False, torch.device("cpu"),
                          cell_override=STREAM_TINY)
    assert res["checks"]["frames_lost"]["value"] == 0
    assert res["checks"]["order_errors"]["value"] == 0
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["fps"]["value"] > 0
