"""Frames delivered correct and in order during the window, per second of
the whole window."""

from portbench.window import rate


def read(outcome):
    times = outcome.get("in_order_times")
    return None if times is None else rate(times, outcome["t_start"], outcome["t_end"])
