"""Shared arithmetic of the metric readers (``end_to_end/``,
``layer_metrics/``). Each reader returns None where its run has nothing to
read, and the metric is then left out of the line."""

from __future__ import annotations

from typing import Optional

from portbench import counts, spec


def load_end_to_end(name: str, outcome):
    """Another metric's reader, to build on its value."""
    return spec.load_module("end_to_end", name, outcome["ctx"].root)


def counts_module(outcome):
    ctx = outcome["ctx"]
    return spec.load_module("counts", ctx.config["counts"], ctx.root)


def idle_share_pct(outcome) -> Optional[float]:
    tr = outcome.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def frame_convs(outcome):
    h, w = outcome["frame_hw"]
    return counts_module(outcome).frame(outcome["ctx"].config, h, w)


def net_device_s_per_frame(outcome) -> Optional[float]:
    tr = outcome.get("trace")
    if tr is None or not tr.get("frames"):
        return None
    return tr["kernel_s"] / tr["frames"]
