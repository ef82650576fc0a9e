"""BasicVSR++'s deformable convs at their roofline: their counted least
time a frame (``counts/basicvsrpp.py`` ``dcn_ops``: the larger of FLOPs ÷
989e12 and bytes ÷ 3.35e12) over the ``vsr.dcn`` spans' device time a
frame in the traced window, in %."""

from portbench import counts
from portbench.readers import counts_module


def read(outcome):
    spans = outcome.get("vsr_spans")
    if not spans or not spans["frames"] or not spans["ms"].get("vsr.dcn"):
        return None
    ms = spans["ms"]["vsr.dcn"] / spans["frames"]
    cfg = outcome["ctx"].config
    h, w = outcome["frame_hw"]
    least = counts.least_time_s(counts_module(outcome).dcn_ops(cfg, h, w), cfg["dtype"])
    return 100.0 * least / (ms / 1000.0)
