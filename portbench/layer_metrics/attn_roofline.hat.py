"""HAT's attention blocks at their roofline: the counted least time a frame
of every window and overlapping attention block (qkv, the attention and
proj, ``counts/hat.py``) over their device time a frame
(``attn_device_ms_per_frame.hat``), in %."""

from portbench import counts, spec
from portbench.readers import counts_module


def read(outcome):
    ms = spec.load_module("layer_metrics", "attn_device_ms_per_frame.hat",
                          outcome["ctx"].root).read(outcome)
    if not ms:
        return None
    cfg = outcome["ctx"].config
    h, w = outcome["frame_hw"]
    least = counts.least_time_s(counts_module(outcome).attention_ops(cfg, h, w), cfg["dtype"])
    return 100.0 * least / (ms / 1000.0)
