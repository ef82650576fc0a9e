"""HAT's least time a frame (the sum over its convs, linears and
attentions of the larger of FLOPs ÷ 989e12 and bytes ÷ 3.35e12, at the
padded size) over its kernels' device time a frame in the traced window,
in %."""

from portbench import counts
from portbench.readers import frame_convs, net_device_s_per_frame


def read(outcome):
    s = net_device_s_per_frame(outcome)
    if not s:
        return None
    least = counts.least_time_s(frame_convs(outcome), outcome["ctx"].config["dtype"])
    return 100.0 * least / s
