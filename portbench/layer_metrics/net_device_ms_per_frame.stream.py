"""Device time of the kernels in the traced window (copies left out) per
frame delivered in it."""

from portbench.readers import net_device_s_per_frame


def read(outcome):
    s = net_device_s_per_frame(outcome)
    return None if s is None else 1000.0 * s
