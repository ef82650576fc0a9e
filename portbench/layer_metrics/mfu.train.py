"""The whole train step's share of the card's bf16 peak: counted FLOPs a
step × steps completed in the window ÷ the window ÷ 989e12, in %."""

from portbench import counts
from portbench.readers import counts_module


def read(outcome):
    if not outcome.get("steps_in_window"):
        return None
    cfg = outcome["ctx"].config
    batch, size = outcome["train_geometry"]
    per_step = counts_module(outcome).train_step_flops(cfg, batch, size)
    rate = outcome["steps_in_window"] / outcome["window_s"]
    return 100.0 * rate * per_step / counts.PEAK_FLOPS[cfg["dtype"]]
