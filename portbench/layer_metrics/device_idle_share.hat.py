"""1 − the union of kernel, copy and set intervals ÷ the traced window, in %."""

from portbench.readers import idle_share_pct


def read(outcome):
    return idle_share_pct(outcome)
