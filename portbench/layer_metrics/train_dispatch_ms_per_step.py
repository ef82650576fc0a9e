"""Host ms a step spends in the step call (the benchmark's own span around
it, no sync inside), mean over the window's steps."""


def read(outcome):
    return outcome.get("dispatch_ms_per_step")
