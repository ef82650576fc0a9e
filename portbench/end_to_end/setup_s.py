"""Process start to the window's start: imports, CUDA context, weights,
inputs, compile and warm-up."""


def read(outcome):
    return outcome["setup_s"]
