"""The window's seconds × 1000 over the train steps completed in it."""


def read(outcome):
    n = outcome.get("steps_in_window")
    return None if not n else 1000.0 * outcome["window_s"] / n
