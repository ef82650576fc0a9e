"""Device ms of the device-to-host copies per batch delivered in the traced
window: the egress's transfer, whichever of the port's egress paths
(streamed or monolithic) carries it."""


def read(outcome):
    tr = outcome.get("trace")
    if tr is None or not tr.get("frames"):
        return None
    return 1000.0 * tr["d2h_s"] * outcome["batch"] / tr["frames"]
