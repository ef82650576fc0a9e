"""Device ms a frame of BasicVSR++'s flow estimation: the ``vsr.flow``
spans (SpyNet on every pair of neighbouring frames, both directions) of
the clips collected in the traced window, over their frames."""


def read(outcome):
    spans = outcome.get("vsr_spans")
    if not spans or not spans["frames"] or "vsr.flow" not in spans["ms"]:
        return None
    return spans["ms"]["vsr.flow"] / spans["frames"]
