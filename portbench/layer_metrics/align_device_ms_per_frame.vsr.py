"""Device ms a frame of BasicVSR++'s second-order deformable alignment: the
``vsr.warp`` (feature warps, second-order flow), ``vsr.offset`` (the offset
stack and its float32 epilogue) and ``vsr.dcn`` (sampling, mask, GEMM and
bias) spans of the clips collected in the traced window, over their
frames."""

ALIGN_SPANS = ("vsr.warp", "vsr.offset", "vsr.dcn")


def read(outcome):
    spans = outcome.get("vsr_spans")
    if not spans or not spans["frames"] or not spans["ms"]:
        return None
    return sum(spans["ms"].get(n, 0.0) for n in ALIGN_SPANS) / spans["frames"]
