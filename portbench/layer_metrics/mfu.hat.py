"""The whole step's share of the card's bf16 peak: HAT's counted FLOPs a
frame (at the padded size) × frames delivered in the window ÷ the window
÷ 989e12, in %."""

from portbench import counts
from portbench.readers import frame_convs, load_end_to_end


def read(outcome):
    fps = load_end_to_end("fps", outcome).read(outcome)
    if fps is None:
        return None
    peak = counts.PEAK_FLOPS[outcome["ctx"].config["dtype"]]
    return 100.0 * fps * counts.flops(frame_convs(outcome)) / peak
