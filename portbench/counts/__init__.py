"""Work counted from shapes, and the card's published peaks.

A conv's FLOPs are 2·k²·Cin·Cout per output pixel. Its bytes are its input
read once and its output written once at the compute dtype, plus its
weights once; the norm, ReLU, residual add and upsample around it are
counted inside it, with no bytes of their own (an upsample conv reads the
low-resolution input). A layer's least time is the larger of its FLOPs
over the peak rate and its bytes over the peak bandwidth, and a net's least
time is the sum over its layers. The counts read the same work whatever
implements it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Conv:
    k: int
    cin: int
    cout: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int

    @property
    def flops(self) -> float:
        return 2.0 * self.k * self.k * self.cin * self.cout * self.h_out * self.w_out

    def bytes(self, dtype_bytes: int) -> float:
        return dtype_bytes * (self.h_in * self.w_in * self.cin
                              + self.h_out * self.w_out * self.cout
                              + self.k * self.k * self.cin * self.cout)


def least_time_s(convs: Iterable[Conv], dtype: str) -> float:
    b = DTYPE_BYTES[dtype]
    return sum(max(c.flops / PEAK_FLOPS[dtype], c.bytes(b) / PEAK_BYTES_PER_S)
               for c in convs)


def flops(convs: Iterable[Conv]) -> float:
    return sum(c.flops for c in convs)
