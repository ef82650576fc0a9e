"""The comparison that decides ``correct`` for served frames.

Each sampled frame the program delivered is set against the float32
reference's output for the input the benchmark sent under that index,
scaled to 0..255: the frame's gap is the root mean square of the
difference in levels, and the number compared is the worst frame's gap.
The reference runs after the window, once the program's state is freed,
a few frames at a time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import F32, FP8, johnson, no_tf32


def reference_outputs(params, inputs: Dict[int, np.ndarray], n_res: int, device,
                      prec=F32, block: int = 4) -> Dict[int, torch.Tensor]:
    """{key: float32 (H, W, 3) in [0, 1]} of the reference on each input."""
    keys = sorted(inputs)
    out = {}
    with torch.no_grad(), no_tf32():
        for i in range(0, len(keys), block):
            ks = keys[i:i + block]
            x = torch.from_numpy(np.stack([inputs[k] for k in ks])).to(device)
            y = johnson.forward(params, x.float() / 255.0, n_res, prec)
            for k, yk in zip(ks, y):
                out[k] = yk
    return out


def worst_rms_gap(pairs: List[Tuple[np.ndarray, torch.Tensor]]) -> float:
    """Max over (delivered uint8 frame, reference float frame) pairs of the
    RMS difference in levels; ``inf`` where nothing was delivered."""
    worst = 0.0 if pairs else math.inf
    for got, ref in pairs:
        g = torch.from_numpy(np.asarray(got)).to(ref.device).float()
        if g.shape != ref.shape:
            return math.inf
        worst = max(worst, float(torch.sqrt(torch.mean((g - ref * 255.0) ** 2))))
    return worst


def control_gap(params, inputs: Dict[int, np.ndarray], n_res: int, device) -> float:
    """The control: the reference computed in float8 (e4m3), rounded to
    bytes as the program's frames are, held to the float32 reference."""
    ref = reference_outputs(params, inputs, n_res, device)
    low = reference_outputs(params, inputs, n_res, device, prec=FP8)
    return worst_rms_gap([(johnson.to_uint8(low[k]).cpu().numpy(), ref[k]) for k in ref])
