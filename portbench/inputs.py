"""Inputs made from ``--seed``: frames, weights and training images.

Frames are a frozen copy of the port's ``SyntheticSource`` noise texture
(seeded iid noise plus a horizontal ramp, ``base // 2 + ramp // 2``) and
its cycle of 2-pixel rolls, with the cycle length a traffic parameter.
The frames are read-only arrays served as views.

Weights are drawn on the device with one ``torch.Generator`` in one call
per net (a flat standard normal buffer, cut leaf by leaf): He-normal conv
weights, and small random biases and norm affines so that every leaf is
exercised. The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def frame_cycle(seed: int, height: int, width: int, cycle: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(height, width, 3), dtype=np.uint8)
    ramp = np.linspace(0, 255, width, dtype=np.uint8)[None, :, None]
    base = (base // 2 + ramp // 2).astype(np.uint8)
    frames = [np.roll(base, (i * 2) % width, axis=1) for i in range(cycle)]
    for f in frames:
        f.setflags(write=False)
    return frames


# A layer: (name, kind, shape). kind "conv": {"w": (k, k, cin, cout), "b"};
# "norm": {"scale", "bias"} of width c.
Layer = Tuple[str, str, Tuple[int, ...]]


def johnson_layers(c: int, n_res: int) -> List[Layer]:
    """The transform net's leaves in the port's layout (HWIO convs)."""
    c1, c2, c3 = c, 2 * c, 4 * c
    out: List[Layer] = [("stem", "conv", (9, 3, c1)), ("stem_norm", "norm", (c1,)),
                        ("down1", "conv", (3, c1, c2)), ("down1_norm", "norm", (c2,)),
                        ("down2", "conv", (3, c2, c3)), ("down2_norm", "norm", (c3,))]
    for i in range(n_res):
        out += [(f"res{i}_a", "conv", (3, c3, c3)), (f"res{i}_an", "norm", (c3,)),
                (f"res{i}_b", "conv", (3, c3, c3)), (f"res{i}_bn", "norm", (c3,))]
    out += [("up1", "conv", (3, c3, c2)), ("up1_norm", "norm", (c2,)),
            ("up2", "conv", (3, c2, c1)), ("up2_norm", "norm", (c1,)),
            ("out", "conv", (9, c1, 3))]
    return out


def vgg_layers(blocks: Sequence[Sequence[int]]) -> List[Layer]:
    """VGG prefix leaves ``b{block}c{conv}``, 3x3 convs."""
    out: List[Layer] = []
    cin = 3
    for bi, (n, c) in enumerate(blocks):
        for ci in range(n):
            out.append((f"b{bi}c{ci}", "conv", (3, cin, c)))
            cin = c
    return out


def _numel(kind: str, shape) -> int:
    if kind == "conv":
        k, cin, cout = shape
        return k * k * cin * cout + cout
    return 2 * shape[0]


def make_params(layers: List[Layer], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Float32 params on ``device`` from one seeded normal draw."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(_numel(kind, shape) for _, kind, shape in layers)
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for name, kind, shape in layers:
        if kind == "conv":
            k, cin, cout = shape
            n = k * k * cin
            w = buf[at:at + n * cout].view(k, k, cin, cout) * math.sqrt(2.0 / n)
            at += n * cout
            b = buf[at:at + cout] * 0.01
            at += cout
            params[name] = {"w": w, "b": b}
        else:
            c = shape[0]
            params[name] = {"scale": 1.0 + 0.1 * buf[at:at + c],
                            "bias": 0.1 * buf[at + c:at + 2 * c]}
            at += 2 * c
    return params


def train_images(seed: int, n: int, size: int, device) -> torch.Tensor:
    """``n`` float32 NHWC images in [0, 1]: smooth random fields, each with
    its own brightness and contrast, so that no two rows are alike."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    coarse = torch.rand((n, 3, size // 8, size // 8), generator=gen, device=device)
    fine = torch.rand((n, 3, size, size), generator=gen, device=device)
    ab = torch.rand((n, 2, 1, 1), generator=gen, device=device)
    smooth = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                             align_corners=False)
    img = ab[:, :1] * 0.5 + (0.25 + ab[:, 1:]) * (0.8 * smooth + 0.2 * fine - 0.5)
    return img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()
