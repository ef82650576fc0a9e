"""The Johnson transform net in float32, NHWC at the boundary.

Layers (supplementary Table 1 of arXiv:1603.08155, with the departures
the configuration lists): 9×9 conv to c, 3×3 stride-2 convs to 2c and 4c,
n residual blocks (conv, norm, ReLU, conv, norm, add), two nearest ×2
upsamples each followed by a 3×3 conv (to 2c, then c), a 9×9 conv to 3,
and ``(tanh + 1) / 2``. Every conv reflect-pads by k // 2 and adds its
bias; every conv but the last is followed by an instance norm (population
variance, eps 1e-5, per-channel scale and bias) and, outside the second
conv of a residual block, a ReLU.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import F32, Precision


def conv(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1,
         prec: Precision = F32) -> torch.Tensor:
    """NCHW ``x`` by an HWIO weight, reflect padding, plus bias."""
    w = p["w"].permute(3, 2, 0, 1)
    r = w.shape[-1] // 2
    x = F.pad(x, (r, r, r, r), mode="reflect")
    return prec.conv2d(x, w, p["b"], stride=stride)


def instance_norm(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    y = (x - mean) / torch.sqrt(var + 1e-5)
    return y * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


def forward(params: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor,
            n_res: int, prec: Precision = F32) -> torch.Tensor:
    """float NHWC in [0, 1] → float NHWC in [0, 1]."""
    a = prec.act
    h = a(x.permute(0, 3, 1, 2).float())

    def block(name, h, stride=1):
        y = a(instance_norm(params[name + "_norm"], a(conv(params[name], h, stride, prec))))
        return a(torch.relu(y))

    h = block("stem", h)
    h = block("down1", h, stride=2)
    h = block("down2", h, stride=2)
    for i in range(n_res):
        y = a(conv(params[f"res{i}_a"], h, prec=prec))
        y = a(torch.relu(a(instance_norm(params[f"res{i}_an"], y))))
        y = a(conv(params[f"res{i}_b"], y, prec=prec))
        y = a(instance_norm(params[f"res{i}_bn"], y))
        h = a(h + y)
    h = block("up1", F.interpolate(h, scale_factor=2, mode="nearest"))
    h = block("up2", F.interpolate(h, scale_factor=2, mode="nearest"))
    h = conv(params["out"], h, prec=prec)
    return a((0.5 * (torch.tanh(h) + 1.0)).permute(0, 2, 3, 1))


def to_uint8(y: torch.Tensor) -> torch.Tensor:
    """Frames in [0, 1] to bytes, as a video sink receives them."""
    return torch.round(torch.clamp(y, 0.0, 1.0) * 255.0).to(torch.uint8)
