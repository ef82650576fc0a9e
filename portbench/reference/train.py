"""The perceptual-loss train step in float32, one step at a time.

loss = content_weight · content + style_weight · style + tv_weight · tv,
with, over the VGG blocks b = 1..L of the net's output ŷ and the input x:
- content = mean_b mean((φ_b(ŷ) − φ_b(x))²);
- style = mean_b mean((G(φ_b(ŷ)) − G_b^style)²) / (mean((G_b^style)²) + 1e-12);
- tv = mean((ŷ[:, 1:] − ŷ[:, :-1])²) + mean((ŷ[:, :, 1:] − ŷ[:, :, :-1])²);
G(f) the Gram matrix over H·W divided by H·W·C. The encoder's features of
x carry no gradient. Adam: optax's defaults (β 0.9 / 0.999, ε 1e-8).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference import F32, Precision, johnson, vgg

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def loss_fn(params, batch: torch.Tensor, vgg_params, grams: List[torch.Tensor],
            blocks: Sequence[Sequence[int]], n_res: int, weights: Dict[str, float],
            prec: Precision = F32) -> torch.Tensor:
    out = johnson.forward(params, batch, n_res, prec)
    of = vgg.features(vgg_params, out, blocks, prec)
    with torch.no_grad():
        cf = vgg.features(vgg_params, batch, blocks, prec)
    content = sum(torch.mean((a - b) ** 2) for a, b in zip(of, cf)) / len(of)
    style = sum(torch.mean((vgg.gram(f) - g[None]) ** 2) / (torch.mean(g ** 2) + 1e-12)
                for f, g in zip(of, grams)) / len(of)
    dh = out[:, 1:] - out[:, :-1]
    dw = out[:, :, 1:] - out[:, :, :-1]
    tv = torch.mean(dh ** 2) + torch.mean(dw ** 2)
    return (weights["content_weight"] * content + weights["style_weight"] * style
            + weights["tv_weight"] * tv)


class Adam:
    """Adam over a flat dict of leaves (float32)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], lr: float):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    def step(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
        with torch.no_grad():
            for k, p in leaves.items():
                g = grads[k]
                self.m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                self.v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                p.sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + EPS))


def flat(params) -> Dict[str, torch.Tensor]:
    return {f"{k}/{n}": t for k, v in params.items() for n, t in v.items()}


def nest(leaves: Dict[str, torch.Tensor]):
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in leaves.items():
        k, n = key.split("/")
        out.setdefault(k, {})[n] = t
    return out


def run_steps(params, vgg_params, style_image, batches: List[torch.Tensor],
              blocks, n_res: int, weights: Dict[str, float], lr: float, prec: Precision = F32
              ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Train a float32 copy of ``params`` on ``batches`` in turn. Returns each
    step's loss, the first step's gradient and each leaf's change after the
    last step, both keyed ``layer/leaf``."""
    leaves = {k: t.detach().clone().float().requires_grad_(True)
              for k, t in flat(params).items()}
    start = {k: t.detach().clone() for k, t in leaves.items()}
    with torch.no_grad():
        grams = vgg.style_grams(vgg_params, style_image, blocks, prec)
    opt = Adam(leaves, lr)
    losses, first_grad = [], None
    for batch in batches:
        for t in leaves.values():
            t.grad = None
        loss = loss_fn(nest(leaves), batch, vgg_params, grams, blocks, n_res, weights, prec)
        loss.backward()
        grads = {k: t.grad for k, t in leaves.items()}
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(leaves, grads)
        losses.append(float(loss.detach()))
    change = {k: (leaves[k].detach() - start[k]) for k in leaves}
    return losses, first_grad, change
