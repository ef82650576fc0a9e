"""Counts of HAT-SRx4 (``configs/hat_srx4.json``), at the size it runs:
the input reflect-padded to a multiple of the window.

- ``frame(config, h, w)``: every conv and linear of one h×w frame (a
  linear as a ``Conv`` with k = 1 over the token grid, a 1×1 conv of the
  channel attention at 1×1), and each attention as an :class:`Attention`.

An attention's FLOPs are 4·(keys a query)·C a token (q·kᵀ and the
weighted sum of v); its bytes are q, k and v read once, the output
written once and its bias table read once (the scores are not counted).
LayerNorm, GELU, the softmax, the window gathers, the residual adds and
the pixel shuffles are counted inside the layer they follow, with no
bytes of their own.
"""


import math
from dataclasses import dataclass
from typing import List

from portbench.counts import Conv


@dataclass(frozen=True)
class Attention:
    tokens: int
    keys: int        # keys a query attends
    c: int
    table: int       # entries of the relative position bias table

    @property
    def flops(self) -> float:
        return 4.0 * self.keys * self.c * self.tokens

    def bytes(self, dtype_bytes: int) -> float:
        return dtype_bytes * (4 * self.tokens * self.c + self.table)


def padded(config: dict, h: int, w: int):
    ws = config["net"]["window_size"]
    return -(-h // ws) * ws, -(-w // ws) * ws


def attention_block(net: dict, hp: int, wp: int, keys: int, table: int) -> list:
    """One attention block as the spans ``hat.window_attn`` and
    ``hat.ocab_attn`` time it: qkv, the attention, proj."""
    c = net["embed_dim"]
    return [Conv(1, c, 3 * c, hp, wp, hp, wp),
            Attention(hp * wp, keys, c, table),
            Conv(1, c, c, hp, wp, hp, wp)]


def attention_ops(config: dict, h: int, w: int) -> list:
    """Every attention block of a frame (all the HABs' window attentions
    and the OCABs)."""
    net = config["net"]
    hp, wp = padded(config, h, w)
    ws = net["window_size"]
    wse = int(ws * net["overlap_ratio"]) + ws
    ops = []
    for depth, heads in zip(net["depths"], net["num_heads"]):
        for _ in range(depth):
            ops += attention_block(net, hp, wp, ws * ws, (2 * ws - 1) ** 2 * heads)
        ops += attention_block(net, hp, wp, wse * wse, (ws + wse - 1) ** 2 * heads)
    return ops


def frame(config: dict, h: int, w: int) -> List:
    net = config["net"]
    hp, wp = padded(config, h, w)
    c, nf, cin = net["embed_dim"], net["num_feat"], net["in_chans"]
    hid = int(c * net["mlp_ratio"])
    cab = c // net["compress_ratio"]
    sq = c // net["squeeze_factor"]
    ops: List = [Conv(3, cin, c, hp, wp, hp, wp)]
    mlp = [Conv(1, c, hid, hp, wp, hp, wp), Conv(1, hid, c, hp, wp, hp, wp)]
    ws = net["window_size"]
    wse = int(ws * net["overlap_ratio"]) + ws
    for depth, heads in zip(net["depths"], net["num_heads"]):
        for _ in range(depth):
            ops += attention_block(net, hp, wp, ws * ws, (2 * ws - 1) ** 2 * heads)
            ops += [Conv(3, c, cab, hp, wp, hp, wp), Conv(3, cab, c, hp, wp, hp, wp),
                    Conv(1, c, sq, 1, 1, 1, 1), Conv(1, sq, c, 1, 1, 1, 1)]
            ops += mlp
        ops += attention_block(net, hp, wp, wse * wse, (ws + wse - 1) ** 2 * heads)
        ops += mlp
        ops.append(Conv(3, c, c, hp, wp, hp, wp))
    ops += [Conv(3, c, c, hp, wp, hp, wp), Conv(3, c, nf, hp, wp, hp, wp)]
    for i in range(int(math.log2(net["upscale"]))):
        s = 2 ** i
        ops.append(Conv(3, nf, 4 * nf, hp * s, wp * s, hp * s, wp * s))
    s = net["upscale"]
    ops.append(Conv(3, nf, cin, hp * s, wp * s, hp * s, wp * s))
    return ops
