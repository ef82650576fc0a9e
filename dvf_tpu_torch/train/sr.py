"""The SR family's data helpers (port of part of ``dvf_tpu.train.sr``):
the randomized structured frames the ESPCN net was trained on and the
area downscale that makes its low-resolution inputs. The training step
waits for the training slice."""

from __future__ import annotations

import numpy as np
import torch


def synthesize_structured_batch(rng: np.random.Generator, batch: int,
                                size: int) -> np.ndarray:
    """Randomized structured HR frames (oriented gratings, rings around
    random centres, hard-edged checkers; a fresh draw per channel), the
    same bytes as the reference for the same generator state. Values
    uint8, shape (B, size, size, 3)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((batch, size, size, 3), np.uint8)
    for b in range(batch):
        chans = []
        for _ in range(3):
            kind = rng.integers(0, 3)
            if kind == 0:  # oriented grating
                freq = rng.uniform(6.0, 32.0)
                ang = rng.uniform(0.0, np.pi)
                ph = rng.uniform(0.0, 2 * np.pi)
                u = xx * np.cos(ang) + yy * np.sin(ang)
                ch = 127.5 + 127.5 * np.sin(2 * np.pi * u / freq + ph)
            elif kind == 1:  # rings around a random center
                cy, cx = rng.uniform(0, size, 2)
                rad = np.hypot(yy - cy, xx - cx)
                ch = 127.5 + 127.5 * np.sin(rad / rng.uniform(2.0, 8.0))
            else:  # hard-edged checker, random scale + offset
                s = rng.integers(5, 21)
                oy, ox = rng.integers(0, s, 2)
                ch = (((xx + ox) // s).astype(int)
                      + ((yy + oy) // s).astype(int)) % 2 * 255.0
            chans.append(ch)
        out[b] = np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)
    return out


def downscale_area(x: torch.Tensor, r: int) -> torch.Tensor:
    """Area (box) ×r downscale of an NHWC batch; H and W must be divisible
    by r."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"({h}, {w}) not divisible by scale {r}")
    xf = x.float()
    return xf.reshape(b, h // r, r, w // r, r, c).mean(dim=(2, 4)).to(x.dtype)
