"""Histogram equalization and CLAHE (port of ``dvf_tpu.ops.histogram``).

The per-plane (or per-tile) 256-bin histogram is one ``torch.bincount``
over ``plane * 256 + value`` (on a card, an atomic scatter-add: the
reference sorts and binary-searches because a TPU has no fast scatter).
The counts are exact integers, carried as float32 as in the reference,
and every LUT step after them follows the reference's float32 operations
in its order (``_lut_apply``, ``_clahe_luts``), so the result is
bit-exact. On a mesh with a ``space`` axis, ``equalize`` specialises to
the global-reduction pattern: each block counts its rows, the counts of
one frame's blocks are summed (exact integers), and each block maps its
rows through the whole-frame LUT.
"""

from __future__ import annotations

from typing import Callable

import torch

from dvf_tpu_torch.api.filter import Filter, stateless
from dvf_tpu_torch.ops.registry import register_filter
from dvf_tpu_torch.utils.image import rgb_to_gray, to_float, to_uint8


def _plane_hist(flat: torch.Tensor) -> torch.Tensor:
    """(B, P) integer pixels in [0, 256) → (B, 256) float32 counts."""
    b = flat.shape[0]
    keys = flat.long() + 256 * torch.arange(b, device=flat.device)[:, None]
    return torch.bincount(keys.reshape(-1), minlength=256 * b).reshape(b, 256).float()


def _lut_apply(hist: torch.Tensor, flat: torch.Tensor, n: int) -> torch.Tensor:
    """cv2.equalizeHist's exact LUT from (B, 256) counts over ``n`` pixels
    per plane, gathered back onto the (B, P) pixels → uint8."""
    cdf = hist.cumsum(dim=1)
    # lut[v] = round((cdf[v] - cdf_min) / (N - cdf_min) * 255), cdf_min =
    # the cdf at the lowest occupied bin; a constant plane (N == cdf_min)
    # keeps its values.
    nf = hist.new_full((), float(n))
    cdf_min = torch.where(hist > 0, cdf, nf + 1.0).amin(dim=1, keepdim=True)
    denom = nf - cdf_min
    # (a Python number over a tensor is a reciprocal and a multiply in
    # torch, not one division: divide tensors, here and below)
    scale = torch.where(denom > 0,
                        torch.full_like(denom, 255.0) / torch.clamp(denom, min=1.0),
                        torch.zeros_like(denom))
    lut = torch.round((cdf - cdf_min) * scale)
    ident = torch.arange(256, dtype=torch.float32, device=hist.device)[None]
    lut = torch.where(denom > 0, lut, ident)
    lut = torch.clamp(lut, 0.0, 255.0).to(torch.uint8)   # (B, 256)
    return torch.gather(lut, 1, flat.long())


def _equalize_u8_plane(plane_u8: torch.Tensor) -> torch.Tensor:
    """Equalize uint8 planes (B, H, W), vectorized over the batch."""
    b, h, w = plane_u8.shape
    flat = plane_u8.reshape(b, h * w)
    return _lut_apply(_plane_hist(flat), flat, h * w).reshape(b, h, w)


def _planes_of(x_u8: torch.Tensor, on_gray: bool) -> torch.Tensor:
    """The (N, H, W) uint8 planes the histogram family works on: the luma
    (``on_gray``, the cv2 golden mode), or the channels folded into the
    batch axis."""
    if on_gray:
        gray = (x_u8 if x_u8.shape[-1] == 1
                else to_uint8(rgb_to_gray(to_float(x_u8))))
        return gray[..., 0]
    b, h, w, c = x_u8.shape
    return x_u8.permute(0, 3, 1, 2).reshape(b * c, h, w)


def _from_planes(planes: torch.Tensor, x_u8: torch.Tensor, on_gray: bool) -> torch.Tensor:
    """Back from :func:`_planes_of`'s layout (the luma broadcast)."""
    if on_gray:
        return planes[..., None].expand(x_u8.shape)
    b, h, w, c = x_u8.shape
    return planes.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _dispatch_planes(x_u8: torch.Tensor, on_gray: bool,
                     apply_planes: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``on_gray`` runs ``apply_planes`` on the luma and broadcasts it (the
    cv2 golden mode); otherwise the channels fold into the batch axis."""
    return _from_planes(apply_planes(_planes_of(x_u8, on_gray)), x_u8, on_gray)


@register_filter("equalize")
def equalize(on_gray: bool = False) -> Filter:
    """Global histogram equalization: each RGB channel on its own
    (default), or ``on_gray=True``: ``cv2.equalizeHist`` on the luma,
    broadcast to the channels."""

    def fn(batch: torch.Tensor) -> torch.Tensor:
        u8 = batch.dtype == torch.uint8
        out = _dispatch_planes(to_uint8(batch), on_gray, _equalize_u8_plane)
        return out if u8 else to_float(out, batch.dtype)

    def specialize(mesh, batch_shape):
        """Spatial sharding the global-reduction way: each block counts
        the pixels of its H-slice (counts are additive), the counts of a
        frame's blocks are summed once, and every block maps its rows
        through the whole-frame LUT: 256 floats per plane cross between
        devices, no pixel does."""
        from dvf_tpu_torch.parallel.mesh import NamedSharding, P
        from dvf_tpu_torch.parallel.sharded import (ShardedBatch, as_sharded,
                                                    finish)

        d, sp = mesh.axis_size("data"), mesh.axis_size("space")
        b, h = batch_shape[0], batch_shape[1]
        if sp <= 1 or h % sp != 0:
            return None  # engine default: replicate H (correct, unsharded)
        # H-sharding only needs h % space == 0; an indivisible batch just
        # degrades the batch axis.
        sharding = NamedSharding(
            mesh, P("data" if b % d == 0 else None, "space", None, None))

        def sharded_fn(batch, state):
            sb, whole = as_sharded(batch, sharding)
            out = [None] * len(sb.shards)
            for ring in sb.grid():
                xs = [to_uint8(sb.shards[i]) for i in ring]
                planes = [_planes_of(x, on_gray) for x in xs]
                flats = [p.reshape(p.shape[0], -1) for p in planes]
                home = xs[0].device
                total = None
                for f in flats:
                    hk = _plane_hist(f).to(home, non_blocking=True)
                    total = hk if total is None else total + hk
                n_total = h * planes[0].shape[2]
                for i, x, p, f in zip(ring, xs, planes, flats):
                    eq = _lut_apply(total.to(x.device, non_blocking=True), f,
                                    n_total).reshape(p.shape)
                    y = _from_planes(eq, x, on_gray).contiguous()
                    src = sb.shards[i]
                    out[i] = y if src.dtype == torch.uint8 else to_float(y, src.dtype)
            res = ShardedBatch(out, sharding, sb.shape)
            return finish(res, whole, batch), state

        return Filter(
            name=f"space(equalize(gray={on_gray}))",
            fn=sharded_fn,
            uint8_ok=True,
            # halo=0: this body owns its spatial distribution (the summed
            # counts); the engine must not route it through the halo
            # machinery or replicate H.
            halo=0,
            sharding=sharding,
        )

    return stateless(f"equalize(gray={on_gray})", fn, uint8_ok=True, halo=None,
                     specialize=specialize)


# ---------------------------------------------------------------------------
# CLAHE — contrast-limited ADAPTIVE histogram equalization
# ---------------------------------------------------------------------------


def _clahe_luts(tiles_flat: torch.Tensor, tile_area: int,
                clip_abs: int) -> torch.Tensor:
    """(T, P) tile pixels → (T, 256) uint8 CLAHE LUTs, as cv2.CLAHE: clip
    each histogram at ``clip_abs``, redistribute the excess the way cv2
    does (a uniform share, then a strided residual), then the scaled
    cumulative LUT."""
    hist = _plane_hist(tiles_flat)                     # (T, 256)
    excess = torch.clamp(hist - clip_abs, min=0.0).sum(dim=1, keepdim=True)
    hist = torch.clamp(hist, max=float(clip_abs))
    batch_add = torch.floor(excess / 256.0)
    residual = excess - batch_add * 256.0              # (T, 1), 0..255
    hist = hist + batch_add
    # cv2's residual pass: step = max(256 // residual, 1); bins 0, step,
    # 2*step, ... each get +1 until the residual runs out.
    step = torch.clamp(torch.floor(torch.full_like(residual, 256.0)
                                   / torch.clamp(residual, min=1.0)), min=1.0)
    idx = torch.arange(256, dtype=torch.float32, device=hist.device)[None, :]
    gets_one = ((torch.remainder(idx, step) == 0.0)
                & (torch.floor(idx / step) < residual)
                & (residual > 0.0))
    hist = hist + gets_one.float()
    lut = torch.round(hist.cumsum(dim=1) * (255.0 / tile_area))
    return torch.clamp(lut, 0.0, 255.0).to(torch.uint8)


def _reflect_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Extend ``dim`` of ``x`` to ``size`` by reflect-101 at its end."""
    n = x.shape[dim]
    if size == n:
        return x
    i = torch.arange(size, device=x.device)
    return x.index_select(dim, torch.where(i > n - 1, 2 * (n - 1) - i, i))


@register_filter("clahe")
def clahe(clip_limit: float = 2.0, grid: int = 8,
          on_gray: bool = False) -> Filter:
    """Contrast-Limited Adaptive Histogram Equalization (cv2.createCLAHE
    semantics): a ``grid``×``grid`` lattice of tile histograms, each
    clipped at ``clip_limit``×(uniform level), the excess redistributed,
    and the four neighbouring tile LUTs interpolated bilinearly at every
    pixel. Geometries that the grid does not divide are reflect-padded at
    the right and bottom and cropped. ``on_gray`` as in ``equalize``."""
    if grid < 1:
        raise ValueError(f"grid must be >= 1, got {grid}")
    if clip_limit <= 0:
        raise ValueError(f"clip_limit must be > 0, got {clip_limit}")

    def apply_planes(planes: torch.Tensor) -> torch.Tensor:
        """(N, H, W) uint8 planes → CLAHE'd uint8 planes."""
        n, h, w = planes.shape
        hp = -(-h // grid) * grid
        wp = -(-w // grid) * grid
        u = _reflect_to(_reflect_to(planes, 1, hp), 2, wp).long()
        th, tw = hp // grid, wp // grid
        tile_area = th * tw
        clip_abs = max(1, int(clip_limit * tile_area / 256.0))
        tiles = u.reshape(n, grid, th, grid, tw).permute(0, 1, 3, 2, 4)
        luts = _clahe_luts(tiles.reshape(n * grid * grid, tile_area),
                           tile_area, clip_abs).reshape(-1)

        # cv2's interpolation lattice: tile-space coordinate of a pixel
        # centre is (p / tile) - 0.5; corners floor/ceil, clamped.
        def corners(size, tile):
            # (a tensor over a Python number is a multiply by its
            # reciprocal on a card, not one division: divide tensors)
            pos = torch.arange(size, dtype=torch.float32, device=u.device)
            f = pos / torch.full_like(pos, tile) - 0.5
            lo = torch.floor(f)
            frac = f - lo
            lo_i = lo.long()
            return (torch.clamp(lo_i, 0, grid - 1), torch.clamp(lo_i + 1, 0, grid - 1),
                    frac)

        ty0, ty1, fy = corners(hp, th)
        tx0, tx1, fx = corners(wp, tw)
        base = torch.arange(n, device=u.device)[:, None, None] * (grid * grid * 256) + u

        def look(ty, tx):
            # LUT of tile (ty[y], tx[x]) at value u, for every pixel
            off = (ty[:, None] * grid + tx[None, :]) * 256
            return luts[base + off].float()

        fy_ = fy[None, :, None]
        fx_ = fx[None, None, :]
        out = ((1 - fy_) * (1 - fx_) * look(ty0, tx0)
               + (1 - fy_) * fx_ * look(ty0, tx1)
               + fy_ * (1 - fx_) * look(ty1, tx0)
               + fy_ * fx_ * look(ty1, tx1))
        out = torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)
        return out[:, :h, :w]

    def fn(batch: torch.Tensor) -> torch.Tensor:
        u8 = batch.dtype == torch.uint8
        out = _dispatch_planes(to_uint8(batch), on_gray, apply_planes)
        return out if u8 else to_float(out, batch.dtype)

    return stateless(f"clahe(c={clip_limit},g={grid})", fn, uint8_ok=True,
                     halo=None)
