"""Dense optical flow via Farneback polynomial expansion, and the filters
built on it: ``flow_warp``, ``flow_vis``, ``ema_smooth`` (port of
``dvf_tpu.ops.flow``).

Covers BASELINE.json configs[3]: "Farneback optical-flow warp filter,
720p, 2-frame temporal window" — the stateful filter family, whose
temporal window (the previous batch's last frame) stays on the device.

Algorithm (G. Farneback, "Two-frame motion estimation based on polynomial
expansion", SCIA 2003 — as cv2.calcOpticalFlowFarneback):

1. each gray frame is approximated per pixel by a quadratic polynomial,
   fitted by weighted least squares under a Gaussian window: six
   separable correlations sharing one padded input, then a fixed 6×6
   normal-equation inverse;
2. per iteration the candidate frame's polynomial stack is warped by the
   current flow, and a 2×2 system averaged over a window (Gaussian
   separable conv, or running-sum box) is solved in closed form;
3. coarse to fine over a pyramid, the flow upscaled between levels.

Everything is plain torch except the bounded warp
(``warp_impl``/``inner_warp="pallas"``), which is the hand-written CUDA
kernel ``kernels.warp_bounded_pallas`` on a card. The device state's
``initialized`` flag is a 0-d bool tensor selected with ``torch.where``:
nothing here reads a device value on the host, so a batch never waits
for the card.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dvf_tpu_torch.api.filter import Filter
from dvf_tpu_torch.ops.conv import box_filter, gaussian_kernel_1d, reflect_pad_nhwc, sep_conv2d
from dvf_tpu_torch.ops.registry import register_filter
from dvf_tpu_torch.utils.image import resize_linear, rgb_to_gray

WarpFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# bilinear sampling (the warp primitive)
# ---------------------------------------------------------------------------

def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (B,H,W,C) at float coords ``ys``/``xs`` (B,h,w).

    Out-of-range coordinates clamp to the border (cv2 BORDER_REPLICATE).
    Four flat gathers, then the lerp in x (top and bottom rows), then in
    y — the order the bounded-warp kernel repeats.
    """
    b, h, w, c = img.shape
    qshape = tuple(ys.shape)  # (B, qh, qw): the query grid may differ from img
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)

    flat = img.reshape(b, h * w, c)
    nq = qshape[1] * qshape[2]

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, nq, 1).expand(b, nq, c)
        return torch.gather(flat, 1, idx).reshape(qshape + (c,))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x1i)
    v10 = gather(y1i, x0i)
    v11 = gather(y1i, x1i)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def warp_by_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``img`` by ``flow`` (B,H,W,2; flow[...,0]=dx, [...,1]=dy):
    out(x) = img(x + flow(x)), the cv2.remap convention for Farneback flow.
    """
    b, h, w, _ = img.shape
    gy = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    gx = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    return bilinear_sample(img, gy + flow[..., 1], gx + flow[..., 0])


# ---------------------------------------------------------------------------
# polynomial expansion
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _poly_exp_setup(n: int, sigma: float):
    """Precompute (numpy) the 1-D moment kernels and the 6x6
    normal-equation inverse for basis [1, x, y, x², y², xy]."""
    xs = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    # 1-D moment kernels (correlation kernels, not flipped).
    k0, k1, k2 = g, xs * g, (xs ** 2) * g

    # G[i,j] = sum_{x,y} w(x,y) b_i(x,y) b_j(x,y), b = [1, x, y, x^2, y^2, xy]
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    wgt = np.outer(g, g)  # rows=y, cols=x
    basis = [np.ones_like(X), X, Y, X ** 2, Y ** 2, X * Y]
    G = np.zeros((6, 6))
    for i in range(6):
        for j in range(6):
            G[i, j] = np.sum(wgt * basis[i] * basis[j])
    Ginv = np.linalg.inv(G)
    return (
        np.asarray(k0, np.float32),
        np.asarray(k1, np.float32),
        np.asarray(k2, np.float32),
        np.asarray(Ginv, np.float32),
    )


@functools.lru_cache(maxsize=None)
def _ginv(n: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The 6x6 inverse as a tensor on ``device``: copied to a card once,
    not once per call."""
    return torch.from_numpy(_poly_exp_setup(n, sigma)[3]).to(device)


def poly_expansion(gray: torch.Tensor, n: int = 5, sigma: float = 1.1):
    """Quadratic polynomial coefficients per pixel.

    Args:
      gray: (B, H, W, 1) float frames.
    Returns:
      (A11, A12, A22, b1, b2): each (B, H, W, 1). A is the symmetric
      quadratic form, b the linear term, in (x, y) = (col, row) coordinates.
    """
    k0, k1, k2, _ = _poly_exp_setup(n, float(sigma))
    # The six correlations (b=1 -> k0⊗k0; x -> k0(y)k1(x); y -> k1(y)k0(x);
    # x² -> k0(y)k2(x); y² -> k2(y)k0(x); xy -> k1(y)k1(x)) share one
    # reflect pad and three vertical passes c0/c1/c2, then six horizontal
    # passes over those, taps accumulated in index order as in
    # sep_conv2d(impl="shift").
    h, w = gray.shape[1], gray.shape[2]
    x = reflect_pad_nhwc(gray, n, n)
    taps = 2 * n + 1
    xs = [x[:, i:i + h, :, :] for i in range(taps)]

    def vert(k):
        a = float(k[0]) * xs[0]
        for i in range(1, taps):
            a = a + float(k[i]) * xs[i]
        return a

    c0, c1, c2 = vert(k0), vert(k1), vert(k2)

    def horiz(a, k):
        o = float(k[0]) * a[:, :, :w, :]
        for j in range(1, taps):
            o = o + float(k[j]) * a[:, :, j:j + w, :]
        return o

    v1 = horiz(c0, k0)
    vx = horiz(c0, k1)
    vxx = horiz(c0, k2)
    vy = horiz(c1, k0)
    vxy = horiz(c1, k1)
    vyy = horiz(c2, k0)
    v = torch.stack([v1, vx, vy, vxx, vyy, vxy], dim=-1)  # (B,H,W,1,6)
    # r_j = sum_i Ginv[j, i] v_i, as an elementwise product and a sum (no
    # matmul, so TF32 settings cannot touch it).
    r = (v[..., None, :] * _ginv(n, float(sigma), gray.device)).sum(-1)
    b1 = r[..., 1]
    b2 = r[..., 2]
    A11 = r[..., 3]
    A22 = r[..., 4]
    A12 = r[..., 5] * 0.5
    return A11, A12, A22, b1, b2


# ---------------------------------------------------------------------------
# displacement estimation
# ---------------------------------------------------------------------------

def _flow_level(poly1: torch.Tensor, poly2: torch.Tensor, flow: torch.Tensor,
                smooth: Callable[[torch.Tensor], torch.Tensor], n_iters: int,
                warp_fn: WarpFn = warp_by_flow) -> torch.Tensor:
    """Refine ``flow`` at one pyramid level. poly*: stacked (B,H,W,5);
    ``smooth(x)``: the window average of the structure-tensor images;
    ``warp_fn(img, flow)``: how the candidate frame's poly stack is
    motion-compensated each iteration (gather, or the bounded kernel)."""
    A11_1, A12_1, A22_1, b1_1, b2_1 = [poly1[..., i:i + 1] for i in range(5)]

    for _ in range(n_iters):
        poly2w = warp_fn(poly2, flow)
        A11_2, A12_2, A22_2, b1_2, b2_2 = [poly2w[..., i:i + 1] for i in range(5)]
        A11 = 0.5 * (A11_1 + A11_2)
        A12 = 0.5 * (A12_1 + A12_2)
        A22 = 0.5 * (A22_1 + A22_2)
        fx = flow[..., 0:1]
        fy = flow[..., 1:2]
        db1 = -0.5 * (b1_2 - b1_1) + (A11 * fx + A12 * fy)
        db2 = -0.5 * (b2_2 - b2_1) + (A12 * fx + A22 * fy)

        # Per-pixel normal equations, averaged over the window.
        t11 = A11 * A11 + A12 * A12
        t12 = A12 * (A11 + A22)
        t22 = A12 * A12 + A22 * A22
        h1 = A11 * db1 + A12 * db2
        h2 = A12 * db1 + A22 * db2
        sm = smooth(torch.cat([t11, t12, t22, h1, h2], dim=-1))
        g11, g12, g22 = sm[..., 0:1], sm[..., 1:2], sm[..., 2:3]
        s1, s2 = sm[..., 3:4], sm[..., 4:5]
        # Tikhonov relative to the trace: structure-tensor entries are
        # O(1e-4), so an absolute clamp would swamp the determinant.
        lam = 1e-3 * (g11 + g22) + 1e-12
        g11r = g11 + lam
        g22r = g22 + lam
        det = g11r * g22r - g12 * g12
        fx_new = (g22r * s1 - g12 * s2) / det
        fy_new = (g11r * s2 - g12 * s1) / det
        flow = torch.cat([fx_new, fy_new], dim=-1)
    return flow


def _polys(gray: torch.Tensor, size: Tuple[int, int], poly_n: int,
           poly_sigma: float) -> torch.Tensor:
    """Resize ``gray`` to ``size`` and stack its five polynomial
    coefficient images (B, h, w, 5)."""
    return torch.cat(poly_expansion(resize_linear(gray, size), poly_n, poly_sigma),
                     dim=-1)


def farneback_flow(
    prev_gray: torch.Tensor,
    curr_gray: torch.Tensor,
    levels: int = 3,
    pyr_scale: float = 0.5,
    win_size: int = 15,
    n_iters: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.1,
    win_type: str = "gaussian",
    inner_warp="gather",
    inner_max_disp: int = 4,
) -> torch.Tensor:
    """Dense flow (B,H,W,2) mapping prev -> curr, cv2 convention.

    ``win_type``: "gaussian" (OPTFLOW_FARNEBACK_GAUSSIAN parity) or "box"
    (cv2's flags=0 window, running-sum smoothing)."""
    def polys_at(lh, lw):
        return (_polys(prev_gray, (lh, lw), poly_n, poly_sigma),
                _polys(curr_gray, (lh, lw), poly_n, poly_sigma))

    return _coarse_to_fine(polys_at, prev_gray.shape[0], prev_gray.shape[1],
                           prev_gray.shape[2], prev_gray, levels, pyr_scale,
                           win_size, n_iters, win_type,
                           _inner_warp_fn(inner_warp, inner_max_disp))


def farneback_flow_seq(
    gray_seq: torch.Tensor,
    levels: int = 3,
    pyr_scale: float = 0.5,
    win_size: int = 15,
    n_iters: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.1,
    win_type: str = "gaussian",
    inner_warp="gather",
    inner_max_disp: int = 4,
) -> torch.Tensor:
    """Flow for every consecutive pair of a frame sequence.

    ``gray_seq``: (B+1, H, W, 1) — frame i is "prev" of pair i and "curr"
    of pair i-1. The pyramid and polynomial expansion run once per unique
    frame (B+1 expansions instead of 2B) and the pair stacks are views.

    Returns (B, H, W, 2) flows mapping gray_seq[i] -> gray_seq[i+1].
    """
    def polys_at(lh, lw):
        poly_all = _polys(gray_seq, (lh, lw), poly_n, poly_sigma)
        return poly_all[:-1], poly_all[1:]

    return _coarse_to_fine(polys_at, gray_seq.shape[0] - 1, gray_seq.shape[1],
                           gray_seq.shape[2], gray_seq, levels, pyr_scale,
                           win_size, n_iters, win_type,
                           _inner_warp_fn(inner_warp, inner_max_disp))


def _inner_warp_fn(inner_warp, max_disp: int) -> WarpFn:
    """Resolve the per-iteration poly-warp implementation.

    "gather" — the exact bilinear sample (no displacement bound).
    "pallas" — the bounded-warp kernel (``kernels.warp_bounded_pallas``),
    which clips the TOTAL accumulated flow at every level and iteration to
    ±``max_disp`` estimation-grid px before sampling: faithful only while
    the true motion at the estimation grid stays within the bound, an
    approximation beyond it. A callable ``(img, flow) -> img`` is used as
    it is (a check can pass the kernel's plain version)."""
    if callable(inner_warp):
        return inner_warp
    if inner_warp == "gather":
        return warp_by_flow
    if inner_warp == "pallas":
        from dvf_tpu_torch.ops.kernels import warp_bounded_pallas

        return lambda img, f: warp_bounded_pallas(img, f, max_disp=max_disp)
    raise ValueError(
        f"inner_warp must be 'gather' or 'pallas', got {inner_warp!r}")


def _coarse_to_fine(polys_at, b: int, h: int, w: int, like: torch.Tensor,
                    levels: int, pyr_scale: float, win_size: int, n_iters: int,
                    win_type: str = "gaussian",
                    warp_fn: WarpFn = warp_by_flow) -> torch.Tensor:
    """Shared coarse-to-fine pyramid loop: ``polys_at(lh, lw)`` supplies
    the (poly1, poly2) pair stacks per level. ``like`` gives the flow's
    dtype and device."""
    if win_type == "gaussian":
        win_kern = gaussian_kernel_1d(win_size, win_size / 6.0)
        smooth = lambda x: sep_conv2d(x, win_kern, win_kern)  # noqa: E731
    elif win_type == "box":
        smooth = lambda x: box_filter(x, win_size)  # noqa: E731
    else:
        raise ValueError(
            f"win_type must be 'gaussian' or 'box', got {win_type!r}")
    shapes = []
    for lvl in range(levels):
        scale = pyr_scale ** lvl
        shapes.append((max(8, int(round(h * scale))), max(8, int(round(w * scale)))))

    flow = None
    for lvl in range(levels - 1, -1, -1):
        lh, lw = shapes[lvl]
        poly1, poly2 = polys_at(lh, lw)
        if flow is None:
            flow = torch.zeros((b, lh, lw, 2), dtype=like.dtype, device=like.device)
        else:
            ph, pw = shapes[lvl + 1]
            flow = resize_linear(flow, (lh, lw))
            # The reference multiplies by the float32 roundings of the two
            # scale factors.
            flow = torch.cat([flow[..., :1] * float(np.float32(lw / pw)),
                              flow[..., 1:] * float(np.float32(lh / ph))], dim=-1)
        flow = _flow_level(poly1, poly2, flow, smooth, n_iters, warp_fn)
    return flow


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def _window_state(batch_shape: Sequence[int], dtype: Any, device: torch.device):
    """The 2-frame temporal window: the previous batch's last frame and a
    device flag that a real one exists."""
    _, h, w, c = batch_shape
    return {
        "prev": torch.zeros((h, w, c), dtype=dtype, device=device),
        "initialized": torch.zeros((), dtype=torch.bool, device=device),
    }


def _next_window(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
    # The state owns its frame (a copy, not a view holding the whole batch).
    return {"prev": batch[-1].clone(),
            "initialized": torch.ones((), dtype=torch.bool, device=batch.device)}


@register_filter("flow_warp")
def flow_warp(
    levels: int = 3,
    win_size: int = 15,
    n_iters: int = 3,
    flow_scale: int = 2,
    warp_impl: Optional[str] = None,
    max_disp: int = 4,
    win_type: str = "gaussian",
    inner_warp: str = "gather",
) -> Filter:
    """Motion-compensate each previous frame onto the current one.

    Output = prev warped by the prev→curr flow. State = (last frame of the
    previous batch, initialized flag), both on the device; the first batch
    passes through. ``flow_scale``: flow is estimated at 1/flow_scale
    resolution and upsampled. ``win_type``: "gaussian" (default) or "box"
    (cv2's flags=0 window — another algorithm variant, not a numerics-
    identical swap).

    ``warp_impl``: "gather" = the exact bilinear sample
    (:func:`warp_by_flow`); "pallas" = the hand-written bounded-warp
    kernel (``kernels.warp_bounded_pallas``). ``None`` resolves to
    "pallas", the kernel, as the TPU's measured default does.

    NOTE "pallas" is an APPROXIMATION: it clips displacements to
    ±``max_disp`` px (after ``flow_scale`` upsampling, which multiplies
    magnitudes). At video rates Farneback flows are a few px and the clip
    is invisible; for faster motion pin ``warp_impl="gather"`` or raise
    ``max_disp``. ``inner_warp="pallas"`` applies the same kernel to the
    per-iteration poly warps, bounded at ceil(max_disp / flow_scale)
    estimation-grid px, so it carries the same full-resolution contract.
    """
    if warp_impl is None:
        warp_impl = "pallas"
    if warp_impl not in ("gather", "pallas"):
        raise ValueError(f"warp_impl must be 'gather' or 'pallas', got {warp_impl!r}")
    if win_type not in ("gaussian", "box"):
        raise ValueError(
            f"win_type must be 'gaussian' or 'box', got {win_type!r}")
    if inner_warp not in ("gather", "pallas"):
        raise ValueError(
            f"inner_warp must be 'gather' or 'pallas', got {inner_warp!r}")
    if win_type == "box" and win_size % 2 != 1:
        raise ValueError(
            f"win_size must be odd when win_type='box', got {win_size}")
    if warp_impl == "pallas":
        from dvf_tpu_torch.ops.kernels import warp_bounded_pallas

        def final_warp(img, flow):
            return warp_bounded_pallas(img, flow, max_disp=max_disp)
    else:
        final_warp = warp_by_flow
    inner_max_disp = max(1, -(-max_disp // max(1, flow_scale)))

    def fn(batch: torch.Tensor, state) -> Tuple[torch.Tensor, Any]:
        bsz, h, w, c = batch.shape
        # Sequence form: frame i is curr of pair i and prev of pair i+1, so
        # gray, downscale, pyramid and poly expansion run once per frame.
        seq = torch.cat([state["prev"][None], batch], dim=0)
        prev = seq[:-1]
        sg = rgb_to_gray(seq)
        if flow_scale > 1:
            sg = resize_linear(sg, (h // flow_scale, w // flow_scale))
        flow = farneback_flow_seq(
            sg, levels=levels, win_size=win_size, n_iters=n_iters,
            win_type=win_type, inner_warp=inner_warp,
            inner_max_disp=inner_max_disp)
        if flow_scale > 1:
            flow = resize_linear(flow, (h, w)) * float(flow_scale)
        warped = final_warp(prev, flow)
        # Until the first real previous frame exists, pass the input through.
        out = torch.where(state["initialized"], warped, batch)
        return out.to(batch.dtype), _next_window(batch)

    return Filter(
        name=(f"flow_warp(levels={levels},win={win_size},warp={warp_impl}"
              f"{',box' if win_type == 'box' else ''}"
              f"{',pallas-inner' if inner_warp == 'pallas' else ''})"),
        fn=fn,
        init_state=_window_state,
    )


def flow_to_rgb(flow: torch.Tensor, max_mag: float) -> torch.Tensor:
    """HSV colouring of a (B,H,W,2) flow with S=1: hue = direction, value
    = magnitude / max_mag clipped to [0, 1]. Returns (B,H,W,3)."""
    mag = torch.sqrt(torch.sum(flow * flow, dim=-1))
    ang = torch.atan2(flow[..., 1], flow[..., 0])   # [-pi, pi]
    hue = (ang + np.pi) / (2.0 * np.pi)             # [0, 1]
    val = torch.clamp(mag / max_mag, 0.0, 1.0)
    i = torch.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = torch.zeros_like(val)
    q = val * (1.0 - f)
    t = val * f
    sector = torch.remainder(i.to(torch.int32), 6)

    def select(*choices):
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(sector == k, choices[k], out)
        return out

    r = select(val, q, p, p, t, val)
    g = select(t, val, val, q, p, p)
    b = select(p, p, t, val, val, q)
    return torch.stack([r, g, b], dim=-1)


@register_filter("flow_vis")
def flow_vis(levels: int = 3, win_size: int = 15, n_iters: int = 3,
             max_mag: float = 8.0) -> Filter:
    """Visualize prev→curr flow as HSV (hue=direction, value=magnitude)."""

    def fn(batch: torch.Tensor, state) -> Tuple[torch.Tensor, Any]:
        seq = torch.cat([state["prev"][None], batch], dim=0)
        flow = farneback_flow_seq(rgb_to_gray(seq), levels=levels,
                                  win_size=win_size, n_iters=n_iters)
        return flow_to_rgb(flow, max_mag).to(batch.dtype), _next_window(batch)

    return Filter(name="flow_vis", fn=fn, init_state=_window_state)


@register_filter("ema_smooth")
def ema_smooth(alpha: float = 0.35) -> Filter:
    """Temporal exponential smoothing — motion trail / denoise.

    y_i = alpha·x_i + (1-alpha)·y_{i-1}, chained across batches through
    device state. A frame bit-identical to the one before it is a no-op
    (the recurrence's A=1, B=0), which makes the filter exactly pad-safe:
    the runtime pads short batches by repeating the last frame, and the
    carried state is independent of the pad count. The first frame ever
    seeds the average.

    The reference runs the recurrence as an associative scan over the
    batch; here it is a loop over the batch's frames, each step one
    multiply-add over a frame (its sums associate differently: the two
    agree to float32 rounding, ~1e-7).
    """
    if not 0.0 < alpha <= 1.0:
        raise ValueError("alpha must be in (0, 1]")
    a32 = float(np.float32(alpha))
    one_minus = float(np.float32(1.0) - np.float32(alpha))

    def init_state(batch_shape: Sequence[int], dtype: Any, device: torch.device):
        state = _window_state(batch_shape, dtype, device)
        state["ema"] = torch.zeros_like(state["prev"])
        return state

    def fn(batch: torch.Tensor, state) -> Tuple[torch.Tensor, Any]:
        init = state["initialized"]
        y = torch.where(init, state["ema"], batch[0])
        # Repeats (x_i == x_{i-1} bit for bit) are identities; the carried
        # "prev" extends the test across the batch boundary.
        same0 = torch.logical_and(init, torch.all(batch[0] == state["prev"]))
        same = torch.cat([same0[None],
                          (batch[1:] == batch[:-1]).flatten(1).all(dim=1)])
        A = torch.where(same, 1.0, one_minus).to(batch.dtype)
        Bs = torch.where(same[:, None, None, None], 0.0, a32 * batch).to(batch.dtype)
        ys = []
        for i in range(batch.shape[0]):
            y = A[i] * y + Bs[i]
            ys.append(y)
        out = torch.stack(ys)
        new_state = _next_window(batch)
        new_state["ema"] = ys[-1]
        return out.to(batch.dtype), new_state

    return Filter(name=f"ema_smooth(a={alpha})", fn=fn, init_state=init_state,
                  halo=0)
