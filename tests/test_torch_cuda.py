"""The hand-written CUDA kernels against their plain torch versions, on the
card. These need a CUDA device and skip without one.

This file imports neither jax nor the JAX package, so it also runs where
JAX is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest`` skips tests/conftest.py,
which sets JAX up).
"""

import numpy as np
import pytest
import torch

import dvf_tpu_torch
from dvf_tpu_torch.ops import flow as tflow
from dvf_tpu_torch.ops import kernels as tk
from dvf_tpu_torch.ops.conv import gaussian_kernel_1d

pytestmark = pytest.mark.cuda

SHAPES = [(2, 68, 40, 3), (2, 72, 130, 3), (1, 33, 17, 4)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _input(shape, seed, dev):
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return torch.from_numpy(x).to(dev)


def _launched(counter, fn):
    before = tk.LAUNCHES[counter]
    out = fn()
    torch.cuda.synchronize()
    assert tk.LAUNCHES[counter] == before + 1
    return out


# K1 and K2 also at frames larger than one of their tiles (64x64 and
# 32x32 outputs) with ragged right and bottom tiles, at every channel
# count. (1, 70, 130, 4) with 31 taps is K1's largest case: its 96 KB of
# shared memory needs the launch's opt-in above 48 KB.
STENCIL_SHAPES = SHAPES + [(1, 150, 270, 3), (2, 97, 131, 1), (1, 64, 130, 2),
                           (1, 70, 130, 4)]


def _view(x, offset):
    """x itself, or a contiguous copy of it that starts ``offset`` floats
    into its buffer (not 16-byte aligned for offset 1)."""
    if not offset:
        return x
    flat = torch.empty(x.numel() + offset, device=x.device)
    v = flat[offset:].view(x.shape)
    v.copy_(x)
    assert v.is_contiguous() and v.data_ptr() % 16
    return v


# (9,9), (3,9), (5,1): compiled tap pairs; (7,7), (31,31), (1,15): the
# runtime-tap instantiation.
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
@pytest.mark.parametrize("kh,kw", [(9, 9), (3, 9), (5, 1), (7, 7), (31, 31), (1, 15)])
def test_sep_blur_kernel_matches_plain(dev, shape, kh, kw, offset):
    x = _view(_input(shape, 1, dev), offset)
    th, tw = gaussian_kernel_1d(kh, 0.0), gaussian_kernel_1d(kw, 0.0)
    got = _launched("sep_blur", lambda: tk.sep_blur_nhwc_pallas(x, th, tw))
    want = tk.sep_blur_nhwc_pallas(x.cpu(), th, tw)
    assert (got.cpu() - want).abs().max().item() <= 1e-5


# d 3, 5, 7: compiled radii; d 9, 15, 1: the runtime-radius instantiation
# (d = 15 at C = 4 is K2's largest tile, 46x46 RGBA, 34 KB).
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
@pytest.mark.parametrize("d,sc,ss", [(5, 0.1, 2.0), (3, 0.2, 5.0), (7, 0.15, 3.0),
                                     (9, 0.1, 3.0), (15, 0.12, 4.0), (1, 0.1, 1.0)])
def test_bilateral_kernel_matches_plain(dev, shape, d, sc, ss, offset):
    x = _view(_input(shape, 2, dev), offset)
    got = _launched("bilateral", lambda: tk.bilateral_nhwc_pallas(
        x, d=d, sigma_color=sc, sigma_space=ss))
    want = tk.bilateral_nhwc_pallas(x.cpu(), d=d, sigma_color=sc, sigma_space=ss)
    assert (got.cpu() - want).abs().max().item() <= 1e-5


# K3 takes C = 3 or 4: every such shape above, tiles ragged (32x32
# outputs) and frames smaller than one. d 3, 5, 7: compiled radii; d 9, 1:
# the runtime-radius instantiation.
SOBEL_SHAPES = [s for s in STENCIL_SHAPES if s[-1] >= 3]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", SOBEL_SHAPES)
@pytest.mark.parametrize("d,scale", [(5, 1.0), (3, 2.5), (7, 1.0), (9, 1.5), (1, 1.0)])
def test_sobel_bilateral_kernel_matches_plain(dev, shape, d, scale, offset):
    x = _view(_input(shape, 3, dev), offset)
    got = _launched("sobel_bilateral", lambda: tk.sobel_bilateral_nhwc_pallas(
        x, d=d, magnitude_scale=scale))
    want = tk.sobel_bilateral_nhwc_pallas(x.cpu(), d=d, magnitude_scale=scale)
    assert (got.cpu() - want).abs().max().item() <= 1e-5


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = _input((1, 16, 24, 3), 4, dev)
    k = gaussian_kernel_1d(3, 0.0)
    with pytest.raises(TypeError):
        tk.bilateral_nhwc_pallas(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tk.bilateral_nhwc_pallas(x.transpose(1, 2))
    with pytest.raises(ValueError, match="NHWC"):
        tk.sep_blur_nhwc_pallas(x[0], k, k)
    with pytest.raises(ValueError, match="channels"):
        tk.sobel_bilateral_nhwc_pallas(x[..., :2].contiguous())
    with pytest.raises(ValueError, match="too small"):
        tk.sobel_bilateral_nhwc_pallas(_input((1, 3, 24, 3), 5, dev))
    # An instantiation that does not match the sizes, or was not compiled,
    # is refused by the C entry points, not substituted.
    lib, out = tk._lib(), torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    taps = tk._floats([0.25, 0.5, 0.25])
    for fixed in ((9, 9), (3, 3)):
        assert lib.dvf_sep_blur(x.data_ptr(), out.data_ptr(), 1, 16, 24, 3, taps, 3,
                                taps, 3, *fixed, stream) != 0
    for d, fixed_r in ((5, 1), (9, 4)):    # a mismatch; a radius not compiled
        log2w, nk = tk.bilateral_constants(d, 0.1, 2.0)
        assert lib.dvf_bilateral(x.data_ptr(), out.data_ptr(), 1, 16, 24, 3, d // 2,
                                 fixed_r, tk._floats(log2w), nk, stream) != 0
        log2w, nk = tk.sobel_bilateral_constants(d, 0.1, 2.0, 3)
        assert lib.dvf_sobel_bilateral(x.data_ptr(), out.data_ptr(), 1, 16, 24, 3,
                                       d // 2, fixed_r, tk._floats(log2w), nk, 1.0,
                                       stream) != 0


# offsets (image, flow), in floats: an image view not 16-byte aligned, a
# flow 8- but not 16-byte aligned. fits: the shared-memory window fits 48
# KB (every case up to C = 6 at R = 4); where it does not, "window" is
# refused without a launch and "auto" runs the direct gather, as it does on
# frames too small to give every SM two window blocks.
@pytest.mark.parametrize("design", ["auto", "window", "gather"])
@pytest.mark.parametrize("shape,scale,r,offsets,fits", [
    ((2, 68, 40, 3), 12.0, 4, (0, 0), True), ((2, 68, 40, 5), 12.0, 4, (0, 0), True),
    ((1, 33, 17, 1), 5.0, 2, (0, 0), True), ((4, 90, 160, 5), 4.0, 1, (0, 0), True),
    ((2, 37, 131, 3), 12.0, 4, (0, 0), True),     # W not a multiple of a tile or of 2 px
    ((1, 5, 9, 3), 6.0, 2, (0, 0), True),         # smaller than one tile
    ((3, 1, 3, 1), 6.0, 1, (0, 0), True),
    ((2, 45, 70, 1), 12.0, 4, (0, 0), True),      # C = 1
    ((1, 33, 65, 8), 12.0, 4, (0, 0), False),     # C = 8
    ((2, 50, 67, 3), 12.0, 4, (1, 2), True),
    ((2, 50, 67, 5), 6.0, 2, (1, 0), True),
    ((1, 40, 90, 3), 60.0, 12, (0, 0), True),     # R = 12: a 41-row window
    ((1, 40, 90, 3), 100.0, 20, (0, 0), False),   # R = 20
    ((4, 200, 330, 5), 6.0, 2, (0, 0), True),     # 312 window blocks: "auto" takes it
])
def test_warp_bounded_kernel_matches_plain(dev, shape, scale, r, offsets, fits, design):
    rng = np.random.default_rng(7)
    img = _view(torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev),
                offsets[0])
    flow = torch.from_numpy(((rng.random(shape[:3] + (2,)) - 0.5) * scale)
                            .astype(np.float32)).to(dev)
    if offsets[1]:
        flow = _view(flow, offsets[1])
    if design == "window" and not fits:
        before = tk.LAUNCHES["warp_bounded"]
        with pytest.raises(RuntimeError, match="launch failed"):
            tk.warp_bounded_pallas(img, flow, r, design)
        assert tk.LAUNCHES["warp_bounded"] == before
        return
    got = _launched("warp_bounded", lambda: tk.warp_bounded_pallas(img, flow, r, design))
    want = tk.warp_bounded_pallas(img.cpu(), flow.cpu(), r)
    # 3e-6 is the reference's bar; the kernels repeat the plain version's
    # operations and match it bit for bit on the card.
    assert (got.cpu() - want).abs().max().item() <= 3e-6
    assert torch.equal(got, tflow.warp_by_flow(img, flow.clamp(-r, r)))


def test_warp_bounded_refuses_without_launching(dev):
    img = _input((1, 16, 24, 3), 8, dev)
    flow = torch.zeros((1, 16, 24, 2), device=dev)
    before = tk.LAUNCHES["warp_bounded"]
    with pytest.raises(TypeError):
        tk.warp_bounded_pallas(img.double(), flow)
    with pytest.raises(ValueError, match="flow must be"):
        tk.warp_bounded_pallas(img, flow[:, :8].contiguous())   # too few rows
    with pytest.raises(ValueError, match="contiguous"):
        tk.warp_bounded_pallas(img.transpose(1, 2).contiguous().transpose(1, 2),
                               flow)
    with pytest.raises(ValueError, match="channels"):
        tk.warp_bounded_pallas(_input((1, 16, 24, 9), 9, dev), flow)
    with pytest.raises(ValueError, match="CUDA device"):
        tk.warp_bounded_pallas(img, flow.cpu())
    assert tk.LAUNCHES["warp_bounded"] == before


def test_flow_warp_state_stays_on_the_card(dev):
    """The stateful path never waits on the host: after a warm-up batch,
    a batch runs under CUDA's sync debug mode set to raise, the
    ``initialized`` flag and the previous frame stay device tensors, and
    the kernel launches once per batch (10 times with the inner warp)."""
    frames = np.random.default_rng(10).integers(0, 256, (4, 48, 64, 3), np.uint8)
    for kw, per_batch in [({}, 1), ({"inner_warp": "pallas"}, 10)]:
        filt = dvf_tpu_torch.get_filter("flow_warp", **kw)
        state = filt.init_state(frames.shape, torch.float32, dev)
        x = torch.from_numpy(frames).to(dev).float() / 255.0
        _, state = filt.fn(x, state)                         # warm-up
        torch.cuda.synchronize()
        before = tk.LAUNCHES["warp_bounded"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, state = filt.fn(x, state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert tk.LAUNCHES["warp_bounded"] == before + per_batch
        assert state["initialized"].device == dev == state["prev"].device
        assert state["initialized"].dim() == 0 and bool(state["initialized"])
        assert out.device == dev and torch.isfinite(out).all()


@pytest.mark.parametrize("shape,tile", [
    ((2, 68, 40, 3), 16), ((2, 68, 40, 1), 8), ((2, 64, 96, 4), 16),
    ((3, 67, 41, 3), 16), ((64, 96, 3), 32), ((2, 45, 77, 3), 8),
])
def test_tile_maxdiff_kernel_matches_plain(dev, shape, tile):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = a.copy()
    b[..., 3:9, 5:30, :] = rng.integers(0, 256, b[..., 3:9, 5:30, :].shape,
                                        dtype=np.uint8)
    b[..., -1, -1, :] ^= 1                    # the ragged corner tile too
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = _launched("tile_maxdiff", lambda: tk.tile_maxdiff_pallas(ta, tb, tile))
    want = tk.tile_maxdiff_ref(ta, tb, tile)
    assert got.shape == want.shape and torch.equal(got, want)
    # views one byte into the buffer are unaligned: byte-wide loads
    va = ta.reshape(-1)[1:1 + 4 * 96 * 3].view(1, 4, 96, 3)
    vb = tb.reshape(-1)[1:1 + 4 * 96 * 3].view(1, 4, 96, 3)
    assert va.is_contiguous() and va.data_ptr() % 4
    assert torch.equal(tk.tile_maxdiff_pallas(va, vb, tile),
                       tk.tile_maxdiff_ref(va, vb, tile))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(2, 52, 100), (1, 8, 8), (3, 48, 64), (50, 33)])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_dct8x8_quant_kernel_matches_plain(dev, dtype, shape, quality):
    rng = np.random.default_rng(12)
    plane = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8
             else rng.uniform(0, 255, shape).astype(np.float32))
    q = tk.jpeg_quant_table(quality, chroma=quality == 50)
    x = torch.from_numpy(plane).to(dev)
    got = _launched("dct8x8_quant", lambda: tk.dct8x8_quant_pallas(x, q))
    assert torch.equal(got, tk.dct8x8_quant_ref(x, q))      # plain, on the card
    assert torch.equal(got.cpu(), tk.dct8x8_quant_ref(x.cpu(), q))


def _planes(rng, shapes, dtype, dev, offset=0):
    out = []
    for s in shapes:
        p = (rng.integers(0, 256, s, dtype=np.uint8) if dtype == np.uint8
             else rng.uniform(0, 255, s).astype(np.float32))
        t = torch.from_numpy(p).to(dev)
        if offset:   # a contiguous view `offset` elements into its buffer
            flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
            t = flat[offset:].view(s).copy_(t)
        out.append(t)
    return out


def _wire_tables(quality, n=3):
    chroma = tk.jpeg_quant_table(quality, chroma=True)
    return [tk.jpeg_quant_table(quality)] + [chroma] * (n - 1)


# Y with Cb and Cr: ragged (edge blocks clamp), one block, more than one
# 32-block strip per block row.
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shapes", [((2, 52, 100), (2, 26, 50)), ((1, 8, 8), (1, 4, 4)),
                                    ((3, 40, 520), (3, 20, 260))])
@pytest.mark.parametrize("quality", [50, 90, 95, 100])
def test_dct8x8_quant_planes_kernel_matches_plain(dev, dtype, shapes, quality):
    xs = _planes(np.random.default_rng(13), (shapes[0], shapes[1], shapes[1]), dtype, dev)
    tables = _wire_tables(quality)
    got = _launched("dct8x8_quant", lambda: tk.dct8x8_quant_planes(xs, tables))
    for g, w, x, t in zip(got, tk.dct8x8_quant_planes_ref(xs, tables), xs, tables,
                          strict=True):
        assert torch.equal(g, w)                                # plain, on the card
        assert torch.equal(g.cpu(), tk.dct8x8_quant_ref(x.cpu(), t))


def test_dct8x8_quant_planes_kernel_other_counts_and_views(dev):
    """One and two planes, 2-D planes, and uint8 views not 8-byte aligned
    (their blocks load byte by byte): one launch each, bit-exact."""
    rng = np.random.default_rng(14)
    cases = [(((4, 64, 64),), 0), (((2, 48, 64), (2, 24, 32)), 0),
             (((56, 72), (28, 36), (28, 36)), 0), (((2, 48, 64), (2, 24, 32)), 1),
             (((2, 48, 64), (2, 24, 32), (2, 24, 32)), 3)]
    for shapes, offset in cases:
        xs = _planes(rng, shapes, np.uint8, dev, offset)
        tables = _wire_tables(90, len(xs))
        got = _launched("dct8x8_quant", lambda: tk.dct8x8_quant_planes(xs, tables))
        for g, w in zip(got, tk.dct8x8_quant_planes_ref(xs, tables), strict=True):
            assert torch.equal(g, w)


def test_codec_kernels_refuse_without_launching(dev):
    a = torch.zeros((2, 32, 32, 3), dtype=torch.uint8, device=dev)
    plane = torch.zeros((2, 32, 32), dtype=torch.uint8, device=dev)
    q = tk.jpeg_quant_table(90)
    qs = [q, q]
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        tk.dct8x8_quant_planes([plane, plane.cpu()], qs)
    with pytest.raises(ValueError, match="contiguous"):
        tk.dct8x8_quant_planes([plane, plane.transpose(1, 2)], qs)
    with pytest.raises(TypeError):
        tk.dct8x8_quant_planes([plane, plane.to(torch.int16)], qs)
    with pytest.raises(TypeError):
        tk.dct8x8_quant_planes([plane, plane.float()], qs)
    with pytest.raises(ValueError, match="batch size"):
        tk.dct8x8_quant_planes([plane, plane[:1]], qs)
    with pytest.raises(ValueError, match="planes"):
        tk.dct8x8_quant_planes([plane] * 4, [q] * 4)
    with pytest.raises(TypeError):
        tk.tile_maxdiff_pallas(a.float(), a.float())
    with pytest.raises(ValueError, match="contiguous"):
        tk.tile_maxdiff_pallas(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA device"):
        tk.tile_maxdiff_pallas(a, a.cpu())
    with pytest.raises(ValueError, match="one shape"):
        tk.tile_maxdiff_pallas(a, a[:1])
    with pytest.raises(TypeError):
        tk.dct8x8_quant_pallas(plane.to(torch.int16), q)
    with pytest.raises(ValueError, match="contiguous"):
        tk.dct8x8_quant_pallas(plane.transpose(1, 2), q)
    with pytest.raises(ValueError, match="plane"):
        tk.dct8x8_quant_pallas(a, q)
    assert tk.LAUNCHES == before


def test_engine_runs_the_kernels_on_cuda(dev):
    frames = np.random.default_rng(6).integers(0, 256, (4, 40, 56, 3), np.uint8)
    for name, counter in [("gaussian_blur", "sep_blur"),
                          ("bilateral", "bilateral"),
                          ("sobel_bilateral", "sobel_bilateral")]:
        eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name))
        assert eng.device == dev
        eng.compile(frames.shape)
        before = tk.LAUNCHES[counter]
        got = eng.submit(frames).fetch()
        assert tk.LAUNCHES[counter] == before + 1
        want = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name),
                                    device="cpu").submit(frames).fetch()
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
