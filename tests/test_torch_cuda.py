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


# --------------------------------------------------------- neural filters
# No hand kernel runs here (cuDNN convs, torch ops): these hold the card's
# output to the trained checkpoints' goldens and to the CPU.

GOLDEN = __import__("pathlib").Path(__file__).resolve().parent / "golden"


def _run_filter(filt, x, device):
    state = (filt.init_state(tuple(x.shape), torch.float32, device)
             if filt.stateful else None)
    with torch.no_grad():
        return filt.fn(x.to(device), state)[0]


def test_style_checkpoint_meets_golden_on_the_card(dev):
    """tests/test_style_demo.py's golden frame on the card, bf16, at the
    reference's bar (mean |Δ| < 2.0, max <= 30)."""
    import os

    from dvf_tpu_torch.train.checkpoint import CHECKPOINT_ROOT, load_style_filter

    filt = load_style_filter(os.path.join(CHECKPOINT_ROOT, "style_stripes_64"))
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(64, 64, n_frames=4)][:4]
    x = torch.from_numpy(np.stack(frames)).float() / 255.0
    out = _run_filter(filt, x, dev)
    assert out.device == dev
    got = (torch.clamp(out, 0, 1)[0].cpu().numpy() * 255).astype(np.uint8)
    diff = np.abs(got.astype(int) - np.load(GOLDEN / "style_demo_out.npy").astype(int))
    assert diff.mean() < 2.0 and diff.max() <= 30, (diff.mean(), diff.max())


def test_sr_checkpoint_meets_golden_on_the_card(dev):
    import os

    from dvf_tpu_torch.train.checkpoint import CHECKPOINT_ROOT, load_sr_filter
    from dvf_tpu_torch.train.sr import downscale_area, synthesize_structured_batch

    filt = load_sr_filter(os.path.join(CHECKPOINT_ROOT, "sr2x_64"))
    hr = torch.from_numpy(synthesize_structured_batch(
        np.random.default_rng(12345), 8, 80)).to(dev).float() / 255.0
    out = _run_filter(filt, downscale_area(hr, 2), dev)
    got = (torch.clamp(out, 0, 1)[0].cpu().numpy() * 255).astype(np.uint8)
    diff = np.abs(got.astype(int) - np.load(GOLDEN / "sr_demo_out.npy").astype(int))
    assert diff.mean() < 2.0 and diff.max() <= 30, (diff.mean(), diff.max())


@pytest.mark.parametrize("name,ckpt,kw", [
    ("style", "style_stripes_64", {}),
    ("style", "style_stripes_64", {"fast_convs": True}),
    ("sr", "sr2x_64", {}),
    ("sr", "sr2x_64", {"fast_convs": True}),
])
def test_float32_nets_on_the_card_match_the_cpu(dev, name, ckpt, kw):
    """dtype="float32" means float32 on the card too (no TF32): within 1e-4
    of the CPU, the reference's own f32 bar."""
    import os

    from dvf_tpu_torch.train import checkpoint as tc

    load = tc.load_style_filter if name == "style" else tc.load_sr_filter
    filt = load(os.path.join(tc.CHECKPOINT_ROOT, ckpt), dtype="float32", **kw)
    x = torch.from_numpy(np.random.default_rng(7).random((2, 48, 64, 3),
                                                         dtype=np.float32))
    torch.backends.cudnn.allow_tf32 = True   # the filter must turn it off itself
    try:
        got = _run_filter(filt, x, dev).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = _run_filter(filt, x, torch.device("cpu"))
    err = float((got - want).abs().max())
    assert err <= 1e-4, err


@pytest.mark.parametrize("name,cfg", [
    ("equalize", {}), ("equalize", {"on_gray": True}), ("clahe", {}),
    ("clahe", {"grid": 5, "clip_limit": 1.0}), ("canny", {}),
    ("upscale", {"scale": 2}),
])
def test_classical_ops_on_the_card_are_bit_exact(dev, name, cfg):
    """The card's bytes are the CPU's (which the CPU tests hold to the JAX
    package's) at a ragged geometry."""
    frames = np.random.default_rng(8).integers(0, 256, (3, 45, 71, 3), np.uint8)
    frames[:, 10:30, 20:50] //= 3           # structure for canny's edges
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **cfg))
    assert eng.device == dev
    got = eng.submit(frames).fetch()
    want = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **cfg),
                                device="cpu").submit(frames).fetch()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,cfg", [
    ("style_transfer", {"base_channels": 8, "n_residual": 2}),
    ("style_transfer", {"base_channels": 8, "n_residual": 2, "fast_convs": True,
                        "parallel": "pp"}),
    ("style_transfer", {"base_channels": 8, "n_residual": 2, "dtype": "float32"}),
    ("super_resolution", {}),
    ("super_resolution", {"fast_convs": True}),
    ("upscale", {"scale": 2}),
])
def test_neural_forward_never_waits_on_the_host(dev, name, cfg):
    """After a warm-up batch, the nets' forward runs under CUDA's sync
    debug mode set to raise: no index or constant crosses from the host,
    so the engine's host thread can run ahead of the card."""
    filt = dvf_tpu_torch.get_filter(name, **cfg)
    x = torch.rand((2, 36, 52, 3), device=dev)
    state = filt.init_state(tuple(x.shape), torch.float32, dev) if filt.stateful else None
    filt.fn(x, state)                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out, _ = filt.fn(x, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.device == dev and torch.isfinite(out).all()


# -- streamed ingest and egress on the card ----------------------------------


@pytest.mark.parametrize("name,kw", [("gaussian_blur", {"ksize": 9}),
                                     ("flow_warp", {})])
def test_streamed_dispatch_never_waits_on_the_host(dev, name, kw):
    """Stage → chunk copies on the H2D stream → submit_resident → D2H
    prefetch on the D2H stream runs under CUDA's sync debug mode set to
    raise: only the fetch waits, and it waits on events. The result
    equals a plain submit of the same frames."""
    from dvf_tpu_torch.runtime.egress import ShardedBatchFetcher
    from dvf_tpu_torch.runtime.ingest import ShardedBatchAssembler

    shape = (4, 72, 130, 3)
    frames = np.random.default_rng(11).integers(0, 256, (2,) + shape, np.uint8)
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), device=dev)
    ref = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), device=dev)
    eng.compile(shape)
    asm = ShardedBatchAssembler(shape, np.uint8, dev, depth=3, slots=2,
                                stream=eng.h2d_stream)
    fetcher = ShardedBatchFetcher(eng.out_shape, eng.out_dtype, dev, slots=2,
                                  stream=eng.d2h_stream)
    assert asm.effective_mode == fetcher.effective_mode == "streamed"
    for seq in range(2):
        want = ref.submit(frames[seq]).fetch().copy()
        b = asm.begin(seq)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for row in range(shape[0]):
                b.write_row(row, frames[seq][row])
            batch, resident = b.finish(shape[0])
            res = eng.submit_resident(batch, ready=b.ready)
            fetcher.prefetch(res, seq)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert resident and batch.device == dev
        got = fetcher.fetch(res, seq)
        assert fetcher.owns(got)
        np.testing.assert_array_equal(got, want)


def _card_pipeline(dev, name, kw, mode, n, shape, **cfg):
    got = {}
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter(name, **kw), device=dev)
    stats = dvf_tpu_torch.Pipeline(
        dvf_tpu_torch.SyntheticSource(*shape[1:], n_frames=n, seed=5), eng.filter,
        dvf_tpu_torch.CallbackSink(lambda i, f, _: got.__setitem__(i, f.copy())),
        dvf_tpu_torch.PipelineConfig(batch_size=shape[0], queue_size=n + 1,
                                     ingest=mode, egress=mode, **cfg),
        engine=eng).run()
    assert stats["delivered"] == n and sorted(got) == list(range(n))
    return got, stats


def test_slot_reuse_and_record_stream_at_a_full_window(dev, monkeypatch):
    """max_inflight 2 with frame_delay 8: the staging, device and slab
    slots wrap while the reorder buffer still holds rows and the card is
    still busy (bilateral at 360p keeps it so): a copy that read freed or
    rewritten memory would show as wrong bytes. The dispatch thread
    submits and the collect thread fetches, so the copy streams must be
    linked to the compute stream by events, not by whichever stream is
    current in the other thread. Streamed equals monolithic byte for
    byte, and both stay within 1 LSB of the CPU."""
    from dvf_tpu_torch.runtime import egress as egress_mod
    from dvf_tpu_torch.runtime import ingest as ingest_mod

    monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 0.0)
    shape, n = (4, 360, 640, 3), 40
    runs = {}
    for mode in ("streamed", "monolithic"):
        runs[mode], stats = _card_pipeline(dev, "bilateral", {}, mode, n, shape,
                                           max_inflight=2, frame_delay=8,
                                           ingest_depth=2, assemble_timeout_s=60.0)
        assert stats["ingest"]["mode"] == stats["egress"]["mode"] == mode
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(*shape[1:], n_frames=n,
                                                          seed=5)][:-1]
    cpu = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("bilateral"), device="cpu")
    for s in (0, n - shape[0]):
        want = cpu.submit(np.stack(frames[s:s + shape[0]])).fetch()
        for j in range(shape[0]):
            d = np.abs(runs["streamed"][s + j].astype(np.int16) - want[j].astype(np.int16))
            assert d.max() <= 1
    for i in range(n):
        np.testing.assert_array_equal(runs["streamed"][i], runs["monolithic"][i])


def test_streamed_equals_monolithic_at_a_ragged_batch(dev, monkeypatch):
    """A stream that is no multiple of the batch at an odd geometry: the
    padded last batch, the chunks of unequal rows and both fetch paths."""
    from dvf_tpu_torch.runtime import egress as egress_mod
    from dvf_tpu_torch.runtime import ingest as ingest_mod

    monkeypatch.setattr(ingest_mod, "MIN_STREAM_H2D_MS", 0.0)
    monkeypatch.setattr(egress_mod, "MIN_STREAM_D2H_MS", 0.0)
    shape, n = (5, 37, 53, 3), 23
    for name, kw in [("invert", {}), ("sobel_bilateral", {}), ("identity", {})]:
        runs = {m: _card_pipeline(dev, name, kw, m, n, shape, ingest_depth=3)[0]
                for m in ("streamed", "monolithic")}
        for i in range(n):
            np.testing.assert_array_equal(runs["streamed"][i], runs["monolithic"][i])
        if name != "sobel_bilateral":
            frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(
                *shape[1:], n_frames=n, seed=5)][:-1]
            for i, f in enumerate(frames):
                np.testing.assert_array_equal(runs["streamed"][i],
                                              255 - f if name == "invert" else f)


def test_engine_entries_on_the_card(dev):
    """submit_resident equals submit byte for byte; run_probe equals
    submit and refuses flow_warp; out_uint8=False is the float output;
    compile sets the three calibrations; a fetcher handed a batch it did
    not prefetch (one rebuilt between submit and collect) copies it
    then."""
    from dvf_tpu_torch.runtime.egress import ShardedBatchFetcher

    shape = (4, 64, 96, 3)
    x = np.random.default_rng(12).integers(0, 256, shape, np.uint8)
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("gaussian_blur", ksize=9),
                               device=dev)
    want = eng.submit(x).fetch().copy()
    assert None not in (eng.h2d_block_ms, eng.d2h_block_ms, eng.step_block_ms)
    res = eng.submit_resident(torch.from_numpy(x).to(dev))
    np.testing.assert_array_equal(res.device.cpu().numpy(), want)
    np.testing.assert_array_equal(eng.run_probe(x), want)
    fetcher = ShardedBatchFetcher(eng.out_shape, eng.out_dtype, dev, slots=2,
                                  stream=eng.d2h_stream)
    got = fetcher.fetch(eng.submit(x, fetch=False), 1)
    assert fetcher.owns(got)
    np.testing.assert_array_equal(got, want)
    flow = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("flow_warp"), device=dev)
    flow.compile(shape)
    with pytest.raises(ValueError, match="stateful"):
        flow.run_probe(x)
    f32 = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("gaussian_blur", ksize=9),
                               device=dev, out_uint8=False)
    got = f32.submit(x).fetch()
    plain = tk.sep_blur_nhwc_pallas(torch.from_numpy(x).to(dev).float() / 255.0,
                                    gaussian_kernel_1d(9, 0.0), gaussian_kernel_1d(9, 0.0))
    assert got.dtype == np.float32
    assert np.abs(got - plain.cpu().numpy()).max() <= 1e-5


def test_serve_runs_the_kernels_and_a_resize_swap_on_the_card(dev):
    """Two signatures through ServeFrontend on cuda:0 — gaussian_blur(9)
    (K1) and sobel_bilateral (K3) — with one resize hot swap mid-stream:
    every frame within 1 LSB of the plain version of its own input, both
    kernels launched once per batch, no pool engine live after stop()."""
    import time

    from dvf_tpu_torch.ops.conv import sep_conv2d
    from dvf_tpu_torch.runtime.engine import live_pool_engines
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    shape, n = (48, 72, 3), 24
    rng = np.random.default_rng(3)
    k9 = gaussian_kernel_1d(9, 0.0)
    chain = dvf_tpu_torch.get_filter("sobel_bilateral", impl="chain")
    plain = {"gaussian_blur(ksize=9)": lambda x: sep_conv2d(x, k9, k9, impl="shift"),
             "sobel_bilateral": lambda x: chain.fn(x, None)[0]}
    fe = dvf_tpu_torch.ServeFrontend(
        dvf_tpu_torch.get_filter("invert"),
        dvf_tpu_torch.ServeConfig(batch_size=4, queue_size=64, out_queue_size=64,
                                  slo_ms=600_000.0))
    frames, got = {}, {}
    with fe:
        sids = {c: fe.open_stream(op_chain=c, frame_shape=shape) for c in plain}
        engines = {c: fe._session(s).bucket.engine for c, s in sids.items()}
        b0 = {c: e.stats.batches for c, e in engines.items()}
        tk.reset_launches()
        for c, s in sids.items():
            frames[c] = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
            got[c] = []
        label = fe._session(sids["sobel_bilateral"]).bucket.label()
        deadline = time.time() + 60.0
        for j in range(n):
            for c, s in sids.items():
                fe.submit(s, frames[c][j])
            if j == n // 3:
                assert fe.request_batch_size(label, 2, reason="card test")
            time.sleep(0.002)
        while any(len(v) < n for v in got.values()) or fe.swaps < 1:
            assert time.time() < deadline, (fe.stats()["swaps"], fe.health())
            for c, s in sids.items():
                got[c].extend(fe.poll(s))
            time.sleep(0.002)
        launches = dict(tk.LAUNCHES)
        batches = {c: e.stats.batches - b0[c] for c, e in engines.items()}
    assert fe.swaps == 1 and fe.swap_aborts == 0
    assert launches["sep_blur"] == batches["gaussian_blur(ksize=9)"] > 0
    # the swap's successor compile launched K3 twice: its warm-up step and
    # its step calibration
    assert launches["sobel_bilateral"] == batches["sobel_bilateral"] + 2
    assert batches["sobel_bilateral"] > 0
    for c, fn in plain.items():
        assert [d.index for d in got[c]] == list(range(n))
        x = to_float(torch.from_numpy(np.stack(frames[c])).to(dev))
        want = to_uint8(fn(x)).cpu().numpy().astype(np.int16)
        diff = np.abs(np.stack([d.frame for d in got[c]]).astype(np.int16) - want)
        assert diff.max() <= 1, (c, int(diff.max()))
    assert live_pool_engines() == []


def test_compile_waits_only_on_its_own_work(dev):
    """A compile beside busy serving (the default stream held by a long
    kernel) finishes without waiting for that work: its warm-up and
    calibrations run on the compile stream and wait on events there."""
    import time

    busy = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("invert"))
    busy.compile((2, 32, 32, 3))     # the pinned buffers of this size exist
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(4_000_000_000)  # ~2 s of the default stream at ~2 GHz
    eng = dvf_tpu_torch.Engine(dvf_tpu_torch.get_filter("invert"))
    eng.compile((2, 32, 32, 3))
    t_compile = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_busy = time.perf_counter() - t0
    assert t_busy > 0.5, t_busy       # the stream really was held
    assert t_compile < t_busy / 2, (t_compile, t_busy)



def test_shadow_replay_launches_k3_once_on_the_planes_own_stream(dev):
    """One shadow replay of a sobel_bilateral frame launches K3 exactly
    once, on the audit plane's own non-default stream (never the legacy
    default stream every engine stream would synchronize with), and its
    golden agrees with the plain version on the CPU within the plane's
    tolerance."""
    import dataclasses

    from dvf_tpu_torch.obs.audit import AuditPlane, golden_execute

    filt = dvf_tpu_torch.get_filter("sobel_bilateral")
    streams = []

    def spy(x, state):
        streams.append(torch.cuda.current_stream(x.device))
        return filt.fn(x, state)

    spied = dataclasses.replace(filt, fn=spy)
    frame = np.random.default_rng(11).integers(0, 256, (72, 96, 3),
                                               dtype=np.uint8)
    delivered = golden_execute(filt, frame)          # the plain version
    plane = AuditPlane(sample_every=1).start()
    try:
        tk.reset_launches()
        plane.submit_replay(spied, frame, delivered, session="s",
                            index=0, bucket="b", device=dev)
        assert plane.drain(60.0)
    finally:
        plane.stop()
    assert tk.LAUNCHES["sobel_bilateral"] == 1
    assert plane.replays_ok == 1 and plane.replay_errors == 0
    own = plane.stream(dev)
    assert streams == [own]
    assert own != torch.cuda.default_stream(dev)
    assert own != torch.cuda.current_stream(dev)


def test_lineage_device_mark_waits_on_the_batch_event(dev, monkeypatch):
    """The collect thread takes each batch's ``device`` mark after a wait
    on that batch's own compute event (BatchResult.compute_event), never
    a device-wide synchronize; the mark comes out non-zero and within a
    few step times of the bucket's calibration."""
    import time

    from dvf_tpu_torch.runtime import engine as engine_mod
    from dvf_tpu_torch.serve import server as server_mod

    waited, syncs = [], []
    real_wait = engine_mod.wait_compute

    def spy_wait(result):
        waited.append(result.compute_event)
        return real_wait(result)

    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(server_mod, "wait_compute", spy_wait)
    fe = dvf_tpu_torch.ServeFrontend(
        dvf_tpu_torch.get_filter("invert"),
        dvf_tpu_torch.ServeConfig(batch_size=4, queue_size=64,
                                  slo_ms=600_000.0, lineage=True,
                                  max_inflight=2))
    shape, n = (240, 320, 3), 32
    got = []
    with fe:
        sid = fe.open_stream(op_chain="sobel_bilateral", frame_shape=shape)
        step_ms = fe._session(sid).bucket.engine.step_block_ms
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a, **k: syncs.append(1) or real_sync(*a, **k))
        rng = np.random.default_rng(2)
        for _ in range(n):
            fe.submit(sid, rng.integers(0, 256, shape, dtype=np.uint8))
        deadline = time.time() + 60.0
        while len(got) < n:
            assert time.time() < deadline
            got += fe.poll(sid)
            time.sleep(0.002)
        monkeypatch.setattr(torch.cuda, "synchronize", real_sync)
    assert syncs == []
    assert waited and all(isinstance(ev, torch.cuda.Event) for ev in waited)
    device_ms = [d.lineage.components_ms()["device"] for d in got]
    for d in got:
        assert sum(d.lineage.components_ms().values()) == pytest.approx(
            d.latency_ms, abs=1e-6)
    assert min(device_ms) > 0
    # A batch's device span can hold the batches queued ahead of it on
    # the compute stream (max_inflight) besides its own.
    assert float(np.median(device_ms)) < (2 + 2) * step_ms + 5.0, (
        device_ms, step_ms)


def test_audited_serving_launches_k3_per_batch_and_per_replay(dev):
    """An audited sobel_bilateral bucket: K3 launches once per serving
    batch plus once per sampled replay; no replay mismatches."""
    import time

    fe = dvf_tpu_torch.ServeFrontend(
        dvf_tpu_torch.get_filter("invert"),
        dvf_tpu_torch.ServeConfig(batch_size=4, queue_size=64,
                                  slo_ms=600_000.0, audit=True,
                                  audit_sample_every=3))
    shape, n = (64, 96, 3), 24
    got = []
    with fe:
        sid = fe.open_stream(op_chain="sobel_bilateral", frame_shape=shape)
        eng = fe._session(sid).bucket.engine
        b0 = eng.stats.batches
        tk.reset_launches()
        rng = np.random.default_rng(5)
        for _ in range(n):
            fe.submit(sid, rng.integers(0, 256, shape, dtype=np.uint8))
        deadline = time.time() + 60.0
        while len(got) < n:
            assert time.time() < deadline
            got += fe.poll(sid)
            time.sleep(0.002)
        assert fe.audit.drain(60.0)
        st = fe.stats()["audit"]
        batches = eng.stats.batches - b0
        launches = tk.LAUNCHES["sobel_bilateral"]
    assert st["replays_sampled_total"] == n // 3
    assert st["replays_ok_total"] == n // 3
    assert launches == batches + n // 3


def test_quality_downshift_on_the_card_matches_the_plain_program(dev):
    """A sobel_bilateral session on cuda:0 with the control plane armed
    (its controllers idle: manual actuation): frames before a downshift
    and after the recovery within 1 LSB of the plain full program, the
    downshifted ones within 1 LSB of the plain frame[::2, ::2] ->
    sobel_bilateral -> nearest x2, every delivery full size; the
    downshift program, warmed at admission, serves at half size with
    K3 launched once per batch of each bucket."""
    import time

    from dvf_tpu_torch.control import ControlConfig
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    shape, per = (64, 96, 3), 8
    chain = dvf_tpu_torch.get_filter("sobel_bilateral", impl="chain")
    fe = dvf_tpu_torch.ServeFrontend(
        dvf_tpu_torch.get_filter("invert"),
        dvf_tpu_torch.ServeConfig(
            batch_size=4, queue_size=64, out_queue_size=64,
            slo_ms=600_000.0, control=True,
            control_config=ControlConfig(interval_s=3600.0)))
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8)
              for _ in range(3 * per)]
    got = []
    with fe:
        sid = fe.open_stream(op_chain="sobel_bilateral", frame_shape=shape)
        deadline = time.time() + 60.0
        while len(fe.pool) < 2:   # the x2 program's admission warm-up
            assert time.time() < deadline
            time.sleep(0.01)
        tk.reset_launches()
        for k, level in enumerate((0, 1, 0)):
            if level != fe._session(sid).quality_level:
                assert fe.request_session_quality(sid, level)
                while fe._session(sid).quality_level != level:
                    assert time.time() < deadline
                    time.sleep(0.002)
            for f in frames[k * per:(k + 1) * per]:
                fe.submit(sid, f)
            while len(got) < (k + 1) * per:
                assert time.time() < deadline
                got += fe.poll(sid)
                time.sleep(0.002)
        launches = tk.LAUNCHES["sobel_bilateral"]
        batches = sum(b.engine.stats.batches for b in fe._buckets
                      if b.op_chain and b.op_chain.startswith(
                          "sobel_bilateral"))
        labels = sorted(fe.stats()["buckets"])
    assert fe.quality_rebinds == 2
    assert "sobel_bilateral|upscale(scale=2)|32x48x3|uint8" in labels
    assert launches == batches > 0
    assert [d.index for d in got] == list(range(3 * per))
    x = torch.from_numpy(np.stack(frames)).to(dev)
    full = to_uint8(chain.fn(to_float(x), None)[0]).cpu().numpy()
    half = to_uint8(chain.fn(to_float(x[:, ::2, ::2].contiguous()),
                             None)[0]).cpu().numpy()
    down = half.repeat(2, axis=1).repeat(2, axis=2)
    for i, d in enumerate(got):
        assert d.frame.shape == shape
        want = down[i] if per <= i < 2 * per else full[i]
        diff = np.abs(d.frame.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, (i, int(diff.max()))


def test_meshless_fingerprint_equals_the_engines_and_names_the_card(dev):
    from dvf_tpu_torch.control import plan_cache

    name = torch.cuda.get_device_name(0)
    meshless = plan_cache.topology_fingerprint()
    fe = dvf_tpu_torch.ServeFrontend(dvf_tpu_torch.get_filter("invert"),
                                     dvf_tpu_torch.ServeConfig(batch_size=2))
    try:
        assert fe._topology_fingerprint() == meshless
        assert plan_cache.topology_fingerprint(fe.engine.device) == meshless
    finally:
        fe.pool.close()
        fe.engine.free()
    assert meshless.startswith(f"torch-cuda/{name}/n{torch.cuda.device_count()}/")
    assert f"cuda={torch.version.cuda}" in meshless
    assert plan_cache.topology_fingerprint("cpu") != meshless


def test_local_fleet_runs_the_kernels_on_the_card(dev):
    """A 2-replica local fleet on cuda:0 (both replicas share the card,
    each with its own engines): sobel_bilateral (K3) and gaussian_blur(9)
    (K1) sessions placed on both replicas (each precompiled both), every
    frame in order and within 1 LSB of the plain version of its own
    input, K1 and K3 launched by the serving batches, and one kernel
    launch per replica by a divergence check."""
    import time

    from dvf_tpu_torch.fleet import FleetConfig, FleetFrontend
    from dvf_tpu_torch.ops.conv import sep_conv2d
    from dvf_tpu_torch.runtime.engine import live_pool_engines
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    shape, n = (48, 72, 3), 12
    rng = np.random.default_rng(5)
    k9 = gaussian_kernel_1d(9, 0.0)
    chain = dvf_tpu_torch.get_filter("sobel_bilateral", impl="chain")
    plain = {"gaussian_blur(ksize=9)": lambda x: sep_conv2d(x, k9, k9, impl="shift"),
             "sobel_bilateral": lambda x: chain.fn(x, None)[0]}
    fleet = FleetFrontend(
        dvf_tpu_torch.get_filter("invert"),
        FleetConfig(replicas=2, mode="local", serve=dvf_tpu_torch.ServeConfig(
            batch_size=4, queue_size=64, out_queue_size=64, slo_ms=600_000.0),
            precompile=[{"op_chain": c, "frame_shape": list(shape)}
                        for c in plain]))
    assert fleet.device == dev
    frames, got, sids = {}, {}, {}
    with fleet:
        for c in plain:
            for k in range(2):
                sid = fleet.open_stream(op_chain=c, frame_shape=shape)
                sids[sid] = c
                frames[sid] = [rng.integers(0, 256, shape, dtype=np.uint8)
                               for _ in range(n)]
                got[sid] = []
        placed = {fleet.stats()["sessions"][s]["replica"] for s in sids}
        tk.reset_launches()
        for j in range(n):
            for s in sids:
                fleet.submit(s, frames[s][j])
        deadline = time.time() + 120.0
        while any(len(v) < n for v in got.values()):
            assert time.time() < deadline, fleet.stats()["replicas"]
            for s in sids:
                got[s].extend(fleet.poll(s))
            time.sleep(0.002)
        served = dict(tk.LAUNCHES)
        # the health monitor learns both replicas' warm signatures
        while fleet._audit_signature() is None:
            assert time.time() < deadline, fleet._warm
            time.sleep(0.01)
        tk.reset_launches()
        ev = fleet.audit_divergence_check()
        probes = dict(tk.LAUNCHES)
    assert placed == {"r0", "r1"}
    assert served["sobel_bilateral"] > 0 and served["sep_blur"] > 0
    assert ev["verdict"] == "match" and ev["replicas_probed"] == 2, ev
    assert probes["sobel_bilateral"] + probes["sep_blur"] == 2, probes
    for s, c in sids.items():
        assert [d.index for d in got[s]] == list(range(n))
        x = to_float(torch.from_numpy(np.stack(frames[s])).to(dev))
        want = to_uint8(plain[c](x)).cpu().numpy().astype(np.int16)
        diff = np.abs(np.stack([d.frame for d in got[s]]).astype(np.int16) - want)
        assert diff.max() <= 1, (c, int(diff.max()))
    assert live_pool_engines() == []


# -- the command line (python -m dvf_tpu_torch) on the card -----------------


@pytest.mark.parametrize("name,counter,cfg", [
    ("sobel_bilateral", "sobel_bilateral", None),
    ("gaussian_blur", "sep_blur", '{"ksize": 9}'),
])
def test_cli_serve_launches_the_kernel_once_per_batch(dev, monkeypatch, capsys,
                                                      name, counter, cfg):
    """``serve`` with no --platform runs on cuda:0: the kernel launched
    once per device batch besides its compile's warm-up and calibration
    launches, no other kernel, and every frame the display sink composes
    in order and within 1 LSB of the plain version."""
    import json
    import os

    from dvf_tpu_torch import cli
    from dvf_tpu_torch.io import display
    from dvf_tpu_torch.ops.conv import sep_conv2d
    from dvf_tpu_torch.runtime import engine as em
    from dvf_tpu_torch.utils.image import to_float, to_uint8

    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    assert cli._force_platform() == "cuda:0"
    h, w, b, n = 48, 72, 4, 16
    flt = ["--filter", name] + (["--filter-config", cfg] if cfg else [])
    k9 = gaussian_kernel_1d(9, 0.0)
    chain = dvf_tpu_torch.get_filter("sobel_bilateral", impl="chain")
    plain = (lambda x: sep_conv2d(x, k9, k9, impl="shift")) if cfg else \
        (lambda x: chain.fn(x, None)[0])
    probe = em.Engine(cli._parse_filter_arg(name, cfg), device=dev)
    tk.reset_launches()
    probe.compile((b, h, w, 3))
    per_compile = tk.LAUNCHES[counter]
    probe.free()
    compiles, devices, got = [], [], []
    real_compile, real_emit = em.Engine.compile, display.SideBySideSink.emit

    def compile_(eng, *a, **k):
        compiles.append(1)
        devices.append(eng.device)
        return real_compile(eng, *a, **k)

    def emit(sink, index, processed, ts):
        got.append((index, np.array(processed)))
        return real_emit(sink, index, processed, ts)

    monkeypatch.setattr(em.Engine, "compile", compile_)
    monkeypatch.setattr(display.SideBySideSink, "emit", emit)
    tk.reset_launches()
    rc = cli.main(["serve", *flt, "--height", str(h), "--width", str(w),
                   "--batch", str(b), "--frames", str(n), "--frame-delay", "0",
                   "--queue-size", str(n + 1), "--quiet", "--display",
                   "--headless"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["delivered"] == n
    assert set(devices) == {torch.device("cuda", 0)}
    want = {k: 0 for k in tk.LAUNCHES}
    want[counter] = stats["engine_batches"] + per_compile * len(compiles)
    assert dict(tk.LAUNCHES) == want
    frames = [f for f, _ in dvf_tpu_torch.SyntheticSource(h, w, n_frames=n)][:-1]
    x = to_float(torch.from_numpy(np.stack(frames)).to(dev))
    ref = to_uint8(plain(x)).cpu().numpy().astype(np.int16)
    assert [i for i, _ in got] == list(range(n))
    diff = np.abs(np.stack([f for _, f in got]).astype(np.int16) - ref)
    assert diff.max() <= 1
    assert os.environ.get("DVF_FORCE_PLATFORM") is None


def test_cli_compile_cache_dir_builds_then_loads(dev, tmp_path):
    """``serve --compile-cache-dir DIR`` in a fresh process builds every
    kernel library into DIR; a second process on DIR loads them with 0.0
    s of build."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = tmp_path / "kernels"
    builds = []
    for _ in range(2):
        r = subprocess.run(
            [sys.executable, "-m", "dvf_tpu_torch", "serve", "--filter",
             "sobel_bilateral", "--height", "32", "--width", "32", "--frames",
             "8", "--batch", "4", "--frame-delay", "0", "--queue-size", "9",
             "--quiet", "--compile-cache-dir", str(cache)],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        line = [ln for ln in r.stderr.splitlines() if "kernel builds (s): " in ln][-1]
        builds.append(json.loads(line.split("kernel builds (s): ", 1)[1]))
    names = {"stencils", "warp", "codec"}
    assert set(builds[0]) == names and all(v > 0 for v in builds[0].values())
    assert builds[1] == {k: 0.0 for k in names}
    assert {p.name.split("-")[0][3:] for p in cache.glob("lib*.so")} >= names


# -- training on the card ------------------------------------------------------


def _train_config(name, dtype):
    from dvf_tpu_torch.models import EspcnConfig, StyleNetConfig
    from dvf_tpu_torch.models.vgg import VGGConfig
    from dvf_tpu_torch.train import sr as tsr
    from dvf_tpu_torch.train import style as tst

    if name == "style":
        return tst.StyleTrainConfig(
            net=StyleNetConfig(base_channels=8, n_residual=2, compute_dtype=dtype),
            vgg=VGGConfig(compute_dtype=dtype))
    return tsr.SrTrainConfig(net=EspcnConfig(compute_dtype=dtype))


def _train_family(name, dtype, device):
    """(state, step, batch) of one family at a small float32 (or bf16)
    size, its weights from seed 0 (drawn on the CPU: the same on every
    device)."""
    from dvf_tpu_torch.train import sr as tsr
    from dvf_tpu_torch.train import style as tst

    rng = np.random.default_rng(3)
    cfg = _train_config(name, dtype)
    if name == "style":
        state = tst.init_train_state(0, rng.random((1, 48, 48, 3), dtype=np.float32),
                                     cfg, device=device)
        return state, tst.make_train_step(None, cfg, state_template=state), \
            torch.from_numpy(rng.random((2, 48, 64, 3), dtype=np.float32))
    state = tsr.init_train_state(0, cfg, device=device)
    return state, tsr.make_train_step(None, cfg, state_template=state), \
        torch.from_numpy(rng.random((2, 48, 64, 3), dtype=np.float32))


# Conv biases an instance norm follows: exact gradient zero, rounding noise.
# So are the residual norms' biases: a per-channel constant on the trunk
# reaches only convs an instance norm follows.
_PRE_NORM = {"stem/b", "down1/b", "down2/b", "res0_a/b", "res0_b/b", "res0_bn/bias",
             "res1_a/b", "res1_b/b", "res1_bn/bias", "up1/b", "up2/b"}


@pytest.mark.parametrize("family", ["style", "sr"])
def test_float32_train_step_on_the_card_matches_the_cpu(dev, family):
    """One float32 step from the same state and batch on the card and on
    the CPU, with cuDNN's TF32 switched on globally (the step must turn it
    off for forward AND backward): the loss within 1e-5 relative, every
    gradient leaf within 1e-4 of its largest element (TF32 errs ~1e-3),
    the pre-norm biases' zero gradients below 1e-5 of the largest."""
    from dvf_tpu_torch.train import optim

    states = {}
    torch.backends.cudnn.allow_tf32 = True
    try:
        for where in (dev, torch.device("cpu")):
            state, step, batch = _train_family(family, torch.float32, where)
            state, m = step(state, batch)
            states[where.type] = (state, {k: float(v) for k, v in m.items()})
    finally:
        torch.backends.cudnn.allow_tf32 = False
    (card, mc), (cpu, mp) = states["cuda"], states["cpu"]
    assert abs(mc["loss"] - mp["loss"]) <= 1e-5 * abs(mp["loss"])
    grads = {k: (v.grad.cpu(), optim.flatten(cpu.params)[k].grad)
             for k, v in optim.flatten(card.params).items()}
    big = max(float(b.abs().max()) for _, b in grads.values())
    for k, (a, b) in grads.items():
        if k in _PRE_NORM:
            assert float(a.abs().max()) <= 1e-5 * big and float(b.abs().max()) <= 1e-5 * big
        else:
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), k
    assert card.step.device == dev and int(card.step) == 1


@pytest.mark.parametrize("family", ["style", "sr"])
def test_train_step_never_waits_on_the_host(dev, family):
    """After a warm-up step, steps run under CUDA's sync debug mode set to
    raise: the batch copy, forward, backward and Adam update are queued
    without the host waiting (metrics stay on the card)."""
    state, step, batch = _train_family(family, torch.bfloat16, dev)
    pinned = batch.pin_memory()
    state, _ = step(state, pinned.to(dev, non_blocking=True))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, m = step(state, pinned.to(dev, non_blocking=True))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.device == dev for v in m.values())
    assert int(state.step) == 3 and np.isfinite(float(m["loss"]))


def test_train_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """Save a card state, restore it onto a card template from another
    seed: bitwise, on the card; the next steps of both agree."""
    from dvf_tpu_torch.train import checkpoint as tc
    from dvf_tpu_torch.train import optim

    state, step, batch = _train_family("style", torch.bfloat16, dev)
    state, _ = step(state, batch)
    path = tc.save_checkpoint(str(tmp_path / "final"), state)
    template, _, _ = _train_family("style", torch.bfloat16, dev)
    restored = tc.restore_checkpoint(path, template)
    assert int(restored.step) == 1 and restored.step.device == dev
    for k, v in optim.flatten(state.params).items():
        got = optim.flatten(restored.params)[k]
        assert got.device == dev and torch.equal(got, v), k
    for g, h in zip(state.style_grams, restored.style_grams):
        assert torch.equal(g, h)


def test_cli_train_runs_on_cuda0_by_default(dev, tmp_path, monkeypatch, capsys):
    """``train`` / ``train-sr`` with no --platform run on cuda:0 and write
    checkpoints the serving loaders read."""
    import json

    from dvf_tpu_torch import cli
    from dvf_tpu_torch.train.checkpoint import load_sr_filter

    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    ck = str(tmp_path / "sr")
    assert cli.main(["train-sr", "--steps", "3", "--batch", "2", "--size", "32",
                     "--checkpoint-dir", ck, "--checkpoint-every", "2", "--eval"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 3 and np.isfinite(out["held_out"]["delta_db"])
    filt = load_sr_filter(ck)
    assert filt.stateful
    assert cli.main(["train", "--steps", "2", "--batch", "2", "--size", "32",
                     "--base-channels", "8", "--n-residual", "1"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 2


# ---------------------------------------------------------------------------
# The bench harness on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw,counter", [
    ("gaussian_blur", {"ksize": 9}, "sep_blur"),
    ("sobel_bilateral", {}, "sobel_bilateral"),
    ("flow_warp", {}, "warp_bounded"),
    ("super_resolution", {"scale": 2}, None),
])
def test_bench_device_resident_on_the_card(dev, name, kw, counter):
    """The device-resident chain launches the filter's kernel once per
    batch (warm-up and timed) beside its compile's, and its H100 shares
    stay at or below 1."""
    from dvf_tpu_torch.benchmarks import bench_device_resident, roofline_fields

    tk.reset_launches()
    r = bench_device_resident(dvf_tpu_torch.get_filter(name, **kw), iters=3,
                              batch_size=2, height=64, width=96)
    assert r["frames"] == 6 and r["fps"] > 0
    if counter is not None:
        assert tk.LAUNCHES[counter] >= 4   # 1 warm-up + 3 timed, + compile's
    out = roofline_fields(r, "cuda")
    assert 0 <= out["hbm_roofline_frac"] <= 1.0 and 0 <= out["mfu"] <= 1.0


def test_bench_transfer_on_the_card_times_pinned_memory(dev):
    from dvf_tpu_torch.benchmarks import bench_transfer

    r = bench_transfer(2, 64, 96)
    assert r["host_memory"] == "pinned"
    assert r["h2d_mbps"] > 0 and r["d2h_mbps"] > 0 and np.isfinite(r["d2h_mbps"])


def test_cli_bench_on_cuda0_by_default(dev, monkeypatch, capsys):
    import json

    from dvf_tpu_torch import cli

    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    monkeypatch.setitem(cli.BENCH_CONFIGS, "gauss9_1080p",
                        dict(filter=("gaussian_blur", {"ksize": 9}), h=64, w=96,
                             batch=2))
    assert cli.main(["bench", "--config", "gauss9_1080p", "--iters", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["value"] > 0 and 0 <= out["hbm_roofline_frac"] <= 1.0
    assert out["mfu_peak_tflops"] == 67.0


# ------------------------------------------- the in-host mesh on the card


@pytest.mark.parametrize("name,kw,counter", [
    ("gaussian_blur", {"ksize": 9}, "sep_blur"),
    ("bilateral", {}, "bilateral"),
    ("sobel_bilateral", {}, "sobel_bilateral"),
])
def test_stencils_over_a_virtual_mesh_equal_one_device(dev, name, kw, counter):
    """K1–K3 over a data=2, space=4 mesh of cuda:0 eight times: every
    block runs its kernel on its halo-extended slab, once per block per
    batch, and the output equals the unsharded engine's bit for bit."""
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from dvf_tpu_torch.runtime.engine import Engine

    x = np.random.default_rng(0).integers(0, 255, (4, 96, 80, 3), np.uint8)
    one = Engine(dvf_tpu_torch.get_filter(name, **kw), device=dev)
    eng = Engine(dvf_tpu_torch.get_filter(name, **kw),
                 mesh=make_mesh(MeshConfig(data=2, space=4), devices=[dev] * 8))
    want = one.submit(x).fetch().copy()
    eng.compile(x.shape, np.uint8)
    before = tk.LAUNCHES[counter]
    got = eng.submit(x).fetch().copy()
    assert tk.LAUNCHES[counter] == before + 8
    np.testing.assert_array_equal(got, want)


def test_wrapper_refuses_a_b_and_h_sharded_view(dev):
    """A view of a batch cut on both B and H is not contiguous: the
    wrapper raises rather than copy it or fall back."""
    x = torch.rand((4, 32, 16, 3), device=dev)
    block = x[:2, 8:16]
    assert not block.is_contiguous()
    taps = gaussian_kernel_1d(5, 0.0)
    for call in (lambda: tk.sep_blur_nhwc_pallas(block, taps, taps),
                 lambda: tk.bilateral_nhwc_pallas(block),
                 lambda: tk.sobel_bilateral_nhwc_pallas(block)):
        before = dict(tk.LAUNCHES)
        with pytest.raises(ValueError, match="contiguous"):
            call()
        assert tk.LAUNCHES == before


# --------------------------------- the multi-process runtime on the card


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 2, "space": 2}],
                         ids=["data=2", "data=2,space=2"])
def test_codec_assist_per_block_equals_the_whole_batch(dev, axes):
    """The probe and the fused transform over a ShardedBatch of cuda:0
    (a virtual mesh): bitmaps and coefficient blocks equal the whole
    batch's across two batches, K5 and K6 once per block per batch."""
    from dvf_tpu_torch.parallel.mesh import MeshConfig, batch_sharding, make_mesh
    from dvf_tpu_torch.parallel.sharded import shard_batch
    from dvf_tpu_torch.runtime.codec_assist import DeviceDeltaProbe, FusedDeltaTransform

    m = make_mesh(MeshConfig(**axes), devices=[dev] * (2 * axes.get("space", 1)))
    shape = (8, 128, 96, 3)
    rng = np.random.default_rng(3)
    pw, pm = DeviceDeltaProbe(32), DeviceDeltaProbe(32)
    fw, fm = FusedDeltaTransform(32), FusedDeltaTransform(32)
    for _ in range(2):
        x = torch.from_numpy(rng.integers(0, 255, shape, np.uint8)).to(dev)
        x[:, :64] = 7
        sb = shard_batch(x, batch_sharding(m, shape))
        want_bm, (want_fbm, want_f) = pw.bitmaps(x), fw.process(x)
        before = dict(tk.LAUNCHES)
        got_bm, (got_fbm, got_f) = pm.bitmaps(sb), fm.process(sb)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["tile_maxdiff"] - before["tile_maxdiff"] == 2 * m.size
        assert tk.LAUNCHES["dct8x8_quant"] - before["dct8x8_quant"] == m.size
        np.testing.assert_array_equal(got_bm, want_bm)
        np.testing.assert_array_equal(got_fbm, want_fbm)
        for a, b in zip(got_f, want_f):
            for p, q in ((a.yq, b.yq), (a.cbq, b.cbq), (a.crq, b.crq)):
                assert torch.equal(p, q)


def test_multihost_engine_in_one_process_equals_the_engine(dev):
    """MultiHostEngine in one process (no group) over a data=2 mesh of
    cuda:0: every row is local, the rows run through the single-card
    engine's step (K1 once per batch) and equal ``Engine`` bit for bit."""
    from dvf_tpu_torch.fleet import MultiHostEngine
    from dvf_tpu_torch.parallel.mesh import MeshConfig
    from dvf_tpu_torch.runtime.engine import Engine

    filt = dvf_tpu_torch.get_filter("gaussian_blur", ksize=9)
    x = np.random.default_rng(1).integers(0, 255, (4, 96, 80, 3), np.uint8)
    want = Engine(filt, device=dev).submit(x).fetch().copy()
    eng = MultiHostEngine(filt, MeshConfig(data=2), devices=[dev] * 2)
    eng.compile(x.shape)
    assert eng.local_batch_size == 4 and eng.device == dev
    got = _launched("sep_blur", lambda: eng.submit_local(x))
    np.testing.assert_array_equal(got, want)


# --------------------------------------- the sharded train state on the card


def _sharded_family(name, dtype, dev, axes):
    """(one-device state, step; the same state placed on a virtual mesh of
    ``dev``, its step; the batch): ``_train_family`` at batch 4."""
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from dvf_tpu_torch.train import sr as tsr
    from dvf_tpu_torch.train import style as tst

    state, step, batch = _train_family(name, dtype, dev)
    mod, cfg = (tst if name == "style" else tsr), _train_config(name, dtype)
    mcfg = MeshConfig(**axes)
    mesh = make_mesh(mcfg, devices=[dev] * mcfg.n_devices)
    placed = mod.shard_train_state(state, mesh, cfg)
    return (state, step, placed, mod.make_train_step(mesh, cfg, state_template=placed),
            torch.cat([batch, batch.flip(1)]).to(dev))


@pytest.mark.parametrize("family,axes", [
    ("style", {"model": 2}), ("style", {"data": 2}),
    ("sr", {"model": 2}), ("sr", {"data": 2})],
    ids=["style-model=2", "style-data=2", "sr-model=2", "sr-data=2"])
def test_sharded_train_step_on_a_virtual_mesh_is_the_one_device_step(dev, family, axes):
    """float32 on ``[cuda:0] * 2``: the sharded step's loss within 1e-5
    relative of the one-device step's and every gradient leaf (the
    masters' summed gradients) within 1e-4 of its largest element, the
    pre-norm biases' zero gradients below 1e-5 of the largest."""
    from dvf_tpu_torch.train import optim

    state, step, placed, mstep, batch = _sharded_family(family, torch.float32, dev, axes)
    _, m1 = step(state, batch)
    _, m2 = mstep(placed, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5 * abs(float(m1["loss"]))
    one = {k: v.grad for k, v in optim.flatten(state.params).items()}
    got = placed.params.assemble(lambda t: t.grad)
    big = max(float(g.abs().max()) for g in one.values())
    for k, g in one.items():
        if k in _PRE_NORM:
            assert float(g.abs().max()) <= 1e-5 * big and float(got[k].abs().max()) <= 1e-5 * big
        else:
            assert float((got[k] - g).abs().max()) <= 1e-4 * float(g.abs().max()), k
    assert int(placed.step) == 1 and placed.step.device == dev


@pytest.mark.parametrize("family", ["style", "sr"])
def test_sharded_train_step_never_waits_on_the_host(dev, family):
    """After a warm-up step, sharded steps on ``data=2, model=2`` of the
    card run under CUDA's sync debug mode set to raise: the batch cut,
    the ranks' lockstep, the collectives, the copies' gradient sums and
    Adam are queued without the host waiting."""
    _, _, placed, mstep, batch = _sharded_family(family, torch.bfloat16, dev,
                                                 {"data": 2, "model": 2})
    placed, _ = mstep(placed, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            placed, m = mstep(placed, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.device == dev for v in m.values())
    assert int(placed.step) == 3 and np.isfinite(float(m["loss"]))


def test_dryrun_multichip_on_the_card(dev):
    """``dryrun_multichip(8)`` with no device: the attached cards, or a
    virtual mesh of cuda:0 eight times; every sub-check passes, K3 runs
    in the halo and pipeline checks and K4 in the flow check."""
    from dvf_tpu_torch.dryrun import dryrun_devices, dryrun_multichip, entry

    assert dryrun_devices(8)[0] == dev
    rows = {r["label"]: r for r in dryrun_multichip(8)}
    assert rows["engine-halo(sobel_bilateral)"]["launches"].get("sobel_bilateral", 0) >= 9
    assert rows["engine-pipeline(Pipeline.run)"]["launches"].get("sobel_bilateral", 0) > 0
    assert rows["engine-flow(flow_warp)"]["launches"].get("warp_bounded", 0) > 0
    assert np.isfinite(rows["train-step"]["loss"])
    fn, args = entry()
    assert fn(*args).shape == args[1].shape
