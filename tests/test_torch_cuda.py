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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kh,kw", [(9, 9), (3, 9), (5, 1)])
def test_sep_blur_kernel_matches_plain(dev, shape, kh, kw):
    x = _input(shape, 1, dev)
    th, tw = gaussian_kernel_1d(kh, 0.0), gaussian_kernel_1d(kw, 0.0)
    got = _launched("sep_blur", lambda: tk.sep_blur_nhwc_pallas(x, th, tw))
    want = tk.sep_blur_nhwc_pallas(x.cpu(), th, tw)
    assert (got.cpu() - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d,sc,ss", [(5, 0.1, 2.0), (3, 0.2, 5.0), (7, 0.15, 3.0)])
def test_bilateral_kernel_matches_plain(dev, shape, d, sc, ss):
    x = _input(shape, 2, dev)
    got = _launched("bilateral", lambda: tk.bilateral_nhwc_pallas(
        x, d=d, sigma_color=sc, sigma_space=ss))
    want = tk.bilateral_nhwc_pallas(x.cpu(), d=d, sigma_color=sc, sigma_space=ss)
    assert (got.cpu() - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d,scale", [(5, 1.0), (3, 2.5)])
def test_sobel_bilateral_kernel_matches_plain(dev, shape, d, scale):
    x = _input(shape, 3, dev)
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


@pytest.mark.parametrize("shape,scale,r", [
    ((2, 68, 40, 3), 12.0, 4), ((2, 68, 40, 5), 12.0, 4),
    ((1, 33, 17, 1), 5.0, 2), ((4, 90, 160, 5), 4.0, 1),
])
def test_warp_bounded_kernel_matches_plain(dev, shape, scale, r):
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    flow = torch.from_numpy(((rng.random(shape[:3] + (2,)) - 0.5) * scale)
                            .astype(np.float32)).to(dev)
    got = _launched("warp_bounded", lambda: tk.warp_bounded_pallas(img, flow, r))
    want = tk.warp_bounded_pallas(img.cpu(), flow.cpu(), r)
    # The kernel repeats the plain version's operations: 3e-6 is the
    # reference's bar, the kernel is expected to match bit for bit.
    assert (got.cpu() - want).abs().max().item() <= 3e-6
    on_card = tflow.warp_by_flow(img, flow.clamp(-r, r))
    assert (got - on_card).abs().max().item() <= 3e-6


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


def test_codec_kernels_refuse_without_launching(dev):
    a = torch.zeros((2, 32, 32, 3), dtype=torch.uint8, device=dev)
    plane = torch.zeros((2, 32, 32), dtype=torch.uint8, device=dev)
    q = tk.jpeg_quant_table(90)
    before = dict(tk.LAUNCHES)
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
