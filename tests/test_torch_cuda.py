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
