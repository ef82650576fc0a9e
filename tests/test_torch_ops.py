"""The port's filter ops against the JAX package on the same inputs.

Pointwise ops go uint8 → cast → fn → uint8 (the port through its
engine) and must agree byte for byte; the stencil ops' float outputs must
agree within 1e-5, the bar the reference pins for its own kernels.

The reference side runs op by op, not under ``jit``: on the CPU backend
XLA contracts a fused multiply-add into an FMA, which can move a value
across a .5 rounding boundary (3 of 7680 bytes of ``grayscale`` on the
frames below). Op by op, both packages round after every operation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch
from dvf_tpu.ops.conv import gaussian_kernel_1d as jax_gaussian_kernel_1d
from dvf_tpu.utils.image import to_float as jax_to_float, to_uint8 as jax_to_uint8
from dvf_tpu_torch.ops.conv import gaussian_kernel_1d
from dvf_tpu_torch.runtime.engine import Engine

POINTWISE = [
    ("invert", {}),
    ("identity", {}),
    ("grayscale", {}),
    ("brightness_contrast", {"alpha": 1.3, "beta": -0.1}),
    ("gamma", {"g": 2.2}),
    ("threshold", {"t": 0.4}),
    ("sepia", {}),
    ("posterize", {"levels": 5}),
    ("median_blur", {}),
]

STENCILS = [
    ("gaussian_blur", {"ksize": 9, "impl": "shift"}),
    ("gaussian_blur", {"ksize": 5, "sigma": 1.3, "impl": "shift"}),
    ("box_blur", {"ksize": 5}),
    ("sobel", {"magnitude_scale": 2.0}),
    ("sharpen", {"amount": 0.7}),
    ("emboss", {"strength": 1.5}),
    ("bilateral", {"d": 5, "impl": "jnp"}),
    ("sobel_bilateral", {"impl": "chain"}),
    ("cartoon", {}),
]


@pytest.fixture(scope="module")
def frames_u8():
    return np.random.default_rng(3).integers(0, 256, (8, 16, 20, 3),
                                              dtype=np.uint8)


def _jax_step(filt, frames_u8):
    x = jnp.asarray(frames_u8)
    if not filt.uint8_ok:
        x = jax_to_float(x, filt.compute_dtype)
    y, _ = filt.fn(x, None)
    return np.asarray(jax_to_uint8(y))


@pytest.mark.parametrize("name,cfg", POINTWISE, ids=[n for n, _ in POINTWISE])
def test_pointwise_uint8_byte_identical(name, cfg, frames_u8):
    want = _jax_step(dvf_tpu.get_filter(name, **cfg), frames_u8)
    got = Engine(dvf_tpu_torch.get_filter(name, **cfg), device="cpu") \
        .submit(frames_u8).fetch()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize", [3, 5, 9, 15])
@pytest.mark.parametrize("sigma", [0.0, 1.7])
def test_gaussian_taps_bit_identical(ksize, sigma):
    want = np.asarray(jax_gaussian_kernel_1d(ksize, sigma))
    got = gaussian_kernel_1d(ksize, sigma).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,cfg", STENCILS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(STENCILS)])
def test_stencil_float_outputs_match(name, cfg):
    batch = np.random.default_rng(5).random((2, 24, 28, 3), dtype=np.float32)
    jf = dvf_tpu.get_filter(name, **cfg)
    tf = dvf_tpu_torch.get_filter(name, **cfg)
    want, _ = jf.fn(jnp.asarray(batch), None)
    got, _ = tf.fn(torch.from_numpy(batch), None)
    assert tf.halo == jf.halo
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_sep_conv2d_depthwise_pin_matches_shift():
    """The explicit ``depthwise`` A/B pin computes the same function as
    the plain shift formulation."""
    from dvf_tpu_torch.ops.conv import sep_conv2d

    x = torch.from_numpy(np.random.default_rng(9).random((2, 20, 24, 3),
                                                         dtype=np.float32))
    k3, k9 = gaussian_kernel_1d(3, 0.0), gaussian_kernel_1d(9, 0.0)
    np.testing.assert_allclose(sep_conv2d(x, k3, k9, impl="depthwise").numpy(),
                               sep_conv2d(x, k3, k9).numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        sep_conv2d(x, k3, k9, impl="nope")


def test_registry_names_match_reference():
    """Every port filter name is a reference filter name, so op-chain
    strings mean the same in both packages."""
    ported = set(dvf_tpu_torch.list_filters())
    assert ported <= set(dvf_tpu.list_filters())
    assert {"invert", "gaussian_blur", "bilateral", "sobel_bilateral",
            "bilateral_pallas", "sobel_bilateral_pallas",
            "gaussian_blur_pallas"} <= ported
    with pytest.raises(KeyError):
        dvf_tpu_torch.get_filter("no_such_filter")


def test_chain_composes_members_like_reference():
    batch = np.random.default_rng(4).random((2, 16, 18, 3), dtype=np.float32)
    specs = ["grayscale", ("box_blur", {"ksize": 3})]
    jf = dvf_tpu.get_filter("chain", specs=specs)
    tf = dvf_tpu_torch.get_filter("chain", specs=specs)
    want, _ = jf.fn(jnp.asarray(batch), None)
    got, state = tf.fn(torch.from_numpy(batch), None)
    assert state == (None, None) and tf.halo == jf.halo == 1
    assert [m.name for m in tf.members] == [m.name for m in jf.members]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
