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


# ------------------------------------------- the rest of the registry

def _frames(shape, seed):
    """uint8 frames with smooth structure plus noise: edges for canny and
    uneven histograms for equalize/clahe."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 90 * np.sin(xx / 3.1 + yy / 5.3)[None, :, :, None] * \
        rng.uniform(0.3, 1.0, (b, 1, 1, c))
    steps = ((xx[None, :, :, None] > rng.uniform(0, w, (b, 1, 1, c))) * 60.0)
    x = base + steps + rng.normal(0, 12, shape)
    return np.clip(x, 0, 255).astype(np.uint8)


HIST_CASES = [
    ("equalize", {}),
    ("equalize", {"on_gray": True}),
    ("clahe", {}),
    ("clahe", {"clip_limit": 1.0, "grid": 4, "on_gray": True}),
    ("clahe", {"clip_limit": 40.0, "grid": 3}),
    ("canny", {}),
    ("canny", {"threshold1": 200.0, "threshold2": 40.0, "l2_gradient": False}),
    ("canny", {"threshold1": 5.0, "threshold2": 30.0, "max_iters": 2}),
    ("upscale", {}),
    ("upscale", {"scale": 3}),
    ("upscale", {"scale": 1}),
]


@pytest.mark.parametrize("shape", [(3, 24, 32, 3), (2, 29, 37, 3)],
                         ids=["24x32", "29x37"])
@pytest.mark.parametrize("name,cfg", HIST_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(HIST_CASES)])
def test_classical_ops_bit_exact(name, cfg, shape):
    """equalize, clahe, canny and nearest upscale: the port's engine output
    is the JAX package's byte for byte (29x37 is not divisible by the
    CLAHE grid: the reflect-padded tiles)."""
    frames = _frames(shape, 11)
    jf, tf = dvf_tpu.get_filter(name, **cfg), dvf_tpu_torch.get_filter(name, **cfg)
    assert tf.name == jf.name and tf.uint8_ok == jf.uint8_ok and tf.halo == jf.halo
    want = _jax_step(jf, frames)
    got = Engine(tf, device="cpu").submit(frames).fetch()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,cfg", [("equalize", {}), ("clahe", {"grid": 4}),
                                      ("equalize", {"on_gray": True})])
def test_histogram_ops_float_path_bit_exact(name, cfg):
    """A float batch goes to uint8, through the LUT and back to float."""
    x = _frames((2, 16, 20, 3), 12).astype(np.float32) / 255.0
    want, _ = dvf_tpu.get_filter(name, **cfg).fn(jnp.asarray(x), None)
    got, _ = dvf_tpu_torch.get_filter(name, **cfg).fn(torch.from_numpy(x), None)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_equalize_constant_frame_is_unchanged():
    x = np.full((2, 8, 8, 3), 77, np.uint8)
    got = Engine(dvf_tpu_torch.get_filter("equalize"), device="cpu").submit(x).fetch()
    np.testing.assert_array_equal(got, x)


def test_canny_hysteresis_cap_counts_rounds_like_reference():
    """A long weak chain from one strong seed: after max_iters rounds the
    promoted prefix is the reference's, whatever the check interval."""
    from dvf_tpu.ops.canny import _hysteresis as jhyst
    from dvf_tpu_torch.ops import canny as tcanny

    weak = np.zeros((1, 5, 40), bool)
    weak[0, 2, :] = True
    strong = np.zeros_like(weak)
    strong[0, 2, 0] = True
    for cap in (0, 1, 5, 8, 9, 17, 256):
        want = np.asarray(jhyst(jnp.asarray(strong), jnp.asarray(weak), max_iters=cap))
        got = tcanny._hysteresis(torch.from_numpy(strong), torch.from_numpy(weak),
                                 max_iters=cap)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(want.sum()) == min(cap + 1, 40)


@pytest.mark.parametrize("scale", [2, 3])
def test_upscale_linear_matches_jax_image_resize(scale):
    """Bilinear, half-pixel centres, borders taking the edge pixel: within
    1e-6 of ``jax.image.resize(..., "linear")``, borders included."""
    x = np.random.default_rng(13).random((2, 7, 9, 3), dtype=np.float32)
    jf = dvf_tpu.get_filter("upscale", scale=scale, method="linear")
    tf = dvf_tpu_torch.get_filter("upscale", scale=scale, method="linear")
    want, _ = jf.fn(jnp.asarray(x), None)
    got, _ = tf.fn(torch.from_numpy(x), None)
    assert got.shape == want.shape == (2, 7 * scale, 9 * scale, 3)
    assert not tf.uint8_ok
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert torch.isfinite(edge).all()


@pytest.mark.parametrize("name,cfg,err", [
    ("upscale", {"scale": 0}, ValueError),
    ("upscale", {"method": "cubic"}, ValueError),
    ("clahe", {"grid": 0}, ValueError),
    ("clahe", {"clip_limit": 0.0}, ValueError),
    ("style_transfer", {"parallel": "dp"}, ValueError),
    ("style_transfer", {"dtype": "float16"}, ValueError),
    ("super_resolution", {"dtype": "int8"}, ValueError),
])
def test_argument_errors_match_reference(name, cfg, err):
    with pytest.raises(err) as want:
        dvf_tpu.get_filter(name, **cfg)
    with pytest.raises(err) as got:
        dvf_tpu_torch.get_filter(name, **cfg)
    assert str(got.value) == str(want.value)


def test_list_filters_equals_reference():
    assert dvf_tpu_torch.list_filters() == dvf_tpu.list_filters()


def test_measured_defaults_resolve_to_ref():
    """No A/B of the port is committed: both neural keys run the reference
    lowering on either backend, and the factories resolve fast_convs=None
    to it."""
    from dvf_tpu_torch.ops.registry import MEASURED_DEFAULTS, measured_default_for

    assert set(MEASURED_DEFAULTS) == {"style_fast", "espcn_fast"}
    for key in MEASURED_DEFAULTS:
        assert MEASURED_DEFAULTS[key]["winners"] == {}
        for backend in ("cpu", "cuda"):
            assert measured_default_for(key, backend) == "ref"
    assert measured_default_for("style_fast") == "ref"


@pytest.mark.parametrize("name,cfg", [
    ("style_transfer", {"base_channels": 8, "n_residual": 2}),
    ("style_transfer", {"base_channels": 8, "n_residual": 2, "parallel": "pp",
                        "dtype": "float32", "fast_convs": True}),
    ("super_resolution", {"scale": 3}),
])
def test_neural_filters_names_and_state(name, cfg):
    """The same filter names as the reference; seeded weights live in the
    state on the engine's device, and the state comes back unchanged."""
    jf, tf = dvf_tpu.get_filter(name, **cfg), dvf_tpu_torch.get_filter(name, **cfg)
    assert tf.name == jf.name and tf.stateful
    state = tf.init_state((1, 8, 8, 3), torch.float32, torch.device("cpu"))
    x = torch.rand(1, 8, 8, 3)
    y, state2 = tf.fn(x, state)
    assert state2 is state
    scale = cfg.get("scale", 1)
    assert y.shape == (1, 8 * scale, 8 * scale, 3) and y.dtype == torch.float32
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0
