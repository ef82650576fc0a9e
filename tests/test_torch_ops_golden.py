"""The port's filter library on the golden cases of ``tests/test_ops_golden.py``.

The reference suite holds the JAX package to cv2 and numpy goldens; this
counterpart feeds the same inputs to the port and to the JAX package and
holds the port to the JAX package's output, with each case's tolerance,
never to cv2 directly. The properties each reference case asserts of its
output (mass preserved, edges kept, level counts, monotone equalization)
are asserted of the port's output too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch as dt


def _jax(filt, x):
    out, _ = filt(jnp.asarray(x), None)
    return np.asarray(out)


def _port(filt, x):
    with torch.no_grad():
        out, _ = filt(torch.from_numpy(np.ascontiguousarray(x)), None)
    return out.numpy()


def _both(name, x, **kw):
    return (_port(dt.get_filter(name, **kw), x),
            _jax(dvf_tpu.get_filter(name, **kw), x))


@pytest.fixture
def frame_f32(frame_u8):
    return frame_u8.astype(np.float32) / 255.0


class TestInvert:
    def test_matches_jax_uint8(self, frame_u8):
        got, want = _both("invert", frame_u8[None])
        np.testing.assert_array_equal(got, want)

    def test_float_path(self, batch_f32):
        got, want = _both("invert", batch_f32)
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_involution(self, frame_u8):
        f = dt.get_filter("invert")
        np.testing.assert_array_equal(_port(f, _port(f, frame_u8[None]))[0],
                                      frame_u8)


class TestGaussianBlur:
    @pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (9, 0.0), (9, 2.0), (5, 1.5)])
    def test_matches_jax(self, frame_f32, ksize, sigma):
        got, want = _both("gaussian_blur", frame_f32[None], ksize=ksize, sigma=sigma)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_preserves_mean(self, batch_f32):
        got, want = _both("gaussian_blur", batch_f32, ksize=9, sigma=2.0)
        np.testing.assert_allclose(got, want, atol=2e-5)
        assert abs(float(got.mean()) - float(batch_f32.mean())) < 1e-2


class TestSobel:
    def test_gradients_match_jax(self, frame_u8):
        from dvf_tpu.ops.conv import sobel_gradients as jax_sobel
        from dvf_tpu_torch.ops.conv import sobel_gradients

        gray = frame_u8.astype(np.float32).mean(-1, keepdims=True)[None] / 255.0
        gx, gy = sobel_gradients(torch.from_numpy(gray))
        jgx, jgy = jax_sobel(jnp.asarray(gray))
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-4)
        np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), atol=1e-4)

    def test_flat_image_is_zero(self):
        flat = np.full((1, 32, 32, 3), 0.5, dtype=np.float32)
        got, want = _both("sobel", flat)
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(got, 0.0, atol=1e-6)


class TestBilateral:
    def test_matches_jax(self, frame_f32):
        got, want = _both("bilateral", frame_f32[None], d=5, sigma_color=0.1,
                          sigma_space=2.0)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_large_sigma_color_approaches_gaussian(self, frame_f32):
        got, want = _both("bilateral", frame_f32[None], d=5, sigma_color=1e3,
                          sigma_space=2.0)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_edge_preserved_vs_gaussian(self):
        img = np.zeros((1, 32, 32, 3), dtype=np.float32)
        img[:, :, 16:, :] = 1.0
        bi, jbi = _both("bilateral", img, d=5, sigma_color=0.05, sigma_space=2.0)
        ga, jga = _both("gaussian_blur", img, ksize=5, sigma=2.0)
        np.testing.assert_allclose(bi, jbi, atol=1e-5)
        np.testing.assert_allclose(ga, jga, atol=1e-5)
        col = 15
        assert abs(bi[0, 16, col, 0] - img[0, 16, col, 0]) < abs(
            ga[0, 16, col, 0] - img[0, 16, col, 0])


class TestChains:
    def test_sobel_bilateral_matches_jax(self, batch_f32):
        got, want = _both("sobel_bilateral", batch_f32)
        assert got.shape == batch_f32.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestPointwiseExtras:
    def test_grayscale_matches_jax(self, frame_f32):
        got, want = _both("grayscale", frame_f32[None])
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_uint8_roundtrip(self, frame_u8):
        from dvf_tpu.utils.image import to_float as jax_to_float
        from dvf_tpu.utils.image import to_uint8 as jax_to_uint8
        from dvf_tpu_torch.utils import to_float, to_uint8

        f = to_float(torch.from_numpy(frame_u8))
        np.testing.assert_array_equal(f.numpy(),
                                      np.asarray(jax_to_float(jnp.asarray(frame_u8))))
        np.testing.assert_array_equal(to_uint8(f).numpy(), frame_u8)
        np.testing.assert_array_equal(
            to_uint8(f).numpy(), np.asarray(jax_to_uint8(jax_to_float(jnp.asarray(frame_u8)))))


class TestPosterize:
    def test_matches_jax(self, batch_f32):
        got, want = _both("posterize", batch_f32, levels=4)
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_level_count(self, batch_f32):
        got, want = _both("posterize", batch_f32, levels=3)
        assert len(np.unique(got)) <= 3
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_rejects_bad_levels(self):
        with pytest.raises(ValueError):
            dt.get_filter("posterize", levels=1)


class TestEmboss:
    def test_matches_jax(self, frame_f32):
        got, want = _both("emboss", frame_f32[None])
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert np.array_equal(got[..., 0], got[..., 1])


class TestCartoon:
    def test_structure_matches_jax(self, frame_f32):
        got, want = _both("cartoon", frame_f32[None], levels=4)
        assert got.shape == want.shape
        assert got.min() >= 0.0 and got.max() <= 1.0
        np.testing.assert_allclose(got, want, atol=1e-5)
        smooth = _port(dt.get_filter("bilateral", d=5, sigma_color=0.15,
                                     sigma_space=3.0), frame_f32[None])
        quant = np.round(np.clip(smooth, 0, 1) * 3) / 3
        assert got.mean() <= quant.mean() + 1e-6


def test_cartoon_rejects_bad_levels():
    with pytest.raises(ValueError):
        dt.get_filter("cartoon", levels=1)


def test_cartoon_halo_never_pointwise():
    for d in (1, 5):
        assert dt.get_filter("cartoon", d=d).halo == dvf_tpu.get_filter("cartoon", d=d).halo
    assert dt.get_filter("cartoon", d=1).halo == 1


def test_sep_conv_impls_agree():
    """The shifted-FMA formulation and the grouped-conv one are the same
    operator, and both equal the JAX package's shift lowering."""
    from dvf_tpu.ops.conv import gaussian_kernel_1d as jax_kernel
    from dvf_tpu.ops.conv import sep_conv2d as jax_sep_conv2d
    from dvf_tpu_torch.ops.conv import gaussian_kernel_1d, sep_conv2d

    x = np.random.default_rng(7).random((2, 37, 53, 3), np.float32)
    for ksize in (3, 5, 9):
        k = gaussian_kernel_1d(ksize, 0.0)
        a = sep_conv2d(torch.from_numpy(x), k, k, impl="shift").numpy()
        d = sep_conv2d(torch.from_numpy(x), k, k, impl="depthwise").numpy()
        np.testing.assert_allclose(a, d, atol=1e-5, rtol=1e-5)
        jk = jax_kernel(ksize, 0.0)
        j = np.asarray(jax_sep_conv2d(jnp.asarray(x), jk, jk, impl="shift"))
        np.testing.assert_allclose(a, j, atol=1e-5, rtol=1e-5)


def test_equalize_matches_jax_on_gray():
    rng = np.random.default_rng(3)
    img = (rng.normal(120, 40, (3, 40, 56)).clip(0, 255)).astype(np.uint8)
    rgb = np.repeat(img[..., None], 3, -1)
    got, want = _both("equalize", rgb, on_gray=True)
    np.testing.assert_array_equal(got, want)
    const = np.full((1, 8, 8, 3), 77, np.uint8)
    got, want = _both("equalize", const, on_gray=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, const)


def test_equalize_per_channel_flattens_histogram():
    x = np.random.default_rng(4).integers(100, 156, (2, 32, 32, 3)).astype(np.uint8)
    got, want = _both("equalize", x)
    np.testing.assert_array_equal(got, want)
    assert got.min() < 20 and got.max() > 235
    xv, ov = x[0, :, :, 0].ravel(), got[0, :, :, 0].ravel()
    assert (np.diff(ov[np.argsort(xv, kind="stable")]) >= 0).all()


def test_measured_per_backend_defaults():
    """The port's rule: ``impl=None`` resolves to the hand kernel where one
    exists (no TPU or CPU winner of the JAX package carries over); an
    explicit impl pins; an unknown impl raises."""
    from dvf_tpu_torch.ops.registry import measured_default

    assert "pallas" in dt.get_filter("sobel_bilateral").name
    assert "pallas" in dt.get_filter("gaussian_blur").name          # k=9
    assert "pallas" not in dt.get_filter("gaussian_blur", ksize=3).name
    assert "pallas" not in dt.get_filter("sobel_bilateral", impl="chain").name
    assert "pallas" not in dt.get_filter("gaussian_blur", impl="shift").name
    with pytest.raises(ValueError, match="impl"):
        dt.get_filter("sobel_bilateral", impl="nope")
    assert measured_default({"cuda": "a"}, fallback="b") == "a"
    assert measured_default({"tpu": "a"}, fallback="b") == "b"
    assert measured_default({"cpu": "a"}, fallback="b", backend="cpu") == "a"
    with pytest.raises(ValueError, match="pallas"):
        dt.get_filter("gaussian_blur", impl="palas")


def test_median_blur_matches_jax():
    rng = np.random.RandomState(3)
    for shape in [(48, 64), (31, 37)]:
        img = rng.randint(0, 255, (*shape, 3), np.uint8)
        x = img[None].astype(np.float32) / 255.0
        got, want = _both("median_blur", x)
        np.testing.assert_array_equal(np.round(got * 255.0).astype(np.uint8),
                                      np.round(want * 255.0).astype(np.uint8))
    with pytest.raises(ValueError, match="ksize=3"):
        dt.get_filter("median_blur", ksize=5)


def test_clahe_matches_jax():
    """Within the 1-step interpolation rounding the reference allows
    against cv2. The JAX side runs under jit here (eager CLAHE is tens of
    seconds); a contracted FMA moves a value by far less than a step."""
    import jax

    rng = np.random.RandomState(7)
    for clip, grid, shape in [(2.0, 8, (64, 64)), (2.0, 8, (96, 128)),
                              (4.0, 4, (100, 120)), (40.0, 8, (64, 96)),
                              (2.0, 8, (61, 83))]:
        img = (rng.randint(0, 255, shape, np.uint8) // 3 + 60).astype(np.uint8)
        x = img.astype(np.float32)[None, ..., None] / 255.0
        kw = dict(clip_limit=clip, grid=grid, on_gray=True)
        got = _port(dt.get_filter("clahe", **kw), x)
        want = np.asarray(jax.jit(dvf_tpu.get_filter("clahe", **kw).fn)(
            jnp.asarray(x), None)[0])
        g8 = np.round(got[0, ..., 0] * 255).astype(int)
        w8 = np.round(want[0, ..., 0] * 255).astype(int)
        assert np.abs(g8 - w8).max() <= 1, (clip, grid, shape)
    batch = rng.randint(0, 255, (2, 40, 48, 3), np.uint8)
    got, want = _both("clahe", batch)
    assert got.shape == batch.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="grid"):
        dt.get_filter("clahe", grid=0)
    with pytest.raises(ValueError, match="clip_limit"):
        dt.get_filter("clahe", clip_limit=0.0)


def test_canny_matches_jax():
    rng = np.random.RandomState(3)
    import cv2  # the input's pre-blur only; the golden is the JAX package

    for t1, t2, l2, blur in [(100, 200, True, 3), (50, 150, True, 5),
                             (100, 200, False, 3), (200, 100, True, 3)]:
        img = cv2.GaussianBlur(rng.randint(0, 255, (90, 130), np.uint8),
                               (blur, blur), 0)
        rgb = np.repeat(img[..., None], 3, -1).astype(np.float32)[None] / 255.0
        got, want = _both("canny", rgb, threshold1=t1, threshold2=t2,
                          l2_gradient=l2)
        assert set(np.unique(got).tolist()) <= {0.0, 1.0}
        ours, ref = got[0, ..., 0] > 0.5, want[0, ..., 0] > 0.5
        iou = (ours & ref).sum() / max(1, (ours | ref).sum())
        assert iou >= 0.99, (t1, t2, l2, blur, iou)
        assert np.array_equal(got[0, ..., 0], got[0, ..., 1])
