"""The port's neural layers and models against the JAX package's.

Same seeded numpy inputs through both packages; params are the JAX
package's, carried across with ``convert.from_jax``. Bars: rearrangements
(depth_to_space, space_to_depth, the fast-conv kernel rewrites, nearest
upsampling) exact; float32 within 1e-4 (the reference's own f32 bar,
tests/test_models.py); the bfloat16 nets within the goldens' bar on the
uint8 output (mean |Δ| < 2.0, max <= 30), since bf16 conv sums taken in
another order round differently layer by layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvf_tpu.models import espcn as jespcn
from dvf_tpu.models import layers as jl
from dvf_tpu.models import style_transfer as jst
from dvf_tpu_torch.convert import from_jax
from dvf_tpu_torch.models import espcn as tespcn
from dvf_tpu_torch.models import layers as tl
from dvf_tpu_torch.models import style_transfer as tst

CPU = torch.device("cpu")


def _both(a):
    """numpy → (jax array, torch tensor) holding the same values."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _conv_params(rng, k, cin, cout):
    return {"w": rng.standard_normal((k, k, cin, cout)).astype(np.float32),
            "b": rng.standard_normal(cout).astype(np.float32)}


@pytest.mark.parametrize("k,stride,reflect,padding", [
    (9, 1, True, "SAME"), (3, 2, True, "SAME"), (3, 1, False, "SAME"),
    (5, 1, False, "SAME"), (3, 1, False, "VALID"), (3, 2, False, "VALID"),
])
def test_conv2d_nb_matches(k, stride, reflect, padding):
    rng = np.random.default_rng(k * 10 + stride)
    p = _conv_params(rng, k, 4, 6)
    jx, tx = _both(rng.random((2, 14, 18, 4), dtype=np.float32))
    want = jl.conv2d_nb(jax.tree.map(jnp.asarray, p), jx, stride=stride,
                        padding=padding, compute_dtype=jnp.float32, reflect=reflect)
    got = tl.conv2d_nb(from_jax(p, CPU), tx, stride=stride, padding=padding,
                       compute_dtype=torch.float32, reflect=reflect)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


def test_conv2d_nb_bf16_result_dtype_and_values():
    """A bf16 conv returns bf16, as lax.conv does, within one bf16
    rounding of the reference's."""
    rng = np.random.default_rng(1)
    p = _conv_params(rng, 3, 8, 8)
    jx, tx = _both(rng.random((1, 10, 12, 8), dtype=np.float32))
    want = jl.conv2d_nb(jax.tree.map(jnp.asarray, p), jx, reflect=True)
    got = tl.conv2d_nb(from_jax(p, CPU), tx, reflect=True)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches(dtype):
    rng = np.random.default_rng(2)
    p = {"scale": rng.random(5, dtype=np.float32) + 0.5,
         "bias": rng.standard_normal(5).astype(np.float32)}
    x = (rng.standard_normal((3, 9, 11, 5)) * 3 + 1).astype(np.float32)
    want = jl.instance_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x).astype(dtype))
    got = tl.instance_norm(from_jax(p, CPU), torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(dtype)
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_instance_norm_uses_population_variance():
    x = torch.tensor([0.0, 2.0]).view(1, 1, 2, 1)
    p = {"scale": torch.ones(1), "bias": torch.zeros(1)}
    # var = 1 (population), so the output is +-1 / sqrt(1 + eps)
    np.testing.assert_allclose(tl.instance_norm(p, x).flatten().numpy(),
                               [-1 / np.sqrt(1 + 1e-5), 1 / np.sqrt(1 + 1e-5)],
                               rtol=1e-6)


@pytest.mark.parametrize("factor", [2, 3])
def test_rearrangements_exact(factor):
    rng = np.random.default_rng(factor)
    x = rng.random((2, 6, 9, 3 * factor * factor), dtype=np.float32)
    jx, tx = _both(x)
    np.testing.assert_array_equal(tl.depth_to_space(tx, factor).numpy(),
                                  np.asarray(jl.depth_to_space(jx, factor)))
    y = rng.random((2, 6 * factor, 3 * factor, 4), dtype=np.float32)
    jy, ty = _both(y)
    np.testing.assert_array_equal(tl.space_to_depth(ty, factor).numpy(),
                                  np.asarray(jl.space_to_depth(jy, factor)))
    np.testing.assert_array_equal(tl.upsample_nearest(ty, factor).numpy(),
                                  np.asarray(jl.upsample_nearest(jy, factor)))
    # space_to_depth inverts depth_to_space
    np.testing.assert_array_equal(
        tl.space_to_depth(tl.depth_to_space(tx, factor), factor).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        tl.depth_to_space(torch.zeros(1, 2, 2, 5), 2)


def test_depth_to_space_is_dcr_not_pixel_shuffle():
    """y[b, h*r+i, w*r+j, c] = x[b, h, w, (i*r + j)*C + c]."""
    x = torch.arange(12.0).view(1, 1, 1, 12)
    y = tl.depth_to_space(x, 2)
    for i in range(2):
        for j in range(2):
            for c in range(3):
                assert y[0, i, j, c] == x[0, 0, 0, (i * 2 + j) * 3 + c]


def test_gram_matrix_matches():
    x = np.random.default_rng(4).random((2, 7, 5, 6), dtype=np.float32)
    jx, tx = _both(x)
    np.testing.assert_allclose(tl.gram_matrix(tx).numpy(),
                               np.asarray(jl.gram_matrix(jx)), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("k", [3, 5, 9])
def test_fast_conv_kernels_exact(k):
    """The rewritten kernels are the reference's, element for element."""
    w = np.random.default_rng(k).standard_normal((k, k, 3, 4)).astype(np.float32)
    jw, tw = _both(w)
    np.testing.assert_array_equal(tl._s2d_kernel(tw).numpy(),
                                  np.asarray(jl._s2d_kernel(jw)))
    kj, pad_j = jl._upsample2_kernel(jw)
    kt, pad_t = tl._upsample2_kernel(tw)
    assert pad_t == pad_j
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


# tests/test_models.py::test_fast_conv_rewrites_match_reference_lowering's
# shapes, with He-normal weights (the nets' scale) so the outputs are O(1)
# and 1e-4 is a bar on the rewrite, not on float32 rounding at |y| ~ 100
# (unit-variance 9x9x32 taps give that: 1.5e-4 between two conv libraries).
def _he(rng, k, cin, cout):
    return (rng.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)


S2D_CASES = [(9, 3, 5, 12, 16), (9, 32, 3, 20, 24), (3, 4, 6, 10, 14), (5, 3, 8, 16, 12)]


@pytest.mark.parametrize("reflect", [True, False])
@pytest.mark.parametrize("k,cin,cout,h,w", S2D_CASES)
def test_conv2d_s2d_matches(k, cin, cout, h, w, reflect):
    rng = np.random.RandomState(0)
    p = {"w": _he(rng, k, cin, cout)}
    jx, tx = _both(rng.rand(2, h, w, cin).astype(np.float32))
    tp = from_jax(p, CPU)
    got = tl.conv2d_s2d(tp, tx, compute_dtype=torch.float32, reflect=reflect)
    want = jl.conv2d_s2d(jax.tree.map(jnp.asarray, p), jx,
                         compute_dtype=jnp.float32, reflect=reflect)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    ref = tl.conv2d_nb(tp, tx, compute_dtype=torch.float32, reflect=reflect)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=0)


def test_conv2d_s2d_odd_geometry_falls_back_exactly():
    rng = np.random.RandomState(0)
    p = from_jax({"w": rng.randn(9, 9, 3, 4).astype(np.float32)}, CPU)
    x = torch.from_numpy(rng.rand(1, 13, 17, 3).astype(np.float32))
    a = tl.conv2d_nb(p, x, compute_dtype=torch.float32, reflect=True)
    b = tl.conv2d_s2d(p, x, compute_dtype=torch.float32, reflect=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("k,cin,cout,h,w", [(3, 5, 7, 9, 11), (3, 3, 3, 8, 8),
                                            (5, 4, 6, 10, 12)])
def test_upsample2_conv_matches(k, cin, cout, h, w):
    """Phase-collapsed for k = 3; k = 5 falls back to the materialized
    upsample (exactly the reference lowering)."""
    rng = np.random.RandomState(k + h)
    p = {"w": _he(rng, k, cin, cout)}
    jx, tx = _both(rng.rand(2, h, w, cin).astype(np.float32))
    tp = from_jax(p, CPU)
    got = tl.upsample2_conv(tp, tx, compute_dtype=torch.float32)
    want = jl.upsample2_conv(jax.tree.map(jnp.asarray, p), jx, compute_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    ref = tl.conv2d_nb(tp, tl.upsample_nearest(tx, 2), compute_dtype=torch.float32,
                       reflect=True)
    if k == 5:
        assert torch.equal(got, ref)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["reflect", "edge", "constant"])
def test_pad_nhwc_matches_jnp_pad(mode):
    x = np.random.default_rng(5).random((2, 5, 7, 3), dtype=np.float32)
    for r in (1, 2, 4):
        want = np.pad(x, ((0, 0), (r, r), (r, r), (0, 0)), mode=mode)
        got = tl.pad_nhwc(torch.from_numpy(x), r, mode)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- whole nets

STYLE_CFG = dict(base_channels=8, n_residual=2)


def _jax_style_params(seed=0):
    cfg = jst.StyleNetConfig(**STYLE_CFG)
    return jax.device_get(jst.init_style_net(jax.random.PRNGKey(seed), cfg))


def _u8(y):
    return np.round(np.clip(_np(y), 0, 1) * 255).astype(np.int16)


@pytest.mark.parametrize("fast", [False, True])
def test_style_net_float32_matches(fast):
    params = _jax_style_params()
    x = np.random.RandomState(1).rand(2, 24, 32, 3).astype(np.float32)
    jx, tx = _both(x)
    jcfg = jst.StyleNetConfig(**STYLE_CFG, compute_dtype=jnp.float32, fast_convs=fast)
    tcfg = tst.StyleNetConfig(**STYLE_CFG, compute_dtype=torch.float32, fast_convs=fast)
    want = jst.apply_style_net(jax.tree.map(jnp.asarray, params), jx, jcfg)
    got = tst.apply_style_net(from_jax(params, CPU), tx, tcfg)
    assert got.shape == (2, 24, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fast", [False, True])
def test_style_net_bfloat16_within_golden_bar(fast):
    params = _jax_style_params(3)
    x = np.random.RandomState(2).rand(2, 24, 32, 3).astype(np.float32)
    jx, tx = _both(x)
    jcfg = jst.StyleNetConfig(**STYLE_CFG, fast_convs=fast)
    tcfg = tst.StyleNetConfig(**STYLE_CFG, fast_convs=fast)
    want = jst.apply_style_net(jax.tree.map(jnp.asarray, params), jx, jcfg)
    got = tst.apply_style_net(from_jax(params, CPU), tx, tcfg)
    assert got.dtype == torch.float32
    diff = np.abs(_u8(got) - _u8(want))
    assert diff.mean() < 2.0 and diff.max() <= 30, (diff.mean(), diff.max())


def test_style_net_pp_grouping_matches_flat():
    """parallel="pp" on one device: the stacked trunk gives the flat net's
    output exactly, and the reference's pp_sequential_apply within 1e-4."""
    params = _jax_style_params(1)
    x = np.random.RandomState(3).rand(2, 16, 20, 3).astype(np.float32)
    jx, tx = _both(x)
    tcfg = tst.StyleNetConfig(**STYLE_CFG, compute_dtype=torch.float32)
    tp = from_jax(params, CPU)
    pp = tst.to_pp_params(tp, tcfg)
    assert pp["trunk"]["a"]["w"].shape == (2, 3, 3, 32, 32)
    got = tst.pp_sequential_apply(tcfg)(pp, tx)
    assert torch.equal(got, tst.apply_style_net(tp, tx, tcfg))
    jcfg = jst.StyleNetConfig(**STYLE_CFG, compute_dtype=jnp.float32)
    jpp = jst.to_pp_params(jax.tree.map(jnp.asarray, params), jcfg)
    want = jst.pp_sequential_apply(jcfg)(jpp, jx)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


def test_stack_layer_params_matches_reference():
    from dvf_tpu.parallel.pp import stack_layer_params as jstack
    from dvf_tpu_torch.parallel.pp import stack_layer_params as tstack

    rng = np.random.default_rng(6)
    blocks = [{"a": {"w": rng.random((2, 3), dtype=np.float32)},
               "n": {"s": rng.random(4, dtype=np.float32)}} for _ in range(3)]
    want = jstack([jax.tree.map(jnp.asarray, b) for b in blocks])
    got = tstack([from_jax(b, CPU) for b in blocks])
    np.testing.assert_array_equal(got["a"]["w"].numpy(), np.asarray(want["a"]["w"]))
    np.testing.assert_array_equal(got["n"]["s"].numpy(), np.asarray(want["n"]["s"]))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_espcn_matches(fast, dtype):
    jcfg = jespcn.EspcnConfig(compute_dtype=jnp.dtype(dtype), fast_convs=fast)
    tcfg = tespcn.EspcnConfig(compute_dtype=getattr(torch, dtype), fast_convs=fast)
    params = jax.device_get(jespcn.init_espcn(jax.random.PRNGKey(0), jcfg))
    x = np.random.RandomState(1).rand(2, 18, 22, 3).astype(np.float32)
    jx, tx = _both(x)
    want = jespcn.apply_espcn(jax.tree.map(jnp.asarray, params), jx, jcfg)
    got = tespcn.apply_espcn(from_jax(params, CPU), tx, tcfg)
    assert got.shape == (2, 36, 44, 3) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    else:
        diff = np.abs(_u8(got) - _u8(want))
        assert diff.mean() < 2.0 and diff.max() <= 30, (diff.mean(), diff.max())


def test_seeded_init_has_the_reference_structure_and_is_device_free():
    """The same tree, shapes and dtypes as the reference's init; He-normal
    scale; zero biases, unit norm scales; one seed, one set of weights."""
    for jinit, tinit, jcfg, tcfg in [
            (jst.init_style_net, tst.init_style_net,
             jst.StyleNetConfig(**STYLE_CFG), tst.StyleNetConfig(**STYLE_CFG)),
            (jespcn.init_espcn, tespcn.init_espcn,
             jespcn.EspcnConfig(), tespcn.EspcnConfig())]:
        ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jinit(jax.random.PRNGKey(0), jcfg))
        a, b = tinit(0, tcfg), tinit(torch.Generator().manual_seed(0), tcfg)
        got = {k: {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in v.items()}
               for k, v in a.items()}
        assert got == {k: {n: tuple(s) for n, s in v.items()} for k, v in ref.items()}
        for k in a:
            for n in a[k]:
                assert a[k][n].device.type == "cpu" and torch.equal(a[k][n], b[k][n])
        w = a["map" if "map" in a else "down2"]["w"]
        fan_in = w.shape[0] * w.shape[1] * w.shape[2]
        assert abs(float(w.std()) - np.sqrt(2.0 / fan_in)) < 0.1 * np.sqrt(2.0 / fan_in)
    assert not torch.equal(tst.init_style_net(1, tst.StyleNetConfig(**STYLE_CFG))["out"]["w"],
                           tst.init_style_net(0, tst.StyleNetConfig(**STYLE_CFG))["out"]["w"])


def test_exact_f32_convs_sets_and_restores_the_flag():
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with tl.exact_f32_convs(torch.float32):
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
        with tl.exact_f32_convs(torch.bfloat16):
            assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_center_crop_matches_reference():
    from dvf_tpu.utils.image import center_crop as jcrop
    from dvf_tpu_torch.utils.image import center_crop

    x = np.random.default_rng(8).integers(0, 256, (2, 9, 14, 3), dtype=np.uint8)
    for size in (4, 7, 9):
        np.testing.assert_array_equal(center_crop(torch.from_numpy(x), size).numpy(),
                                      np.asarray(jcrop(jnp.asarray(x), size)))
