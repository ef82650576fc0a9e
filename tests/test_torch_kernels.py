"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain torch version; these tests
hold that to the JAX Pallas function run in interpret mode (as
tests/test_spatial.py runs it): the stencils at atol 1e-5, the bounded
warp at the reference's 3e-6 or its coordinate-rounding bound. The CUDA kernels themselves
are held to the same plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch
from dvf_tpu.ops import pallas_kernels as jk
from dvf_tpu.ops.conv import gaussian_kernel_1d as jax_taps
from dvf_tpu_torch.ops import flow as tflow
from dvf_tpu_torch.ops import kernels as tk
from dvf_tpu_torch.ops.bilateral import bilateral_nhwc
from dvf_tpu_torch.ops.conv import gaussian_kernel_1d, reflect_pad_nhwc


def _batch(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(got: torch.Tensor, want) -> None:
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.fixture(autouse=True)
def _cpu_calls_launch_nothing():
    """No wrapper call on a CPU tensor may count as a kernel launch."""
    assert all(v == 0 for v in tk.LAUNCHES.values())
    yield
    assert all(v == 0 for v in tk.LAUNCHES.values())


@pytest.mark.parametrize("kh,kw,shape", [
    (9, 9, (2, 24, 32, 3)),
    (3, 9, (2, 24, 32, 3)),     # kh != kw: an H/W swap fails here
    (9, 9, (1, 68, 40, 3)),     # unaligned H and W
], ids=["k9", "k3xk9", "unaligned-68x40"])
def test_sep_blur_matches_pallas(kh, kw, shape):
    x = _batch(shape, 11)
    want = jk.sep_blur_nhwc_pallas(jnp.asarray(x), jax_taps(kh, 0.0),
                                   jax_taps(kw, 0.0), interpret=True)
    got = tk.sep_blur_nhwc_pallas(torch.from_numpy(x), gaussian_kernel_1d(kh, 0.0),
                                  gaussian_kernel_1d(kw, 0.0))
    _close(got, want)


@pytest.mark.parametrize("d,sc,ss,shape", [
    (3, 0.2, 5.0, (2, 24, 32, 3)),
    (5, 0.15, 3.0, (2, 24, 32, 3)),
    (5, 0.1, 2.0, (1, 68, 40, 3)),
], ids=["d3", "d5", "unaligned-68x40"])
def test_bilateral_matches_pallas(d, sc, ss, shape):
    x = _batch(shape, 7)
    want = jk.bilateral_nhwc_pallas(jnp.asarray(x), d=d, sigma_color=sc,
                                    sigma_space=ss, interpret=True)
    got = tk.bilateral_nhwc_pallas(torch.from_numpy(x), d=d, sigma_color=sc,
                                   sigma_space=ss)
    _close(got, want)


def _folded_bilateral(x: torch.Tensor, d: int, sc: float, ss: float) -> torch.Tensor:
    """The bilateral kernel's per-tap formula in float32 torch, from the
    constants its wrapper hands it: w = 2^(dist2·nk + log2 sw), taps in the
    plain version's (dy, dx) order."""
    log2w, nk = tk.bilateral_constants(d, sc, ss)
    r = d // 2
    h, w = x.shape[1], x.shape[2]
    pad = reflect_pad_nhwc(x, r, r)
    nk_t = torch.tensor(nk, dtype=torch.float32)
    num = torch.zeros_like(x)
    den = torch.zeros(x.shape[:-1] + (1,), dtype=torch.float32)
    for i in range(d * d):
        dy, dx = divmod(i, d)
        shifted = pad[:, dy:dy + h, dx:dx + w, :]
        diff = shifted - x
        dist2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        wgt = torch.exp2(dist2 * nk_t + torch.tensor(log2w[i], dtype=torch.float32))
        num = num + wgt * shifted
        den = den + wgt
    return num / den


@pytest.mark.parametrize("d,sc,ss", [(3, 0.2, 5.0), (5, 0.1, 2.0), (7, 0.15, 3.0)])
def test_bilateral_folded_weights_match_plain_and_pallas(d, sc, ss):
    x = _batch((1, 68, 40, 3), 23)
    got = _folded_bilateral(torch.from_numpy(x), d, sc, ss)
    plain = bilateral_nhwc(torch.from_numpy(x), d=d, sigma_color=sc, sigma_space=ss)
    want = jk.bilateral_nhwc_pallas(jnp.asarray(x), d=d, sigma_color=sc,
                                    sigma_space=ss, interpret=True)
    _close(got, plain)
    _close(got, want)


def test_bilateral_constants():
    log2w, nk = tk.bilateral_constants(5, 0.1, 2.0)
    assert len(log2w) == 25 and log2w[12] == 0.0    # the centre weight is 1
    sw = [np.exp(-(dy * dy + dx * dx) / 8.0) for dy in range(-2, 3)
          for dx in range(-2, 3)]
    np.testing.assert_allclose(np.exp2(np.float64(log2w)), sw, rtol=1e-6)
    np.testing.assert_allclose(nk * np.log(2.0), -50.0, rtol=1e-6)
    assert all(float(np.float32(v)) == v for v in log2w + [nk])   # float32 values


@pytest.mark.parametrize("kh,kw,c,want", [
    (9, 9, 3, (3, 9, 9)), (3, 9, 1, (1, 3, 9)), (5, 1, 4, (4, 5, 1)),
    (9, 3, 3, (3, 0, 0)), (7, 7, 2, (2, 0, 0)), (31, 31, 4, (4, 0, 0)),
    (1, 1, 3, (3, 0, 0)),
])
def test_sep_blur_instance(kh, kw, c, want):
    assert tk.sep_blur_instance(kh, kw, c) == want


@pytest.mark.parametrize("d,c,want", [
    (5, 3, (3, 2)), (3, 1, (1, 1)), (7, 4, (4, 3)),
    (9, 3, (3, 0)), (15, 4, (4, 0)), (1, 2, (2, 0)),
])
def test_bilateral_instance(d, c, want):
    assert tk.bilateral_instance(d, c) == want


@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (1, 68, 40, 3)],
                         ids=["default", "unaligned-68x40"])
def test_sobel_bilateral_matches_pallas(shape):
    x = _batch(shape, 13)
    want = jk.sobel_bilateral_nhwc_pallas(jnp.asarray(x), interpret=True)
    got = tk.sobel_bilateral_nhwc_pallas(torch.from_numpy(x))
    _close(got, want)


def _folded_sobel_bilateral(x: torch.Tensor, d: int, sc: float, ss: float,
                            scale: float = 1.0) -> torch.Tensor:
    """The fused Sobel+bilateral kernel's per-tap formula in float32 torch,
    from the constants its wrapper hands it: the Sobel magnitude of the
    gray image, then w = 2^(Δ²·nk + log2 sw) on that single channel (the
    centre tap w = 1), taps in the plain version's (dy, dx) order, the
    result broadcast to the C channels."""
    c = x.shape[-1]
    log2w, nk = tk.sobel_bilateral_constants(d, sc, ss, c)
    mag = dvf_tpu_torch.get_filter("sobel", magnitude_scale=scale).fn(x, None)[0]
    mag = mag[..., :1]
    r = d // 2
    h, w = x.shape[1], x.shape[2]
    pad = reflect_pad_nhwc(mag, r, r)
    nk_t = torch.tensor(nk, dtype=torch.float32)
    num = torch.zeros_like(mag)
    den = torch.zeros_like(mag)
    for i in range(d * d):
        dy, dx = divmod(i, d)
        shifted = pad[:, dy:dy + h, dx:dx + w, :]
        diff = shifted - mag
        wgt = torch.exp2(diff * diff * nk_t + torch.tensor(log2w[i], dtype=torch.float32))
        num = num + wgt * shifted
        den = den + wgt
    return (num / den).expand(x.shape)


# C = 3 only: the TPU kernel hard-codes the range distance 3·Δ².
@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (1, 68, 40, 3)],
                         ids=["2x24x32", "68x40"])
@pytest.mark.parametrize("d,sc,ss", [(3, 0.2, 5.0), (5, 0.1, 2.0), (7, 0.15, 3.0)])
def test_sobel_bilateral_folded_weights_match_plain_and_pallas(d, sc, ss, shape):
    x = _batch(shape, 29)
    got = _folded_sobel_bilateral(torch.from_numpy(x), d, sc, ss)
    plain = tk.sobel_bilateral_nhwc_pallas(torch.from_numpy(x), d=d, sigma_color=sc,
                                           sigma_space=ss)
    want = jk.sobel_bilateral_nhwc_pallas(jnp.asarray(x), d=d, sigma_color=sc,
                                          sigma_space=ss, interpret=True)
    _close(got, plain)
    _close(got, want)


def test_sobel_bilateral_constants():
    log2w, nk = tk.sobel_bilateral_constants(5, 0.1, 2.0, 3)
    assert len(log2w) == 25 and log2w[12] == 0.0    # the centre weight is 1
    assert log2w == tk.bilateral_constants(5, 0.1, 2.0)[0]
    np.testing.assert_allclose(nk * np.log(2.0), -3 / (2 * 0.1 ** 2), rtol=1e-6)
    _, nk4 = tk.sobel_bilateral_constants(3, 0.2, 1.0, 4)
    np.testing.assert_allclose(nk4 * np.log(2.0), -4 / (2 * 0.2 ** 2), rtol=1e-6)
    assert all(float(np.float32(v)) == v for v in log2w + [nk, nk4])   # float32 values


@pytest.mark.parametrize("d,c,want", [
    (3, 3, (3, 1)), (5, 3, (3, 2)), (7, 4, (4, 3)),
    (9, 3, (3, 0)), (15, 4, (4, 0)), (1, 3, (3, 0)),
])
def test_sobel_bilateral_instance(d, c, want):
    assert tk.sobel_bilateral_instance(d, c) == want


@pytest.mark.parametrize("name,cfg,halo", [
    ("gaussian_blur_pallas", {"ksize": 9}, 4),
    ("bilateral_pallas", {"d": 5}, 2),
    ("sobel_bilateral_pallas", {}, 3),
])
def test_registered_kernel_filters_match(name, cfg, halo):
    x = _batch((2, 24, 32, 3), 17)
    jf = dvf_tpu.get_filter(name, interpret=True, **cfg)
    tf = dvf_tpu_torch.get_filter(name, **cfg)
    assert tf.halo == jf.halo == halo
    want, _ = jf.fn(jnp.asarray(x), None)
    got, _ = tf.fn(torch.from_numpy(x), None)
    _close(got, want)


@pytest.mark.parametrize("name,cfg,resolved", [
    ("gaussian_blur", {"ksize": 9}, "gaussian_blur_pallas"),
    ("gaussian_blur", {"ksize": 3}, "gaussian_blur(k=3"),
    ("bilateral", {}, "bilateral_pallas"),
    ("sobel_bilateral", {}, "sobel_bilateral_pallas"),
    ("sobel_bilateral", {"impl": "chain"}, "sobel_bilateral(d=5)"),
])
def test_default_impl_is_the_kernel(name, cfg, resolved):
    assert dvf_tpu_torch.get_filter(name, **cfg).name.startswith(resolved)


def test_wrappers_refuse_devices_they_cannot_serve():
    """Only CPU (plain version) and CUDA (kernel) tensors are served: any
    other device raises instead of being routed somewhere silently."""
    meta = torch.empty((1, 16, 16, 3), device="meta")
    k = gaussian_kernel_1d(3, 0.0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.sep_blur_nhwc_pallas(meta, k, k)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.bilateral_nhwc_pallas(meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.sobel_bilateral_nhwc_pallas(meta)
    x = torch.zeros((1, 16, 16, 3))
    with pytest.raises(ValueError, match="odd"):
        tk.bilateral_nhwc_pallas(x, d=4)
    with pytest.raises(ValueError, match="odd"):
        tk.sep_blur_nhwc_pallas(x, [0.5, 0.5], k)


def _coord_tol(h: int, w: int, r: int) -> float:
    """What the plain warp may differ from the TPU kernel by. The plain
    version (the golden, warp_by_flow on the clipped flow) rounds the
    sample coordinate y + fy to float32 before taking its fraction; the
    TPU kernel weighs the flow's own fraction. So the weights differ by up
    to half a float32 step at the largest coordinate, in y and in x, on
    top of a few roundings of the value. 3e-6 is the reference's own bar
    (tests/test_spatial.py), which that term stays under while frames are
    below ~32 px; at 68 rows it reaches 5.7e-6 (measured up to 3.5e-6)."""
    half_steps = 0.5 * (np.spacing(np.float32(h - 1 + r))
                        + np.spacing(np.float32(w - 1 + r)))
    return max(3e-6, float(half_steps) + 4 * 2.0 ** -24)


@pytest.mark.parametrize("shape,scale,r", [
    ((2, 24, 32, 3), 7.0, 4),     # the reference's own aligned case
    ((2, 68, 40, 3), 12.0, 4),    # unaligned H and W; flows in +-6 clip
    ((2, 68, 40, 5), 12.0, 4),    # the inner warp's 5-channel poly stacks
    ((2, 24, 32, 5), 5.0, 2),
], ids=["aligned", "unaligned-68x40", "c5-68x40", "c5-r2"])
def test_warp_bounded_matches_pallas(shape, scale, r):
    rng = np.random.default_rng(19)
    img = rng.random(shape, dtype=np.float32)
    flow = ((rng.random(shape[:3] + (2,)) - 0.5) * scale).astype(np.float32)
    want = jk.warp_bounded_pallas(jnp.asarray(img), jnp.asarray(flow),
                                  max_disp=r, interpret=True)
    got = tk.warp_bounded_pallas(torch.from_numpy(img), torch.from_numpy(flow),
                                 max_disp=r)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_coord_tol(shape[1], shape[2], r))


def test_warp_bounded_border_clamp_matches_pallas():
    """Flows that push every sample point past the frame's edge: the
    border clamp (coordinate clamping in the plain version, edge padding
    in the TPU kernel)."""
    rng = np.random.default_rng(20)
    img = rng.random((2, 8, 16, 3), dtype=np.float32)
    flow = np.empty((2, 8, 16, 2), np.float32)
    flow[0] = 3.7                                   # out past bottom/right
    flow[1] = rng.uniform(-2.0, 2.0, (8, 16, 2))    # near every edge
    flow[1, :2, :, 1] = -2.0                        # rows 0-1 look above
    flow[1, :, -2:, 0] = 2.0                        # last cols look right
    want = jk.warp_bounded_pallas(jnp.asarray(img), jnp.asarray(flow),
                                  max_disp=4, interpret=True)
    got = tk.warp_bounded_pallas(torch.from_numpy(img), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-6)


def test_warp_bounded_plain_is_the_clipped_gather():
    rng = np.random.default_rng(21)
    img = torch.from_numpy(rng.random((1, 12, 10, 4), dtype=np.float32))
    flow = torch.from_numpy(((rng.random((1, 12, 10, 2)) - 0.5) * 20).astype(np.float32))
    got = tk.warp_bounded_pallas(img, flow, max_disp=3)
    want = tflow.warp_by_flow(img, flow.clamp(-3, 3))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="max_disp"):
        tk.warp_bounded_pallas(img, flow, max_disp=0)
    with pytest.raises(ValueError, match="CUDA device"):
        tk.warp_bounded_pallas(img.to("meta"), flow.to("meta"))


def test_warp_bounded_takes_only_its_designs():
    img = torch.zeros((1, 8, 8, 3))
    flow = torch.zeros((1, 8, 8, 2))
    for design in tk.WARP_DESIGNS:                  # a CPU tensor: the plain version
        assert torch.equal(tk.warp_bounded_pallas(img, flow, 2, design), img)
    with pytest.raises(ValueError, match="design"):
        tk.warp_bounded_pallas(img, flow, 2, "tiles")


def test_reset_launches_zeroes_every_counter():
    saved, saved_autograd = dict(tk.LAUNCHES), dict(tk.AUTOGRAD_CALLS)
    try:
        for counts in (tk.LAUNCHES, tk.AUTOGRAD_CALLS):
            for k in counts:
                counts[k] = 3
        tk.reset_launches()
        assert set(tk.LAUNCHES) == {"sep_blur", "bilateral", "sobel_bilateral",
                                    "warp_bounded", "tile_maxdiff", "dct8x8_quant",
                                    "instance_norm", "out_conv"}
        assert set(tk.AUTOGRAD_CALLS) == {"instance_norm", "out_conv"}
        assert all(v == 0 for v in tk.LAUNCHES.values())
        assert all(v == 0 for v in tk.AUTOGRAD_CALLS.values())
    finally:
        tk.LAUNCHES.update(saved)
        tk.AUTOGRAD_CALLS.update(saved_autograd)
