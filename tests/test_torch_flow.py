"""The port's optical flow (``dvf_tpu_torch.ops.flow``), its resize and box
filter, and the stateful flow filters against the JAX package on the same
seeded inputs, on the CPU.

Inputs are smooth textures (sums of random sinusoids) translated by a
sub-pixel step per frame, so the flow problem is well conditioned: on iid
noise the regularized 2x2 solve amplifies float32 reassociation noise
(both packages sum the same terms in other orders) towards 1e-4 px.
Where the reference reaches the Pallas warp it runs in interpret mode, as
its own tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch
from dvf_tpu.ops import flow as jflow
from dvf_tpu.ops.conv import box_filter as jax_box_filter
from dvf_tpu_torch.ops import flow as tflow
from dvf_tpu_torch.ops import kernels as tk
from dvf_tpu_torch.ops.conv import box_filter
from dvf_tpu_torch.runtime.engine import Engine
from dvf_tpu_torch.utils.image import resize_linear

CPU = torch.device("cpu")


def moving_frames(n, h, w, c, seed, step=(0.8, -0.5)):
    """``n`` float32 frames in [0, 1]: six random sinusoid gratings per
    channel, the whole pattern moved by ``step`` = (dx, dy) px per frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((n, h, w, c))
    for _ in range(6):
        fx, fy = rng.uniform(0.05, 0.35, 2)
        phase = rng.uniform(0, 2 * np.pi, c)
        amp = rng.uniform(0.3, 1.0)
        for t in range(n):
            arg = fx * (xx - t * step[0]) + fy * (yy - t * step[1])
            out[t] += amp * np.sin(arg[..., None] + phase)
    out = (out - out.min()) / (out.max() - out.min())
    return out.astype(np.float32)


def _close(got: torch.Tensor, want, atol: float) -> None:
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.fixture(autouse=True)
def _cpu_calls_launch_nothing():
    """On CPU tensors the bounded warp runs its plain version: no launch."""
    before = dict(tk.LAUNCHES)
    yield
    assert tk.LAUNCHES == before


# --- resize --------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((48, 64), (24, 32)),      # 2x down: the antialias filter matters
    ((90, 160), (45, 80)),
    ((24, 32), (48, 64)),      # up
    ((45, 61), (22, 30)),      # odd sizes, down
    ((22, 30), (45, 61)),      # odd sizes, up
    ((17, 10), (9, 5)),
], ids=["down", "down-720p-ratio", "up", "odd-down", "odd-up", "tiny-odd"])
@pytest.mark.parametrize("c", [1, 2])
def test_resize_linear_matches_jax_image_resize(src, dst, c):
    import jax

    x = np.random.default_rng(1).random((3, *src, c), dtype=np.float32)
    want = jax.image.resize(jnp.asarray(x), (3, *dst, c), method="linear")
    got = resize_linear(torch.from_numpy(x), dst)
    assert got.is_contiguous()
    # Measured <= 1.8e-7: the same triangle filter, summed in another order.
    _close(got, want, atol=5e-7)


def test_resize_linear_same_size_is_identity():
    x = torch.from_numpy(np.random.default_rng(2).random((1, 8, 8, 1), dtype=np.float32))
    assert resize_linear(x, (8, 8)) is x


# --- sampling and warping ------------------------------------------------

def test_bilinear_sample_matches():
    rng = np.random.default_rng(3)
    img = rng.random((2, 20, 28, 3), dtype=np.float32)
    # Query grid of another size, coordinates partly outside the frame.
    ys = rng.uniform(-3, 23, (2, 9, 11)).astype(np.float32)
    xs = rng.uniform(-3, 31, (2, 9, 11)).astype(np.float32)
    want = jflow.bilinear_sample(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    got = tflow.bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys),
                                torch.from_numpy(xs))
    # The same operations in the same order: float32 rounding at most.
    _close(got, want, atol=1e-6)


@pytest.mark.parametrize("c,scale", [(3, 3.0), (5, 9.0)], ids=["c3", "c5-large"])
def test_warp_by_flow_matches(c, scale):
    rng = np.random.default_rng(4)
    img = rng.random((2, 24, 32, c), dtype=np.float32)
    flow = ((rng.random((2, 24, 32, 2)) - 0.5) * scale).astype(np.float32)
    want = jflow.warp_by_flow(jnp.asarray(img), jnp.asarray(flow))
    got = tflow.warp_by_flow(torch.from_numpy(img), torch.from_numpy(flow))
    _close(got, want, atol=1e-6)


# --- polynomial expansion and flow ----------------------------------------

@pytest.mark.parametrize("n,sigma", [(5, 1.1), (7, 1.5)])
def test_poly_expansion_matches(n, sigma):
    gray = moving_frames(2, 24, 31, 1, 5)
    want = jflow.poly_expansion(jnp.asarray(gray), n, sigma)
    got = tflow.poly_expansion(torch.from_numpy(gray), n, sigma)
    for g, w, name in zip(got, want, ("A11", "A12", "A22", "b1", "b2")):
        assert tuple(g.shape) == (2, 24, 31, 1), name
        # Same taps in the same order; the 6x6 solve sums in another order.
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_poly_setup_is_the_references():
    for a, b in zip(tflow._poly_exp_setup(5, 1.1), jflow._poly_exp_setup(5, 1.1)):
        np.testing.assert_array_equal(a, b)


FLOW_CASES = [
    {},
    {"win_type": "box"},
    {"inner_warp": "pallas", "inner_max_disp": 2},
]
FLOW_IDS = ["gaussian", "box", "inner-pallas"]


@pytest.mark.parametrize("kw", FLOW_CASES, ids=FLOW_IDS)
def test_farneback_flow_matches(kw):
    gray = moving_frames(3, 32, 40, 1, 6)
    want = jflow.farneback_flow(jnp.asarray(gray[:-1]), jnp.asarray(gray[1:]),
                                levels=2, win_size=9, n_iters=2, **kw)
    got = tflow.farneback_flow(torch.from_numpy(gray[:-1]), torch.from_numpy(gray[1:]),
                               levels=2, win_size=9, n_iters=2, **kw)
    # 1e-4 px: the reference's own bar between two summation orders of
    # the same flow (tests/test_flow.py); measured ~1e-5 here.
    _close(got, want, atol=1e-4)
    # ... and it is a flow: the interior recovers the (0.8, -0.5) motion.
    inner = got[:, 8:-8, 8:-8].mean(dim=(0, 1, 2))
    assert abs(inner[0].item() - 0.8) < 0.15 and abs(inner[1].item() + 0.5) < 0.15


@pytest.mark.parametrize("kw", FLOW_CASES, ids=FLOW_IDS)
def test_farneback_flow_seq_matches(kw):
    gray = moving_frames(4, 32, 40, 1, 7)
    want = jflow.farneback_flow_seq(jnp.asarray(gray), levels=2, win_size=9,
                                    n_iters=2, **kw)
    got = tflow.farneback_flow_seq(torch.from_numpy(gray), levels=2, win_size=9,
                                   n_iters=2, **kw)
    _close(got, want, atol=1e-4)
    # The sequence form is the pairwise form with shared expansions.
    pair = tflow.farneback_flow(torch.from_numpy(gray[:-1]), torch.from_numpy(gray[1:]),
                                levels=2, win_size=9, n_iters=2, **kw)
    _close(got, pair.numpy(), atol=1e-6)


# --- box filter ------------------------------------------------------------

@pytest.mark.parametrize("win", [3, 9, 15])
def test_box_filter_matches(win):
    x = np.random.default_rng(5).random((2, 21, 34, 5), dtype=np.float32)
    want = jax_box_filter(jnp.asarray(x), win)
    got = box_filter(torch.from_numpy(x), win)
    # The reference's float32 scan drifts ~1e-6 here; the port sums in
    # float64 (measured 8.6e-7 apart at win 3).
    _close(got, want, atol=5e-6)


def test_box_filter_rejects_even_window():
    with pytest.raises(ValueError, match="odd"):
        box_filter(torch.zeros((1, 8, 8, 1)), 4)
    with pytest.raises(ValueError, match="odd"):
        dvf_tpu_torch.get_filter("box_blur", ksize=4, impl="cumsum")


def test_box_blur_cumsum_matches():
    x = np.random.default_rng(8).random((2, 20, 26, 3), dtype=np.float32)
    jf = dvf_tpu.get_filter("box_blur", ksize=5, impl="cumsum")
    tf = dvf_tpu_torch.get_filter("box_blur", ksize=5, impl="cumsum")
    assert tf.halo == jf.halo == 2
    want, _ = jf.fn(jnp.asarray(x), None)
    got, _ = tf.fn(torch.from_numpy(x), None)
    _close(got, want, atol=5e-6)
    # and it is the box blur the shifted FMAs compute
    shift, _ = dvf_tpu_torch.get_filter("box_blur", ksize=5).fn(torch.from_numpy(x), None)
    _close(got, shift.numpy(), atol=5e-6)


# --- stateful filters across batches ---------------------------------------

def _run_both(name, kw, batches):
    """Both packages' filter over the same batches, state carried."""
    jf = dvf_tpu.get_filter(name, **kw)
    tf = dvf_tpu_torch.get_filter(name, **kw)
    shape = batches[0].shape
    js = jf.init_state(shape, jnp.float32)
    ts = tf.init_state(shape, torch.float32, CPU)
    outs = []
    for x in batches:
        jo, js = jf.fn(jnp.asarray(x), js)
        to, ts = tf.fn(torch.from_numpy(x), ts)
        outs.append((to, np.asarray(jo)))
    return outs, ts


@pytest.mark.parametrize("warp_impl", ["gather", "pallas"])
@pytest.mark.parametrize("inner_warp", ["gather", "pallas"])
def test_flow_warp_two_batches_match(warp_impl, inner_warp):
    frames = moving_frames(8, 32, 40, 3, 9)
    kw = dict(levels=2, win_size=9, n_iters=2, max_disp=2,
              warp_impl=warp_impl, inner_warp=inner_warp)
    outs, state = _run_both("flow_warp", kw, [frames[:4], frames[4:]])
    # First batch: no previous frame yet, so it passes through exactly.
    np.testing.assert_array_equal(outs[0][0].numpy(), frames[:4])
    np.testing.assert_array_equal(outs[0][1], frames[:4])
    # Second batch: warped in both, within 1e-5 (measured 5e-7; 1/255 is
    # one uint8 step).
    _close(outs[1][0], outs[1][1], atol=1e-5)
    assert not np.array_equal(outs[1][0].numpy(), frames[4:])
    assert state["initialized"].dtype == torch.bool and bool(state["initialized"])
    np.testing.assert_array_equal(state["prev"].numpy(), frames[7])


def test_flow_warp_defaults_to_the_kernel_and_validates():
    f = dvf_tpu_torch.get_filter("flow_warp")
    assert "warp=pallas" in f.name and f.stateful and f.pad_safe
    assert "pallas-inner" in dvf_tpu_torch.get_filter("flow_warp", inner_warp="pallas").name
    for bad in ({"warp_impl": "scatter"}, {"inner_warp": "scatter"},
                {"win_type": "median"}, {"win_type": "box", "win_size": 4}):
        with pytest.raises(ValueError):
            dvf_tpu_torch.get_filter("flow_warp", **bad)


def test_flow_vis_two_batches_match():
    frames = moving_frames(8, 32, 40, 3, 10)
    outs, _ = _run_both("flow_vis", dict(levels=2, win_size=9, n_iters=2),
                        [frames[:4], frames[4:]])
    for got, want in outs:
        # HSV of flows that agree to ~1e-5 px (measured 1.7e-5 after the
        # hue/value arithmetic).
        _close(got, want, atol=1e-4)


def test_flow_to_rgb_sectors():
    """One flow per hue sector (and zero): the six HSV branches."""
    ang = np.deg2rad(np.array([-150, -90, -30, 30, 90, 150, 0], np.float64))
    mag = np.array([4, 4, 4, 4, 4, 4, 0], np.float64)
    flow = np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1).astype(np.float32)
    flow = flow.reshape(1, 1, 7, 2)
    rgb = tflow.flow_to_rgb(torch.from_numpy(flow), 8.0).numpy()[0, 0]
    assert rgb.shape == (7, 3)
    np.testing.assert_allclose(rgb.max(axis=1)[:6], 0.5, atol=1e-6)  # V = 4/8
    np.testing.assert_array_equal(rgb[6], 0.0)
    assert len({tuple(np.round(c, 3)) for c in rgb[:6]}) == 6


def test_ema_smooth_across_batches_with_repeats():
    frames = moving_frames(8, 16, 20, 3, 11)
    frames[3] = frames[2]        # a repeat inside a batch
    frames[4] = frames[3]        # ... and across the batch boundary
    outs, state = _run_both("ema_smooth", {"alpha": 0.3}, [frames[:4], frames[4:]])
    for got, want in outs:
        # A loop against the reference's associative scan: float32
        # rounding (measured 1.2e-7).
        _close(got, want, atol=1e-6)
    first, second = outs[0][0].numpy(), outs[1][0].numpy()
    np.testing.assert_array_equal(first[3], first[2])     # repeat = no-op
    np.testing.assert_array_equal(second[0], first[3])
    np.testing.assert_array_equal(state["ema"].numpy(), second[3])
    np.testing.assert_allclose(first[0], frames[0], atol=1e-7)  # seeded


def test_ema_smooth_validates_alpha():
    with pytest.raises(ValueError):
        dvf_tpu_torch.get_filter("ema_smooth", alpha=0.0)


# --- engine ----------------------------------------------------------------

def test_engine_reset_state_starts_a_new_stream():
    frames = (moving_frames(8, 24, 32, 3, 12) * 255).round().astype(np.uint8)
    eng = Engine(dvf_tpu_torch.get_filter("flow_warp", levels=1, win_size=7,
                                          n_iters=1, max_disp=2), device="cpu")
    first = eng.submit(frames[:4]).fetch().copy()
    np.testing.assert_array_equal(first, frames[:4])       # passthrough
    second = eng.submit(frames[4:]).fetch().copy()
    assert not np.array_equal(second, frames[4:])           # warped
    eng.reset_state()
    again = eng.submit(frames[4:]).fetch()
    np.testing.assert_array_equal(again, frames[4:])       # passthrough again
    assert eng.stats.compile_count == 1


def test_engine_free_refuses_further_work():
    eng = Engine(dvf_tpu_torch.get_filter("ema_smooth"), device="cpu")
    x = np.zeros((2, 8, 8, 3), np.uint8)
    eng.submit(x).fetch()
    eng.free()
    eng.free()                                   # idempotent
    with pytest.raises(RuntimeError, match="freed"):
        eng.submit(x)
    with pytest.raises(RuntimeError, match="freed"):
        eng.reset_state()
