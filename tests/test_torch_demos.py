"""The trained style and super-resolution demonstrations through the
port's ``.npz`` loaders (counterpart of ``tests/test_style_demo.py``,
``test_style_demo_256.py``, ``test_sr_demo.py`` and ``test_sr_demo_128.py``).

The held-out quality bars and the committed goldens are the reference's;
each output is also held to the JAX package's output of the same
checkpoint on the same input (mean < 1, max <= 8 of 255: float
reassociation between the two frameworks' convolutions, not behaviour).
The reference files' CLI-eval and style-preset cases are in
tests/test_torch_cli.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from dvf_tpu_torch.io.sources import SyntheticSource
from dvf_tpu_torch.models.layers import upsample_nearest
from dvf_tpu_torch.train.checkpoint import (CHECKPOINT_ROOT, load_sr_filter,
                                            load_style_filter)
from dvf_tpu_torch.train.sr import downscale_area, synthesize_structured_batch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
JAX_CKPT = os.path.join(HERE, "..", "checkpoints")


def _run(filt, x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(x)
    with torch.no_grad():
        out, _ = filt.fn(t, filt.init_state(t.shape, torch.float32,
                                            torch.device("cpu")))
    return torch.clamp(out, 0, 1).numpy()


def _jax_run(loader_name: str, name: str, x: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    import dvf_tpu.train.checkpoint as jc

    filt = getattr(jc, loader_name)(os.path.join(JAX_CKPT, name))
    xj = jnp.asarray(x)
    out, _ = filt.fn(xj, filt.init_state(xj.shape, np.float32))
    return np.asarray(jnp.clip(out, 0, 1))


def _near_jax(got: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(np.round(got * 255).astype(int) - np.round(want * 255).astype(int))
    assert d.mean() < 1.0 and d.max() <= 8, (d.mean(), d.max())


def _psnr(a, b):
    return -10.0 * np.log10(float(np.mean((a - b) ** 2)) + 1e-12)


# ------------------------------------------------------------ style, 64 px

@pytest.fixture(scope="module")
def stylized():
    frames = [f for f, _ in SyntheticSource(height=64, width=64, n_frames=4)][:4]
    x = np.stack(frames).astype(np.float32) / 255.0
    filt = load_style_filter(os.path.join(CHECKPOINT_ROOT, "style_stripes_64"))
    return x, _run(filt, x)


def test_stylized_differs_structurally_from_input(stylized):
    x, o = stylized
    o = (o * 255).astype(np.uint8).astype(np.float32) / 255.0
    corr = np.corrcoef(o.ravel(), x.ravel())[0, 1]
    assert corr < 0.7, f"output too close to input (corr={corr:.3f})"
    sat = np.abs(o - o.mean(-1, keepdims=True)).mean()
    assert sat > 0.10, f"output is desaturated (sat={sat:.3f}) — not stylized"


def test_stylized_matches_committed_golden_and_jax(stylized):
    x, o = stylized
    out = (o * 255).astype(np.uint8)
    golden = np.load(os.path.join(GOLDEN, "style_demo_out.npy"))
    diff = np.abs(out[0].astype(int) - golden.astype(int))
    assert diff.mean() < 2.0 and diff.max() <= 30, (diff.mean(), diff.max())
    _near_jax(o, _jax_run("load_style_filter", "style_stripes_64", x))


# ----------------------------------------------------------- style, 256 px

CKPT_256 = os.path.join(CHECKPOINT_ROOT, "style_stripes_256")


@pytest.fixture(scope="module")
def stylized_256():
    frames = [f for f, _ in SyntheticSource(height=256, width=256, n_frames=3)
              if f is not None][:2]
    x = np.stack(frames).astype(np.float32) / 255.0
    return x, _run(load_style_filter(CKPT_256), x)


def test_256_checkpoint_stylizes_visibly(stylized_256):
    x, o = stylized_256
    corr = np.corrcoef(o.ravel(), x.ravel())[0, 1]
    assert corr < 0.7, f"output too close to input (corr={corr:.3f})"
    sat = np.abs(o - o.mean(-1, keepdims=True)).mean()
    assert sat > 0.10, f"output is desaturated (sat={sat:.3f}) — not stylized"
    _near_jax(o, _jax_run("load_style_filter", "style_stripes_256", x))


def test_256_checkpoint_trained_at_large_geometry():
    with open(os.path.join(CKPT_256, "config.json")) as f:
        assert json.load(f)["size"] >= 256


# --------------------------------------------------------------- SR, 64 px

def _sr_eval(name: str, seed: int, n: int, size: int):
    """Held-out draws (a seed the trainer never derives, at a geometry it
    never saw), area-downscaled, through the port's loader."""
    hr = synthesize_structured_batch(np.random.default_rng(seed), n, size)
    hr = hr.astype(np.float32) / 255.0
    lr = downscale_area(torch.from_numpy(hr), 2).numpy()
    out = _run(load_sr_filter(os.path.join(CHECKPOINT_ROOT, name)), lr)
    near = upsample_nearest(torch.from_numpy(lr), 2).numpy()
    return hr, lr, out, near


@pytest.fixture(scope="module")
def sr_eval():
    return _sr_eval("sr2x_64", 12345, 8, 80)


def test_sr_beats_nearest_baseline(sr_eval):
    hr, _, out, near = sr_eval
    p_sr, p_near = _psnr(out, hr), _psnr(near, hr)
    assert p_sr > p_near + 2.5, (
        f"SR ({p_sr:.2f} dB) does not clearly beat nearest ({p_near:.2f} dB)")


def test_sr_matches_committed_golden_and_jax(sr_eval):
    _, lr, out, _ = sr_eval
    got = (out[0] * 255).astype(np.uint8)
    golden = np.load(os.path.join(GOLDEN, "sr_demo_out.npy"))
    diff = np.abs(got.astype(int) - golden.astype(int))
    assert diff.mean() < 2.0 and diff.max() <= 30, (diff.mean(), diff.max())
    _near_jax(out, _jax_run("load_sr_filter", "sr2x_64", lr))


def test_structured_texture_deterministic_and_distinct():
    """The port's structured source texture is the JAX package's, byte
    for byte."""
    from dvf_tpu.io.sources import SyntheticSource as JaxSyntheticSource

    fa = [f for f, _ in SyntheticSource(height=32, width=32, n_frames=4,
                                        texture="structured")]
    fb = [f for f, _ in SyntheticSource(height=32, width=32, n_frames=4,
                                        texture="structured")]
    fj = [f for f, _ in JaxSyntheticSource(height=32, width=32, n_frames=4,
                                           texture="structured")]
    for x, y, z in zip(fa, fb, fj):
        if x is None:
            assert y is None and z is None
            continue
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    noise = next(iter(SyntheticSource(height=32, width=32, n_frames=1)))[0]
    assert not np.array_equal(fa[0], noise)
    with pytest.raises(ValueError, match="texture"):
        SyntheticSource(height=8, width=8, texture="fractal")


# -------------------------------------------------------------- SR, 128 px

def test_sr128_beats_nearest_baseline():
    hr, lr, out, near = _sr_eval("sr2x_128", 54321, 6, 96)
    p_sr, p_near = _psnr(out, hr), _psnr(near, hr)
    assert p_sr > p_near + 2.5, (
        f"SR ({p_sr:.2f} dB) does not clearly beat nearest ({p_near:.2f} dB)")
    _near_jax(out, _jax_run("load_sr_filter", "sr2x_128", lr))


# -- serve --style-checkpoint / --sr-checkpoint (the port's .npz checkpoints)


def _serve_checkpoint(flag: str, name: str, size: int, frames: int,
                      batch: int, capsys) -> dict:
    from dvf_tpu_torch.cli import main

    rc = main([
        "serve", flag, os.path.join(CHECKPOINT_ROOT, name),
        "--source", "synthetic", "--height", str(size), "--width", str(size),
        "--frames", str(frames), "--batch", str(batch), "--frame-delay", "0",
        "--queue-size", "64", "--platform", "cpu",
    ])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_loads_style_checkpoint(capsys):
    stats = _serve_checkpoint("--style-checkpoint", "style_stripes_64", 64,
                              8, 4, capsys)
    assert stats["delivered"] == 8


def test_serve_loads_256_checkpoint(capsys):
    stats = _serve_checkpoint("--style-checkpoint", "style_stripes_256", 128,
                              4, 2, capsys)
    assert stats["delivered"] == 4


@pytest.mark.parametrize("name", ["sr2x_64", "sr2x_128"])
def test_serve_loads_sr_checkpoint(capsys, name):
    stats = _serve_checkpoint("--sr-checkpoint", name, 64, 8, 4, capsys)
    assert stats["delivered"] == 8


def test_serve_checkpoint_flags_fail_cleanly(tmp_path, capsys):
    """Both flags at once, or a path with no checkpoint: rc 2 and one
    error line, as the reference answers."""
    from dvf_tpu_torch.cli import main

    ckpt = os.path.join(CHECKPOINT_ROOT, "style_stripes_64")
    assert main(["serve", "--style-checkpoint", ckpt, "--sr-checkpoint", ckpt,
                 "--platform", "cpu"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err
    assert main(["serve", "--style-checkpoint", str(tmp_path / "absent"),
                 "--platform", "cpu"]) == 2
    assert "does not exist" in capsys.readouterr().err
