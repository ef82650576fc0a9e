"""The port's trained checkpoints and their loaders against the JAX
package's.

The committed ``dvf_tpu_torch/checkpoints/<name>/final/params.npz`` are the
JAX package's in-repo orbax checkpoints (``checkpoints/<name>``), params
only: they must equal what ``dvf_tpu.train.checkpoint.load_params``
restores, array for array. Regenerate them with
``JAX_PLATFORMS=cpu python tests/test_torch_checkpoint.py``.

The port's loaders must reproduce the reference's goldens at the
reference's own bar (``tests/test_style_demo.py``, ``tests/test_sr_demo.py``)
and fail where the reference's fail, with its messages.
"""

import json
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from dvf_tpu_torch.train import checkpoint as tc  # noqa: E402

NAMES = ["style_stripes_64", "style_stripes_256", "sr2x_64", "sr2x_128"]
GOLDEN = ROOT / "tests" / "golden"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def reference_params(name):
    """The params of the JAX package's orbax checkpoint, as numpy."""
    from dvf_tpu.train.checkpoint import load_params, resolve_checkpoint_dir

    final = resolve_checkpoint_dir(str(ROOT / "checkpoints" / name), "ckpt", "train")
    return load_params(final)


def convert(name):
    """Write the port's form of ``checkpoints/<name>``: its config.json
    copied verbatim and its params as ``final/params.npz``."""
    dst = pathlib.Path(tc.CHECKPOINT_ROOT) / name
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(ROOT / "checkpoints" / name / "config.json", dst / "config.json")
    tc.save_params(str(dst / "final"), reference_params(name))
    return dst


@pytest.mark.parametrize("name", NAMES)
def test_committed_params_equal_orbax_checkpoint(name):
    want = _flat(reference_params(name))
    got = _flat(tc.load_params(os.path.join(tc.CHECKPOINT_ROOT, name, "final")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(ROOT / "checkpoints" / name / "config.json") as a, \
            open(os.path.join(tc.CHECKPOINT_ROOT, name, "config.json")) as b:
        assert json.load(a) == json.load(b)


def _style_out(filt, frames):
    x = torch.from_numpy(np.stack(frames)).float() / 255.0
    with torch.no_grad():
        out, _ = filt.fn(x, filt.init_state(x.shape, torch.float32,
                                             torch.device("cpu")))
    return (torch.clamp(out, 0, 1).numpy() * 255).astype(np.uint8)


def test_style_loader_reproduces_golden():
    """tests/test_style_demo.py's golden frame through the port's loader:
    the same input, the same bar (mean < 2.0, max <= 30)."""
    from dvf_tpu_torch.io.sources import SyntheticSource

    filt = tc.load_style_filter(os.path.join(tc.CHECKPOINT_ROOT, "style_stripes_64"))
    assert filt.name == "style_transfer(c=8,r=2,tp)"
    frames = [f for f, _ in SyntheticSource(height=64, width=64, n_frames=4)][:4]
    out = _style_out(filt, frames)
    diff = np.abs(out[0].astype(int) - np.load(GOLDEN / "style_demo_out.npy").astype(int))
    assert diff.mean() < 2.0 and diff.max() <= 30, (diff.mean(), diff.max())


def test_sr_loader_reproduces_golden():
    """tests/test_sr_demo.py's golden frame: the held-out 80x80 draws of
    seed 12345, area-downscaled, through the port's loader."""
    from dvf_tpu_torch.train.sr import downscale_area, synthesize_structured_batch

    filt = tc.load_sr_filter(os.path.join(tc.CHECKPOINT_ROOT, "sr2x_64"))
    hr = torch.from_numpy(synthesize_structured_batch(
        np.random.default_rng(12345), 8, 80)).float() / 255.0
    lr = downscale_area(hr, 2)
    with torch.no_grad():
        out, _ = filt.fn(lr, filt.init_state(lr.shape, torch.float32,
                                             torch.device("cpu")))
    got = (torch.clamp(out, 0, 1)[0].numpy() * 255).astype(np.uint8)
    diff = np.abs(got.astype(int) - np.load(GOLDEN / "sr_demo_out.npy").astype(int))
    assert diff.mean() < 2.0 and diff.max() <= 30, (diff.mean(), diff.max())


def test_sr_data_helpers_match_reference():
    import jax.numpy as jnp

    from dvf_tpu.train.sr import downscale_area as jax_downscale
    from dvf_tpu.train.sr import synthesize_structured_batch as jax_synth
    from dvf_tpu_torch.train.sr import downscale_area, synthesize_structured_batch

    a = synthesize_structured_batch(np.random.default_rng(7), 3, 40)
    b = jax_synth(np.random.default_rng(7), 3, 40)
    np.testing.assert_array_equal(a, b)
    x = a.astype(np.float32) / 255.0
    np.testing.assert_allclose(downscale_area(torch.from_numpy(x), 2).numpy(),
                               np.asarray(jax_downscale(jnp.asarray(x), 2)),
                               atol=1e-7, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        downscale_area(torch.zeros(1, 5, 4, 3), 2)


@pytest.mark.parametrize("layout", ["final", "steps", "staging-only", "empty",
                                    "missing"])
def test_resolve_checkpoint_dir_matches_reference(tmp_path, layout):
    """The same fallback (final, else the newest step_* by number, never a
    staging dir) and the same errors as the reference."""
    from dvf_tpu.train.checkpoint import resolve_checkpoint_dir as ref

    d = tmp_path / "ck"
    if layout != "missing":
        d.mkdir()
    if layout == "final":
        (d / "final").mkdir()
        (d / "step_000100").mkdir()
    elif layout == "steps":
        for s in ("step_999999", "step_1000000", "step_5"):
            (d / s).mkdir()
        (d / "step_2000000.orbax-checkpoint-tmp").mkdir()
    elif layout == "staging-only":
        (d / "step_000010.orbax-checkpoint-tmp").mkdir()
    try:
        want = ref(str(d), "style", "train")
    except FileNotFoundError as e:
        with pytest.raises(FileNotFoundError) as got:
            tc.resolve_checkpoint_dir(str(d), "style", "train")
        assert str(got.value) == str(e)
        return
    assert tc.resolve_checkpoint_dir(str(d), "style", "train") == want


@pytest.mark.parametrize("sidecar", [None, "{not json", {"base_channels": 8}])
def test_read_sidecar_errors_match_reference(tmp_path, sidecar):
    from dvf_tpu.train.checkpoint import _read_sidecar as ref

    if sidecar is not None:
        (tmp_path / "config.json").write_text(
            sidecar if isinstance(sidecar, str) else json.dumps(sidecar))
    req = ("base_channels", "n_residual")
    with pytest.raises((FileNotFoundError, ValueError)) as want:
        ref(str(tmp_path), req)
    with pytest.raises(type(want.value)) as got:
        tc._read_sidecar(str(tmp_path), req)
    assert str(got.value) == str(want.value)


def test_load_params_refuses_an_orbax_checkpoint():
    """The JAX package's own directory has no params.npz: the loader says
    how to convert it instead of guessing."""
    final = ROOT / "checkpoints" / "sr2x_64" / "final"
    with pytest.raises(FileNotFoundError, match="params.npz"):
        tc.load_params(str(final))


def test_save_and_load_params_round_trip(tmp_path):
    params = {"a": {"w": torch.arange(6.0).reshape(2, 3), "b": np.ones(3, np.float32)}}
    tc.save_params(str(tmp_path / "final"), params)
    back = tc.load_params(str(tmp_path / "final"))
    assert sorted(back) == ["a"] and sorted(back["a"]) == ["b", "w"]
    assert torch.equal(back["a"]["w"], params["a"]["w"])
    assert torch.equal(back["a"]["b"], torch.ones(3))


if __name__ == "__main__":
    for n in NAMES:
        print(convert(n))
