"""The port's trained checkpoints and their loaders against the JAX
package's.

The committed ``dvf_tpu_torch/checkpoints/<name>/final/params.npz`` are the
JAX package's in-repo orbax checkpoints (``checkpoints/<name>``), params
only: they must equal what ``dvf_tpu.train.checkpoint.load_params``
restores, array for array. ``sr2x_64`` also carries its whole train state
(``final/state.npz``: the Adam moments and count, the step), equal to the
orbax state ``restore_sr_checkpoint`` restores. Regenerate them with
``JAX_PLATFORMS=cpu python tests/test_torch_checkpoint.py``.

It also holds the port's checkpoint writer and its resume to the
reference's tests/test_checkpoint.py.

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
FULL_STATE = ["sr2x_64"]   # committed with its train state (0.2 MB)
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


def reference_sr_state(name):
    """The whole SrTrainState of the JAX package's orbax checkpoint, as
    numpy (optax's Adam state included)."""
    import jax

    from dvf_tpu.train.checkpoint import resolve_checkpoint_dir, restore_sr_checkpoint
    from dvf_tpu.train.sr import SrTrainConfig, init_train_state

    final = resolve_checkpoint_dir(str(ROOT / "checkpoints" / name), "sr", "train-sr")
    template = init_train_state(jax.random.PRNGKey(0), SrTrainConfig())
    return jax.device_get(restore_sr_checkpoint(final, template))


def convert(name, tmp_dir):
    """Write the port's form of ``checkpoints/<name>``: its config.json
    copied verbatim, its params as ``final/params.npz`` and, for the
    FULL_STATE names, the rest of its train state as ``final/state.npz``
    (through ``convert.train_state_from_jax`` and the port's writer)."""
    dst = pathlib.Path(tc.CHECKPOINT_ROOT) / name
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(ROOT / "checkpoints" / name / "config.json", dst / "config.json")
    tc.save_params(str(dst / "final"), reference_params(name))
    if name in FULL_STATE:
        from dvf_tpu_torch.convert import train_state_from_jax
        from dvf_tpu_torch.train.sr import SrTrainConfig

        state = train_state_from_jax(reference_sr_state(name), SrTrainConfig(), "cpu")
        written = tc.save_checkpoint(os.path.join(tmp_dir, name), state)
        shutil.copyfile(os.path.join(written, tc.STATE_FILE),
                        dst / "final" / tc.STATE_FILE)
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
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for n in NAMES:
            print(convert(n, tmp))


# ---------------------------------------------------------------------------
# The committed SR train state, and the writer / resume against the
# reference's tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_committed_sr_state_equals_orbax_checkpoint():
    """``sr2x_64/final/state.npz`` holds the orbax state's Adam moments,
    count and step exactly, under the port's keys, and nothing else."""
    from dvf_tpu_torch.train import optim

    ref = reference_sr_state("sr2x_64")
    adam = ref.opt_state[0]
    with np.load(os.path.join(tc.CHECKPOINT_ROOT, "sr2x_64", "final", tc.STATE_FILE)) as z:
        got = {k: np.array(z[k]) for k in z.files}
    mu, nu = optim.flatten(adam.mu), optim.flatten(adam.nu)
    assert sorted(got) == sorted([f"opt/mu/{k}" for k in mu] + [f"opt/nu/{k}" for k in nu]
                                 + ["opt/count", "step"])
    for k in mu:
        np.testing.assert_array_equal(got[f"opt/mu/{k}"], np.asarray(mu[k]), err_msg=k)
        np.testing.assert_array_equal(got[f"opt/nu/{k}"], np.asarray(nu[k]), err_msg=k)
    assert int(got["opt/count"]) == int(adam.count) == 6000
    assert int(got["step"]) == int(ref.step) == 6000
    assert got["step"].dtype == got["opt/count"].dtype == np.int32


def test_committed_sr_state_resumes_where_the_reference_stopped():
    """Restored onto a fresh template, the committed state is the orbax
    state carried across by ``convert.train_state_from_jax``: step 6000,
    params and both moments bitwise."""
    from dvf_tpu_torch.convert import train_state_from_jax
    from dvf_tpu_torch.train import optim
    from dvf_tpu_torch.train.sr import SrTrainConfig, init_train_state

    cfg = SrTrainConfig()
    got = tc.restore_sr_checkpoint(os.path.join(tc.CHECKPOINT_ROOT, "sr2x_64", "final"),
                                   init_train_state(1, cfg, device="cpu"))
    want = train_state_from_jax(reference_sr_state("sr2x_64"), cfg, "cpu")
    assert int(got.step) == int(want.step) == 6000
    _states_equal(got, want)


def _tiny_style():
    from dvf_tpu_torch.models import StyleNetConfig
    from dvf_tpu_torch.models.vgg import VGGConfig
    from dvf_tpu_torch.train import StyleTrainConfig

    return StyleTrainConfig(net=StyleNetConfig(base_channels=8, n_residual=2),
                            vgg=VGGConfig(blocks=((1, 8), (1, 16))))


def _fresh_state(seed=0):
    from dvf_tpu_torch.train import init_train_state

    return init_train_state(seed, np.full((1, 32, 32, 3), 0.25, np.float32),
                            _tiny_style(), device="cpu")


def _fresh_sr(seed=0):
    from dvf_tpu_torch.train.sr import SrTrainConfig, init_train_state

    return init_train_state(seed, SrTrainConfig(), device="cpu")


def _states_equal(a, b):
    """Every field of two train states bitwise equal (dtypes included)."""
    from dvf_tpu_torch.train import optim

    assert type(a) is type(b)
    ca, mua, nua = optim.adam_state(a.opt_state, a.params)
    cb, mub, nub = optim.adam_state(b.opt_state, b.params)
    assert ca == cb and int(a.step) == int(b.step) and a.step.dtype == b.step.dtype
    pairs = [(optim.flatten(optim.whole(a.params)), optim.flatten(optim.whole(b.params))),
             (mua, mub), (nua, nub)]
    if hasattr(a, "vgg_params"):
        pairs.append((optim.flatten(optim.whole(a.vgg_params)),
                      optim.flatten(optim.whole(b.vgg_params))))
        pairs.append((dict(enumerate(a.style_grams)), dict(enumerate(b.style_grams))))
    for x, y in pairs:
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k].detach(), y[k].detach()), k


@pytest.mark.parametrize("family", ["style", "sr"])
def test_checkpoint_roundtrip(tmp_path, family):
    """Save, restore onto a template from another seed: every field
    bitwise, the params leaves requiring grad again, and the restored
    optimizer stepping them."""
    fresh = _fresh_state if family == "style" else _fresh_sr
    restore = tc.restore_checkpoint if family == "style" else tc.restore_sr_checkpoint
    state = fresh()
    path = tc.save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = restore(path, fresh(seed=99))
    _states_equal(state, restored)
    from dvf_tpu_torch.train import optim

    leaves = list(optim.flatten(restored.params).values())
    assert all(t.requires_grad for t in leaves)
    assert restored.opt_state.param_groups[0]["params"] == leaves
    # the inference loader reads the same checkpoint unchanged
    params = tc.load_params(path)
    for k, v in optim.flatten(params).items():
        assert torch.equal(v, optim.flatten(state.params)[k].detach())


def test_resume_training_continues_from_step(tmp_path):
    """Train 2 steps → checkpoint → restore onto a fresh template → the
    next step counts from 3 and equals the uninterrupted run's third step
    bitwise (the same ops on the same CPU)."""
    from dvf_tpu_torch.train import make_train_step

    cfg = _tiny_style()
    batch = torch.full((2, 64, 64, 3), 0.5)
    state = _fresh_state()
    step_fn = make_train_step(None, cfg, state_template=state, donate=False)
    for _ in range(2):
        state, _ = step_fn(state, batch)
    path = tc.save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = tc.restore_checkpoint(path, _fresh_state(seed=7))
    assert int(restored.step) == 2
    _states_equal(state, restored)
    state3, m = step_fn(state, batch)
    resumed3, m_r = step_fn(restored, batch)
    assert int(resumed3.step) == int(state3.step) == 3
    assert np.isfinite(float(m_r["loss"])) and torch.equal(m["loss"], m_r["loss"])
    _states_equal(state3, resumed3)


def test_restore_refuses_a_mesh_and_mismatched_keys(tmp_path):
    """A mesh is taken (the state placed on it per ``state_pspecs``, the
    same state whole); mismatched keys and a missing file are refused."""
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from dvf_tpu_torch.train import optim

    state = _fresh_sr()
    path = tc.save_checkpoint(str(tmp_path / "ckpt"), state)
    mesh = make_mesh(MeshConfig(model=2), devices=[torch.device("cpu")] * 2)
    placed = tc.restore_sr_checkpoint(path, state, mesh=mesh)
    assert isinstance(placed.params, optim.MeshParams) and placed.params.mesh == mesh
    _states_equal(state, placed)
    with pytest.raises(KeyError, match="missing"):   # an SR state onto a style template
        tc.restore_checkpoint(path, _fresh_state())
    rest = dict(np.load(os.path.join(path, tc.STATE_FILE)))
    rest["opt/extra"] = np.zeros(1, np.float32)
    np.savez(os.path.join(path, tc.STATE_FILE), **rest)
    with pytest.raises(KeyError, match="extra"):
        tc.restore_sr_checkpoint(path, state)
    shutil.rmtree(path)
    with pytest.raises(FileNotFoundError, match="params.npz"):
        tc.restore_sr_checkpoint(path, state, mesh=mesh)
    assert optim.adam_state(state.opt_state, state.params)[0] == 0


def test_save_overwrites_and_leaves_no_staging_dirs(tmp_path):
    """Re-writing ``final`` (a resumed run) replaces it whole, and no
    temporary or moved-aside directory is left behind."""
    a, b = _fresh_sr(0), _fresh_sr(1)
    final = str(tmp_path / "final")
    tc.save_checkpoint(final, a)
    tc.save_checkpoint(final, b)
    _states_equal(tc.restore_sr_checkpoint(final, _fresh_sr(2)), b)
    assert sorted(os.listdir(tmp_path)) == ["final"]
    assert sorted(os.listdir(final)) == [tc.PARAMS_FILE, tc.STATE_FILE]


def test_async_saver_roundtrip(tmp_path):
    """AsyncSaver's writes are durable and restorable after close(), and
    each holds the state as it was at its save(), though the loop steps
    the same tensors in place right after."""
    from dvf_tpu_torch.train.sr import SrTrainConfig, make_train_step

    state = _fresh_sr()
    step = make_train_step(None, SrTrainConfig(), state_template=state)
    hr = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    saver = tc.AsyncSaver()
    p1 = str(tmp_path / "step_000001")
    p2 = str(tmp_path / "step_000002")
    state, _ = step(state, hr)
    want1 = tc._snapshot(state)
    saver.save(p1, state)
    state, _ = step(state, hr)
    saver.save(p2, state)  # waits for p1 first: one in-flight write at most
    want2 = tc._snapshot(state)
    saver.close()
    for p, want in ((p1, want1), (p2, want2)):
        params = tc.load_params(p)
        np.testing.assert_array_equal(params["feat"]["w"].numpy(), want[0]["feat/w"])
        got = tc.restore_sr_checkpoint(p, _fresh_sr(5))
        assert int(got.step) == int(want[1]["step"])


def test_async_saver_close_reraises_the_write_error(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    saver = tc.AsyncSaver()
    saver.save(str(blocker / "step_000001"), _fresh_sr())
    with pytest.raises(OSError):
        saver.close()


def test_resume_fallback_ignores_staging_dirs(tmp_path):
    """A torn write, the port's own staging directory or orbax's
    ``*.orbax-checkpoint-tmp``, is never picked as the newest step."""
    good = tmp_path / "step_000002"
    tc.save_checkpoint(str(good), _fresh_sr())
    (tmp_path / ".step_000009.x1y2z3.tmp").mkdir()   # the port's staging dir
    (tmp_path / ".step_000009.0123abcd.old").mkdir()  # a target moved aside
    (tmp_path / "step_000009.orbax-checkpoint-tmp").mkdir()
    picked = tc.resolve_checkpoint_dir(str(tmp_path), "sr", "train-sr")
    assert picked == str(good)
