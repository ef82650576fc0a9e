"""The port's sharded train state held to the JAX package's on the CPU.

The reference runs on its 8 fake CPU devices (tests/conftest.py), the port
on a virtual mesh of 8 CPU entries; the weights cross with
``convert.train_state_from_jax``. The counterparts of tests/test_train.py's
two sharded cases and two ``__graft_entry__`` cases and of
tests/test_checkpoint.py's resume case, then the port's own contract:
the gradient of the sharded step is the one-device gradient, every copy
of a block holds the same bits, checkpoints are saved whole.

Tolerances, stated per test: against JAX's sharded step the reference's
own bar (loss 5e-3 relative, params after one step 5e-3 absolute); Adam's
first moment against the one-device step at float32 compute 1e-4 relative
L2 per leaf, bar the conv biases an instance norm follows (their exact
gradient is zero), held below 1e-6 of the net's largest moment.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvf_tpu.models import StyleNetConfig as JaxNet
from dvf_tpu.models.espcn import EspcnConfig as JaxEspcn
from dvf_tpu.models.vgg import VGGConfig as JaxVGG
from dvf_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from dvf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from dvf_tpu.train import sr as jsr
from dvf_tpu.train import style as jst
from dvf_tpu_torch.convert import train_state_from_jax
from dvf_tpu_torch.models import EspcnConfig, StyleNetConfig
from dvf_tpu_torch.models.vgg import VGGConfig
from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from dvf_tpu_torch.parallel.sharded import collective, lockstep
from dvf_tpu_torch.train import SrTrainConfig, StyleTrainConfig, optim
from dvf_tpu_torch.train import checkpoint as tc
from dvf_tpu_torch.train import sr as tsr
from dvf_tpu_torch.train import style as tst

CPU = torch.device("cpu")
AXES = dict(data=2, space=2, model=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# Conv biases an instance norm follows (their exact gradient is zero).
PRE_NORM_BIASES = {"stem/b", "down1/b", "down2/b", "res0_a/b", "res0_b/b",
                   "res0_bn/bias", "up1/b", "up2/b"}


def port_mesh(devices=None, **axes):
    cfg = MeshConfig(**(axes or AXES))
    return make_mesh(cfg, devices=devices or [CPU] * cfg.n_devices)


def distinct_mesh(**axes):
    """A mesh whose positions are distinct CPU devices (``cpu:i``): every
    replicated block is held once per position, as on distinct cards."""
    cfg = MeshConfig(**(axes or AXES))
    return port_mesh([torch.device("cpu", i) for i in range(cfg.n_devices)], **axes)


def _style_configs(dtype):
    jd, td = DTYPES[dtype]
    return (jst.StyleTrainConfig(net=JaxNet(base_channels=8, n_residual=1, compute_dtype=jd),
                                 vgg=JaxVGG(blocks=((1, 8), (1, 16)), compute_dtype=jd)),
            StyleTrainConfig(net=StyleNetConfig(base_channels=8, n_residual=1, compute_dtype=td),
                             vgg=VGGConfig(blocks=((1, 8), (1, 16)), compute_dtype=td)))


def _sr_configs(dtype):
    jd, td = DTYPES[dtype]
    return (jsr.SrTrainConfig(net=JaxEspcn(compute_dtype=jd)),
            SrTrainConfig(net=EspcnConfig(compute_dtype=td)))


FAMILIES = {
    "style": dict(configs=_style_configs, ref=jst, port=tst,
                  init=lambda mod, key, cfg: mod.init_train_state(
                      key, jnp.full((1, 32, 32, 3), 0.25, jnp.float32), cfg)),
    "sr": dict(configs=_sr_configs, ref=jsr, port=tsr,
               init=lambda mod, key, cfg: mod.init_train_state(key, cfg)),
}


def _batch(seed=4):
    return np.random.default_rng(seed).random((4, 32, 32, 3), dtype=np.float32)


def _ref_step(family, dtype, axes):
    """The reference's one step on a mesh of ``axes`` (a one-device mesh
    for {}): (loss, params, first moments), as numpy, keyed by path."""
    fam = FAMILIES[family]
    ref_cfg, _ = fam["configs"](dtype)
    mod = fam["ref"]
    mesh = ref_make_mesh(RefMeshConfig(**axes))
    state = mod.shard_train_state(fam["init"](mod, jax.random.PRNGKey(0), ref_cfg),
                                  mesh, ref_cfg)
    step = mod.make_train_step(mesh, ref_cfg, state_template=state, donate=False)
    state, m = step(state, jax.device_put(_batch(), mod.train_batch_sharding(mesh)))
    state = jax.device_get(state)
    return (float(m["loss"]), optim.flatten(state.params),
            optim.flatten(state.opt_state[0].mu))


def _port_start(family, dtype):
    """The reference's initial state carried across: (one-device state,
    port config)."""
    fam = FAMILIES[family]
    ref_cfg, cfg = fam["configs"](dtype)
    ref = fam["init"](fam["ref"], jax.random.PRNGKey(0), ref_cfg)
    return train_state_from_jax(jax.device_get(ref), cfg, "cpu"), cfg


def _port_step(family, dtype, mesh):
    """The port's one step from the carried state, over ``mesh`` (None:
    one device): (loss, stepped state)."""
    mod = FAMILIES[family]["port"]
    state, cfg = _port_start(family, dtype)
    if mesh is not None:
        state = mod.shard_train_state(state, mesh, cfg)
    step = mod.make_train_step(mesh, cfg, state_template=state, donate=False)
    state, m = step(state, torch.from_numpy(_batch()))
    return float(m["loss"]), state


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mu(state):
    return {k: v.numpy() for k, v in optim.adam_state(state.opt_state, state.params)[1].items()}


def _moments_close(want, got, skip=()):
    """Per leaf relative L2 <= 1e-4; ``skip`` leaves (zero exact gradient)
    below 1e-6 of the largest moment of the net on both sides."""
    assert sorted(want) == sorted(got)
    big = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        a, b = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        if k in skip:
            assert np.abs(a).max() <= 1e-6 * big and np.abs(b).max() <= 1e-6 * big, k
        else:
            err = np.linalg.norm(a - b) / np.linalg.norm(a)
            assert err <= 1e-4, (k, err)


# ---------------------------------------------------------------------------
# The counterparts of tests/test_train.py's sharded cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["style", "sr"])
def test_train_step_sharded_matches_replicated(family):
    """(data=2, space=2, model=2) at the reference's TINY / default SR
    configs (bfloat16): the port's sharded step against the reference's
    sharded step and against its own one-device step, loss within 5e-3
    relative and params after one step within 5e-3."""
    ref_loss, ref_params, _ = _ref_step(family, "bfloat16", AXES)
    loss_1, one = _port_step(family, "bfloat16", None)
    loss_8, sharded = _port_step(family, "bfloat16", port_mesh())
    got = optim.flatten(optim.whole(sharded.params))
    for want_loss, want in ((ref_loss, ref_params),
                            (loss_1, optim.flatten(optim.whole(one.params)))):
        assert abs(want_loss - loss_8) < 5e-3 * max(1.0, abs(want_loss))
        for k in want:
            np.testing.assert_allclose(_np(want[k]), got[k].numpy(), atol=5e-3, err_msg=k)


@pytest.mark.parametrize("family", ["style", "sr"])
def test_sharded_gradient_is_the_one_device_gradient(family):
    """float32 compute: the sharded step's Adam first moment (0.1 × the
    gradient) against the one-device step's, the port's and the
    reference's, within 1e-4 relative L2 on every leaf. No leaf is
    scaled by the model axis."""
    _, ref_one, ref_mu1 = _ref_step(family, "float32", {})
    _, one = _port_step(family, "float32", None)
    _, sharded = _port_step(family, "float32", port_mesh())
    skip = PRE_NORM_BIASES if family == "style" else ()
    mu = _mu(sharded)
    _moments_close(ref_mu1, mu, skip)
    _moments_close(_mu(one), mu, skip)


# The reference's first-moment ratio to its one-device step under model=2,
# per leaf (float32): 2 on every column-parallel conv's leaves and every
# weight; 1 on ESPCN's replicated head and map's replicated bias.
REF_SCALED = {"style": {"stem/w": 2.0, "down1/w": 2.0, "down2/w": 2.0, "res0_a/w": 2.0,
                        "res0_b/w": 2.0, "up1/w": 2.0, "up2/w": 2.0, "out/w": 2.0,
                        "stem_norm/scale": 2.0, "down2_norm/scale": 2.0},
              "sr": {"feat/w": 2.0, "feat/b": 2.0, "map/w": 2.0, "map/b": 1.0,
                     "head/w": 1.0, "head/b": 1.0}}


@pytest.mark.parametrize("family", ["style", "sr"])
def test_reference_sharded_gradient_scales_with_the_model_axis(family):
    """Pinned difference of the reference (ROADMAP, "Differences of the
    reference"): under model=2 its sharded step's first moment is 2× its
    one-device step's on every weight and on the leaves of a column
    conv (its psum transposes to a psum and nothing sums a column conv's
    input gradient across the ranks); the port's is 1× on every leaf."""
    _, _, ref_mu1 = _ref_step(family, "float32", {})
    _, _, ref_mu2 = _ref_step(family, "float32", dict(model=2))
    _, sharded = _port_step(family, "float32", port_mesh(model=2))
    mu = _mu(sharded)

    def ratio(got, leaf):
        want = np.asarray(ref_mu1[leaf], np.float64)
        return float(np.vdot(np.asarray(got, np.float64), want) / np.vdot(want, want))

    for leaf, scale in REF_SCALED[family].items():
        assert abs(ratio(ref_mu2[leaf], leaf) - scale) < 1e-3, leaf
        assert abs(ratio(mu[leaf], leaf) - 1.0) < 1e-4, leaf


@pytest.mark.parametrize("family", ["style", "sr"])
def test_every_copy_of_a_block_holds_the_same_bits(family):
    """On a mesh of distinct devices every replicated block has one copy
    per position: after each of two steps all copies equal their master
    bit for bit, Adam holds one entry per distinct block, and its first
    moment equals the virtual mesh's (one copy per block) per
    ``_moments_close`` (the copies' gradients are summed in another
    order there)."""
    mod = FAMILIES[family]["port"]
    state, cfg = _port_start(family, "float32")
    mesh = distinct_mesh()
    placed = mod.shard_train_state(state, mesh, cfg)
    step = mod.make_train_step(mesh, cfg, state_template=placed)
    n_blocks = len(placed.params.masters())
    assert len(placed.params.tensors()) > n_blocks
    assert len(placed.opt_state.param_groups[0]["params"]) == n_blocks
    batch = torch.from_numpy(_batch())
    for _ in range(2):
        placed, _ = step(placed, batch)
        for _, _, copies in placed.params.each_block():
            assert all(torch.equal(copies[0], t) for t in copies[1:])
    virt = mod.shard_train_state(state, port_mesh(), cfg)
    virt_step = mod.make_train_step(virt.params.mesh, cfg, state_template=virt)
    for _ in range(2):
        virt, _ = virt_step(virt, batch)
    _moments_close(_mu(virt), _mu(placed), PRE_NORM_BIASES if family == "style" else ())


# ---------------------------------------------------------------------------
# The counterparts of tests/test_train.py's __graft_entry__ cases
# ---------------------------------------------------------------------------


def test_dryrun_multichip_entrypoint():
    """``dryrun_multichip(8, device="cpu")``: all seven sub-checks pass at
    the reference's tolerances (it raises otherwise), on the reference's
    mesh shapes."""
    from dvf_tpu_torch.dryrun import dryrun_multichip

    rows = dryrun_multichip(8, device="cpu")
    assert [r["label"] for r in rows] == [
        "engine-halo(sobel_bilateral)", "engine-psum(equalize)",
        "engine-flow(flow_warp)", "engine-pp(style_transfer)",
        "engine-tp(super_resolution)", "engine-tp-fast(super_resolution)",
        "engine-pipeline(Pipeline.run)", "train-step"]
    assert rows[0]["mesh"] == "(2,4,1)" and rows[-1]["mesh"] == "(2,2,2)"
    assert rows[-1]["step"] == 1 and np.isfinite(rows[-1]["loss"])
    assert all(r["launches"] == {} for r in rows)   # plain versions on the CPU


def test_entry_compiles():
    from dvf_tpu_torch.dryrun import entry

    fn, args = entry(device="cpu")
    out = fn(*args)
    assert out.shape == args[1].shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def test_dryrun_devices_never_choose_the_cpu_unasked(monkeypatch):
    from dvf_tpu_torch.dryrun import _factor_mesh, dryrun_devices
    from dvf_tpu_torch.parallel import mesh as mesh_mod

    assert dryrun_devices(3, "cpu") == [CPU] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_devices(8)
    monkeypatch.setattr(mesh_mod, "local_devices", lambda: [CPU] * 8)
    assert dryrun_devices(4) == [CPU] * 4
    assert _factor_mesh(8) == MeshConfig(2, 2, 2)
    assert _factor_mesh(2) == MeshConfig(1, 1, 2)
    assert _factor_mesh(1) == MeshConfig(1, 1, 1)


# ---------------------------------------------------------------------------
# Checkpoints of a sharded state
# ---------------------------------------------------------------------------


def _tiny():
    return StyleTrainConfig(net=StyleNetConfig(base_channels=8, n_residual=2),
                            vgg=VGGConfig(blocks=((1, 8), (1, 16))))


def _fresh(seed=0):
    return tst.init_train_state(seed, np.full((1, 32, 32, 3), 0.25, np.float32), _tiny(),
                                device="cpu")


def _equal(a, b):
    ca, mua, nua = optim.adam_state(a.opt_state, a.params)
    cb, mub, nub = optim.adam_state(b.opt_state, b.params)
    assert ca == cb and int(a.step) == int(b.step)
    for x, y in ((optim.flatten(optim.whole(a.params)), optim.flatten(optim.whole(b.params))),
                 (mua, mub), (nua, nub)):
        assert sorted(x) == sorted(y)
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_resume_training_continues_from_step(tmp_path):
    """Counterpart of tests/test_checkpoint.py's: (data=2, model=2), two
    steps, checkpoint, restore onto the mesh from a fresh template, and
    the restored state's third step equals the unrestored third step bit
    for bit."""
    mesh = port_mesh(data=2, model=2)
    cfg = _tiny()
    state = tst.shard_train_state(_fresh(), mesh, cfg)
    step_fn = tst.make_train_step(mesh, cfg, state_template=state, donate=False)
    batch = torch.full((4, 64, 64, 3), 0.5)
    for _ in range(2):
        state, _ = step_fn(state, batch)
    path = tc.save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = tc.restore_checkpoint(path, _fresh(seed=7), mesh=mesh, config=cfg)
    assert int(restored.step) == 2 and restored.params.mesh == mesh
    _equal(state, restored)
    state3, m = step_fn(state, batch)
    resumed3, m_r = step_fn(restored, batch)
    assert int(resumed3.step) == int(state3.step) == 3
    assert np.isfinite(float(m_r["loss"])) and torch.equal(m["loss"], m_r["loss"])
    _equal(state3, resumed3)


def _members(path):
    """Every ``.npz`` member's name and bytes, in file order (the members,
    not the zip's own header, which stamps the time of writing)."""
    out = []
    for name in (tc.PARAMS_FILE, tc.STATE_FILE):
        with zipfile.ZipFile(f"{path}/{name}") as z:
            out.append([(n, z.read(n)) for n in z.namelist()])
    return out


@pytest.mark.parametrize("family", ["style", "sr"])
def test_sharded_checkpoint_is_the_one_device_checkpoint(tmp_path, family):
    """A sharded state saves the same .npz members, byte for byte, as the
    equal one-device state, before a step and after one (the one-device
    state then restored from the sharded checkpoint)."""
    if family == "style":
        state, cfg, restore = _fresh(), _tiny(), tc.restore_checkpoint
        batch = torch.full((4, 64, 64, 3), 0.5)
        template = _fresh(seed=3)
    else:
        cfg, restore = SrTrainConfig(), tc.restore_sr_checkpoint
        state, batch = tsr.init_train_state(0, cfg, device="cpu"), torch.from_numpy(_batch())
        template = tsr.init_train_state(3, cfg, device="cpu")
    mod = FAMILIES[family]["port"]
    placed = mod.shard_train_state(state, distinct_mesh(), cfg)
    a = tc.save_checkpoint(str(tmp_path / "one"), state)
    b = tc.save_checkpoint(str(tmp_path / "sharded"), placed)
    assert _members(a) == _members(b)
    placed, _ = mod.make_train_step(placed.params.mesh, cfg, state_template=placed)(placed, batch)
    b = tc.save_checkpoint(str(tmp_path / "sharded"), placed)
    whole = restore(b, template)
    assert not isinstance(whole.params, optim.MeshParams)
    a = tc.save_checkpoint(str(tmp_path / "one"), whole)
    assert _members(a) == _members(b)


def test_sharded_state_from_a_sharded_jax_state():
    """``convert.train_state_from_jax`` of the reference's sharded state
    (``jax.device_get`` gives whole arrays), then ``shard_train_state``:
    the port's placed state holds the reference's values."""
    ref_cfg, cfg = _style_configs("bfloat16")
    mesh = ref_make_mesh(RefMeshConfig(**AXES))
    ref = jst.shard_train_state(jst.init_train_state(
        jax.random.PRNGKey(0), jnp.full((1, 32, 32, 3), 0.25, jnp.float32), ref_cfg),
        mesh, ref_cfg)
    state = tst.shard_train_state(train_state_from_jax(jax.device_get(ref), cfg, "cpu"),
                                  port_mesh(), cfg)
    want = optim.flatten(jax.device_get(ref.params))
    got = optim.flatten(optim.whole(state.params))
    assert all(np.array_equal(np.asarray(want[k]), got[k].detach().numpy()) for k in want)
    want_v = optim.flatten(jax.device_get(ref.vgg_params))
    got_v = optim.flatten(optim.whole(state.vgg_params))
    assert all(np.array_equal(np.asarray(want_v[k]), got_v[k].numpy()) for k in want_v)


# ---------------------------------------------------------------------------
# Lockstep and the specs
# ---------------------------------------------------------------------------


def test_state_pspecs_match_the_reference():
    ref_cfg, cfg = _style_configs("bfloat16")
    ref = jst.state_pspecs(jst.init_train_state(
        jax.random.PRNGKey(0), jnp.full((1, 32, 32, 3), 0.25, jnp.float32), ref_cfg), ref_cfg)
    got = tst.state_pspecs(_fresh(), cfg)
    for mine, theirs in ((got.params, ref.params), (got.vgg_params, ref.vgg_params),
                         (got.opt_state["mu"], ref.opt_state[0].mu)):
        a, b = optim.flatten(mine), optim.flatten(theirs)
        assert sorted(a) == sorted(b)
        assert all(tuple(a[k]) == tuple(b[k]) for k in a)
    assert tuple(tst.train_batch_sharding(port_mesh()).spec) == (("data", "space"),)
    sr_ref = jsr.state_pspecs(jsr.init_train_state(jax.random.PRNGKey(0), jsr.SrTrainConfig()),
                              jsr.SrTrainConfig())
    sr_got = tsr.state_pspecs(None, SrTrainConfig())
    a, b = optim.flatten(sr_got.params), optim.flatten(sr_ref.params)
    assert sorted(a) == sorted(b) and all(tuple(a[k]) == tuple(b[k]) for k in a)


def test_collectives_are_megatrons_conjugate_pairs():
    """The sum of partials hands every partial the sum of the ranks'
    gradients; the gather hands each slice its part of that sum; both in
    rank order, in float32 for bfloat16 partials."""
    devs = [CPU, CPU]
    rng = np.random.default_rng(0)
    parts = [torch.tensor(rng.standard_normal((2, 3)), requires_grad=True) for _ in devs]
    outs = collective("sum", parts, devs)
    assert len(outs) == 2 and torch.equal(outs[0], parts[0] + parts[1])
    (outs[0] * 2 + outs[1] * 3).sum().backward()
    assert all(torch.equal(p.grad, torch.full((2, 3), 5.0, dtype=p.dtype)) for p in parts)
    slices = [torch.tensor(rng.standard_normal((2, 1, 2)), requires_grad=True) for _ in devs]
    outs = collective("gather", slices, devs)
    assert torch.equal(outs[1], torch.cat([s.detach() for s in slices], -1))
    (outs[0] * torch.arange(4.0)).sum().backward()
    assert torch.equal(slices[0].grad, torch.tensor([0.0, 1.0]).expand(2, 1, 2).double())
    assert torch.equal(slices[1].grad, torch.tensor([2.0, 3.0]).expand(2, 1, 2).double())
    half = [torch.full((4,), 1.0, dtype=torch.bfloat16), torch.full((4,), 2.0 ** -9,
                                                                    dtype=torch.bfloat16)]
    assert collective("sum", half, devs)[0].dtype == torch.bfloat16


def test_lockstep_refuses_programs_that_diverge():
    def prog(n):
        for _ in range(n):
            yield "sum", torch.ones(2)
        return n

    assert lockstep([prog(2), prog(2)], [CPU, CPU]) == [2, 2]
    with pytest.raises(RuntimeError, match="diverged"):
        lockstep([prog(1), prog(2)], [CPU, CPU])


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def test_cli_train_spans_the_cards(tmp_path, capsys, monkeypatch):
    """``train`` builds ``MeshConfig(data=gcd(batch, cards))`` over the
    cards (two stand-ins here), steps the sharded state, checkpoints it
    whole and resumes onto the mesh; with ``--platform cpu`` the devices
    are the CPU alone, one device (a divergence: the reference spans its
    CPU's devices)."""
    from dvf_tpu_torch import cli

    assert cli._train_mesh(2, "cpu") is None
    monkeypatch.setattr(cli, "_train_devices", lambda _device: [CPU] * 2)
    meshes = []
    real = cli._train_mesh
    monkeypatch.setattr(cli, "_train_mesh",
                        lambda batch, device: meshes.append(real(batch, device)) or meshes[-1])
    ckpt = str(tmp_path / "ck")
    argv = ["train", "--platform", "cpu", "--batch", "2", "--size", "32",
            "--base-channels", "8", "--n-residual", "1", "--checkpoint-dir", ckpt,
            "--checkpoint-every", "2", "--log-every", "100"]
    assert cli.main(argv + ["--steps", "2"]) == 0
    assert meshes[-1].shape == {"data": 2, "space": 1, "model": 1}
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["steps"] == 2 and np.isfinite(first["final_loss"])
    assert cli.main(argv + ["--steps", "3", "--resume", f"{ckpt}/final"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 3
    params = tc.load_params(f"{ckpt}/final")
    assert params["stem"]["w"].shape == (9, 9, 3, 8)
    monkeypatch.setattr(cli, "_train_devices", lambda _device: [CPU] * 3)
    assert real(2, "cpu") is None   # gcd(2, 3) = 1: one device
