"""The port's training subsystem held to the JAX package's on the CPU.

The same seeded numpy inputs go through ``dvf_tpu`` and ``dvf_tpu_torch``:
the VGG encoder, both loss functions with their gradients, and whole
train steps (the port's ``torch.optim.Adam`` against ``optax.adam``), the
JAX state carried across by ``convert.train_state_from_jax``. Then the
counterparts of tests/test_train.py (its two sharded cases and the two
``__graft_entry__`` cases are in tests/test_torch_train_mesh.py) and the
port's own contract: in-place steps, ``donate=False``, one device per
state, TF32 off in the backward.

Tolerances, stated per test: float32 features and losses to 1e-5
relative, float32 gradients to 1e-4 of each leaf's largest element;
bfloat16 (where JAX's CPU conv and torch round differently) features to
two bfloat16 ulps and losses to 1e-2 relative; one Adam step to 1e-3 of
the learning rate where the gradient stands clear of Adam's eps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvf_tpu.models import StyleNetConfig as JaxNet
from dvf_tpu.models.espcn import EspcnConfig as JaxEspcn
from dvf_tpu.models.vgg import VGGConfig as JaxVGG
from dvf_tpu.models.vgg import init_vgg as jax_init_vgg
from dvf_tpu.models.vgg import vgg_features as jax_vgg_features
from dvf_tpu.parallel.mesh import MeshConfig, make_mesh
from dvf_tpu.train import sr as jsr
from dvf_tpu.train import style as jst
from dvf_tpu_torch.convert import train_state_from_jax
from dvf_tpu_torch.models import StyleNetConfig, EspcnConfig
from dvf_tpu_torch.models.vgg import VGGConfig, init_vgg, vgg_features
from dvf_tpu_torch.train import (
    StyleTrainConfig, SrTrainConfig, init_train_state, make_train_step,
    style_loss_fn)
from dvf_tpu_torch.train import optim
from dvf_tpu_torch.train import sr as tsr
from dvf_tpu_torch.train import style as tst

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LR = 1e-3
# Conv biases an instance norm follows: their exact gradient is zero (the
# norm takes the per-channel mean out), so both packages give rounding
# noise there and Adam's first step turns that noise into ±lr.
PRE_NORM_BIASES = {"stem/b", "down1/b", "down2/b", "res0_a/b", "res0_b/b",
                   "res0_bn/bias", "up1/b", "up2/b"}


def _configs(dtype="float32"):
    jd, td = DTYPES[dtype]
    ref = jst.StyleTrainConfig(net=JaxNet(base_channels=8, n_residual=1, compute_dtype=jd),
                               vgg=JaxVGG(blocks=((1, 8), (1, 16)), compute_dtype=jd))
    port = StyleTrainConfig(net=StyleNetConfig(base_channels=8, n_residual=1,
                                               compute_dtype=td),
                            vgg=VGGConfig(blocks=((1, 8), (1, 16)), compute_dtype=td))
    return ref, port


def _sr_configs(dtype="float32"):
    jd, td = DTYPES[dtype]
    return (jsr.SrTrainConfig(net=JaxEspcn(compute_dtype=jd)),
            SrTrainConfig(net=EspcnConfig(compute_dtype=td)))


def _inputs(seed=0, shape=(2, 32, 32, 3)):
    rng = np.random.default_rng(seed)
    return (rng.random((1, 32, 32, 3), dtype=np.float32),
            rng.random(shape, dtype=np.float32))


def _style_pair(dtype="float32", seed=0):
    """(JAX state, the port's state carried across, JAX cfg, port cfg)."""
    ref_cfg, cfg = _configs(dtype)
    style, _ = _inputs(seed)
    ref = jst.init_train_state(jax.random.PRNGKey(seed), jnp.asarray(style), ref_cfg)
    return ref, train_state_from_jax(jax.device_get(ref), cfg, "cpu"), ref_cfg, cfg


def _sr_pair(dtype="float32", seed=0):
    ref_cfg, cfg = _sr_configs(dtype)
    ref = jsr.init_train_state(jax.random.PRNGKey(seed), ref_cfg)
    return ref, train_state_from_jax(jax.device_get(ref), cfg, "cpu"), ref_cfg, cfg


def _rel(a, b):
    a, b = float(a), float(torch.as_tensor(b).detach())
    return abs(a - b) / max(abs(a), 1e-30)


def _grads_close(ref_grads, port_params, port_grads, skip=()):
    """Every leaf's gradient within 1e-4 of that leaf's largest |g|; the
    ``skip`` leaves (exact gradient zero) below 1e-5 of the largest
    gradient of the whole net on both sides."""
    ref = optim.flatten(jax.device_get(ref_grads))
    leaves = list(optim.flatten(port_params))
    assert sorted(ref) == sorted(leaves)
    got = dict(zip(leaves, port_grads))
    big = max(float(np.abs(v).max()) for v in ref.values())
    for k in leaves:
        a, b = np.asarray(ref[k]), got[k].numpy()
        if k in skip:
            assert np.abs(a).max() <= 1e-5 * big and np.abs(b).max() <= 1e-5 * big, k
        else:
            err = np.abs(a - b).max() / np.abs(a).max()
            assert err <= 1e-4, (k, err)


# ---------------------------------------------------------------------------
# The encoder, the losses and their gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 33, 31, 3)],
                         ids=["even", "odd"])
def test_vgg_features_match_reference(dtype, shape):
    """Per block, at the default widths: float32 within 1e-5 of the block's
    largest |feature|, bfloat16 within two bfloat16 ulps of it. The odd
    geometry drops the pool's last row and column as VALID does."""
    jd, td = DTYPES[dtype]
    _, batch = _inputs(1, shape)
    params = init_vgg(3)
    ref = jax_vgg_features(jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
                           jnp.asarray(batch), JaxVGG(compute_dtype=jd))
    got = vgg_features(params, torch.from_numpy(batch), VGGConfig(compute_dtype=td))
    assert len(got) == len(ref) == 3
    tol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -8
    for a, b in zip(ref, got):
        a = np.asarray(a.astype(jnp.float32))
        assert b.dtype == td and tuple(b.shape) == a.shape
        assert np.abs(a - b.float().numpy()).max() <= tol * np.abs(a).max()


def test_vgg_init_is_seeded_and_shaped_like_the_reference():
    ref = jax.device_get(jax_init_vgg(jax.random.PRNGKey(0)))
    assert VGGConfig().blocks == JaxVGG().blocks
    assert VGGConfig().compute_dtype == torch.bfloat16
    a, b = init_vgg(5), init_vgg(5)
    assert sorted(a) == sorted(ref) == ["b0c0", "b1c0", "b2c0", "b2c1"]
    for k in a:
        for leaf in ("w", "b"):
            assert tuple(a[k][leaf].shape) == ref[k][leaf].shape
            assert a[k][leaf].dtype == torch.float32
            assert torch.equal(a[k][leaf], b[k][leaf])


def test_style_loss_and_gradients_match_reference():
    """float32 on both sides: the loss and each aux term within 1e-5
    relative, every gradient leaf within 1e-4 of its largest element."""
    ref, state, ref_cfg, cfg = _style_pair()
    _, batch = _inputs(2)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b, v, g: jst.style_loss_fn(p, b, v, g, ref_cfg), has_aux=True))(
        ref.params, jnp.asarray(batch), ref.vgg_params, ref.style_grams)
    loss, aux = style_loss_fn(state.params, torch.from_numpy(batch), state.vgg_params,
                              state.style_grams, cfg)
    assert sorted(aux) == sorted(ref_aux) == ["content", "loss", "style", "tv"]
    for k in aux:
        assert aux[k].dtype == torch.float32 and aux[k].dim() == 0
        assert _rel(ref_aux[k], aux[k]) <= 1e-5, k
    grads = torch.autograd.grad(loss, list(optim.flatten(state.params).values()))
    _grads_close(ref_grads, state.params, grads, skip=PRE_NORM_BIASES)


def test_style_loss_in_bfloat16_matches_reference():
    """The default (bfloat16) nets: the loss and its terms within 1e-2
    relative (the two packages' CPU bfloat16 convs round differently, so
    their gradients are compared in float32 above)."""
    ref, state, ref_cfg, cfg = _style_pair("bfloat16")
    _, batch = _inputs(2)
    _, ref_aux = jax.jit(lambda p, b, v, g: jst.style_loss_fn(p, b, v, g, ref_cfg))(
        ref.params, jnp.asarray(batch), ref.vgg_params, ref.style_grams)
    _, aux = style_loss_fn(state.params, torch.from_numpy(batch), state.vgg_params,
                           state.style_grams, cfg)
    for k in aux:
        assert _rel(ref_aux[k], aux[k]) <= 1e-2, k
    for a, b in zip(ref.style_grams, state.style_grams):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sr_loss_and_gradients_match_reference(dtype):
    """Charbonnier loss and MSE within 1e-5 relative and every gradient
    leaf within 1e-4 in float32; in bfloat16 the loss and MSE within 1e-2."""
    ref, state, ref_cfg, cfg = _sr_pair(dtype)
    hr = np.random.default_rng(4).random((2, 32, 32, 3), dtype=np.float32)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsr.sr_loss_fn(p, b, ref_cfg), has_aux=True))(ref.params, jnp.asarray(hr))
    loss, aux = tsr.sr_loss_fn(state.params, torch.from_numpy(hr), cfg)
    assert sorted(aux) == sorted(ref_aux) == ["loss", "mse"]
    tol = 1e-5 if dtype == "float32" else 1e-2
    for k in aux:
        assert _rel(ref_aux[k], aux[k]) <= tol, k
    if dtype == "float32":
        grads = torch.autograd.grad(loss, list(optim.flatten(state.params).values()))
        _grads_close(ref_grads, state.params, grads)


def test_reflect_padded_conv_input_gradient_matches_jax():
    """``pad_nhwc`` builds the reflect border by slice assignment: its
    input gradient must equal ``jnp.pad(mode="reflect")``'s (each border
    tap's gradient lands on the pixel it mirrors)."""
    from dvf_tpu.models.layers import conv2d_nb as jax_conv
    from dvf_tpu_torch.models.layers import conv2d_nb, conv_init, generator

    p = conv_init(generator(0), 9, 3, 4)
    rng = np.random.default_rng(5)
    x = rng.random((1, 13, 11, 3), dtype=np.float32)
    w = rng.random((1, 13, 11, 4), dtype=np.float32)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    ref = jax.grad(lambda x: jnp.sum(jax_conv(jp, x, compute_dtype=jnp.float32,
                                               reflect=True) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (conv2d_nb(p, xt, compute_dtype=torch.float32, reflect=True)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Whole steps against optax.adam
# ---------------------------------------------------------------------------


def _step_close(ref_params, ref_grads, params):
    """One Adam step apart: every element within 2·lr (the most a first
    update moves), and within 1e-3·lr where |g| >= 1e-4 of the largest
    gradient (Adam's first update, -lr·g/(|g|+eps), amplifies a gradient's
    last bits only near eps)."""
    ref = optim.flatten(jax.device_get(ref_params))
    g = optim.flatten(jax.device_get(ref_grads))
    big = max(float(np.abs(v).max()) for v in g.values())
    for k, t in optim.flatten(params).items():
        d = np.abs(np.asarray(ref[k]) - t.detach().numpy())
        assert d.max() <= 2.0 * LR * (1 + 1e-5), k
        clear = np.abs(np.asarray(g[k])) >= 1e-4 * big
        assert d[clear].max(initial=0.0) <= 1e-3 * LR, (k, d[clear].max())


def test_style_step_matches_optax_adam():
    """The reference's jitted step on a one-device mesh against the port's
    step from the same state and batch: the loss within 1e-5 relative,
    the step count, the params per ``_step_close`` and the Adam count."""
    ref, state, ref_cfg, cfg = _style_pair()
    _, batch = _inputs(2)
    ref_grads = jax.jit(jax.grad(lambda p: jst.style_loss_fn(
        p, jnp.asarray(batch), ref.vgg_params, ref.style_grams, ref_cfg)[0]))(ref.params)
    mesh = make_mesh(MeshConfig())
    ref = jst.shard_train_state(ref, mesh, ref_cfg)
    ref, ref_m = jst.make_train_step(mesh, ref_cfg, state_template=ref)(ref, jnp.asarray(batch))
    state, m = make_train_step(None, cfg, state_template=state)(state, torch.from_numpy(batch))
    assert _rel(ref_m["loss"], m["loss"]) <= 1e-5
    assert int(state.step) == int(ref.step) == 1
    assert optim.adam_state(state.opt_state, state.params)[0] == int(ref.opt_state[0].count)
    _step_close(ref.params, ref_grads, state.params)


def test_sr_step_matches_optax_adam():
    ref, state, ref_cfg, cfg = _sr_pair()
    hr = np.random.default_rng(6).random((2, 32, 32, 3), dtype=np.float32)
    ref_grads = jax.grad(lambda p: jsr.sr_loss_fn(p, jnp.asarray(hr), ref_cfg)[0])(ref.params)
    mesh = make_mesh(MeshConfig())
    ref = jsr.shard_train_state(ref, mesh, ref_cfg)
    ref, ref_m = jsr.make_train_step(mesh, ref_cfg, state_template=ref)(ref, jnp.asarray(hr))
    state, m = tsr.make_train_step(None, cfg, state_template=state)(state, torch.from_numpy(hr))
    assert sorted(m) == sorted(ref_m) == ["loss", "psnr"]
    for k in m:
        assert _rel(ref_m[k], m[k]) <= 1e-5, k
    assert int(state.step) == int(ref.step) == 1
    _step_close(ref.params, ref_grads, state.params)


def test_adam_matches_optax_on_the_same_gradients():
    """The optimizer alone: three updates from the same gradients (numpy,
    seeded) through optax.adam and the port's torch.optim.Adam: params
    within float32 rounding (two ulps of their value per step, plus 1e-6
    of lr),
    both moments within 1e-6 of each moment's scale."""
    import optax

    rng = np.random.default_rng(8)
    p0 = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
          "b": {"b": rng.standard_normal(5).astype(np.float32)}}
    grads = [jax.tree.map(lambda v: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(
        -3, 2)).astype(np.float32), p0) for _ in range(3)]
    tx = optax.adam(LR)
    ref, st = jax.tree.map(jnp.asarray, p0), None
    st = tx.init(ref)
    params = optim.trainable(p0, torch.device("cpu"))
    opt = optim.adam(params, LR)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, ref)
        ref = optax.apply_updates(ref, upd)
        for k, t in optim.flatten(params).items():
            t.grad = torch.from_numpy(optim.flatten(g)[k])
        opt.step()
    count, mu, nu = optim.adam_state(opt, params)
    assert count == int(st[0].count) == 3
    for k, t in optim.flatten(params).items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(optim.flatten(ref)[k]),
                                   rtol=len(grads) * 2.0 ** -22, atol=1e-6 * LR)
        for mine, theirs in ((mu[k], st[0].mu), (nu[k], st[0].nu)):
            want = np.asarray(optim.flatten(theirs)[k])
            assert np.abs(want - mine.numpy()).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The counterparts of tests/test_train.py
# ---------------------------------------------------------------------------

TINY = StyleTrainConfig(net=StyleNetConfig(base_channels=8, n_residual=1),
                        vgg=VGGConfig(blocks=((1, 8), (1, 16))))


def _mk_state(seed=0):
    return init_train_state(seed, np.full((1, 32, 32, 3), 0.25, np.float32), TINY,
                            device="cpu")


def _uniform(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def test_loss_finite_and_composed():
    state = _mk_state()
    loss, aux = style_loss_fn(state.params, _uniform(2, (2, 32, 32, 3)), state.vgg_params,
                              state.style_grams, TINY)
    assert np.isfinite(float(loss.detach()))
    assert set(aux) == {"loss", "content", "style", "tv"}
    assert all(float(v.detach()) >= 0 for v in aux.values())


def test_train_step_reduces_loss_single_device():
    state = _mk_state()
    step = make_train_step(None, TINY, state_template=state)
    batch = _uniform(3, (2, 32, 32, 3))
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert int(state.step) == 5


def test_sr_train_step_reduces_loss_and_improves_psnr():
    cfg = SrTrainConfig()
    state = tsr.init_train_state(0, cfg, device="cpu")
    step = tsr.make_train_step(None, cfg, state_template=state)
    hr = _uniform(1, (2, 32, 32, 3))
    hist = []
    for _ in range(6):
        state, metrics = step(state, hr)
        hist.append((float(metrics["loss"]), float(metrics["psnr"])))
    assert hist[-1][0] < hist[0][0]
    assert hist[-1][1] > hist[0][1]
    assert int(state.step) == 6


def test_sr_downscale_area_exact():
    x = torch.arange(16.0).reshape(1, 4, 4, 1)
    y = tsr.downscale_area(x, 2)
    np.testing.assert_allclose(y[0, :, :, 0].numpy(), [[2.5, 4.5], [10.5, 12.5]])
    with pytest.raises(ValueError, match="divisible"):
        tsr.downscale_area(torch.zeros((1, 5, 4, 1)), 2)


# ---------------------------------------------------------------------------
# The port's own contract
# ---------------------------------------------------------------------------


def _family(name):
    if name == "style":
        return (_mk_state(), lambda **k: make_train_step(None, TINY, **k),
                _uniform(3, (2, 32, 32, 3)))
    cfg = SrTrainConfig()
    return (tsr.init_train_state(0, cfg, device="cpu"),
            lambda **k: tsr.make_train_step(None, cfg, **k), _uniform(1, (2, 32, 32, 3)))


def _snapshot(state):
    count, mu, nu = optim.adam_state(state.opt_state, state.params)
    return (count, int(state.step),
            {k: v.detach().clone() for k, v in optim.flatten(state.params).items()},
            {k: v.clone() for k, v in mu.items()}, {k: v.clone() for k, v in nu.items()})


def _same(a, b):
    assert a[:2] == b[:2]
    for x, y in zip(a[2:], b[2:]):
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("family", ["style", "sr"])
def test_donate_false_leaves_its_input_unchanged(family):
    """``donate=False`` steps a copy: the input's params, Adam moments and
    count and step are bitwise what they were, and the copy's step is the
    one an in-place step takes from the same state."""
    state, make, batch = _family(family)
    before = _snapshot(state)
    new, m1 = make(state_template=state, donate=False)(state, batch)
    assert new is not state
    _same(_snapshot(state), before)
    assert int(new.step) == 1
    same, m2 = make(state_template=state)(state, batch)
    assert same is state and int(state.step) == 1
    _same(_snapshot(new), _snapshot(state))
    assert torch.equal(m1["loss"], m2["loss"])


@pytest.mark.parametrize("family", ["style", "sr"])
def test_step_updates_in_place_and_returns_device_tensors(family):
    """The analogue of donation: the same state object and the same leaf
    tensors come back, updated; metrics are 0-d tensors (never synced)."""
    state, make, batch = _family(family)
    leaves = [id(t) for t in optim.flatten(state.params).values()]
    out, metrics = make(state_template=state)(state, batch)
    assert out is state
    assert [id(t) for t in optim.flatten(out.params).values()] == leaves
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 and not v.requires_grad
               for v in metrics.values())
    assert state.step.dtype == torch.int32


def test_steps_run_on_one_device_only():
    """A step runs where its state is: ``mesh=None`` and a one-position
    mesh are the state's device (bitwise the same step), and a sharded
    step refuses a state not placed on its mesh."""
    from dvf_tpu_torch.parallel.mesh import MeshConfig as PortMesh
    from dvf_tpu_torch.parallel.mesh import make_mesh as port_mesh

    cpu = torch.device("cpu")
    batch = _uniform(3, (2, 32, 32, 3))
    a, ma = make_train_step(None, TINY, state_template=_mk_state())(_mk_state(), batch)
    one = port_mesh(PortMesh(), devices=[cpu])
    placed = tst.shard_train_state(_mk_state(), one, TINY)
    b, mb = make_train_step(one, TINY, state_template=placed)(placed, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    _same(_snapshot(a), _snapshot(b))
    two = port_mesh(PortMesh(data=2), devices=[cpu] * 2)
    with pytest.raises(ValueError, match="placed"):
        make_train_step(two, TINY, state_template=a)(a, batch)
    with pytest.raises(ValueError, match="placed"):
        tsr.make_train_step(two, SrTrainConfig(), state_template=a)(
            tsr.init_train_state(0, device="cpu"), batch)
    with pytest.raises(ValueError, match="state_template"):
        make_train_step(None, TINY)


def test_entry_points_default_to_cuda():
    """No device named: cuda:0, which raises where there is none (no
    quiet move to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(0, np.zeros((1, 8, 8, 3), np.float32), TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsr.init_train_state(0)


@pytest.mark.parametrize("dtype,off", [("float32", True), ("bfloat16", False)])
def test_tf32_is_off_in_the_backward_of_a_float32_step(dtype, off, monkeypatch):
    """cuDNN's TF32 flag as the backward sees it: off for float32 nets
    (forward AND backward in the block), untouched for bfloat16, and
    restored after the step either way."""
    _, cfg = _configs(dtype)
    state = init_train_state(0, np.full((1, 32, 32, 3), 0.25, np.float32), cfg,
                             device="cpu")
    seen = []
    real = tst.apply_style_net

    def spy(params, batch, config):
        out = real(params, batch, config)
        out.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
        return out

    monkeypatch.setattr(tst, "apply_style_net", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    make_train_step(None, cfg, state_template=state)(state, _uniform(3, (2, 32, 32, 3)))
    assert seen == [not off]
    assert torch.backends.cudnn.allow_tf32 is True


def test_train_package_exports_the_references_names():
    import dvf_tpu.train as ref
    import dvf_tpu_torch.train as port

    names = {"StyleTrainConfig", "TrainState", "init_train_state", "make_train_step",
             "style_loss_fn", "SrTrainConfig", "SrTrainState"}
    assert names <= set(vars(ref)) and names <= set(vars(port))
    for cls in ("StyleTrainConfig", "SrTrainConfig"):
        want = {f.name: f.default for f in dataclasses.fields(getattr(ref, cls))}
        got = {f.name: f.default for f in dataclasses.fields(getattr(port, cls))}
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == v, (cls, k)
    assert [f.name for f in dataclasses.fields(port.TrainState)] == \
        [f.name for f in dataclasses.fields(ref.TrainState)]
    assert [f.name for f in dataclasses.fields(port.SrTrainState)] == \
        [f.name for f in dataclasses.fields(ref.SrTrainState)]
