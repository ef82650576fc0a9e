"""The neural filters over the port's in-host mesh, held to the
reference's on its 8 fake CPU devices: tensor parallelism of the style
net and ESPCN over the ``model`` axis (counterparts of
tests/test_models.py's TP cases) and the GPipe layer pipeline
(counterparts of every test in tests/test_pp.py). The port runs on
``[cpu] * 8``; weights cross with ``convert.from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch as dt
from dvf_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from dvf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from dvf_tpu.runtime.engine import Engine as RefEngine
from dvf_tpu_torch.convert import from_jax
from dvf_tpu_torch.models import espcn as tes
from dvf_tpu_torch.models import style_transfer as tst
from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from dvf_tpu_torch.parallel.pp import (pipeline_apply, pipeline_stage_specs,
                                       stack_layer_params)
from dvf_tpu_torch.parallel.sharded import RankGroup, place_tree
from dvf_tpu_torch.runtime.engine import Engine

CPU = torch.device("cpu")
CPU8 = [CPU] * 8
SMALL = dict(base_channels=8, n_residual=2)


def mesh(**axes):
    return make_mesh(MeshConfig(**axes), devices=CPU8)


def ref_mesh(**axes):
    return ref_make_mesh(RefMeshConfig(**axes))


def _u8diff(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


def _jax_params(kind, seed=0, **kw):
    if kind == "style":
        from dvf_tpu.models.style_transfer import StyleNetConfig, init_style_net

        return jax.device_get(init_style_net(jax.random.PRNGKey(seed),
                                             StyleNetConfig(**kw)))
    from dvf_tpu.models.espcn import EspcnConfig, init_espcn

    return jax.device_get(init_espcn(jax.random.PRNGKey(seed), EspcnConfig(**kw)))


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _leaf_paths(v, prefix + (k,))}
    return {prefix}


# ------------------------------------------------- tensor parallelism


def test_param_pspecs_cover_params_and_are_valid():
    """The TP spec tree covers the param tree leaf for leaf (and equals
    the reference's), and every block it names places on a model=2 mesh."""
    from dvf_tpu.models.style_transfer import param_pspecs as ref_specs

    cfg = tst.StyleNetConfig(**SMALL)
    params = tst.init_style_net(0, cfg)
    specs = tst.param_pspecs(cfg)
    flat = {}

    def walk(t, s, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (k,))
        else:
            flat[path] = s

    walk(params, specs)
    assert set(flat) == _leaf_paths(params)
    ref = ref_specs(dvf_tpu.models.StyleNetConfig(**SMALL))
    for path, spec in flat.items():
        r = ref
        for k in path:
            r = r[k]
        assert tuple(spec) == tuple(r), path
    placed = place_tree(params, mesh(model=2), specs)
    stem = placed.local((0, 0, 1))["stem"]["w"]
    assert tuple(stem.shape) == (9, 9, 3, 4)   # cout 8 over 2 ranks
    torch.testing.assert_close(stem, params["stem"]["w"][..., 4:])


def test_tp_sharded_forward_matches_replicated():
    """Two ranks each with their weight blocks, one sum after each
    row-parallel conv: the replicated forward's output, and the
    reference's TP forward's."""
    from dvf_tpu.models.style_transfer import StyleNetConfig as RefCfg
    from dvf_tpu.models.style_transfer import apply_style_net as ref_apply

    jp = _jax_params("style", **SMALL)
    x = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32)
    cfg = tst.StyleNetConfig(**SMALL)
    params = from_jax(jp, CPU)
    want = tst.apply_style_net(params, torch.from_numpy(x), cfg)
    placed = place_tree(params, mesh(model=2), tst.param_pspecs(cfg))
    group = RankGroup([CPU, CPU])
    inner = tst.tp_inner_apply(cfg)
    outs = group.run(lambda m: inner(placed.local((0, 0, m)), torch.from_numpy(x),
                                     lambda y: group.psum(m, y)))
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), atol=2e-2)
    ref = ref_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), RefCfg(**SMALL))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref), atol=2e-2)


def _style(parallel="tp", params=None, **kw):
    return dt.get_filter("style_transfer", parallel=parallel, params=params,
                         **{**SMALL, **kw})


def test_style_engine_tp_matches_replicated():
    """The engine swaps in the TP body on a model-sharded mesh and places
    the weights by its specs; the output matches the unsharded engine and
    the reference's TP engine (same weights)."""
    x = np.random.default_rng(0).integers(0, 255, (2, 32, 32, 3), np.uint8)
    jp = _jax_params("style", **SMALL)
    eng = Engine(_style(params=from_jax(jp, CPU)), mesh=mesh(data=2, model=4))
    eng.compile(x.shape, np.uint8)
    assert eng._exec_filter.name.startswith("tp("), eng._exec_filter.name
    stem_w = eng._state.local((0, 0, 1))["stem"]["w"]
    assert tuple(stem_w.shape) == (9, 9, 3, 2)      # cout 8 over 4 ranks
    got = eng.submit(x).fetch()
    want = Engine(_style(params=from_jax(jp, CPU)), device="cpu").submit(x).fetch()
    assert _u8diff(got, want).max() <= 3
    ref = RefEngine(dvf_tpu.get_filter("style_transfer", params=jp, **SMALL),
                    mesh=ref_mesh(data=2, model=4)).submit(x)
    d = _u8diff(got, ref)
    assert d.mean() < 2.0 and d.max() <= 30, (d.mean(), d.max())
    # float32 nets: the port's TP and the reference's agree to a level.
    got32 = Engine(_style(params=from_jax(jp, CPU), dtype="float32"),
                   mesh=mesh(data=2, model=4)).submit(x).fetch()
    ref32 = RefEngine(dvf_tpu.get_filter("style_transfer", params=jp,
                                         dtype="float32", **SMALL),
                      mesh=ref_mesh(data=2, model=4)).submit(x)
    assert _u8diff(got32, ref32).max() <= 1


def test_style_engine_tp_with_space_axis_and_odd_batch():
    """B=2 on (data=1, space=4, model=2) cannot fold over data*space=4:
    the batch stays one block and still matches."""
    x = np.random.default_rng(1).integers(0, 255, (2, 32, 32, 3), np.uint8)
    eng = Engine(_style(), mesh=mesh(data=1, space=4, model=2))
    eng.compile(x.shape, np.uint8)
    assert tuple(eng.input_sharding.spec) in ((None,), ("data",))
    got = eng.submit(x).fetch()
    want = Engine(_style(), device="cpu").submit(x).fetch()
    assert _u8diff(got, want).max() <= 3
    ref = RefEngine(dvf_tpu.get_filter("style_transfer", **SMALL),
                    mesh=ref_mesh(data=1, space=4, model=2)).submit(x)
    assert np.asarray(ref).shape == got.shape


def test_espcn_pspecs_cover_params_and_tp_matches_replicated():
    from dvf_tpu.models.espcn import param_pspecs as ref_specs

    cfg = tes.EspcnConfig()
    jp = _jax_params("espcn")
    params = from_jax(jp, CPU)
    specs = tes.param_pspecs(cfg)
    assert _leaf_paths(params) == {(k, j) for k in specs for j in specs[k]}
    ref = ref_specs()
    assert {k: {j: tuple(v) for j, v in d.items()} for k, d in specs.items()} == \
        {k: {j: tuple(v) for j, v in d.items()} for k, d in ref.items()}
    x = torch.from_numpy(np.random.default_rng(1).random((2, 16, 16, 3),
                                                         dtype=np.float32))
    want = tes.apply_espcn(params, x, cfg)
    placed = place_tree(params, mesh(model=2), specs)
    group = RankGroup([CPU, CPU])
    inner = tes.tp_inner_apply(cfg)
    got = group.run(lambda m: inner(placed.local((0, 0, m)), x,
                                    lambda y: group.psum(m, y)))[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2)


def test_sr_engine_tp_matches_replicated():
    """ESPCN gets TP through the engine like the style net, and its ×2
    geometry flows through the sharded submit."""
    x = np.random.default_rng(0).integers(0, 255, (2, 16, 16, 3), np.uint8)
    jp = _jax_params("espcn")
    eng = Engine(dt.get_filter("super_resolution", params=from_jax(jp, CPU)),
                 mesh=mesh(data=2, model=4))
    eng.compile(x.shape, np.uint8)
    assert eng._exec_filter.name.startswith("tp("), eng._exec_filter.name
    assert tuple(eng._state.local((0, 0, 0))["feat"]["w"].shape) == (5, 5, 3, 16)
    got = eng.submit(x).fetch()
    assert got.shape == (2, 32, 32, 3)
    want = Engine(dt.get_filter("super_resolution", params=from_jax(jp, CPU)),
                  device="cpu").submit(x).fetch()
    assert _u8diff(got, want).max() <= 3
    ref = RefEngine(dvf_tpu.get_filter("super_resolution", params=jp),
                    mesh=ref_mesh(data=2, model=4)).submit(x)
    d = _u8diff(got, ref)
    assert d.mean() < 2.0 and d.max() <= 30, (d.mean(), d.max())


# ------------------------------------------------- layer pipelining


def _layers(rng, n, f):
    return [{"w": torch.from_numpy(rng.normal(size=(f, f), scale=0.3).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(f,)).astype(np.float32))}
            for _ in range(n)]


def _layer_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sequential(layers, x):
    for p in layers:
        x = _layer_fn(p, x)
    return x


def _run_pp(layers, x, m, n_microbatches=0):
    """The stack placed over the model axis by ``pipeline_stage_specs``;
    each data block of ``x`` pipelined over its model ranks."""
    stacked = stack_layer_params(layers)
    placed = place_tree(stacked, m, pipeline_stage_specs("model", stacked))
    d, s = m.axis_size("data"), m.axis_size("model")
    outs = []
    for i, xb in enumerate(torch.chunk(x, d)):
        ranks = [(i, 0, k) for k in range(s)]
        outs.append(pipeline_apply(_layer_fn, [placed.local(p) for p in ranks],
                                   xb, [m.devices[p] for p in ranks],
                                   n_microbatches=n_microbatches))
    return torch.cat(outs)


def _ref_run_pp(layers, x, n_microbatches=0, **axes):
    from jax.sharding import PartitionSpec as JP

    from dvf_tpu.parallel.pp import pipeline_apply as ref_apply
    from dvf_tpu.parallel.pp import pipeline_stage_specs as ref_specs
    from dvf_tpu.parallel.pp import stack_layer_params as ref_stack
    from dvf_tpu.utils.compat import shard_map

    jl = [{k: jnp.asarray(v.numpy()) for k, v in p.items()} for p in layers]
    stacked = ref_stack(jl)
    inner = lambda sp, xx: ref_apply(  # noqa: E731
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), sp, xx, axis="model",
        n_microbatches=n_microbatches)
    return np.asarray(jax.jit(shard_map(
        inner, mesh=ref_mesh(**axes),
        in_specs=(ref_specs("model", stacked), JP("data")),
        out_specs=JP("data"), check_vma=False))(stacked, jnp.asarray(x.numpy())))


@pytest.mark.parametrize("n_micro", [0, 2, 4])  # per-DATA-block batch is 4
def test_pipeline_matches_sequential(n_micro):
    rng = np.random.default_rng(0)
    layers = _layers(rng, 8, 16)
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    got = _run_pp(layers, x, mesh(data=2, model=4), n_microbatches=n_micro)
    np.testing.assert_allclose(got.numpy(), _sequential(layers, x).numpy(), atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), _ref_run_pp(layers, x, n_micro, data=2, model=4), atol=1e-5)


def test_pipeline_batch_smaller_than_stages():
    """B=2 over 4 stages: microbatches auto-clamp to B."""
    rng = np.random.default_rng(1)
    layers = _layers(rng, 4, 8)
    x = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    got = _run_pp(layers, x, mesh(data=1, model=4))
    np.testing.assert_allclose(got.numpy(), _sequential(layers, x).numpy(), atol=1e-5)


def test_pipeline_bad_microbatch_raises():
    rng = np.random.default_rng(2)
    layers = _layers(rng, 4, 8)
    x = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="divide"):
        _run_pp(layers, x, mesh(data=1, model=4), n_microbatches=3)


def test_style_pp_engine_matches_single_device():
    x = np.random.default_rng(3).integers(0, 255, (4, 32, 32, 3), np.uint8)
    kw = dict(base_channels=8, n_residual=4)
    want = Engine(_style("pp", **kw), device="cpu").submit(x).fetch()
    eng = Engine(_style("pp", **kw), mesh=mesh(data=2, model=4))
    eng.compile(x.shape, np.uint8)
    assert eng._exec_filter.name.startswith("pp("), eng._exec_filter.name
    # Each stage holds only its own blocks of the trunk.
    assert eng._state.local((0, 0, 3))["trunk"]["a"]["w"].shape[0] == 1
    got = eng.submit(x).fetch()
    assert _u8diff(got, want).max() <= 1


def test_style_pp_matches_tp():
    """Same seed → PP and TP are two schedules of the same math."""
    x = np.random.default_rng(4).integers(0, 255, (4, 32, 32, 3), np.uint8)
    kw = dict(base_channels=8, n_residual=4)
    m = mesh(data=2, model=4)
    pp = Engine(_style("pp", **kw), mesh=m).submit(x).fetch()
    tp = Engine(_style("tp", **kw), mesh=m).submit(x).fetch()
    assert _u8diff(pp, tp).max() <= 4
    ref = RefEngine(dvf_tpu.get_filter("style_transfer", parallel="pp", **kw),
                    mesh=ref_mesh(data=2, model=4)).submit(x)
    assert np.asarray(ref).shape == pp.shape


def test_style_pp_indivisible_falls_back(capsys):
    """model axis 4, n_residual 3: a line on stderr, the generic body with
    replicated weights, still the single-device numerics."""
    x = np.random.default_rng(5).integers(0, 255, (4, 32, 32, 3), np.uint8)
    kw = dict(base_channels=8, n_residual=3)
    want = Engine(_style("pp", **kw), device="cpu").submit(x).fetch()
    eng = Engine(_style("pp", **kw), mesh=mesh(data=2, model=4))
    got = eng.submit(x).fetch()
    assert "pp needs model axis (4) to divide n_residual (3)" in capsys.readouterr().err
    assert eng._exec_filter is eng.filter
    assert _u8diff(got, want).max() <= 1


def test_style_pp_rejects_bad_parallel():
    with pytest.raises(ValueError, match="parallel"):
        dt.get_filter("style_transfer", parallel="zz")
    with pytest.raises(ValueError, match="parallel"):
        dvf_tpu.get_filter("style_transfer", parallel="zz")


def test_rank_group_sum_is_identical_on_every_rank():
    """The sum is formed once, in rank order (half precision in float32),
    and every rank gets the same bits back; an error on one rank reaches
    the caller instead of hanging the others."""
    group = RankGroup([CPU] * 4)
    parts = [torch.full((3,), 0.1 * (r + 1), dtype=torch.bfloat16) for r in range(4)]
    outs = group.run(lambda r: group.psum(r, parts[r]))
    want = sum(p.float() for p in parts).to(torch.bfloat16)
    assert all(torch.equal(o, want) for o in outs)

    failing = RankGroup([CPU] * 4)

    def body(r):
        if r == 2:
            raise KeyError("rank 2")
        return failing.psum(r, parts[r])

    with pytest.raises(KeyError, match="rank 2"):
        failing.run(body)
