"""The port's in-host mesh (``dvf_tpu_torch.parallel``) held to the
reference's on 8 virtual devices: the reference runs on the 8 fake CPU
devices tests/conftest.py sets up, the port on ``[cpu] * 8`` with its
plain kernels. Counterparts of tests/test_spatial.py (the halo-exchanged
spatial sharding and the engine's routing), test_pipeline.py's
TestEngineMesh, test_flow.py's pointwise-stateful mesh case, the mesh
cases of test_ingest_stream.py and test_egress_stream.py, and
test_planner.py's fingerprint case; plus the port's own divergences from
the reference (a device list may repeat a device; the engine's default
stays one card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvf_tpu
import dvf_tpu_torch as dt
from dvf_tpu.parallel.halo import spatial_filter as ref_spatial_filter
from dvf_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from dvf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from dvf_tpu.runtime.engine import Engine as RefEngine
from dvf_tpu_torch.parallel.halo import halo_exchange_rows, spatial_filter
from dvf_tpu_torch.parallel.mesh import (MeshConfig, NamedSharding, P,
                                         batch_pspec, batch_sharding,
                                         make_mesh, pad_batch_size, replicated)
from dvf_tpu_torch.parallel.sharded import ShardedBatch, shard_batch
from dvf_tpu_torch.runtime.engine import Engine

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


def mesh(**axes):
    return make_mesh(MeshConfig(**axes), devices=CPU8)


def ref_mesh(**axes):
    return ref_make_mesh(RefMeshConfig(**axes))


def port_out(eng, x):
    return eng.submit(x).fetch().copy()


def ref_out(name, kw, x, **axes):
    return np.asarray(RefEngine(dvf_tpu.get_filter(name, **kw),
                                mesh=ref_mesh(**axes)).submit(x))


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(7).random((2, 32, 40, 3), dtype=np.float32)


# ------------------------------------------------------------- the mesh


def test_make_mesh_lays_devices_out_as_the_reference():
    m = mesh(data=2, space=2, model=2)
    r = ref_mesh(data=2, space=2, model=2)
    assert m.axis_names == tuple(r.axis_names) == ("data", "space", "model")
    assert m.devices.shape == r.devices.shape
    assert m.shape == dict(r.shape)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh(MeshConfig(data=16), devices=CPU8)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        ref_make_mesh(RefMeshConfig(data=16))
    # Without a device list the mesh spans the visible cards: none here.
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        make_mesh()


def test_repeated_devices_are_a_virtual_mesh():
    """Divergence from the reference (which forbids duplicate devices):
    the device list may repeat a device, and each block of a batch runs
    on it in turn. This is how the CPU gets 8 devices, and how one card
    runs a space=4 mesh."""
    m = make_mesh(MeshConfig(space=4), devices=[CPU] * 4)
    assert list(m.devices.flat) == [CPU] * 4
    assert m.distinct_devices() == [CPU]
    x = np.random.default_rng(0).integers(0, 255, (2, 32, 16, 3), np.uint8)
    eng = Engine(dt.get_filter("gaussian_blur", ksize=5), mesh=m)
    np.testing.assert_array_equal(
        port_out(eng, x), port_out(Engine(dt.get_filter("gaussian_blur", ksize=5),
                                          device="cpu"), x))
    assert len(eng.submit(x).device.shards) == 4


def test_engine_default_stays_one_card(monkeypatch):
    """As the reference's, ``Engine(filt)`` with neither device nor mesh
    spans every attached card: ``make_mesh()`` (all ``data``) over
    ``parallel.mesh.local_devices()`` where there are several, that card
    alone, with no mesh, where there is one, and it raises where there is
    none. A device given alone stays that one device. ``Engine(mesh=m)``
    spans m, and a device given beside the mesh must be its first."""
    from dvf_tpu_torch.parallel import mesh as mesh_mod

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(dt.get_filter("invert"))
    monkeypatch.setattr(mesh_mod, "local_devices", lambda: [CPU] * 4)
    eng = Engine(dt.get_filter("invert"))
    assert eng.mesh.shape == {"data": 4, "space": 1, "model": 1}
    assert eng.mesh == mesh_mod.make_mesh(devices=[CPU] * 4) and eng.device == CPU
    x = np.random.default_rng(0).integers(0, 255, (4, 8, 8, 3), np.uint8)
    np.testing.assert_array_equal(eng.submit(x).fetch(), 255 - x)
    assert len(eng.submit(x).device.shards) == 4
    monkeypatch.setattr(mesh_mod, "local_devices", lambda: [CPU])
    eng = Engine(dt.get_filter("invert"))
    assert eng.mesh is None and eng.devices == [CPU] and not eng._meshed
    monkeypatch.setattr(mesh_mod, "local_devices", lambda: [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(dt.get_filter("invert"))
    eng = Engine(dt.get_filter("invert"), device="cpu")
    assert eng.mesh is None and eng.devices == [CPU]
    m = mesh(data=2)
    eng = Engine(dt.get_filter("invert"), mesh=m)
    assert eng.mesh is m and eng.device == CPU
    Engine(dt.get_filter("invert"), device="cpu", mesh=m)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="disagree"):
        Engine(dt.get_filter("invert"), device="cuda:0", mesh=m)


@pytest.mark.parametrize("axes,shape", [
    (dict(data=2, space=4), (4, 64, 48, 3)),
    (dict(data=8), (4, 64, 48, 3)),        # batch does not divide: B whole
    (dict(data=2, space=4), (4, 62, 48, 3)),  # H does not divide
    (dict(space=8), (2, 64, 8, 3)),
])
def test_batch_pspec_matches_the_reference(axes, shape):
    got = batch_pspec(mesh(**axes), shape)
    from dvf_tpu.parallel.mesh import batch_pspec as ref_batch_pspec

    assert tuple(got) == tuple(ref_batch_pspec(ref_mesh(**axes), shape))
    assert pad_batch_size(5, mesh(**axes)) == \
        __import__("dvf_tpu.parallel.mesh", fromlist=["x"]).pad_batch_size(
            5, ref_mesh(**axes))


def test_devices_indices_map_matches_the_reference():
    shape = (4, 16, 8, 3)
    got = batch_sharding(mesh(data=2, space=2, model=2), shape)
    ref = jax.sharding.NamedSharding(
        ref_mesh(data=2, space=2, model=2),
        jax.sharding.PartitionSpec("data", "space"))
    rmap = ref.devices_indices_map(shape)
    rdevs = ref.mesh.devices
    for pos, idx in got.devices_indices_map(shape).items():
        want = rmap[rdevs[pos]]
        assert [(s.start or 0, s.stop or n) for s, n in zip(want, shape)] == \
            [(s.start, s.stop) for s in idx]
    # Replicas are not materialised: one block per distinct index.
    assert len(got.shards(shape)) == 4
    assert len(replicated(mesh(data=2)).shards(shape)) == 1


def test_shard_and_reshard_round_trip():
    x = torch.arange(8 * 16 * 8 * 3, dtype=torch.float32).reshape(8, 16, 8, 3)
    m = mesh(data=2, space=4)
    a = shard_batch(x, NamedSharding(m, P("data", "space")))
    assert all(t.is_contiguous() for t in a.shards)
    assert [tuple(t.shape) for t in a.shards] == [(4, 4, 8, 3)] * 8
    assert torch.equal(a.cpu(), x)
    b = a.reshard(NamedSharding(m, P(("data", "space"))))
    assert [tuple(t.shape) for t in b.shards] == [(1, 16, 8, 3)] * 8
    assert all(t.is_contiguous() for t in b.shards)
    assert torch.equal(b.cpu(), x)
    c = b.reshard(NamedSharding(m, P(None, "space")))
    assert torch.equal(c.cpu(), x)


# ------------------------------------------- spatial sharding (halo)


SPATIAL_CASES = [
    ("gaussian_blur", dict(ksize=9)),
    ("gaussian_blur", dict(ksize=3)),
    ("sobel", {}),
    ("bilateral", {}),
    ("sharpen", {}),
    ("sobel_bilateral", {}),   # chained radii compose (1 + 2)
    ("invert", {}),            # halo 0: no exchange at all
]


@pytest.mark.parametrize("name,kw", SPATIAL_CASES)
def test_spatial_filter_matches_unsharded(name, kw, batch):
    f = dt.get_filter(name, **kw)
    sf = spatial_filter(f, mesh(data=2, space=4))
    got, _ = sf.fn(torch.from_numpy(batch), None)
    want, _ = f.fn(torch.from_numpy(batch), None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    # ... and the reference's, sharded on its 8 devices.
    rf = dvf_tpu.get_filter(name, **kw)
    ref, _ = jax.jit(lambda b: ref_spatial_filter(
        rf, ref_mesh(data=2, space=4)).fn(b, None))(jnp.asarray(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_spatial_filter_space_only_mesh():
    tall = np.random.default_rng(8).random((2, 64, 40, 3), dtype=np.float32)
    f = dt.get_filter("gaussian_blur", ksize=9)
    got, _ = spatial_filter(f, mesh(space=8)).fn(torch.from_numpy(tall), None)
    want, _ = f.fn(torch.from_numpy(tall), None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    rf = dvf_tpu.get_filter("gaussian_blur", ksize=9)
    ref, _ = rf.fn(jnp.asarray(tall), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_spatial_filter_slab_too_thin_raises():
    sf = spatial_filter(dt.get_filter("gaussian_blur", ksize=9), mesh(space=8))
    with pytest.raises(ValueError, match="stencil radius"):
        sf.fn(torch.zeros((2, 32, 40, 3)), None)   # r=4, 32/8 = 4 rows
    with pytest.raises(ValueError, match="stencil radius"):
        halo_exchange_rows([torch.zeros((1, 2, 4, 3))] * 2, 2)


def test_spatial_filter_requires_halo():
    from dvf_tpu_torch.api.filter import stateless

    with pytest.raises(ValueError, match="halo"):
        spatial_filter(stateless("mystery", lambda b: b), mesh(space=2))


def test_spatial_filter_rejects_stateful():
    with pytest.raises(ValueError, match="stateless"):
        spatial_filter(dt.get_filter("flow_warp"), mesh(space=2))


def test_chain_halo_composition():
    for get in (dt.get_filter, dvf_tpu.get_filter):
        assert get("invert").halo == 0
        assert get("gaussian_blur", ksize=9).halo == 4
        assert get("sobel").halo == 1
        assert get("bilateral", d=5).halo == 2
        assert get("sobel_bilateral", d=5).halo == 3


def test_chain_per_stage_exchange_exact_for_asymmetric_stages():
    """A fused summed-radius exchange is NOT exact at the global border
    when an intermediate is not reflection-symmetric; per-stage exchange
    (the default for chains) matches the unsharded chain bit for bit."""
    from dvf_tpu_torch.api.filter import FilterChain, stateless
    from dvf_tpu_torch.ops.conv import reflect_pad_nhwc

    def shift_down(b):
        # y[i] = x[i-1] with a reflect-101 border: asymmetric on purpose.
        return reflect_pad_nhwc(b, 1, 0)[:, :-2]

    shift = stateless("shift_down", shift_down, halo=1)
    chain = FilterChain(shift, shift)
    x = torch.from_numpy(np.random.default_rng(3).random((2, 32, 8, 3),
                                                         dtype=np.float32))
    want, _ = chain.fn(x, None)
    got, _ = spatial_filter(chain, mesh(data=2, space=4)).fn(x, None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    fused, _ = spatial_filter(chain, mesh(data=2, space=4),
                              per_stage=False).fn(x, None)
    assert not np.allclose(fused.numpy(), want.numpy(), atol=1e-6)


def test_halo_slabs_are_contiguous_for_the_kernels():
    """Each extended slab is a fresh contiguous tensor (the kernel
    wrappers take nothing else), and its edge rows are reflect-101."""
    x = torch.arange(2 * 8 * 2 * 1, dtype=torch.float32).reshape(2, 8, 2, 1)
    slabs = [x[:, :4].contiguous(), x[:, 4:].contiguous()]
    ext = halo_exchange_rows(slabs, 2)
    assert all(t.is_contiguous() and t.shape[1] == 8 for t in ext)
    torch.testing.assert_close(ext[0][:, :2], x[:, 1:3].flip(1))
    torch.testing.assert_close(ext[0][:, 6:], x[:, 4:6])
    torch.testing.assert_close(ext[1][:, :2], x[:, 2:4])
    torch.testing.assert_close(ext[1][:, 6:], x[:, 5:7].flip(1))


# ------------------------------------------------- engine halo routing

ENGINE_HALO_CASES = [
    ("gaussian_blur", dict(ksize=9)),
    ("sobel_bilateral", {}),
]


@pytest.mark.parametrize("name,kw", ENGINE_HALO_CASES)
def test_engine_routes_stencils_through_explicit_halo(name, kw, rng):
    x = rng.integers(0, 255, (4, 64, 48, 3), np.uint8)
    eng = Engine(dt.get_filter(name, **kw), mesh=mesh(data=2, space=4))
    eng.compile(x.shape, np.uint8)
    assert eng._exec_filter.name.startswith("spatial("), eng._exec_filter.name
    assert tuple(eng.input_sharding.spec) == ("data", "space")
    got = port_out(eng, x)
    want = port_out(Engine(dt.get_filter(name, **kw), device="cpu"), x)
    np.testing.assert_array_equal(got, want)
    ref = ref_out(name, kw, x, data=2, space=4)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_engine_replicates_h_when_halo_unusable(rng, capsys):
    """A stateful filter on a space mesh keeps H whole (flow_warp's mesh
    body splits the batch over data only), and matches one device."""
    kw = dict(levels=1, win_size=7, n_iters=1, flow_scale=1)
    x = rng.integers(0, 255, (4, 48, 32, 3), np.uint8)
    eng = Engine(dt.get_filter("flow_warp", **kw), mesh=mesh(data=2, space=4))
    eng.compile(x.shape, np.uint8)
    spec = eng.input_sharding.spec
    assert len(spec) < 2 or spec[1] is None  # H axis not sharded
    one = Engine(dt.get_filter("flow_warp", **kw), device="cpu")
    for k in range(2):  # the pass-through batch, then a warped one
        xk = np.roll(x, k, axis=2)
        got, want = port_out(eng, xk), port_out(one, xk)
        np.testing.assert_array_equal(got, want)
    # An unknown-radius stateless filter keeps H whole with the
    # reference's stderr line.
    from dvf_tpu_torch.api.filter import stateless

    capsys.readouterr()
    eng = Engine(stateless("mystery", lambda b: 1.0 - b), mesh=mesh(data=2, space=4))
    eng.compile(x.shape, np.uint8)
    assert eng._exec_filter is eng.filter
    assert eng.input_sharding.spec[1] is None
    assert "can't halo-shard H" in capsys.readouterr().err


def test_engine_pointwise_keeps_sharding(rng):
    x = rng.integers(0, 255, (4, 64, 32, 3), np.uint8)
    eng = Engine(dt.get_filter("invert"), mesh=mesh(data=2, space=4))
    eng.compile(x.shape, np.uint8)
    assert eng._exec_filter is eng.filter
    assert tuple(eng.input_sharding.spec[:2]) == ("data", "space")
    np.testing.assert_array_equal(port_out(eng, x), 255 - x)


def test_equalize_space_sharded_matches_replicated():
    """Per-block counts + one sum over the frame's blocks equal the
    whole-frame result exactly; indivisible H replicates H, indivisible B
    keeps the space sharding."""
    m = mesh(data=2, space=4)
    for seed, shape, spaced in ((5, (4, 64, 48, 3), True),
                                (6, (4, 62, 48, 3), False),
                                (7, (3, 64, 48, 3), True)):
        x = np.random.default_rng(seed).integers(0, 255, shape, np.uint8)
        eng = Engine(dt.get_filter("equalize"), mesh=m)
        eng.compile(x.shape, np.uint8)
        assert eng._exec_filter.name.startswith("space(") == spaced
        got = port_out(eng, x)
        np.testing.assert_array_equal(
            got, port_out(Engine(dt.get_filter("equalize"), device="cpu"), x))
        np.testing.assert_array_equal(
            got, ref_out("equalize", {}, x, data=2, space=4))


# ------------------------------------------------ TestEngineMesh etc.


class TestEngineMesh:
    def test_data_parallel_mesh(self):
        eng = Engine(dt.get_filter("invert"), mesh=mesh(data=8))
        x = np.random.default_rng(0).integers(0, 255, (16, 32, 32, 3), np.uint8)
        np.testing.assert_array_equal(port_out(eng, x), 255 - x)
        np.testing.assert_array_equal(port_out(eng, x),
                                      ref_out("invert", {}, x, data=8))

    def test_spatial_mesh_conv(self):
        kw = dict(ksize=9, sigma=2.0)
        x = np.random.default_rng(0).integers(0, 255, (4, 64, 48, 3), np.uint8)
        out = port_out(Engine(dt.get_filter("gaussian_blur", **kw),
                              mesh=mesh(data=2, space=4)), x)
        one = port_out(Engine(dt.get_filter("gaussian_blur", **kw),
                              mesh=make_mesh(MeshConfig(), devices=[CPU])), x)
        np.testing.assert_allclose(out.astype(int), one.astype(int), atol=1)
        ref = ref_out("gaussian_blur", kw, x, data=2, space=4)
        np.testing.assert_allclose(out.astype(int), ref.astype(int), atol=1)

    def test_pipeline_over_a_mesh(self):
        """The pipeline over a mesh engine delivers every frame, in order,
        equal to one device (streamed ingest and egress per block)."""
        from dvf_tpu_torch.runtime import egress, ingest

        got = {}
        for m in (mesh(data=2, space=4), None):
            eng = (Engine(dt.get_filter("sobel_bilateral"), mesh=m) if m
                   else Engine(dt.get_filter("sobel_bilateral"), device="cpu"))
            out = []
            pipe = dt.Pipeline(
                dt.SyntheticSource(32, 40, n_frames=20, seed=0),
                dt.get_filter("sobel_bilateral"),
                dt.CallbackSink(lambda i, f, ts: out.append((i, f.copy()))),
                dt.PipelineConfig(batch_size=4, queue_size=100,
                                  assemble_timeout_s=30.0),
                engine=eng)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(ingest, "MIN_STREAM_H2D_MS", 0.0)
                mp.setattr(egress, "MIN_STREAM_D2H_MS", 0.0)
                mp.setattr(egress, "STREAM_ON_CPU", True)
                stats = pipe.run()
            assert stats["delivered"] == 20
            assert stats["ingest"]["mode"] == "streamed"
            assert stats["egress"]["mode"] == "streamed"
            got[m is None] = out
        assert [i for i, _ in got[False]] == list(range(20))
        for (i, a), (j, b) in zip(got[False], got[True]):
            np.testing.assert_array_equal(a, b)


def test_ema_smooth_keeps_h_sharding(rng):
    """halo == 0 + stateful: the mesh keeps H sharded and matches one
    device (test_flow.py's pointwise-stateful case), across batches and
    through frames that repeat in some blocks only."""
    x = rng.integers(0, 255, (4, 32, 32, 3), np.uint8)
    eng = Engine(dt.get_filter("ema_smooth"), mesh=mesh(data=2, space=4))
    eng.compile(x.shape, np.uint8)
    assert tuple(eng.input_sharding.spec[:2]) == ("data", "space")
    one = Engine(dt.get_filter("ema_smooth"), device="cpu")
    ref = RefEngine(dvf_tpu.get_filter("ema_smooth"), mesh=ref_mesh(data=2, space=4))
    part = x.copy()
    part[1, :8] = part[0, :8]   # frame 1 repeats frame 0 in block 0 only
    for xb in (x, part, np.repeat(x[-1:], 4, axis=0)):
        got = port_out(eng, xb)
        np.testing.assert_array_equal(got, port_out(one, xb))
        assert np.abs(got.astype(int)
                      - np.asarray(ref.submit(xb)).astype(int)).max() <= 1


# ---------------------------------------------- ingest / egress blocks


@pytest.mark.parametrize("axes,batch_n,depth", [
    (dict(data=1), 4, 1),
    (dict(data=1), 8, 4),
    (dict(data=4), 8, 2),            # batch-sharded
    (dict(data=2, space=2), 4, 2),   # batch + H sharded
    (dict(data=8), 8, 3),            # one row per device
])
def test_assembler_blocks_match_reference(axes, batch_n, depth, monkeypatch):
    """The assembler's per-block device buffers hold the padded host
    batch for every layout, across aliasing slots and short batches."""
    from dvf_tpu_torch.runtime import ingest
    from dvf_tpu_torch.runtime.ingest import ShardedBatchAssembler

    monkeypatch.setattr(ingest, "MIN_STREAM_H2D_MS", 0.0)
    h, w = 16, 24
    shape = (batch_n, h, w, 3)
    sharding = batch_sharding(mesh(**axes), shape)
    asm = ShardedBatchAssembler(shape, np.uint8, sharding, depth=depth, slots=3)
    assert asm.effective_mode == "streamed"
    for slot, valid in enumerate([batch_n, max(1, batch_n - 1), 1, batch_n]):
        rng = np.random.default_rng(slot)
        frames = [rng.integers(0, 255, (h, w, 3), np.uint8) for _ in range(valid)]
        b = asm.begin(slot)
        if slot % 2:
            for start, stop in b.windows(valid):
                view = b.window_view(start, stop)
                for i in range(stop - start):
                    np.copyto(view[i], frames[start + i])
                b.commit_window(start, stop)
        else:
            for row, f in enumerate(frames):
                b.write_row(row, f)
        arr, resident = b.finish(valid)
        assert resident
        want = np.stack(frames + [frames[-1]] * (batch_n - valid))
        if isinstance(arr, ShardedBatch):
            assert arr.sharding == sharding
            assert all(t.is_contiguous() for t in arr.shards)
            arr = arr.cpu()
        np.testing.assert_array_equal(arr.numpy(), want)


@pytest.mark.parametrize("axes,batch_n", [
    (dict(data=1), 4),
    (dict(data=4), 8),
    (dict(data=2, space=2), 4),
    (dict(data=8), 8),
    (dict(data=8), 4),     # B does not divide: one block
])
def test_fetch_matches_whole_batch(axes, batch_n, monkeypatch):
    from dvf_tpu_torch.runtime import egress
    from dvf_tpu_torch.runtime.egress import ShardedBatchFetcher

    monkeypatch.setattr(egress, "STREAM_ON_CPU", True)
    h, w = 16, 24
    eng = Engine(dt.get_filter("invert"), mesh=mesh(**axes))
    eng.ensure_compiled((batch_n, h, w, 3), np.uint8)
    fetcher = ShardedBatchFetcher(eng.out_shape, eng.out_dtype, eng.placement,
                                  slots=3)
    assert fetcher.effective_mode == "streamed"
    for slot in range(5):
        frames = np.random.default_rng(slot).integers(0, 255, (batch_n, h, w, 3),
                                                      np.uint8)
        result = eng.submit(frames.copy(), fetch=False)
        fetcher.prefetch(result, slot)
        out = fetcher.fetch(result, slot)
        np.testing.assert_array_equal(out, 255 - frames)
        assert fetcher.owns(out)
    s = fetcher.stats.summary()
    assert s["batches"] == 5 and s["pool_allocs"] == 1


def test_submit_resident_takes_the_compiled_layout():
    eng = Engine(dt.get_filter("invert"), mesh=mesh(data=2, space=2))
    x = torch.zeros((4, 16, 8, 3), dtype=torch.uint8)
    eng.compile(tuple(x.shape), np.uint8)
    sb = shard_batch(x, eng.input_sharding)
    assert torch.equal(eng.submit_resident(sb).device.cpu(), 255 - x)
    with pytest.raises(ValueError, match="laid out"):
        eng.submit_resident(shard_batch(x, NamedSharding(eng.mesh, P("data"))))
    with pytest.raises(ValueError, match="ShardedBatch"):
        eng.submit_resident(x)


# ------------------------------------------------------- plan cache


def test_topology_fingerprint_carries_the_mesh_axes():
    """The fingerprint names the mesh's axis shape (not a fixed one-device
    string); a meshless call equals the default engine's (one device,
    data=1,space=1,model=1), as the reference's meshless call equals its
    default mesh's."""
    from dvf_tpu.control import plan_cache as ref_pc
    from dvf_tpu.parallel.mesh import auto_mesh_config as ref_auto

    from dvf_tpu_torch.control import plan_cache as pc

    meshless = pc.topology_fingerprint()
    assert meshless == pc.topology_fingerprint(make_mesh(MeshConfig(), devices=[CPU]))
    assert meshless == pc.topology_fingerprint(CPU)
    assert meshless.endswith("/data=1,space=1,model=1")
    assert pc.topology_fingerprint(mesh(data=2, space=4)).endswith(
        "/data=2,space=4,model=1")
    assert ref_pc.topology_fingerprint() == ref_pc.topology_fingerprint(
        ref_make_mesh(ref_auto(len(jax.devices()))))


def test_serve_frontend_over_a_mesh(monkeypatch):
    """A serving frontend whose engine spans a mesh builds every bucket
    engine over it, fingerprints the mesh, and delivers bit-exactly."""
    from dvf_tpu_torch.serve import ServeConfig, ServeFrontend

    m = mesh(data=2, space=2)
    fe = ServeFrontend(dt.get_filter("invert"),
                       ServeConfig(batch_size=4, queue_size=64, slo_ms=60_000),
                       engine=Engine(dt.get_filter("invert"), mesh=m))
    with fe:
        assert fe.mesh is m
        assert fe._topology_fingerprint().endswith("/data=2,space=2,model=1")
        sid = fe.open_stream()
        frames = np.random.default_rng(1).integers(0, 255, (8, 16, 16, 3), np.uint8)
        for f in frames:
            fe.submit(sid, f)
        got = []
        import time

        t_end = time.time() + 30
        while len(got) < 8 and time.time() < t_end:
            got.extend(fe.poll(sid))
            time.sleep(0.01)
    assert [d.index for d in got] == list(range(8))
    for d, f in zip(got, frames):
        np.testing.assert_array_equal(d.frame, 255 - f)


def test_worker_over_several_devices_waits_for_4c_ii():
    """The worker over a multi-device mesh engine: its batches are staged
    block by block in the engine's input layout and it sends the bytes
    of the one-device worker, on the raw wire; a one-device mesh engine
    is the one device (the delta wire's codec assist over a mesh:
    tests/test_torch_worker_mesh.py)."""
    from dvf_tpu_torch.transport.zmq_ingress import ZmqWorker

    f = dt.get_filter("invert")
    frames = np.random.default_rng(4).integers(0, 255, (8, 16, 16, 3), np.uint8)
    blobs = [fr.tobytes() for fr in frames]
    sent = {}
    for label, eng in (("one", Engine(f, device="cpu")),
                       ("mesh", Engine(f, mesh=mesh(data=2, space=2))),
                       ("mesh1", Engine(f, mesh=make_mesh(MeshConfig(), devices=[CPU])))):
        w = ZmqWorker(f, engine=eng, device="cpu", use_jpeg=False, raw_size=16,
                      batch_size=4, connect=False)
        got = []
        try:
            for s in (0, 4):
                w.process_batch(list(enumerate(blobs))[s:s + 4],
                                lambda i, t0, t1, p: got.append((i, p)))
            w.drain_egress()
            assert w.stats()["errors"] == 0
        finally:
            w.close()
        sent[label] = got
    assert [i for i, _ in sent["mesh"]] == list(range(8))
    assert sent["mesh"] == sent["one"] == sent["mesh1"]
    assert [np.frombuffer(p, np.uint8).reshape(16, 16, 3).tolist()
            for _, p in sent["mesh"]] == (255 - frames).tolist()
