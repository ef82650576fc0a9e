"""Compile check and multi-device dry run (port of the repository root's
``__graft_entry__.py``).

``entry()`` returns the flagship model's forward (the style-transfer net,
``models/style_transfer.py``) with example arguments. ``dryrun_multichip(n)``
builds an n-position ``(data, space, model)`` mesh and drives the sharded
paths against one device: the halo-exchanged and the psum'd engine, the
stateful flow filter, style PP, ESPCN TP (with and without the exact
fast convs), ``Pipeline.run`` on the halo mesh and one full sharded style
train step (forward, perceptual loss, backward, Adam) on tiny shapes, at
the reference's shapes and tolerances.

Run it with ``python -m dvf_tpu_torch.dryrun [N] [--device cpu]``.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def entry(device: Union[None, str, torch.device] = None):
    """(fn, example_args): the style net's forward at its default widths
    and a (4, 256, 256, 3) batch on ``device`` (``cuda:0`` by default;
    raises without CUDA unless the CPU is named)."""
    from dvf_tpu_torch.models import StyleNetConfig, apply_style_net, init_style_net
    from dvf_tpu_torch.models.layers import tree_to
    from dvf_tpu_torch.runtime.engine import resolve_device

    dev = resolve_device(device)
    config = StyleNetConfig(base_channels=32, n_residual=5)
    params = tree_to(init_style_net(0, config), dev)
    batch = torch.full((4, 256, 256, 3), 0.5, dtype=torch.float32, device=dev)

    def fn(params, batch):
        with torch.no_grad():
            return apply_style_net(params, batch, config)

    return fn, (params, batch)


def _factor_mesh(n: int):
    """Split n devices over (data, space, model), data-major."""
    from dvf_tpu_torch.parallel.mesh import MeshConfig

    space = 2 if n % 2 == 0 and n >= 4 else 1
    model = 2 if (n // space) % 2 == 0 and n // space >= 2 else 1
    return MeshConfig(data=n // (space * model), space=space, model=model)


def dryrun_devices(n: int, device: Union[None, str, torch.device] = None
                   ) -> List[torch.device]:
    """The n mesh devices: the first n attached cards where there are n;
    else a virtual mesh, n times ``cuda:0`` (a mesh may repeat a device);
    n times the named device when ``device`` is given (``"cpu"`` for the
    CPU, never chosen unasked). Raises without CUDA unless the CPU is
    named."""
    from dvf_tpu_torch.parallel.mesh import local_devices
    from dvf_tpu_torch.runtime.engine import resolve_device

    if device is not None:
        return [resolve_device(device)] * n
    cards = local_devices()
    if len(cards) >= n:
        return cards[:n]
    return [resolve_device(None)] * n


def _launches() -> Dict[str, int]:
    from dvf_tpu_torch.ops import kernels

    return dict(kernels.LAUNCHES)


def dryrun_multichip(n_devices: int, device: Union[None, str, torch.device] = None
                     ) -> List[dict]:
    """One pass of every sharded path on an n-position mesh, each held to
    one device; raises at the first that disagrees. Returns a row per
    sub-check (label, mesh, max difference, kernel launches)."""
    from dvf_tpu_torch.io import CallbackSink, SyntheticSource
    from dvf_tpu_torch.models import StyleNetConfig
    from dvf_tpu_torch.models.vgg import VGGConfig
    from dvf_tpu_torch.ops import get_filter
    from dvf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from dvf_tpu_torch.parallel.sharded import shard_batch
    from dvf_tpu_torch.runtime import Pipeline, PipelineConfig
    from dvf_tpu_torch.runtime.engine import Engine
    from dvf_tpu_torch.train import StyleTrainConfig, init_train_state, make_train_step
    from dvf_tpu_torch.train.style import shard_train_state, train_batch_sharding

    devices = dryrun_devices(n_devices, device)
    mesh_config = _factor_mesh(n_devices)
    mesh = make_mesh(mesh_config, devices=devices)
    rows: List[dict] = []

    def axes(cfg) -> str:
        return f"({cfg.data},{cfg.space},{cfg.model})"

    def record(label: str, cfg, before: Dict[str, int], **kw) -> None:
        after = _launches()
        row = {"label": label, "mesh": axes(cfg),
               "launches": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}, **kw}
        rows.append(row)
        print(f"dryrun {label} ok: mesh={row['mesh']} "
              + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)

    def engine_vs_single_device(label: str, make_filt: Callable, mesh_cfg,
                                batches: Sequence[np.ndarray],
                                expect_name: Optional[str] = None,
                                ref_filt: Optional[Callable] = None,
                                tol: int = 1) -> None:
        """Run ``batches`` through an Engine on the sharded mesh and on
        one device; max |diff| <= tol uint8 steps. ``expect_name``: the
        engine routed through that specialization; ``ref_filt`` overrides
        the reference filter (PP compares against the flat net)."""
        before = _launches()
        m = make_mesh(mesh_cfg, devices=devices[: mesh_cfg.n_devices])
        eng = Engine(make_filt(), mesh=m)
        eng.compile(batches[0].shape, np.uint8)
        if expect_name is not None:
            assert eng._exec_filter.name.startswith(expect_name), (
                f"{label}: expected {expect_name!r} specialization, got "
                f"{eng._exec_filter.name!r}")
        ref = Engine((ref_filt or make_filt)(), device=devices[0])
        diff = max(
            int(np.abs(eng.submit(b).fetch().astype(int)
                       - ref.submit(b).fetch().astype(int)).max())
            for b in batches)
        assert diff <= tol, f"{label} diverges from single-device: {diff}"
        record(label, mesh_cfg, before, batches=len(batches), maxdiff=diff)

    rng = np.random.default_rng(0)

    # 1: a stencil through the explicit halo exchange on a space > 1 mesh.
    halo_cfg = MeshConfig(data=max(1, n_devices // 4), space=min(4, n_devices))
    engine_vs_single_device(
        "engine-halo(sobel_bilateral)", lambda: get_filter("sobel_bilateral"),
        halo_cfg, [rng.integers(0, 255, (2 * halo_cfg.data, 64, 48, 3), np.uint8)],
        expect_name="spatial(")

    # 1b: a whole-frame statistic crossing the shards as one sum (integer
    # counts: exact).
    engine_vs_single_device(
        "engine-psum(equalize)", lambda: get_filter("equalize"), halo_cfg,
        [rng.integers(0, 255, (2 * halo_cfg.data, 64, 48, 3), np.uint8)],
        expect_name="space(", tol=0)

    # 2: temporal state carried across batches on the mesh.
    flow_cfg = MeshConfig(data=min(2, n_devices))
    engine_vs_single_device(
        "engine-flow(flow_warp)", lambda: get_filter("flow_warp"), flow_cfg,
        [rng.integers(0, 255, (2 * flow_cfg.data, 48, 32, 3), np.uint8)
         for _ in range(2)])

    if n_devices >= 2:
        # 3: the style trunk pipelined over the model axis, held to the
        # flat net (a pp-vs-pp comparison would share the regrouping).
        mp_cfg = MeshConfig(data=max(1, n_devices // 4), model=2)
        engine_vs_single_device(
            "engine-pp(style_transfer)",
            lambda: get_filter("style_transfer", base_channels=8, n_residual=4,
                               parallel="pp"),
            mp_cfg, [rng.integers(0, 255, (2 * mp_cfg.data, 32, 32, 3), np.uint8)],
            expect_name="pp(",
            ref_filt=lambda: get_filter("style_transfer", base_channels=8,
                                        n_residual=4),
            tol=4)

        # 4: ESPCN tensor-parallel, its 2x geometry through the mesh path.
        engine_vs_single_device(
            "engine-tp(super_resolution)", lambda: get_filter("super_resolution"),
            mp_cfg, [rng.integers(0, 255, (2 * mp_cfg.data, 32, 32, 3), np.uint8)],
            expect_name="tp(")

        # 4b: TP with the exact fast-conv rewrites (bfloat16 reassociation).
        engine_vs_single_device(
            "engine-tp-fast(super_resolution)",
            lambda: get_filter("super_resolution", fast_convs=True), mp_cfg,
            [rng.integers(0, 255, (2 * mp_cfg.data, 32, 32, 3), np.uint8)],
            expect_name="tp(", tol=4)

    # 5: Pipeline.run over the halo mesh: every frame, in order, within
    # 1 LSB of the one-device pipeline.
    def run_pipeline(engine, batch_size: int):
        got, order = {}, []

        def sink(idx, frame, _ts):
            order.append(idx)
            got[idx] = np.asarray(frame)

        stats = Pipeline(SyntheticSource(height=64, width=48, n_frames=24),
                         get_filter("sobel_bilateral"), CallbackSink(sink),
                         PipelineConfig(batch_size=batch_size, queue_size=100),
                         engine=engine).run()
        return got, order, stats

    before = _launches()
    got_mesh, order_mesh, pstats = run_pipeline(Engine(
        get_filter("sobel_bilateral"),
        mesh=make_mesh(halo_cfg, devices=devices[: halo_cfg.n_devices])), 2 * halo_cfg.data)
    got_one, _, _ = run_pipeline(Engine(get_filter("sobel_bilateral"), device=devices[0]),
                                 2 * halo_cfg.data)
    assert pstats["delivered"] == 24, f"pipeline delivered {pstats}"
    assert order_mesh == sorted(order_mesh), "out-of-order delivery"
    pdiff = max(int(np.abs(got_mesh[i].astype(int) - got_one[i].astype(int)).max())
                for i in got_one)
    assert pdiff <= 1, f"pipeline-on-mesh diverges from single-device: {pdiff}"
    record("engine-pipeline(Pipeline.run)", halo_cfg, before,
           delivered=pstats["delivered"], maxdiff=pdiff)

    # 6: one full sharded train step on tiny but shardable shapes
    # (channels divisible by the model axis, batch by data x space).
    before = _launches()
    train_config = StyleTrainConfig(net=StyleNetConfig(base_channels=8, n_residual=2),
                                    vgg=VGGConfig(blocks=((1, 8), (1, 16))))
    style_image = np.full((1, 32, 32, 3), 0.25, np.float32)
    state = init_train_state(0, style_image, train_config, device=devices[0])
    state = shard_train_state(state, mesh, train_config)
    step = make_train_step(mesh, train_config, state_template=state)
    batch = shard_batch(
        np.full((2 * mesh_config.data * mesh_config.space, 64, 64, 3), 0.5, np.float32),
        train_batch_sharding(mesh))
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    record("train-step", mesh_config, before, step=int(state.step), loss=round(loss, 4))
    print(f"dryrun_multichip ok: mesh={axes(mesh_config)} step={int(state.step)} "
          f"loss={loss:.4f}", flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m dvf_tpu_torch.dryrun",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="run every mesh position on this device (e.g. cpu)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry ok:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
