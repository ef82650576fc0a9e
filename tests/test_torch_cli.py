"""The port's command line (``python -m dvf_tpu_torch``), held to the JAX
package's (``dvf_tpu.cli``): the counterpart of tests/test_cli.py (its
``bench`` cases included) and of the CLI cases of tests/test_checkpoint.py,
test_sr_demo.py and test_style_demo.py (training), plus the parser's surface, the final JSON lines'
key sets, the device choice and the frames a display sink sees, on the
CPU at small shapes. The subprocess pairs (camera → serve over shm) are
in tests/test_torch_cli_shm.py."""

import argparse
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

import dvf_tpu.cli as ref_cli
import dvf_tpu_torch.cli as cli
from dvf_tpu_torch.cli import main
from torch_ring_util import jax_native_isolated  # noqa: F401
from torch_serve_util import port_fleet_guard, port_leak_guard  # noqa: F401

SHARED = ("filters", "doctor", "serve", "subscribe", "fleet", "camera",
          "worker", "trace-view", "train", "train-sr", "bench")


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def cpu(monkeypatch):
    """The CPU platform for this test; the env var is restored after."""
    monkeypatch.setenv("DVF_FORCE_PLATFORM", "cpu")


@pytest.fixture
def build_dirs_restored(monkeypatch):
    """--compile-cache-dir moves the build directories of this process:
    put them back after the test."""
    from dvf_tpu_torch.ops import _build
    from dvf_tpu_torch.transport import _native

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_native, "BUILD_DIR", _native.BUILD_DIR)


# ---------------------------------------------------------------------------
# The counterparts of tests/test_cli.py
# ---------------------------------------------------------------------------


def test_filters_lists_registry(capsys):
    assert main(["filters"]) == 0
    out = capsys.readouterr().out.split()
    for expected in ("invert", "gaussian_blur", "bilateral", "style_transfer",
                     "sobel_bilateral", "flow_warp", "bilateral_pallas"):
        assert expected in out


def test_filters_output_equals_the_references(capsys):
    import dvf_tpu_torch

    assert main(["filters"]) == 0
    ours = capsys.readouterr().out
    assert ref_cli.main(["filters"]) == 0
    assert ours == capsys.readouterr().out
    assert ours.split() == dvf_tpu_torch.list_filters()
    # -v: the same names in the same order, each with its own one-liner.
    assert main(["filters", "-v"]) == 0
    ours_v = capsys.readouterr().out.splitlines()
    assert ref_cli.main(["filters", "-v"]) == 0
    ref_v = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in ours_v] == [ln.split()[0] for ln in ref_v]


def test_serve_synthetic(capsys, cpu):
    rc = main([
        "serve", "--filter", "invert", "--source", "synthetic",
        "--height", "32", "--width", "32", "--frames", "20",
        "--batch", "4", "--frame-delay", "0", "--queue-size", "64",
    ])
    assert rc == 0
    stats = _last_json(capsys.readouterr().out)
    assert stats["delivered"] == 20


def test_serve_filter_config(capsys, cpu):
    rc = main([
        "serve", "--filter", "gaussian_blur", "--filter-config", '{"ksize": 3}',
        "--source", "synthetic", "--height", "32", "--width", "32",
        "--frames", "8", "--batch", "4", "--frame-delay", "0",
        "--queue-size", "64",
    ])
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["delivered"] == 8


def test_bench_configs_cover_baseline():
    # BASELINE.json configs[0..4] + headline all present, with the
    # reference's keys and shapes.
    assert {"invert_1080p", "invert_640x480", "gauss3_1080p", "gauss9_1080p",
            "sobel_bilateral_1080p", "flow_720p", "style_720p"} <= set(cli.BENCH_CONFIGS)
    assert cli.BENCH_CONFIGS == ref_cli.BENCH_CONFIGS


def test_bench_runs_small(capsys, monkeypatch, cpu):
    # Shrink a config so the device-resident loop runs fast on the CPU.
    monkeypatch.setitem(cli.BENCH_CONFIGS, "invert_1080p",
                        dict(filter=("invert", {}), h=32, w=32, batch=4))
    rc = main(["bench", "--config", "invert_1080p", "--iters", "3"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["unit"] == "fps" and out["value"] > 0
    # On the CPU no roofline claim: the H100's peaks are not the CPU's.
    assert "hbm_roofline_frac" not in out and "mfu" not in out


def test_bench_with_auto_mesh(capsys, cpu):
    """--mesh auto over the one attached device is the single-device
    engine."""
    rc = main(["bench", "--config", "invert_640x480", "--iters", "3",
               "--batch", "8", "--mesh", "auto"])
    assert rc == 0
    out = _last_json(capsys.readouterr().out)
    assert out["value"] > 0


def test_bench_over_several_cards_exits_2(monkeypatch, capsys, cpu):
    """bench --mesh runs the engine over a mesh of the attached devices
    (here eight CPU entries stand in for cards); it exits 2 only when the
    mesh needs more devices than are attached."""
    monkeypatch.setattr(cli, "_mesh_devices", lambda: [torch.device("cpu")] * 8)
    rc = main(["bench", "--config", "invert_640x480", "--iters", "3",
               "--batch", "8", "--mesh", "auto"])
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["value"] > 0
    with pytest.raises(SystemExit) as ei:
        main(["bench", "--config", "invert_640x480", "--mesh", "data=16"])
    assert ei.value.code == 2
    assert "needs 16 devices, have 8" in capsys.readouterr().err


@pytest.mark.parametrize("e2e", [False, True], ids=["device", "e2e"])
def test_bench_json_keys_equal_the_references(e2e, capsys, monkeypatch, cpu):
    small = dict(filter=("gaussian_blur", {"ksize": 3}), h=16, w=24, batch=4)
    monkeypatch.setitem(cli.BENCH_CONFIGS, "gauss3_1080p", small)
    monkeypatch.setitem(ref_cli.BENCH_CONFIGS, "gauss3_1080p", small)
    argv = ["bench", "--config", "gauss3_1080p", "--iters", "2",
            "--platform", "cpu"] + (["--e2e", "--frames", "16"] if e2e else [])
    ours = _keys_of(lambda: main(argv), capsys)
    assert ours == _keys_of(lambda: ref_cli.main(argv), capsys)
    assert ("p50_ms" in ours) is e2e


@pytest.mark.parametrize("wire", ["jpeg", "delta"])
def test_bench_codec_wire_without_the_jpeg_codec_exits_2(wire, capsys,
                                                         monkeypatch, cpu):
    """Both codec wires encode with the native JPEG codec: where it cannot
    be built (no libjpeg, as on the card machine) the leg exits 2 and says
    why; it is never skipped or swapped for another wire."""
    from dvf_tpu_torch.transport import codec

    def no_shim():
        raise RuntimeError("jpeg_shim build failed: no libjpeg")

    monkeypatch.setattr(codec, "_load_shim", no_shim)
    rc = main(["bench", "--config", "invert_640x480", "--e2e", "--transport",
               "ring", "--wire", wire])
    assert rc == 2
    assert f"--wire {wire} needs the JPEG codec" in capsys.readouterr().err


def test_bench_wire_needs_the_ring_and_e2e(capsys, cpu):
    assert main(["bench", "--config", "invert_640x480", "--e2e",
                 "--wire", "jpeg"]) == 2
    assert "needs --transport ring" in capsys.readouterr().err
    assert main(["bench", "--config", "invert_640x480",
                 "--transport", "ring"]) == 2
    assert "only apply to --e2e" in capsys.readouterr().err


def test_fleet_scaling_keys_equal_the_references(capsys):
    argv = ["fleet", "--scaling", "--mode", "local", "--replicas", "2",
            "--sessions", "2", "--frames", "6", "--height", "16",
            "--width", "16", "--batch", "2", "--platform", "cpu"]
    assert main(argv) == 0
    ours = _last_json(capsys.readouterr().out)
    assert ref_cli.main(argv) == 0
    theirs = _last_json(capsys.readouterr().out)
    assert set(ours) == set(theirs)
    assert set(ours["rounds"]) == set(theirs["rounds"]) == {"1", "2"}
    assert set(ours["rounds"]["2"]) == set(theirs["rounds"]["2"])
    assert ours["rounds"]["2"]["delivered"] == ours["rounds"]["2"]["expected"] == 12
    assert ours["scaling"]["1"] == 1.0 and ours["pinned_replicas"] is False
    assert ours["filter"] == theirs["filter"]


def test_serve_ring_transport(capsys, cpu):
    """serve --transport ring: the port's native ring on the hot path."""
    rc = main([
        "serve", "--filter", "invert", "--source", "synthetic",
        "--height", "32", "--width", "32", "--frames", "20",
        "--batch", "4", "--frame-delay", "0", "--queue-size", "64",
        "--transport", "ring", "--quiet",
    ])
    assert rc == 0
    stats = _last_json(capsys.readouterr().out)
    assert stats["delivered"] == 20
    assert stats["transport"] == "RingFrameQueue"


def _jpeg_shim_or_skip():
    from dvf_tpu_torch.transport.codec import NativeJpegCodec

    try:
        NativeJpegCodec(threads=1).close()
    except RuntimeError as e:
        pytest.skip(f"the native JPEG shim does not build here: {e}")


def test_serve_ring_transport_jpeg_wire(capsys, cpu):
    _jpeg_shim_or_skip()
    rc = main([
        "serve", "--filter", "invert", "--source", "synthetic",
        "--height", "32", "--width", "32", "--frames", "12",
        "--batch", "4", "--frame-delay", "0", "--queue-size", "64",
        "--transport", "ring", "--wire", "jpeg",
    ])
    assert rc == 0
    captured = capsys.readouterr()
    assert _last_json(captured.out)["delivered"] == 12
    # No rate requested → informational budget line, not the warning.
    assert "jpeg wire budget" in captured.err
    assert "WARNING" not in captured.err


def test_serve_jpeg_wire_warns_when_rate_exceeds_codec_budget(capsys, cpu):
    """--wire jpeg at a rate the host codec cannot sustain warns loudly
    and points at --wire raw. 1e9 fps exceeds any host's capacity."""
    _jpeg_shim_or_skip()
    rc = main([
        "serve", "--filter", "invert", "--source", "synthetic",
        "--height", "32", "--width", "32", "--frames", "12",
        "--batch", "4", "--frame-delay", "0", "--queue-size", "64",
        "--transport", "ring", "--wire", "jpeg", "--rate", "1000000000",
    ])
    assert rc == 0
    err = capsys.readouterr().err
    assert "WARNING: --wire jpeg cannot sustain" in err
    assert "--wire raw" in err


def test_serve_with_explicit_one_device_mesh(capsys, cpu):
    """--mesh data=1 is the single-device engine: it serves."""
    rc = main([
        "serve", "--filter", "gaussian_blur", "--filter-config",
        '{"ksize": 3}', "--source", "synthetic", "--height", "32",
        "--width", "32", "--frames", "16", "--batch", "8",
        "--frame-delay", "0", "--queue-size", "64", "--mesh", "data=1",
    ])
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["delivered"] == 16


def test_serve_mesh_larger_than_the_devices_fails(cpu):
    with pytest.raises(SystemExit, match="bad --mesh.*needs 2 devices, have 1"):
        main(["serve", "--filter", "invert", "--height", "16", "--width", "16",
              "--frames", "4", "--mesh", "data=2"])


def test_bad_mesh_arg_fails_loudly(cpu):
    from dvf_tpu_torch.cli import _parse_mesh

    for arg in ("rows=2", "data=two", "data=0", "auto:bogus", "data=512"):
        with pytest.raises(SystemExit, match="bad --mesh"):
            _parse_mesh(arg)
    with pytest.raises(SystemExit, match="duplicate axis"):
        _parse_mesh("data=2,data=4")
    assert _parse_mesh(None) is None
    assert _parse_mesh("auto") is None and _parse_mesh("auto:space") is None
    # The same forms are refused by the reference's parser.
    for arg in ("rows=2", "data=two", "data=0", "auto:bogus", "data=512"):
        with pytest.raises(SystemExit, match="bad --mesh"):
            ref_cli._parse_mesh(arg)


def test_mesh_over_several_cards_exits_2(monkeypatch, capsys):
    """Where enough cards are attached, --mesh builds a mesh over them;
    it exits 2 when the mesh needs more cards than are attached. The
    worker's --mesh over several devices builds its engine over that
    mesh (its run loop stood in for by an immediate return)."""
    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = cli._parse_mesh("data=2")
    assert list(m.devices.flat) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert m.shape == {"data": 2, "space": 1, "model": 1}
    assert cli._parse_mesh("auto:space").shape == {"data": 1, "space": 2, "model": 1}
    assert cli._parse_mesh("data=1") is None
    with pytest.raises(SystemExit, match="needs 4 devices, have 2") as ei:
        cli._parse_mesh("data=4")
    assert ei.value.code == 2
    capsys.readouterr()
    pytest.importorskip("zmq")
    import dvf_tpu_torch.transport.zmq_ingress as zmq_mod

    workers = []
    monkeypatch.setattr(zmq_mod.ZmqWorker, "run",
                        lambda self, *a, **k: workers.append(self))
    worker_argv = ["worker", "--filter", "invert", "--no-jpeg", "--mesh",
                   "data=2,space=2", "--distribute-port", str(_free_port()),
                   "--collect-port", str(_free_port())]
    monkeypatch.setenv("DVF_FORCE_PLATFORM", "cpu")
    with pytest.raises(SystemExit) as ei:
        main(worker_argv)
    assert ei.value.code == 2
    assert "needs 4 devices, have 1" in capsys.readouterr().err
    monkeypatch.setattr(cli, "_mesh_devices", lambda: [torch.device("cpu")] * 4)
    assert main(worker_argv) == 0
    (w,) = workers
    assert w.engine.mesh.shape == {"data": 2, "space": 2, "model": 1}
    assert w.engine.devices == [torch.device("cpu")]


def test_serve_with_explicit_mesh(monkeypatch, capsys, cpu):
    """Counterpart of the reference's: a data=2,space=2,model=2 mesh over
    eight virtual devices serves the stream end to end."""
    monkeypatch.setattr(cli, "_mesh_devices", lambda: [torch.device("cpu")] * 8)
    rc = main([
        "serve", "--filter", "gaussian_blur", "--filter-config",
        '{"ksize": 3}', "--source", "synthetic", "--height", "32",
        "--width", "32", "--frames", "16", "--batch", "8",
        "--frame-delay", "0", "--queue-size", "64",
        "--mesh", "data=2,space=2,model=2",
    ])
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["delivered"] == 16
    rc = main(["serve", "--filter", "invert", "--source", "synthetic",
               "--height", "32", "--width", "32", "--frames", "16",
               "--batch", "4", "--sessions", "2", "--quiet",
               "--mesh", "data=2,space=2"])
    assert rc == 0


def test_filter_pipe_composition(capsys, cpu):
    rc = main([
        "serve", "--filter", "gaussian_blur|invert", "--source", "synthetic",
        "--height", "32", "--width", "32", "--frames", "16", "--batch", "8",
        "--frame-delay", "0", "--queue-size", "64",
    ])
    assert rc == 0
    assert _last_json(capsys.readouterr().out)["delivered"] == 16


def test_filter_pipe_composition_rejects_config_and_singletons():
    from dvf_tpu_torch.cli import _parse_filter_arg

    for fn in (_parse_filter_arg, ref_cli._parse_filter_arg):
        with pytest.raises(SystemExit, match="chain") as a:
            fn("invert|sobel", '{"ksize": 3}')
        with pytest.raises(SystemExit, match="bad chain") as b:
            fn("invert|", None)
    assert _parse_filter_arg("invert|invert", None).name == \
        ref_cli._parse_filter_arg("invert|invert", None).name


def _write_clip(path: str) -> None:
    cv2 = pytest.importorskip("cv2")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    assert wr.isOpened()
    for i in range(20):
        frame = np.full((48, 64, 3), i * 10, np.uint8)
        frame[:, : i * 3, 0] = 255  # moving edge
        wr.write(frame)
    wr.release()


def test_serve_video_file_end_to_end(tmp_path, capsys, cpu):
    """A real encoded video file through the whole pipeline: cv2 decode →
    batch → device → ordered sink (native geometry: only a fixed-geometry
    consumer center-crops to --target-size), and the same frames the
    reference's CLI delivers from the same file."""
    path = str(tmp_path / "clip.avi")
    _write_clip(path)
    argv = ["serve", "--filter", "invert", "--source", path,
            "--target-size", "32", "--frames", "100", "--batch", "4",
            "--frame-delay", "0", "--queue-size", "64", "--quiet",
            "--display", "--headless"]
    ours, ref = _capture_display(lambda: main(argv)), \
        _capture_display(lambda: ref_cli.main(argv), ref=True)
    assert [i for i, _ in ours] == list(range(20)) == [i for i, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        assert a.shape == (48, 64, 3)
        np.testing.assert_array_equal(a, b)
    assert _last_json(capsys.readouterr().out)["delivered"] == 20


def test_doctor_reports_environment(capsys, cpu):
    rc = main(["doctor", "--probe-timeout", "120"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["ring_shim"] == "ok"
    assert "jpeg_shim" in out and "backend" in out and "compile_cache" in out
    assert out["backend"] == {"platform": "cpu", "n_devices": 1,
                              "kinds": ["cpu"]}
    assert set(out["mesh_suggestions"]) == {"data", "space", "model"}
    from dvf_tpu_torch.runtime.engine import DEFAULT_COMPILE_CACHE_DIR

    assert out["compile_cache"]["dir"] == DEFAULT_COMPILE_CACHE_DIR


def test_doctor_without_cuda_reports_a_backend_error(capsys, monkeypatch):
    """The default platform is cuda: where there is no card the probe
    fails, and doctor answers 1 as the reference does for an
    unreachable backend."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is attached")
    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    rc = main(["doctor", "--probe-timeout", "120"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert "no CUDA device" in out["backend"]["error"]
    assert "mesh_suggestions" not in out


def test_platform_flag_forces_backend(capsys, monkeypatch):
    """--platform cpu == DVF_FORCE_PLATFORM=cpu, on any subcommand; the
    variable does not leak past main()."""
    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    calls = {}
    real = cli.cmd_doctor

    def spy(args):
        calls["env"] = os.environ.get("DVF_FORCE_PLATFORM")
        return real(args)

    monkeypatch.setattr(cli, "cmd_doctor", spy)  # dispatch uses the module dict
    rc = main(["doctor", "--platform", "cpu", "--probe-timeout", "120"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["backend"]["platform"] == "cpu"
    assert calls["env"] == "cpu"
    assert os.environ.get("DVF_FORCE_PLATFORM") is None
    # A prior value is restored, not dropped.
    monkeypatch.setenv("DVF_FORCE_PLATFORM", "cuda")
    main(["doctor", "--platform", "cpu", "--probe-timeout", "120"])
    capsys.readouterr()
    assert os.environ["DVF_FORCE_PLATFORM"] == "cuda"


def test_observability_flags_consistent_across_tiers(capsys):
    """Every tier that accepts --metrics-port also accepts --trace, the
    flight flag and the audit flags with the same spelling."""
    for tier in ("serve", "fleet", "worker"):
        with pytest.raises(SystemExit) as ei:
            main([tier, "--help"])
        assert ei.value.code == 0
        text = capsys.readouterr().out
        for flag in ("--metrics-port", "--trace", "--flight-dir", "--audit",
                     "--audit-wire", "--platform"):
            assert flag in text, (tier, flag)
        if tier == "fleet":
            assert "--audit-interval" in text
            assert "--audit-quarantine" in text


def test_trace_view_in_help(capsys):
    with pytest.raises(SystemExit) as ei:
        main(["--help"])
    assert ei.value.code == 0
    text = capsys.readouterr().out
    assert "trace-view" in text
    assert ",train,train-sr,bench" in text


# ---------------------------------------------------------------------------
# The parser's surface against the reference's
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _parser_of(main_fn, monkeypatch) -> argparse.ArgumentParser:
    """The top-level parser ``main_fn`` builds, caught at parse time."""
    caught = {}

    def grab(self, *a, **k):
        caught["ap"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main_fn(["filters"])
    return caught["ap"]


def _subparsers(ap) -> dict:
    action = next(a for a in ap._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(parser) -> dict:
    return {max(a.option_strings or [a.dest], key=len):
            (a.default, tuple(a.choices) if a.choices else None, a.nargs,
             getattr(a, "const", None), a.required)
            for a in parser._actions}


def test_subcommands_are_the_references_minus_bench(monkeypatch):
    """The port's subcommands equal the reference's (the name is from
    when ``bench`` was the one missing), so the option-parity test below
    covers every one of them."""
    ours = set(_subparsers(_parser_of(main, monkeypatch)))
    ref = set(_subparsers(_parser_of(ref_cli.main, monkeypatch)))
    assert ours == ref
    assert ours == set(SHARED)


@pytest.mark.parametrize("sub", SHARED)
def test_subcommand_options_equal_the_references(monkeypatch, sub):
    """Each shared subcommand takes the reference's options, with its
    defaults, choices and arities."""
    ours = _options(_subparsers(_parser_of(main, monkeypatch))[sub])
    ref = _options(_subparsers(_parser_of(ref_cli.main, monkeypatch))[sub])
    assert ours == ref


# ---------------------------------------------------------------------------
# The device: cuda:0 by default, the CPU only when asked for, rc 2 without
# CUDA
# ---------------------------------------------------------------------------

_NO_CUDA_ARGV = {
    "serve": ["serve", "--filter", "invert", "--height", "16", "--width", "16",
              "--frames", "4"],
    "serve-sessions": ["serve", "--sessions", "2", "--filter", "invert",
                       "--height", "16", "--width", "16", "--frames", "4"],
    "fleet": ["fleet", "--mode", "local", "--replicas", "1", "--sessions", "1",
              "--height", "16", "--width", "16", "--frames", "4"],
    "worker": ["worker", "--filter", "invert", "--no-jpeg"],
    "train": ["train", "--steps", "1", "--batch", "1", "--size", "16"],
    "train-sr": ["train-sr", "--steps", "1", "--batch", "1", "--size", "16"],
    "bench": ["bench", "--config", "invert_640x480", "--iters", "1"],
    "bench-e2e": ["bench", "--config", "invert_640x480", "--e2e"],
    "fleet-scaling": ["fleet", "--scaling", "--mode", "local", "--height", "16",
                      "--width", "16", "--frames", "4"],
}


@pytest.mark.parametrize("which", sorted(_NO_CUDA_ARGV))
def test_without_cuda_every_device_subcommand_exits_2(which, monkeypatch, capsys):
    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(_NO_CUDA_ARGV[which]) == 2
    err = capsys.readouterr().err
    assert "error: no CUDA device (pass --platform cpu to run on the CPU)" in err


def test_unknown_platform_exits_2(monkeypatch, capsys):
    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    assert main(_NO_CUDA_ARGV["serve"] + ["--platform", "tpu"]) == 2
    assert "unknown platform 'tpu'" in capsys.readouterr().err
    assert os.environ.get("DVF_FORCE_PLATFORM") is None


class _Built(Exception):
    pass


def test_default_device_is_cuda0_for_every_object(monkeypatch):
    """With no --platform every object the CLI builds is asked for
    cuda:0 (CUDA claimed present; the constructors are stand-ins that
    record their device)."""
    import dvf_tpu_torch.fleet as fleet_mod
    import dvf_tpu_torch.runtime.engine as engine_mod
    import dvf_tpu_torch.transport.zmq_ingress as zmq_mod

    monkeypatch.delenv("DVF_FORCE_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cli._force_platform() == "cuda:0"
    seen = []

    def recorder(kind):
        def build(*a, device=None, **k):
            seen.append((kind, device))
            raise _Built
        return build

    monkeypatch.setattr(engine_mod, "Engine", recorder("Engine"))
    monkeypatch.setattr(fleet_mod, "FleetFrontend", recorder("FleetFrontend"))
    for argv in (_NO_CUDA_ARGV["serve"], _NO_CUDA_ARGV["fleet"],
                 _NO_CUDA_ARGV["worker"]):
        with pytest.raises(_Built):
            main(argv)
    assert seen == [("Engine", "cuda:0"), ("FleetFrontend", "cuda:0"),
                    ("Engine", "cuda:0")]
    monkeypatch.setattr(engine_mod, "Engine", lambda *a, device=None, **k: device)
    monkeypatch.setattr(zmq_mod, "ZmqWorker", recorder("ZmqWorker"))
    with pytest.raises(_Built):
        main(_NO_CUDA_ARGV["worker"])
    assert seen[-1] == ("ZmqWorker", "cuda:0")


# ---------------------------------------------------------------------------
# Frames through the display sink, against the reference CLI's
# ---------------------------------------------------------------------------


def _capture_display(run, ref: bool = False) -> list:
    """(index, processed frame) as the cv2 display sink receives them."""
    import importlib

    mod = importlib.import_module(
        "dvf_tpu.io.display" if ref else "dvf_tpu_torch.io.display")
    got = []
    real = mod.SideBySideSink.emit

    def emit(self, index, processed, capture_ts):
        got.append((index, np.array(processed)))
        return real(self, index, processed, capture_ts)

    mod.SideBySideSink.emit = emit
    try:
        assert run() == 0
    finally:
        mod.SideBySideSink.emit = real
    return got


@pytest.mark.parametrize("name,size,lsb", [
    ("invert", 16, 0), ("gaussian_blur", 40, 1), ("sobel_bilateral", 64, 1),
])
def test_display_frames_equal_the_reference_clis(name, size, lsb, capsys):
    """serve --display --headless: the frames the sink composes are the
    reference CLI's, bit-exact for invert and within 1 LSB for the
    stencils, in order and all of them."""
    argv = ["serve", "--filter", name, "--height", str(size),
            "--width", str(size), "--frames", "12", "--batch", "4",
            "--frame-delay", "0", "--queue-size", "64", "--display",
            "--headless", "--quiet", "--platform", "cpu"]
    ours = _capture_display(lambda: main(argv))
    ref = _capture_display(lambda: ref_cli.main(argv), ref=True)
    capsys.readouterr()
    assert [i for i, _ in ours] == list(range(12)) == [i for i, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        assert a.shape == b.shape == (size, size, 3)
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= lsb


# ---------------------------------------------------------------------------
# Every subcommand's final JSON line has the reference's key set
# ---------------------------------------------------------------------------


def _keys_of(run, capsys) -> set:
    assert run() == 0
    return set(_last_json(capsys.readouterr().out))


@pytest.mark.parametrize("which", ["serve", "serve-sessions", "fleet"])
def test_final_json_keys_equal_the_references(which, capsys):
    argv = {
        "serve": ["serve", "--filter", "invert", "--height", "16",
                  "--width", "16", "--frames", "8", "--batch", "4",
                  "--frame-delay", "0", "--queue-size", "64", "--quiet"],
        "serve-sessions": ["serve", "--sessions", "2", "--filter", "invert",
                           "--height", "16", "--width", "16", "--frames", "6",
                           "--rate", "120", "--batch", "2", "--queue-size",
                           "100", "--slo-ms", "60000", "--quiet"],
        "fleet": ["fleet", "--mode", "local", "--replicas", "2", "--sessions",
                  "2", "--filter", "invert", "--height", "16", "--width", "16",
                  "--frames", "6", "--rate", "120", "--batch", "2",
                  "--queue-size", "100", "--slo-ms", "60000"],
    }[which] + ["--platform", "cpu"]
    # The pipeline's batch-fill counters have no counterpart in the reference.
    port_only = {"short_batches", "padded_rows", "fill_holds"} if which == "serve" else set()
    assert _keys_of(lambda: main(argv), capsys) == \
        _keys_of(lambda: ref_cli.main(argv), capsys) | port_only


def test_camera_json_keys_equal_the_references(capsys):
    import uuid

    keys = []
    for fn in (main, ref_cli.main):
        name = f"/dvf_torch_cli_{uuid.uuid4().hex[:8]}"
        keys.append(_keys_of(lambda: fn([
            "camera", "--shm", name, "--height", "16", "--width", "16",
            "--frames", "4", "--rate", "0", "--queue-size", "8",
            "--linger-s", "0"]), capsys))
    assert keys[0] == keys[1] == {"pushed", "dropped"}


def test_doctor_and_trace_view_json_keys_equal_the_references(tmp_path, capsys,
                                                              monkeypatch):
    monkeypatch.setenv("DVF_FORCE_PLATFORM", "cpu")
    ours = json.loads(_doctor_out(main, capsys))
    ref = json.loads(_doctor_out(ref_cli.main, capsys))
    assert set(ours) == set(ref)
    assert set(ours["backend"]) == set(ref["backend"])
    assert set(ours["compile_cache"]) == set(ref["compile_cache"])
    from dvf_tpu_torch.obs import trace

    t = trace.Tracer(enabled=True, process_name="serve:r0")
    t.complete("serve_dispatch", t.perf_start, t.perf_start + 0.01, track=0)
    path = str(tmp_path / "t.pftrace")
    trace.merge_tracer_snapshots([t.snapshot()], out_path=path)
    assert main(["trace-view", path, "--json"]) == 0
    a = json.loads(capsys.readouterr().out)
    assert ref_cli.main(["trace-view", path, "--json"]) == 0
    b = json.loads(capsys.readouterr().out)
    assert set(a) == set(b)


def _doctor_out(fn, capsys) -> str:
    assert fn(["doctor", "--probe-timeout", "120"]) == 0
    return capsys.readouterr().out


def test_worker_json_keys_equal_the_references(monkeypatch, capsys):
    """The worker's final stats line (its run loop stood in for by an
    immediate return, as a SIGTERM before any frame leaves it) carries
    every key of the reference's."""
    pytest.importorskip("zmq")
    import dvf_tpu.transport.zmq_ingress as ref_zmq
    import dvf_tpu_torch.transport.zmq_ingress as zmq_mod

    monkeypatch.setattr(zmq_mod.ZmqWorker, "run", lambda self, *a, **k: None)
    monkeypatch.setattr(ref_zmq.TpuZmqWorker, "run", lambda self, *a, **k: None)
    keys = []
    for fn in (main, ref_cli.main):
        keys.append(_keys_of(lambda: fn([
            "worker", "--filter", "invert", "--no-jpeg", "--platform", "cpu",
            "--distribute-port", str(_free_port()),
            "--collect-port", str(_free_port())]), capsys))
    ours, ref = keys
    assert "frames_processed" in ours and ref <= ours
    # The port's worker also always reports its transport, its egress
    # summary (the reference's appears after the first batch) and the
    # per-batch split of its loop.
    assert ours - ref <= {"transport", "egress", "split_ms_per_batch"}


def test_subscribe_json_keys_equal_the_references(capsys):
    """Against one stand-in gate speaking the broadcast hello and two raw
    frames: the same summary keys and counts from both CLIs."""
    zmq = pytest.importorskip("zmq")
    port = _free_port()
    ctx = zmq.Context()
    router = ctx.socket(zmq.ROUTER)
    router.bind(f"tcp://127.0.0.1:{port}")
    done = threading.Event()

    def gate():
        while not done.is_set():
            if not router.poll(50):
                continue
            ident, payload = router.recv_multipart()
            op = json.loads(payload)["op"]
            if op == "hello":
                router.send_multipart([ident, json.dumps(
                    {"ok": True, "wire": "raw", "quality": 0,
                     "tier": "native/q0/raw"}).encode()])
                for k in range(2):
                    router.send_multipart([ident, json.dumps(
                        {"index": k, "key": k == 0}).encode(), b"\x07" * 12])

    gt = threading.Thread(target=gate, daemon=True)
    gt.start()
    outs = []
    try:
        for fn in (main, ref_cli.main):
            assert fn(["subscribe", f"tcp://127.0.0.1:{port}", "--channel",
                       "demo", "--frames", "2", "--timeout", "30"]) == 0
            outs.append(_last_json(capsys.readouterr().out))
    finally:
        done.set()
        gt.join(timeout=5.0)
        router.close(0)
        ctx.term()
    a, b = outs
    assert set(a) == set(b)
    for k in ("frames", "keyframes", "bytes", "wire", "complete", "tier"):
        assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# --compile-cache-dir: the kernel-build cache
# ---------------------------------------------------------------------------


def test_compile_cache_dir_moves_the_builds(tmp_path, capsys, cpu,
                                            build_dirs_restored):
    """--compile-cache-dir points the build directories at DIR: the ring
    shim of a --transport ring run is built there (unless this process
    had loaded it before, when it is used as loaded), and the default
    build directory gains nothing."""
    from dvf_tpu_torch.ops import _build
    from dvf_tpu_torch.runtime.engine import DEFAULT_COMPILE_CACHE_DIR
    from dvf_tpu_torch.transport import _native, ring

    d = tmp_path / "kcache"
    before = sorted(os.listdir(DEFAULT_COMPILE_CACHE_DIR)) \
        if os.path.isdir(DEFAULT_COMPILE_CACHE_DIR) else []
    rc = main(["serve", "--filter", "invert", "--height", "16", "--width", "16",
               "--frames", "8", "--batch", "4", "--frame-delay", "0",
               "--queue-size", "64", "--quiet", "--transport", "ring",
               "--compile-cache-dir", str(d)])
    assert rc == 0
    err = capsys.readouterr().err
    assert f"kernel build cache: {d}" in err
    assert _build.BUILD_DIR == d and _native.BUILD_DIR == d
    lib = _native.library_path(ring._SRC)
    assert lib.parent == d
    assert lib.exists() or ring._lib._name != str(lib)
    after = sorted(os.listdir(DEFAULT_COMPILE_CACHE_DIR)) \
        if os.path.isdir(DEFAULT_COMPILE_CACHE_DIR) else []
    assert after == before
    if ring._lib is not None and ring._lib._name != str(lib):
        # This process loaded the ring before the move: it was neither
        # reloaded from DIR nor deleted.
        assert os.path.exists(ring._lib._name)


def test_enable_compilation_cache_keeps_loaded_libraries(tmp_path, build_dirs_restored):
    """The build directory moves without reloading a loaded library, and
    the prune bounds the directory oldest first, never deleting a loaded
    library or a build in flight."""
    from dvf_tpu_torch.runtime import engine
    from dvf_tpu_torch.transport import _native, ring

    ring._load()
    loaded = ring._lib
    d = tmp_path / "cache"
    d.mkdir()
    for i, name in enumerate(["liba-1.so", "libb-2.so", "libc-3.so",
                              "libd-4.so.123.7.tmp"]):
        p = d / name
        p.write_bytes(b"x" * 1000)
        os.utime(p, (1000 + i, 1000 + i))
    keep = d / "libkept-0.so"
    keep.write_bytes(b"y" * 1000)
    os.utime(keep, (900, 900))  # the oldest, but loaded
    removed = engine.prune_compilation_cache(str(d), max_bytes=2500,
                                             keep={str(keep)})
    assert removed == 2  # liba, then libb
    assert sorted(os.listdir(d)) == ["libc-3.so", "libd-4.so.123.7.tmp",
                                     "libkept-0.so"]
    out = engine.enable_compilation_cache(str(d), max_bytes=1)
    assert out == str(d)
    assert sorted(os.listdir(d)) == ["libd-4.so.123.7.tmp"]
    # The ring library this process loaded elsewhere is neither reloaded
    # from the new directory nor deleted.
    assert _native.load_native(ring._SRC, cdll_cls=type(loaded)) is loaded
    assert os.path.exists(loaded._name)
    assert not list(d.glob("libring-*"))


# ---------------------------------------------------------------------------
# Training: train / train-sr (the CLI cases of tests/test_checkpoint.py,
# test_sr_demo.py and test_style_demo.py)
# ---------------------------------------------------------------------------

SR64 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dvf_tpu_torch", "checkpoints", "sr2x_64")


def test_cli_train_checkpoint_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpts")
    rc = main([
        "train", "--platform", "cpu", "--steps", "4", "--batch", "2", "--size", "32",
        "--base-channels", "8", "--n-residual", "1",
        "--checkpoint-dir", ckpt, "--checkpoint-every", "2",
        "--log-every", "2",
    ])
    assert rc == 0
    cap = capsys.readouterr()
    out = _last_json(cap.out)
    assert out["steps"] == 4 and np.isfinite(out["final_loss"])
    assert os.path.isdir(os.path.join(ckpt, "final"))
    for line in ("step 2: loss=", "step 4: loss=",
                 f"checkpointed {os.path.join(ckpt, 'step_000002')} (async)",
                 f"checkpointed {os.path.join(ckpt, 'final')}\n"):
        assert line in cap.err, line
    with open(os.path.join(ckpt, "config.json")) as f:
        assert json.load(f) == {"base_channels": 8, "n_residual": 1,
                                "style": "stripes", "size": 32, "steps": 4}

    # Resume into the SAME checkpoint dir — "final" must be overwritten,
    # not crash the end of the run.
    rc = main([
        "train", "--platform", "cpu", "--steps", "6", "--batch", "2", "--size", "32",
        "--base-channels", "8", "--n-residual", "1",
        "--resume", os.path.join(ckpt, "final"),
        "--checkpoint-dir", ckpt, "--log-every", "100",
    ])
    assert rc == 0
    cap = capsys.readouterr()
    assert _last_json(cap.out)["steps"] == 6
    assert f"resumed from {os.path.join(ckpt, 'final')} at step 4" in cap.err

    # The serving loader takes what training wrote.
    from dvf_tpu_torch.train.checkpoint import load_style_filter

    filt = load_style_filter(ckpt)
    assert filt.name.startswith("style_transfer(c=8,r=1")

    # A typo'd resume path errors out instead of silently restarting.
    rc = main([
        "train", "--platform", "cpu", "--steps", "2", "--batch", "2", "--size", "32",
        "--resume", os.path.join(ckpt, "fnal"),
    ])
    assert rc == 2


def test_cli_train_sr_checkpoint_resume(tmp_path, capsys):
    """train-sr end-to-end through the CLI: checkpoint, resume continues
    from the saved step, the serving loader takes the trained weights."""
    from dvf_tpu_torch.train.checkpoint import load_sr_filter

    ck = str(tmp_path / "sr")
    assert main(["train-sr", "--platform", "cpu", "--steps", "6", "--batch", "2",
                 "--size", "32", "--checkpoint-dir", ck, "--checkpoint-every", "3",
                 "--log-every", "3"]) == 0
    cap = capsys.readouterr()
    out1 = _last_json(cap.out)
    assert out1["steps"] == 6 and np.isfinite(out1["final_loss"])
    assert np.isfinite(out1["final_psnr_db"])
    assert "step 3: loss=" in cap.err and "dB" in cap.err
    assert sorted(os.listdir(ck)) == ["config.json", "final", "step_000003", "step_000006"]

    # Resume from final: continues at step 6, not from scratch.
    assert main(["train-sr", "--platform", "cpu", "--steps", "8", "--batch", "2",
                 "--size", "32", "--checkpoint-dir", ck, "--resume", ck + "/final",
                 "--log-every", "100"]) == 0
    captured = capsys.readouterr()
    assert "resumed" in captured.err and "step 6" in captured.err

    filt = load_sr_filter(ck)
    assert filt.stateful
    x = torch.full((1, 32, 32, 3), 0.5)
    state = filt.init_state(tuple(x.shape), torch.float32, torch.device("cpu"))
    with torch.no_grad():
        y, _ = filt.fn(x, state)
    assert tuple(y.shape) == (1, 64, 64, 3)
    assert main(["train-sr", "--platform", "cpu", "--size", "33"]) == 2


def test_cli_eval_reproduces_demo_claim(capsys):
    """``train-sr --steps 0 --resume <committed> --eval`` from the port's
    converted sr2x_64 (its whole train state): the README's "+dB over
    nearest" claim, at the reference's bar."""
    rc = main(["train-sr", "--platform", "cpu", "--steps", "0", "--batch", "2",
               "--size", "32", "--resume", os.path.join(SR64, "final"), "--eval",
               "--log-every", "100"])
    assert rc == 0
    cap = capsys.readouterr()
    assert "at step 6000" in cap.err
    out = _last_json(cap.out)
    assert out["held_out"]["delta_db"] > 2.5
    assert sorted(out["held_out"]) == ["delta_db", "psnr_nearest_db", "psnr_sr_db"]


def test_cli_eval_after_real_steps(capsys):
    """``train-sr --steps 2 --eval`` evaluates the TRAINED state."""
    rc = main(["train-sr", "--platform", "cpu", "--steps", "2", "--batch", "2",
               "--size", "16", "--eval", "--log-every", "100"])
    assert rc == 0
    out = _last_json(capsys.readouterr().out)
    assert "held_out" in out and "delta_db" in out["held_out"]
    assert np.isfinite(out["final_loss"])


@pytest.mark.parametrize("sub,argv", [
    ("train", ["--steps", "1", "--batch", "1", "--size", "16", "--base-channels", "8",
               "--n-residual", "1", "--log-every", "1"]),
    ("train-sr", ["--steps", "1", "--batch", "1", "--size", "16", "--eval",
                  "--log-every", "1"]),
])
def test_train_json_and_log_lines_match_the_references(sub, argv, tmp_path, capsys):
    """The same argv through both CLIs: the final JSON's keys (nested
    ones too), and the stderr lines with their numbers masked."""
    import re

    def run(fn, ck):
        assert fn([sub, "--platform", "cpu", "--checkpoint-dir", ck] + argv) == 0
        cap = capsys.readouterr()
        lines = [re.sub(r"[0-9a-f]{6,}|[-+]?\d+\.\d+|/\S+", "#", ln)
                 for ln in cap.err.splitlines()
                 if ln.startswith(("step ", "checkpointed", "resumed"))]
        return _last_json(cap.out), lines

    ours, our_lines = run(main, str(tmp_path / "ours"))
    ref, ref_lines = run(ref_cli.main, str(tmp_path / "ref"))
    assert sorted(ours) == sorted(ref)
    if "held_out" in ref:
        assert sorted(ours["held_out"]) == sorted(ref["held_out"])
    assert our_lines == ref_lines and our_lines


@pytest.mark.parametrize("kind", ["gray", "stripes", "checker", "noise"])
def test_make_style_image_equals_the_references(kind):
    a = cli.make_style_image(kind, 32)
    assert a.shape == (1, 32, 32, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, cli.make_style_image(kind, 32))
    want = ref_cli.make_style_image(kind, 32)
    assert a.dtype == want.dtype and a.tobytes() == want.tobytes()


def test_make_style_image_refuses_an_unknown_preset():
    with pytest.raises(ValueError, match="unknown style preset"):
        cli.make_style_image("nope", 32)
