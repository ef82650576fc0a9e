"""Two real processes over the shared-memory ring: ``camera --shm NAME``
pushes synthetic frames, ``serve --source shm:NAME`` consumes, filters and
delivers them — port to port, and from the JAX package's ``camera`` to
the port's ``serve`` (one ring wire: the port's ring.cpp is the
reference's code). Counterpart of tests/test_cli.py's camera → serve
test."""

import json
import os
import subprocess
import sys
import uuid

from torch_ring_util import JAX_CLI_ISOLATED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 24


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["DVF_FORCE_PLATFORM"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _camera_to_serve(producer_argv, tmp_path):
    name = f"/dvf_torch_cli_{uuid.uuid4().hex[:8]}"
    env = _env()
    geometry = ["--height", "32", "--width", "32"]
    producer = subprocess.Popen(
        producer_argv + ["camera", "--shm", name, "--source", "synthetic",
                         *geometry, "--frames", str(FRAMES), "--rate", "120",
                         "--queue-size", "64"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    consumer = subprocess.Popen(
        [sys.executable, "-m", "dvf_tpu_torch", "serve", "--source",
         f"shm:{name}", "--filter", "invert", *geometry, "--batch", "4",
         "--frame-delay", "0", "--queue-size", "64", "--quiet"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        pout, _ = producer.communicate(timeout=120)
        cout, _ = consumer.communicate(timeout=120)
    finally:
        for p in (producer, consumer):
            if p.poll() is None:
                p.kill()
                p.communicate()
        try:  # the creator unlinks on close; this covers a killed one
            os.unlink(f"/dev/shm{name}")
        except OSError:
            pass
    assert producer.returncode == 0, pout[-2000:]
    assert consumer.returncode == 0, cout[-2000:]
    pstats = json.loads(pout.strip().splitlines()[-1])
    cstats = json.loads(cout.strip().splitlines()[-1])
    assert pstats["pushed"] == FRAMES
    # At-most-once across the process boundary: every frame the ring did
    # not evict is delivered.
    assert cstats["delivered"] + pstats["dropped"] >= \
        FRAMES - cstats["dropped_at_ingest"]
    assert cstats["delivered"] > 0
    assert cstats["current_display_frame"] == cstats["delivered"] - 1 \
        or pstats["dropped"] or cstats["dropped_at_ingest"]
    return pstats, cstats


def test_camera_to_serve_over_shm(tmp_path):
    _camera_to_serve([sys.executable, "-m", "dvf_tpu_torch"], tmp_path)


def test_reference_camera_to_port_serve_over_shm(tmp_path):
    """The JAX package's producer (its ring shim built into a temporary
    directory, so nothing is written into ``dvf_tpu/``) feeding the
    port's consumer."""
    lib_dir = tmp_path / "jax_native"
    lib_dir.mkdir()
    beside = os.path.join(ROOT, "dvf_tpu", "transport", "_ring.so")

    def stamp():
        return os.stat(beside).st_mtime_ns if os.path.exists(beside) else None

    before = stamp()
    _camera_to_serve([sys.executable, "-c", JAX_CLI_ISOLATED, str(lib_dir)],
                     tmp_path)
    assert (lib_dir / "_ring.so").exists()
    assert stamp() == before
