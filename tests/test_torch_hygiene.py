"""The port stands alone: importing it (and chip_smoke.py) pulls in
neither jax nor any part of the JAX package nor the repo-root
``benchtools`` of its bench harness; chip_smoke.py prints no result
where it cannot run the port on a card."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

BENCH_MODULES = {"dvf_tpu_torch.benchmarks", "dvf_tpu_torch.bench_child",
                 "dvf_tpu_torch.models.analysis", "dvf_tpu_torch.runtime.cost"}
MULTIPROC_MODULES = {"dvf_tpu_torch.parallel.distributed",
                     "dvf_tpu_torch.fleet.multiproc",
                     "dvf_tpu_torch.fleet.multihost",
                     "dvf_tpu_torch.fleet._mh_worker"}

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import dvf_tpu_torch
mods = ["dvf_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    dvf_tpu_torch.__path__, "dvf_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "dvf_tpu" or m.startswith("dvf_tpu.")
             or m == "benchtools")
print(json.dumps({{"imported": mods, "bad": bad}}))
"""


def test_import_pulls_in_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "dvf_tpu_torch.ops.kernels" in res["imported"]
    assert "dvf_tpu_torch.runtime.pipeline" in res["imported"]
    assert {"dvf_tpu_torch.models.style_transfer", "dvf_tpu_torch.models.espcn",
            "dvf_tpu_torch.models.hat", "dvf_tpu_torch.train.checkpoint", "dvf_tpu_torch.ops.histogram",
            "dvf_tpu_torch.ops.canny"} <= set(res["imported"])
    # Training: the VGG encoder, both train steps and their optimizer.
    assert {"dvf_tpu_torch.models.vgg", "dvf_tpu_torch.train.style",
            "dvf_tpu_torch.train.sr", "dvf_tpu_torch.train.optim"} <= set(res["imported"])
    # The compile check and multi-device dry run (``__graft_entry__``'s).
    assert "dvf_tpu_torch.dryrun" in res["imported"]
    # The serving slice: the frontend and every module it pulls forward.
    assert {"dvf_tpu_torch.serve", "dvf_tpu_torch.serve.server",
            "dvf_tpu_torch.serve.session", "dvf_tpu_torch.serve.batcher",
            "dvf_tpu_torch.serve.router", "dvf_tpu_torch.runtime.signature",
            "dvf_tpu_torch.obs.registry", "dvf_tpu_torch.obs.export",
            "dvf_tpu_torch.obs.ledger", "dvf_tpu_torch.obs.memory",
            "dvf_tpu_torch.resilience.continuity"} <= set(res["imported"])
    # The worker's wire: the native ring, its ingest queue, the shm source.
    assert {"dvf_tpu_torch.transport.ring", "dvf_tpu_torch.transport.ring_queue",
            "dvf_tpu_torch.io.sources"} <= set(res["imported"])
    # The observability planes: audit, lineage, the viewer, the trace
    # merge and the flight recorder.
    assert {"dvf_tpu_torch.obs.audit", "dvf_tpu_torch.obs.lineage",
            "dvf_tpu_torch.obs.viewer", "dvf_tpu_torch.obs.trace",
            "dvf_tpu_torch.obs.export"} <= set(res["imported"])
    # The control plane, auto-plan with its plan cache, and broadcast.
    assert {"dvf_tpu_torch.control.controllers",
            "dvf_tpu_torch.control.plane", "dvf_tpu_torch.control.planner",
            "dvf_tpu_torch.control.plan_cache", "dvf_tpu_torch.control._ab",
            "dvf_tpu_torch.control.fleet_elastic",
            "dvf_tpu_torch.broadcast.abr", "dvf_tpu_torch.broadcast.channel",
            "dvf_tpu_torch.broadcast.relay",
            "dvf_tpu_torch.broadcast.plane"} <= set(res["imported"])
    # The fleet tier: the front door, its replicas and their worker.
    assert {"dvf_tpu_torch.fleet", "dvf_tpu_torch.fleet.stats",
            "dvf_tpu_torch.fleet.admission", "dvf_tpu_torch.fleet.replica",
            "dvf_tpu_torch.fleet._worker", "dvf_tpu_torch.fleet.elastic",
            "dvf_tpu_torch.fleet.router"} <= set(res["imported"])
    # The command line, its sources' display and the mesh arithmetic.
    assert {"dvf_tpu_torch.cli", "dvf_tpu_torch.__main__",
            "dvf_tpu_torch.io.display", "dvf_tpu_torch.io.gl_display",
            "dvf_tpu_torch.parallel.mesh"} <= set(res["imported"])
    # The in-host mesh: shardings, sharded batches, halo exchange and the
    # layer pipeline.
    assert {"dvf_tpu_torch.parallel", "dvf_tpu_torch.parallel.sharded",
            "dvf_tpu_torch.parallel.halo",
            "dvf_tpu_torch.parallel.pp"} <= set(res["imported"])
    # The bench harness: benchmarks, the child process, the roofline model
    # and the counters behind Engine.cost_analysis.
    assert BENCH_MODULES <= set(res["imported"])
    # The multi-process runtime: the process group, the multi-process
    # engine, the multi-host replica and its worker.
    assert MULTIPROC_MODULES <= set(res["imported"])


def test_planner_ranks_with_its_own_copy_of_ab_comparison():
    """The planner ranks its legs with the port's copy of the repo-root
    ``benchtools.ab_comparison`` (``control._ab``), which computes what
    the original does: the same comparison for the same legs, seeded
    priors and aborts."""
    import benchtools

    from dvf_tpu_torch.control import _ab, planner

    assert planner.ab_comparison is _ab.ab_comparison
    legs = [("a", 1), ("b", 2), ("c", 3), ("d", 0)]

    def measure(_label, v):
        return {"error": "stalled"} if v == 0 else {"fps": 10.0 * v % 25}

    for kw in ({}, {"prior": {"a": {"fps": 99.0}},
                    "keep_leg": lambda e: "fps" in e},
               {"abort": lambda r: True}, {"meta": {"run": "x"}}):
        assert _ab.ab_comparison(legs, measure, **kw) == \
            benchtools.ab_comparison(legs, measure, **kw)


def test_ring_source_is_the_ports_own_copy():
    """The ring is built from the port's copy of ring.cpp (into the port's
    build directory), never from the JAX package's source; the code is the
    JAX package's, so both share one wire and one eviction order."""
    from dvf_tpu_torch.transport import _native, ring

    port_src = ROOT / "dvf_tpu_torch" / "transport" / "ring.cpp"
    assert pathlib.Path(ring._SRC) == port_src
    lib = _native.library_path(ring._SRC)
    assert lib.parent == _native.BUILD_DIR
    assert "dvf_tpu_torch" in lib.parts and "transport" not in lib.parts

    def code(path):
        text = path.read_text()
        return text[text.index("#include <atomic>"):]

    assert code(port_src) == code(ROOT / "dvf_tpu" / "transport" / "ring.cpp")


@pytest.mark.parametrize("pkg", ["api", "io", "sched", "utils", "transport",
                                 "obs", "control", "broadcast", "fleet",
                                 "train", "models", "runtime", "resilience",
                                 "serve", "ops", "parallel", ""])
def test_package_exports_the_references_names(pkg):
    """Each package (and the top-level one, ``""``) re-exports the names
    its JAX counterpart exports."""
    import importlib
    import types

    suffix = f".{pkg}" if pkg else ""
    ref = importlib.import_module(f"dvf_tpu{suffix}")
    want = {n for n, v in vars(ref).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", "").startswith("dvf_tpu.")}
    assert want
    got = importlib.import_module(f"dvf_tpu_torch{suffix}")
    missing = sorted(n for n in want if not hasattr(got, n))
    assert missing == []


_CUDA_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import torch
inits = []
real = torch.cuda._lazy_init
torch.cuda._lazy_init = lambda: inits.append(1) or real()
import dvf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dvf_tpu_torch.__path__,
                                               "dvf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps(names))
raise SystemExit(0 if not inits and not torch.cuda.is_initialized() else 3)
"""


def test_import_creates_no_cuda_context():
    """Twin of tests/test_import_hygiene.py: importing the port (every
    module of it) initializes no CUDA context; the card is first touched
    by an entry point."""
    out = subprocess.run([sys.executable, "-c", _CUDA_PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert BENCH_MODULES | MULTIPROC_MODULES <= names


_HELP_PROBE = r"""
import json, runpy, sys
sys.path.insert(0, {root!r})
import torch
inits = []
real = torch.cuda._lazy_init
torch.cuda._lazy_init = lambda: inits.append(1) or real()
sys.argv = ["dvf_tpu_torch", "--help"]
try:
    runpy.run_module("dvf_tpu_torch", run_name="__main__", alter_sys=True)
    code = None
except SystemExit as e:
    code = e.code
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "dvf_tpu" or m.startswith("dvf_tpu."))
print(json.dumps({{"code": code, "bad": bad, "cuda": bool(inits)
                   or torch.cuda.is_initialized()}}))
"""


def test_main_help_imports_no_jax_and_touches_no_card():
    """``python -m dvf_tpu_torch --help`` in a fresh interpreter exits 0,
    lists every subcommand the reference has (training and bench), and
    imports neither jax nor the JAX package, nor creates a CUDA context."""
    out = subprocess.run([sys.executable, "-c", _HELP_PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"code": 0, "bad": [], "cuda": False}
    subs = re.search(r"\{([a-z,-]+)\}", out.stdout).group(1).split(",")
    assert subs == ["filters", "doctor", "serve", "subscribe", "fleet",
                    "camera", "worker", "trace-view", "train", "train-sr",
                    "bench"]
    direct = subprocess.run([sys.executable, "-m", "dvf_tpu_torch", "--help"],
                            capture_output=True, text=True, timeout=120,
                            cwd=str(ROOT))
    assert direct.returncode == 0 and "trace-view" in direct.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+dvf_tpu(\.|\s|$)|"
    r"from\s+dvf_tpu(\.|\s)|import\s+benchtools\b|from\s+benchtools\b)",
    re.M)


def test_sources_name_no_jax_or_reference_import():
    files = sorted((ROOT / "dvf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if _FORBIDDEN.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("where,cuda", [
    ("repo", False), ("alone", False), ("alone", True),
], ids=["no-cuda", "alone-no-cuda", "alone-cuda-claimed"])
def test_chip_smoke_fails_and_prints_no_result(tmp_path, where, cuda):
    """Without CUDA, or copied away from the repository (so it cannot
    import the port, even where a card is claimed to be present), the
    script exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    code = ("import runpy, torch\n"
            f"torch.cuda.is_available = lambda: {cuda}\n"
            f"runpy.run_path({str(script)!r}, run_name='__main__')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if cuda:
        assert "dvf_tpu_torch" in out.stderr


def test_worker_runs_as_a_child_without_jax():
    """``python -m dvf_tpu_torch.fleet._worker`` speaks the wire to a
    bare listener (hello, config, ready, an op, stop) and imports
    neither jax nor the JAX package."""
    probe = (
        "import json, runpy, sys\n"
        "sys.argv = ['_worker'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('dvf_tpu_torch.fleet._worker', "
        "run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'dvf_tpu' or "
        "m.startswith('dvf_tpu.'))\n"
        "print(json.dumps(bad))\n")
    import socket

    from dvf_tpu_torch.fleet.replica import recv_msg, send_msg

    root = str(ROOT)
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    lst.settimeout(120)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(
        [sys.executable, "-c", probe, "--port",
         str(lst.getsockname()[1]), "--replica-id", "r0"],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        sock, _ = lst.accept()
        sock.settimeout(120)
        assert recv_msg(sock)[0] == "hello"
        send_msg(sock, ("config", {"filter": ("invert", {}),
                                   "serve": {"batch_size": 2},
                                   "device": "cpu", "replica_id": "r0"}))
        assert recv_msg(sock)[0] == "ready"
        send_msg(sock, ("health",))
        reply = recv_msg(sock)
        assert reply[0] == "ok" and reply[1]["ok"] is True
        send_msg(sock, ("stop",))
        assert recv_msg(sock) == ("ok", None)
        sock.close()
        out, err = proc.communicate(timeout=60)
    finally:
        lst.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_mh_worker_runs_as_a_child_without_jax():
    """``python -m dvf_tpu_torch.fleet._mh_worker`` as the leader of a
    one-member group on the CPU speaks the replica wire to a bare
    listener (hello, config, ready, an op, stop) and imports neither jax
    nor the JAX package; it ends with ``os._exit``."""
    import socket

    from dvf_tpu_torch.fleet.replica import recv_msg, send_msg

    probe = (
        "import json, os, runpy, sys\n"
        "mod = runpy.run_module('dvf_tpu_torch.fleet._mh_worker')\n"
        "rc = mod['main'](sys.argv[1:])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'dvf_tpu' or "
        "m.startswith('dvf_tpu.'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad}), flush=True)\n"
        "os._exit(0)\n")
    from torch_mp_util import free_port

    peer_port, coord_port = free_port(), free_port()
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    lst.settimeout(120)
    root = str(ROOT)
    env = dict(os.environ, PYTHONPATH=root, DVF_MH_CONFIG=json.dumps({
        "op_chain": "invert", "frame_shape": [8, 8, 3], "frame_dtype": "uint8",
        "batch_global": 2, "slo_ms": 1000.0, "queue_size": 8,
        "out_queue_size": 8, "hosts": 1, "device": "cpu"}))
    proc = subprocess.Popen(
        [sys.executable, "-c", probe, "--parent-port",
         str(lst.getsockname()[1]), "--peer-port", str(peer_port),
         "--coordinator", f"127.0.0.1:{coord_port}", "--num-processes", "1",
         "--process-id", "0", "--replica-id", "r0"],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        sock, _ = lst.accept()
        sock.settimeout(120)
        assert recv_msg(sock)[0] == "hello"
        send_msg(sock, ("config", {"mh": {}, "replica_id": "r0"}))
        assert recv_msg(sock)[0] == "ready"
        send_msg(sock, ("health",))
        reply = recv_msg(sock)
        assert reply[0] == "ok" and reply[1]["ok"] is True
        assert reply[1]["warm_signatures"] == ["invert|8x8x3|uint8"]
        send_msg(sock, ("stop",))
        assert recv_msg(sock) == ("ok", None)
        sock.close()
        out, err = proc.communicate(timeout=60)
    finally:
        lst.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1]) == {"rc": 0, "bad": []}
