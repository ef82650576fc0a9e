"""Process groups for the port's multi-process tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_fleet_multiproc.py``):
N ranks of one script, each started as ``python script RANK PORT ...``
with the repository on its path, a free port for the group's rendezvous,
a time limit on each rank, and every rank killed on the way out."""

import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "2"   # two ranks beside the test's own workers
    return env


def run_group(script, n: int, *args, timeout: float = 150.0) -> list:
    """Run ``n`` ranks of ``script``; returns ``[(returncode, output)]``
    in rank order (stdout and stderr together)."""
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), port, *map(str, args)],
        env=child_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(n)]
    outs = [""] * n
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=timeout)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]
