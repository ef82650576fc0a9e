"""The port stands alone: importing it (and chip_smoke.py) pulls in
neither jax nor any part of the JAX package; chip_smoke.py prints no
result where it cannot run the port on a card."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

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
             or m == "dvf_tpu" or m.startswith("dvf_tpu."))
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
            "dvf_tpu_torch.train.checkpoint", "dvf_tpu_torch.ops.histogram",
            "dvf_tpu_torch.ops.canny"} <= set(res["imported"])
    # The serving slice: the frontend and every module it pulls forward.
    assert {"dvf_tpu_torch.serve", "dvf_tpu_torch.serve.server",
            "dvf_tpu_torch.serve.session", "dvf_tpu_torch.serve.batcher",
            "dvf_tpu_torch.serve.router", "dvf_tpu_torch.runtime.signature",
            "dvf_tpu_torch.obs.registry", "dvf_tpu_torch.obs.export",
            "dvf_tpu_torch.obs.ledger", "dvf_tpu_torch.obs.memory",
            "dvf_tpu_torch.resilience.continuity"} <= set(res["imported"])


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+dvf_tpu(\.|\s|$)|"
    r"from\s+dvf_tpu(\.|\s))", re.M)


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
