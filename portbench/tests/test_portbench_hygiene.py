"""What the benchmark may load and read: no JAX and no JAX package in a
run, no program code in the reference, no path under ``benchmarks/``."""

import ast
import json
import os
import subprocess
import sys

from portbench import spec

ROOT = spec.ROOT
CHECKOUT = spec.checkout_root()

DRY_RUN = r"""
import json, sys, torch
from portbench.run import forbidden_modules, run_cell
cpu = torch.device("cpu")
run_cell("style.stream720", 2**31 + 7, 1.0, False, cpu,
         cell_override={"height": 32, "width": 48, "batch": 4, "cycle": 8, "outstanding": 8,
                        "queue_size": 12, "warmup_frames": 8, "sample": 4, "expected_fps": 40})
run_cell("style_train.vgg16_256", 2**31 + 8, 0.5, False, cpu,
         cell_override={"batch": 2, "size": 32, "pool": 4, "warmup_steps": 1})
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
print(json.dumps(forbidden_modules()))
"""


def test_dry_run_of_each_driver_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", DRY_RUN], cwd=CHECKOUT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, forbidden = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert "dvf_tpu_torch" in tops            # the program did run
    assert forbidden == []
    assert not {"jax", "jaxlib", "flax", "dvf_tpu"} & set(tops)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _py_files(folder):
    for dirpath, _, names in os.walk(folder):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(ROOT, "reference")):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("dvf_tpu_torch", "dvf_tpu", "jax", "jaxlib", "flax"), (path, mod)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _py_files(ROOT):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("dvf_tpu", "jax", "jaxlib", "flax"), (path, mod)


def test_no_file_opens_a_path_under_benchmarks():
    for dirpath, _, names in os.walk(ROOT):
        if ".cache" in dirpath or "__pycache__" in dirpath:
            continue
        for n in names:
            if n.endswith((".py", ".json")) and n != os.path.basename(__file__):
                text = open(os.path.join(dirpath, n)).read()
                assert "benchmarks/" not in text and "benchmarks\\" not in text, n
