"""A cell, a configuration and a per-layer metric added as new files to a
copy of the benchmark are found and validated with no existing file of the
folder edited (``BENCHMARK.json``, outside it, gains their entries)."""

import json
import os
import shutil

import torch

from portbench import run as runmod
from portbench import spec


def _copy(tmp_path):
    checkout = tmp_path / "checkout"
    shutil.copytree(spec.ROOT, checkout / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(spec.checkout_root(), "BENCHMARK.json"), checkout)
    return checkout


def _tree(folder):
    out = {}
    for dirpath, _, names in os.walk(folder):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, folder)] = open(p, "rb").read()
    return out


def test_new_cell_config_and_metric_are_found_as_new_files(tmp_path):
    checkout = _copy(tmp_path)
    root = str(checkout / "portbench")
    before = _tree(root)
    cfg = json.load(open(os.path.join(root, "configs", "johnson_style.json")))
    cfg.update(name="johnson_style_c16", net={**cfg["net"], "base_channels": 16})
    (checkout / "portbench" / "configs" / "johnson_style_c16.json").write_text(json.dumps(cfg))
    cell = json.load(open(os.path.join(root, "cells", "style.stream720.json")))
    cell.update(config="johnson_style_c16", limits={**cell["limits"], "worst_frame_rms_gap": 1e9})
    cell["params"].update(height=32, width=48, batch=4, cycle=8, outstanding=8, queue_size=12,
                          warmup_frames=8, sample=4, expected_fps=40)
    (checkout / "portbench" / "cells" / "style_c16.stream32.json").write_text(json.dumps(cell))
    (checkout / "portbench" / "layer_metrics" / "frames_sampled.c16.py").write_text(
        "def read(outcome):\n    return outcome.get('sampled')\n")
    bench = json.load(open(checkout / "BENCHMARK.json"))
    bench["configs"].append({"name": "johnson_style_c16", "source": "https://arxiv.org/abs/1603.08155",
                             "file": "portbench/configs/johnson_style_c16.json", "reduced": [],
                             "why": "a test entry"})
    bench["workloads"].append({"name": "style_c16.stream32", "config": "johnson_style_c16",
                               "traffic": "stream", "chips": 1, "why": "a test entry"})
    bench["per_layer"].append({"name": "frames_sampled.c16", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "the harness", "moves": "fps",
                               "workloads": ["style_c16.stream32"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    assert "style_c16.stream32" in spec.validate(root)
    after = _tree(root)
    assert all(after[k] == v for k, v in before.items())     # nothing edited
    res = runmod.run_cell("style_c16.stream32", 11, 0.5, True, torch.device("cpu"), root=root)
    assert res["correct"]
    assert res["metrics"]["frames_sampled.c16"]["value"] >= 0
    assert "mfu.stream" not in res["metrics"]                 # another cell's metric


def test_the_committed_benchmark_validates():
    assert spec.validate() == [w["name"] for w in spec.load_benchmark()["workloads"]]
