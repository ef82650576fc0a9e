"""Discovery: every file of the benchmark is found by the name that
``BENCHMARK.json`` or a cell gives it, and no file lists the others.

- ``cells/<cell>.json``: ``config``, ``traffic`` (a driver under
  ``traffic/``), the driver's ``params``, the ``limits`` of the numbers
  that decide ``correct``, and ``why``;
- ``configs/<config>.json``: the published source and widths, ``reduced``,
  ``assumed``, the deployment, and ``counts`` (a module under ``counts/``);
- ``traffic/<driver>.py``: ``run(ctx) -> Outcome``;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``:
  ``read(outcome) -> float | None`` (None: nothing to read, and the
  metric is left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Any, Dict, List

ROOT = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELL_KEYS = {"config", "traffic", "params", "limits", "why"}
CONFIG_KEYS = {"name", "source", "counts", "reduced", "assumed", "deployment"}


def checkout_root(root: str = ROOT) -> str:
    return os.path.dirname(root)


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    """``BENCHMARK.json`` at the checkout root beside this folder."""
    return _json(os.path.join(checkout_root(root), "BENCHMARK.json"))


def load_cell(name: str, root: str = ROOT) -> Dict[str, Any]:
    cell = _json(os.path.join(root, "cells", _name("cell", name) + ".json"))
    missing = CELL_KEYS - set(cell)
    if missing:
        raise ValueError(f"cell {name}: missing keys {sorted(missing)}")
    _name("config", cell["config"])
    _name("traffic", cell["traffic"])
    cell["name"] = name
    return cell


def load_config(name: str, root: str = ROOT) -> Dict[str, Any]:
    cfg = _json(os.path.join(root, "configs", _name("config", name) + ".json"))
    missing = CONFIG_KEYS - set(cfg)
    if missing:
        raise ValueError(f"config {name}: missing keys {sorted(missing)}")
    if cfg["name"] != name:
        raise ValueError(f"config file {name}.json names itself {cfg['name']!r}")
    return cfg


def load_module(kind: str, name: str, root: str = ROOT):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, kind, _name(kind, name) + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: Dict[str, Any], cell: str, kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` entries that a cell reports: those
    without a ``workloads`` key, and those that list the cell."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or cell in m["workloads"]]


def validate(root: str = ROOT) -> List[str]:
    """Every cell, config, driver and metric that ``BENCHMARK.json`` names
    is found and well formed; returns the cell names."""
    bench = load_benchmark(root)
    configs = {c["name"]: c for c in bench["configs"]}
    for name, entry in configs.items():
        cfg = load_config(name, root)
        if sorted(cfg["reduced"]) != sorted(entry["reduced"]):
            raise ValueError(f"config {name}: reduced differs from BENCHMARK.json")
        load_module("counts", cfg["counts"], root)
    cells = []
    for w in bench["workloads"]:
        cell = load_cell(w["name"], root)
        if cell["config"] != w["config"] or cell["traffic"] != w["traffic"]:
            raise ValueError(f"cell {w['name']}: config/traffic differ from BENCHMARK.json")
        if w["config"] not in configs:
            raise ValueError(f"cell {w['name']}: unknown config {w['config']}")
        load_module("traffic", cell["traffic"], root)
        cells.append(w["name"])
    for kind, folder in (("end_to_end", "end_to_end"), ("per_layer", "layer_metrics")):
        for m in bench[kind]:
            if not hasattr(load_module(folder, m["name"], root), "read"):
                raise ValueError(f"{folder}/{m['name']}.py has no read()")
    return cells
