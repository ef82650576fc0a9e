"""The port's measured per-backend defaults (counterpart of
``tests/test_measured_defaults.py``).

A declared winner must come from a committed A/B of the port on that
backend. No H100 (or CPU) A/B of the port is committed, so every
``MEASURED_DEFAULTS`` entry declares no winner and resolves to its
fallback on every backend; no winner of the JAX package carries over. The
entries name the same comparisons and impl labels as the JAX package's
entries of the same key, so a later A/B folds in the same way.
"""

from __future__ import annotations

import os
import re

import pytest

from dvf_tpu.ops.registry import MEASURED_DEFAULTS as JAX_MEASURED_DEFAULTS
from dvf_tpu_torch.ops.registry import (MEASURED_DEFAULTS, measured_default,
                                        measured_default_for)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("key", sorted(MEASURED_DEFAULTS))
@pytest.mark.parametrize("backend", ["cuda", "cpu", "tpu"])
def test_every_entry_resolves_to_its_fallback(key, backend):
    entry = MEASURED_DEFAULTS[key]
    assert entry["winners"] == {}, (
        f"{key}: a declared winner needs a committed A/B of the port")
    assert measured_default_for(key, backend) == entry["fallback"]
    assert entry["fallback"] in entry["label_to_impl"].values()


@pytest.mark.parametrize("key", sorted(MEASURED_DEFAULTS))
def test_entries_name_the_jax_comparisons(key):
    want = JAX_MEASURED_DEFAULTS[key]
    got = MEASURED_DEFAULTS[key]
    assert got["comparison"] == want["comparison"]
    assert got["label_to_impl"] == want["label_to_impl"]
    assert got["fallback"] == want["fallback"]


def test_measured_default_picks_the_backends_winner():
    assert measured_default({"cuda": "fast"}, fallback="ref") == "fast"
    assert measured_default({"tpu": "fast"}, fallback="ref") == "ref"
    assert measured_default({"cpu": "fast"}, fallback="ref", backend="cpu") == "fast"


def test_every_winner_map_is_declared():
    """No factory passes an inline winners map: every default goes
    through a MEASURED_DEFAULTS entry this file checks."""
    ops_dir = os.path.join(ROOT, "dvf_tpu_torch", "ops")
    offenders = []
    for fname in sorted(os.listdir(ops_dir)):
        if not fname.endswith(".py") or fname == "registry.py":
            continue
        with open(os.path.join(ops_dir, fname)) as f:
            if re.search(r"measured_default\(", f.read()):
                offenders.append(fname)
    assert offenders == []


@pytest.mark.parametrize("module,factory,key", [
    ("style", "style_transfer", "style_fast"),
    ("sr", "super_resolution", "espcn_fast"),
])
def test_neural_factories_take_the_measured_default(monkeypatch, module,
                                                    factory, key):
    """``fast_convs=None`` asks the registry for its entry; an explicit
    value pins without asking."""
    import importlib

    import dvf_tpu_torch as dt

    mod = importlib.import_module(f"dvf_tpu_torch.ops.{module}")
    asked = []
    monkeypatch.setattr(mod, "measured_default_for",
                        lambda k, backend="cuda": asked.append(k) or "ref")
    dt.get_filter(factory)
    assert asked == [key]
    dt.get_filter(factory, fast_convs=True)
    assert asked == [key]
