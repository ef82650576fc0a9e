"""Inference loaders for the trained neural filters (port of the loading
half of ``dvf_tpu.train.checkpoint``).

The reference writes orbax checkpoints, which need JAX to read. The port's
checkpoint is a directory laid out like the reference's::

    <name>/config.json          the architecture sidecar (copied verbatim)
    <name>/final/params.npz     the net params, one array per leaf, keyed
                                "<layer>/<leaf>" (e.g. "stem/w")

(or ``<name>/step_NNNNNN/params.npz`` where training stopped early). The
committed weights are the JAX package's in-repo checkpoints converted to
that form, params only, under :data:`CHECKPOINT_ROOT`; their conversion
(which needs orbax, and so JAX) lives in ``tests/test_torch_checkpoint.py``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Sequence

import numpy as np
import torch

CHECKPOINT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")
PARAMS_FILE = "params.npz"


def load_params(path: str) -> Dict[str, Any]:
    """The net params of a checkpoint (a ``final`` or ``step_*`` directory)
    as a nested dict of float32 CPU tensors, ready for ``get_filter(...,
    params=...)``."""
    path = os.path.abspath(path)
    npz = os.path.join(path, PARAMS_FILE)
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"{npz} missing — the port reads params.npz checkpoints (an "
            f"orbax checkpoint of the JAX package converts with "
            f"tests/test_torch_checkpoint.py)")
    params: Dict[str, Any] = {}
    with np.load(npz) as z:
        for key in z.files:
            node = params
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(np.array(z[key]))
    return params


def save_params(path: str, params: Dict[str, Any]) -> str:
    """Write a nested dict of arrays or tensors as ``<path>/params.npz``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            t = node.detach().cpu().numpy() if isinstance(node, torch.Tensor) else node
            flat[prefix[:-1]] = np.asarray(t)

    walk(params, "")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, PARAMS_FILE), **flat)
    return path


# ------------------------------------------------- shared layout helpers

def resolve_checkpoint_dir(ckpt_dir: str, family: str, train_cmd: str) -> str:
    """Map a checkpoint directory to the concrete checkpoint to load:
    prefer 'final'; fall back to the newest step_* (a run killed
    mid-training leaves step dirs but no final)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"{family} checkpoint dir {ckpt_dir!r} does not exist")
    final = os.path.join(ckpt_dir, "final")
    if not os.path.isdir(final):
        import re

        # step_NNNNNN only (a staging 'step_*.orbax-checkpoint-tmp' dir is
        # not a checkpoint), sorted by number, not by name.
        steps = sorted((d for d in os.listdir(ckpt_dir)
                        if re.fullmatch(r"step_\d+", d)),
                       key=lambda d: int(d[len("step_"):]))
        if not steps:
            raise FileNotFoundError(
                f"{ckpt_dir!r} has no 'final' or step_* checkpoint — pass "
                f"the directory given to {train_cmd} --checkpoint-dir")
        final = os.path.join(ckpt_dir, steps[-1])
    return final


def _read_sidecar(ckpt_dir: str, required: Sequence[str]) -> dict:
    """Load the config.json architecture sidecar. Required: guessing a
    default architecture on a mismatch would silently skip trained layers
    or crash with an opaque shape error."""
    import json

    cfg_path = os.path.join(os.path.abspath(ckpt_dir), "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"{cfg_path} missing — the net architecture cannot be recovered "
            f"(the train CLI writes this sidecar at training start)")
    try:
        with open(cfg_path) as f:
            sc = json.load(f)
        missing = [k for k in required if k not in sc]
        if missing:
            raise KeyError(", ".join(missing))
    except (json.JSONDecodeError, KeyError) as e:
        raise ValueError(
            f"{cfg_path} is corrupt or missing required keys "
            f"({', '.join(required)}): {e}") from e
    return sc


# --------------------------------------------------------- the families

def load_style_filter(ckpt_dir: str, **config):
    """The style_transfer Filter of a checkpoint directory; ``config``
    (e.g. ``dtype``, ``fast_convs``) passes on to the factory."""
    final = resolve_checkpoint_dir(ckpt_dir, "style", "train")
    sc = _read_sidecar(ckpt_dir, ("base_channels", "n_residual"))

    from dvf_tpu_torch.ops import get_filter

    return get_filter(
        "style_transfer",
        params=load_params(final),
        base_channels=sc["base_channels"],
        n_residual=sc["n_residual"],
        **config,
    )


def load_sr_filter(ckpt_dir: str, **config):
    """The super_resolution Filter of a checkpoint directory; ``config``
    passes on to the factory."""
    final = resolve_checkpoint_dir(ckpt_dir, "sr", "train-sr")
    sc = _read_sidecar(ckpt_dir, ("scale",))

    from dvf_tpu_torch.ops import get_filter

    return get_filter("super_resolution", params=load_params(final),
                      scale=sc["scale"], **config)
