"""Checkpoint / resume for the training families, and the inference
loaders of the trained neural filters (port of
``dvf_tpu.train.checkpoint``).

The reference writes orbax checkpoints, which need JAX to read. The port's
checkpoint is a directory laid out like the reference's::

    <name>/config.json          the architecture sidecar
    <name>/final/params.npz     the net params, one array per leaf, keyed
                                "<layer>/<leaf>" (e.g. "stem/w")
    <name>/final/state.npz      the rest of a TrainState: "opt/mu/<leaf
                                path>", "opt/nu/<leaf path>" and
                                "opt/count" (the Adam state), "step", and
                                for the style family "vgg/<layer>/<leaf>"
                                and "grams/<i>"

(or ``<name>/step_NNNNNN/`` where training stopped early). The inference
loaders read ``params.npz`` alone; :func:`restore_checkpoint` /
:func:`restore_sr_checkpoint` read both files onto a template state, and
place it on a mesh when given one. A state sharded over a mesh is saved
whole (its blocks joined), so its files hold what the equal one-device
state's hold. A
write lands in a temporary directory beside its target (named
``.<name>.<random>.tmp``, never ``step_*``) and is renamed into place; a
target that exists is moved aside first and removed after, so a resumed
run overwrites ``final`` as the reference's ``force=True`` does.

The committed weights under :data:`CHECKPOINT_ROOT` are the JAX package's
in-repo checkpoints converted to that form (params, and for ``sr2x_64``
its whole train state); their conversion (which needs orbax, and so JAX)
lives in ``tests/test_torch_checkpoint.py``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dvf_tpu_torch.train import optim

CHECKPOINT_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")
PARAMS_FILE = "params.npz"
STATE_FILE = "state.npz"


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
    with np.load(npz) as z:
        return optim.unflatten({k: torch.from_numpy(np.array(z[k])) for k in z.files})


def save_params(path: str, params: Dict[str, Any]) -> str:
    """Write a nested dict of arrays or tensors as ``<path>/params.npz``."""
    flat = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in optim.flatten(params).items()}
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

        # step_NNNNNN only (a staging dir, the port's '.step_*.<random>.tmp'
        # or orbax's 'step_*.orbax-checkpoint-tmp', is not a checkpoint),
        # sorted by number, not by name.
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


# ------------------------------------------------- train state: save / restore

def _host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy (a CPU tensor is copied too: the step writes its
    leaves in place while a background write may still read them)."""
    return t.detach().to("cpu", copy=True).numpy()


def _snapshot(state) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(params, the rest of the state) as host arrays keyed by path, each
    leaf whole."""
    params = {k: _host(v) for k, v in optim.flatten(optim.whole(state.params)).items()}
    count, mu, nu = optim.adam_state(state.opt_state, state.params)
    rest = {f"opt/mu/{k}": _host(v) for k, v in mu.items()}
    rest.update({f"opt/nu/{k}": _host(v) for k, v in nu.items()})
    rest["opt/count"] = np.asarray(count, np.int32)
    rest["step"] = _host(state.step).astype(np.int32)
    if hasattr(state, "vgg_params"):
        rest.update({f"vgg/{k}": _host(v)
                     for k, v in optim.flatten(optim.whole(state.vgg_params)).items()})
        rest.update({f"grams/{i}": _host(g) for i, g in enumerate(state.style_grams)})
    return params, rest


def _write(path: str, params: Dict[str, np.ndarray],
           rest: Dict[str, np.ndarray]) -> str:
    """Both files into a temporary directory beside ``path``, then renamed
    into place (an existing ``path`` moved aside first, then removed)."""
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{name}.", suffix=".tmp", dir=parent)
    try:
        os.chmod(tmp, 0o755)   # mkdtemp's 0700 would outlive the rename
        np.savez(os.path.join(tmp, PARAMS_FILE), **params)
        np.savez(os.path.join(tmp, STATE_FILE), **rest)
        old = None
        if os.path.exists(path):
            old = os.path.join(parent, f".{name}.{uuid.uuid4().hex}.old")
            os.rename(path, old)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return path


def save_checkpoint(path: str, state) -> str:
    """Write a train state (either family) to ``path``. Blocking;
    overwrites an existing checkpoint there."""
    return _write(os.path.abspath(path), *_snapshot(state))


def _read(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    out = []
    for fname in (PARAMS_FILE, STATE_FILE):
        f = os.path.join(path, fname)
        if not os.path.exists(f):
            raise FileNotFoundError(
                f"{f} missing — a train checkpoint holds {PARAMS_FILE} and "
                f"{STATE_FILE} (an orbax checkpoint of the JAX package "
                f"converts with tests/test_torch_checkpoint.py)")
        with np.load(f) as z:
            out.append({k: np.array(z[k]) for k in z.files})
    return out[0], out[1]


def _take(arrays: Dict[str, np.ndarray], like: Dict[str, torch.Tensor],
          what: str, path: str) -> Dict[str, torch.Tensor]:
    """The arrays of ``like``'s keys as tensors with ``like``'s shapes,
    dtypes and devices; a missing or an extra key raises."""
    if set(arrays) != set(like):
        raise KeyError(
            f"{path}: {what} keys differ from the template's: missing "
            f"{sorted(set(like) - set(arrays))}, extra "
            f"{sorted(set(arrays) - set(like))}")
    out = {}
    for k, t in like.items():
        a = arrays[k]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{path}: {what} {k!r} has shape {a.shape}, the "
                             f"template {tuple(t.shape)}")
        out[k] = torch.from_numpy(a).to(t.device, t.dtype)
    return out


def _restore_state(path: str, template):
    """The state at ``path`` on the template's (first) device, whole."""
    path = os.path.abspath(path)
    params_np, rest_np = _read(path)
    dev = template.step.device
    tmpl = optim.flatten(optim.whole(template.params))
    params = optim.trainable(optim.unflatten(_take(params_np, tmpl, "params", path)), dev)
    like = {**{f"opt/mu/{k}": v for k, v in tmpl.items()},
            **{f"opt/nu/{k}": v for k, v in tmpl.items()},
            "opt/count": torch.zeros((), dtype=torch.int32),
            "step": template.step}
    style = hasattr(template, "vgg_params")
    if style:
        like.update({f"vgg/{k}": v for k, v in
                     optim.flatten(optim.whole(template.vgg_params)).items()})
        like.update({f"grams/{i}": g for i, g in enumerate(template.style_grams)})
    rest = _take(rest_np, like, "state", path)
    opt = optim.adam(params, template.opt_state.param_groups[0]["lr"])
    optim.set_adam_state(opt, params, int(rest["opt/count"]),
                         {k: rest[f"opt/mu/{k}"] for k in tmpl},
                         {k: rest[f"opt/nu/{k}"] for k in tmpl})
    fields = dict(params=params, opt_state=opt, step=rest["step"])
    if style:
        fields.update(
            vgg_params=optim.unflatten(
                {k[len("vgg/"):]: v for k, v in rest.items() if k.startswith("vgg/")}),
            style_grams=[rest[f"grams/{i}"] for i in range(len(template.style_grams))])
    return type(template)(**fields)


def restore_checkpoint(path: str, template, mesh=None, config=None):
    """Load a style TrainState from ``path``. ``template`` (e.g. a fresh
    ``train.style.init_train_state``) gives the structure, dtypes, device
    and learning rate; every key must match it. With ``mesh`` (and
    ``config``, the default ``StyleTrainConfig()`` otherwise) the state
    is placed straight onto the mesh per ``state_pspecs``."""
    from dvf_tpu_torch.train.style import StyleTrainConfig, shard_train_state

    state = _restore_state(path, template)
    if mesh is not None:
        state = shard_train_state(state, mesh, config or StyleTrainConfig())
    return state


def restore_sr_checkpoint(path: str, template, mesh=None, config=None):
    """SR counterpart of :func:`restore_checkpoint` (template = a fresh
    ``train.sr.init_train_state``)."""
    from dvf_tpu_torch.train.sr import SrTrainConfig, shard_train_state

    state = _restore_state(path, template)
    if mesh is not None:
        state = shard_train_state(state, mesh, config or SrTrainConfig())
    return state


class AsyncSaver:
    """Checkpoint writes off the training loop's thread.

    One write in flight: ``save()`` first waits for the previous write
    (re-raising its error), snapshots the state to host memory (which
    waits for the device's pending steps), and returns once the write is
    handed to a background thread. ``close()`` drains the last write and
    re-raises its error."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="dvf-ckpt")
        self._pending: Optional[Future] = None

    def _drain(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def save(self, path: str, state) -> str:
        path = os.path.abspath(path)
        self._drain()
        self._pending = self._pool.submit(_write, path, *_snapshot(state))
        return path

    def close(self) -> None:
        try:
            self._drain()
        finally:
            self._pool.shutdown(wait=True)
