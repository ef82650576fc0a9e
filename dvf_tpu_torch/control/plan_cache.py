"""On-disk plan cache — the auto-plan plane's persistence tier
(port of ``dvf_tpu.control.plan_cache``).

A sibling of the stage profiles: where those store *measured stage
costs*, this stores the planner's *decisions* — the winning
:class:`~dvf_tpu_torch.control.planner.Plan` for a (canonical signature,
geometry, topology fingerprint, planner version) key — plus the
compile-time calibrations (``h2d_block_ms`` / ``d2h_block_ms`` /
``step_block_ms``) keyed per (backend, topology fingerprint), so a warm
restart skips BOTH the candidate search and the blocking re-measurement
passes at engine compile.

Keying discipline (pinned by tests/test_torch_planner.py): any change to the
op chain, the geometry, the device topology, or the planner's own
version misses — a plan searched on a card must never drive a
CPU host, and a planner whose candidate grid or scoring changed must
re-search rather than trust a stale winner. Corrupt or foreign cache
entries load as None (the caller re-plans); a broken cache file must
never crash a startup.

Same durability discipline as `obs.lineage`'s stage profiles: atomic
tmp+rename writes, one flock'd lock file per directory against
concurrent writers (N fleet replicas planning at once), best-effort
everywhere — plans are optimization state, never worth failing a serve
over.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Optional

# Bump when the Plan schema, the candidate grid, or the scoring model
# changes shape: a cached winner from an older planner must re-search,
# not silently drive the new runtime.
PLANNER_VERSION = 1

PLAN_SCHEMA = "dvf.plan_cache.v1"
CAL_SCHEMA = "dvf.plan_calibrations.v1"

DEFAULT_PLAN_CACHE_DIR = ".dvf_plan_cache"


# ---------------------------------------------------------------------------
# Topology fingerprint
# ---------------------------------------------------------------------------


def _axes(cfg) -> str:
    return f"data={cfg[0]},space={cfg[1]},model={cfg[2]}"


def _driver_version() -> str:
    """The CUDA driver's version as ``cuDriverGetVersion`` reports it
    (e.g. 12080), or "?" when the driver library cannot be asked."""
    import ctypes

    try:
        get = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion
    except (OSError, AttributeError):
        return "?"
    get.argtypes = [ctypes.POINTER(ctypes.c_int)]
    get.restype = ctypes.c_int
    v = ctypes.c_int(0)
    return str(v.value) if get(ctypes.byref(v)) == 0 else "?"


def topology_fingerprint(target: Any = None) -> str:
    """A stable string for "what hardware, laid out how": the backend
    (``cuda`` or ``cpu``), on a card its name, the device count and the
    driver and CUDA versions, and the mesh's axis shape. ``target`` is
    what an ``Engine`` spans: its mesh (``Engine.mesh``), or the device
    it runs on (``Engine.device``: the axes of a one-device mesh); None
    is the device an engine takes by default here (``cuda:0``, or the CPU
    where there is no card), so a meshless call equals the fingerprint of
    an engine on that device. Every fingerprint starts with ``torch-``,
    so an entry the JAX package wrote never matches one of the port's,
    and a CPU entry never matches a card's. Never raises: when the
    device cannot be enumerated the fingerprint is ``"unknown"`` (every
    lookup misses — correct, just cold)."""
    try:
        import torch

        from dvf_tpu_torch.parallel.mesh import Mesh

        if isinstance(target, Mesh):
            axes = _axes(target.devices.shape)
            device = target.first_device
        else:
            axes = _axes((1, 1, 1))
            device = target
        if device is None:
            device = "cuda:0" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        if dev.type == "cpu":
            return f"torch-cpu/cpu/n1/{axes}"
        if dev.type != "cuda" or not torch.cuda.is_available():
            return "unknown"
        n = torch.cuda.device_count()
        name = torch.cuda.get_device_name(
            dev.index if dev.index is not None else 0)
        return (f"torch-cuda/{name}/n{n}/driver={_driver_version()},"
                f"cuda={torch.version.cuda}/{axes}")
    except Exception:  # noqa: BLE001 — a fingerprint failure = cache cold
        return "unknown"


# ---------------------------------------------------------------------------
# Plan entries
# ---------------------------------------------------------------------------


def _plan_key(signature: str, geometry, topology: str,
              planner_version: int) -> str:
    geo = "x".join(str(int(d)) for d in tuple(geometry))
    raw = f"{signature}|{geo}|{topology}|v{int(planner_version)}"
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def plan_path(cache_dir: str, signature: str, geometry, topology: str,
              planner_version: int = PLANNER_VERSION) -> str:
    return os.path.join(
        cache_dir,
        f"plan-{_plan_key(signature, geometry, topology, planner_version)}"
        f".json")


def save_plan(cache_dir: str, signature: str, geometry, topology: str,
              plan_doc: dict,
              planner_version: int = PLANNER_VERSION) -> Optional[str]:
    """Persist one winning plan (atomic tmp+rename). The key fields are
    stored IN the entry too, so a load re-verifies them — a hash
    collision or a hand-edited file degrades to a miss, never to a
    foreign plan driving the runtime. Returns the path, or None when
    the write failed (best-effort)."""
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = plan_path(cache_dir, signature, geometry, topology,
                         planner_version)
        doc = {
            "schema": PLAN_SCHEMA,
            "planner_version": int(planner_version),
            "signature": signature,
            "geometry": [int(d) for d in tuple(geometry)],
            "topology": topology,
            "plan": dict(plan_doc),
            "updated": time.time(),
        }
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def load_plan(cache_dir: Optional[str], signature: str, geometry,
              topology: str,
              planner_version: int = PLANNER_VERSION) -> Optional[dict]:
    """The cached plan dict for this exact key, or None on a miss —
    where "miss" includes absent, unreadable, corrupt JSON, a foreign
    schema/planner version, and an entry whose embedded key fields
    disagree with the request (each pinned by tests/test_planner.py).
    Never raises: a broken cache entry re-plans, it does not crash
    startup."""
    if not cache_dir:
        return None
    try:
        with open(plan_path(cache_dir, signature, geometry, topology,
                            planner_version)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != PLAN_SCHEMA:
        return None
    if doc.get("planner_version") != int(planner_version):
        return None
    if doc.get("signature") != signature or doc.get("topology") != topology:
        return None
    if list(doc.get("geometry") or ()) != [int(d) for d in tuple(geometry)]:
        return None
    plan = doc.get("plan")
    return dict(plan) if isinstance(plan, dict) else None


# ---------------------------------------------------------------------------
# Compile-time calibrations (per backend+topology, per batch signature)
# ---------------------------------------------------------------------------


_CAL_KEYS = ("h2d_block_ms", "d2h_block_ms", "step_block_ms")


def calibration_path(cache_dir: str, topology: str) -> str:
    """One JSON file per (backend, topology) — the backend is part of
    the topology fingerprint — holding every batch signature's
    calibration triple measured on that hardware."""
    h = hashlib.sha256(topology.encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"plan-cal-{h}.json")


def save_calibrations(cache_dir: str, topology: str, signature: str,
                      cal: dict) -> Optional[str]:
    """Record one batch signature's measured calibration triple under
    its topology's file (read-merge-write under the directory flock —
    N replicas compiling different signatures share one file). Only
    the known keys persist; None values are kept (d2h is legitimately
    None above the calibration size cap, and a seed must reproduce
    that). Best-effort."""
    entry = {k: cal.get(k) for k in _CAL_KEYS}
    if all(v is None for v in entry.values()):
        return None
    lock_f = None
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = calibration_path(cache_dir, topology)
        try:
            import fcntl

            lock_f = open(os.path.join(cache_dir, ".plan-cache.lock"), "w")
            fcntl.flock(lock_f, fcntl.LOCK_EX)
        except (ImportError, OSError):
            lock_f = None
        doc = None
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            doc = None
        if (not isinstance(doc, dict) or doc.get("schema") != CAL_SCHEMA
                or doc.get("topology") != topology
                or not isinstance(doc.get("signatures"), dict)):
            doc = {"schema": CAL_SCHEMA, "topology": topology,
                   "signatures": {}}
        doc["signatures"][signature] = entry
        doc["updated"] = time.time()
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except OSError:
        return None
    finally:
        if lock_f is not None:
            try:
                lock_f.close()
            except OSError:
                pass


def load_calibrations(cache_dir: Optional[str], topology: str,
                      signature: str) -> Optional[dict]:
    """One batch signature's calibration triple for this topology, or
    None on any miss/corruption (the compile re-measures — the cold
    path is always correct)."""
    if not cache_dir:
        return None
    try:
        with open(calibration_path(cache_dir, topology)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    if (not isinstance(doc, dict) or doc.get("schema") != CAL_SCHEMA
            or doc.get("topology") != topology):
        return None
    entry = (doc.get("signatures") or {}).get(signature)
    if not isinstance(entry, dict):
        return None
    out = {k: entry.get(k) for k in _CAL_KEYS}
    # A seed must carry a real step cost — it is what the analytic
    # scorer and the bucket scheduler start from; h2d alone is not
    # worth skipping the measurement passes for.
    if not isinstance(out.get("step_block_ms"), (int, float)):
        return None
    if not isinstance(out.get("h2d_block_ms"), (int, float)):
        return None
    return out
