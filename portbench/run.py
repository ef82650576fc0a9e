"""Run one cell once and print its result line.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit, which are also the last lines of
standard error. Without a CUDA device, or with ``jax``, ``jaxlib``,
``flax`` or ``dvf_tpu`` loaded once the window has closed, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import time

_T0_WALL, _T0_PERF = time.time(), time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.spans import Spans  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dvf_tpu")
CACHE_ENV = {
    "DVF_COMPILE_CACHE_DIR": "dvf_build",
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": "inductor",
    "CUDA_CACHE_PATH": "cuda",
}


def set_cache_dirs(root: str = spec.ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (``portbench/.cache/``, git-ignored), set before torch or the program
    is imported, so only a checkout's first run builds."""
    for var, sub in CACHE_ENV.items():
        path = os.path.join(root, ".cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def process_start_wall() -> float:
    """The wall-clock time this process started (from /proc), or the time
    this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T0_WALL


def setup_seconds(t_start_perf: float) -> float:
    """Process start to the window's start."""
    return (t_start_perf - _T0_PERF) + (_T0_WALL - process_start_wall())


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""
    cell: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    root: str = spec.ROOT
    spans: Spans = dataclasses.field(default_factory=Spans)
    fault: Optional[str] = None   # a break planted under the timed path (tests,
    #   calibration); the benchmark's own runs never set it
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """The end of a set-up phase (reported as ``setup_phases``)."""
        self.marks.append((name, time.perf_counter()))

    @property
    def params(self) -> Dict[str, Any]:
        return self.cell["params"]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: str = spec.ROOT, fault: Optional[str] = None,
             cell_override: Optional[Dict[str, Any]] = None,
             marks: Optional[list] = None) -> Dict[str, Any]:
    """Drive one cell and reduce it: everything but the check for a card.
    ``cell_override`` merges into the cell's ``params`` (CPU tests)."""
    bench = spec.load_benchmark(root)
    cell = spec.load_cell(name, root)
    if cell_override:
        cell["params"] = {**cell["params"], **cell_override}
    config = spec.load_config(cell["config"], root)
    driver = spec.load_module("traffic", cell["traffic"], root)
    ctx = Ctx(cell=cell, config=config, seed=seed, seconds=seconds, trace=trace,
              device=device, root=root, fault=fault, marks=list(marks or []))
    out = driver.run(ctx)
    out["setup_s"] = setup_seconds(out["t_start"])
    out["ctx"] = ctx
    kind, folder = ("per_layer", "layer_metrics") if trace else ("end_to_end", "end_to_end")
    metrics = {}
    for m in spec.metrics_for(bench, name, kind):
        value = spec.load_module(folder, m["name"], root).read(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  and not math.isnan(c["value"]) for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics}
    phases, prev = {}, _T0_PERF
    for phase, t in ctx.marks + [("warmup", out["t_start"])]:
        phases[phase] = t - prev
        prev = t
    result["setup_phases"] = phases
    result["reference_s"] = out.get("reference_s")
    if out.get("detail"):
        result["detail"] = out["detail"]
    device_row = {"memory_peak_bytes": int(out["memory_peak_bytes"])}
    tr = out.get("trace")
    if trace and tr is not None:
        device_row.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["top_ops"], "idle_gaps": tr["idle_gaps"]}
        result["trace_events"] = {"device": tr["n_device_events"],
                                  "kernels_in_window": tr["n_kernels"]}
    result["device"] = device_row
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    bench = spec.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]

    import torch

    marks = [("import_torch", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    marks.append(("cuda_init", time.perf_counter()))
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda:0"), marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the measuring process: {bad}", file=sys.stderr)
        return 4
    dev = result.pop("device")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": chips, **dev, "power_limit_w": power_limit_w()}
    result["checks"] = result.pop("checks")
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
