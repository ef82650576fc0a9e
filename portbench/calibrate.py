"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 3
        [--control] [--fault unchanged|half_batch|altered]

For each seed, in one process: the program's run of the cell at its own
size with a short window (or, with ``--fault``, that run with the timed
path broken underneath), or with ``--control`` the control's reading (the
float8 reference in the program's place). One JSON line per seed, then a
summary line with the largest and smallest reading of each number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from portbench import run as runmod

    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    runmod.set_cache_dirs()

    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    cell = spec.load_cell(args.workload)
    config = spec.load_config(cell["config"])
    driver = spec.load_module("traffic", cell["traffic"])
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.control:
            ctx = runmod.Ctx(cell=cell, config=config, seed=seed, seconds=args.seconds,
                             trace=False, device=dev)
            got = driver.control(ctx)
            row = {"seed": seed, "control": got}
        else:
            res = runmod.run_cell(args.workload, seed, args.seconds, False, dev,
                                  fault=args.fault)
            got = {k: c["value"] for k, c in res["checks"].items()}
            row = {"seed": seed, "fault": args.fault, "checks": got,
                   "correct": res["correct"], "failed": res["failed"],
                   "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                   "detail": res.get("detail")}
        readings.append(got)
        print(json.dumps(row), flush=True)
    summary = {k: {"max": max(r[k] for r in readings), "min": min(r[k] for r in readings)}
               for k in readings[0]}
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "fault": args.fault, "seeds": len(readings), "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
