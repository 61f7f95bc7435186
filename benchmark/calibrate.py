"""Readings that the correctness limits are set from (PERF.md gives them);
the benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --what program,control[,<fault>...] [--seconds 2]

For each seed, one process: the cell's set-up and a short window at its
own size, then
  program     the numbers a run compares (the lower reading);
  control     the driver's ``control``: the same numbers with the float32
              reference in the program's place computed in float8 (e4m3, a
              scale a tensor);
  <fault>     a name in the driver's ``FAULTS`` (training: ``half_batch``,
              the reference stepping on the first half of each batch's
              rows, the mean over them), in the program's place.
Prints one JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

import harness  # noqa: E402
from reference.precision import Precision  # noqa: E402
from run import Run  # noqa: E402


def readings(cell, seed: int, seconds: float, what, device, config=None,
             traffic=None) -> dict:
    drv = harness.driver(cell)
    st = drv.setup(Run(cell, seed, device, config, traffic))
    drv.window(st, seconds)
    drv.release(st)
    out = {}
    if "program" in what:
        checked = drv.check(st)
        out["program"] = {**checked["numbers"], **checked.get("detail", {})}
    if "control" in what:
        out["control"] = drv.control(st, Precision("float8"))
    for name, fault in getattr(drv, "FAULTS", {}).items():
        if name in what:
            out[name] = fault(st)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    what = args.what.split(",")
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, args.seconds, what, torch.device("cuda:0"))
        print(json.dumps({"workload": args.workload, "seed": seed, **r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
