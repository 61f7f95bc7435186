"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (``setup_s``), measures for ``--seconds``
(the cell's end-to-end metrics with ``--trace 0``), or with ``--trace 1``
also traces a short segment after the window twice, once with CUDA
activity alone and once with the host's operations too, and reads the
cell's per-layer metrics from them; then frees the program, checks what the window
produced against the plain reference, and prints as its last line one
JSON object: correct, attempted, failed, metrics, device, (breakdown,)
checks.  Exits non-zero, printing no result, without enough CUDA devices
or if JAX, Flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the benchmark's own modules, and the checkout's root for the program
sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

import harness  # noqa: E402


class Run:
    """What a driver is handed: the cell's configuration and traffic, the
    seed and the device."""

    def __init__(self, cell, seed: int, device, config=None, traffic=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.config = config or cell.config
        self.traffic = traffic or cell.traffic


def per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        value = harness.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class Context:
    """What a per-layer reader sees: the traces of the segment (``trace``,
    CUDA activity alone; ``ops``, with the host's operations) and its unit
    count, the window's rate, the model FLOPs and the hand kernels' work
    of one unit, the cell."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = None, config=None, traffic=None) -> dict:
    """One run of ``cell`` -> the result object (None if a forbidden
    module was loaded)."""
    from trace_reader import record

    t0 = T0 if t0 is None else t0
    drv = harness.driver(cell)
    run = Run(cell, seed, device, config, traffic)
    state = drv.setup(run)
    # what set-up made stays out of the window's collections
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    before = harness.host_snapshot()
    stats = drv.window(state, seconds)
    print(harness.host_look(before, harness.host_snapshot(), stats.get("unit_s", ())),
          file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return None
    result_device = harness.device_info(device, cell.workload["chips"])
    metrics, breakdown, trace_ctx = {}, None, None
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else stats[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # the device's pace from a trace of CUDA activity alone; the launch
        # calls and the breakdown from one with the host's operations too
        units, tr = record(lambda: drv.traced(state))
        _, ops = record(lambda: drv.traced(state), host_ops=True)
        kernels = sum(1 for n, _, _ in tr.device
                      if not n.startswith(("Memcpy", "Memset")))
        print(f"traced: {units} units, {kernels} kernels on the device, "
              f"launch calls {tr.launch_calls()} (with host operations: "
              f"{ops.launch_calls()}), window {tr.window_s:.4f} s "
              f"({ops.window_s:.4f} s with host operations)", file=sys.stderr)
        result_device["busy_s"] = tr.busy_s()
        result_device["window_s"] = tr.window_s
        breakdown = {"device_ops": ops.top_device_ops(), "idle_gaps": ops.idle_gaps()}
        trace_ctx = dict(trace=tr, ops=ops, units=units, rate=state.rate,
                         state=state, work=drv.work(state), config=run.config)
    drv.release(state)
    checked = drv.check(state, count_flops=trace)
    if trace:
        metrics = per_layer(cell, Context(flops_per_unit=checked["flops_per_unit"],
                                          **trace_ctx))
    # a number with no limit file entry is not compared (PERF.md says why)
    checks = {k: {"value": checked["numbers"][k], "limit": lim["limit"]}
              for k, lim in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": stats["attempted"],
              "failed": stats["failed"], "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda:0"))
    if result is None:
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
