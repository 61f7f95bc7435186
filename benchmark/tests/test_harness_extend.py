"""Adding a configuration, a cell and a per-layer metric is adding files
and entries: in a copy of the benchmark, a dummy configuration file, a
cell that names it, its limits and a dummy metric are added, and the cell
runs end to end with no file of the copy edited but BENCHMARK.json."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from conftest import BENCH

SCRIPT = r"""
import json, sys
sys.path[:0] = [{tests!r}, {bench!r}, {root!r}, {repo!r}]
from conftest import tiny_run
import harness, run
cell = harness.load_cell("dummy-cell")
print(json.dumps({{"per_layer": [m["name"] for m in cell.per_layer],
                  "result": tiny_run("dummy-cell", seconds=0.1),
                  "dummy": run.per_layer(cell, run.Context(value=7.5))}}))
"""


def test_added_cell_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / "ha2g-gesture.json").read_text())
    (root / "benchmark" / "configs" / "dummy-config.json").write_text(
        json.dumps({**conf, "n_speakers": 3}))
    (root / "benchmark" / "limits" / "dummy-cell.json").write_text(
        (BENCH / "limits" / "gesture-train-b256.json").read_text())
    (root / "benchmark" / "metrics" / "dummy.metric.py").write_text(
        "def read(ctx):\n    return ctx.value\n")
    bench["configs"].append({"name": "dummy-config", "source": "https://example.org",
                             "file": "benchmark/configs/dummy-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "train_gan", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("dummy-cell")
    bench["per_layer"] = [{"name": "dummy.metric", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "train_samples_per_s",
                           "workloads": ["dummy-cell"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = SCRIPT.format(tests=str(root / "benchmark" / "tests"),
                         bench=str(root / "benchmark"), root=str(root),
                         repo=str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["per_layer"] == ["dummy.metric"]
    assert got["result"]["correct"] and "train_samples_per_s" in got["result"]["metrics"]
    assert got["dummy"] == {"dummy.metric": {"value": 7.5, "unit": "%"}}
