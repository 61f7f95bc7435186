"""Each cell end to end on the CPU at tiny widths, with a short window:
the result has the contract's keys, every end-to-end metric of the cell,
and comes out correct against the reference."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH, tiny_run

CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json")
                                       .read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_cpu(name):
    r = tiny_run(name, seconds=1.0)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    json.dumps(r)


def test_seed_gives_the_same_inputs():
    """Two runs of one seed check the same answers to the same numbers."""
    a = tiny_run("expressive-batch256", seed=2 ** 31 + 7, seconds=0.1)
    b = tiny_run("expressive-batch256", seed=2 ** 31 + 7, seconds=0.1)
    assert a["checks"] == b["checks"]
