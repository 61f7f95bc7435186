"""The control: the reference in the program's place, computed in float8
(e4m3, a scale a tensor), fails each cell's comparison.  At tiny widths
here; the chip's readings at the cells' sizes come from calibrate.py
(PERF.md)."""

from __future__ import annotations

import json

import pytest
import torch

import harness
from calibrate import readings
from conftest import BENCH, tiny

CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json")
                                       .read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = harness.load_cell(name)
    cfg, tr = tiny(cell)
    r = readings(cell, 99, 0.1, ("control",), torch.device("cpu"), cfg, tr)
    assert any(r["control"][k] > lim["limit"] for k, lim in cell.limits.items()
               if k in r["control"]), r
