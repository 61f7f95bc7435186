"""On the card: every cell through the benchmark's own command, a short
window, exit 0 and correct.  Skips without CUDA (decided in the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH

CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json")
                                       .read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", name,
                          "--seed", "4000000001", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=600,
                         cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_no_result_without_a_card():
    """Without enough CUDA devices the command exits non-zero and prints
    nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=BENCH.parent)
    assert out.returncode != 0 and out.stdout == ""
