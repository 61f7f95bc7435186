"""The benchmark's own CPU tests: the ``cuda`` marker, and each cell run
at tiny widths on the CPU.  Nothing here imports JAX."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

# tiny widths for a CPU run, one file a driver: every cell's code path,
# seconds not hours
TINY = Path(__file__).resolve().parent / "tiny"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on machines without one")


def tiny(cell):
    """The cell's configuration and traffic with ``tiny/<driver>.json``'s
    ``config`` and ``traffic`` laid over them -> (config, traffic)."""
    path = TINY / f"{cell.traffic['driver']}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"no tiny CPU settings for driver {cell.traffic['driver']!r}: add "
            f"{path.relative_to(BENCH.parent)} with its tiny \"config\" and "
            f"\"traffic\"")
    t = json.loads(path.read_text())
    return {**cell.config, **t["config"]}, {**cell.traffic, **t["traffic"]}


def tiny_run(name: str, seed: int = 12345678901, seconds: float = 1.0,
             config=None, traffic=None):
    """One run of cell ``name`` on the CPU at tiny widths -> the result."""
    import torch

    import harness
    import run as bench_run
    cell = harness.load_cell(name)
    cfg, tr = tiny(cell)
    return bench_run.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                              config={**cfg, **(config or {})},
                              traffic={**tr, **(traffic or {})})


@pytest.fixture
def cpu_run():
    return tiny_run
