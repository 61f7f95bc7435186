"""The benchmark's own CPU tests: the ``cuda`` marker, and each cell run
at tiny widths on the CPU.  Nothing here imports JAX."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

# tiny widths for a CPU run: every cell's code path, seconds not hours
TINY_CONFIG = {"hidden_size": 16, "wordembed_dim": 16, "n_layers": 2,
               "n_words": 40, "n_speakers": 5, "batch_size": 4,
               "compute_dtype": "float32"}
TINY_TRAFFIC = {"batch_synth": {"clips": 3, "clip_seconds": 4.5, "ring": 2,
                                "warmup_calls": 1, "check_rows": 2,
                                "check_calls": 2, "trace_calls": 1},
                "train_gan": {"steps_per_epoch": 3}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on machines without one")


def tiny_run(name: str, seed: int = 12345678901, seconds: float = 1.0,
             config=None, traffic=None):
    """One run of cell ``name`` on the CPU at tiny widths -> the result."""
    import torch

    import harness
    import run as bench_run
    cell = harness.load_cell(name)
    cfg = {**cell.config, **TINY_CONFIG, **(config or {})}
    tr = {**cell.traffic, **TINY_TRAFFIC[cell.traffic["driver"]], **(traffic or {})}
    return bench_run.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                              config=cfg, traffic=tr)


@pytest.fixture
def cpu_run():
    return tiny_run
