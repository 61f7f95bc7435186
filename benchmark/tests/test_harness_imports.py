"""What the benchmark may import, and its formulas against FlopCounterMode
over the reference's plain versions."""

from __future__ import annotations

import ast

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import rooflines
from conftest import BENCH
from reference.model import recurrence
from reference.steps import contrastive

FORBIDDEN = {"jax", "jaxlib", "flax", "ha2g_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        found = _imports(path)
        assert "ha2g_torch" not in found and not (found & FORBIDDEN), path


@pytest.mark.parametrize("T,B,H", [(5, 3, 8), (7, 2, 12)])
def test_b1_formulas(T, B, H):
    xp = torch.randn(T, 2, B, 3 * H, requires_grad=True)
    w = torch.randn(2, H, 3 * H)
    b = torch.randn(2, 3 * H)
    # an h0 that takes a gradient: the kernel's loop runs all T steps
    h0 = torch.zeros(2, B, H, requires_grad=True)
    with FlopCounterMode(display=False) as fwd:
        out = recurrence(xp, w, b, h0=h0)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    assert fwd.get_total_flops() == rooflines.b1_fwd(T, B, H, 2)[0]
    assert bwd.get_total_flops() == rooflines.b1_bwd(T, B, H, 2)[0]


@pytest.mark.parametrize("N,D", [(16, 4), (40, 32)])
def test_contrastive_formulas(N, D):
    a = torch.randn(N, D, requires_grad=True)
    b = torch.randn(N, D, requires_grad=True)
    with FlopCounterMode(display=False) as fwd:
        loss = contrastive(a, b)
    with FlopCounterMode(display=False) as bwd:
        loss.backward()
    assert fwd.get_total_flops() == rooflines.contrastive_fwd(N, D)[0]
    # B3 and B4: the gradient to each side
    assert bwd.get_total_flops() == 2 * rooflines.contrastive_bwd(N, D)[0]
