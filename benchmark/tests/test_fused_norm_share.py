"""``fused_norm_share.diffuse`` on hand-made traces: PyTorch's layer norm
alone, the program's fused add and layer norm alone, both, and no norm;
and the fused kernel is no attention kernel to ``attn_roofline.diffuse``."""

from __future__ import annotations

import json

import pytest

import harness
from conftest import BENCH
from test_diffuse_metrics import CELL, _read

TORCH_NORM = ("void at::native::(anonymous namespace)::vectorized_layer_norm_"
              "kernel<c10::BFloat16, float, false>(int, float, ...)")
FUSED = ("void (anonymous namespace)::add_layer_norm_kernel<__nv_bfloat16, "
         "2>(const T1 *, const T1 *, ...)")
ADD = ("void at::native::vectorized_elementwise_kernel<8, at::native::"
       "CUDAFunctorOnSelf_add<c10::BFloat16>, ...>")
GEMM = "nvjet_tst_128x160_64x5_4x2_h_bz_coopA_bias_TNT"


def _read_names(metric, names, **kw):
    """``metric`` on a trace of ``names``, one kernel a microsecond."""
    device = [(n, float(i), i + 0.5) for i, n in enumerate(names)]
    return _read(metric, device=device, window=len(names) + 1.0, **kw)


@pytest.mark.parametrize("names,want", [
    ([TORCH_NORM, ADD, GEMM] * 17, 0.0),
    ([FUSED, GEMM] * 17, 1.0),
    ([FUSED, TORCH_NORM, ADD, FUSED, GEMM, FUSED, FUSED], 0.8),
    ([GEMM, ADD], None),
    ([], None)])
def test_fused_norm_share(names, want):
    assert _read_names("fused_norm_share.diffuse", names) == want


def test_fused_kernel_is_no_attention():
    work = {"attn": [(128, 8, 34, 64, 4000)]}
    assert _read_names("attn_roofline.diffuse", [FUSED, TORCH_NORM, GEMM],
                       work=work) is None


def test_entry():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"]
                if m["name"] == "fused_norm_share.diffuse"]
    assert entry == {"name": "fused_norm_share.diffuse", "unit": "fraction",
                     "better": "higher", "source": "device_trace",
                     "layer": "model", "moves": "frames_per_s",
                     "workloads": [CELL]}
    assert "fused_norm_share.diffuse" in [
        m["name"] for m in harness.load_cell(CELL).per_layer]
