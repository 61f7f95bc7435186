"""The diffusion cell's readers on hand-made traces, its attention formula
against FlopCounterMode over the reference's plain attention, and the
driver's FLOPs of a call (one pass and one encoder call, times the passes
and windows) against a direct count of the reference's whole synthesis."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness
from conftest import BENCH, tiny
from harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from reference.diffgesture import DiffGesture, attention, synthesize
from run import Context
from trace_reader import Trace

CELL = "diffgesture-expressive-batch64"
LAUNCH = "cudaLaunchKernel"
STEPS = 500


def _read(metric, host=(), device=(("kernel", 0.0, 10.0),), window=100.0,
          **kw):
    trace = Trace(list(device), list(host), (0.0, window))
    ctx = Context(ops=trace, trace=trace, units=1,
                  config={"diffusion_steps": STEPS}, **kw)
    return harness.metric_reader(metric).read(ctx)


@pytest.mark.parametrize("R,h,L,d", [(4, 2, 5, 8), (6, 8, 34, 64)])
def test_attention_formula(R, h, L, d):
    q, k, v = (torch.randn(R, h, L, d) for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        attention(q, k, v)
    work = harness.metric_reader("attn_roofline.diffuse").attn_work
    assert work(R, h, L, d)[0] == fc.get_total_flops()
    assert work(R, h, L, d)[1] == 4 * q.numel() * 2


def test_attention_roofline_reads_attention_kernels_only():
    device = [("pytorch_flash::flash_fwd_kernel<...>", 1.0, 1.002),
              ("fmha_cutlassF_bf16_aligned", 2.0, 2.001),
              ("sm90_xmma_gemm_bf16bf16", 3.0, 3.5)]
    work = {"attn": [(128, 8, 34, 64, 4000)]}
    got = _read("attn_roofline.diffuse", device=device, work=work)
    flops, nbytes = 4 * 128 * 8 * 34 * 34 * 64, 4 * 128 * 34 * 8 * 64 * 2
    least = 4000 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    assert got == pytest.approx(100 * least / 0.003)
    assert _read("attn_roofline.diffuse", work=work) is None


def test_idle_share_and_mfu():
    device = [("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 7.0)]
    assert _read("idle_share.diffuse", device=device, window=10.0) == \
        pytest.approx(60.0)
    got = _read("mfu.diffuse", flops_per_unit=2e15, rate=0.25)
    assert got == pytest.approx(100 * 2e15 * 0.25 / PEAK_BF16_FLOPS)
    assert _read("mfu.diffuse", flops_per_unit=None, rate=0.25) is None


def _chains(replayed):
    host = []
    for i, r in enumerate(replayed):
        s = 10.0 * i
        host += [("ha2g.diffuse.window", s, s + 9), ("ha2g.diffuse.condition", s, s + 1),
                 (LAUNCH, s + 0.5, s + 0.51), ("ha2g.diffuse.chain", s + 2, s + 8)]
        if r:
            host += [("ha2g.diffuse.replay", s + 3, s + 7),
                     ("cudaGraphLaunch", s + 4, s + 4.01)]
        else:
            host += [(LAUNCH, s + 2.5 + j * 0.01, s + 2.505 + j * 0.01)
                     for j in range(300)]
    return host


def test_launches_per_step_counts_inside_chains_only():
    assert _read("launches_per_step.diffuse", _chains([True, True])) == \
        pytest.approx(2 / (2 * STEPS))
    assert _read("launches_per_step.diffuse", _chains([True, False])) == \
        pytest.approx(301 / (2 * STEPS))


def test_graph_step_share():
    assert _read("graph_step_share.diffuse", _chains([True, True])) == 1.0
    assert _read("graph_step_share.diffuse", _chains([True, False])) == 0.5
    assert _read("graph_step_share.diffuse", _chains([False])) == 0.0


@pytest.mark.parametrize("metric", ["launches_per_step.diffuse",
                                    "graph_step_share.diffuse"])
def test_no_chain_reads_none(metric):
    host = [(LAUNCH, 1.0, 1.01), ("ha2g.synth.window", 0.0, 5.0)]
    assert _read(metric, host) is None


def test_call_flops_equal_a_direct_count():
    """At the tiny settings: the driver's product against FlopCounterMode
    over the reference synthesizing the whole batch of clips."""
    cell = harness.load_cell(CELL)
    cfg, tr = tiny(cell)
    drv = harness.driver(cell)
    model = DiffGesture(cfg).eval()
    model.load_state_dict(harness.make_weights(drv.reference_model(cfg, None),
                                               1, torch.device("cpu")))
    B = tr["clips"]
    audio = 0.1 * torch.randn(B, int(tr["clip_seconds"] * 16000))
    with harness.flop_counter() as fc:
        synthesize(model, audio, torch.Generator().manual_seed(0),
                   torch.arange(B), B)
    assert drv.call_flops(cfg, tr) == fc.get_total_flops()


def test_cell_entries():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", ())]
    assert names == ["idle_share.diffuse", "mfu.diffuse", "attn_roofline.diffuse",
                     "launches_per_step.diffuse", "graph_step_share.diffuse"]
    cell = harness.load_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    assert set(cell.limits) == {"worst_clip_rel_err", "worst_window_rel_err",
                                "bad_units"}
