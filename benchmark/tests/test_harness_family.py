"""Adding a model family is adding files and entries.  In a copy of the
benchmark a dummy family brings its own driver, plain reference, tiny CPU
settings, configuration, traffic, limits and per-layer metric, and its
cell runs through the cells, control, card and imports tests with no file
of the copy edited but BENCHMARK.json.  Beside it: ``make_weights`` draws
the two configurations' weights as it did before it learned the module
types a transformer reference uses, and fills such a tree; the tiny
settings come from ``tiny/<driver>.json``."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch
import torch.nn as nn

import harness
from conftest import BENCH, tiny

CELL = "dummy-family-batch"

REFERENCE = '''"""The dummy family's plain reference: float32, the control's rounding
where the program casts to its compute dtype."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import FLOAT32, Precision


class Net(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        c, d = config["channels"], config["width"]
        self.inp = nn.Conv1d(c, d, 3, padding=1)
        self.bn = nn.BatchNorm1d(d)
        self.null = nn.Parameter(torch.empty(d))
        self.norm = nn.LayerNorm(d)
        self.out = nn.Linear(d, c)

    def forward(self, x, p: Precision = FLOAT32):
        h = F.conv1d(p.q(x), p.q(self.inp.weight), p.q(self.inp.bias), padding=1)
        h = self.norm(p.q(self.bn(h)).transpose(1, 2) + self.null)
        return F.linear(p.q(torch.relu(h)), p.q(self.out.weight),
                        p.q(self.out.bias)).transpose(1, 2)
'''

DRIVER = '''"""The dummy family: a closed loop of calls, each one forward of a conv,
batch-norm, layer-norm and linear tree over a batch from a ring, in the
configuration's compute dtype.  Check: the window's first
``check_calls`` answers against the float32 reference, the worst relative
error; the control gives it with the reference in float8 in the
program's place."""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

import harness
from reference.dummy_family import Net
from reference.precision import FLOAT32, Precision, exact_float32


class State:
    pass


def _reference(cfg, dev, weights=None):
    if weights is None:
        with torch.device("meta"):
            return Net(cfg)
    net = Net(cfg)
    net.load_state_dict(weights, strict=True)
    return net.to(dev).eval()


def _program(w, x):
    h = F.conv1d(x.to(w["inp.weight"].dtype), w["inp.weight"], w["inp.bias"],
                 padding=1)
    h = F.batch_norm(h, w["bn.running_mean"], w["bn.running_var"],
                     w["bn.weight"], w["bn.bias"], False, 0.0, 1e-5)
    h = F.layer_norm(h.transpose(1, 2) + w["null"], w["null"].shape,
                     w["norm.weight"], w["norm.bias"])
    return F.linear(torch.relu(h), w["out.weight"], w["out.bias"]).transpose(1, 2)


def setup(run) -> State:
    cfg, tr, dev = run.config, run.traffic, run.device
    st = State()
    st.run = run
    weights = harness.make_weights(_reference(cfg, dev),
                                   harness.sub_seed(run.seed, 1), dev)
    st.weights = {k: v.cpu() for k, v in weights.items()}
    dtype = getattr(torch, cfg["compute_dtype"])
    st.w = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in weights.items()}
    gen = torch.Generator(dev).manual_seed(harness.sub_seed(run.seed, 2))
    st.inputs = [torch.randn((tr["batch"], cfg["channels"], cfg["frames"]),
                             generator=gen, device=dev) for _ in range(tr["ring"])]
    st.kept, st.bad, st.calls = [], 0, 0
    for k in range(tr["warmup_calls"]):
        _call(st, -1 - k)
    return st


def _call(st, k: int) -> None:
    x = st.inputs[k % len(st.inputs)]
    with torch.no_grad():
        out = _program(st.w, x).float().cpu()
    ok = out.shape == x.shape and bool(torch.isfinite(out).all())
    st.bad += not ok
    if 0 <= k < st.run.traffic["check_calls"]:
        st.kept.append(out if ok else None)


def window(st, seconds: float) -> dict:
    t0 = t = time.perf_counter()
    unit_s = []
    while True:
        _call(st, st.calls)
        st.calls += 1
        now = time.perf_counter()
        unit_s.append(now - t)
        t = now
        if t - t0 >= seconds:
            break
    st.rate = st.calls / (t - t0)
    frames = st.run.traffic["batch"] * st.run.config["frames"]
    return {"frames_per_s": st.rate * frames, "attempted": st.calls,
            "failed": st.bad, "unit_s": unit_s}


def traced(st) -> int:
    n = st.run.traffic["trace_calls"]
    for i in range(n):
        _call(st, -10 ** 6 - i)
    return n


def release(st) -> None:
    del st.w
    harness.release(st.run.device)


def work(st) -> dict:
    return {}


def _worst(st, answer) -> float:
    net = _reference(st.run.config, st.run.device, st.weights)
    worst = 0.0
    for k, kept in enumerate(st.kept):
        x = st.inputs[k % len(st.inputs)]
        with torch.no_grad(), exact_float32():
            want = net(x).cpu()
            got = answer(net, x, kept)
        if got is not None:
            worst = max(worst, float((got - want).norm() / want.norm()))
    return worst


def check(st, count_flops: bool = False) -> dict:
    flops = None
    if count_flops:
        net = _reference(st.run.config, st.run.device, st.weights)
        with harness.flop_counter() as fc, torch.no_grad():
            net(st.inputs[0])
        flops = fc.get_total_flops()
    worst = _worst(st, lambda net, x, kept: kept)
    return {"numbers": {"worst_rel_err": worst, "bad_units": float(st.bad)},
            "flops_per_unit": flops}


def control(st, p: Precision) -> dict:
    return {"worst_rel_err": _worst(st, lambda net, x, kept: net(x, p).cpu())}
'''

METRIC = '''def read(ctx):
    """Calls a second in the window."""
    return ctx.rate
'''

ADDED = {
    "benchmark/reference/dummy_family.py": REFERENCE,
    "benchmark/drivers/dummy_family.py": DRIVER,
    "benchmark/metrics/dummy_rate.dummy.py": METRIC,
    "benchmark/tests/tiny/dummy_family.json": json.dumps(
        {"config": {"width": 8, "compute_dtype": "float32"},
         "traffic": {"batch": 3, "ring": 2, "warmup_calls": 1}}),
    "benchmark/configs/dummy-family.json": json.dumps(
        {"channels": 16, "width": 512, "frames": 34, "compute_dtype": "bfloat16"}),
    "benchmark/traffic/dummy_batch.json": json.dumps(
        {"driver": "dummy_family", "batch": 64, "ring": 4, "warmup_calls": 2,
         "check_calls": 2, "trace_calls": 2}),
    "benchmark/limits/dummy-family-batch.json": json.dumps(
        {"worst_rel_err": {"limit": 0.01}, "bad_units": {"limit": 0.0}}),
}


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_family_needs_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    for rel, text in ADDED.items():
        assert rel not in before
        (root / rel).write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-family", "source": "https://example.org",
                             "file": "benchmark/configs/dummy-family.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "dummy-family",
                               "traffic": "dummy_batch", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "dummy_rate.dummy", "unit": "calls/s",
                               "better": "higher", "source": "program_counter",
                               "layer": "synthesis loop", "moves": "frames_per_s",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "test_harness_cells.py", "test_harness_control.py",
         "test_harness_card.py", "test_harness_imports.py",
         "-k", "dummy or imports"],
        capture_output=True, text=True, timeout=900,
        cwd=root / "benchmark" / "tests")
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    for line in (f"test_cell_runs_on_cpu[{CELL}] PASSED",
                 f"test_control_is_not_correct[{CELL}] PASSED",
                 f"test_cell_on_the_card[{CELL}] SKIPPED",
                 "test_no_jax_anywhere PASSED",
                 "test_reference_imports_nothing_of_the_program PASSED"):
        assert line in out.stdout, out.stdout[-4000:]

    after = _digests(root)
    changed = sorted(k for k, v in before.items() if after.get(k) != v)
    assert changed == ["BENCHMARK.json"]


# ---------------------------------------------------------------------------
# make_weights
# ---------------------------------------------------------------------------

SEED = 20260418
# sha256 of make_weights' state dict (keys sorted, each key's name and its
# tensor's bytes) for each configuration's full-size reference tree on the
# CPU, recorded from the make_weights that knew neither layer norm, nor
# BatchNorm1d, nor bare parameters
DIGESTS = {
    "ha2g-expressive": "b130612f628f3409c8e56e7c27d9d17642a8592de5d96e79e24019b137b5861e",
    "ha2g-gesture": "15692f582ab066194945b4a76d49c3272b278ba3ed725ecce5f18fc3cc5888fc",
}


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_configurations_weights_are_unchanged(name):
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[name]
    config = json.loads((BENCH.parent / conf["file"]).read_text())
    cpu = torch.device("cpu")
    weights = harness.make_weights(harness.reference_model(config, cpu), SEED, cpu)
    assert _digest(weights) == DIGESTS[name]


class _Block(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.cond = nn.Parameter(torch.empty(3, d))
        self.norm = nn.LayerNorm(d)
        self.plain = nn.LayerNorm(d, bias=False)
        self.proj = nn.Linear(d, d)


class _Tree(nn.Module):
    def __init__(self, d=8):
        super().__init__()
        self.conv = nn.Conv1d(4, d, 3)
        self.bn = nn.BatchNorm1d(d)
        self.blocks = nn.ModuleList([_Block(d), _Block(d)])
        self.null = nn.Parameter(torch.empty(d))


def test_transformer_style_tree_gets_a_full_state_dict():
    cpu = torch.device("cpu")
    with torch.device("meta"):
        shapes = _Tree()
    w = harness.make_weights(shapes, 7, cpu)
    tree = _Tree()
    tree.load_state_dict(w, strict=True)
    assert set(w) == set(tree.state_dict())
    assert torch.equal(w["bn.running_var"], torch.ones(8))
    assert w["bn.num_batches_tracked"].dtype == torch.long
    for b in ("blocks.0", "blocks.1"):
        assert torch.equal(w[f"{b}.norm.weight"], torch.ones(8))
        assert torch.equal(w[f"{b}.norm.bias"], torch.zeros(8))
        assert torch.equal(w[f"{b}.plain.weight"], torch.ones(8))
    # bare parameters N(0, 1), each its own draw
    bare = torch.cat([w["null"], w["blocks.0.cond"].flatten(),
                      w["blocks.1.cond"].flatten()])
    assert 0.5 < bare.std() < 1.5
    assert not torch.equal(w["blocks.0.cond"], w["blocks.1.cond"])
    assert w["blocks.0.proj.weight"].abs().max() <= 1 / 8 ** 0.5
    assert all(torch.equal(v, harness.make_weights(shapes, 7, cpu)[k])
               for k, v in w.items())


# ---------------------------------------------------------------------------
# tiny CPU settings
# ---------------------------------------------------------------------------

# the values each driver ran its CPU tests at before they became data
TINY_CONFIG = {"hidden_size": 16, "wordembed_dim": 16, "n_layers": 2,
               "n_words": 40, "n_speakers": 5, "batch_size": 4,
               "compute_dtype": "float32"}
TINY_TRAFFIC = {"batch_synth": {"clips": 3, "clip_seconds": 4.5, "ring": 2,
                                "warmup_calls": 1, "check_rows": 2,
                                "check_calls": 2, "trace_calls": 1},
                "train_gan": {"steps_per_epoch": 3}}


@pytest.mark.parametrize("name", ["expressive-batch256", "gesture-train-b256"])
def test_tiny_settings_of_the_drivers(name):
    cell = harness.load_cell(name)
    config, traffic = tiny(cell)
    assert config == {**cell.config, **TINY_CONFIG}
    assert traffic == {**cell.traffic, **TINY_TRAFFIC[cell.traffic["driver"]]}


def test_missing_tiny_settings_name_the_file():
    cell = harness.load_cell("expressive-batch256")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "driver": "no_such"})
    with pytest.raises(FileNotFoundError,
                       match=r"add benchmark/tests/tiny/no_such\.json"):
        tiny(cell)
