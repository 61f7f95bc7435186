"""The benchmark's yardstick: cells found by name in BENCHMARK.json, the
environment of a run, weights made from the seed, the chip's peaks, and
the result line.

A cell names a configuration (``benchmark/configs/<name>.json``, the
program's config fields flat, plus ``n_words``, ``n_speakers`` and what was
``assumed``) and a traffic mix (``benchmark/traffic/<name>.json``, whose
``driver`` names ``benchmark/drivers/<driver>.py``, whose CPU tests run
at the tiny sizes of ``benchmark/tests/tiny/<driver>.json``).  Its
correctness limits are ``benchmark/limits/<cell>.json``, and each
per-layer metric is read by ``benchmark/metrics/<metric>.py``.  Adding
any of these is adding files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ha2g_tpu")

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, TF32 tensor cores,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989.4e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_HBM_BYTES = 3.35e12


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict          # number -> {"limit": x, ...}


def _cell_has(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _cell_has(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _cell_has(m, name, names)]
    limits = json.loads((root / "benchmark" / "limits"
                         / f"{name}.json").read_text())
    return Cell(name, w, config, traffic, e2e, per_layer, limits)


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_file(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_file(BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py",
                     f"bench_driver_{cell.traffic['driver']}")


def metric_reader(name: str):
    return load_file(BENCH_DIR / "metrics" / f"{name}.py",
                     "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one purpose of a run."""
    import numpy as np
    return int(np.random.SeedSequence([seed % 2 ** 63, *salt])
               .generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


# ---------------------------------------------------------------------------
# weights: torch-default initialisation, drawn on the device in two calls
# ---------------------------------------------------------------------------

def make_weights(model, seed: int, device) -> dict:
    """A state dict for ``model`` (the reference's module tree, whose names
    the program shares): Linear / Conv weights and biases U(+-1/sqrt(fan
    in)); the SE-ResNet's convolutions N(0, 2/fan_out); GRU tensors
    U(+-1/sqrt(H)); embeddings N(0, 1); the TCN decoder N(0, 0.01^2) with
    a zero bias; weight norm's g = ||v||; batch norm (1d or 2d) 1, 0 and
    running statistics 0, 1; layer norm 1, 0; any other parameter
    registered on a module itself (a learned embedding, a null condition)
    N(0, 1).  One uniform and one normal draw on the device.  A persistent
    buffer other than batch norm's has no rule and is refused."""
    import torch
    import torch.nn as nn
    from reference.model import BiGRU, ResNetSE, SEBasicBlock, \
        TextEncoderTCN, WeightNormConv1d

    he = set()
    for m in model.modules():
        if isinstance(m, ResNetSE):
            he.add(id(m.conv1))
        if isinstance(m, SEBasicBlock):
            he.update((id(m.conv1), id(m.conv2)))
            if m.downsample is not None:
                he.add(id(m.downsample[0]))
    decoders = {id(m.decoder) for m in model.modules()
                if isinstance(m, TextEncoderTCN)}
    uniform, normal, fixed, norms = [], [], {}, []
    for prefix, m in model.named_modules():
        key = (prefix + ".") if prefix else ""
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            if id(m) in he:
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                normal.append((key + "weight", m.weight.shape,
                               math.sqrt(2.0 / fan_out)))
            elif id(m) in decoders:
                normal.append((key + "weight", m.weight.shape, 0.01))
            else:
                uniform.append((key + "weight", m.weight.shape,
                                1 / math.sqrt(fan_in)))
            if m.bias is not None:
                if id(m) in decoders:
                    fixed[key + "bias"] = torch.zeros(m.bias.shape)
                else:
                    uniform.append((key + "bias", m.bias.shape,
                                    1 / math.sqrt(fan_in)))
        elif isinstance(m, nn.Embedding):
            normal.append((key + "weight", m.weight.shape, 1.0))
        elif isinstance(m, WeightNormConv1d):
            fan_in = m.weight_v[0].numel()
            uniform.append((key + "weight_v", m.weight_v.shape,
                            1 / math.sqrt(fan_in)))
            uniform.append((key + "bias", m.bias.shape, 1 / math.sqrt(fan_in)))
            norms.append(key)
        elif isinstance(m, BiGRU):
            for n, p in m.named_parameters(recurse=False):
                uniform.append((key + n, p.shape, 1 / math.sqrt(m.hidden)))
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            fixed[key + "weight"] = torch.ones(m.num_features)
            fixed[key + "bias"] = torch.zeros(m.num_features)
            fixed[key + "running_mean"] = torch.zeros(m.num_features)
            fixed[key + "running_var"] = torch.ones(m.num_features)
            fixed[key + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        elif isinstance(m, nn.LayerNorm):
            for n, p in m.named_parameters(recurse=False):
                fixed[key + n] = (torch.ones if n == "weight" else torch.zeros)(p.shape)
        else:
            for n, p in m.named_parameters(recurse=False):
                normal.append((key + n, p.shape, 1.0))
    gen = torch.Generator(device).manual_seed(seed)
    out = {}
    for plan, draw in ((uniform, lambda n: torch.rand(
            n, generator=gen, device=device) * 2 - 1),
                       (normal, lambda n: torch.randn(
            n, generator=gen, device=device))):
        flat = draw(sum(math.prod(s) for _, s, _ in plan))
        at = 0
        for name, shape, scale in plan:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape) * scale
            at += n
    for key in norms:
        v = out[key + "weight_v"]
        out[key + "weight_g"] = v.flatten(1).norm(dim=1).view(-1, 1, 1)
    out.update({k: v.to(device) for k, v in fixed.items()})
    want = set(model.state_dict())
    if set(out) != want:
        raise RuntimeError(f"weights miss {sorted(want - set(out))[:5]} and "
                           f"add {sorted(set(out) - want)[:5]}")
    return out


# ---------------------------------------------------------------------------
# the device and the result
# ---------------------------------------------------------------------------

def device_info(device, count: int = 1) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# ---------------------------------------------------------------------------
# what both sides are handed
# ---------------------------------------------------------------------------

def word(i: int) -> str:
    return f"w{i}"


def index_of(w: str) -> int:
    """The vocabulary index of a generated word: the four special tokens
    (PAD, SOS, EOS, UNK) come first."""
    return 4 + int(w[1:])


def vocabularies(config: dict):
    """The program's word and speaker vocabularies for the cell's sizes,
    with ``index_of``'s mapping."""
    from ha2g_torch.data.vocab import Vocab
    lang = Vocab("words")
    for i in range(config["n_words"] - lang.n_words):
        lang.index_word(word(i))
    speaker = Vocab("vid", insert_default_tokens=False)
    for i in range(config["n_speakers"] - speaker.n_words):
        speaker.index_word(f"s{i}")
    if (lang.n_words, speaker.n_words) != (config["n_words"], config["n_speakers"]):
        raise RuntimeError("vocabulary sizes differ from the configuration")
    return lang, speaker


def reference_model(config: dict, device, weights=None):
    """The reference Hierarchy for the configuration: on the meta device
    without ``weights`` (shapes only), else on ``device`` holding them."""
    import torch
    from reference.model import Hierarchy
    from reference.skeletons import SKELETONS
    sk = SKELETONS[config["dataset"]]
    if weights is None:
        with torch.device("meta"):
            return Hierarchy(config, sk, config["n_words"], config["n_speakers"])
    model = Hierarchy(config, sk, config["n_words"], config["n_speakers"])
    model.load_state_dict(weights, strict=True)
    return model.to(device)


def program_config(config: dict, **extra):
    from ha2g_torch.config import Config
    return Config.from_dict({**config, **extra})


def host_snapshot() -> dict:
    """The clock and this process's CPU time, for ``host_look``."""
    import resource
    import time
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime}


def host_look(a: dict, b: dict, unit_s=()) -> str:
    """One line on the window between two snapshots: this process's CPU
    seconds over the window's, and the window's units (calls or epochs) in
    time: their spread, and the second half's pace over the first's."""
    import numpy as np
    wall = b["t"] - a["t"]
    parts = [f"window {wall:.3f} s",
             f"process cpu {(b['cpu'] - a['cpu']) / wall:.3f} of the window"]
    if len(unit_s) >= 4:
        u = np.asarray(unit_s)
        h = len(u) // 2
        parts.append(f"units {len(u)}: p10 / p50 / p90 {np.percentile(u, 10):.4f} / "
                     f"{np.percentile(u, 50):.4f} / {np.percentile(u, 90):.4f} s, "
                     f"second half over first {u[h:].mean() / u[:h].mean():.4f}")
    return "host: " + ", ".join(parts)


def release(device) -> None:
    import gc
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class _GlobalOnly:
    """A module tracker that files every count under "Global" alone: the
    per-module one's hooks fail in a train step."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


class Phases:
    """Seconds of each phase of a set-up, printed on standard error."""

    def __init__(self, what: str):
        import time
        self.what, self.clock = what, time.perf_counter
        self.t, self.parts = self.clock(), []

    def __call__(self, name: str) -> None:
        now = self.clock()
        self.parts.append(f"{name} {now - self.t:.2f}")
        self.t = now

    def done(self) -> None:
        print(f"{self.what}: " + ", ".join(self.parts) + " (s)", file=sys.stderr)


def flop_counter():
    """FlopCounterMode counting the total only."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    mode.mod_tracker = _GlobalOnly()
    return mode


def rel_gap(a: float, b: float, floor: float) -> float:
    """|a - b| over max(|b|, floor)."""
    return abs(a - b) / max(abs(b), floor)
