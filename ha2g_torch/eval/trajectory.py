"""The golden-trajectory check against the reference's training logs (the
port of ha2g_tpu/eval/trajectory.py).

The reference ships four training logs (training_logs/*.log, written by
scripts/train.py: [VAL] lines at train.py:326-508, EP lines at
train.py:91-324, a "best loss values" tail at train.py:252-258).  This
module

* parses such a log into per-epoch trajectories
  (``parse_reference_log``);
* loads the parsed logs kept under ha2g_torch/baselines/ (a copy of the
  JAX package's, written by ``cli parse-reference-log``;
  ``load_baseline``);
* compares a run's history.jsonl with a reference trajectory, a verdict a
  metric (``compare_trajectories``).

A run is "within noise" when its best value lies inside the reference's
best +/- a band from the spread of the reference's own last 25% of
validation scores, the yardstick a reader takes from the log's tail.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from pathlib import Path

# reference [VAL] metric labels -> this framework's history keys
REF_TO_OURS = {
    "loss": "loss",
    "joint mae": "joint_mae",
    "accel diff": "accel",
    "FGD": "frechet",
    "feat_D": "feat_dist",
    "Diversity": "diversity",
    "BC": "BC",
}
# metrics where larger is better (Trainer._track_best agrees)
HIGHER_IS_BETTER = {"diversity"}

# the 2021 "original" logs end at feat_D; the 2022 "new" logs append
# Diversity and BC — both optional here
_VAL_RE = re.compile(
    r"\[VAL\] loss: ([-\d.]+), joint mae: ([-\d.]+), accel diff: ([-\d.]+), "
    r"FGD: ([-\d.]+), feat_D: ([-\d.]+)"
    r"(?:, Diversity: ([-\d.]+))?(?:, BC: ([-\d.]+))?")
_EP_RE = re.compile(
    r"EP (\d+) \((\d+)\) \|\s*(?:(\d+)m)?\s*([\d.]+)s, (\d+) samples/s \| "
    r"(.*)")
# tail lines look like "<timestamp>: frechet: 2.656 at EPOCH 98"
_BEST_RE = re.compile(r" (\w+): ([-\d.]+) at EPOCH (\d+)")
_KV_RE = re.compile(r"([\w ]+): ([-\d.]+)")


@dataclass
class Trajectory:
    """One training run: per-epoch validation metrics + train-loss tail."""
    name: str
    val: list[dict] = field(default_factory=list)      # keys: ours naming
    train: list[dict] = field(default_factory=list)    # per logged EP line
    best: dict = field(default_factory=dict)           # key -> (value, epoch)
    samples_per_s: float = 0.0

    def to_json(self) -> dict:
        return {"name": self.name, "val": self.val, "train": self.train,
                "best": self.best, "samples_per_s": self.samples_per_s}

    @classmethod
    def from_json(cls, d: dict) -> "Trajectory":
        return cls(name=d["name"], val=d["val"], train=d["train"],
                   best={k: tuple(v) for k, v in d["best"].items()},
                   samples_per_s=d.get("samples_per_s", 0.0))


def parse_reference_log(path: str | Path, name: str | None = None
                        ) -> Trajectory:
    """Parse a reference training log (scripts/train.py's logging format)."""
    text = Path(path).read_text(errors="replace")
    traj = Trajectory(name=name or Path(path).stem)
    epoch = 0
    sps: list[float] = []
    for line in text.splitlines():
        m = _VAL_RE.search(line)
        if m:
            keys = ["loss", "joint_mae", "accel", "frechet", "feat_dist",
                    "diversity", "BC"]
            row = {"epoch": epoch}
            for k, g in zip(keys, m.groups()):
                if g is not None:
                    row[k] = float(g)
            traj.val.append(row)
            epoch += 1
            continue
        m = _EP_RE.search(line)
        if m:
            ep, _it, _mins, _secs, s_per_s, tail = m.groups()
            row = {"epoch": int(ep)}
            for k, v in _KV_RE.findall(tail):
                row[k.strip()] = float(v)
            traj.train.append(row)
            sps.append(float(s_per_s))
    # "best loss values" tail (train.py:252-258)
    tail_at = text.find("best loss values")
    if tail_at >= 0:
        for k, v, ep in _BEST_RE.findall(text[tail_at:]):
            ours = {"bc": "BC", "diversity": "diversity"}.get(
                k, REF_TO_OURS.get(k, k))
            traj.best[ours] = (float(v), int(ep))
    if not traj.best:
        traj.best = best_of(traj.val)
    if sps:
        traj.samples_per_s = sum(sps) / len(sps)
    return traj


def best_of(val_rows: list[dict]) -> dict:
    """Per-key best over a validation trajectory (Trainer._track_best
    semantics: min, except diversity max)."""
    best: dict = {}
    for row in val_rows:
        for k, v in row.items():
            if k == "epoch" or not isinstance(v, (int, float)):
                continue
            if k not in best:
                best[k] = (v, row.get("epoch", 0))
            else:
                hi = k in HIGHER_IS_BETTER
                if (v > best[k][0]) if hi else (v < best[k][0]):
                    best[k] = (v, row.get("epoch", 0))
    return best


def load_history_jsonl(path: str | Path) -> Trajectory:
    """Load this framework's Trainer history (one JSON object per epoch)."""
    traj = Trajectory(name=Path(path).stem)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                traj.val.append(json.loads(line))
    traj.best = best_of(traj.val)
    return traj


def _baseline_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "baselines"


def load_baseline(name: str) -> Trajectory:
    """Load a committed parsed reference trajectory
    (e.g. 'ted_gesture_new')."""
    p = _baseline_dir() / f"{name}.json"
    if not p.exists():
        have = sorted(q.stem for q in _baseline_dir().glob("*.json"))
        raise FileNotFoundError(f"no baseline '{name}'; have: {have}")
    return Trajectory.from_json(json.loads(p.read_text()))


def noise_band(traj: Trajectory, key: str, tail_frac: float = 0.25) -> float:
    """Std-dev of the reference metric over its last `tail_frac` epochs —
    the run-to-run noise yardstick used for the within-noise verdict."""
    vals = [r[key] for r in traj.val if key in r]
    if len(vals) < 4:
        return float("inf")
    tail = vals[-max(2, int(len(vals) * tail_frac)):]
    mean = sum(tail) / len(tail)
    return math.sqrt(sum((v - mean) ** 2 for v in tail) / len(tail))


def compare_trajectories(ref: Trajectory, ours: Trajectory,
                         keys: tuple[str, ...] = ("frechet", "joint_mae",
                                                  "diversity", "feat_dist",
                                                  "loss"),
                         noise_sigmas: float = 2.0) -> dict:
    """Per-metric verdict of our run vs the reference trajectory.

    Returns {key: {ref_best, ref_epoch, our_best, our_epoch, noise,
    verdict}} where verdict is 'BEATS' / 'WITHIN_NOISE' / 'BEHIND' /
    'MISSING'.  The alignment check ('aligned_epochs') additionally
    reports, for the epochs both runs cover, how many of our values fall
    at-or-better than the reference's value for that same epoch — a
    trajectory-shape signal, not just the endpoint.
    """
    report: dict = {"metrics": {}, "ref_name": ref.name, "our_name": ours.name}
    for k in keys:
        entry: dict = {}
        rb = ref.best.get(k)
        ob = ours.best.get(k)
        if rb is None or ob is None:
            entry["verdict"] = "MISSING"
            report["metrics"][k] = entry
            continue
        band = noise_band(ref, k) * noise_sigmas
        hi = k in HIGHER_IS_BETTER
        margin = (ob[0] - rb[0]) if hi else (rb[0] - ob[0])
        entry.update(ref_best=rb[0], ref_epoch=rb[1], our_best=ob[0],
                     our_epoch=ob[1], noise=band)
        if margin >= 0:
            entry["verdict"] = "BEATS"
        elif math.isinf(band):
            # too few reference epochs to estimate run-to-run noise: an
            # infinite band must not silently bless a regression
            entry["verdict"] = "INSUFFICIENT_REF"
        elif -margin <= band:
            entry["verdict"] = "WITHIN_NOISE"
        else:
            entry["verdict"] = "BEHIND"
        # trajectory shape over shared epochs
        ref_by_ep = {r["epoch"]: r.get(k) for r in ref.val}
        n_shared = n_better = 0
        for row in ours.val:
            rv = ref_by_ep.get(row.get("epoch"))
            if rv is None or k not in row:
                continue
            n_shared += 1
            better = row[k] >= rv - band if hi else row[k] <= rv + band
            n_better += bool(better)
        entry["aligned_epochs"] = {"shared": n_shared, "at_or_better":
                                   n_better}
        report["metrics"][k] = entry
    return report


def format_report(report: dict) -> str:
    lines = [f"trajectory: {report['our_name']} vs reference "
             f"{report['ref_name']}",
             f"{'metric':<12}{'ref best':>12}{'ours best':>12}"
             f"{'noise(2s)':>12}  verdict"]
    for k, e in report["metrics"].items():
        if e["verdict"] == "MISSING":
            lines.append(f"{k:<12}{'-':>12}{'-':>12}{'-':>12}  MISSING")
            continue
        al = e.get("aligned_epochs", {})
        extra = (f"  [{al['at_or_better']}/{al['shared']} shared epochs "
                 f"at-or-better]" if al.get("shared") else "")
        lines.append(f"{k:<12}{e['ref_best']:>12.4f}{e['our_best']:>12.4f}"
                     f"{e['noise']:>12.4f}  {e['verdict']}{extra}")
    return "\n".join(lines)
