"""Rank processes of tests/test_torch_parallel.py (and of the
data-parallel check in tests/test_torch_train_gesture_gan.py), and the
set-ups they share with the parent's single-process references.

Run as ``python -m tests.torch_parallel_child SCENARIO OUT_DIR PORT RANK
WORLD``: each rank joins a gloo group at ``tcp://127.0.0.1:PORT``, runs
every check of its scenario and writes what the parent compares to
``OUT_DIR/SCENARIO_rank{RANK}.pt``.  Imports torch, numpy and the port
only (no JAX), so a rank starts in a few seconds.
"""

from __future__ import annotations

import copy
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from ha2g_torch.checkpoint import load_state, save_checkpoint  # noqa: E402
from ha2g_torch.config import Config  # noqa: E402
from ha2g_torch.models.common import BatchNorm  # noqa: E402
from ha2g_torch.parallel.mesh import Mesh, permute_rows  # noqa: E402
from ha2g_torch.train import losses  # noqa: E402
from ha2g_torch.train.baselines import clip_grad_norm_optax_  # noqa: E402
from ha2g_torch.train.hierarchy import HierarchySystem  # noqa: E402
from ha2g_torch.train.loop import build_system  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the hierarchy of tests/test_parallel.py::_hier_system (TED Gesture, pose
# 27, hidden 16, 2 GRU layers, speaker z, dropout on (0.3), SGD) at a
# global batch of 8 (the SE-ResNet's backward sets a step's CPU time)
HB, HT, HSPEC_T, HN_WORDS, HN_SPK = 8, 34, 70, 20, 5
# the baselines: the shipped configs at hidden 16, 2 GRU layers, batch 8
FAMILIES = ("multimodal_context", "speech2gesture", "seq2seq",
            "joint_embedding", "gesture_autoencoder", "motion_ae")
BB, B_WORDS, B_SPK, AUDIO_LEN, WORD_SEQ = 8, 16, 4, 36267, 32
CONFIGS = {"multimodal_context": "configs/multimodal_context.yaml",
           "speech2gesture": "configs/speech2gesture.yaml",
           "seq2seq": "configs/seq2seq.yaml",
           "joint_embedding": "configs/joint_embed.yaml",
           "gesture_autoencoder": "configs/gesture_autoencoder.yaml",
           "motion_ae": "configs_expressive/gesture_autoencoder.yaml"}
# the unit checks' global batch
UNIT_ROWS = 8


def hierarchy_config(**kw) -> Config:
    return Config(model="hierarchy", dataset="ted_gesture", pose_dim=27,
                  n_poses=HT, n_pre_poses=4, hidden_size=16, n_layers=2,
                  z_type="speaker", loss_warmup=10, loss_gan_weight=5.0,
                  loss_regression_weight=70.0, loss_kld_weight=0.1,
                  loss_reg_weight=0.05, loss_contrastive_pos_weight=0.2,
                  loss_contrastive_neg_weight=0.005,
                  loss_physical_weight=0.01, mean_dir_vec=[0.0] * 27,
                  compute_dtype="float32", **kw)


def _sgd(system, g_lr=0.05, d_lr=0.01):
    """SGD: a step's parameter delta is -lr times its gradient, so the new
    parameters compare every gradient (JAX's test does the same)."""
    g = [p for m in (system.audio, system.text, system.gens)
         for p in m.parameters()] if hasattr(system, "audio") else \
        list(system.gen.parameters()) if hasattr(system, "gen") else \
        list(system.parameters())
    if hasattr(system, "dis"):
        system.g_opt = torch.optim.SGD(g, lr=g_lr)
        system.d_opt = torch.optim.SGD(system.dis.parameters(), lr=d_lr)
    else:
        system.opt = torch.optim.SGD(g, lr=g_lr)
    return system


@functools.cache
def _hierarchy_prototype(sgd: bool) -> HierarchySystem:
    system = HierarchySystem(hierarchy_config(), HN_WORDS, HN_SPK,
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return _sgd(system) if sgd else system


def hierarchy_system(sgd: bool = True) -> HierarchySystem:
    """A fresh copy of the seed-0 system (and its optimisers): a copy
    costs a fraction of a build."""
    return copy.deepcopy(_hierarchy_prototype(sgd))


def hierarchy_batch() -> dict:
    rng = np.random.default_rng(7)
    return {"text": rng.integers(0, HN_WORDS, (HB, HT)),
            "spec": rng.normal(size=(HB, 128, HSPEC_T)).astype(np.float32),
            "target": (rng.normal(size=(HB, HT, 27)) * 0.1)
            .astype(np.float32),
            "vids": rng.integers(0, HN_SPK, (HB,))}


def step_generator() -> torch.Generator:
    return torch.Generator().manual_seed(3)


def baseline_config(family: str) -> Config:
    kw = dict(hidden_size=16, n_layers=2, wordembed_dim=16, batch_size=BB,
              compute_dtype="float32", eval_net_path="")
    if family == "seq2seq":
        kw["n_poses"] = 10
    return Config.from_yaml(ROOT / CONFIGS[family], **kw)


def baseline_system(family: str):
    return _sgd(build_system(baseline_config(family), B_WORDS, B_SPK,
                             device="cpu",
                             generator=torch.Generator().manual_seed(0)))


# the FSDP state checks' system: a GAN (both Adam optimisers)
FSDP_FAMILY = "multimodal_context"


def adam_system():
    """FSDP_FAMILY's system with its own Adam optimisers."""
    return build_system(baseline_config(FSDP_FAMILY), B_WORDS, B_SPK,
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))


def baseline_batch(family: str) -> dict:
    cfg = baseline_config(family)
    rng = np.random.default_rng(11)
    lengths = rng.integers(2, WORD_SEQ + 1, BB)
    seq = np.zeros((BB, WORD_SEQ), np.int64)
    for b, n in enumerate(lengths):
        seq[b, :n] = rng.integers(4, B_WORDS, n)
        seq[b, 0], seq[b, n - 1] = 1, 2
    T = cfg.n_poses
    return {"word_seq": seq, "word_lengths": lengths,
            "text": rng.integers(0, B_WORDS, (BB, T)),
            "audio": (rng.normal(size=(BB, AUDIO_LEN)) * 0.1)
            .astype(np.float32),
            "spec": rng.normal(size=(BB, 128, HSPEC_T)).astype(np.float32),
            "target": (rng.normal(size=(BB, T, cfg.pose_dim)) * 0.2)
            .astype(np.float32),
            "vids": rng.integers(0, B_SPK, (BB,))}


def baseline_step(system, batch, generator):
    cfg = system.cfg
    if cfg.model == "multimodal_context":
        return system.train_step(batch, True, generator)
    return system.train_step(batch, generator)


def unit_inputs() -> dict:
    """The global inputs of the unit checks (batch norm, contrastive,
    permutation)."""
    g = torch.Generator().manual_seed(5)
    return {"x": torch.randn((UNIT_ROWS, 4, 5), generator=g) * 2 + 1,
            "w": torch.randn((UNIT_ROWS, 4, 5), generator=g),
            "fa": torch.randn((UNIT_ROWS * 3, 6), generator=g),
            "fb": torch.randn((UNIT_ROWS * 3, 6), generator=g),
            "vids": torch.randint(0, 50, (UNIT_ROWS,), generator=g)}


def unit_modules():
    torch.manual_seed(0)
    norm = BatchNorm(4)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    heads = torch.nn.ModuleList([torch.nn.Linear(6, 5), torch.nn.Linear(6, 5)])
    return norm, heads


def unit_losses(norm, heads, x, w, fa, fb):
    """Batch norm's weighted output sum and the contrastive loss of two
    linear heads (the terms whose global-batch semantics the unit checks
    hold)."""
    out = norm(x)
    return out, (out * w).sum(), losses.softmax_contrastive(heads[0](fa),
                                                            heads[1](fb))


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def subprocess_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    return env


class Ranks:
    """The rank processes of one scenario of torch_parallel_child."""

    def __init__(self, scenario: str, out: Path, world: int = 2):
        self.scenario, self.out, self.world = scenario, out, world
        port = _free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_child", scenario,
             str(out), str(port), str(r), str(world)],
            cwd=ROOT, env=subprocess_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self._results = None

    def results(self, timeout: float = 240.0) -> list:
        if self._results is None:
            logs = [p.communicate(timeout=timeout)[0] for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, \
                    f"{self.scenario} rank failed:\n{log[-4000:]}"
            self._results = [torch.load(
                self.out / f"{self.scenario}_rank{r}.pt", weights_only=False)
                for r in range(self.world)]
        return self._results


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------

def rows_of(batch: dict, rank: int, world: int = 2) -> dict:
    """Rank ``rank``'s contiguous rows of every field of a global batch."""
    return {k: np.array_split(np.asarray(v), world)[rank]
            for k, v in batch.items()}


def _mean_metrics(mesh, metrics) -> dict:
    return {k: float(mesh.mean_over_ranks(v.reshape(1))[0])
            for k, v in metrics.items()}


def _full_state(mesh, system) -> dict:
    with mesh.full_state(system, state=False):
        return {k: v.detach().clone() for k, v in system.state_dict().items()}


def _g_params(system):
    opt = system.g_opt if hasattr(system, "g_opt") else system.opt
    return [p for group in opt.param_groups for p in group["params"]]


def _mesh(layout: str) -> Mesh:
    return Mesh(2, 1) if layout == "dp" else Mesh(1, 2)


def run_hierarchy(rank: int, out: Path) -> dict:
    res = {}
    batch = rows_of(hierarchy_batch(), rank)
    for layout in ("dp", "fsdp"):
        for gan_on in (True, False):
            mesh = _mesh(layout)
            system = hierarchy_system()
            mesh.place(system)
            metrics = system.train_step(batch, gan_on, step_generator())
            norm = clip_grad_norm_optax_(_g_params(system), 1e30, mesh)
            res[(layout, gan_on)] = {
                "metrics": _mean_metrics(mesh, metrics),
                "state": _full_state(mesh, system), "g_norm": float(norm)}

    # unit checks on the DP mesh
    mesh = _mesh("dp")
    u = unit_inputs()
    norm, heads = unit_modules()
    x = u["x"].chunk(2)[rank].clone().requires_grad_(True)
    fa = u["fa"].chunk(2)[rank]
    fb = u["fb"].chunk(2)[rank]
    with mesh.part():
        out, bn_loss, c_loss = unit_losses(norm, heads, x,
                                           u["w"].chunk(2)[rank], fa, fb)
        (bn_loss + c_loss).backward()
        perm = permute_rows(u["vids"].chunk(2)[rank], step_generator())
        opt = torch.optim.SGD([*norm.parameters(), *heads.parameters()],
                              lr=0.0)
        mesh.reduce_grads(opt)
    # a gradient average outside the part (a forward that took local
    # statistics) is refused
    try:
        mesh.reduce_grads(opt)
        outside_refused = False
    except RuntimeError:
        outside_refused = True
    res["unit"] = {"out": out.detach(), "x_grad": x.grad,
                   "c_loss": float(c_loss),
                   "grads": [p.grad.clone() for p in opt.param_groups[0]
                             ["params"]],
                   "running": (norm.running_mean.clone(),
                               norm.running_var.clone()),
                   "perm": perm, "outside_refused": outside_refused}
    # gloo's stand-in for reduce-scatter and the list gather, as they are
    # chosen for the backend
    flat = torch.arange(6.0) * (rank + 1)
    from ha2g_torch.parallel.mesh import all_gather_flat, reduce_scatter
    res["collectives"] = {"backend": dist.get_backend(),
                          "reduce_scatter": reduce_scatter(flat, mesh.group),
                          "gather": torch.stack(all_gather_flat(
                              flat[:2], mesh.group))}
    return res


def run_baselines(rank: int, out: Path) -> dict:
    res = {}
    # FSDP with Adam (the GAN of multimodal_context: both optimisers): what
    # a rank holds between steps, a checkpoint, and its load back into a
    # sharded system
    mesh = _mesh("fsdp")
    system = adam_system()
    mesh.place(system)
    baseline_step(system, rows_of(baseline_batch(FSDP_FAMILY), rank),
                  step_generator())
    names = {id(p): k for k, p in system.named_parameters()}
    res["held"] = {
        names[id(p)]: (tuple(p.shape), [tuple(v.shape) for v in
                                        opt.state[p].values() if v.dim()])
        for opt in (system.g_opt, system.d_opt)
        for p in (q for g in opt.param_groups for q in g["params"])}
    res["resident"] = mesh.resident_bytes(system)
    ckpt = out / "fsdp_ckpt"
    with mesh.full_state(system):
        res["whole"] = mesh.resident_bytes(system)
        if rank == 0:
            save_checkpoint(ckpt, system, system.cfg, step=1)
        saved = {k: v.detach().clone()
                 for k, v in system.state_dict().items()}
        saved_m = [v.clone() for opt in (system.g_opt, system.d_opt)
                   for st in opt.state.values() for v in st.values()
                   if v.dim()]
    mesh.barrier()
    other = adam_system()
    mesh2 = _mesh("fsdp")
    mesh2.place(other)
    with mesh2.full_state(other):
        load_state(ckpt, other)
    with mesh2.full_state(other):
        reloaded = other.state_dict()
        moments = [v for opt in (other.g_opt, other.d_opt)
                   for st in opt.state.values() for v in st.values()
                   if v.dim()]
        res["reload_equal"] = all(
            torch.equal(reloaded[k], v) for k, v in saved.items()) and \
            len(moments) == len(saved_m) and all(
                torch.equal(a, b) for a, b in zip(moments, saved_m))
    for family in FAMILIES:
        batch = rows_of(baseline_batch(family), rank)
        for layout in ("dp", "fsdp"):
            mesh = _mesh(layout)
            system = baseline_system(family)
            mesh.place(system)
            metrics = baseline_step(system, batch, step_generator())
            res[(family, layout)] = {"metrics": _mean_metrics(mesh, metrics),
                                     "state": _full_state(mesh, system)}
    return res


def run_jax_dp(rank: int, out: Path) -> dict:
    """The DP step of tests/torch_train_parity.py's port system (its
    weights, batch and speaker permutation written by the parent)."""
    spec = torch.load(out / "jax_dp_input.pt", weights_only=False)
    system = HierarchySystem(Config(**spec["config"]), spec["n_words"],
                             spec["n_speakers"], device="cpu")
    system.load_state_dict(spec["state"], strict=True)
    system.text.emb_dropout = 0.0
    for g in system.gens:
        g.text_encoder.emb_dropout = 0.0
    system.dis.gru.dropout = 0.0
    mesh = Mesh(2, 1)
    mesh.place(system)
    metrics = system.train_step(rows_of(spec["batch"], rank), spec["gan_on"],
                                torch.Generator().manual_seed(0),
                                rand_vids=spec["rand_vids"])
    return {"metrics": _mean_metrics(mesh, metrics),
            "state": {k: v.clone() for k, v in system.state_dict().items()},
            "grads": {k: None if p.grad is None else p.grad.clone()
                      for k, p in system.named_parameters()}}


SCENARIOS = {"hierarchy": run_hierarchy, "baselines": run_baselines,
             "jax_dp": run_jax_dp}


def main(argv) -> int:
    scenario, out, port, rank, world = argv
    out, rank = Path(out), int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=int(world))
    try:
        res = SCENARIOS[scenario](rank, out)
        torch.save(res, out / f"{scenario}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
