"""Multi-process training and sharded synthesis of the port on the CPU:
two ranks on a gloo group against the single-process run on the same
global batch (the port's counterpart of tests/test_parallel.py).

The ranks run ``tests/torch_parallel_child.py``, spawned once per scenario
group (the hierarchy's steps and the unit checks; the baselines' steps),
all at the start of the module (``spawned``), which computes the
single-process references while they run; the ranks write their results,
and the parent compares.  ``torchrun`` trains through the CLI under FSDP
the same way.  Bounds of the steps: tests/test_parallel.py::_assert_step_equiv
(metrics 5e-4 / 1e-4, batch-norm statistics 1e-4 / 1e-5, every leaf's SGD
delta within 2% by norm with cosine >= 0.999), with dropout and speaker z
on.
"""

from __future__ import annotations

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests import torch_parallel_child as child
from tests.torch_parallel_child import Ranks, subprocess_env

from ha2g_torch import cli
from ha2g_torch.checkpoint import load_state, read_state
from ha2g_torch.config import Config
from ha2g_torch.data.loader import BatchLoader
from ha2g_torch.data.storage import save_clips
from ha2g_torch.data.synthetic import synthetic_clips
from ha2g_torch.parallel import mesh as pm
from ha2g_torch.skeleton import TED_GESTURE
from ha2g_torch.train.baselines import clip_grad_norm_optax_

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "hierarchy.yaml"


def _cli_args(root: Path, out: Path, *extra) -> list[str]:
    return ["train", "--config", str(CONFIG), "--device", "cpu",
            "--hidden_size", "16", "--n_layers", "2", "--batch_size", "8",
            "--compute_dtype", "float32", "--epochs", "1",
            "--loss_warmup", "-1", "--random_seed", "0",
            "--train_data_path", str(root / "train"),
            "--test_data_path", str(root / "val"),
            "--model_save_path", str(out), "--eval_net_path", "", *extra]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank process of the module, started at once."""
    root = tmp_path_factory.mktemp("parallel")
    save_clips(root / "train", synthetic_clips(TED_GESTURE, n_clips=2,
                                               seed=0))
    save_clips(root / "val", synthetic_clips(TED_GESTURE, n_clips=2, seed=1))
    runs = {name: Ranks(name, root) for name in ("hierarchy", "baselines")}
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ha2g_torch.cli",
         *_cli_args(root, root / "fsdp_run", "--fsdp_devices", "2")],
        cwd=ROOT, env=subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    # the single-process references while the ranks run
    for gan_on in (True, False):
        _hierarchy_single(gan_on)
    for family in child.FAMILIES:
        _baseline_single(family)
    assert cli.main(_cli_args(root, root / "single_run")) == 0
    yield root, runs, torchrun
    for p in [torchrun, *(p for r in runs.values() for p in r.procs)]:
        if p.poll() is None:
            p.kill()
            p.communicate()


# ---------------------------------------------------------------------------
# single-process references
# ---------------------------------------------------------------------------

@functools.cache
def _hierarchy_single(gan_on: bool):
    system = child.hierarchy_system()
    old = {k: v.clone() for k, v in system.state_dict().items()}
    metrics = system.train_step(child.hierarchy_batch(), gan_on,
                                child.step_generator())
    norm = clip_grad_norm_optax_(child._g_params(system), 1e30)
    return old, {k: float(v) for k, v in metrics.items()}, \
        {k: v.clone() for k, v in system.state_dict().items()}, float(norm)


@functools.cache
def _baseline_single(family: str):
    system = child.baseline_system(family)
    old = {k: v.clone() for k, v in system.state_dict().items()}
    metrics = child.baseline_step(system, child.baseline_batch(family),
                                  child.step_generator())
    return old, {k: float(v) for k, v in metrics.items()}, \
        {k: v.clone() for k, v in system.state_dict().items()}


def _is_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def assert_step_equiv(old, m1, s1, m2, s2, delta_rtol=0.02):
    """tests/test_parallel.py::_assert_step_equiv on state dicts: every
    metric, every batch-norm statistic, and every parameter's SGD delta by
    norm and direction."""
    assert set(m1) == set(m2), (sorted(m1), sorted(m2))
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=5e-4, atol=1e-4,
                                   err_msg=k)
    assert set(s1) == set(s2)
    n_stats = 0
    for k in s1:
        if _is_stat(k):
            np.testing.assert_allclose(s2[k].numpy(), s1[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            n_stats += 1
        elif not k.endswith("num_batches_tracked"):
            da = (s1[k].double() - old[k].double()).ravel().numpy()
            db = (s2[k].double() - old[k].double()).ravel().numpy()
            diff = np.linalg.norm(da - db)
            if diff <= 3e-5:
                continue
            nb = np.linalg.norm(db)
            assert diff / nb <= delta_rtol, (k, diff, nb)
            cos = float(np.dot(da, db) / (np.linalg.norm(da) * nb + 1e-30))
            assert cos >= 0.999, (k, cos)
    return n_stats


# ---------------------------------------------------------------------------
# the hierarchy's step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dp", "fsdp"])
@pytest.mark.parametrize("gan_on", [True, False])
def test_hierarchy_step_matches_single_process(spawned, gan_on, layout):
    """The full GAN step (D phase, shared audio forward, cascade,
    contrastive, diversity, physical prior) on 2 ranks (DP, and FSDP on a
    1 x 2 mesh) equals the single-process step on the same 8-row global
    batch, with dropout and speaker z on."""
    _, runs, _ = spawned
    old, m1, s1, _ = _hierarchy_single(gan_on)
    rank0 = runs["hierarchy"].results()[0][(layout, gan_on)]
    n_stats = assert_step_equiv(old, m1, s1, rank0["metrics"],
                                rank0["state"])
    assert n_stats > 0
    if gan_on:
        assert "dis" in m1 and "gen" in m1


@pytest.mark.parametrize("layout", ["dp", "fsdp"])
def test_clip_norm_is_the_global_one(spawned, layout):
    """clip_grad_norm_optax_ after the gradient average (DP) and over the
    gradients' shards (FSDP) gives the single process's global norm."""
    _, runs, _ = spawned
    want = _hierarchy_single(True)[3]
    for res in runs["hierarchy"].results():
        np.testing.assert_allclose(res[(layout, True)]["g_norm"], want,
                                   rtol=1e-4)


def test_batch_norm_takes_global_statistics_and_gradient(spawned):
    """Each rank's 4 rows normalise with the 8-row batch's statistics; the
    input gradient of each row, the scale and shift gradients summed over
    the ranks, and the running statistics equal one process's."""
    _, runs, _ = spawned
    u = child.unit_inputs()
    norm, heads = child.unit_modules()
    x = u["x"].clone().requires_grad_(True)
    out, bn_loss, _ = child.unit_losses(norm, heads, x, u["w"], u["fa"],
                                        u["fb"])
    bn_loss.backward()
    res = [r["unit"] for r in runs["hierarchy"].results()]
    torch.testing.assert_close(torch.cat([r["out"] for r in res]),
                               out.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([r["x_grad"] for r in res]),
                               x.grad, rtol=1e-5, atol=1e-6)
    # reduce_grads averaged each rank's gradient of its own loss term: the
    # sum of the terms is the single process's loss
    for got, p in zip(res[0]["grads"][:2], norm.parameters()):
        torch.testing.assert_close(got * 2, p.grad, rtol=1e-5, atol=1e-6)
    for r in res:
        torch.testing.assert_close(r["running"][0], norm.running_mean)
        torch.testing.assert_close(r["running"][1], norm.running_var)


def test_contrastive_gradient_spans_the_global_batch(spawned):
    """The contrastive loss over 2 x 12 rows equals one process's on all
    24, and the heads' gradients after the average equal its gradients: a
    gather that kept only the local rows' graph gives half."""
    _, runs, _ = spawned
    u = child.unit_inputs()
    norm, heads = child.unit_modules()
    _, _, c_loss = child.unit_losses(norm, heads, u["x"], u["w"], u["fa"],
                                     u["fb"])
    c_loss.backward()
    for r in (res["unit"] for res in runs["hierarchy"].results()):
        np.testing.assert_allclose(r["c_loss"], c_loss.item(), rtol=1e-6)
        for got, p in zip(r["grads"][2:], heads.parameters()):
            torch.testing.assert_close(got, p.grad, rtol=1e-5, atol=1e-7)


def test_speaker_permutation_runs_over_the_global_batch(spawned):
    _, runs, _ = spawned
    vids = child.unit_inputs()["vids"]
    want = vids[torch.randperm(len(vids), generator=child.step_generator())]
    got = torch.cat([r["unit"]["perm"] for r in runs["hierarchy"].results()])
    assert torch.equal(got, want)


def test_gradient_average_outside_the_part_is_refused(spawned):
    """Mesh.reduce_grads outside Mesh.part raises: the forward before it
    took this rank's statistics, not the global batch's."""
    _, runs, _ = spawned
    assert all(r["unit"]["outside_refused"]
               for r in runs["hierarchy"].results())


def test_gloo_stands_in_for_reduce_scatter(spawned):
    """gloo has no reduce-scatter on CUDA tensors, so the mesh all-reduces
    and slices there; the list gather stands in for the tensor one."""
    _, runs, _ = spawned
    res = [r["collectives"] for r in runs["hierarchy"].results()]
    total = torch.arange(6.0) * 3
    for rank, r in enumerate(res):
        assert r["backend"] == "gloo"
        torch.testing.assert_close(r["reduce_scatter"],
                                   total[3 * rank:3 * rank + 3])
        torch.testing.assert_close(r["gather"], torch.stack(
            [torch.arange(2.0), torch.arange(2.0) * 2]))


# ---------------------------------------------------------------------------
# FSDP state
# ---------------------------------------------------------------------------

def test_fsdp_rank_holds_half_of_every_large_leaf(spawned):
    """Between steps a rank of the 1 x 2 mesh holds half of every leaf of
    at least 2048 elements with an even dimension, and half of both of its
    Adam moments; the rest stays whole.  Its resident parameter and Adam
    bytes are the whole system's less exactly half of the split leaves'."""
    _, runs, _ = spawned
    system = child.adam_system()
    full = {k: tuple(p.shape) for k, p in system.named_parameters()}
    split = 0
    for res in runs["baselines"].results():
        split = 0
        for name, (shape, moments) in res["held"].items():
            numel, whole = int(np.prod(shape)), int(np.prod(full[name]))
            if pm._fsdp_dim(full[name], 2) is None:
                assert shape == full[name], name
            else:
                assert numel * 2 == whole, (name, shape, full[name])
                split += whole
            assert moments == [shape, shape], (name, moments)
        # fp32 parameter and two moments a split element, half of them away
        assert res["whole"] - res["resident"] == 3 * 4 * split // 2
    assert split >= 0.8 * sum(int(np.prod(s)) for s in full.values())


def test_fsdp_checkpoint_loads_in_one_process_and_resumes(spawned):
    """A checkpoint written under FSDP holds whole tensors and both Adam
    states whole: it loads strictly in one process, resumes a step there,
    and loads back into a sharded system unchanged."""
    root, runs, _ = spawned
    res = runs["baselines"].results()
    assert all(r["reload_equal"] for r in res)
    system = child.adam_system()
    assert load_state(root / "fsdp_ckpt", system) == 1
    state = read_state(root / "fsdp_ckpt")
    for opt in (system.g_opt, system.d_opt):
        assert opt.state
        for p in opt.state:
            assert opt.state[p]["exp_avg"].shape == p.shape
    assert set(state) >= {"model", "g_opt", "d_opt"}
    metrics = child.baseline_step(
        system, child.baseline_batch(child.FSDP_FAMILY),
        child.step_generator())
    assert all(np.isfinite(float(v)) for v in metrics.values())


# ---------------------------------------------------------------------------
# the baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", child.FAMILIES)
def test_baseline_step_matches_single_process(spawned, family):
    """Each baseline family's step on 2 ranks, DP and FSDP, equals its
    single-process step on the same 8-row batch (dropout and speaker z
    where the shipped config has them; the embedders' batch-summed losses
    scaled per rank)."""
    _, runs, _ = spawned
    old, m1, s1 = _baseline_single(family)
    results = runs["baselines"].results()[0]
    for layout in ("dp", "fsdp"):
        r = results[(family, layout)]
        assert_step_equiv(old, m1, s1, r["metrics"], r["state"])


# ---------------------------------------------------------------------------
# the loader, the CLI, synthesis
# ---------------------------------------------------------------------------

class _arrays:
    """A stand-in for WindowedSamples: the loader reads its fields and
    its length."""

    def __init__(self, n):
        rng = np.random.default_rng(0)
        self.n = n
        self.target = rng.normal(size=(n, 4, 3)).astype(np.float32)
        self.vids = np.arange(n)

    def __len__(self):
        return self.n


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_parts_are_the_single_loaders_rows(drop_last):
    """Rank r of 2 takes the rows [4 r, 4 r + 4) of every batch of 8, in
    the single loader's order (same seed), over epochs."""
    samples = _arrays(22)
    keys = ("target", "vids")
    single = BatchLoader(samples, 8, seed=3, keys=keys, drop_last=drop_last)
    parts = [BatchLoader(samples, 8, seed=3, keys=keys, drop_last=drop_last,
                         part=(r, 2)) for r in range(2)]
    for _ in range(2):
        whole = list(single)
        split = [list(p) for p in parts]
        assert len(whole) == len(split[0]) == len(split[1]) == len(single)
        for b, (x, y) in zip(whole, zip(*split)):
            for k in keys:
                np.testing.assert_array_equal(
                    np.concatenate([x[k], y[k]]), b[k])
            if drop_last:
                assert len(x["vids"]) == len(y["vids"]) == 4
    with pytest.raises(ValueError):
        BatchLoader(samples, 7, part=(0, 2))


def _final_loss(out: Path) -> float:
    import json
    rows = [json.loads(ln) for ln in
            (out / "history.jsonl").read_text().splitlines()]
    return rows[-1]["loss"]


def test_cli_train_fsdp_matches_single_process(spawned):
    """``torchrun --nproc_per_node 2 -m ha2g_torch.cli train ...
    --fsdp_devices 2`` ends within 5e-3 of the single-process run's final
    validation loss (tests/test_parallel.py:278), rank 0 alone writing the
    history and checkpoints, which load strictly in one process."""
    root, _, torchrun = spawned
    single = root / "single_run"
    log = torchrun.communicate(timeout=240)[0]
    assert torchrun.returncode == 0, log[-4000:]
    fsdp = root / "fsdp_run"
    want, got = _final_loss(single), _final_loss(fsdp)
    assert abs(got - want) <= 5e-3 * max(1.0, abs(want)), (want, got)
    rows = (fsdp / "history.jsonl").read_text().splitlines()
    assert len(rows) == len((single / "history.jsonl").read_text()
                            .splitlines())
    a, b = read_state(single / "checkpoint_final"), \
        read_state(fsdp / "checkpoint_final")
    assert a["step"] == b["step"] > 0
    for k, v in a["model"].items():
        assert b["model"][k].shape == v.shape, k
    for key in ("g_opt", "d_opt"):
        for i, st in a[key]["state"].items():
            for name, v in st.items():
                assert b[key]["state"][i][name].shape == v.shape


def test_mesh_needs_a_group_for_more_than_one_device():
    """A single process (no group, no torchrun) takes the single-device
    path; asking it for FSDP raises."""
    assert pm.mesh_for(Config(), "cpu") is None
    with pytest.raises(ValueError):
        pm.mesh_for(Config(fsdp_devices=2), "cpu")
    assert pm._fsdp_dim((16, 300), 2) == 1
    assert pm._fsdp_dim((3, 3), 2) is None
    assert pm._fsdp_dim((301, 7), 2) is None
    assert pm._fsdp_dim((100, 100), 2) == 0


@pytest.mark.parametrize("fields", [dict(dp_devices=-1),
                                    dict(fsdp_devices=0)])
def test_config_refuses_an_impossible_mesh(fields):
    """dp_devices (0 = the world size over fsdp_devices) and fsdp_devices
    (1 = pure data parallel) are checked where a config loads."""
    with pytest.raises(ValueError):
        Config(**fields)
    with pytest.raises(ValueError):
        Config().replace(**fields)


def test_run_fused_over_devices_matches_one_call():
    """``run_fused(devices=["cpu", "cpu"])``: two parts of the batch from
    two threads, the speaker z noise of the whole batch (z on), equal the
    single call within 2e-4 (tests/test_streaming.py:257), and leave the
    generator where the single call does."""
    from ha2g_torch.data.vocab import Vocab
    from ha2g_torch.synthesis import make_synthesizer
    from ha2g_torch.train.hierarchy import HierarchySystem

    cfg = child.hierarchy_config()
    system = HierarchySystem(cfg, child.HN_WORDS, child.HN_SPK, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    synth = make_synthesizer(system, system.state_dict())
    lang = Vocab("words")
    for i in range(child.HN_WORDS - lang.n_words):
        lang.index_word(f"w{i}")
    rng = np.random.default_rng(0)
    B, seconds = 4, 4.5
    audio = (rng.normal(size=(B, int(seconds * 16000))) * 0.1) \
        .astype(np.float32)
    words = [[(f"w{j}", 0.3 * j, 0.3 * j + 0.2) for j in range(8)]
             for _ in range(B)]
    vids = np.arange(B) % child.HN_SPK
    outs, after = [], []
    for devices in (None, ["cpu", "cpu"]):
        gen = torch.Generator().manual_seed(1)
        plan = synth.prepare_fused(words, lang, vids, audio.shape[1], gen)
        outs.append(synth.run_fused(audio, plan, devices=devices))
        after.append(torch.rand(3, generator=gen))
    assert outs[0].shape == outs[1].shape and np.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1], outs[0], atol=2e-4)
    assert torch.equal(after[0], after[1])
    with pytest.raises(ValueError):
        synth.run_fused(audio[:3], synth.prepare_fused(
            words[:3], lang, vids[:3], audio.shape[1]), devices=["cpu"] * 2)
