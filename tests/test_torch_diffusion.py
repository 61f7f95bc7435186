"""DiffGesture's pose diffusion (``model: pose_diffusion``) against the
benchmark's plain float32 reference (``benchmark/reference/diffgesture.py``,
loaded by path), at tiny widths on the CPU on seeded random weights: one
denoiser pass, the guided step's one batched pass against two, the
schedule against its closed form, a two-window ``generate`` (no draw at
t = 1), the train step's loss and every gradient, the spans and the step
counter.  The graph-replayed chain runs on the card
(tests/test_torch_cuda.py)."""

import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch.config import Config
from ha2g_torch.data.vocab import Vocab
from ha2g_torch.models.diffusion import variance_schedule
from ha2g_torch.synthesis import DiffusionSynthesizer, make_synthesizer
from ha2g_torch.train.loop import build_system

REF_DIR = Path(__file__).resolve().parents[1] / "benchmark" / "reference"
CFG = dict(model="pose_diffusion", dataset="ted_expressive", pose_dim=126,
           n_poses=34, n_pre_poses=4, motion_resampling_framerate=15,
           diff_hidden_dim=32, block_depth=2, n_heads=2, mlp_ratio=4,
           diffusion_steps=4, beta_1=1e-4, beta_T=0.02, null_cond_prob=0.5,
           guidance_scale=1.5, compute_dtype="float32")
B = 2
REL = 1e-5


def _reference_module():
    """``benchmark/reference/diffgesture.py`` as a module of a package named
    apart from the benchmark's own imports."""
    name = "bench_reference_for_tests"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, REF_DIR / "__init__.py",
            submodule_search_locations=[str(REF_DIR)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.diffgesture")


ref = _reference_module()


def _weights(system, seed=0) -> dict:
    """The system's state with every float leaf drawn from ``seed``: layer
    norms and the bare parameters away from their initial values, batch
    norm's running variance positive."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in system.state_dict().items():
        if not v.is_floating_point():
            out[k] = v
        elif k.endswith("running_var"):
            out[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("running_mean"):
            out[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif "norm" in k and k.endswith("weight"):
            out[k] = 1.0 + 0.2 * torch.randn(v.shape, generator=g)
        else:
            scale = 0.3 if v.dim() > 1 else 0.2
            out[k] = v + scale * torch.randn(v.shape, generator=g) * (
                v.std() if v.numel() > 1 and v.std() > 0 else 1.0)
    return out


@pytest.fixture(scope="module")
def case():
    cfg = Config.from_dict(CFG)
    system = build_system(cfg, 4, 1, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    w = _weights(system)
    model = ref.DiffGesture(CFG)
    model.load_state_dict(w, strict=True)
    model.eval()
    synth = make_synthesizer(system, w)
    audio = (0.1 * np.random.default_rng(1).normal(
        size=(B, 3 * 16000))).astype(np.float32)
    return system, model, synth, w, audio


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def test_builds_through_the_normal_path(case):
    system, _, synth, _, _ = case
    assert type(synth) is DiffusionSynthesizer
    assert synth.uses_audio and not synth.uses_spec
    assert system.batch_keys == ("audio", "target")
    assert set(system.state_dict()) == set(ref.DiffGesture(CFG).state_dict())


def test_denoiser_pass(case):
    system, model, _, _, _ = case
    x = torch.randn(3, 34, 126 + 3 + 126 + 1 + 32,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = system.denoiser(x, system.denoiser.cast(torch.float32))
        want = model.denoiser(x)
    assert _rel(got, want) < REL


def test_guided_step_is_two_passes(case):
    """The one pass over 2B rows (conditioned first) and the guidance
    against two separate reference passes."""
    system, model, _, _, audio = case
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, 34, 126, generator=g)
    seed = torch.randn(B, 4, 126, generator=g)
    wav = torch.from_numpy(audio[:, :36266])
    f32 = torch.float32
    with torch.no_grad():
        cond = system.condition(seed, wav, f32)
        got = system.guided_eps(x, 3, system.guided_rows(cond),
                                system.denoiser.cast(f32), f32)
        rcond = ref.condition(model, seed, wav)
        temb = ref.schedule(CFG)["temb"][3]
        e_c = model.denoiser(ref._inputs(x, temb, rcond, ref.FLOAT32))
        null = model.null_cond.view(1, 1, -1).expand_as(rcond)
        e_u = model.denoiser(ref._inputs(x, temb, null, ref.FLOAT32))
    assert _rel(cond, rcond) < REL
    assert _rel(got, e_u + 1.5 * (e_c - e_u)) < REL


def test_schedule_closed_form():
    T, b1, bT = 500, 1e-4, 0.02
    got = variance_schedule(T, b1, bT)
    t = np.arange(1, T + 1)
    beta = np.concatenate([[0.0], b1 + (bT - b1) * (t - 1) / (T - 1)])
    abar = np.cumprod(1.0 - beta)
    sigma = np.zeros(T + 1)
    sigma[1:] = np.sqrt(beta[1:] * (1 - abar[:-1]) / (1 - abar[1:]))
    for key, want in (("beta", beta), ("alpha", 1.0 - beta),
                      ("alpha_bar", abar), ("sigma", sigma)):
        np.testing.assert_allclose(got[key].numpy(), want, rtol=1e-6,
                                   atol=1e-12)
    np.testing.assert_allclose(got["temb"].numpy(), np.stack(
        [beta, np.sin(beta), np.cos(beta)], -1), rtol=1e-6, atol=1e-12)
    assert got["sigma"][1] == 0.0 and got["alpha_bar"][0] == 1.0
    theirs = ref.schedule({"diffusion_steps": T, "beta_1": b1, "beta_T": bT})
    for key in got:
        assert torch.equal(got[key], theirs[key]), key


def test_two_windows_match_the_reference_sampler(case):
    """``generate`` over two windows against the reference's sliding-window
    sampler with the same generator; both leave the generator where T
    draws a window leave it (x_T and z_T .. z_2: none at t = 1)."""
    _, model, synth, _, audio = case
    gen, rgen = (torch.Generator().manual_seed(5) for _ in range(2))
    before = dict(synth.step_counts)
    got = synth.generate(audio, [[]] * B, Vocab("words"),
                         np.zeros(B, np.int64), generator=gen)
    want, wins, _ = ref.synthesize(model, torch.from_numpy(audio), rgen,
                                   torch.arange(B), B)
    assert len(wins) == 2 and got.shape == (B, 34 + 30, 126)
    assert _rel(got, want) < REL
    counted = torch.Generator().manual_seed(5)
    for _ in range(2 * 4):
        torch.randn((B, 34, 126), generator=counted)
    assert torch.equal(gen.get_state(), counted.get_state())
    assert torch.equal(rgen.get_state(), counted.get_state())
    assert {k: synth.step_counts[k] - before[k] for k in before} == {
        "eager": 2 * 4, "replayed": 0, "captured": 0}


def test_reference_restarts_windows_beside_the_chain(case):
    """The reference's second copy of the rows, restarted at each window
    from the chained windows' own seed frames, gives the chained windows
    again: the batch the correctness check runs both in."""
    _, model, _, _, audio = case
    x = torch.from_numpy(audio)
    _, wins, _ = ref.synthesize(model, x, torch.Generator().manual_seed(4),
                                torch.arange(B), B)
    seeds = [torch.zeros(B, 4, 126)] + [w[:, -4:] for w in wins[:-1]]
    _, again, restarted = ref.synthesize(
        model, x, torch.Generator().manual_seed(4), torch.arange(B), B,
        seeds=seeds)
    for w, a, r in zip(wins, again, restarted):
        assert _rel(a, w) < REL and _rel(r, w) < REL


def test_train_step_loss_and_gradients(case):
    """One train step (fp32, train-mode batch norm) against the reference's
    loss and autograd, leaf by leaf; the step draws t, the noise and the
    null condition's coin in the reference's order."""
    _, _, _, w, audio = case
    cfg = Config.from_dict(CFG)
    system = build_system(cfg, 4, 1, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    system.load_state_dict(w)
    model = ref.DiffGesture(CFG)
    model.load_state_dict(w)
    model.train()
    g = torch.Generator().manual_seed(7)
    batch = {"audio": audio[:, :36267].repeat(2, 0),
             "target": torch.randn(2 * B, 34, 126, generator=g).numpy()}
    metrics = system.train_step(batch, torch.Generator().manual_seed(9))
    loss = ref.eps_loss(model, torch.from_numpy(batch["target"]),
                        torch.from_numpy(batch["audio"]),
                        torch.Generator().manual_seed(9))
    loss.backward()
    loss = float(loss.detach())
    assert abs(float(metrics["loss"]) - loss) <= REL * loss
    theirs = dict(model.named_parameters())
    # a leaf's gap over the larger of its norm and the median leaf's: a
    # bias right before a train-mode batch norm has a zero true gradient
    # and holds round-off alone
    median = float(np.median([float(p.grad.norm()) for p in theirs.values()]))
    for name, p in system.named_parameters():
        want = theirs[name].grad
        assert p.grad is not None and want is not None, name
        scale = max(float(want.norm()), median)
        assert float((p.grad - want).norm()) <= REL * scale, name


def test_null_condition_coin_drops_rows():
    """With null_cond_prob 1 every row trains on the null condition, so the
    audio encoder takes no gradient; with 0, it does."""
    grads = []
    for prob in (1.0, 0.0):
        cfg = Config.from_dict({**CFG, "null_cond_prob": prob})
        system = build_system(cfg, 4, 1, device="cpu",
                              generator=torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        batch = {"audio": 0.1 * rng.normal(size=(2, 36267)),
                 "target": rng.normal(size=(2, 34, 126))}
        batch = {k: v.astype(np.float32) for k, v in batch.items()}
        system.train_step(batch, torch.Generator().manual_seed(1))
        enc = [p.grad for p in system.audio_encoder.parameters()]
        grads.append(sum(0.0 if g is None else float(g.abs().sum())
                         for g in enc))
    assert grads[0] == 0.0 and grads[1] > 0.0


def test_spans_and_step_counts(case):
    """Under a profiler: a window span per window holding its condition
    and chain spans, a denoiser span per step, no replay on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    _, _, synth, _, audio = case
    before = dict(synth.step_counts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        synth.generate(audio, [[]] * B, Vocab("words"), np.zeros(B, np.int64),
                       generator=torch.Generator().manual_seed(1))
    names = [e.name for e in prof.events()]
    count = {n: names.count(n) for n in (
        "ha2g.diffuse.window", "ha2g.diffuse.condition", "ha2g.diffuse.chain",
        "ha2g.diffuse.replay", "ha2g.model.denoiser")}
    assert count == {"ha2g.diffuse.window": 2, "ha2g.diffuse.condition": 2,
                     "ha2g.diffuse.chain": 2, "ha2g.diffuse.replay": 0,
                     "ha2g.model.denoiser": 2 * 4}
    assert {k: synth.step_counts[k] - before[k] for k in before} == {
        "eager": 2 * 4, "replayed": 0, "captured": 0}


def test_cli_trains_evaluates_and_synthesizes(tmp_path):
    """``cli train`` (two epochs on stored 4 s clips: the epsilon-loss
    steps, an evaluation that samples the chain), ``eval`` and
    ``synthesize`` on the pose_diffusion checkpoint."""
    import contextlib
    import io

    from ha2g_torch import cli
    from ha2g_torch.data.storage import save_clips
    from ha2g_torch.data.synthetic import synthetic_clips
    from ha2g_torch.skeleton import TED_EXPRESSIVE

    root = Path(__file__).resolve().parents[1]
    for split, seed in (("train", 0), ("val", 1)):
        save_clips(tmp_path / split, synthetic_clips(
            TED_EXPRESSIVE, n_clips=2, clip_seconds=4.0, seed=seed))
    run = tmp_path / "run"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main([
            "train", "--config",
            str(root / "configs_expressive" / "multimodal_context.yaml"),
            "--model", "pose_diffusion", "--device", "cpu",
            "--diff_hidden_dim", "16", "--block_depth", "1", "--n_heads", "2",
            "--diffusion_steps", "3", "--batch_size", "4",
            "--compute_dtype", "float32", "--epochs", "2",
            "--random_seed", "0", "--train_data_path", str(tmp_path / "train"),
            "--test_data_path", str(tmp_path / "val"),
            "--model_save_path", str(run), "--eval_net_path", ""]) == 0
        assert cli.main(["eval", str(run / "checkpoint_best"),
                         "--device", "cpu"]) == 0
        assert cli.main(["synthesize", str(run / "checkpoint_best"),
                         "--clips", str(tmp_path / "val"), "--n", "2",
                         "--device", "cpu", "--out",
                         str(tmp_path / "s.npz")]) == 0
    history = (run / "history.jsonl").read_text().splitlines()
    assert len(history) == 3 and "joint_mae" in history[-1]
    got = np.load(tmp_path / "s.npz")["dir_vec"]
    assert got.shape == (2, 64, 126) and np.isfinite(got).all()
    assert "wrote" in out.getvalue()
