"""The port's command line on the CPU (``--device cpu``) at a narrow
width: ``train`` for two epochs on stored synthetic clips with a seeded
FGD embedder, ``--resume``, ``eval --bc``, ``synthesize`` (with
``--fade_out``), ``from-text --wav``, the round trip of a checkpoint and
of the embedder through ``export-checkpoint`` / ``import-checkpoint`` /
``import-evalnet``; and every family's system building."""

import ast
import contextlib
import copy
import functools
import io
import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch import checkpoint as ckpt
from ha2g_torch import cli
from ha2g_torch.config import Config
from ha2g_torch.data.storage import save_clips
from ha2g_torch.data.synthetic import synthetic_clips
from ha2g_torch.models.common import init_parameters_
from ha2g_torch.models.embedding_net import EmbeddingNet
from ha2g_torch.skeleton import TED_GESTURE
from ha2g_torch.train.loop import Trainer, build_system

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "hierarchy.yaml"
VAL_KEYS = {"loss", "joint_mae", "accel", "frechet", "feat_dist",
            "diversity"}


def _train_args(root, epochs, *extra):
    return ["train", "--config", str(CONFIG), "--device", "cpu",
            "--hidden_size", "16", "--n_layers", "2", "--batch_size", "8",
            "--compute_dtype", "float32", "--epochs", str(epochs),
            "--loss_warmup", "0", "--random_seed", "0",
            "--train_data_path", str(root / "train"),
            "--test_data_path", str(root / "val"),
            "--model_save_path", str(root / "out"),
            "--eval_net_path", str(root / "embedder"), *extra]


def _live_state(trainer):
    """A copy of what the trainer holds: every parameter and buffer, both
    Adam optimisers' state, the step count."""
    system = trainer.system
    return copy.deepcopy({"model": system.state_dict(),
                          "g_opt": system.g_opt.state_dict(),
                          "d_opt": system.d_opt.state_dict(),
                          "step": trainer.step})


@functools.cache
def _trained(root):
    """Clips, an embedder, and two epochs of `cli train` under ``root``
    (shared by the tests of this module); -> (root, the trainer's own
    state when it wrote checkpoint_final)."""
    save_clips(root / "train", synthetic_clips(TED_GESTURE, n_clips=2,
                                               seed=0))
    save_clips(root / "val", synthetic_clips(TED_GESTURE, n_clips=2, seed=1))
    net = EmbeddingNet(27, 34)
    init_parameters_(net, torch.Generator().manual_seed(0))
    ckpt.save_embedder(root / "embedder", net, Config(
        model="gesture_autoencoder", pose_dim=27, n_poses=34, latent_dim=32))
    live = {}
    save = Trainer.save

    def save_and_keep(self, path, extra):
        if Path(path).name == "checkpoint_final":
            live.update(_live_state(self))
        save(self, path, extra)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(Trainer, "save", save_and_keep)
        assert cli.main(_train_args(root, 2)) == 0
    assert live
    return root, live


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return _trained(tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def run(trained):
    return trained[0]


def _history(root):
    return [json.loads(ln) for ln in
            (root / "out" / "history.jsonl").read_text().splitlines()]


def test_train_writes_checkpoints_and_picks_best_by_frechet(run):
    out = run / "out"
    rows = _history(run)
    # evaluations at epochs 0 and 1 and after the last epoch
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert VAL_KEYS <= set(r) and all(np.isfinite(r[k]) for k in VAL_KEYS)
    for name in ("checkpoint_best", "checkpoint_final"):
        assert (out / name / "state.pt").is_file()
        assert (out / name / "lang_vocab.json").is_file()
        assert (out / name / "speaker_vocab.json").is_file()
        assert (out / name / "word_vectors.npy").is_file()
    cfg, extra = ckpt.load_config(out / "checkpoint_best")
    best = min(rows, key=lambda r: r["frechet"])
    assert extra["epoch"] == best["epoch"]
    assert extra["val"]["frechet"] == best["frechet"]
    assert cfg.hidden_size == 16 and cfg.eval_net_path.endswith("embedder")
    assert ckpt.load_config(out / "checkpoint_final")[1]["epoch"] == 1


def test_resume_restores_the_state_exactly_and_continues(trained):
    """A fresh trainer resumed from checkpoint_final holds what the
    training run's trainer held when it saved: parameters, batch-norm
    statistics, both Adam optimisers and the step count, exactly; training
    goes on at the next epoch."""
    run, live = trained
    final = run / "out" / "checkpoint_final"
    cfg, _ = ckpt.load_config(final)
    lang, speaker = ckpt.load_vocabs(final)
    cfg, lang, speaker, train_s, val_s = cli._prepare(cfg, lang, speaker)
    trainer = Trainer(cfg, train_s, val_s, lang, speaker, device="cpu")
    assert trainer.resume(final) == 2
    assert trainer.step == live["step"] > 0
    have = _live_state(trainer)
    assert have["model"].keys() == live["model"].keys()
    for k, v in live["model"].items():
        assert torch.equal(have["model"][k], v), k
    for name in ("g_opt", "d_opt"):
        assert have[name]["param_groups"] == live[name]["param_groups"]
        assert have[name]["state"].keys() == live[name]["state"].keys()
        for i, st in live[name]["state"].items():
            assert have[name]["state"][i].keys() == st.keys(), (name, i)
            for k, v in st.items():
                assert torch.equal(have[name]["state"][i][k], v), (name, i, k)
    assert any(len(s) for s in live["d_opt"]["state"].values())

    assert cli.main(_train_args(run, 3, "--resume", str(final))) == 0
    assert [r["epoch"] for r in _history(run)] == [0, 1, 2, 2, 3]
    resumed = ckpt.read_state(run / "out" / "checkpoint_final")
    assert resumed["step"] == live["step"] + live["step"] // 2
    assert ckpt.load_config(run / "out" / "checkpoint_final")[1]["epoch"] == 2


@pytest.mark.parametrize("field", ("--train_data_path", "--test_data_path",
                                   "--wordembed_path"))
def test_a_named_path_that_does_not_exist_raises(run, field):
    """Only "synthetic", "none" or an empty path stand for the built-in
    synthetic clips; a mistyped path raises instead of training on them."""
    missing = str(run / "no_such_dir" / "x.npy")
    with pytest.raises(FileNotFoundError):
        cli.main(_train_args(run, 1, field, missing))


def test_eval_and_synthesize_read_the_checkpoint(run, tmp_path):
    best = run / "out" / "checkpoint_best"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["eval", str(best), "--clips", str(run / "val"),
                         "--bc", "--device", "cpu"]) == 0
    metrics = ast.literal_eval(buf.getvalue().strip().splitlines()[-1])
    assert VAL_KEYS | {"BC"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    for fused in ((), ("--fused",)):
        out = tmp_path / f"synth{len(fused)}.npz"
        assert cli.main(["synthesize", str(best), "--n", "2", "--device",
                         "cpu", "--out", str(out), *fused]) == 0
        poses = np.load(out)["dir_vec"]
        assert poses.shape[0] == 2 and poses.shape[2] == 27
        assert np.isfinite(poses).all()


@pytest.mark.parametrize("model", ("multimodal_context", "seq2seq",
                                   "speech2gesture", "joint_embedding",
                                   "gesture_autoencoder"))
def test_build_system_raises_for_a_baseline_family(model):
    """No baseline family raises any more (ROADMAP A.5 is ported): each
    builds, with the JAX package's batch keys."""
    ported = {"multimodal_context": ("text", "audio", "target", "vids"),
              "speech2gesture": ("spec", "target", "vids"),
              "seq2seq": ("word_seq", "word_lengths", "target", "vids"),
              "joint_embedding": ("text", "audio", "target", "vids"),
              "gesture_autoencoder": ("target", "vids")}
    cfg = Config(model=model, hidden_size=8, n_layers=1, wordembed_dim=8)
    assert build_system(cfg, 8, 2, device="cpu").batch_keys == ported[model]


def _quiet(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(argv)


def test_synthesize_fade_out_and_from_text(run, tmp_path):
    """``--fade_out`` appends 2 * n_pre_poses frames faded to the mean
    pose and leaves the rest; ``from-text`` reads a 16 kHz mono WAV,
    spreads the words over it and fades out."""
    best = str(run / "out" / "checkpoint_best")
    outs = {}
    for name, extra in (("plain", ()), ("faded", ("--fade_out",))):
        outs[name] = tmp_path / f"{name}.npz"
        assert _quiet(["synthesize", best, "--n", "2", "--device", "cpu",
                       "--out", str(outs[name]), *extra]) == 0
    plain = np.load(outs["plain"])["dir_vec"]
    faded = np.load(outs["faded"])["dir_vec"]
    n = plain.shape[1]
    assert faded.shape == (2, n + 8, 27)
    np.testing.assert_array_equal(faded[:, :n], plain)
    np.testing.assert_allclose(faded[:, n:], 0.0, atol=1e-6)

    pcm = (np.random.default_rng(0).normal(size=3 * 16000) * 3000) \
        .astype("<i2")
    wav = tmp_path / "speech.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    out = tmp_path / "text.npz"
    assert _quiet(["from-text", best, "--text", "hello there world",
                   "--wav", str(wav), "--out", str(out),
                   "--device", "cpu"]) == 0
    result = np.load(out)
    np.testing.assert_array_equal(result["audio"][0],
                                  pcm.astype(np.float32) / 32767.0)
    assert result["dir_vec"].shape == (1, 34 + 30 + 8, 27)
    assert np.isfinite(result["dir_vec"]).all()
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    with pytest.raises(ValueError, match="16 kHz mono"):
        _quiet(["from-text", best, "--text", "x", "--wav", str(wav),
                "--device", "cpu"])


def test_checkpoint_and_embedder_round_trip_through_reference_bins(
        run, tmp_path):
    """``export-checkpoint`` then ``import-checkpoint`` gives back every
    tensor, the config and the vocabularies of a trained checkpoint; the
    embedder goes through ``export-checkpoint`` / ``import-evalnet``."""
    best = run / "out" / "checkpoint_best"
    assert _quiet(["export-checkpoint", str(best), str(tmp_path / "h.bin"),
                   "--device", "cpu"]) == 0
    assert _quiet(["import-checkpoint", str(tmp_path / "h.bin"),
                   str(tmp_path / "h"), "--device", "cpu"]) == 0
    want, got = ckpt.read_state(best), ckpt.read_state(tmp_path / "h")
    assert want["model"].keys() == got["model"].keys()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    cfg, extra = ckpt.load_config(best)
    cfg2, extra2 = ckpt.load_config(tmp_path / "h")
    # the importer reads the means as float32, as the JAX package's does
    f32 = lambda v: [float(x) for x in np.float32(v)]
    assert cfg2 == cfg.replace(mean_pose=f32(cfg.mean_pose),
                               mean_dir_vec=f32(cfg.mean_dir_vec))
    assert extra2["epoch"] == extra["epoch"]
    for a, b in zip(ckpt.load_vocabs(best), ckpt.load_vocabs(tmp_path / "h")):
        assert a.to_dict() == b.to_dict()

    assert _quiet(["export-checkpoint", str(run / "embedder"),
                   str(tmp_path / "e.bin"), "--device", "cpu"]) == 0
    assert _quiet(["import-evalnet", str(tmp_path / "e.bin"),
                   str(tmp_path / "e"), "--device", "cpu"]) == 0
    (ecfg, want), (ecfg2, got) = (ckpt.load_embedder(run / "embedder"),
                                  ckpt.load_embedder(tmp_path / "e"))
    assert ecfg2.pose_dim == ecfg.pose_dim == 27
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_unknown_command_and_model():
    assert cli.main(["no-such-command"]) == 1
    with pytest.raises(ValueError, match="unknown model"):
        build_system(Config(model="nope"), 8, 2, device="cpu")
