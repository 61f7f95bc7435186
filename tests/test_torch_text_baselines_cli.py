"""The text and embedding baselines (seq2seq, joint_embedding,
gesture_autoencoder at pose 27 and 126) through the port's surfaces on
the CPU at a narrow width (seq2seq hidden 16 / 2 layers, word embedding
16, fp32): ``cli train`` for two epochs on stored synthetic clips, ``eval``
and ``synthesize`` (none for an embedder); the exact resume of a
single-optimiser system; the embedders' loop: a port-trained
``checkpoint_best`` named as another run's ``eval_net_path`` (FGD on the
validation rows, the best checkpoint picked by it), and through
``export-checkpoint`` / ``import-evalnet``; a reference ``.bin`` written
by ``ha2g_tpu.export_torch`` and a JAX checkpoint directory written by
``ha2g_tpu.checkpoint`` read back bit for bit, and exported as
``export_torch`` exports them; one ``GestureService`` request and one
HTTP request of seq2seq and joint_embedding, each equal to the direct
``generate`` on the same padded batch; and their live streams refused.
"""

import ast
import base64
import contextlib
import copy
import functools
import io
import json
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import checkpoint as jckpt
from ha2g_tpu import export_torch as et
from tests.torch_baselines import N_SPK, clips, jax_config, vocabs
from tests.torch_serving import (http_server,  # noqa: F401  (fixture)
                                 no_thread_outlives_module)
from tests.torch_text_baselines import (AE, CONFIGS, JE, MAE, S2S,
                                        jax_setup, port_config, pose_dim)

from ha2g_torch import checkpoint as ckpt
from ha2g_torch import cli
from ha2g_torch.data.storage import save_clips
from ha2g_torch.data.synthetic import synthetic_clips
from ha2g_torch.eval.fgd import make_embedder
from ha2g_torch.serve import GestureService
from ha2g_torch.skeleton import TED_EXPRESSIVE, TED_GESTURE
from ha2g_torch.train.loop import Trainer, build_system

OPT_KEYS = {"model", "opt", "step"}


def _quiet(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    return out.getvalue()


def _data(root: Path, family: str) -> Path:
    """Two stored 4 s clips per split, of the family's skeleton."""
    spec = TED_EXPRESSIVE if family == MAE else TED_GESTURE
    data = root / ("data126" if family == MAE else "data27")
    if not data.exists():
        save_clips(data / "train", synthetic_clips(
            spec, n_clips=2, clip_seconds=4.0, seed=0))
        save_clips(data / "val", synthetic_clips(
            spec, n_clips=2, clip_seconds=4.0, seed=1))
    return data


def _train_args(root: Path, family: str, out: Path, epochs: int, *extra):
    data = _data(root, family)
    return ["train", "--config", str(CONFIGS[family]), "--device", "cpu",
            "--hidden_size", "16", "--n_layers", "2", "--batch_size", "4",
            "--wordembed_dim", "16", "--compute_dtype", "float32",
            "--subdivision_stride", "10", "--epochs", str(epochs),
            "--random_seed", "0", "--train_data_path", str(data / "train"),
            "--test_data_path", str(data / "val"),
            "--model_save_path", str(out), "--eval_net_path", "", *extra]


def _live_state(trainer):
    system = trainer.system
    return copy.deepcopy({"model": system.state_dict(),
                          "opt": system.opt.state_dict(),
                          "step": trainer.step})


@functools.cache
def _trained(root: Path, family: str):
    """Two epochs of ``cli train``; -> (output directory, the trainer's own
    state when it wrote checkpoint_final)."""
    out = root / family
    live = {}
    save = Trainer.save

    def save_and_keep(self, path, extra):
        if Path(path).name == "checkpoint_final":
            live.update(_live_state(self))
        save(self, path, extra)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(Trainer, "save", save_and_keep)
        _quiet(_train_args(root, family, out, 2))
    return out, live


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("text_baselines")


def _history(out: Path):
    return [json.loads(ln) for ln in
            (out / "history.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("family", (S2S, JE, AE, MAE))
def test_train_eval_synthesize(root, family, tmp_path):
    """Two epochs of every family; an embedder's evaluation is its
    reconstruction loss alone (no pose metrics, no FGD), so its
    checkpoint_best is picked by the loss, and that checkpoint's state dict
    is the embedder's own (``make_embedder``'s keys)."""
    out, _ = _trained(root, family)
    rows = _history(out)
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    for name in ("checkpoint_best", "checkpoint_final"):
        assert set(ckpt.read_state(out / name)) == OPT_KEYS
    assert ckpt.read_state(out / "checkpoint_final")["step"] > 0
    cfg, extra = ckpt.load_config(out / "checkpoint_best")
    embedder = family in (AE, MAE)
    if embedder:
        assert all(r["joint_mae"] == r["accel"] == 0.0 and "frechet" not in r
                   for r in rows)
        assert extra["val"]["loss"] == min(r["loss"] for r in rows)
        net = make_embedder(cfg.pose_dim, cfg.n_poses, cfg.latent_dim)
        state = ckpt.read_state(out / "checkpoint_best")["model"]
        assert state.keys() == net.state_dict().keys()
        net.load_state_dict(state, strict=True)
    data = _data(root, family)
    printed = _quiet(["eval", str(out / "checkpoint_final"),
                      "--clips", str(data / "val"), "--device", "cpu"])
    metrics = ast.literal_eval(printed.strip().splitlines()[-1])
    assert {"loss", "joint_mae", "accel"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    argv = ["synthesize", str(out / "checkpoint_final"), "--n", "2",
            "--clips", str(data / "val"), "--device", "cpu",
            "--out", str(tmp_path / "s.npz")]
    if embedder:
        with pytest.raises(ValueError, match="no synthesizer"):
            cli.main(argv)
        return
    _quiet(argv)
    poses = np.load(tmp_path / "s.npz")["dir_vec"]
    assert poses.shape[::2] == (2, 27) and np.isfinite(poses).all()


def test_resume_of_a_single_optimizer_system_is_exact(root, tmp_path):
    """A fresh seq2seq trainer resumed from checkpoint_final holds what
    the run's trainer held when it saved: every parameter and batch-norm
    statistic, the one Adam's state and the step count, exactly; training
    goes on at the next epoch."""
    out, live = _trained(root, S2S)
    final = out / "checkpoint_final"
    cfg, _ = ckpt.load_config(final)
    lang, speaker = ckpt.load_vocabs(final)
    cfg, lang, speaker, train_s, val_s = cli._prepare(cfg, lang, speaker)
    trainer = Trainer(cfg, train_s, val_s, lang, speaker, device="cpu")
    assert trainer.resume(final) == 2
    assert trainer.step == live["step"] > 0
    have = _live_state(trainer)
    for k, v in live["model"].items():
        assert torch.equal(have["model"][k], v), k
    assert have["opt"]["param_groups"] == live["opt"]["param_groups"]
    assert have["opt"]["state"].keys() == live["opt"]["state"].keys()
    for i, st in live["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(have["opt"]["state"][i][k], v), (i, k)
    resumed = root / "resumed"
    _quiet(_train_args(root, S2S, resumed, 3, "--resume", str(final)))
    assert [r["epoch"] for r in _history(resumed)] == [2, 3]
    assert ckpt.read_state(resumed / "checkpoint_final")["step"] == \
        live["step"] + live["step"] // 2
    # saved without the optimiser state: loads, but does not resume
    bare = tmp_path / "bare"
    ckpt.save_checkpoint(bare, trainer.system,
                         cfg.replace(save_optimizer_state=False))
    assert set(ckpt.read_state(bare)) == {"model", "step"}
    ckpt.load_state(bare, trainer.system, optimizers=False)
    with pytest.raises(ValueError, match="optimiser state"):
        ckpt.load_state(bare, trainer.system)


def test_a_port_trained_embedder_is_an_eval_net(root, tmp_path):
    """The embedders' loop: the pose-27 autoencoder's checkpoint_best as a
    seq2seq run's eval_net_path (FGD in every validation row, the best
    checkpoint picked by it); the pose-126 MotionAE's as an evaluator's;
    both through ``export-checkpoint`` to the evaluator's ``.bin`` and
    ``import-evalnet`` back, every tensor equal."""
    ae = _trained(root, AE)[0] / "checkpoint_best"
    out = tmp_path / "s2s"
    _quiet(_train_args(root, S2S, out, 1, "--eval_net_path", str(ae)))
    rows = _history(out)
    assert all(np.isfinite(r["frechet"]) for r in rows)
    extra = ckpt.load_config(out / "checkpoint_best")[1]
    assert extra["val"]["frechet"] == min(r["frechet"] for r in rows)

    mae = _trained(root, MAE)[0] / "checkpoint_best"
    cfg = port_config(MAE).replace(eval_net_path=str(mae))
    evaluator = cli.make_evaluator(cfg, torch.device("cpu"))
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(2, 8, 34, 126)).astype(np.float32) * 0.3
    evaluator.push_samples(poses[0], poses[1])
    assert all(np.isfinite(evaluator.get_scores()))

    for family, path in ((AE, ae), (MAE, mae)):
        _quiet(["export-checkpoint", str(path), str(tmp_path / "e.bin"),
                "--device", "cpu"])
        ref = torch.load(tmp_path / "e.bin", weights_only=False)
        assert ref["pose_dim"] == pose_dim(family)
        assert ("motion_ae" in ref) == (family == MAE)
        _quiet(["import-evalnet", str(tmp_path / "e.bin"),
                str(tmp_path / family), "--device", "cpu"])
        (_, want), (_, got) = (ckpt.load_embedder(path),
                               ckpt.load_embedder(tmp_path / family))
        assert want.keys() == got.keys()
        assert all(torch.equal(got[k], v) for k, v in want.items())


def _jax_directory(tmp: Path, family: str):
    """A JAX checkpoint directory of jax_setup's weights."""
    _, state, sd = jax_setup(family)
    (jlang, jspeaker), _ = vocabs()
    jcfg = jax_config(port_config(family))
    jckpt.save_checkpoint(tmp / "jax", state, jcfg, jlang, jspeaker,
                          extra={"epoch": 3})
    return state, jcfg, sd


@pytest.mark.parametrize("family", (S2S, JE))
def test_reference_bin_and_jax_directory_read_exactly(family, tmp_path):
    state, jcfg, sd = _jax_directory(tmp_path, family)
    (jlang, jspeaker), _ = vocabs()
    ref = et.export_generic_checkpoint(state, jcfg, jlang, jspeaker, epoch=3)
    assert set(ref) >= {"gen_dict"} and "dis_dict" not in ref
    torch.save(ref, tmp_path / "ref.bin")
    _quiet(["import-checkpoint", str(tmp_path / "ref.bin"),
            str(tmp_path / "imported"), "--device", "cpu"])
    imported = ckpt.read_state(tmp_path / "imported")["model"]
    assert imported.keys() == sd.keys()
    assert all(torch.equal(imported[k], v) for k, v in sd.items())
    assert ckpt.load_config(tmp_path / "imported")[0].model == family
    _, _, _, system = cli.load_checkpoint_system(str(tmp_path / "jax"), "cpu")
    got = system.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    _quiet(["export-checkpoint", str(tmp_path / "jax"),
            str(tmp_path / "out.bin"), "--device", "cpu"])
    out = torch.load(tmp_path / "out.bin", weights_only=False)
    assert out["args"].model == family and out["epoch"] == 3
    assert out["gen_dict"].keys() == ref["gen_dict"].keys()
    assert all(torch.equal(out["gen_dict"][k], v)
               for k, v in ref["gen_dict"].items())
    with pytest.raises(ValueError, match="cannot be resumed"):
        ckpt.load_state(tmp_path / "jax", system)


@pytest.mark.parametrize("family", (AE, MAE))
def test_embedder_jax_directory_and_evalnet_bin(family, tmp_path):
    """A JAX gesture_autoencoder directory reads as an embedder (the FGD
    evaluator's ``load_embedder``) bit for bit, exports to the ``.bin``
    ``export_torch.export_evalnet_checkpoint`` writes, and its ``.bin``
    does not import as a generation checkpoint."""
    state, jcfg, sd = _jax_directory(tmp_path, family)
    cfg, got = ckpt.load_embedder(tmp_path / "jax")
    assert cfg.pose_dim == pose_dim(family) and got.keys() == sd.keys()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    _quiet(["export-checkpoint", str(tmp_path / "jax"),
            str(tmp_path / "e.bin"), "--device", "cpu"])
    out = torch.load(tmp_path / "e.bin", weights_only=False)
    want = et.export_evalnet_checkpoint(state, jcfg, epoch=3)
    name = "motion_ae" if family == MAE else "gen_dict"
    assert out[name].keys() == want[name].keys()
    assert all(torch.equal(out[name][k], v) for k, v in want[name].items())
    with pytest.raises(ValueError, match="no generic importer"):
        cli.main(["import-checkpoint", str(tmp_path / "e.bin"),
                  str(tmp_path / "imported"), "--device", "cpu"])


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module", params=(S2S, JE))
def service(request, tmp_path_factory):
    family = request.param
    _, _, sd = jax_setup(family)
    _, (lang, speaker) = vocabs()
    port = build_system(port_config(family), lang.n_words, N_SPK,
                        device="cpu")
    port.load_state_dict(sd, strict=True)
    path = tmp_path_factory.mktemp(family) / "checkpoint"
    ckpt.save_checkpoint(path, port, port.cfg, lang, speaker)
    svc = GestureService(str(path), max_clip_seconds=3.0, max_batch=4,
                         batch_window_ms=200.0, warm=False, device="cpu")
    yield svc
    svc.close()


def test_service_and_http_equal_direct_generate_and_streams_refused(
        service):
    """A request through the service and over HTTP: the row of the direct
    ``generate`` on the same padded batch, bit for bit; a live stream is
    refused every way (words or the raw waveform, not a spectrogram)."""
    audio, words, _ = clips(B=1, seconds=3.0, seed=8)
    got = service.synthesize(audio[0], words[0], vid=1)
    req = types.SimpleNamespace(audio=audio[0], words=words[0], vid=1)
    batch, batch_words, vids = service.padded_batch([req])
    want = service.synth.generate(batch, batch_words, service.lang, vids)
    n = int(round(3.0 * service.fps))
    assert got.shape == (n, 27)
    np.testing.assert_array_equal(got, want[0, :n])
    with http_server(service) as url:
        code, resp = _post(url + "/synthesize", {
            "audio": base64.b64encode(audio[0].tobytes()).decode(),
            "words": words[0], "vid": 1})
        assert code == 200, resp
        poses = np.frombuffer(base64.b64decode(resp["dir_vec"]), "<f4")
        np.testing.assert_array_equal(poses.reshape(resp["shape"]), got)
        code, resp = _post(url + "/stream/open", {"vid": 0})
        assert code == 500 and "spec-windowed" in resp["error"]
    with pytest.raises(ValueError, match="spec-windowed"):
        service.open_stream(0)
    with pytest.raises(ValueError, match="spectrogram-windowed"):
        service.synth.stream(service.lang, 0)
    assert service.stats["errors"] == 0
