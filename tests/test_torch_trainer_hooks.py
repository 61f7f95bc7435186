"""The Trainer's hooks and the evaluator's feature view on the CPU:
``tensorboard`` scalars read back with tensorboard's own reader, a
``profile_dir`` trace that covers global iterations 3 to 5 exactly, and
``get_features_for_viz``: its PCA against scikit-learn's ``PCA(2)``
(signs included, within 1e-6), in the (real, generated) order of the JAX
package's."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_torch.config import Config
from ha2g_torch.data.dataset import window_clips
from ha2g_torch.data.synthetic import synthetic_clips
from ha2g_torch.data.vocab import Vocab, build_vocab
from ha2g_torch.eval.fgd import EmbeddingSpaceEvaluator, make_embedder, pca_2d
from ha2g_torch.models.common import init_parameters_
from ha2g_torch.skeleton import TED_GESTURE
from ha2g_torch.train.loop import Trainer

CONFIG = (Path(__file__).resolve().parent.parent / "configs"
          / "gesture_autoencoder.yaml")


@pytest.fixture(scope="module")
def data():
    clips = synthetic_clips(TED_GESTURE, n_clips=3, clip_seconds=6.0, seed=3)
    lang = build_vocab("words", [clips])
    speaker = Vocab("vid", insert_default_tokens=False)
    for c in clips:
        speaker.index_word(c["vid"])
    cfg = Config.from_yaml(CONFIG)
    samples = window_clips(clips, TED_GESTURE, lang, speaker,
                           cfg.mean_pose_array, cfg.mean_dir_vec_array)
    return samples, lang, speaker


def _trainer(tmp_path, data, **hooks):
    samples, lang, speaker = data
    cfg = Config.from_yaml(CONFIG, batch_size=2, epochs=1, random_seed=0,
                           model_save_path=str(tmp_path / "out"))
    return Trainer(cfg, samples, samples, lang, speaker, device="cpu",
                   **hooks)


def test_tensorboard_scalars(tmp_path, data, monkeypatch):
    # torch's writer imports TensorFlow where it is installed (tens of
    # seconds); without it, tensorboard uses its own stub
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    trainer = _trainer(tmp_path, data, tensorboard=True)
    history = trainer.fit(epochs=2)
    acc = EventAccumulator(str(tmp_path / "out" / "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"train/loss", "val/loss"} <= tags
    steps = len(trainer.train_loader)
    train = acc.Scalars("train/loss")
    assert [e.step for e in train] == [steps, 2 * steps]
    assert all(np.isfinite(e.value) for e in train)
    val = acc.Scalars("val/loss")
    assert [e.step for e in val] == [0, 1]
    np.testing.assert_allclose([e.value for e in val],
                               [r["loss"] for r in history[:2]], rtol=1e-6)


def test_profile_covers_iterations_3_to_5(tmp_path, data):
    trainer = _trainer(tmp_path, data, profile_dir=str(tmp_path / "prof"))
    assert len(trainer.train_loader) >= 6
    trainer.fit(epochs=1)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    steps = sorted(int(n.split("#")[1]) for n in names
                   if n.startswith("train_step#"))
    assert steps == [3, 4, 5]
    assert trainer._prof is None and trainer.global_iter == \
        len(trainer.train_loader)
    # without profile_dir nothing is traced
    assert _trainer(tmp_path, data)._prof is None


@pytest.mark.parametrize("shape", ((40, 32), (600, 32), (30, 128)))
def test_pca_matches_scikit_learn(shape):
    from sklearn.decomposition import PCA
    rng = np.random.default_rng(shape[0])
    x = rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1]))
    want = PCA(n_components=2).fit_transform(x)
    got = pca_2d(x)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the sign rule: each component's largest-magnitude loading positive
    np.testing.assert_allclose(pca_2d(-x), -want, atol=1e-6, rtol=0)


def test_features_for_viz_real_then_generated():
    from sklearn.decomposition import PCA
    from ha2g_tpu.eval.fgd import EmbeddingSpaceEvaluator as JaxEvaluator
    net = make_embedder(27)
    init_parameters_(net, torch.Generator().manual_seed(0))
    ev = EmbeddingSpaceEvaluator(27, 34, net.state_dict(), latent_dim=32,
                                 device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(2):
        real = (rng.normal(size=(6, 34, 27)) * 0.3).astype(np.float32)
        ev.push_samples(real + 0.1, real)
    real, gen = ev.get_features_for_viz()
    assert real.shape == gen.shape == (12, 2)
    stacked = np.vstack(ev.generated_feat_list + ev.real_feat_list)
    want = PCA(n_components=2).fit_transform(stacked.astype(np.float64))
    np.testing.assert_allclose(real, want[12:], atol=1e-6, rtol=0)
    np.testing.assert_allclose(gen, want[:12], atol=1e-6, rtol=0)
    # the JAX evaluator's view of the same features (scikit-learn in
    # float32): the same order and signs
    jev = object.__new__(JaxEvaluator)
    jev.generated_feat_list = ev.generated_feat_list
    jev.real_feat_list = ev.real_feat_list
    jreal, jgen = jev.get_features_for_viz()
    scale = np.abs(want).max()
    np.testing.assert_allclose(real, jreal, atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(gen, jgen, atol=1e-4 * scale, rtol=0)
