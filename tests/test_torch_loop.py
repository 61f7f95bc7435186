"""The port's Trainer.evaluate against the JAX package's on the same
hierarchy parameters, the same validation samples and the same FGD
embedder, on the CPU in fp32: a 3-level TED Gesture hierarchy, hidden 16,
2 GRU layers, no speaker z (so evaluation draws no noise).  The port's
seeded parameters and randomised batch-norm statistics cross to the JAX
side through the JAX package's own reference-checkpoint importer
(``ha2g_tpu.import_torch``), which saves the JAX initialisation's
compile; ``convert.hierarchy_state`` (the other direction) is held to
``export_torch`` by the train-step parity tests.  Also the trainer's
best-checkpoint bookkeeping and its GAN gating."""

import functools

import numpy as np
import jax.numpy as jnp
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import import_torch
from ha2g_tpu.config import Config as JaxConfig
from ha2g_tpu.eval.fgd import EmbeddingSpaceEvaluator as JaxEvaluator
from ha2g_tpu.train.hierarchy import HierarchyState
from ha2g_tpu.train.loop import Trainer as JaxTrainer

from ha2g_torch.config import Config
from ha2g_torch.data import vocab as pvocab
from ha2g_torch.data.dataset import window_clips
from ha2g_torch.data.synthetic import default_mean_dir_vec, synthetic_clips
from ha2g_torch.eval.fgd import EmbeddingSpaceEvaluator
from ha2g_torch.models.common import init_parameters_
from ha2g_torch.models.embedding_net import EmbeddingNet
from ha2g_torch.skeleton import TED_GESTURE
from ha2g_torch.train.loop import Trainer

NL = 2
# loss (mean L1), joint_mae and accel: fp32 forward of the same network in
# another summation order, 1e-4 relative; frechet: the sqrtm of products
# of covariances of those outputs' features, 1e-3 relative; feat_dist: a
# mean of feature L1 distances, 1e-4 relative
RTOL = {"loss": 1e-4, "joint_mae": 1e-4, "accel": 1e-4, "frechet": 1e-3,
        "feat_dist": 1e-4}


def _fields(mean_vec):
    return dict(model="hierarchy", dataset="ted_gesture", pose_dim=27,
                n_poses=34, n_pre_poses=4, hidden_size=16, n_layers=NL,
                z_type="none", batch_size=8, compute_dtype="float32",
                mean_dir_vec=[float(v) for v in mean_vec], random_seed=0)


def _randomise_stats(module: torch.nn.Module, seed: int) -> None:
    """Running statistics away from (0, 1), so eval-mode batch norm is
    exercised."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape)))
            elif name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.1, buf.shape)))


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _jax_state(sd: dict, n_levels: int) -> HierarchyState:
    """The port's state dict (the reference's keys) as a JAX
    HierarchyState, through the JAX package's reference importer."""
    audio_p, audio_s = import_torch.convert_audio_encoder(_sub(sd, "audio."))
    dis_p, dis_s = import_torch.convert_discriminator(_sub(sd, "dis."))
    params = {"audio": audio_p, "dis": dis_p,
              "text": import_torch.convert_text_encoder(_sub(sd, "text."),
                                                        NL),
              "gens": tuple(import_torch.convert_generator(
                  _sub(sd, f"gens.{lv}."), NL) for lv in range(n_levels))}
    return HierarchyState(params=params,
                          batch_stats={"audio": audio_s, "dis": dis_s},
                          g_opt=None, d_opt=None,
                          step=jnp.zeros((), jnp.int32))


@functools.cache
def _setup():
    """Samples, vocabularies, the embedder's state dict, the port's
    hierarchy state dict and the JAX trainer with that state."""
    mean_vec = default_mean_dir_vec(TED_GESTURE)
    train_clips = synthetic_clips(TED_GESTURE, n_clips=2, seed=0)
    val_clips = synthetic_clips(TED_GESTURE, n_clips=6, seed=1)
    lang = pvocab.build_vocab("words", [train_clips, val_clips])
    lang.random_word_vectors(300)
    speaker = pvocab.Vocab("vid", insert_default_tokens=False)
    for c in train_clips + val_clips:
        speaker.index_word(c["vid"])
    kw = dict(spec=TED_GESTURE, lang=lang, speaker=speaker,
              mean_pose=np.zeros(30, np.float32), mean_dir_vec=mean_vec)
    train_s, val_s = window_clips(train_clips, **kw), window_clips(
        val_clips, **kw)

    emb = EmbeddingNet(27, 34)
    init_parameters_(emb, torch.Generator().manual_seed(77))
    _randomise_stats(emb, 1)
    ev_sd = emb.state_dict()
    ev_params, ev_stats = import_torch.convert_embedding_net_pose(ev_sd)

    port = Trainer(Config(**_fields(mean_vec)), train_s, val_s, lang,
                   speaker, device="cpu")
    _randomise_stats(port.system, 2)
    sd = {k: v.clone() for k, v in port.system.state_dict().items()}
    jtrainer = JaxTrainer(JaxConfig(**_fields(mean_vec)), train_s, val_s,
                          lang, speaker,
                          JaxEvaluator(27, 34, ev_params, ev_stats),
                          use_mesh=False)
    return (mean_vec, lang, speaker, train_s, val_s, jtrainer,
            _jax_state(sd, TED_GESTURE.n_levels), sd, ev_sd)


def _port_trainer(cfg=None, evaluator=True, bc=False):
    mean_vec, lang, speaker, train_s, val_s, _, _, sd, ev_sd = _setup()
    cfg = cfg or Config(**_fields(mean_vec))
    pev = EmbeddingSpaceEvaluator(27, 34, ev_sd, device="cpu") \
        if evaluator else None
    trainer = Trainer(cfg, train_s, val_s, lang, speaker, pev,
                      beat_consistency_score=bc, device="cpu")
    trainer.system.load_state_dict(sd, strict=True)
    return trainer


def test_evaluate_matches_jax_trainer():
    """Trainer.evaluate on both sides: loss / joint_mae / accel within
    1e-4, frechet within 1e-3, feat_dist within 1e-4 (relative); the same
    keys, and a finite positive diversity (drawn from fresh entropy on
    both sides, as the reference's, so not compared)."""
    _, _, _, _, val_s, jtrainer, state, _, _ = _setup()
    assert len(val_s) >= 40           # more samples than feature dims
    want = jtrainer.evaluate(state, 0)
    trainer = _port_trainer()
    got = trainer.evaluate(0)
    assert set(got) == set(want)
    for k, rtol in RTOL.items():
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert np.isfinite(got["diversity"]) and got["diversity"] > 0
    assert set(trainer.eval_times) == {"eval_step", "embed", "metrics",
                                       "stats", "total"}


def test_track_best_selects_by_frechet_and_maximises_diversity(tmp_path):
    trainer = _port_trainer(evaluator=False)
    rows = [{"loss": 2.0, "frechet": 5.0, "diversity": 1.0},
            {"loss": 1.0, "frechet": 6.0, "diversity": 3.0},
            {"loss": 3.0, "frechet": 4.0, "diversity": 2.0}]
    for epoch, row in enumerate(rows):
        trainer._track_best(row, epoch, tmp_path)
    assert trainer.best_values == {"loss": (1.0, 1), "frechet": (4.0, 2),
                                   "diversity": (3.0, 1)}
    from ha2g_torch.checkpoint import load_config
    assert load_config(tmp_path / "checkpoint_best")[1]["epoch"] == 2


def test_train_epoch_gates_gan_by_loss_warmup():
    """GAN steps (the dis / gen terms) run only when epoch > loss_warmup;
    the metrics are drained to host floats once an epoch."""
    mean_vec = _setup()[0]
    trainer = _port_trainer(Config(**{**_fields(mean_vec),
                                      "loss_warmup": 0}), evaluator=False)
    warm = trainer.train_epoch(0)
    gan = trainer.train_epoch(1)
    assert trainer.step == 2 * len(trainer.train_loader) > 0
    assert "dis" not in warm and {"dis", "gen"} <= set(gan)
    assert all(isinstance(v, float) and np.isfinite(v)
               for v in gan.values())
