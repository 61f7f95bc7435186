"""The checkpoint bridge on the CPU: the port reads a JAX checkpoint
directory and a reference ``.bin`` bit for bit, writes a ``.bin`` that the
JAX importer and the reference-layout torch mirrors read back exactly, and
imports an FGD embedder ``.bin``; ``generate`` from a JAX directory and
the imported embedder's features hold the JAX package within 1e-4 (fp32,
hidden 16, 2 GRU layers, 3-level TED Gesture and 6-level TED Expressive).

The JAX states are built without ``HierarchySystem.init`` (a 20-30 s
compile on a CPU): seeded weights of the port's modules go through the
JAX package's own importers (``ha2g_tpu.import_torch``) into its tree
layout, and the optimiser states come from ``optax`` directly.  Speaker z
is pinned at mu (the two packages draw different noise), and the
batch-norm running statistics are randomised.
"""

import argparse
import contextlib
import functools
import io
import pickle
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import checkpoint as jckpt
from ha2g_tpu import export_torch as et
from ha2g_tpu import import_torch as it
from ha2g_tpu.config import Config as JaxConfig
from ha2g_tpu.data.vocab import Vocab as JaxVocab
from ha2g_tpu.eval.fgd import EmbeddingSpaceEvaluator as JaxEvaluator
from ha2g_tpu.synthesis import HierarchySynthesizer as JaxSynthesizer
from ha2g_tpu.train.hierarchy import HierarchyState
from ha2g_tpu.train.hierarchy import HierarchySystem as JaxSystem
from tests import torch_mirrors as tm

from ha2g_torch import checkpoint as ckpt
from ha2g_torch import cli
from ha2g_torch import reference_ckpt as rc
from ha2g_torch.config import Config
from ha2g_torch.convert import hierarchy_state
from ha2g_torch.data.vocab import Vocab
from ha2g_torch.eval.fgd import EmbeddingSpaceEvaluator, make_embedder
from ha2g_torch.models.common import init_parameters_
from ha2g_torch.synthesis import make_synthesizer
from ha2g_torch.train.hierarchy import HierarchySystem

N_WORDS, N_SPK, T, HID, NL = 16, 4, 34, 16, 2
# fp32 on both sides: summation order of the convs, products and the
# recurrence, through the level cascade
ATOL = 1e-4
DATASETS = [("ted_gesture", 27), ("ted_expressive", 126)]


def _randomise_stats(sd: dict, rng) -> None:
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                     .astype(np.float32))
        elif k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape)
                                     .astype(np.float32))


def vocabs():
    """(lang, speaker) of the JAX package and of the port, alike."""
    out = []
    for cls in (JaxVocab, Vocab):
        lang = cls("words")
        for i in range(N_WORDS - lang.n_words):
            lang.index_word(f"w{i}")
        speaker = cls("vid", insert_default_tokens=False)
        for i in range(N_SPK - speaker.n_words):
            speaker.index_word(f"s{i}")
        out.append((lang, speaker))
    return out


def port_config(dataset, pose_dim, hidden=HID) -> Config:
    return Config(model="hierarchy", dataset=dataset, pose_dim=pose_dim,
                  n_poses=T, n_pre_poses=4, hidden_size=hidden, n_layers=NL,
                  z_type="speaker")


@functools.cache
def jax_hierarchy(dataset: str, pose_dim: int, seed: int = 0,
                  hidden: int = HID):
    """-> (JAX config, JAX system, its HierarchyState): seeded weights,
    speaker z pinned at mu, random batch-norm statistics."""
    port = HierarchySystem(port_config(dataset, pose_dim, hidden), N_WORDS,
                           N_SPK, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    sd = port.state_dict()
    for level in range(port.spec.n_levels):
        sd[f"gens.{level}.speaker_logvar.weight"].zero_()
        sd[f"gens.{level}.speaker_logvar.bias"].fill_(-100.0)
    _randomise_stats(sd, np.random.default_rng(seed))
    ref = rc.export_hierarchy_checkpoint(sd, port.cfg)
    audio_p, audio_s = it.convert_audio_encoder(ref["audio_dict"])
    dis_p, dis_s = it.convert_discriminator(ref["dis_dict"])
    params = {"audio": audio_p,
              "text": it.convert_text_encoder(ref["text_dict"], NL),
              "gens": tuple(it.convert_generator(ref[f"gen_dict_{l + 1}"], NL)
                            for l in range(port.spec.n_levels)),
              "dis": dis_p}
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, {"audio": audio_s, "dis": dis_s})
    cfg = JaxConfig(**{k: v for k, v in port.cfg.to_dict().items()
                       if k in JaxConfig.__dataclass_fields__})
    system = JaxSystem(cfg, n_words=N_WORDS, n_speakers=N_SPK)
    g_params = {k: params[k] for k in ("audio", "text", "gens")}
    state = HierarchyState(params=params, batch_stats=stats,
                           g_opt=system.g_tx.init(g_params),
                           d_opt=system.d_tx.init(params["dis"]),
                           step=jnp.asarray(7, jnp.int32))
    return cfg, system, state


def jax_state_dict(state, n_layers=NL) -> dict:
    """The port's state dict of a JAX state (ha2g_torch.convert)."""
    return hierarchy_state(jax.device_get(state.params),
                           jax.device_get(state.batch_stats), n_layers)


def clips(B=1, seconds=3.0, seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=(B, int(seconds * 16000))) * 0.1) \
        .astype(np.float32)
    words = [[(f"w{rng.integers(0, 10)}", float(t), float(t + 0.2))
              for t in np.arange(0.2, seconds - 0.3, 0.4)]
             for _ in range(B)]
    return audio, words, rng.integers(0, N_SPK, (B,))


def assert_state_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def _quiet(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(argv)


# ---------------------------------------------------------------------------
# a JAX checkpoint directory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset,pose_dim", DATASETS)
def test_jax_checkpoint_directory_loads_bit_exact_and_generates(
        dataset, pose_dim, tmp_path):
    """``state.msgpack`` (with its optimiser states) decodes to the JAX
    tree; the port's system from the directory holds exactly
    ``convert.hierarchy_state`` of it; ``generate`` from the directory
    matches the JAX package's within 1e-4."""
    cfg, system, state = jax_hierarchy(dataset, pose_dim)
    (jlang, jspeaker), _ = vocabs()
    jckpt.save_checkpoint(tmp_path, state, cfg, jlang, jspeaker,
                          extra={"epoch": 3})
    params, stats = ckpt.read_jax_state(tmp_path)
    _tree_equal(params, jax.device_get(state.params))
    _tree_equal(stats, jax.device_get(state.batch_stats))

    tcfg, lang, speaker, port = cli.load_checkpoint_system(tmp_path, "cpu")
    assert (tcfg.hidden_size, lang.n_words, speaker.n_words) == \
        (HID, N_WORDS, N_SPK)
    assert_state_equal(port.state_dict(), jax_state_dict(state))

    audio, words, vids = clips(seed=1)
    want = JaxSynthesizer(system, state).generate(audio, words, jlang, vids)
    got = make_synthesizer(port, port.state_dict()).generate(
        audio, words, lang, vids)
    assert got.shape == want.shape == (1, T + 30, pose_dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_resume_from_a_jax_checkpoint_raises(tmp_path):
    """A JAX directory's optimiser moments are not carried: resuming from
    one raises, as from a port checkpoint without optimiser state."""
    cfg, _, state = jax_hierarchy("ted_gesture", 27)
    jckpt.save_checkpoint(tmp_path, state, cfg)
    port = HierarchySystem(port_config("ted_gesture", 27), N_WORDS, N_SPK,
                           device="cpu")
    with pytest.raises(ValueError, match="cannot be resumed"):
        ckpt.load_state(tmp_path, port)
    assert ckpt.load_state(tmp_path, port, optimizers=False) == 7


# ---------------------------------------------------------------------------
# reference .bin files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset,pose_dim", DATASETS)
def test_reference_bin_imports_bit_exact(dataset, pose_dim, tmp_path):
    """A ``.bin`` of ``export_torch.save_reference_checkpoint`` imports
    (``cli import-checkpoint``) to the state that ``import_torch`` and
    ``convert`` give, bit for bit; an Expressive hierarchy turns
    ``ref_routing_compat`` on; the vocabularies come across."""
    cfg, _, state = jax_hierarchy(dataset, pose_dim)
    (jlang, jspeaker), _ = vocabs()
    path = tmp_path / "ref.bin"
    et.save_reference_checkpoint(str(path), state, cfg, jlang, jspeaker,
                                 epoch=5)
    assert _quiet(["import-checkpoint", str(path), str(tmp_path / "out"),
                   "--device", "cpu"]) == 0

    want = it.import_hierarchy_checkpoint(
        it.load_reference_checkpoint(str(path)), state, n_layers=NL)
    got = ckpt.read_state(tmp_path / "out")["model"]
    assert_state_equal(got, jax_state_dict(want))
    tcfg, extra = ckpt.load_config(tmp_path / "out")
    assert tcfg.ref_routing_compat == (dataset == "ted_expressive")
    assert extra["epoch"] == 5
    lang, speaker = ckpt.load_vocabs(tmp_path / "out")
    assert lang.word2index == jlang.word2index
    assert speaker.index2word == jspeaker.index2word
    np.testing.assert_array_equal(lang.word_embedding_weights,
                                  jlang.word_embedding_weights)


def test_a_real_reference_pickle_loads(tmp_path):
    """A reference training run pickles ``model.vocab.Vocab`` and an
    argparse Namespace, with ``module.``-prefixed keys after
    DataParallel.  The port reads it without the reference's modules and
    without touching ``sys.modules``."""
    cfg, _, state = jax_hierarchy("ted_gesture", 27)
    ref = et.export_hierarchy_checkpoint(state, cfg, epoch=2)
    ref["audio_dict"] = {f"module.{k}": v
                         for k, v in ref["audio_dict"].items()}
    vocab_mod = types.ModuleType("model.vocab")

    class Vocab_:                                   # the reference's class
        def __init__(self, words, specials):
            self.name = "words"
            self.index2word = dict(enumerate(
                ["<PAD>", "<SOS>", "<EOS>", "<UNK>"] if specials
                else ["<UNK>"]))
            self.word2index = {}
            for w in words:
                self.word2index[w] = len(self.index2word)
                self.index2word[len(self.index2word)] = w
            self.n_words = len(self.index2word)
            self.word_embedding_weights = None

    Vocab_.__module__, Vocab_.__qualname__ = "model.vocab", "Vocab"
    vocab_mod.Vocab = Vocab_
    ref["args"] = argparse.Namespace(**vars(ref["args"]))
    ref["lang_model"] = Vocab_([f"w{i}" for i in range(12)], True)
    ref["speaker_model"] = Vocab_(["s0", "s1", "s2"], False)
    shims = ("model", "model.vocab", "utils", "utils.vocab_utils")
    with pytest.MonkeyPatch.context() as m:
        # (ha2g_tpu.import_torch leaves its shims in sys.modules)
        for name in shims:
            m.delitem(sys.modules, name, raising=False)
        m.setitem(sys.modules, "model", types.ModuleType("model"))
        m.setitem(sys.modules, "model.vocab", vocab_mod)
        torch.save(ref, tmp_path / "real.bin", pickle_module=pickle)
        m.delitem(sys.modules, "model.vocab")
        m.delitem(sys.modules, "model")
        loaded = rc.load_reference_checkpoint(tmp_path / "real.bin")
        assert not set(shims) & set(sys.modules)
    lang = rc.vocab_from_pickled(loaded["lang_model"])
    speaker = rc.vocab_from_pickled(loaded["speaker_model"])
    assert (lang.n_words, lang.insert_default_tokens) == (N_WORDS, True)
    assert (speaker.n_words, speaker.insert_default_tokens) == (N_SPK, False)
    assert lang.get_word_index("w3") == 7
    assert rc.config_from_reference_args(loaded["args"]).hidden_size == HID
    assert_state_equal(rc.import_hierarchy_checkpoint(loaded, 3),
                       jax_state_dict(state))


def test_importing_another_family_raises(tmp_path):
    """A seq2seq reference .bin imports (ROADMAP A.5 is ported); a .bin of
    a family with no generation checkpoint (an FGD embedder's model)
    raises ValueError."""
    cfg, _, state = jax_hierarchy("ted_gesture", 27)
    ref = et.export_hierarchy_checkpoint(state, cfg)
    ref["args"].model = "gesture_autoencoder"
    torch.save(ref, tmp_path / "mm.bin")
    with pytest.raises(ValueError, match="no generic importer"):
        _quiet(["import-checkpoint", str(tmp_path / "mm.bin"),
                str(tmp_path / "out"), "--device", "cpu"])
    from ha2g_torch.train.loop import build_system
    s2s_cfg = port_config("ted_gesture", 27).replace(model="seq2seq",
                                                      wordembed_dim=8)
    system = build_system(s2s_cfg, N_WORDS, N_SPK, device="cpu")
    _, (lang, speaker) = vocabs()
    torch.save(rc.export_generic_checkpoint(system.state_dict(), s2s_cfg,
                                            lang, speaker),
               tmp_path / "s2s.bin")
    assert _quiet(["import-checkpoint", str(tmp_path / "s2s.bin"),
                   str(tmp_path / "s2s"), "--device", "cpu"]) == 0
    got = ckpt.read_state(tmp_path / "s2s")["model"]
    assert all(torch.equal(got[k], v)
               for k, v in system.state_dict().items())


@pytest.mark.parametrize("dataset,pose_dim", DATASETS)
def test_port_export_reads_back_in_jax_and_the_mirrors(dataset, pose_dim,
                                                       tmp_path):
    """``cli export-checkpoint`` of a port checkpoint made from JAX
    parameters: ``import_torch`` gives those parameters back bit for bit,
    and every dict loads strictly into the reference-layout mirrors."""
    cfg, system, state = jax_hierarchy(dataset, pose_dim)
    _, (lang, speaker) = vocabs()
    port = HierarchySystem(port_config(dataset, pose_dim), N_WORDS, N_SPK,
                           device="cpu")
    port.load_state_dict(jax_state_dict(state), strict=True)
    ckpt.save_checkpoint(tmp_path / "port", port, port.cfg, lang, speaker,
                         extra={"epoch": 4})
    out = tmp_path / "port.bin"
    assert _quiet(["export-checkpoint", str(tmp_path / "port"), str(out),
                   "--device", "cpu"]) == 0

    ref = it.load_reference_checkpoint(str(out))
    assert ref["epoch"] == 4 and ref["pose_dim"] == pose_dim
    back = it.import_hierarchy_checkpoint(ref, state, n_layers=NL)
    _tree_equal(jax.device_get(back.params), jax.device_get(state.params))
    _tree_equal(jax.device_get(back.batch_stats),
                jax.device_get(state.batch_stats))
    assert it.vocab_from_pickled(ref["lang_model"]).word2index == \
        lang.word2index

    L = system.spec.n_levels
    for level in range(L):
        tm.TorchHierGenerator(system.spec.level_dim(level), N_WORDS, N_SPK,
                              HID, NL).load_state_dict(
            ref[f"gen_dict_{level + 1}"], strict=True)
    tm.TorchResNetSE(N_SPK, pose_level=L).load_state_dict(
        {k[len("feat_extractor."):]: v
         for k, v in ref["audio_dict"].items()}, strict=True)
    tm.TorchConvDiscriminator(pose_dim).load_state_dict(ref["dis_dict"],
                                                        strict=True)
    tm.TorchTextEncoderTCN(N_WORDS, 300, HID, NL).load_state_dict(
        ref["text_dict"], strict=True)


# ---------------------------------------------------------------------------
# FGD embedders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pose_dim", [27, 126])
def test_embedder_bin_imports_and_embeds_as_jax(pose_dim, tmp_path):
    """A ``.bin`` of ``export_torch.export_evalnet_checkpoint`` (EmbeddingNet
    for 27, MotionAE for 126) through ``cli import-evalnet``: its features
    and reconstructions match the JAX evaluator's within 1e-4, and
    ``cli export-checkpoint`` of the embedder directory gives back the
    same tensors."""
    latent = 32 if pose_dim == 126 else 128
    net = make_embedder(pose_dim, T, latent)
    init_parameters_(net, torch.Generator().manual_seed(pose_dim))
    sd = net.state_dict()
    _randomise_stats(sd, np.random.default_rng(pose_dim))
    ecfg = Config(model="gesture_autoencoder", pose_dim=pose_dim,
                  n_poses=T, latent_dim=latent)
    own = rc.export_embedder_checkpoint(sd, ecfg)
    params, stats = it.convert_motion_ae(own["motion_ae"]) \
        if pose_dim == 126 else it.convert_embedding_net_pose(own["gen_dict"])
    jcfg = JaxConfig(model="gesture_autoencoder", pose_dim=pose_dim,
                     latent_dim=latent)
    jstate = types.SimpleNamespace(params=params, batch_stats=stats)
    torch.save(et.export_evalnet_checkpoint(jstate, jcfg), tmp_path / "e.bin")
    assert _quiet(["import-evalnet", str(tmp_path / "e.bin"),
                   str(tmp_path / "emb"), "--device", "cpu"]) == 0

    ecfg2, state = ckpt.load_embedder(tmp_path / "emb")
    assert (ecfg2.pose_dim, ecfg2.latent_dim) == (pose_dim, latent)
    assert_state_equal(state, {k: v for k, v in sd.items()})
    poses = np.random.default_rng(1).normal(size=(3, T, pose_dim)) \
        .astype(np.float32) * 0.3
    ours = EmbeddingSpaceEvaluator(pose_dim, T, state, latent_dim=latent,
                                   device="cpu")
    theirs = JaxEvaluator(pose_dim, T, jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, stats), latent_dim=latent)
    for got, want in zip(ours._embed(poses),
                         theirs._embed(jnp.asarray(poses))):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)

    assert _quiet(["export-checkpoint", str(tmp_path / "emb"),
                   str(tmp_path / "e2.bin"), "--device", "cpu"]) == 0
    again = rc.load_reference_checkpoint(tmp_path / "e2.bin")
    key = "motion_ae" if pose_dim == 126 else "gen_dict"
    assert_state_equal(again[key], own[key])
