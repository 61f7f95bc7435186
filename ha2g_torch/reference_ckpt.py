"""Checkpoints of the reference PyTorch code (``.bin`` files), both ways,
for the hierarchy, the baselines (multimodal_context, speech2gesture,
seq2seq, joint_embedding) and the FGD embedders.

The port's copy of those parts of ``ha2g_tpu/import_torch.py`` (loading,
``vocab_from_pickled``, ``config_from_reference_args``,
``import_hierarchy_checkpoint``, ``import_generic_checkpoint``) and
``ha2g_tpu/export_torch.py`` (``export_hierarchy_checkpoint``,
``export_generic_checkpoint``, ``export_evalnet_checkpoint``,
``_vocab_namespace``, ``_args_namespace``).

A reference checkpoint is a ``torch.save`` dict (reference train.py:232-243):
``args`` (an argparse Namespace), ``epoch``, ``lang_model`` /
``speaker_model`` (pickled ``model.vocab.Vocab`` objects), ``pose_dim``,
``gen_dict_1`` .. ``gen_dict_L``, ``audio_dict``, ``text_dict`` and
``dis_dict``.  The port's state dict already uses the reference's key
names, so the weights move by prefix alone: ``audio_dict`` <-> ``audio.``,
``text_dict`` <-> ``text.``, ``dis_dict`` <-> ``dis.``, ``gen_dict_{l}``
<-> ``gens.{l-1}.``; a leading ``module.`` (DataParallel) is stripped.
A baseline's generic checkpoint (train.py:239-244, loaded by
train_utils.py:197-213) holds ``args``, ``epoch``, ``lang_model``,
``speaker_model``, ``pose_dim`` and, for a GAN baseline, ``gen_dict`` <->
``gen.`` and ``dis_dict`` <-> ``dis.``; seq2seq and joint_embedding
have no discriminator, and their ``gen_dict`` is the port's whole state
dict (the port's copy of ``import_torch.convert_seq2seq`` /
``convert_embedding_net_full`` and their exporters: the keys match, so
the move is the identity).
An FGD embedder's file holds ``gen_dict`` (EmbeddingNet, pose_dim 27) or
``motion_ae`` and ``latent_dim`` (MotionAE, pose_dim 126).

What the port writes holds only torch tensors, numpy arrays and
``types.SimpleNamespace`` objects, so the reference code loads it with
torch and numpy alone.
"""

from __future__ import annotations

import dataclasses
import pickle
import types
from typing import Any, Optional

import numpy as np
import torch

from ha2g_torch.config import Config
from ha2g_torch.data.vocab import SOS_TOKEN, Vocab

# modules whose pickled ``Vocab`` the reference's checkpoints name
_VOCAB_MODULES = ("model.vocab", "utils.vocab_utils")


class _VocabShim:
    """Stand-in for the reference's ``Vocab`` while unpickling: keeps the
    attributes, needs none of the reference's code."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _VOCAB_MODULES and name == "Vocab":
            return _VocabShim
        return super().find_class(module, name)


# the ``pickle_module`` torch.load unpickles with
_PICKLE = types.SimpleNamespace(Unpickler=_Unpickler, load=pickle.load,
                                __name__="ha2g_torch.reference_ckpt")


def load_reference_checkpoint(path) -> dict:
    """``torch.load`` a reference ``.bin`` onto the CPU, its pickled
    ``Vocab`` objects read into attribute bags (no module of the reference
    is needed, and ``sys.modules`` is left as it is)."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PICKLE)


def _strip_module_prefix(sd: dict) -> dict:
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def vocab_from_pickled(obj) -> Vocab:
    """The port's Vocab from a pickled reference Vocab's attributes
    (word2index / index2word / n_words / word_embedding_weights)."""
    index2word = {int(k): w for k, w in obj.index2word.items()}
    word2index = dict(obj.word2index)
    v = Vocab(getattr(obj, "name", "words"),
              insert_default_tokens="<SOS>" in word2index
              or index2word.get(SOS_TOKEN) == "<SOS>")
    v.word2index = word2index
    v.index2word = index2word
    v.word2count = dict(getattr(obj, "word2count", {}))
    v.n_words = int(obj.n_words)
    wev = getattr(obj, "word_embedding_weights", None)
    if wev is not None:
        v.word_embedding_weights = np.asarray(wev, np.float32)
    return v


def config_from_reference_args(args_obj) -> Config:
    """The reference's embedded argparse Namespace (train_utils.py:172) as
    the port's Config; an Expressive hierarchy turns on
    ``ref_routing_compat`` (the reference's pre-seq head-fill layout)."""
    d = dict(args_obj) if isinstance(args_obj, dict) else dict(vars(args_obj))
    d.setdefault("model", "hierarchy")
    d["dataset"] = "ted_expressive" if d.get("pose_dim") == 126 \
        else "ted_gesture"
    for k in ("mean_dir_vec", "mean_pose"):
        if d.get(k) is not None:
            d[k] = [float(x) for x in np.asarray(d[k], np.float32).ravel()]
    for k in ("train_data_path", "val_data_path", "test_data_path"):
        if isinstance(d.get(k), list):
            d[k] = d[k][0] if d[k] else ""
    if d["model"] == "hierarchy" and d["dataset"] == "ted_expressive":
        d["ref_routing_compat"] = True
    return Config.from_dict(d)


def _prefixes(n_levels: int) -> list[tuple[str, str]]:
    """(reference dict, port prefix) pairs of a hierarchy checkpoint."""
    return [("audio_dict", "audio."), ("text_dict", "text."),
            ("dis_dict", "dis.")] + \
        [(f"gen_dict_{level + 1}", f"gens.{level}.")
         for level in range(n_levels)]


# (reference dict, port prefix) pairs of a baseline's generic checkpoint
GENERIC_PREFIXES = {"multimodal_context": [("gen_dict", "gen."),
                                           ("dis_dict", "dis.")],
                    "speech2gesture": [("gen_dict", "gen."),
                                       ("dis_dict", "dis.")],
                    "seq2seq": [("gen_dict", "")],
                    "joint_embedding": [("gen_dict", "")]}
GENERIC_FAMILIES = tuple(GENERIC_PREFIXES)


def _tensor(v) -> torch.Tensor:
    t = torch.as_tensor(v).detach().cpu()
    return (t.float() if t.is_floating_point() else t).contiguous().clone()


def _import(ckpt: dict, prefixes) -> dict:
    return {prefix + k: _tensor(v) for name, prefix in prefixes
            for k, v in _strip_module_prefix(ckpt[name]).items()}


def import_hierarchy_checkpoint(ckpt: dict, n_levels: int) -> dict:
    """A reference hierarchy checkpoint dict -> the port's state dict, for
    ``load_state_dict(strict=True)``."""
    return _import(ckpt, _prefixes(n_levels))


def import_generic_checkpoint(ckpt: dict, cfg: Config) -> dict:
    """A reference generic checkpoint dict of a baseline -> the port's
    state dict (a GAN baseline's ``gen.*``, ``dis.*``; seq2seq's and
    joint_embedding's ``gen_dict`` keys as they are).  Another family
    raises ValueError."""
    if cfg.model not in GENERIC_FAMILIES:
        raise ValueError(f"no generic importer for model {cfg.model!r} "
                         f"(the generic families: {GENERIC_FAMILIES})")
    return _import(ckpt, GENERIC_PREFIXES[cfg.model])


def import_checkpoint(ckpt: dict, cfg: Config) -> dict:
    """A reference checkpoint of ``cfg.model`` -> the port's state dict."""
    if cfg.model == "hierarchy":
        return import_hierarchy_checkpoint(ckpt, cfg.skeleton.n_levels)
    return import_generic_checkpoint(ckpt, cfg)


def import_embedder_checkpoint(ckpt: dict) -> tuple[int, int, dict]:
    """A reference FGD embedder checkpoint -> (pose_dim, latent_dim, state
    dict of the port's ``eval.fgd.make_embedder`` net)."""
    pose_dim = int(ckpt["pose_dim"])
    if pose_dim == 126:
        latent_dim, sd = int(ckpt.get("latent_dim", 128)), ckpt["motion_ae"]
    else:
        latent_dim, sd = 128, ckpt["gen_dict"]
    return pose_dim, latent_dim, {k: _tensor(v) for k, v in
                                  _strip_module_prefix(sd).items()}


def _vocab_namespace(vocab: Optional[Vocab]):
    """Duck type of the reference's ``model.vocab.Vocab``: the attributes
    its synthesize and train code read (vocab.py:8-84)."""
    if vocab is None:
        return None
    return types.SimpleNamespace(
        name=vocab.name, word2index=dict(vocab.word2index),
        word2count=dict(vocab.word2count), index2word=dict(vocab.index2word),
        n_words=vocab.n_words,
        word_embedding_weights=(
            None if vocab.word_embedding_weights is None
            else np.asarray(vocab.word_embedding_weights)))


def _args_namespace(cfg: Config) -> types.SimpleNamespace:
    """The Config as the reference's args Namespace (the field names follow
    parse_args.py; ``config_from_reference_args`` inverts it)."""
    d = dataclasses.asdict(cfg)
    for k in ("train_data_path", "val_data_path", "test_data_path"):
        if isinstance(d.get(k), str):
            d[k] = [d[k]]     # the reference keeps these as lists
    return types.SimpleNamespace(**d)


def export_hierarchy_checkpoint(state: dict, cfg: Config,
                                lang: Optional[Vocab] = None,
                                speaker: Optional[Vocab] = None,
                                epoch: int = 0) -> dict:
    """The port's hierarchy state dict -> the reference's checkpoint dict
    (train.py:232-243 / train_expressive.py:298-304)."""
    return _export(state, cfg, lang, speaker, epoch,
                   _prefixes(cfg.skeleton.n_levels))


def export_generic_checkpoint(state: dict, cfg: Config,
                              lang: Optional[Vocab] = None,
                              speaker: Optional[Vocab] = None,
                              epoch: int = 0) -> dict:
    """The port's state dict of a baseline -> the reference's generic
    checkpoint dict {args, epoch, lang_model, speaker_model, pose_dim,
    gen_dict[, dis_dict]} (train.py:239-244)."""
    if cfg.model not in GENERIC_FAMILIES:
        raise ValueError(f"no generic exporter for model {cfg.model!r}")
    return _export(state, cfg, lang, speaker, epoch,
                   GENERIC_PREFIXES[cfg.model])


def export_checkpoint(state: dict, cfg: Config,
                      lang: Optional[Vocab] = None,
                      speaker: Optional[Vocab] = None,
                      epoch: int = 0) -> dict:
    """The port's state dict of ``cfg.model`` -> the reference's dict."""
    export = export_hierarchy_checkpoint if cfg.model == "hierarchy" \
        else export_generic_checkpoint
    return export(state, cfg, lang, speaker, epoch)


def _export(state: dict, cfg: Config, lang, speaker, epoch: int,
            prefixes) -> dict:
    ckpt: dict[str, Any] = {
        "args": _args_namespace(cfg), "epoch": int(epoch),
        "lang_model": _vocab_namespace(lang),
        "speaker_model": _vocab_namespace(speaker),
        "pose_dim": int(cfg.pose_dim)}
    taken = 0
    for name, prefix in prefixes:
        ckpt[name] = {k[len(prefix):]: _tensor(v) for k, v in state.items()
                      if k.startswith(prefix)}
        taken += len(ckpt[name])
    if taken != len(state):
        raise ValueError(f"{len(state) - taken} keys of the state dict map "
                         "to no reference dict")
    return ckpt


def export_embedder_checkpoint(state: dict, cfg: Config,
                               epoch: int = 0) -> dict:
    """An FGD embedder's state dict -> the reference's evaluator layout
    (embedding_space_evaluator.py:27-34)."""
    ckpt = {"args": _args_namespace(cfg), "epoch": int(epoch),
            "pose_dim": int(cfg.pose_dim)}
    sd = {k: _tensor(v) for k, v in state.items()}
    if cfg.pose_dim == 126:
        ckpt["motion_ae"] = sd
        ckpt["latent_dim"] = int(cfg.latent_dim)
    else:
        ckpt["gen_dict"] = sd
    return ckpt
