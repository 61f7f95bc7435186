"""Checkpoints (the port of ha2g_tpu/checkpoint.py).

A checkpoint is a directory:

  state.pt      ``torch.save`` of {"model": the system's state dict,
                "g_opt" / "d_opt": both Adam optimisers' state dicts of
                a GAN system, or "opt": the one of a single-optimiser
                system (seq2seq, joint_embedding, gesture_autoencoder;
                unless ``save_optimizer_state`` is off), "step": train
                steps taken}; every tensor on the CPU;
  config.json   {"config": the Config, "extra": epoch, val metrics ...},
                the JAX package's layout;
  lang_vocab.json / speaker_vocab.json   the vocabularies, in the JAX
                package's schema;
  word_vectors.npy   the word-embedding table, when there is one.

A run on several processes writes the same files: the trainer gathers an
FSDP-sharded state whole on every rank and rank 0 alone calls
``save_checkpoint`` (``train/loop.py``), so a checkpoint resumes on any
number of processes.

``load_state`` reads ``state.pt`` with ``weights_only=True`` into a freshly
built system with strict keys, and restores parameters, batch-norm
statistics and Adam moments exactly.  It also reads a checkpoint directory
of the JAX package (ha2g_tpu/checkpoint.py), whose ``state.msgpack`` holds
the training state tree (a hierarchy's ``HierarchyState``, a GAN
baseline's ``GanState`` {gen, dis}, another family's ``TrainState``):
``read_jax_state`` decodes its
parameters and batch-norm statistics (``utils/msgpack.py``), and
``convert.system_state`` maps them onto the port's keys.  Its optimiser
moments are not carried, so such a checkpoint serves and evaluates but
does not resume.  An FGD
embedder is saved the same way by ``save_embedder`` (model only, with a
config whose model is ``gesture_autoencoder``), and read by
``load_embedder``; a trained gesture_autoencoder's checkpoint is one too
(its system's state dict is the embedder's), port or JAX.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ha2g_torch.config import Config
from ha2g_torch.convert import system_state
from ha2g_torch.data.vocab import Vocab
from ha2g_torch.utils.msgpack import unpackb

STATE = "state.pt"
JAX_STATE = "state.msgpack"


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _optimizers(system) -> dict[str, Any]:
    """The system's optimisers by checkpoint key: ``opt`` of a
    single-optimiser system, else ``g_opt`` and ``d_opt``."""
    if hasattr(system, "opt"):
        return {"opt": system.opt}
    return {"g_opt": system.g_opt, "d_opt": system.d_opt}


def _write_meta(path: Path, cfg: Config, extra: Optional[dict]) -> None:
    meta = {"config": cfg.to_dict(), "extra": extra or {}}
    (path / "config.json").write_text(json.dumps(meta, default=float))


def save_checkpoint(path, system, cfg: Config, lang: Optional[Vocab] = None,
                    speaker: Optional[Vocab] = None,
                    extra: Optional[dict] = None, step: int = 0) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state: dict[str, Any] = {"model": _cpu(system.state_dict()),
                             "step": int(step)}
    if cfg.save_optimizer_state:
        for key, opt in _optimizers(system).items():
            state[key] = _cpu(opt.state_dict())
    torch.save(state, path / STATE)
    _write_meta(path, cfg, extra)
    if lang is not None:
        lang.save(path / "lang_vocab.json")
        if lang.word_embedding_weights is not None:
            np.save(path / "word_vectors.npy", lang.word_embedding_weights)
    if speaker is not None:
        speaker.save(path / "speaker_vocab.json")


def read_state(path) -> dict[str, Any]:
    return torch.load(Path(path) / STATE, map_location="cpu",
                      weights_only=True)


def _jax_state(tree: dict) -> tuple[dict, dict]:
    params = dict(tree["params"])
    if "gens" in params:        # a hierarchy's level tuple
        gens = params["gens"]
        params["gens"] = [gens[str(i)] for i in range(len(gens))]
    return params, tree["batch_stats"]


def _read_jax_tree(path) -> dict:
    return unpackb((Path(path) / JAX_STATE).read_bytes())


def read_jax_state(path) -> tuple[dict, dict]:
    """-> (params, batch_stats) of a JAX checkpoint directory as numpy
    trees (a hierarchy's ``params["gens"]`` a list by level), the layout
    ``convert.system_state`` takes."""
    return _jax_state(_read_jax_tree(path))


def load_state(path, system, optimizers: bool = True) -> int:
    """Restore a checkpoint into ``system`` (strict keys) and, with
    ``optimizers``, its Adam optimisers.  Returns the step count.  A JAX
    checkpoint directory loads its parameters and batch-norm statistics;
    with ``optimizers`` it raises."""
    path = Path(path)
    if not (path / STATE).exists() and (path / JAX_STATE).exists():
        if optimizers:
            raise ValueError(f"{path} is a JAX checkpoint: its optimiser "
                             "state is not carried to the port, so it "
                             "cannot be resumed")
        tree = _read_jax_tree(path)
        params, stats = _jax_state(tree)
        system.load_state_dict(system_state(system.cfg.model, params, stats,
                                            system.cfg.n_layers),
                               strict=True)
        return int(np.asarray(tree["step"]))
    state = read_state(path)
    system.load_state_dict(state["model"], strict=True)
    if optimizers:
        opts = _optimizers(system)
        if not set(opts) <= set(state):
            raise ValueError(f"{path} holds no optimiser state "
                             f"{sorted(opts)} (saved with "
                             "save_optimizer_state off, or by another "
                             "family)")
        for key, opt in opts.items():
            opt.load_state_dict(state[key])
    return int(state["step"])


def load_config(path) -> tuple[Config, dict]:
    meta = json.loads((Path(path) / "config.json").read_text())
    return Config.from_dict(meta["config"]), meta.get("extra", {})


def load_vocabs(path) -> tuple[Optional[Vocab], Optional[Vocab]]:
    path = Path(path)
    lang = speaker = None
    if (path / "lang_vocab.json").exists():
        lang = Vocab.load(path / "lang_vocab.json")
        if (path / "word_vectors.npy").exists():
            lang.word_embedding_weights = np.load(path / "word_vectors.npy")
    if (path / "speaker_vocab.json").exists():
        speaker = Vocab.load(path / "speaker_vocab.json")
    return lang, speaker


def save_embedder(path, net: torch.nn.Module, cfg: Config) -> None:
    """An FGD embedder (EmbeddingNet in pose mode or MotionAE) as a
    checkpoint that ``eval_net_path`` can name: its state dict, and a
    config with model ``gesture_autoencoder``, its pose_dim, n_poses and
    latent_dim."""
    if cfg.model != "gesture_autoencoder":
        raise ValueError(f"an embedder's config has model "
                         f"'gesture_autoencoder', not {cfg.model!r}")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"model": _cpu(net.state_dict()), "step": 0}, path / STATE)
    _write_meta(path, cfg, None)


def load_embedder(path) -> tuple[Config, dict[str, torch.Tensor]]:
    """-> (the embedder's Config, its state dict) of an embedder directory
    or a trained gesture_autoencoder's checkpoint (the port's or the JAX
    package's)."""
    cfg, _ = load_config(path)
    if cfg.model != "gesture_autoencoder":
        raise ValueError(f"{path} is a {cfg.model!r} checkpoint, not an "
                         "embedder")
    if not (Path(path) / STATE).exists() and (Path(path) / JAX_STATE).exists():
        params, stats = read_jax_state(path)
        return cfg, system_state(cfg.model, params, stats, cfg.n_layers)
    return cfg, read_state(path)["model"]
