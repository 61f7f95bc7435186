"""Shared set-up of the GAN baselines' CPU tests (tests/test_torch_
multimodal.py, test_torch_speech2gesture.py, test_torch_baselines_cli.py):
the same seeded weights in the port and in the JAX package, at a narrow
width (hidden 16, 2 GRU layers, TED Gesture), fp32.

The JAX states are built without ``system.init``: the port's seeded
weights go through the JAX package's own importers
(``ha2g_tpu.import_torch.convert_*``, by way of the reference's generic
checkpoint layout) into its tree layout, and the optimiser states come from
``optax`` directly.  Randomness is frozen as in tests/torch_train_parity.py:
dropout 0 (the GRUs, the TCN and its fixed 0.1 embedding dropout, the
discriminator's GRU), speaker z pinned at mu (logvar kernel 0, bias -100),
and the batch-norm running statistics randomised.  The JAX optimisers keep
the gradient tree they were given (``_record_grads``).  The loss weights
and learning rates are the shipped configs' (configs/*.yaml).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from ha2g_tpu import import_torch as it
from ha2g_tpu.config import Config as JaxConfig
from ha2g_tpu.data.vocab import Vocab as JaxVocab
from ha2g_tpu.models.hierarchy import ConvDiscriminator as JaxConvDis
from ha2g_tpu.train.baselines import GanState
from ha2g_tpu.train.baselines import MultimodalGanSystem as JaxMultimodal
from ha2g_tpu.train.baselines import S2GSystem as JaxS2G
from tests.torch_train_parity import _record_grads

from ha2g_torch import reference_ckpt as rc
from ha2g_torch.config import Config
from ha2g_torch.convert import multimodal_state, speech2gesture_state
from ha2g_torch.data.vocab import Vocab
from ha2g_torch.train.loop import build_system

N_WORDS, N_SPK, B, T, HID, NL = 16, 4, 4, 34, 16, 2
MM, S2G = "multimodal_context", "speech2gesture"
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {MM: ROOT / "configs" / "multimodal_context.yaml",
           S2G: ROOT / "configs" / "speech2gesture.yaml"}
AUDIO_LEN = 36267       # round(34 / 15 * 16000), the train windows'
SPEC_LEN = 70


def port_config(model: str) -> Config:
    return Config.from_yaml(CONFIGS[model], hidden_size=HID, n_layers=NL,
                            dropout_prob=0.0, compute_dtype="float32",
                            eval_net_path="")


def jax_config(cfg: Config) -> JaxConfig:
    return JaxConfig(**{k: v for k, v in cfg.to_dict().items()
                        if k in JaxConfig.__dataclass_fields__})


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


def converter(model: str):
    return multimodal_state if model == MM else speech2gesture_state


def freeze(system) -> None:
    """Dropout 0 everywhere the config does not reach."""
    if system.cfg.model == MM:
        system.gen.text_encoder.emb_dropout = 0.0
        system.dis.gru.dropout = 0.0


def _port_weights(model: str, seed: int) -> dict:
    cfg = port_config(model)
    port = build_system(cfg, N_WORDS, N_SPK, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    if model == MM:
        sd["gen.speaker_logvar.weight"].zero_()
        sd["gen.speaker_logvar.bias"].fill_(-100.0)
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                     .astype(np.float32))
        elif k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape)
                                     .astype(np.float32))
    return sd


@functools.cache
def jax_setup(model: str, seed: int = 0):
    """-> (JAX system, its GanState, the port's state dict of the same
    weights).  The JAX side is functional, so tests share it."""
    cfg = port_config(model)
    sd = _port_weights(model, seed)
    ref = rc.export_generic_checkpoint(sd, cfg)
    jcfg = jax_config(cfg)
    if model == MM:
        gen_p, gen_s = it.convert_multimodal_generator(ref["gen_dict"], NL)
        dis_p, dis_s = it.convert_discriminator(ref["dis_dict"])
        system = JaxMultimodal(jcfg, n_words=N_WORDS, n_speakers=N_SPK)
        system.gen = system.gen.clone(emb_dropout=0.0)
        system.dis = JaxConvDis(slope=1.0, dropout=0.0)
    else:
        gen_p, gen_s = it.convert_s2g_generator(ref["gen_dict"])
        dis_p, dis_s = it.convert_s2g_discriminator(ref["dis_dict"])
        system = JaxS2G(jcfg)
    system.g_tx = optax.chain(_record_grads(), system.g_tx)
    system.d_tx = optax.chain(_record_grads(), system.d_tx)
    params = jax.tree.map(jnp.asarray, {"gen": gen_p, "dis": dis_p})
    stats = jax.tree.map(jnp.asarray, {"gen": gen_s, "dis": dis_s})
    state = GanState(params=params, batch_stats=stats,
                     g_opt=system.g_tx.init(params["gen"]),
                     d_opt=system.d_tx.init(params["dis"]),
                     step=jnp.asarray(3, jnp.int32))
    return system, state, sd


def port_system(model: str, seed: int = 0):
    """The port's system on the CPU with ``jax_setup``'s weights."""
    _, _, sd = jax_setup(model, seed)
    port = build_system(port_config(model), N_WORDS, N_SPK, device="cpu")
    port.load_state_dict(sd, strict=True)
    freeze(port)
    return port


def train_batch(seed: int = 0, pose_dim: int = 27) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "text": rng.integers(0, N_WORDS, (B, T)).astype(np.int32),
        "audio": (rng.normal(size=(B, AUDIO_LEN)) * 0.1).astype(np.float32),
        "spec": rng.normal(size=(B, 128, SPEC_LEN)).astype(np.float32),
        "target": (rng.normal(size=(B, T, pose_dim)) * 0.2)
        .astype(np.float32),
        "vids": rng.integers(0, N_SPK, (B,)).astype(np.int32)}


def numpy_state(model: str, params, stats) -> dict[str, np.ndarray]:
    sd = converter(model)(jax.device_get(params), jax.device_get(stats))
    return {k: v.numpy() for k, v in sd.items()}


def clips(B=1, seconds=6.1, seed=0):
    """Audio of ``seconds`` (6.1 s: three windows, the last one padded)
    and words every 0.4 s."""
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=(B, int(seconds * 16000))) * 0.1) \
        .astype(np.float32)
    words = [[(f"w{rng.integers(0, 10)}", float(t), float(t + 0.2))
              for t in np.arange(0.2, seconds - 0.3, 0.4)]
             for _ in range(B)]
    return audio, words, rng.integers(0, N_SPK, (B,))
