"""Shared set-up of the text and embedding baselines' CPU tests
(tests/test_torch_seq2seq.py, test_torch_joint_embedding.py,
test_torch_text_baselines_cli.py): the same seeded weights in the port and
in the JAX package, fp32, TED Gesture (pose 27) unless the family is the
TED Expressive embedder (MotionAE, pose 126).

Widths: seq2seq at hidden 16 / 2 layers over 10 frames (the JAX package
unrolls its decoder a frame at a time, so its compile time grows with the
frames; chip_smoke.py runs the shipped 34); the joint embedding's widths
are fixed by the JAX package (TCN 300 x 4, GRU(256) x 2, decoder
bi-GRU(300) x 4), only the word embedding is narrowed (16).  The JAX states
are built without ``system.init``: the port's seeded weights go through
the reference's layout (``ha2g_torch.reference_ckpt``) and the JAX
package's own importers (``ha2g_tpu.import_torch.convert_*``); each
system keeps its own optimiser (``system.tx``), and the gradient its Adam
was given is read back from Adam's first moment (``recorded_grads``).
Randomness is frozen: dropout 0 where the config
reaches it (``dropout_prob``), the port's hard-coded rates set to 0
(``freeze``; the JAX side's are patched in the tests that need it), the
context encoder's variational noise pinned by a logvar head of weight 0
and bias -60 (std e^-30), and the batch-norm running statistics
randomised.
"""

from __future__ import annotations

import functools
from pathlib import Path

import flax.linen as flax_nn
import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from ha2g_tpu import import_torch as it
from ha2g_tpu.train.baselines import EmbedSystem as JaxEmbed
from ha2g_tpu.train.baselines import MotionAESystem as JaxMotionAE
from ha2g_tpu.train.baselines import Seq2SeqSystem as JaxSeq2Seq
from ha2g_tpu.train.baselines import TrainState
from tests.torch_baselines import AUDIO_LEN, N_SPK, N_WORDS, jax_config
from tests.torch_train_parity import compare_step

from ha2g_torch import reference_ckpt as rc
from ha2g_torch.config import Config
from ha2g_torch.convert import system_state
from ha2g_torch.train.loop import build_system

B, T, HID, NL, EMBED = 4, 34, 16, 2, 16
S2S, JE, AE, MAE = "seq2seq", "joint_embedding", "gesture_autoencoder", \
    "motion_ae"
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {S2S: ROOT / "configs" / "seq2seq.yaml",
           JE: ROOT / "configs" / "joint_embed.yaml",
           AE: ROOT / "configs" / "gesture_autoencoder.yaml",
           MAE: ROOT / "configs_expressive" / "gesture_autoencoder.yaml"}
# seq2seq's frames: 9 decoder steps, the first 4 fed teacher frames
S2S_POSES = 10
# the word sequences' width (the windows' and the synthesizer's)
WORD_SEQ = 32
# the loss terms of one train step, relative
METRIC_RTOL = 1e-5
# Adam's second moments after one step, nu = (1 - beta2) g^2, summed over
# the leaves held at GRAD_REL (1e-4 relative L2): the sum of squares is
# then within twice that.  A beta2 other than the port's moves the sum by
# the factor (1 - beta2') / (1 - beta2).
NU_RTOL = 2e-4
# the logvar bias that pins the context encoder's z at mu
LOGVAR_BIAS = -60.0


def port_config(family: str) -> Config:
    return Config.from_yaml(CONFIGS[family], hidden_size=HID, n_layers=NL,
                            dropout_prob=0.0, wordembed_dim=EMBED,
                            compute_dtype="float32", eval_net_path="",
                            n_poses=n_poses(family))


def pose_dim(family: str) -> int:
    return 126 if family == MAE else 27


def n_poses(family: str) -> int:
    return S2S_POSES if family == S2S else T


def no_flax_dropout(monkeypatch) -> None:
    """flax's Dropout as the identity: the JAX joint embedding hard-codes
    its decoder GRU's 0.3 and its TCN's 0.3 / 0.1."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def freeze(system) -> None:
    """Dropout 0 where the config does not reach: the joint embedding's
    context TCN (0.3, embedding 0.1) and decoder GRU (0.3)."""
    if system.cfg.model == JE:
        tcn = system.context_encoder.text_encoder
        tcn.emb_dropout = 0.0
        for block in tcn.tcn.network:
            block.dropout = 0.0
        system.decoder.gru.dropout = 0.0


def _port_weights(family: str, seed: int) -> dict:
    port = build_system(port_config(family), N_WORDS, N_SPK, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    if family == JE:
        sd["context_encoder.fc_logvar.weight"].zero_()
        sd["context_encoder.fc_logvar.bias"].fill_(LOGVAR_BIAS)
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                     .astype(np.float32))
        elif k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape)
                                     .astype(np.float32))
    return sd


def jax_tree(family: str, sd: dict, cfg: Config):
    """The port's state dict -> the JAX (params, batch_stats), through the
    reference's layout and ha2g_tpu.import_torch."""
    if family in (AE, MAE):
        ref = rc.export_embedder_checkpoint(sd, cfg)
        return it.convert_motion_ae(ref["motion_ae"]) if family == MAE \
            else it.convert_embedding_net_pose(ref["gen_dict"])
    gen = rc.export_generic_checkpoint(sd, cfg)["gen_dict"]
    return it.convert_seq2seq(gen, NL) if family == S2S \
        else it.convert_embedding_net_full(gen)


@functools.cache
def jax_setup(family: str, seed: int = 0):
    """-> (JAX system, its TrainState with the system's own optimiser state
    fresh from ``tx.init``, the port's state dict of the same weights)."""
    cfg = port_config(family)
    sd = _port_weights(family, seed)
    params, stats = jax_tree(family, sd, cfg)
    jcfg = jax_config(cfg)
    if family == S2S:
        system = JaxSeq2Seq(jcfg, n_words=N_WORDS)
    elif family == MAE:
        system = JaxMotionAE(jcfg)
    else:
        system = JaxEmbed(jcfg, n_words=N_WORDS)
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    state = TrainState(params=params, batch_stats=stats,
                       opt=jax.jit(system.tx.init)(params),
                       step=jnp.asarray(3, jnp.int32))
    return system, state, sd


def adam_moments(opt_state):
    """(mu, nu) of the Adam inside a JAX optimiser state."""
    def is_adam(s):
        return isinstance(s, optax.ScaleByAdamState)
    (adam,) = [s for s in jax.tree.leaves(opt_state, is_leaf=is_adam)
               if is_adam(s)]
    return adam.mu, adam.nu


def recorded_grads(opt_state, port):
    """The gradient tree the JAX step's Adam was given (seq2seq: after its
    clip), from Adam's first moment one step from zero, mu = (1 - beta1) g,
    at the port's beta1: a JAX beta1 other than the port's shows as every
    gradient off by one factor."""
    beta1 = np.float32(1.0 - port.opt.param_groups[0]["betas"][0])
    return jax.tree.map(lambda m: np.asarray(m) / beta1,
                        adam_moments(opt_state)[0])


def compare_second_moments(family: str, port, new_state,
                           skip: tuple = ()) -> None:
    """The port's Adam second moments after its one step against the JAX
    step's, summed over every leaf but those named or prefixed in
    ``skip`` (zero true gradients, looser gradient bounds).  A leaf the
    step gave no gradient has no Adam state in torch, zero in optax."""
    want = numpy_state(family, adam_moments(new_state.opt)[1],
                       new_state.batch_stats)
    have_sum = want_sum = 0.0
    for key, p in port.named_parameters():
        if key.startswith(skip):
            continue
        if p in port.opt.state:
            have_sum += float(port.opt.state[p]["exp_avg_sq"].double().sum())
        want_sum += float(want[key].astype(np.float64).sum())
    assert want_sum > 0
    assert abs(have_sum / want_sum - 1.0) <= NU_RTOL, have_sum / want_sum


def port_system(family: str, seed: int = 0):
    """The port's system on the CPU with ``jax_setup``'s weights."""
    _, _, sd = jax_setup(family, seed)
    port = build_system(port_config(family), N_WORDS, N_SPK, device="cpu")
    port.load_state_dict(sd, strict=True)
    freeze(port)
    return port


def numpy_state(family: str, params, stats) -> dict[str, np.ndarray]:
    model = AE if family == MAE else family
    sd = system_state(model, jax.device_get(params), jax.device_get(stats),
                      NL)
    return {k: v.numpy() for k, v in sd.items()}


def word_seqs(rng, n: int, lengths=None):
    """(n, 32) SOS..EOS-shaped token rows zero-padded past their length
    (drawn in [2, 32] unless given) and the lengths."""
    if lengths is None:
        lengths = rng.integers(2, WORD_SEQ + 1, n)
    lengths = np.asarray(lengths, np.int32)
    seq = np.zeros((n, WORD_SEQ), np.int32)
    for b, n_tok in enumerate(lengths):
        seq[b, :n_tok] = rng.integers(4, N_WORDS, n_tok)
        seq[b, 0], seq[b, n_tok - 1] = 1, 2
    return seq, lengths


def train_batch(family: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    seq, lengths = word_seqs(rng, B, [WORD_SEQ, 2] + list(
        rng.integers(2, WORD_SEQ + 1, B - 2)))
    T = n_poses(family)
    return {
        "word_seq": seq, "word_lengths": lengths,
        "text": rng.integers(0, N_WORDS, (B, T)).astype(np.int32),
        "audio": (rng.normal(size=(B, AUDIO_LEN)) * 0.1).astype(np.float32),
        "target": (rng.normal(size=(B, T, pose_dim(family))) * 0.2)
        .astype(np.float32),
        "vids": rng.integers(0, N_SPK, (B,)).astype(np.int32)}


def zero_grad_leaves(family: str) -> tuple[str, ...]:
    """Biases right before a train-mode batch norm (zero true gradient)."""
    def encoder(prefix):
        return tuple(f"{prefix}.net.{i}.0.bias" for i in range(3)) + (
            f"{prefix}.out_net.0.bias", f"{prefix}.out_net.3.bias")
    conv_decoder = ("decoder.pre_net.0.bias", "decoder.net.0.bias",
                    "decoder.net.3.bias")
    if family == S2S:
        return ("decoder.decoder.pre_linear.0.bias",)
    if family == MAE:
        return encoder("encoder") + conv_decoder
    if family == AE:
        return encoder("pose_encoder") + conv_decoder
    return encoder("pose_encoder") + tuple(
        f"context_encoder.audio_encoder.feat_extractor.{i}.bias"
        for i in (0, 3, 6)) + ("context_encoder.out.0.bias",
                               "decoder.pre_pose_net.0.bias")


def compare_train_step(family: str, port, old: dict, got: dict,
                       metrics: dict, new_state, lr: float,
                       loose: tuple = ()) -> None:
    """One port train step (``got``; ``old`` its state dict before) against
    the JAX system's own step (``metrics``, ``new_state``): the loss terms
    within METRIC_RTOL, then ``compare_step`` on the gradient the JAX
    Adam was given, and the Adam second moments.  Leaves under a ``loose``
    prefix take the audio encoder's gradient bounds."""
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    want_grads = numpy_state(family, recorded_grads(new_state.opt, port),
                             new_state.batch_stats)
    compare_step(got, metrics, port, old, want_grads,
                 numpy_state(family, new_state.params,
                             new_state.batch_stats),
                 lr=lr, d_lr=lr, loose=loose,
                 zero_grad=zero_grad_leaves(family))
    compare_second_moments(family, port, new_state,
                           zero_grad_leaves(family) + loose)
