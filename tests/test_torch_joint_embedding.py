"""The joint-embedding baseline of the port against the JAX package on the
CPU in fp32, with the weights and frozen randomness of
tests/torch_text_baselines.py (the joint embedding's widths are the JAX
package's own: TCN 300 x 4, GRU(256) x 2, decoder bi-GRU(300) x 4; word
embedding 16; TED Gesture, batch 4).

Module forwards within 1e-4: ``ContextEncoder`` (z pinned at mu),
``PoseDecoderGRU`` (eval, and train with flax's dropout patched out in
that test), ``PoseDecoderFC`` and ``EmbeddingNet`` with every input mode
(the random mode's coin, drawn by the port, handed to flax as the mode).
``generate`` against the JAX ``EmbedSynthesizer`` (1e-4) and
``convert.embedding_net_full_state`` against ``ha2g_tpu.export_torch``
exactly.  The train steps are in test_torch_joint_embedding_train.py and
test_torch_embedder_train.py.
"""

import functools

import numpy as np
import jax
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import export_torch as et
from ha2g_tpu.models.embedding_net import PoseDecoderFC as JaxDecoderFC
from ha2g_tpu.models.embedding_net import PoseDecoderGRU as JaxDecoderGRU
from ha2g_tpu.synthesis import EmbedSynthesizer as JaxSynthesizer
from tests.torch_baselines import clips, vocabs
from tests.torch_text_baselines import (B, JE, T, jax_setup, no_flax_dropout,
                                        port_system, train_batch)

from ha2g_torch.convert import embedding_net_full_state
from ha2g_torch.models.common import init_parameters_
from ha2g_torch.models.embedding_net import PoseDecoderFC
from ha2g_torch.synthesis import make_synthesizer

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rngs():
    return {"dropout": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}


@functools.cache
def _jax_net(mode: str):
    """The JAX EmbeddingNet in eval mode on ``train_batch(JE, 3)``,
    decoding the latent of ``mode`` (speech or pose): its 7 outputs."""
    system, state, _ = jax_setup(JE)
    b = train_batch(JE, 3)
    return jax.jit(lambda v, *a: system.net.apply(
        v, *a, input_mode=mode, rngs=_rngs()))(
        {"params": state.params, "batch_stats": state.batch_stats},
        b["text"], b["audio"], b["target"][:, :4], b["target"])


def test_context_encoder_forward_matches_jax():
    """Text TCN + waveform encoder -> unidirectional GRU(256) x 2 -> head,
    against the JAX ContextEncoder's outputs in the net (its first three);
    z a draw at std e^-30 around mu on both sides."""
    port = port_system(JE).eval()
    b = train_batch(JE, 3)
    want = _jax_net("speech")[:3]
    got = port.context_encoder(_t(b["text"]).long(), _t(b["audio"]),
                               generator=torch.Generator())
    for g, w, name in zip(got, want, ("z", "mu", "logvar")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_pose_decoder_gru_forward_matches_jax(train, monkeypatch):
    """The pre-pose MLP and the 4-layer bi-GRU(300) decoder (kernel B1's
    plain version on the CPU), eval mode and train mode (batch
    statistics)."""
    no_flax_dropout(monkeypatch)
    _, state, _ = jax_setup(JE)
    port = port_system(JE).train(train)
    rng = np.random.default_rng(2)
    latent = rng.normal(size=(B, 32)).astype(np.float32)
    pre = (rng.normal(size=(B, 4, 27)) * 0.2).astype(np.float32)
    res = jax.jit(lambda v, z, p: JaxDecoderGRU(27, T).apply(
        v, z, p, train=train, mutable=["batch_stats"] if train else False))(
        {"params": state.params["PoseDecoderGRU_0"],
         "batch_stats": state.batch_stats["PoseDecoderGRU_0"]}, latent, pre)
    want = res[0] if train else res
    got = port.decoder(_t(latent), _t(pre))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_pose_decoder_fc_matches_jax():
    """The FC decoder kept for API parity, with its pre-pose MLP, on the
    same seeded weights."""
    port = PoseDecoderFC(27, T, use_pre_poses=True)
    init_parameters_(port, torch.Generator().manual_seed(5))
    port.eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}

    def dense(key):
        return {"Dense_0": {"kernel": sd[f"{key}.weight"].T,
                            "bias": sd[f"{key}.bias"]}}

    def bn(key):
        return ({"BatchNorm_0": {"scale": sd[f"{key}.weight"],
                                 "bias": sd[f"{key}.bias"]}},
                {"BatchNorm_0": {"mean": sd[f"{key}.running_mean"],
                                 "var": sd[f"{key}.running_var"]}})

    params = {"Dense_0": dense("pre_pose_net.0"),
              "Dense_1": dense("pre_pose_net.3")}
    stats = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("pre_pose_net.1")
    for i in range(4):
        params[f"Dense_{2 + i}"] = dense(f"net.{3 * i}")
        params[f"BatchNorm_{1 + i}"], stats[f"BatchNorm_{1 + i}"] = \
            bn(f"net.{3 * i + 1}")
    params["Dense_6"] = dense("net.12")
    rng = np.random.default_rng(6)
    latent = rng.normal(size=(B, 32)).astype(np.float32)
    pre = rng.normal(size=(B, 4, 27)).astype(np.float32)
    want = jax.jit(JaxDecoderFC(27, T, use_pre_poses=True).apply)(
        {"params": params, "batch_stats": stats}, latent, pre)
    got = port(_t(latent), _t(pre))
    assert got.shape == (B, T, 27)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["pose", "speech", "random"])
def test_embedding_net_modes_match_jax(mode):
    """Every output of the joint EmbeddingNet in eval mode; in the random
    mode the port's coin (``last_coin``) picks the latent flax decodes."""
    port = port_system(JE).eval()
    b = train_batch(JE, 3)
    got = port(_t(b["text"]).long(), _t(b["audio"]), _t(b["target"][:, :4]),
               _t(b["target"]), input_mode=mode,
               generator=torch.Generator().manual_seed(0))
    jax_mode = mode
    if mode == "random":
        jax_mode = "speech" if bool(port.last_coin) else "pose"
    want = _jax_net(jax_mode)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, err_msg=str(i))


def test_generate_matches_jax():
    """Three windows of raw waveform and words decoded from the speech
    latent (z at mu), pre-poses from the carry, faded out over the last
    window's zero padding."""
    system, state, _ = jax_setup(JE)
    port = port_system(JE)
    (jlang, _), (lang, _) = vocabs()
    audio, words, vids = clips(B=2, seconds=6.1, seed=7)
    want = JaxSynthesizer(system, state).generate(audio, words, jlang, vids,
                                                  fade_out=True)
    got = make_synthesizer(port, port.state_dict()).generate(
        audio, words, lang, vids, fade_out=True)
    assert got.shape == want.shape and got.shape[1] > 3 * 34 - 8
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_state_conversion_matches_export_torch():
    """``convert.embedding_net_full_state`` of a JAX TrainState: the keys
    and values of ``export_embedding_net_full``, exactly, and the port's
    own state dict."""
    _, state, sd = jax_setup(JE)
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    got = embedding_net_full_state(params, stats)
    want = et.export_embedding_net_full(params, stats)
    assert got.keys() == want.keys() == sd.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], sd[k]), k
