"""The port's model modules against the JAX package's, on the CPU in fp32,
with parameters carried across by ha2g_torch.convert; and convert's output
against ha2g_tpu.export_torch, which writes the same reference layout."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ha2g_tpu import export_torch
from ha2g_tpu.models.hierarchy import (HierarchicalPoseGenerator as
                                       JaxGenerator,
                                       HierarchicalWavEncoder as JaxWavEncoder)
from ha2g_tpu.models.tcn import TextEncoderTCN as JaxTCN
from ha2g_torch import convert
from ha2g_torch.models.hierarchy import (HierarchicalPoseGenerator,
                                         HierarchicalWavEncoder)
from ha2g_torch.models.tcn import TextEncoderTCN
import tests.torch_cpu  # noqa: F401  (one torch thread)

N_WORDS, N_SPK, T, HID = 20, 4, 34, 24
# fp32 on both sides; summation order of convs and matmuls only
ATOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def test_text_encoder_tcn_matches_jax():
    tokens = _rng(0).integers(0, N_WORDS, (3, T))
    jm = JaxTCN(n_words=N_WORDS, embed_dim=40, hidden_size=HID, n_layers=3)
    params = jax.device_get(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    want = jm.apply({"params": params}, jnp.asarray(tokens))

    tm = TextEncoderTCN(N_WORDS, embed_dim=40, hidden_size=HID,
                        n_layers=3).eval()
    tm.load_state_dict(convert.text_encoder_state(params, 3), strict=True)
    got = tm(torch.from_numpy(tokens))
    assert got.shape == (3, T, 32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _randomise_stats(tree, rng):
    if isinstance(tree, dict):
        return {k: (_randomise_stats(v, rng) if isinstance(v, dict) else
                    (rng.uniform(0.5, 1.5, np.shape(v)) if k == "var" else
                     rng.normal(0, 0.2, np.shape(v))).astype(np.float32))
                for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("levels", [3, 6])
def test_resnet_se_matches_jax(levels):
    """Full-width SE-ResNet (layers 3,4,6,3) with non-trivial BN running
    stats: checks the NCHW layout (pixel shuffle, tap fold, speaker blend)
    against the JAX package's NHWC one."""
    rng = _rng(1)
    spec = rng.normal(size=(2, 128, 70)).astype(np.float32)
    vids = np.array([1, 3])
    jm = JaxWavEncoder(pose_level=levels, n_speakers=N_SPK)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(spec),
                               jnp.asarray(vids)))
    stats = _randomise_stats(v["batch_stats"], rng)
    want = jm.apply({"params": v["params"], "batch_stats": stats},
                    jnp.asarray(spec), jnp.asarray(vids))

    tm = HierarchicalWavEncoder(pose_level=levels, n_speakers=N_SPK).eval()
    tm.load_state_dict(convert.audio_encoder_state(
        v["params"], stats, prefix="feat_extractor."), strict=True)
    got = tm(torch.from_numpy(spec), torch.from_numpy(vids))
    assert got[-1].shape == (levels, 2, T, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("input_context", ["both", "audio"])
def test_pose_generator_matches_jax(input_context):
    rng = _rng(2)
    pose_dim = 15
    pre = rng.normal(size=(2, T, pose_dim + 1)).astype(np.float32)
    text = rng.integers(0, N_WORDS, (2, T))
    audio = rng.normal(size=(2, T, 32)).astype(np.float32)
    vids = np.array([0, 2])
    jm = JaxGenerator(pose_dim=pose_dim, n_words=N_WORDS, n_speakers=N_SPK,
                      word_embed_dim=40, hidden_size=HID, n_layers=2,
                      input_context=input_context)
    args = tuple(map(jnp.asarray, (pre, text, audio, vids)))
    params = jax.device_get(jm.init(
        {"params": jax.random.PRNGKey(2), "noise": jax.random.PRNGKey(3)},
        *args)["params"])
    lv = params["SpeakerZ_0"]["Dense_2"]["Dense_0"]   # pin z at mu
    lv["kernel"] = np.zeros_like(lv["kernel"])
    lv["bias"] = np.full_like(lv["bias"], -100.0)
    want = jm.apply({"params": params}, *args,
                    rngs={"noise": jax.random.PRNGKey(4)})

    tm = HierarchicalPoseGenerator(pose_dim, N_WORDS, N_SPK,
                                   word_embed_dim=40, hidden_size=HID,
                                   n_layers=2,
                                   input_context=input_context).eval()
    tm.load_state_dict(convert.generator_state(params, 2), strict=True)
    got = tm(*map(torch.from_numpy, (pre, text, audio, vids)),
             generator=torch.Generator().manual_seed(0))
    assert got[0].shape == (2, T, pose_dim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0)


def test_convert_matches_export_torch():
    """convert.py is the port's own copy of export_torch's layout logic:
    identical keys and values for a generator and the audio encoder."""
    rng = _rng(3)
    pre = jnp.zeros((1, T, 16))
    jg = JaxGenerator(pose_dim=15, n_words=N_WORDS, n_speakers=N_SPK,
                      word_embed_dim=40, hidden_size=HID, n_layers=2)
    gp = jax.device_get(jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        pre, jnp.zeros((1, T), jnp.int32), jnp.zeros((1, T, 32)),
        jnp.zeros((1,), jnp.int32))["params"])
    ja = JaxWavEncoder(pose_level=3, n_speakers=N_SPK)
    av = jax.device_get(ja.init(jax.random.PRNGKey(2),
                                jnp.zeros((1, 128, 70)),
                                jnp.zeros((1,), jnp.int32)))
    stats = _randomise_stats(av["batch_stats"], rng)
    pairs = [(convert.generator_state(gp, 2),
              export_torch.export_generator(gp, 2)),
             (convert.audio_encoder_state(av["params"], stats,
                                          prefix="feat_extractor."),
              export_torch.export_audio_encoder(av["params"], stats,
                                                prefix="feat_extractor."))]
    for got, want in pairs:
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
