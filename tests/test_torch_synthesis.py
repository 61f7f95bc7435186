"""The port's serving path against the JAX package's, on the CPU in fp32:
HierarchySynthesizer.generate and generate_fused of ha2g_torch against
ha2g_tpu's HierarchySynthesizer.generate, for the 3-level TED Gesture and
the 6-level TED Expressive hierarchies (hidden 32, 2 GRU layers, 5 s
clips), with the JAX parameters carried across by ha2g_torch.convert.

Speaker z is pinned at mu (logvar kernel 0, bias -100) because the two
frameworks draw different noise, and dropout is off (eval mode).  The
batch-norm running statistics are randomised so batch norm is not the
identity.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ha2g_tpu.config import Config as JaxConfig
from ha2g_tpu.data.vocab import Vocab as JaxVocab
from ha2g_tpu.synthesis import HierarchySynthesizer as JaxSynthesizer
from ha2g_tpu.train.hierarchy import HierarchySystem as JaxSystem

from ha2g_torch.config import Config
from ha2g_torch.convert import hierarchy_state
from ha2g_torch.data.vocab import Vocab
from ha2g_torch.synthesis import make_synthesizer
from ha2g_torch.train.hierarchy import HierarchySystem
import tests.torch_cpu  # noqa: F401  (one torch thread)

N_WORDS, N_SPK, T = 16, 4, 34
# fp32 on both sides; the differences are summation order in the convs,
# matmuls and the recurrence, compounded through the level cascade
ATOL = 1e-4


def _vocab(cls):
    lang = cls("words")
    for i in range(N_WORDS - lang.n_words):
        lang.index_word(f"w{i}")
    return lang


def _clips(B=2, seconds=5.0, seed=0):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(B, int(seconds * 16000))).astype(np.float32) * .1
    audio[1] *= 0.01   # a quiet clip beside a loud one
    words = [[(f"w{rng.integers(0, 10)}", float(t), float(t + 0.2))
              for t in np.arange(0.2, seconds - 0.3, 0.4)]
             for _ in range(B)]
    vids = rng.integers(0, N_SPK, (B,)).astype(np.int32)
    return audio, words, vids


def _randomise_stats(tree, rng):
    if isinstance(tree, dict):
        return {k: (_randomise_stats(v, rng) if isinstance(v, dict) else
                    (rng.uniform(0.5, 1.5, np.shape(v)) if k == "var" else
                     rng.normal(0, 0.1, np.shape(v))).astype(np.float32))
                for k, v in tree.items()}
    return tree


def _jax_state(dataset, pose_dim):
    cfg = JaxConfig(model="hierarchy", dataset=dataset, pose_dim=pose_dim,
                    n_poses=T, n_pre_poses=4, hidden_size=32, n_layers=2,
                    z_type="speaker")
    system = JaxSystem(cfg, n_words=N_WORDS, n_speakers=N_SPK)
    rng = np.random.default_rng(0)
    batch = {
        "text": jnp.asarray(rng.integers(0, N_WORDS, (2, T))),
        "spec": jnp.asarray(rng.normal(size=(2, 128, 70)).astype(np.float32)),
        "target": jnp.asarray(rng.normal(size=(2, T, pose_dim))
                              .astype(np.float32)),
        "vids": jnp.asarray(rng.integers(0, N_SPK, (2,))),
    }
    state = system.init(jax.random.PRNGKey(0), batch)
    params = jax.device_get(state.params)
    for g in params["gens"]:
        lv = g["SpeakerZ_0"]["Dense_2"]["Dense_0"]
        lv["kernel"] = np.zeros_like(lv["kernel"])
        lv["bias"] = np.full_like(lv["bias"], -100.0)
    stats = _randomise_stats(jax.device_get(state.batch_stats), rng)
    state = state.replace(params=params, batch_stats=stats)
    return cfg, system, state, params, stats


@pytest.mark.parametrize("dataset,pose_dim", [("ted_gesture", 27),
                                              ("ted_expressive", 126)])
def test_generate_matches_jax(dataset, pose_dim):
    cfg, jsystem, jstate, params, stats = _jax_state(dataset, pose_dim)
    audio, words, vids = _clips()
    want = JaxSynthesizer(jsystem, jstate).generate(
        audio, words, _vocab(JaxVocab), vids, rng=jax.random.PRNGKey(7))

    tcfg = Config.from_dict(cfg.to_dict())
    system = HierarchySystem(tcfg, N_WORDS, N_SPK, device="cpu")
    synth = make_synthesizer(system, hierarchy_state(params, stats,
                                                     cfg.n_layers))
    lang = _vocab(Vocab)
    got = synth.generate(audio, words, lang, vids)
    fused = synth.generate_fused(audio, words, lang, vids)

    assert got.shape == want.shape == (2, T + 2 * (T - 4), pose_dim)
    assert got.dtype == fused.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(fused, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(fused, got, atol=ATOL, rtol=0)


def test_int16_and_mulaw_input_follow_float_path():
    """The compact wire formats decode on the device to the float path's
    input: int16 is exact up to the x/32768 scaling, mu-law up to its
    companding (checked against the JAX front-end in test_torch_mel)."""
    from ha2g_tpu.ops.mel import mulaw_decode_np, mulaw_encode_np

    tcfg = Config(dataset="ted_gesture", hidden_size=16, n_layers=1,
                  z_type="speaker")
    system = HierarchySystem(tcfg, N_WORDS, N_SPK, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    synth = make_synthesizer(system, system.state_dict())
    audio, words, vids = _clips(seconds=3.0, seed=1)
    lang = _vocab(Vocab)
    pcm = (audio * 32767).astype(np.int16)
    mu = mulaw_encode_np(audio)
    g = lambda: torch.Generator().manual_seed(5)
    out_i16 = synth.generate(pcm, words, lang, vids, g())
    out_f_i16 = synth.generate(pcm.astype(np.float32) / 32768.0, words, lang,
                               vids, g())
    out_mu = synth.generate(mu, words, lang, vids, g())
    out_f_mu = synth.generate(mulaw_decode_np(mu), words, lang, vids, g())
    np.testing.assert_allclose(out_i16, out_f_i16, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out_mu, out_f_mu, atol=1e-5, rtol=0)
    # unpinned speaker z: the same generator seed gives the same draw, and
    # the fused loop draws in the host loop's order
    fused = synth.generate_fused(pcm, words, lang, vids, g())
    np.testing.assert_allclose(fused, out_i16, atol=1e-5, rtol=0)
