"""The multimodal_context baseline of the port against the JAX package on
the CPU in fp32, TED Gesture at hidden 16 / 2 GRU layers / batch 4, with
the weights and frozen randomness of tests/torch_baselines.py: module
forwards (1e-4), one train step with the GAN phase on and off (every
metric, every gradient leaf through the converter, the batch-norm
statistics and the post-Adam parameters, at the bounds of
tests/torch_train_parity.py: metrics 1e-4 relative, gradients 1e-4
relative L2 per leaf and 3e-2 inside the batch-normed waveform encoder),
a 3-window ``generate`` against the JAX synthesizer (1e-4), and
``convert.multimodal_state`` against ``ha2g_tpu.export_torch`` exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import export_torch as et
from ha2g_tpu.synthesis import MultimodalSynthesizer as JaxSynthesizer
from tests.torch_baselines import (MM, NL, clips, jax_setup, numpy_state,
                                   port_system, train_batch, vocabs)
from tests.torch_train_parity import compare_step

from ha2g_torch.convert import multimodal_state
from ha2g_torch.synthesis import make_synthesizer

# fp32 on both sides: summation order of the convs, products and the GRU
ATOL = 1e-4
# conv biases right before a train-mode batch norm: zero true gradient
ZERO_GRAD = tuple(f"gen.audio_encoder.feat_extractor.{i}.bias"
                  for i in (0, 3, 6)) + ("dis.pre_conv.0.bias",
                                         "dis.pre_conv.3.bias")


@pytest.mark.parametrize("train", [False, True])
def test_generator_and_discriminator_forward_match_jax(train):
    """PoseGenerator (waveform encoder, TCN, speaker z, bi-GRU, slope-1
    output) and the slope-1 ConvDiscriminator, in eval mode and in train
    mode (batch statistics), against flax on the same weights."""
    system, state, _ = jax_setup(MM)
    port = port_system(MM)
    port.train(train)
    b = train_batch(1)
    pre = np.asarray(system._pre_seq(jnp.asarray(b["target"])))
    variables = {"params": state.params["gen"],
                 "batch_stats": state.batch_stats["gen"]}
    rngs = {"dropout": jax.random.PRNGKey(0),
            "noise": jax.random.PRNGKey(1)}
    mutable = ["batch_stats"] if train else False
    res = jax.jit(lambda v, *a: system.gen.apply(
        v, *a, train=train, rngs=rngs, mutable=mutable))(
        variables, pre, b["text"], b["audio"], b["vids"])
    want = res[0] if train else res
    t = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    got = port.gen(torch.from_numpy(pre.copy()), t["text"].long(), t["audio"],
                   t["vids"].long(), generator=torch.Generator())
    for g, w, name in zip(got, want, ("out", "z", "mu", "logvar")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, err_msg=name)
    d_want = jax.jit(lambda v, x: system.dis.apply(
        v, x, train=train, mutable=mutable))(
        {"params": state.params["dis"],
         "batch_stats": state.batch_stats["dis"]}, b["target"])
    d_want = d_want[0] if train else d_want
    np.testing.assert_allclose(port.dis(t["target"]).detach().numpy(),
                               np.asarray(d_want), atol=ATOL)


@pytest.mark.parametrize("gan_on", [True, False])
def test_train_step_matches_jax(gan_on):
    system, state, _ = jax_setup(MM)
    port = port_system(MM)
    old = {k: v.detach().clone().numpy() for k, v in port.state_dict().items()}
    b = train_batch(2)
    rng = jax.random.PRNGKey(42)
    new_state, metrics = system.make_train_step(gan_on)(
        state, {k: jnp.asarray(v) for k, v in b.items()}, rng)
    k_perm = jax.random.split(rng, 4)[3]
    rand_vids = np.asarray(jax.random.permutation(k_perm, b["vids"]))
    got = port.train_step(b, gan_on, torch.Generator().manual_seed(0),
                          rand_vids=torch.tensor(rand_vids))
    want_grads = numpy_state(MM, {"gen": new_state.g_opt[0]["grads"],
                                  "dis": new_state.d_opt[0]["grads"]},
                             new_state.batch_stats)
    cfg = port.cfg
    compare_step(got, metrics, port, old, want_grads,
                 numpy_state(MM, new_state.params, new_state.batch_stats),
                 lr=cfg.learning_rate,
                 d_lr=cfg.learning_rate * cfg.discriminator_lr_weight,
                 loose=("gen.audio_encoder.",),
                 zero_grad=ZERO_GRAD)


def test_generate_matches_jax():
    """Three windows of raw waveform (the last zero-padded, which
    ``fade_out`` fades over), int16 input decoded on the host."""
    system, state, _ = jax_setup(MM)
    port = port_system(MM)
    (jlang, _), (lang, _) = vocabs()
    audio, words, vids = clips(B=2, seconds=6.1, seed=5)
    want = JaxSynthesizer(system, state).generate(audio, words, jlang, vids,
                                                  fade_out=True)
    synth = make_synthesizer(port, port.state_dict())
    got = synth.generate(audio, words, lang, vids, fade_out=True)
    assert got.shape == want.shape and got.shape[1] > 3 * 34 - 8
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    np.testing.assert_allclose(
        synth.generate(pcm, words, lang, vids),
        np.asarray(JaxSynthesizer(system, state).generate(pcm, words, jlang,
                                                          vids)),
        atol=ATOL)


def test_state_conversion_matches_export_torch():
    """``convert.multimodal_state`` of a JAX GanState: the keys and values
    of ``export_multimodal_generator`` / ``export_discriminator``,
    exactly."""
    _, state, sd = jax_setup(MM)
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    got = multimodal_state(params, stats)
    want = {**{f"gen.{k}": v for k, v in et.export_multimodal_generator(
        params["gen"], stats["gen"], NL).items()},
        **{f"dis.{k}": v for k, v in et.export_discriminator(
            params["dis"], stats["dis"]).items()}}
    assert got.keys() == want.keys() == sd.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], sd[k]), k
