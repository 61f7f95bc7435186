"""The speech2gesture baseline of the port against the JAX package on the
CPU in fp32, TED Gesture at batch 4, with the weights of
tests/torch_baselines.py: the generator and the discriminator forward
(1e-4) in eval and train mode, on spectrograms of odd and even length
(TF "SAME" padding pads one more on the right at an odd length), one
train step (every metric, every gradient leaf through the converter, the
batch-norm statistics and the post-Adam parameters, at the bounds of
tests/torch_train_parity.py: metrics 1e-4 relative, gradients 1e-4
relative L2 per leaf and 3e-2 inside the batch-normed audio encoder), a
3-window ``generate`` against the JAX synthesizer (1e-4), and
``convert.speech2gesture_state`` against ``ha2g_tpu.export_torch``
exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import export_torch as et
from ha2g_tpu.synthesis import S2GSynthesizer as JaxSynthesizer
from tests.torch_baselines import (S2G, clips, jax_setup, numpy_state,
                                   port_system, train_batch, vocabs)
from tests.torch_train_parity import compare_step

from ha2g_torch.convert import speech2gesture_state
from ha2g_torch.synthesis import make_synthesizer

# fp32 on both sides: summation order of the convs and products
ATOL = 1e-4


def _zero_grad_leaves(port) -> tuple:
    """Biases right before a train-mode batch norm (every ConvNormRelu's
    conv, the pre-pose encoder's first Linear): zero true gradient."""
    return tuple(k for k, _ in port.named_parameters()
                 if (k.endswith(".0.bias") and k != "dis.net.0.bias")
                 or k == "gen.pre_pose_encoder.0.bias")


@pytest.mark.parametrize("spec_len,train", [(70, False), (71, False),
                                            (69, True), (73, False)])
def test_generator_and_discriminator_forward_match_jax(spec_len, train):
    system, state, _ = jax_setup(S2G)
    port = port_system(S2G)
    port.train(train)
    rng = np.random.default_rng(spec_len)
    spec = rng.normal(size=(3, 128, spec_len)).astype(np.float32)
    pre = (rng.normal(size=(3, 4, 27)) * 0.2).astype(np.float32)
    mutable = ["batch_stats"] if train else False
    want = jax.jit(lambda v, s, p: system.gen.apply(
        v, s, p, train=train, mutable=mutable))(
        {"params": state.params["gen"],
         "batch_stats": state.batch_stats["gen"]}, spec, pre)
    want = want[0] if train else want
    got = port.gen(torch.from_numpy(spec), torch.from_numpy(pre))
    assert got.shape == want.shape == (3, 34, 27)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    motion = np.diff(train_batch(spec_len)["target"], axis=1)
    d_want = jax.jit(lambda v, x: system.dis.apply(
        v, x, train=train, mutable=mutable))(
        {"params": state.params["dis"],
         "batch_stats": state.batch_stats["dis"]}, motion)
    d_want = d_want[0] if train else d_want
    d_got = port.dis(torch.from_numpy(motion))
    assert d_got.shape == d_want.shape
    np.testing.assert_allclose(d_got.detach().numpy(), np.asarray(d_want),
                               atol=ATOL)


def test_train_step_matches_jax():
    system, state, _ = jax_setup(S2G)
    port = port_system(S2G)
    old = {k: v.detach().clone().numpy() for k, v in port.state_dict().items()}
    b = train_batch(2)
    new_state, metrics = system.make_train_step()(
        state, {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.PRNGKey(42))
    got = port.train_step(b, torch.Generator().manual_seed(0))
    want_grads = numpy_state(S2G, {"gen": new_state.g_opt[0]["grads"],
                                   "dis": new_state.d_opt[0]["grads"]},
                             new_state.batch_stats)
    cfg = port.cfg
    compare_step(got, metrics, port, old, want_grads,
                 numpy_state(S2G, new_state.params, new_state.batch_stats),
                 lr=cfg.learning_rate,
                 d_lr=cfg.learning_rate * cfg.discriminator_lr_weight,
                 loose=("gen.audio_encoder.",),
                 zero_grad=_zero_grad_leaves(port))


def test_generate_matches_jax():
    """Three spectrogram windows (the last edge-padded) with fade_out."""
    system, state, _ = jax_setup(S2G)
    port = port_system(S2G)
    (jlang, _), (lang, _) = vocabs()
    audio, words, vids = clips(B=2, seconds=6.1, seed=6)
    want = JaxSynthesizer(system, state).generate(audio, words, jlang, vids,
                                                  fade_out=True)
    got = make_synthesizer(port, port.state_dict()).generate(
        audio, words, lang, vids, fade_out=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_state_conversion_matches_export_torch():
    """``convert.speech2gesture_state`` of a JAX GanState: the keys and
    values of ``export_s2g_generator`` / ``export_s2g_discriminator``,
    exactly."""
    _, state, sd = jax_setup(S2G)
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    got = speech2gesture_state(params, stats)
    want = {**{f"gen.{k}": v for k, v in et.export_s2g_generator(
        params["gen"], stats["gen"]).items()},
        **{f"dis.{k}": v for k, v in et.export_s2g_discriminator(
            params["dis"], stats["dis"]).items()}}
    assert got.keys() == want.keys() == sd.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], sd[k]), k
