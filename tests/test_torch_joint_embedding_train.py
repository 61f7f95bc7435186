"""One train step of the port's joint embedding (``EmbedSystem`` in mode
random) against the JAX system's own step on the CPU in fp32, with the
weights and frozen randomness of tests/torch_text_baselines.py (flax's
hard-coded dropouts patched out): for each coin, the port draws it from a
seeded generator and the JAX step runs under the first PRNG key that
draws the same one (recorded as the step runs).  Both encoders run in
train mode either way.  The loss within 1e-5 relative, every gradient
leaf, the batch-norm statistics and the post-Adam parameters at
tests/torch_train_parity.py's bounds (the waveform encoder's leaves at
tests/test_torch_multimodal.py's), and Adam's second moments.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.torch_text_baselines import (JE, compare_train_step, jax_setup,
                                        no_flax_dropout, port_system,
                                        train_batch)

# generator seeds whose coin picks the speech latent (True) and the pose
# latent (False) in the random mode's train step
COIN_SEEDS = {True: 0, False: 1}
# the waveform encoder's leaves, held at the audio bounds
AUDIO_LEAVES = ("context_encoder.audio_encoder.",)
# the coins the JAX random mode draws, as its step runs
DRAWN = []


def _record_coins(monkeypatch):
    """``jax.random.bernoulli`` recording each scalar draw (the random
    mode's coin; dropout is patched out) into DRAWN as the step runs."""
    draw = jax.random.bernoulli

    def bernoulli(key, p=0.5, shape=None, **kwargs):
        out = draw(key, p, shape, **kwargs)
        if not out.shape:
            jax.debug.callback(DRAWN.append, out)
        return out
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)


@functools.cache
def _jax_random_step():
    """The JAX EmbedSystem's own train step in mode random, traced once
    for both coins."""
    return jax_setup(JE)[0].make_train_step()


def _jax_step_drawing(coin, state, batch):
    """The JAX step under the first PRNG key whose coin is ``coin``."""
    step = _jax_random_step()
    for seed in range(32):
        DRAWN.clear()
        out = step(state, batch, jax.random.PRNGKey(seed))
        jax.effects_barrier()
        (drawn,) = DRAWN
        if bool(drawn) == coin:
            return out
    raise AssertionError(f"no PRNG key of 32 draws the coin {coin}")


@pytest.mark.parametrize("coin", [True, False])
def test_joint_embedding_train_step_matches_jax(coin, monkeypatch):
    """One random-mode step: the port draws its coin (seeded to each
    value), the JAX step draws the same one; both encoders run in train
    mode and update their statistics either way."""
    no_flax_dropout(monkeypatch)
    _record_coins(monkeypatch)
    _, state, _ = jax_setup(JE)
    port = port_system(JE)
    old = {k: v.detach().clone().numpy() for k, v in port.state_dict().items()}
    b = train_batch(JE, 4)
    got = port.train_step(b, torch.Generator().manual_seed(COIN_SEEDS[coin]))
    assert bool(port.last_coin) == coin
    new_state, metrics = _jax_step_drawing(
        coin, state, {k: jnp.asarray(v) for k, v in b.items()})
    compare_train_step(JE, port, old, got, metrics, new_state,
                       port.cfg.learning_rate, loose=AUDIO_LEAVES)
