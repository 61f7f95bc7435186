"""One train step of each FGD embedder's training system of the port
against the JAX system's own step on the CPU in fp32, with the weights of
tests/torch_text_baselines.py: gesture_autoencoder at pose 27
(``EmbedSystem`` in mode pose, with and without ``embed_pose_diff_loss``)
and at pose 126 (``MotionAESystem`` at an epoch's learning rate).  The
loss terms within 1e-5 relative, every gradient leaf, the batch-norm
statistics and the post-Adam parameters at tests/torch_train_parity.py's
bounds, and Adam's second moments.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.torch_text_baselines import (AE, MAE, compare_train_step,
                                        jax_setup, port_system, train_batch)


@pytest.mark.parametrize("family, pose_diff",
                         [(AE, False), (AE, True), (MAE, False)])
def test_embedder_train_steps_match_jax(family, pose_diff):
    """gesture_autoencoder: EmbeddingNet in pose mode at pose 27 (Adam
    0.5 / 0.999; with ``embed_pose_diff_loss`` the difference term too),
    MotionAE at pose 126 (Adam 0.9 / 0.999 at epoch 31's learning rate, a
    tenth of the config's; L1, difference L1 and the summed bone
    cosines)."""
    system, state, _ = jax_setup(family)
    port = port_system(family)
    if pose_diff:
        system = copy.copy(system)
        system.cfg = dataclasses.replace(system.cfg,
                                         embed_pose_diff_loss=True)
        port.cfg = port.cfg.replace(embed_pose_diff_loss=True)
    old = {k: v.detach().clone().numpy() for k, v in port.state_dict().items()}
    b = train_batch(family, 5)
    batch = {k: jnp.asarray(b[k]) for k in ("target", "vids")}
    if family == MAE:
        lr = port.lr_for_epoch(31)
        assert lr == pytest.approx(port.cfg.learning_rate * 0.1)
        new_state, metrics = system.make_train_step()(
            state, batch, jax.random.PRNGKey(0), lr)
        got = port.train_step(b, torch.Generator(), lr=lr)
        assert port.opt.param_groups[0]["lr"] == lr
    else:
        lr = port.cfg.learning_rate
        new_state, metrics = system.make_train_step()(
            state, batch, jax.random.PRNGKey(0))
        got = port.train_step(b, torch.Generator())
    compare_train_step(family, port, old, got, metrics, new_state, lr)
