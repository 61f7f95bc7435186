"""One train step of the port against the JAX package on the CPU in fp32,
3-level TED Gesture hierarchy (hidden 32, 2 GRU layers, batch 4), without
the GAN phase, and the eval step; the step with the GAN phase is in
test_torch_train_gesture_gan.py (a file each, so that the JAX compiles run
on two workers).  Method and tolerances: tests/torch_train_parity.py.
"""

import pytest

from tests.torch_train_parity import run_and_compare
import tests.torch_cpu  # noqa: F401  (one torch thread)


@pytest.mark.parametrize("gan_on", [False])
def test_train_step_matches_jax(gan_on):
    run_and_compare("ted_gesture", 27, gan_on)


def test_eval_step_matches_jax():
    """make_eval_step: eval-mode batch norm (running statistics), no
    dropout, the same pinned speaker z."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tests.torch_train_parity import jax_setup, port_setup

    system, state, batch, common = jax_setup("ted_gesture", 27)
    want_out, want_l1 = system.make_eval_step()(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(3))
    port = port_setup(state, common)
    out, l1 = port.eval_step(batch, torch.Generator().manual_seed(0))
    assert port.training            # the step restores the module's mode
    # fp32, summation order through the cascade (as the synthesis tests)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(l1), float(want_l1), rtol=1e-5)
