"""One train step of the port against the JAX package on the CPU in fp32,
6-level TED Expressive hierarchy (hidden 32, 2 GRU layers, batch 4): with
and without the GAN phase.  Method and tolerances:
tests/torch_train_parity.py.
"""

import pytest

from tests.torch_train_parity import run_and_compare


@pytest.mark.parametrize("gan_on", [False, True])
def test_train_step_matches_jax(gan_on):
    run_and_compare("ted_expressive", 126, gan_on)
