"""One train step with the GAN phase of the port against the JAX package
on the CPU in fp32, 3-level TED Gesture hierarchy (hidden 32, 2 GRU
layers, batch 4); the step without it and the eval step are in
test_torch_train_gesture.py.  Method and tolerances:
tests/torch_train_parity.py.
"""

import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.torch_train_parity import run_and_compare


@pytest.mark.parametrize("gan_on", [True])
def test_train_step_matches_jax(gan_on):
    run_and_compare("ted_gesture", 27, gan_on)
