"""One train step with the GAN phase of the port against the JAX package
on the CPU in fp32, 3-level TED Gesture hierarchy (hidden 32, 2 GRU
layers, batch 4), in one process and on 2 data-parallel ranks (against
the same compiled JAX step); the step without it and the eval step are in
test_torch_train_gesture.py.  Method and tolerances:
tests/torch_train_parity.py.
"""

import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.torch_train_parity import (compare_dp_step, run_and_compare,
                                      start_dp_ranks)


@pytest.fixture(scope="module", autouse=True)
def dp_ranks(tmp_path_factory):
    """The 2-rank step, started before the module's first test so that it
    runs while the JAX step compiles."""
    ranks = start_dp_ranks("ted_gesture", 27, True,
                           tmp_path_factory.mktemp("dp"))
    yield ranks
    for p in ranks.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("gan_on", [True])
def test_train_step_matches_jax(gan_on):
    run_and_compare("ted_gesture", 27, gan_on)


def test_data_parallel_train_step_matches_jax(dp_ranks):
    """The 2-rank step (batch norm over the global batch, the contrastive
    loss on the gathered rows, gradients averaged) against the JAX step on
    the same 4-row global batch, speaker z pinned and dropout off."""
    compare_dp_step("ted_gesture", 27, True, dp_ranks)
