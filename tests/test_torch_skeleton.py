"""The port's skeleton tables and cascade routing against the JAX
package's, for both skeletons, with and without ref_routing_compat."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ha2g_tpu import skeleton as jsk
from ha2g_tpu.train.cascade import build_pre_seq as jax_build_pre_seq
from ha2g_torch import skeleton as tsk
from ha2g_torch.config import Config
from ha2g_torch.train.cascade import build_pre_seq
import tests.torch_cpu  # noqa: F401  (one torch thread)

CASES = [(name, compat) for name in ("ted_gesture", "ted_expressive")
         for compat in (False, True)]


def _specs(name, compat):
    table_j = jsk.REF_COMPAT_SKELETONS if compat else jsk.SKELETONS
    table_t = tsk.REF_COMPAT_SKELETONS if compat else tsk.SKELETONS
    return table_j[name], table_t[name]


@pytest.mark.parametrize("name,compat", CASES)
def test_tables_equal_jax(name, compat):
    js, ts = _specs(name, compat)
    assert ts.bones == js.bones and ts.levels == js.levels
    assert ts.pose_dim == js.pose_dim and ts.level_dims == js.level_dims
    assert ts.ref_routing_compat == js.ref_routing_compat
    for level in range(ts.n_levels):
        np.testing.assert_array_equal(ts.level_slice_cols(level),
                                      js.level_slice_cols(level))
    for level in range(ts.n_levels - 1):
        for a, b in zip(ts.routing_indices(level), js.routing_indices(level)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ts.routing_matrix(level),
                                      js.routing_matrix(level))
    assert Config(dataset=name, ref_routing_compat=compat).skeleton == ts


@pytest.mark.parametrize("name,compat", CASES)
def test_pre_seq_routing_bit_exact(name, compat):
    """The indexed copy routes the same values as the JAX package's 0/1
    matmul, bit for bit, at every level."""
    js, ts = _specs(name, compat)
    rng = np.random.default_rng(0)
    target = rng.normal(size=(2, 34, ts.pose_dim)).astype(np.float32)
    for level in range(ts.n_levels):
        t_l = ts.extract_level_target(torch.from_numpy(target), level)
        jt_l = js.extract_level_target(jnp.asarray(target), level)
        np.testing.assert_array_equal(t_l.numpy(), np.asarray(jt_l))
        prev = None if level == 0 else rng.normal(
            size=(2, 34, ts.level_dim(level - 1))).astype(np.float32)
        got = build_pre_seq(t_l, None if prev is None
                            else torch.from_numpy(prev), level, ts, 4)
        want = jax_build_pre_seq(jt_l, None if prev is None
                                 else jnp.asarray(prev), level, js, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
