"""Every loss of ha2g_torch/train/losses.py against ha2g_tpu/train/losses.py
on the CPU in fp32: value and the gradient of each differentiable input,
the same seeded numpy inputs through both."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ha2g_tpu import skeleton as jax_skeleton
from ha2g_tpu.train import losses as J
from ha2g_torch import skeleton
from ha2g_torch.train import losses as P
import tests.torch_cpu  # noqa: F401  (one torch thread)

# fp32 elementwise math and means over a few hundred terms: rounding only
RTOL, ATOL = 1e-5, 1e-7


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _compare(jax_fn, port_fn, arrays, argnums, grad_rtol=1e-4):
    """Value and the gradients w.r.t. ``argnums`` of both functions."""
    want, grads = jax.value_and_grad(jax_fn, argnums=argnums)(
        *map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=i in argnums)
          for i, a in enumerate(arrays)]
    got = port_fn(*ts)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    for i, g in zip(argnums, grads):
        np.testing.assert_allclose(ts[i].grad.numpy(), np.asarray(g),
                                   rtol=grad_rtol, atol=1e-6,
                                   err_msg=f"arg {i}")
    for i, t in enumerate(ts):
        if i not in argnums:
            assert t.grad is None


@pytest.mark.parametrize("beta", [0.1, 0.05])
def test_scaled_huber(beta):
    # differences on both sides of beta
    x, y = _arrays(0, (3, 10, 27), (3, 10, 27), scale=0.1)
    _compare(lambda a, b: J.scaled_huber(a, b, beta),
             lambda a, b: P.scaled_huber(a, b, beta), [x, y], (0, 1))
    unreduced = P.scaled_huber(torch.from_numpy(x), torch.from_numpy(y), beta,
                               reduce=False)
    np.testing.assert_allclose(
        unreduced.numpy(),
        np.asarray(J.scaled_huber(jnp.asarray(x), jnp.asarray(y), beta,
                                  reduce=False)), rtol=RTOL, atol=ATOL)


def test_speaker_kld():
    mu, logvar = _arrays(1, (4, 16), (4, 16), scale=0.5)
    _compare(J.speaker_kld, P.speaker_kld, [mu, logvar], (0, 1))


def test_diversity_regularizer_detaches_all_but_out():
    out, out_r, z, z_r = _arrays(2, (4, 34, 27), (4, 34, 27), (4, 16),
                                 (4, 16), scale=0.3)
    # a row whose speaker draws the same z hits the -1000 clamp
    z_r[1] = z[1]
    _compare(J.diversity_regularizer, P.diversity_regularizer,
             [out, out_r, z, z_r], (0,))
    # the three detached inputs take no gradient
    ts = [torch.tensor(a, requires_grad=True) for a in (out, out_r, z, z_r)]
    P.diversity_regularizer(*ts).backward()
    assert all(t.grad is None for t in ts[1:])


def test_nsgan_pair():
    rng = np.random.default_rng(3)
    real, fake = (rng.uniform(0.05, 0.95, (6, 1)).astype(np.float32)
                  for _ in range(2))
    _compare(J.nsgan_d_loss, P.nsgan_d_loss, [real, fake], (0, 1))
    _compare(J.nsgan_g_loss, P.nsgan_g_loss, [fake], (0,))


def test_l1_loss():
    x, y = _arrays(4, (3, 34, 27), (3, 34, 27))
    _compare(J.l1_loss, P.l1_loss, [x, y], (0, 1))


@pytest.mark.parametrize("name", ["ted_gesture", "ted_expressive"])
def test_physical_angle_prior(name):
    spec, jspec = skeleton.SKELETONS[name], jax_skeleton.SKELETONS[name]
    out, mean = _arrays(5, (2, 34, spec.pose_dim), (spec.pose_dim,),
                        scale=0.3)
    # gradients: 1/var (var down to 2.6e-5) and arccos' 1/sqrt(1 - c^2)
    # amplify the rounding of each cosine c; measured worst 2.7e-4
    _compare(lambda o, m: J.physical_angle_prior(o, m, jspec),
             lambda o, m: P.physical_angle_prior(o, m, spec),
             [out, mean], (0, 1), grad_rtol=1e-3)


def test_softmax_contrastive_with_row_normalisation():
    """Raw features (N = B*T rows of 32): normalisation, then the
    contrastive core, whose gradient is the hand backward."""
    a, b = _arrays(6, (4 * 34, 32), (4 * 34, 32), scale=2.0)
    _compare(J.softmax_contrastive, P.softmax_contrastive, [a, b], (0, 1))
