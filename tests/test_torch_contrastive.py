"""Kernels B2-B4 (the flash contrastive loss): the plain versions the CPU
runs, against the JAX package's XLA path (losses._contrastive_core with its
hand backward) and its Pallas kernels in interpret mode, as
tests/test_pallas_contrastive.py runs them.  Value and both gradients, at
N = 1024 (a multiple of the Pallas tile) and at a ragged N (XLA path only
there: the Pallas kernels need N % 512 == 0).  The kernels themselves run
on the card (tests/test_torch_cuda.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ha2g_tpu.ops import pallas_contrastive as pc
from ha2g_tpu.train import losses as jax_losses
from ha2g_torch.ops import contrastive as C
import tests.torch_cpu  # noqa: F401  (one torch thread)

D = 32
# fp32 on both sides: the (N, N) logits' logsumexp and the two (N, N) x
# (N, D) products summed in another order; the gradient entries are
# ~1e-3, their differences ~1e-9
VALUE_RTOL, GRAD_ATOL = 1e-6, 1e-8


@pytest.fixture
def interpret():
    pc.INTERPRET = True
    yield
    pc.INTERPRET = False


def _unit_rows(n, seed, dup=0):
    """Random unit rows a, b (N, D); b's first ``dup`` rows repeat a's, so
    some diagonal logits sit at the 1e6 clamp."""
    rng = np.random.default_rng(seed)
    a, b = (rng.normal(size=(n, D)).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    b[:dup] = a[:dup]
    return a, b


def _port(a, b):
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    before = (C.contrastive_fwd.launches, C.contrastive_bwd_da.launches,
              C.contrastive_bwd_db.launches)
    loss = C.flash_contrastive(ta, tb)
    loss.backward()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (C.contrastive_fwd.launches, C.contrastive_bwd_da.launches,
            C.contrastive_bwd_db.launches) == before
    return float(loss.detach()), ta.grad.numpy(), tb.grad.numpy()


@pytest.mark.parametrize("n,dup", [(1024, 0), (1024, 5), (1000, 0),
                                   (1000, 5)])
def test_plain_matches_xla_core(n, dup):
    a, b = _unit_rows(n, n + dup, dup)
    want, (ga, gb) = jax.value_and_grad(jax_losses._contrastive_core,
                                        argnums=(0, 1))(jnp.asarray(a),
                                                        jnp.asarray(b))
    got, da, db = _port(a, b)
    np.testing.assert_allclose(got, float(want), rtol=VALUE_RTOL)
    np.testing.assert_allclose(da, np.asarray(ga), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(db, np.asarray(gb), atol=GRAD_ATOL, rtol=0)


def test_plain_matches_pallas_interpret(interpret):
    a, b = _unit_rows(1024, 7)
    want, (ga, gb) = jax.value_and_grad(pc.flash_contrastive,
                                        argnums=(0, 1))(jnp.asarray(a),
                                                        jnp.asarray(b))
    logz, diag = pc._flash_fwd_arrays(jnp.asarray(a), jnp.asarray(b))
    got, da, db = _port(a, b)
    np.testing.assert_allclose(got, float(want), rtol=VALUE_RTOL)
    np.testing.assert_allclose(da, np.asarray(ga), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(db, np.asarray(gb), atol=GRAD_ATOL, rtol=0)
    p_logz, p_diag = C.contrastive_fwd(torch.from_numpy(a),
                                       torch.from_numpy(b))
    np.testing.assert_allclose(p_logz.numpy(), np.asarray(logz)[:, 0],
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(p_diag.numpy(), np.asarray(diag)[:, 0],
                               rtol=VALUE_RTOL)


def test_backward_pieces_take_the_global_n():
    """B3 and B4 scale ds by g / N with the global N (the Pallas
    _ds_tile's ``n`` argument is unused): doubling g doubles both."""
    a, b = (torch.from_numpy(x) for x in _unit_rows(300, 3))
    logz, _ = C.contrastive_fwd(a, b)
    g1 = torch.tensor([0.5 / 300])
    g2 = torch.tensor([1.0 / 300])
    for fn in (C.contrastive_bwd_da, C.contrastive_bwd_db):
        torch.testing.assert_close(2 * fn(a, b, logz, g1), fn(a, b, logz, g2))


def test_wrappers_check_their_arguments():
    a, b = (torch.from_numpy(x) for x in _unit_rows(8, 1))
    with pytest.raises(ValueError, match="D <= 512"):
        C.contrastive_fwd(torch.zeros(4, 513), torch.zeros(4, 513))
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        C.contrastive_fwd(a, b[:5])
    logz, _ = C.contrastive_fwd(a, b)
    with pytest.raises(ValueError, match="logz"):
        C.contrastive_bwd_da(a, b, logz[:3], torch.ones(1))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (the kernels' cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _fwd_from_s(s):
    logits, _ = C._logits(s)
    return torch.logsumexp(logits, dim=1), torch.diagonal(logits)


# the card's aligned-row tolerance on logz and diag at sigma = 0.1
# (tests/test_torch_cuda.py ALIGNED_TOL): 2x the fp32 product's error
ALIGNED_RTOL = 1e-4


def test_three_tf32_products_keep_the_aligned_row_tolerance():
    """Why the kernels split their operands (s = hi.hi + hi.lo + lo.hi):
    on aligned rows b = normalize(a + 0.1 n / sqrt(D)) (s_ii ~ 0.995, as a
    trained contrastive loss sees them) one TF32 product puts logz and
    diag more than 1e-2 off float64, 3xTF32 stays within fp32's error."""
    rng = np.random.default_rng(0)
    n = 1024
    a = rng.normal(size=(n, D))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = a + 0.1 * rng.normal(size=(n, D)) / D ** 0.5
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in (a, b))
    want = _fwd_from_s(a.double() @ b.double().T)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    # the products of TF32 values are exact in fp32; the sums are fp32
    products = {"fp32": a @ b.T, "1xTF32": a_hi @ b_hi.T,
                "3xTF32": a_hi @ b_hi.T + (a_hi @ b_lo.T + a_lo @ b_hi.T)}
    err = {}
    for name, s in products.items():
        got = _fwd_from_s(s)
        err[name] = max(((g.double() - w).abs() / w.abs()).max().item()
                        for g, w in zip(got, want))
    assert err["fp32"] <= ALIGNED_RTOL, err
    assert err["3xTF32"] <= ALIGNED_RTOL, err
    assert err["1xTF32"] > 100 * ALIGNED_RTOL, err


def test_tensors_off_the_cpu_never_take_the_plain_version():
    """No fallback: tensors that are not on the CPU go to the kernel or
    raise; here a device that is neither the CPU nor CUDA raises, and no
    launch is counted.  (On the card, tests/test_torch_cuda.py shows CUDA
    tensors reach the kernels.)"""
    a = torch.empty((64, D), device="meta")
    before = C.contrastive_fwd.launches
    with pytest.raises(ValueError, match="CUDA device"):
        C.contrastive_fwd(a, a)
    with pytest.raises(ValueError, match="CUDA device"):
        C.contrastive_bwd_db(a, a, torch.empty(64, device="meta"),
                             torch.empty(1, device="meta"))
    assert C.contrastive_fwd.launches == before
