"""Kernel B1's plain version and the GRU module against the JAX package.

The plain version runs against the Pallas kernel in interpret mode and the
scan reference, as tests/test_pallas_gru.py runs them (T=7, B=4, H=16).
The GRU module runs against the JAX GRU on its scan path
(use_pallas=False), which is bit-exact with the kernel and compiles on the
CPU, forward and (through jax.grad and the port's autograd) backward.  On
CPU tensors the wrapper takes the plain version and counts no
kernel launch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ha2g_tpu.ops.gru import GRU as JaxGRU
from ha2g_tpu.ops.gru import _gru_scan
from ha2g_tpu.ops.pallas_gru import _pallas_forward, gru_sequence_reference
from ha2g_torch.convert import _gru
from ha2g_torch.ops.gru import GRU
from ha2g_torch.ops.gru_kernel import (MAX_HIDDEN, cluster_plan,
                                       gru_backward_loop,
                                       gru_backward_loop_plain,
                                       gru_recurrence,
                                       gru_recurrence_backward,
                                       gru_recurrence_plain)
import tests.torch_cpu  # noqa: F401  (one torch thread)

T, B, H = 7, 4, 16
# fp32: summation order of the h.w_hh products (and, backward, of the
# d_gh.w_hh^T and hoisted weight-gradient contractions) only
ATOL_F32 = 1e-5


def _inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(T, 2, B, 3 * H)) * 0.5
    h0 = rng.normal(size=(2, B, H)) * 0.5
    w_hh = rng.normal(size=(2, H, 3 * H)) * 0.1
    b_hh = rng.normal(size=(2, 3 * H)) * 0.1
    return [a.astype(dtype) for a in (xp, h0, w_hh, b_hh)]


def test_plain_matches_pallas_interpret_and_scan():
    args = _inputs()
    want_k = _pallas_forward(*map(jnp.asarray, args), interpret=True)
    want_s = gru_sequence_reference(*map(jnp.asarray, args))
    before = gru_recurrence.launches
    got = gru_recurrence(*map(torch.from_numpy, args))
    assert gru_recurrence.launches == before
    assert got.shape == (T, 2, B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k),
                               atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_s),
                               atol=ATOL_F32, rtol=0)


def test_plain_bf16_carry_matches_pallas_interpret():
    """bf16 inputs: fp32 gates, carry rounded to bf16 every step.  Both sides
    round the same fp32 value unless the two summation orders straddle a
    rounding boundary; such a flip is one bf16 ulp (2^-8 near 1) and can
    echo through later steps, so allow 2 ulps."""
    args = [a.astype(np.float32) for a in _inputs(1)]
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    want = _pallas_forward(*jargs, interpret=True).astype(jnp.float32)
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in args]
    got = gru_recurrence_plain(*targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=2 ** -7, rtol=0)


def test_wrapper_rejects_bad_shapes():
    xp, h0, w_hh, b_hh = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="w_hh"):
        gru_recurrence(xp, h0, w_hh[:, :, :-3], b_hh)
    with pytest.raises(ValueError, match="dtype"):
        gru_recurrence(xp, h0.double(), w_hh, b_hh)


def test_gru_module_matches_jax_scan():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 9, 10)).astype(np.float32)
    jgru = JaxGRU(hidden_size=H, n_layers=2, bidirectional=True, dropout=0.3)
    params = jgru.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want_out, want_h = jgru.apply({"params": params}, jnp.asarray(x))

    gru = GRU(10, H, n_layers=2, dropout=0.3).eval()
    sd = {}
    _gru(jax.device_get(params), sd, "gru", 2)
    gru.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    got_out, got_h = gru(torch.from_numpy(x))
    assert got_out.shape == (3, 9, 2 * H) and got_h.shape == (4, 3, H)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(want_out),
                               atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               atol=ATOL_F32, rtol=0)


def test_gru_gradients_match_jax_grad():
    """B1's autograd (the torch-ops backward of _gru_scan_bwd): gradients of
    the input and of every weight of a 2-layer bi-GRU against jax.grad
    through the JAX GRU, with a cotangent on the outputs and on the final
    hidden state."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 9, 10)).astype(np.float32)
    ct = rng.normal(size=(3, 9, 2 * H)).astype(np.float32)
    jgru = JaxGRU(hidden_size=H, n_layers=2, bidirectional=True)
    params = jgru.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def f(p, xx):
        out, h = jgru.apply({"params": p}, xx)
        return jnp.sum(out * ct) + jnp.sum(h ** 2)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    gru = GRU(10, H, n_layers=2).eval()
    sd = {}
    _gru(jax.device_get(params), sd, "gru", 2)
    gru.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    calls = gru_recurrence_backward.calls
    out, h = gru(tx)
    ((out * torch.from_numpy(ct)).sum() + (h ** 2).sum()).backward()
    assert gru_recurrence_backward.calls == calls + 2     # one per layer
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               atol=ATOL_F32, rtol=0)
    want = {}
    _gru(jax.device_get(gp), want, "gru", 2)
    for k, v in want.items():
        np.testing.assert_allclose(getattr(gru, k[4:]).grad.numpy(),
                                   v.numpy(), atol=ATOL_F32, rtol=0,
                                   err_msg=k)


def test_split_plain_backward_matches_jax_vjp():
    """The plain backward as the port splits it (hoisted hh, the serial
    loop gru_backward_loop on CPU tensors, hoisted d_w_hh / d_b_hh) against
    jax.vjp of _gru_scan, with a cotangent on the outputs and on the final
    state (the port's recurrence returns no separate final state, so that
    cotangent joins d_outs[-1])."""
    t, b, h = 7, 3, 48
    rng = np.random.default_rng(4)
    xp = (rng.normal(size=(t, 2, b, 3 * h)) * 0.5).astype(np.float32)
    h0 = (rng.normal(size=(2, b, h)) * 0.5).astype(np.float32)
    w_hh = (rng.normal(size=(2, h, 3 * h)) * 0.1).astype(np.float32)
    b_hh = (rng.normal(size=(2, 3 * h)) * 0.1).astype(np.float32)
    d_outs = rng.normal(size=(t, 2, b, h)).astype(np.float32)
    d_final = rng.normal(size=(2, b, h)).astype(np.float32)
    _, vjp = jax.vjp(_gru_scan, *map(jnp.asarray, (xp, h0, w_hh, b_hh)))
    want = vjp((jnp.asarray(d_outs), jnp.asarray(d_final)))

    args = list(map(torch.from_numpy, (xp, h0, w_hh, b_hh)))
    outs = gru_recurrence_plain(*args)
    ct = torch.from_numpy(d_outs).clone()
    ct[-1] += torch.from_numpy(d_final)
    launches = gru_backward_loop.launches
    got = gru_recurrence_backward(*args, outs, ct)
    assert gru_backward_loop.launches == launches       # CPU: plain loop
    for name, g, w in zip(("d_xp", "d_h0", "d_w_hh", "d_b_hh"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_F32,
                                   rtol=0, err_msg=name)


def test_backward_loop_rejects_bad_inputs():
    t, b, h = 3, 2, 8
    xp = torch.zeros((t, 2, b, 3 * h))
    hh, h_prev = torch.zeros((t, 2, b, 3 * h)), torch.zeros((t, 2, b, h))
    w_hh, d_outs = torch.zeros((2, h, 3 * h)), torch.zeros((t, 2, b, h))
    with pytest.raises(ValueError, match="hh"):
        gru_backward_loop(xp, hh.double(), h_prev, w_hh, d_outs)
    with pytest.raises(ValueError, match="d_outs"):
        gru_backward_loop(xp, hh, h_prev, w_hh, d_outs[:-1])


@pytest.mark.parametrize("H", [16, 48, 200, 300, MAX_HIDDEN])
def test_cluster_plan_covers_hidden_units(H):
    """The unit slices of a cluster's CTAs cover 0..H once, in order, and
    both kernels' shared memory fits at every row count."""
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 3, 8, 16, 96, 97):
            plan = cluster_plan(H, B, dtype)
            units = [j for lo, hi in plan["slices"] for j in range(lo, hi)]
            assert units == list(range(H))
            assert max(plan["smem_forward"], plan["smem_backward"]) <= 232448
            assert plan["clusters"] == 2 * -(-B // plan["rows"])
            assert plan["mma"] == (dtype == torch.bfloat16)


def test_cluster_plan_rejects_above_max_hidden():
    assert MAX_HIDDEN >= 300        # every config of configs*/ fits
    with pytest.raises(ValueError, match="does not fit"):
        cluster_plan(MAX_HIDDEN + 1, 16, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_plan_at_a_data_parallel_rank_rows(dtype):
    """The Expressive step's 96 rows on two data-parallel ranks: 48 rows a
    rank run as 3 row groups of 16, one cluster a direction each (6 of the
    15 the card runs at once), as chip_smoke.py times (34, 48, 300)."""
    from ha2g_torch.ops.gru_kernel import rows_per_group
    assert rows_per_group(48) == 16
    plan = cluster_plan(300, 48, dtype)
    assert plan["rows"] == 16 and plan["clusters"] == 2 * 3


def _trunc_tf32(v):
    """The TF32 truncation of float32 v (what the tensor cores read)."""
    return (v.view(torch.int32) & -0x2000).view(torch.float32)


def _split(v, scheme):
    """v = hi + lo as the backward kernel splits an operand."""
    if scheme == "bf16":
        hi = v.to(torch.bfloat16).float()
        return hi, (v - hi).to(torch.bfloat16).float()
    hi = _trunc_tf32(v)
    return hi, _trunc_tf32(v - hi)


def _emulated_backward_loop(xp, hh, h_prev, w_hh, d_outs, scheme):
    """The backward kernel's arithmetic (csrc/gru_recurrence.cu) in float32
    on the CPU: CTA k of the 8 owns the units J_k and the gate columns
    C_k = {j, H+j, 2H+j : j in J_k}, multiplies d_gh[:, C_k], split into
    hi + lo, by w_hh[:, C_k]^T for all units (each chain a product of its
    own, the chains added in the kernel's order: bf16 hi, lo; TF32 hi.hi,
    lo.hi, hi.lo), and the owner of each unit sums g z and the 8 partials
    in the order k = 0..7."""
    T, H = xp.shape[0], h_prev.shape[-1]
    hs = -(-H // 8)
    x = xp.float()
    r = torch.sigmoid(x[..., :H] + hh[..., :H])
    z = torch.sigmoid(x[..., H:2 * H] + hh[..., H:2 * H])
    h_n = hh[..., 2 * H:]
    n = torch.tanh(x[..., 2 * H:] + r * h_n)
    f_n = (1.0 - z) * (1.0 - n * n)
    f_z = (h_prev - n) * z * (1.0 - z)
    f_r = f_n * h_n * r * (1.0 - r)
    w = w_hh.float()
    w_hi, w_lo = _split(w, scheme) if scheme == "tf32x3" else (w, None)
    slices = []
    for k in range(8):
        units = list(range(k * hs, min(H, (k + 1) * hs)))
        slices.append([g * H + j for g in range(3) for j in units])
    d_outs = d_outs.float()
    d_gx, d_gh = torch.empty_like(hh), torch.empty_like(hh)
    dh = torch.zeros_like(d_outs[0])
    for t in range(T - 1, -1, -1):
        g = dh + d_outs[t]
        d_gx[t] = g.repeat(1, 1, 3) * torch.cat([f_r[t], f_z[t], f_n[t]], -1)
        d_gh[t] = g.repeat(1, 1, 3) * torch.cat(
            [f_r[t], f_z[t], f_n[t] * r[t]], -1)
        a_hi, a_lo = _split(d_gh[t], scheme)
        dh = g * z[t]
        for cols in slices:
            wt = lambda m: m[:, :, cols].transpose(1, 2)     # (2, |C_k|, H)
            if scheme == "bf16":
                chains = [torch.bmm(a[:, :, cols], wt(w)) for a in (a_hi, a_lo)]
            else:
                chains = [torch.bmm(a_hi[:, :, cols], wt(w_hi)),
                          torch.bmm(a_lo[:, :, cols], wt(w_hi)),
                          torch.bmm(a_hi[:, :, cols], wt(w_lo))]
            part = chains[0]
            for c in chains[1:]:
                part = part + c
            dh = dh + part
    return d_gx, d_gh, dh


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("scheme", ["bf16", "tf32x3"])
@pytest.mark.parametrize("t,b,h", [(34, 96, 300), (11, 5, 200)])
def test_split_product_emulation_matches_plain_and_jax_vjp(t, b, h, scheme):
    """The backward kernel's precision scheme before any card run: the
    column-sliced d_gh . w_hh^T with d_gh split into bf16 hi + lo (bf16
    storage: xp, w_hh and d_outs hold bf16 values) or into TF32 hi + lo
    with w_hh split too (fp32 storage), partials summed over the 8 CTAs in
    the kernel's order, against the plain loop on the same inputs and the
    whole backward against jax.vjp of the JAX scan, relative L2 <= 1e-4."""
    rng = np.random.default_rng(5)
    k = h ** -0.5
    xp = rng.normal(size=(t, 2, b, 3 * h)) * 0.5
    h0 = rng.normal(size=(2, b, h)) * 0.5
    w_hh = rng.uniform(-k, k, size=(2, h, 3 * h))
    b_hh = rng.uniform(-k, k, size=(2, 3 * h))
    d_outs = rng.normal(size=(t, 2, b, h))
    xp, h0, w_hh, b_hh, d_outs = (torch.from_numpy(a.astype(np.float32))
                                  for a in (xp, h0, w_hh, b_hh, d_outs))
    if scheme == "bf16":      # the values bf16 storage holds, in float32
        xp, w_hh, d_outs = (a.to(torch.bfloat16).float()
                            for a in (xp, w_hh, d_outs))
    outs = gru_recurrence_plain(xp, h0, w_hh, b_hh)
    h_prev = torch.cat([h0[None], outs[:-1]])
    hh = torch.einsum("tdbh,dhg->tdbg", h_prev, w_hh) + b_hh[None, :, None]
    got = _emulated_backward_loop(xp, hh, h_prev, w_hh, d_outs, scheme)
    want = gru_backward_loop_plain(xp, hh, h_prev, w_hh, d_outs)
    for name, g, w in zip(("d_gx", "d_gh", "d_h0"), got, want):
        assert _rel_l2(g, w) <= 1e-4, name

    _, vjp = jax.vjp(_gru_scan, *(jnp.asarray(a.numpy())
                                  for a in (xp, h0, w_hh, b_hh)))
    jax_grads = vjp((jnp.asarray(d_outs.numpy()), jnp.zeros((2, b, h))))
    d_gx, d_gh, d_h0 = got
    ours = (d_gx, d_h0, torch.einsum("tdbh,tdbg->dhg", h_prev, d_gh),
            d_gh.sum(dim=(0, 2)))
    for name, g, w in zip(("d_xp", "d_h0", "d_w_hh", "d_b_hh"), ours,
                          jax_grads):
        assert _rel_l2(g, w) <= 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_plan_backward_keys(dtype):
    """The backward's own row groups: 16 rows (an m-tile), 32 in bf16
    above a batch of 112, so the baselines' batch 128 runs as 8 clusters
    and the Expressive step's 96 as 12 (the card holds 15 at once); its
    shared memory fits at every batch; the forward's keys unchanged."""
    for B in (1, 3, 8, 16, 32, 96, 97, 113, 128, 200, 256):
        plan = cluster_plan(300, B, dtype)
        assert plan["smem_backward"] <= 232448
        assert plan["rows_backward"] == (32 if dtype == torch.bfloat16
                                         and B > 112 else 16)
        assert plan["clusters_backward"] == 2 * -(-B // plan["rows_backward"])
        assert plan["clusters"] == 2 * -(-B // plan["rows"])
    if dtype == torch.bfloat16:
        for B in (96, 128):
            assert cluster_plan(300, B, dtype)["clusters_backward"] <= 15
    assert MAX_HIDDEN >= 313


def test_chip_smoke_counts_backward_spills():
    """chip_smoke.py fails a build whose ptxas log shows B1's backward
    kernel spilling, and only its spills count."""
    import chip_smoke
    head = "ptxas info    : Function properties for _ZN12_GLOBAL__N_1{}\n"
    row = "    0 bytes stack frame, {} bytes spill stores, {} bytes spill loads\n"
    log = (head.format("19gru_backward_kernelIfLi1EEEvPKT_") + row.format(0, 0)
           + head.format("21gru_recurrence_kernelIfLi16ELb0EEEvPKT_")
           + row.format(8, 8))
    assert chip_smoke._backward_spills({"gru": log}) == 0
    spilled = log + head.format("19gru_backward_kernelI13__nv_bfloat16Li2EEE"
                                "vPKT_") + row.format(4, 12)
    with pytest.raises(AssertionError, match="spills 16 bytes"):
        chip_smoke._backward_spills({"gru": spilled})

