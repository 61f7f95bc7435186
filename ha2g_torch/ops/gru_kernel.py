"""Kernel B1: the fused bidirectional GRU recurrence of one layer, forward
and backward.

``gru_recurrence`` launches the hand-written CUDA kernel
``csrc/gru_recurrence.cu`` (replacing the TPU kernel
``ha2g_tpu/ops/pallas_gru.py::_kernel``) on CUDA tensors, and its plain
PyTorch version ``gru_recurrence_plain`` on CPU tensors.  A CUDA tensor
either reaches the kernel or raises.  ``gru_recurrence.launches`` counts
the kernel's executions, a CUDA graph's replays included
(``kernels.launch``).

Layout (same as the TPU kernel): xp (T, 2, B, 3H) input projections with
direction 1 already time-reversed, h0 (2, B, H), w_hh (2, H, 3H),
b_hh (2, 3H) -> outputs (T, 2, B, H).  Gates are computed in float32; the
carry is rounded to the input dtype (float32 or bfloat16) every step.

``gru_recurrence_fn`` is the differentiable form: its forward is
``gru_recurrence``, its backward ``gru_recurrence_backward``, which copies
the JAX package's hand VJP ``ha2g_tpu/ops/gru.py::_gru_scan_bwd`` (the JAX
package has no Pallas backward to port): one hoisted product recomputes
hh, the serial reverse loop ``gru_backward_loop`` runs the backward kernel
of the same source on CUDA tensors (``.launches``) and its plain version
``gru_backward_loop_plain`` on CPU tensors, and d_w_hh / d_b_hh are one
contraction each.  ``gru_recurrence_backward.calls`` counts its calls.

Both kernels split the hidden units over a thread-block cluster of
``CLUSTER`` CTAs (``cluster_plan``); ``MAX_HIDDEN`` is the largest hidden
size whose share of ``w_hh`` fits one CTA in both dtypes.  The backward
kernel's d_gh . w_hh^T product runs on the tensor cores: in bf16 with d_gh
split into bf16 hi + lo (~2^-17 relative to an fp32 product), in fp32 as
3xTF32; its clusters carry ``rows_backward`` rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ha2g_torch import kernels
from ha2g_torch.utils.roofline import kernel_call

SOURCE = kernels.CSRC / "gru_recurrence.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the cluster split, as csrc/gru_recurrence.cu computes it
CLUSTER = 8            # CTAs per cluster
THREADS = 256          # threads per CTA
MAX_ITEMS = 4          # (row, unit) items per thread
SMEM_LIMIT = 232448    # bytes of dynamic shared memory a CTA may use


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rup(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _ldw(k4: int) -> int:
    """Row stride of the FFMA kernels' w_hh slice: k4 / 4 odd."""
    return k4 if k4 // 4 % 2 else k4 + 4


def rows_per_group(B: int) -> int:
    """Rows of the batch one forward cluster carries."""
    return next((rb for rb in (1, 2, 4, 8) if B <= rb), 16)


BWD_SPLIT_BATCH = 112  # bf16: the backward's clusters carry 32 rows above


def rows_backward(B: int, dtype: torch.dtype) -> int:
    """Rows of the batch one backward cluster carries: 16 (an m-tile), 32
    in bf16 above BWD_SPLIT_BATCH, where 16 would need more clusters than
    the card runs at once."""
    return 32 if dtype == torch.bfloat16 and B > BWD_SPLIT_BATCH else 16


def _backward_smem(H: int, rb: int, dtype: torch.dtype) -> int:
    """The backward's shared memory (csrc/gru_recurrence.cu::bwd_smem):
    fp32 keeps w_hh[:, C_k] ([H][kw]) and d_gh ([rb][kw]) as floats, bf16
    d_gh as hi and lo ([2][rb][136]); the partials of every source CTA
    twice over, g z and the staged inputs (two buffers in bf16, one in
    fp32) in whole 16-byte chunks, then the two recv buffers' mbarriers;
    bf16 first stages w_hh[:, C_k] after d_gh."""
    hs = _cdiv(H, CLUSTER)
    elem = 4 if dtype == torch.float32 else 2
    sx = 16 * _cdiv(hs + 16 // elem - 1, 16 // elem)
    sf = 16 * _cdiv(hs + 3, 4)
    if dtype == torch.bfloat16:
        w, a, nst = 0, _rup(2 * rb * 136 * 2, 16), 2
    else:
        kw = _rup(3 * hs, 8) + 4
        w, a, nst = _rup(H * kw * 4, 16), _rup(rb * kw * 4, 16), 1
    total = (w + a + 2 * CLUSTER * rb * hs * 4 + _rup(rb * hs * 4, 16)
             + nst * rb * 4 * (sx + sf))
    # bf16 first stages w_hh[:, C_k] after d_gh: 3 row slices a unit, then
    # rows of 136 (ldmatrix)
    w_t = a + _rup(H * 3 * sx, 16) + _rup(H, 8) * 136 * 2
    if dtype == torch.bfloat16:
        total = max(total, w_t)
    return _rup(total, 16) + 16      # and an mbarrier for each recv buffer


def cluster_plan(H: int, B: int, dtype: torch.dtype) -> dict:
    """How both kernels split a layer of hidden size H at batch B: the
    unit slice of every CTA of a cluster; the forward's rows a cluster,
    clusters and shared memory in bytes (on the tensor cores for bf16,
    rows padded to 16); the backward's (``rows_backward``; its product on
    the tensor cores, bf16 split hi + lo or 3xTF32).  Raises ValueError
    where a CTA's share does not fit."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype}")
    elem = 4 if dtype == torch.float32 else 2
    rb = rows_per_group(B)
    hs = _cdiv(H, CLUSTER)
    h4 = _rup(H, 4)
    mma = dtype == torch.bfloat16
    if mma:     # w_hh's slice lives in registers
        npad, kp = _rup(3 * hs, 8), _rup(H, 16) + 8
        fwd = _rup(npad * 4, 16) + _rup(2 * 16 * kp * 2, 16) + 16 * npad * 4
    else:
        n = 3 * hs
        ks = THREADS // (32 * (rb // min(rb, 8)))
        fwd = (_rup(n * _ldw(h4) * elem, 16) + _rup(n * 4, 16)
               + _rup(2 * rb * h4 * 4, 16) + ks * rb * n * 4)
    rb_bwd = rows_backward(B, dtype)
    bwd = _backward_smem(H, rb_bwd, dtype)
    plan = {"slices": [(min(H, k * hs), min(H, (k + 1) * hs))
                       for k in range(CLUSTER)],
            "rows": rb, "clusters": 2 * _cdiv(B, rb), "mma": mma,
            "smem_forward": fwd, "rows_backward": rb_bwd,
            "clusters_backward": 2 * _cdiv(B, rb_bwd), "smem_backward": bwd}
    # forward register tiles: 3 hs gate columns over 32 lanes x 4, the mma
    # B fragments 20 k-steps of 16; backward: 3 hs columns in 8 k-steps of
    # 16, H units in 3 n-tiles of 8 a warp of 16
    if (max(fwd, bwd) > SMEM_LIMIT or rb * hs > MAX_ITEMS * THREADS
            or 3 * hs > 128 or (mma and H > 320) or _cdiv(H, 8) > 16 * 3):
        raise ValueError(f"hidden size {H} does not fit the cluster kernels "
                         f"(shared memory {fwd} / {bwd} bytes of "
                         f"{SMEM_LIMIT})")
    return plan


def _max_hidden() -> int:
    def fits(H):
        try:
            for dtype in _DTYPE_CODES:
                for B in (1, 2, 4, 8, 16, 128):
                    cluster_plan(H, B, dtype)
        except ValueError:
            return False
        return True
    H = 1
    while fits(H + 1):
        H += 1
    return H


MAX_HIDDEN = _max_hidden()


@functools.cache
def _lib():
    lib = kernels.load(SOURCE)
    lib.ha2g_gru_recurrence.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.ha2g_gru_backward.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.ha2g_gru_max_active_clusters.argtypes = [ctypes.c_int] * 4
    for fn in (lib.ha2g_gru_recurrence, lib.ha2g_gru_backward,
               lib.ha2g_gru_max_active_clusters):
        fn.restype = ctypes.c_int
    return lib


def max_active_clusters(B: int, H: int, dtype: torch.dtype,
                        backward: bool = False) -> int:
    """cudaOccupancyMaxActiveClusters for one kernel at one shape."""
    n = _lib().ha2g_gru_max_active_clusters(B, H, _DTYPE_CODES[dtype],
                                            int(backward))
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {-n}")
    return n


def _check(xp, h0, w_hh, b_hh) -> tuple[int, int, int]:
    if xp.dim() != 4 or xp.shape[1] != 2 or xp.shape[3] % 3:
        raise ValueError(f"xp must be (T, 2, B, 3H), got {tuple(xp.shape)}")
    T, _, B, G = xp.shape
    H = G // 3
    want = {"h0": (2, B, H), "w_hh": (2, H, G), "b_hh": (2, G)}
    for name, t in (("h0", h0), ("w_hh", w_hh), ("b_hh", b_hh)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != xp.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != xp dtype {xp.dtype}")
    if xp.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {xp.dtype}")
    return T, B, H


def gru_recurrence_plain(xp, h0, w_hh, b_hh) -> torch.Tensor:
    """Plain PyTorch version: the scan of pallas_gru.py::_scan_forward with
    the kernel's precision (fp32 gates, carry rounded to xp.dtype)."""
    H = h0.shape[-1]
    w = w_hh.float()
    b = b_hh.float()[:, None, :]
    h = h0
    outs = []
    for x_t in xp.unbind(0):
        hf = h.float()
        hh = torch.bmm(hf, w) + b
        x = x_t.float()
        r = torch.sigmoid(x[..., :H] + hh[..., :H])
        z = torch.sigmoid(x[..., H:2 * H] + hh[..., H:2 * H])
        n = torch.tanh(x[..., 2 * H:] + r * hh[..., 2 * H:])
        h = ((1.0 - z) * n + z * hf).to(xp.dtype)
        outs.append(h)
    return torch.stack(outs)


def forward_flops(T: int, B: int, H: int) -> int:
    """B1 forward's FLOPs (``utils/roofline.py``): the TPU kernel's
    CostEstimate, 2 T D B H G + 10 T D B H with D = 2 and G = 3H
    (ha2g_tpu/ops/pallas_gru.py:101-104)."""
    D, G = 2, 3 * H
    return 2 * T * D * B * H * G + 10 * T * D * B * H


def backward_loop_flops(T: int, B: int, H: int) -> int:
    """The backward loop's FLOPs as FlopCounterMode counts its plain
    version: one (2, B, 3H) x (2, 3H, H) product a step."""
    return 2 * T * 2 * B * 3 * H * H


def gru_recurrence(xp, h0, w_hh, b_hh) -> torch.Tensor:
    """The recurrence of one bidirectional GRU layer (see module doc)."""
    T, B, H = _check(xp, h0, w_hh, b_hh)
    with kernel_call(forward_flops(T, B, H)):
        if not kernels.on_card("gru_recurrence", (xp, h0, w_hh, b_hh)):
            return gru_recurrence_plain(xp, h0, w_hh, b_hh)
        if H > MAX_HIDDEN:
            raise ValueError(f"hidden size {H} exceeds the kernel's "
                             f"{MAX_HIDDEN}")
        out = torch.empty((T, 2, B, H), dtype=xp.dtype, device=xp.device)
        kernels.launch(gru_recurrence, _lib().ha2g_gru_recurrence, xp.device,
                       xp.data_ptr(), h0.data_ptr(), w_hh.data_ptr(),
                       b_hh.data_ptr(), out.data_ptr(), T, B, H,
                       _DTYPE_CODES[xp.dtype])
    return out


gru_recurrence.launches = 0


def gru_backward_loop_plain(xp, hh, h_prev, w_hh, d_outs):
    """The serial part of the backward: (d_gx, d_gh, d_h0) in float32 from
    xp (T, 2, B, 3H), hh = h_prev . w_hh + b_hh (T, 2, B, 3H) float32,
    h_prev (T, 2, B, H) float32, w_hh (2, H, 3H) and the cotangent d_outs
    (T, 2, B, H).  The gate factors of every step depend only on the
    forward, so they are formed for all T at once; the reverse loop
    carries dh through one d_gh . w_hh^T product a step."""
    T, H = xp.shape[0], h_prev.shape[-1]
    x = xp.float()
    r = torch.sigmoid(x[..., :H] + hh[..., :H])
    z = torch.sigmoid(x[..., H:2 * H] + hh[..., H:2 * H])
    h_n = hh[..., 2 * H:]
    n = torch.tanh(x[..., 2 * H:] + r * h_n)
    # h' = (1-z) n + z h_prev, n = tanh(x_n + r h_n): per unit of the
    # incoming gradient g, d_pre_n = g f_n, d_pre_z = g f_z, d_pre_r = g f_r
    f_n = (1.0 - z) * (1.0 - n * n)
    f_z = (h_prev - n) * z * (1.0 - z)
    f_r = f_n * h_n * r * (1.0 - r)
    coef_gh = torch.cat([f_r, f_z, f_n * r], dim=-1)          # d_gh = g coef
    w_t = w_hh.float().transpose(1, 2)                         # (2, 3H, H)
    d_outs = d_outs.float()
    g_seq = torch.empty_like(d_outs)
    dh = torch.zeros_like(d_outs[0])
    for t in range(T - 1, -1, -1):
        g = dh + d_outs[t]
        g_seq[t] = g
        dh = g * z[t] + torch.bmm(g.repeat(1, 1, 3) * coef_gh[t], w_t)
    g3 = g_seq.repeat(1, 1, 1, 3)
    return g3 * torch.cat([f_r, f_z, f_n], dim=-1), g3 * coef_gh, dh


def gru_backward_loop(xp, hh, h_prev, w_hh, d_outs):
    """``gru_backward_loop_plain``'s function: the backward kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if xp.dim() != 4 or xp.shape[1] != 2 or xp.shape[3] % 3:
        raise ValueError(f"xp must be (T, 2, B, 3H), got {tuple(xp.shape)}")
    T, _, B, G = xp.shape
    H = G // 3
    want = {"hh": ((T, 2, B, G), torch.float32),
            "h_prev": ((T, 2, B, H), torch.float32),
            "w_hh": ((2, H, G), xp.dtype), "d_outs": ((T, 2, B, H), xp.dtype)}
    for name, t in (("hh", hh), ("h_prev", h_prev), ("w_hh", w_hh),
                    ("d_outs", d_outs)):
        if (tuple(t.shape), t.dtype) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{(tuple(t.shape), t.dtype)}")
    if xp.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {xp.dtype}")
    tensors = (xp, hh, h_prev, w_hh, d_outs)
    with kernel_call(backward_loop_flops(T, B, H)):
        if not kernels.on_card("gru_backward_loop", tensors):
            return gru_backward_loop_plain(*tensors)
        if H > MAX_HIDDEN:
            raise ValueError(f"hidden size {H} exceeds the kernel's "
                             f"{MAX_HIDDEN}")
        if any(t.data_ptr() % 16 for t in tensors):
            raise ValueError("gru_backward_loop needs 16-byte aligned inputs "
                             "(the kernel stages them in 16-byte chunks)")
        if xp.numel() > 2 ** 31 - 1:
            raise ValueError(f"xp {tuple(xp.shape)} too large for the "
                             f"kernel's 32-bit offsets")
        d_gx = torch.empty((T, 2, B, G), dtype=torch.float32,
                           device=xp.device)
        d_gh = torch.empty_like(d_gx)
        d_h0 = torch.empty((2, B, H), dtype=torch.float32, device=xp.device)
        kernels.launch(gru_backward_loop, _lib().ha2g_gru_backward,
                       xp.device,
                       *(t.data_ptr() for t in (*tensors, d_gx, d_gh, d_h0)),
                       T, B, H, _DTYPE_CODES[xp.dtype])
    return d_gx, d_gh, d_h0


gru_backward_loop.launches = 0


def gru_recurrence_backward(xp, h0, w_hh, b_hh, outs, d_outs):
    """(d_xp, d_h0, d_w_hh, d_b_hh) of one layer's recurrence given the
    forward's inputs, its outputs and their cotangent, all math in float32.

    The kernel keeps no per-step hh = h_prev . w_hh + b_hh, so it is
    recomputed for all T in one batched product from cat(h0, outs[:-1]), as
    the JAX Pallas path recomputes it by re-running the scan
    (ha2g_tpu/ops/pallas_gru.py:138-141); the serial loop is
    ``gru_backward_loop``; d_w_hh / d_b_hh are single hoisted contractions
    over (T, B).
    """
    gru_recurrence_backward.calls += 1
    h_prev = torch.cat([h0[None], outs[:-1]]).float()            # (T,2,B,H)
    hh = torch.einsum("tdbh,dhg->tdbg", h_prev, w_hh.float()) \
        + b_hh.float()[None, :, None]
    d_gx, d_gh, d_h0 = gru_backward_loop(xp, hh.contiguous(), h_prev, w_hh,
                                         d_outs.contiguous())
    d_w_hh = torch.einsum("tdbh,tdbg->dhg", h_prev, d_gh)
    d_b_hh = d_gh.sum(dim=(0, 2))
    return (d_gx.to(xp.dtype), d_h0.to(h0.dtype), d_w_hh.to(w_hh.dtype),
            d_b_hh.to(b_hh.dtype))


gru_recurrence_backward.calls = 0


class _GRURecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, h0, w_hh, b_hh):
        outs = gru_recurrence(xp, h0, w_hh, b_hh)
        ctx.save_for_backward(xp, h0, w_hh, b_hh, outs)
        return outs

    @staticmethod
    def backward(ctx, d_outs):
        grads = gru_recurrence_backward(*ctx.saved_tensors, d_outs)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def gru_recurrence_fn(xp, h0, w_hh, b_hh) -> torch.Tensor:
    """``gru_recurrence`` with a gradient (see module doc)."""
    return _GRURecurrence.apply(xp, h0, w_hh, b_hh)
