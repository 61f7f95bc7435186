"""Kernel B1: the fused bidirectional GRU recurrence of one layer.

``gru_recurrence`` launches the hand-written CUDA kernel
``csrc/gru_recurrence.cu`` (replacing the TPU kernel
``ha2g_tpu/ops/pallas_gru.py::_kernel``) on CUDA tensors, and its plain
PyTorch version ``gru_recurrence_plain`` on CPU tensors.  A CUDA tensor
either reaches the kernel or raises.  ``gru_recurrence.launches`` counts
kernel launches.

Layout (same as the TPU kernel): xp (T, 2, B, 3H) input projections with
direction 1 already time-reversed, h0 (2, B, H), w_hh (2, H, 3H),
b_hh (2, 3H) -> outputs (T, 2, B, H).  Gates are computed in float32; the
carry is rounded to the input dtype (float32 or bfloat16) every step.

``gru_recurrence_fn`` is the differentiable form: its forward is
``gru_recurrence`` (the kernel on the card), its backward
``gru_recurrence_backward``, PyTorch ops that copy the JAX package's hand
VJP ``ha2g_tpu/ops/gru.py::_gru_scan_bwd`` (the JAX package has no Pallas
backward to port).  ``gru_recurrence_backward.calls`` counts its calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ha2g_torch import kernels

SOURCE = kernels.CSRC / "gru_recurrence.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel keeps 4 rows x 4H floats of carry and gate sums in 48 KB of
# shared memory
MAX_HIDDEN = 768


@functools.cache
def _entry():
    fn = kernels.load(SOURCE).ha2g_gru_recurrence
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def gru_recurrence(xp, h0, w_hh, b_hh) -> torch.Tensor:
    """The recurrence of one bidirectional GRU layer (see module doc)."""
    T, B, H = _check(xp, h0, w_hh, b_hh)
    devices = {t.device for t in (xp, h0, w_hh, b_hh)}
    if devices == {torch.device("cpu")}:
        return gru_recurrence_plain(xp, h0, w_hh, b_hh)
    if len(devices) != 1 or xp.device.type != "cuda":
        raise ValueError(f"gru_recurrence needs all tensors on one CUDA "
                         f"device or all on the CPU, got {devices}")
    if not all(t.is_contiguous() for t in (xp, h0, w_hh, b_hh)):
        raise ValueError("gru_recurrence needs contiguous tensors")
    if H > MAX_HIDDEN:
        raise ValueError(f"hidden size {H} exceeds the kernel's {MAX_HIDDEN}")
    out = torch.empty((T, 2, B, H), dtype=xp.dtype, device=xp.device)
    fn = _entry()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), h0.data_ptr(), w_hh.data_ptr(),
                 b_hh.data_ptr(), out.data_ptr(), T, B, H,
                 _DTYPE_CODES[xp.dtype], stream)
    if err != 0:
        raise RuntimeError(f"gru_recurrence kernel launch failed: CUDA error "
                           f"{err}")
    gru_recurrence.launches += 1
    return out


gru_recurrence.launches = 0


def gru_recurrence_backward(xp, h0, w_hh, b_hh, outs, d_outs):
    """(d_xp, d_h0, d_w_hh, d_b_hh) of one layer's recurrence given the
    forward's inputs, its outputs and their cotangent, all math in float32.

    The kernel keeps no per-step hh = h_prev . w_hh + b_hh, so it is
    recomputed for all T in one batched product from cat(h0, outs[:-1]), as
    the JAX Pallas path recomputes it by re-running the scan
    (ha2g_tpu/ops/pallas_gru.py:138-141).  The gate factors of every step
    depend only on the forward, so they are formed for all T at once; the
    reverse loop carries dh through one d_gh . w_hh^T product per step, and
    d_w_hh / d_b_hh are single hoisted contractions over (T, B).
    """
    gru_recurrence_backward.calls += 1
    T, H = xp.shape[0], h0.shape[-1]
    w = w_hh.float()
    h_prev = torch.cat([h0[None], outs[:-1]]).float()            # (T,2,B,H)
    hh = torch.einsum("tdbh,dhg->tdbg", h_prev, w) \
        + b_hh.float()[None, :, None]
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
    w_t = w.transpose(1, 2)                                    # (2, 3H, H)
    d_outs = d_outs.float()
    g_seq = torch.empty_like(d_outs)
    dh = torch.zeros_like(d_outs[0])
    for t in range(T - 1, -1, -1):
        g = dh + d_outs[t]
        g_seq[t] = g
        dh = g * z[t] + torch.bmm(g.repeat(1, 1, 3) * coef_gh[t], w_t)
    g3 = g_seq.repeat(1, 1, 1, 3)
    d_gh = g3 * coef_gh
    d_xp = g3 * torch.cat([f_r, f_z, f_n], dim=-1)
    d_w_hh = torch.einsum("tdbh,tdbg->dhg", h_prev, d_gh)
    d_b_hh = d_gh.sum(dim=(0, 2))
    return (d_xp.to(xp.dtype), dh.to(h0.dtype), d_w_hh.to(w_hh.dtype),
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
