"""The denoiser's residual add and the layer norm after it, as one kernel.

``add_layer_norm(h, d, weight, bias, eps) -> (h', y)``: h' = h + d in the
tensors' type (bit for bit PyTorch's add), then y = layer_norm(h') over the
last dimension with ``weight`` and ``bias``, the statistics in float32 over
the rounded h', y in the tensors' type.  ``d`` has h's shape, or h's
trailing shape (the denoiser's (L, width) positional table, broadcast over
the rows as PyTorch's add broadcasts it).  With ``keep_sum=False`` h' is
not written and comes back as None (the denoiser's last norm).

CUDA tensors run the hand-written kernel of ``csrc/add_layer_norm.cu``
and count the launch in ``add_layer_norm.launches``
(``kernels.count_launch``); the kernel takes float32 or bfloat16 tensors
on one device, contiguous and 16-byte aligned, with rows a multiple of 16
bytes and at most ``MAX_PIECES`` 16-byte pieces, and raises on anything
else.  Where autograd records (the training step's epsilon loss), the
kernel's call is one ``_AddLayerNorm`` node: it keeps h' (written even
when not returned), and its backward is ``add_layer_norm_backward``, the
add's and the layer norm's own backward ops, the norm's statistics
recomputed from h'.  CPU tensors run ``add_layer_norm_plain``: the add,
then ``F.layer_norm``, the denoiser's two ops as they were.  The kernel's
h' is the plain version's bit for bit; its y may differ in the last bit,
as the statistics are summed in another order.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ha2g_torch import kernels

SOURCE = kernels.CSRC / "add_layer_norm.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the compute dtypes
MAX_PIECES = 4 * 32    # 16-byte pieces a row: four a lane of one warp


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ha2g_add_layer_norm.argtypes = ([i32] + [ptr] * 6 + [i32] * 3
                                        + [ctypes.c_float, ptr])
    lib.ha2g_add_layer_norm.restype = ctypes.c_int
    return lib


def add_layer_norm_plain(h, d, weight, bias, eps: float,
                         keep_sum: bool = True):
    """The add, then ``F.layer_norm``: (h + d or None, y)."""
    s = h + d
    y = F.layer_norm(s, (s.shape[-1],), weight, bias, eps)
    return (s if keep_sum else None), y


def _kernel_args(h, d, weight, bias) -> tuple[int, int, int]:
    """(rows, d_rows, width) of a kernel call; raises on what the kernel
    does not take."""
    tensors = (h, d, weight, bias)
    dev, dtype = h.device, h.dtype
    if not (d.device == dev and weight.device == dev and bias.device == dev):
        raise ValueError("add_layer_norm needs all tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if dtype not in DTYPES or not (d.dtype == dtype and weight.dtype == dtype
                                   and bias.dtype == dtype):
        raise ValueError("add_layer_norm takes float32 or bfloat16 tensors "
                         "of one type, got "
                         f"{[t.dtype for t in tensors]}")
    h_dim, d_dim = h.dim(), d.dim()
    width = h.shape[-1] if h_dim else 0
    if (h_dim == 0 or d_dim == 0 or d_dim > h_dim
            or d.shape != h.shape[h_dim - d_dim:]
            or weight.shape != (width,) or bias.shape != (width,)):
        raise ValueError("add_layer_norm needs d of h's shape or its trailing "
                         "shape and (width,) weight and bias, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not (h.is_contiguous() and d.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()) or (
            h.data_ptr() | d.data_ptr() | weight.data_ptr()
            | bias.data_ptr()) % 16:
        raise ValueError("add_layer_norm needs contiguous, 16-byte aligned "
                         "tensors")
    pieces, rem = divmod(width * h.element_size(), 16)
    if rem or not 0 < pieces <= MAX_PIECES:
        raise ValueError(f"add_layer_norm takes rows of 16 to {16 * MAX_PIECES}"
                         f" bytes in 16-byte pieces, got width {width} of "
                         f"{h.dtype}")
    return h.numel() // width, d.numel() // width, width


def add_layer_norm_backward(s, weight, bias, eps: float, d_shape, gs, gy):
    """The gradients (h, d, weight, bias) of ``add_layer_norm_plain`` from
    its sum ``s`` and the gradients of its outputs (``gs`` None where the
    sum's is): the layer norm's own backward op on the statistics that its
    forward op recomputes from ``s`` (as autograd runs them for
    ``F.layer_norm``), plus ``gs``; d's summed to its shape where it was
    broadcast."""
    width = (s.shape[-1],)
    _, mean, rstd = torch.native_layer_norm(s, width, weight, bias, eps)
    g, gw, gb = torch.ops.aten.native_layer_norm_backward(
        gy, s, width, mean, rstd, weight, bias, [True, True, True])
    if gs is not None:
        g = gs + g
    return g, g.sum_to_size(d_shape), gw, gb


def _launch(h, d, weight, bias, eps: float, keep_sum: bool):
    rows, d_rows, width = _kernel_args(h, d, weight, bias)
    s = torch.empty_like(h) if keep_sum else None
    y = torch.empty_like(h)
    with torch.cuda.device(h.device):
        err = _lib().ha2g_add_layer_norm(
            DTYPES[h.dtype], h.data_ptr(), d.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), None if s is None else s.data_ptr(),
            y.data_ptr(), rows, d_rows, width, eps,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_layer_norm kernel launch failed: CUDA error "
                           f"{err}")
    kernels.count_launch(add_layer_norm)
    return s, y


class _AddLayerNorm(torch.autograd.Function):
    """The kernel as one autograd node: (h, d, weight, bias) -> (h', y)."""

    @staticmethod
    def forward(ctx, h, d, weight, bias, eps):
        s, y = _launch(h, d, weight, bias, eps, keep_sum=True)
        ctx.save_for_backward(s, weight, bias)
        ctx.eps, ctx.d_shape = eps, d.shape
        ctx.set_materialize_grads(False)
        return s, y

    @staticmethod
    @once_differentiable
    def backward(ctx, gs, gy):
        s, weight, bias = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(s)
        return (*add_layer_norm_backward(s, weight, bias, ctx.eps,
                                         ctx.d_shape, gs, gy), None)


def add_layer_norm(h, d, weight, bias, eps: float, keep_sum: bool = True):
    """(h + d or None, layer_norm(h + d)): see the module doc."""
    if h.device.type != "cuda":
        return add_layer_norm_plain(h, d, weight, bias, eps, keep_sum)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, d, weight, bias)):
        s, y = _AddLayerNorm.apply(h, d, weight, bias, eps)
        return (s if keep_sum else None), y
    return _launch(h, d, weight, bias, eps, keep_sum)


add_layer_norm.launches = 0
