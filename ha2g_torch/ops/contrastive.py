"""Kernels B2-B4: the flash softmax-contrastive loss.

``flash_contrastive(a, b)`` is the contrastive cross-entropy over
inverse-L2 logits of L2-normalised rows a, b (N, D) float32 with diagonal
labels, ha2g_tpu/train/losses.py::_contrastive_core with its hand backward.
On CUDA tensors it runs the hand-written kernels of
``csrc/contrastive.cu`` (replacing ha2g_tpu/ops/pallas_contrastive.py):

* B2 ``contrastive_fwd``: logz = logsumexp_j logit_ij and diag = logit_ii,
  (N,) each; the loss is mean(logz - diag), taken here in torch as JAX takes
  it outside its kernel;
* B3 ``contrastive_bwd_da``: dA = ds . b;  B4 ``contrastive_bwd_db``:
  dB = ds^T . a, with ds recomputed tile by tile from a, b, logz and g/N.

The kernels compute s = a.b^T on the tensor cores in 3xTF32 and split the
columns over ``splits(...)`` blocks a row tile; each call allocates the
blocks' partial results (B2: 3 S N floats, B3 / B4: S N D) and hands the
kernel a per-stream buffer of arrival counters that the kernels leave
zeroed (see the source's header).

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute (``kernels.launch``); for CPU tensors it runs
its plain PyTorch version (``*_plain``), which materialises the (N, N)
logits, and counts nothing.  A CUDA tensor reaches the kernel or raises.
Every N is served (the kernels mask the ragged edge); D is at most
``MAX_DIM``.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from ha2g_torch import kernels
from ha2g_torch.utils.roofline import kernel_call

SOURCE = kernels.CSRC / "contrastive.cu"
MAX_DIM = 512
EPS = 1e-8
TILE = 64            # rows a block owns, and rows of a column tile
FEATURE_CHUNK = 32   # output features a B3 / B4 block computes


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ha2g_contrastive_splits.argtypes = [i32] * 3
    lib.ha2g_contrastive_check_math.argtypes = [ctypes.c_uint] * 2 + [i32]
    lib.ha2g_contrastive_check_math.restype = ctypes.c_longlong
    lib.ha2g_contrastive_fwd.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    for name in ("ha2g_contrastive_bwd_da", "ha2g_contrastive_bwd_db"):
        getattr(lib, name).argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
    for name in ("ha2g_contrastive_splits", "ha2g_contrastive_fwd",
                 "ha2g_contrastive_bwd_da", "ha2g_contrastive_bwd_db"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.cache
def splits(which: int, N: int, D: int, device_index: int) -> int:
    """The column splits S of kernel ``which`` (0: B2, 1: B3, 2: B4) at
    (N, D), from the kernel's occupancy on the device: the S that
    minimises waves x (tiles a split + 1), at most 16 (see the source)."""
    with torch.cuda.device(device_index):
        S = _lib().ha2g_contrastive_splits(which, N, D)
    if S < 1:
        raise RuntimeError(f"contrastive kernel {which}: no split plan at "
                           f"N={N} D={D}")
    return S


def _f32_bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def math_mismatches() -> dict[str, int]:
    """The kernels' branch-free sqrt and reciprocal against IEEE sqrtf and
    1.0f / x on the current CUDA device, over every float that the logits
    can give them: sqrt of [1e-12, 4.01], reciprocal of [1e-6, 2.01].
    Returns the number of inputs where they differ (0 expected)."""
    lib = _lib()
    out = {"sqrt": lib.ha2g_contrastive_check_math(
               _f32_bits(1e-12), _f32_bits(4.01), 0),
           "rcp": lib.ha2g_contrastive_check_math(
               _f32_bits(1e-6), _f32_bits(2.01), 1)}
    if min(out.values()) < 0:
        raise RuntimeError("the contrastive math check failed to run")
    return out


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The arrival counters of one stream, n int32 zeros at least.  The
    kernels leave them zeroed, so one buffer serves every call that the
    stream orders after it."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


def _float32(name: str, tensors) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name} takes float32 tensors")


def _check(a, b) -> tuple[int, int]:
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"a and b must both be (N, D), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    N, D = a.shape
    if N == 0 or D == 0 or D > MAX_DIM:
        raise ValueError(f"the contrastive kernels take 0 < D <= {MAX_DIM} "
                         f"and N > 0, got N={N} D={D}")
    return N, D


def _rows_for_kernel(*tensors):
    """The kernels stage 16-byte pieces of rows: pad D to a multiple of 4
    with zero features (which add exactly 0 to every s) and give every
    tensor a 16-byte aligned start."""
    D = tensors[0].shape[1]
    pad = -D % 4
    out = []
    for t in tensors:
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        elif t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# plain versions: losses.py::_contrastive_core / _contrastive_bwd in torch
# ---------------------------------------------------------------------------

def _logits(s):
    """s = <a_i, b_j> -> (inverse-L2 logits, dist)."""
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * s, min=0.0) + 1e-12)
    return torch.clamp(1.0 / (dist + EPS), min=EPS), dist


def contrastive_fwd_plain(a, b):
    logits, _ = _logits(a @ b.T)
    return torch.logsumexp(logits, dim=1), torch.diagonal(logits).clone()


def _ds_plain(a, b, logz, g_over_n):
    s = a @ b.T
    logits, dist = _logits(s)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    dlogits = (torch.exp(logits - logz[:, None]) - eye) * g_over_n
    active = (logits > EPS) & (2.0 - 2.0 * s > 0.0)
    return torch.where(active, dlogits / ((dist + EPS) ** 2 * dist), 0.0)


def contrastive_bwd_da_plain(a, b, logz, g_over_n):
    return _ds_plain(a, b, logz, g_over_n) @ b


def contrastive_bwd_db_plain(a, b, logz, g_over_n):
    return _ds_plain(a, b, logz, g_over_n).T @ a


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def fwd_flops(N: int, D: int) -> int:
    """B2's FLOPs (``utils/roofline.py``): FlopCounterMode's count of its
    plain version, the (N, D) x (D, N) product."""
    return 2 * N * N * D


def bwd_flops(N: int, D: int) -> int:
    """B3's or B4's FLOPs: FlopCounterMode's count of the plain version,
    s recomputed and ds times b (or a), two (N, N, D) products."""
    return 4 * N * N * D


def contrastive_fwd(a, b):
    """B2: (logz, diag), each (N,) float32."""
    N, D = _check(a, b)
    with kernel_call(fwd_flops(N, D)):
        if not kernels.on_card("contrastive_fwd", (a, b)):
            return contrastive_fwd_plain(a, b)
        _float32("contrastive_fwd", (a, b))
        dev = a.device
        a, b = _rows_for_kernel(a, b)
        D4 = a.shape[1]
        S = splits(0, N, D4, dev.index)
        logz = torch.empty(N, dtype=torch.float32, device=dev)
        diag = torch.empty_like(logz)
        part = torch.empty(3 * S * N, dtype=torch.float32, device=dev)
        counters = _counters(dev, -(-N // TILE))
        kernels.launch(contrastive_fwd, _lib().ha2g_contrastive_fwd, dev,
                       a.data_ptr(), b.data_ptr(), logz.data_ptr(),
                       diag.data_ptr(), part.data_ptr(), counters.data_ptr(),
                       N, D4, S)
    return logz, diag


def _bwd(wrapper, which, a, b, logz, g_over_n, plain):
    name = wrapper.__name__
    N, D = _check(a, b)
    if tuple(logz.shape) != (N,) or g_over_n.numel() != 1:
        raise ValueError(f"{name}: logz must be ({N},) and g_over_n one "
                         f"value, got {tuple(logz.shape)} and "
                         f"{tuple(g_over_n.shape)}")
    with kernel_call(bwd_flops(N, D)):
        tensors = (a, b, logz, g_over_n)
        if not kernels.on_card(name, tensors):
            return plain(a, b, logz, g_over_n.reshape(()))
        _float32(name, tensors)
        dev = a.device
        a, b = _rows_for_kernel(a, b)
        D4 = a.shape[1]
        S = splits(which, N, D4, dev.index)
        out = torch.empty((N, D4), dtype=torch.float32, device=dev)
        part = torch.empty((S, N, D4), dtype=torch.float32, device=dev)
        counters = _counters(dev, -(-N // TILE) * -(-D4 // FEATURE_CHUNK))
        kernels.launch(wrapper, getattr(_lib(), f"ha2g_{name}"), dev,
                       a.data_ptr(), b.data_ptr(), logz.data_ptr(),
                       g_over_n.data_ptr(), out.data_ptr(), part.data_ptr(),
                       counters.data_ptr(), N, D4, S)
    return out[:, :D] if D4 != D else out


def contrastive_bwd_da(a, b, logz, g_over_n):
    """B3: dA (N, D); ``g_over_n`` is the loss's cotangent over the global
    N, one float32 value on the tensors' device."""
    return _bwd(contrastive_bwd_da, 1, a, b, logz, g_over_n,
                contrastive_bwd_da_plain)


def contrastive_bwd_db(a, b, logz, g_over_n):
    """B4: dB (N, D); arguments as for B3."""
    return _bwd(contrastive_bwd_db, 2, a, b, logz, g_over_n,
                contrastive_bwd_db_plain)


contrastive_fwd.launches = 0
contrastive_bwd_da.launches = 0
contrastive_bwd_db.launches = 0


class _FlashContrastive(torch.autograd.Function):
    """Forward B2 then mean(logz - diag); backward B3 then B4."""

    @staticmethod
    def forward(ctx, a, b):
        logz, diag = contrastive_fwd(a, b)
        ctx.save_for_backward(a, b, logz)
        return (logz - diag).mean()

    @staticmethod
    def backward(ctx, g):
        a, b, logz = ctx.saved_tensors
        g_over_n = (g.float() / a.shape[0]).reshape(1).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = contrastive_bwd_da(a, b, logz, g_over_n)
        if ctx.needs_input_grad[1]:
            db = contrastive_bwd_db(a, b, logz, g_over_n)
        return da, db


def flash_contrastive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Contrastive CE over inverse-L2 logits of unit rows a, b (N, D)."""
    return _FlashContrastive.apply(a, b)
