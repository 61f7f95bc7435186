"""Roofline / MFU accounting (the port of ha2g_tpu/utils/roofline.py).

``count_flops(fn, *args, **kwargs)`` counts the floating-point operations
of one call: torch's ``FlopCounterMode`` counts the ATen operations (a
product or convolution as 2·M·N·K, elementwise work as nothing), and each
hand-written kernel's wrapper adds its own count by formula, since a
kernel launched through ctypes is invisible to the mode.  A wrapper adds
the same formula whichever route it takes, and when it runs its plain
version (CPU tensors) the plain version's operations are hidden from the
mode, so one call counts the same on the CPU and on the card:

* B1 forward (``gru_recurrence``): the TPU kernel's ``CostEstimate``,
  2·T·D·B·H·G + 10·T·D·B·H with D = 2 directions and G = 3H
  (ha2g_tpu/ops/pallas_gru.py:101-104);
* B1's backward loop (``gru_backward_loop``) and B2-B4
  (``contrastive_fwd`` / ``_bwd_da`` / ``_bwd_db``): what the mode counts
  for their plain versions' products (``gru_kernel.backward_loop_flops``,
  ``contrastive.fwd_flops`` / ``bwd_flops``).

Convolutions follow torch's convention, not XLA's: the mode counts every
tap of a padded convolution, XLA's cost analysis leaves the zero taps
out, so the full-width 6-level SE-ResNet counts ~4.6% more here than the
JAX package's ``compiled_flops`` says for the same call.

While ``count_flops`` runs, every hand-kernel call in the process adds to
its count, from any thread (the autograd engine's too).

The denominator is the card's published dense bf16 peak
(``PEAK_TFLOPS_BF16``), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

# dense bf16 tensor-core peaks in TFLOP/s by torch.cuda.get_device_name:
# NVIDIA's H100 datasheet (SXM5 and PCIe, without sparsity), not
# measurements
PEAK_TFLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4,
    "NVIDIA H100 PCIe": 756.5,
}


class _Tally:
    def __init__(self):
        self.flops = 0


_active: list[_Tally] = []
_lock = threading.Lock()


@contextlib.contextmanager
def kernel_call(flops: int):
    """Around a hand kernel's call (either route): adds ``flops`` to every
    running ``count_flops`` and hides the operations inside from its
    ``FlopCounterMode`` (the plain version's, on CPU tensors)."""
    if not _active:
        yield
        return
    with _lock:
        for tally in _active:
            tally.flops += flops
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield


class _Global:
    """A module tracker that puts every count under "Global" alone."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def _flop_counter():
    """torch's FlopCounterMode without its per-module breakdown: the
    breakdown's forward hooks fail on a train step (a tensor that requires
    grad without a grad function), and only the total is read."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    mode.mod_tracker = _Global()
    return mode


def count_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)`` (see the module doc),
    or None when nothing was counted; the counterpart of JAX's
    ``compiled_flops``.  The call runs once, for real."""
    tally = _Tally()
    with _lock:
        _active.append(tally)
    try:
        with _flop_counter() as mode:
            fn(*args, **kwargs)
    finally:
        with _lock:
            _active.remove(tally)
    total = mode.get_total_flops() + tally.flops
    return float(total) if total > 0 else None


def device_kind(device=None) -> str:
    """The device's name as the peak table keys it: the card's
    ``torch.cuda.get_device_name``, else the device type."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(device)
    return device.type


def device_peak_tflops(device=None) -> Optional[float]:
    """The device's dense bf16 peak in TFLOP/s, None without an entry."""
    return PEAK_TFLOPS_BF16.get(device_kind(device))


def mfu_line(flops: Optional[float], seconds: float, device=None) -> str:
    """'X.XX TFLOP/s = Y.Y% of <card> bf16 peak (P TFLOP/s), F GFLOP/call'
    -- or a stated reason when either half is unavailable."""
    if flops is None:
        return "flops unavailable (nothing was counted)"
    tflops = flops / seconds / 1e12
    kind = device_kind(device)
    peak = PEAK_TFLOPS_BF16.get(kind)
    if peak is None:
        return (f"{tflops:.2f} TFLOP/s ({flops / 1e9:.1f} GFLOP/call; "
                f"no peak table entry for {kind!r})")
    return (f"{tflops:.2f} TFLOP/s = {100.0 * tflops / peak:.1f}% of "
            f"{kind} bf16 peak ({peak:.0f} TFLOP/s), "
            f"{flops / 1e9:.1f} GFLOP/call")
