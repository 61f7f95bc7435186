"""The traced window's attention: its least time over the device time of
the kernels that compute it (percent), whatever implements it: PyTorch's
flash, memory-efficient and cuDNN attention, or a kernel of the port's own
with ``attn`` or ``attention`` in its name.  A launch over R sequences, h
heads, L frames and head width d does the two products, 4 R h L^2 d FLOPs
(FlopCounterMode's count of softmax(Q K^T / sqrt(d)) V, tested), against
the bf16 peak, and reads Q, K and V and writes O once, 4 R L h d 2 bytes,
against HBM; its least time is the larger."""
from harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

PATTERNS = ("flash", "fmha", "sdpa", "attention", "attn")


def attn_work(R, h, L, d, e=2):
    """(FLOPs, bytes) of one attention launch, e bytes an element."""
    return 4 * R * h * L * L * d, 4 * R * L * h * d * e


def read(ctx):
    seconds, n = ctx.trace.kernels(PATTERNS)
    if n == 0 or seconds <= 0:
        return None
    least = 0.0
    for R, h, L, d, count in ctx.work.get("attn", ()):
        flops, nbytes = attn_work(R, h, L, d)
        least += count * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * least * ctx.units / seconds
