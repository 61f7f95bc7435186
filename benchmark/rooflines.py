"""Operations and bytes of the hand kernels' work, from their shapes, and
the shares read from a traced segment.

FLOPs count the products, as FlopCounterMode counts the reference's plain
versions (the tests hold them equal); bytes count each input read once
and each output written once.  A kernel's least time is the larger of its
FLOPs over the peak of the fastest datapath that reaches the
configuration's precision and its bytes over HBM bandwidth.  B1 forward:
one bidirectional layer's recurrence, (T, 2, B, 3H) input projections,
(2, H, 3H) recurrent weights -> (T, 2, B, H) states.  B1 backward: the
serial loop, the states' cotangent through T steps (its weight gradient
is a product outside the kernel).  B2: the contrastive loss's forward
over N unit rows of D features; B3 / B4: the gradient to one side (a
kernel that keeps no (N, N) matrix recomputes the similarities, which is
not counted).
"""

from __future__ import annotations

from harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, PEAK_TF32_FLOPS


def b1_fwd(T, B, H, e):
    G = 3 * H
    return 2 * T * 2 * B * H * G, e * (T * 2 * B * G + 2 * B * H + 2 * H * G
                                       + 2 * G + T * 2 * B * H)


def b1_bwd(T, B, H, e):
    G = 3 * H
    # in: xp (e), hh and h_prev (f32), w_hh and d_outs (e);
    # out: d_gx and d_gh (f32), d_h0 (f32)
    return 2 * T * 2 * B * G * H, (e * T * 2 * B * G + 4 * T * 2 * B * G
                                   + 4 * T * 2 * B * H + e * 2 * H * G
                                   + e * T * 2 * B * H + 4 * 2 * T * 2 * B * G
                                   + 4 * 2 * B * H)


def contrastive_fwd(N, D):
    return 2 * N * N * D, 4 * (2 * N * D + 2 * N)


def contrastive_bwd(N, D):
    return 2 * N * N * D, 4 * (3 * N * D + N + 1)


FORMULAS = {"b1_fwd": (b1_fwd, PEAK_BF16_FLOPS),
            "b1_bwd": (b1_bwd, PEAK_BF16_FLOPS),
            "contrastive_fwd": (contrastive_fwd, PEAK_TF32_FLOPS),
            "contrastive_bwd": (contrastive_bwd, PEAK_TF32_FLOPS)}


def least_seconds(kind: str, shape) -> float:
    formula, peak = FORMULAS[kind]
    flops, nbytes = formula(*shape)
    return max(flops / peak, nbytes / PEAK_HBM_BYTES)


def roofline(ctx, kinds, patterns):
    """Percent: the least time of the traced units' work of ``kinds`` over
    the device time of the kernels named by ``patterns``; None where the
    trace holds no such kernel."""
    seconds, n = ctx.trace.kernels(patterns)
    if n == 0 or seconds <= 0:
        return None
    least = sum(entry[-1] * least_seconds(kind, entry[:-1])
                for kind in kinds for entry in ctx.work.get(kind, ()))
    return 100.0 * least * ctx.units / seconds


def idle_share(ctx):
    """Percent of the traced window in which no device operation ran."""
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def mfu(ctx):
    """Percent of the bf16 peak: the model FLOPs of a unit at the window's
    rate of units."""
    if not ctx.flops_per_unit:
        return None
    return 100.0 * ctx.flops_per_unit * ctx.rate / PEAK_BF16_FLOPS
