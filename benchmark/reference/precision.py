"""The reference's arithmetic: float32 with TF32 off, or the control's
float8 (e4m3) rounding at every place the measured program rounds to its
compute dtype.

``Precision.q`` stands where the program casts to its compute dtype: the
inputs and weights of every product, the GRU carry, batch norm's output.
In float32 it is the identity.  The control rounds to float8 with one scale
a tensor (its largest magnitude onto the format's largest, as a
per-tensor scaled fp8 path does): values to e4m3 in the forward and,
under autograd, their gradients to e5m2 in the backward, the usual fp8
training recipe.
"""

from __future__ import annotations

import contextlib

import torch

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t: torch.Tensor, fmt) -> torch.Tensor:
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / FORMATS[fmt], torch.ones_like(amax))
    return (t / scale).to(fmt).float() * scale


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g.float(), torch.float8_e5m2)


class Precision:
    def __init__(self, name: str):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.name == "float32":
            return t
        if t.requires_grad:
            return _Float8.apply(t)
        return _round(t, torch.float8_e4m3fn)


FLOAT32 = Precision("float32")


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
