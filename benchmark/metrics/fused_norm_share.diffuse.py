"""Share of the traced window's layer-norm kernels that are the program's
fused residual add and layer norm: launches of kernels whose name holds
``add_layer_norm``, over launches of kernels whose name holds
``layer_norm`` or ``LayerNorm`` (PyTorch's vectorized and row-wise layer
norms, and the fused kernel itself); None where the window ran no layer
norm.  A fraction: 0.0 where every norm is PyTorch's, 1.0 where every one
is fused."""

FUSED = ("add_layer_norm",)
NORMS = ("layer_norm", "LayerNorm")


def read(ctx):
    _, norms = ctx.trace.kernels(NORMS)
    if norms == 0:
        return None
    _, fused = ctx.trace.kernels(FUSED)
    return fused / norms
