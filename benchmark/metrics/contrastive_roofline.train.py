"""B2-B4 in the traced steps, against the TF32 tensor-core peak: their
least time over the device time of ``contrastive_fwd_kernel`` and
``contrastive_bwd_kernel`` (percent)."""
from rooflines import roofline


def read(ctx):
    return roofline(ctx, ("contrastive_fwd", "contrastive_bwd"),
                    ("contrastive_fwd_kernel", "contrastive_bwd_kernel"))
