"""B1 forward and backward in the traced steps: their least time over the
device time of ``gru_recurrence_kernel`` and ``gru_backward_kernel``
(percent)."""
from rooflines import roofline


def read(ctx):
    return roofline(ctx, ("b1_fwd", "b1_bwd"),
                    ("gru_recurrence_kernel", "gru_backward_kernel"))
