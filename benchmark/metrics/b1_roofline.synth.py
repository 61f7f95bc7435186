"""B1's forward launches of the traced calls: their least time over the
device time of ``gru_recurrence_kernel`` (percent)."""
from rooflines import roofline


def read(ctx):
    return roofline(ctx, ("b1_fwd",), ("gru_recurrence_kernel",))
