"""The program's own host ranges (``ha2g_torch/utils/spans.py``: the
``ha2g.*`` spans and ``train_step#<i>``) as the trace with host operations
holds them, and the launch calls that start inside them."""

from __future__ import annotations

import bisect

from trace_reader import LAUNCH_CALLS, union


def ranges(trace, name: str) -> list:
    """(start, end) of the ranges called ``name``, or whose name starts
    with it where it ends in ``#``, in order of start."""
    hit = (lambda n: n.startswith(name)) if name.endswith("#") \
        else (lambda n: n == name)
    return sorted((s, e) for n, s, e in trace.host if hit(n))


def launches_inside(trace, spans) -> int:
    """Launch calls whose start lies in the union of ``spans`` (a call
    inside nested spans counts once)."""
    merged = union(spans)
    ends = [e for _, e in merged]
    n = 0
    for name, s, _ in trace.host:
        if name in LAUNCH_CALLS:
            # the first range that ends at s or later
            i = bisect.bisect_left(ends, s)
            if i < len(merged) and merged[i][0] <= s:
                n += 1
    return n
