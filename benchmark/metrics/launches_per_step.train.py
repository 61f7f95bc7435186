"""Launch calls (kernel or graph launches) starting inside the program's
``train_step#<i>`` ranges, over the number of such ranges (the trace with
host operations: a count, which the profiler's slowing of the host does
not change).  Launches from autograd's thread in a step's backward start
inside its range and count."""
from span_reader import launches_inside, ranges


def read(ctx):
    steps = ranges(ctx.ops, "train_step#")
    return launches_inside(ctx.ops, steps) / len(steps) if steps else None
