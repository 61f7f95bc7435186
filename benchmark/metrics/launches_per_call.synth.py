"""Launch calls (kernel or graph launches) the host made in the traced
calls, per call, as the profiler records the runtime and driver APIs (in
the trace with host operations: a count, which the profiler's slowing of
the host does not change)."""


def read(ctx):
    n = sum(ctx.ops.launch_calls().values())
    return n / ctx.units if n else None
