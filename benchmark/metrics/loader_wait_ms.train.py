"""Mean milliseconds a step of the window waited in the program's loader
(the benchmark's span around each ``next()``)."""


def read(ctx):
    return ctx.state.loader_wait_ms
