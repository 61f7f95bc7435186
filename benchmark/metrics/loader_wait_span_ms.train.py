"""Mean milliseconds of the program's ``ha2g.trainer.loader_wait`` spans
that a step follows (the ``next()`` that handed it its batch); the
epoch's closing ``next()``, after its last step, yields no batch and is
left out."""
from span_reader import ranges


def read(ctx):
    steps = ranges(ctx.ops, "train_step#")
    if not steps:
        return None
    waits = [e - s for s, e in ranges(ctx.ops, "ha2g.trainer.loader_wait")
             if s < steps[-1][0]]
    return 1e3 * sum(waits) / len(waits) if waits else None
