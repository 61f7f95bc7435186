"""Launch calls (kernel or graph launches) starting inside the program's
``ha2g.synth.window`` spans (the window loop: cascade, cross-fade, cat),
per traced call; the rest of ``launches_per_call.synth`` is the mel
front-end, the audio encoder and the pull."""
from span_reader import launches_inside, ranges


def read(ctx):
    windows = ranges(ctx.ops, "ha2g.synth.window")
    return launches_inside(ctx.ops, windows) / ctx.units if windows else None
