"""Share of the traced calls' ``ha2g.synth.window`` spans that hold an
``ha2g.synth.replay`` span: the windows whose level cascade ran as a
replay of its CUDA graph, not op by op (a program without graphs reads
0.0 where it has window spans)."""
from span_reader import ranges


def read(ctx):
    windows = ranges(ctx.ops, "ha2g.synth.window")
    if not windows:
        return None
    replays = ranges(ctx.ops, "ha2g.synth.replay")
    held = sum(any(s <= rs and re <= e for rs, re in replays)
               for s, e in windows)
    return held / len(windows)
