"""Share of the traced denoising steps that ran in a CUDA graph's replay:
the steps of ``ha2g.diffuse.chain`` spans that hold an
``ha2g.diffuse.replay`` span, over the steps of all chain spans.  A
replay covers its whole chain's steps, as the program captures one graph
a chain (the spans' args; the trace reader keeps no args); a program
without graphs reads 0.0 where it has chain spans."""
from span_reader import ranges


def read(ctx):
    chains = ranges(ctx.ops, "ha2g.diffuse.chain")
    if not chains:
        return None
    replays = ranges(ctx.ops, "ha2g.diffuse.replay")
    held = sum(any(s <= rs and re <= e for rs, re in replays)
               for s, e in chains)
    return held / len(chains)
