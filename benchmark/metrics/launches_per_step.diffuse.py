"""Launch calls (kernel or graph launches) starting inside the program's
``ha2g.diffuse.chain`` spans, over the denoising steps those spans cover
(the trace with host operations: a count, which the profiler's slowing of
the host does not change).  A chain span covers the configuration's
``diffusion_steps`` (its args; the trace reader keeps no args)."""
from span_reader import launches_inside, ranges


def read(ctx):
    chains = ranges(ctx.ops, "ha2g.diffuse.chain")
    if not chains:
        return None
    return launches_inside(ctx.ops, chains) / (
        len(chains) * ctx.config["diffusion_steps"])
