"""engine.gather_ms: per call, the time under ``spt.engine.gather``, the
engine's host gather and pad of its payload blocks (the inside view of
``engine.host_prep_ms``). Mean over the calls that gather, in ms."""

from portbench.core.spans import summed_ms


def read(ctx):
    return summed_ms(ctx.trace, ("spt.engine.gather",))
