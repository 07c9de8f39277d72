"""engine.finalize_ms: per call, the time under ``spt.engine.finalize``,
the output's info, log, metadata and seal after the readback. Mean over
the calls that hold the span, in ms."""

from portbench.core.spans import summed_ms


def read(ctx):
    return summed_ms(ctx.trace, ("spt.engine.finalize",))
