"""granger.wilson_ms: per call, the time under the program's Wilson spans,
``spt.granger.wilson`` (the one-sided factorization) and
``spt.granger.wilson_twosided`` (its retry), summed. Each step waits for
its launches, so the host's span covers the card's work. Mean over the
calls that hold one, in ms."""

from portbench.core.spans import summed_ms


def read(ctx):
    return summed_ms(ctx.trace, ("spt.granger.wilson", "spt.granger.wilson_twosided"))
