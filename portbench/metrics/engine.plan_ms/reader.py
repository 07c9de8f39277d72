"""engine.plan_ms: per call, the time under the engine's plan spans,
``spt.engine.initialize`` (selection, per-trial shapes, buckets, the host
gather's plan) and ``spt.engine.store_key`` (the trial store's key and
lookup), summed. Mean over the calls that hold one, in ms."""

from portbench.core.spans import summed_ms


def read(ctx):
    return summed_ms(ctx.trace, ("spt.engine.initialize", "spt.engine.store_key"))
