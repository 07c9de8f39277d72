"""frontend.host_ms: per call, the self time of the program's outermost
frontend span (``spt.<frontend>``, e.g. ``spt.connectivityanalysis``): its
duration less what the engine's and the mesh's spans (``spt.engine.*``,
``spt.mesh.*``) inside it cover, i.e. the frontend's own host work. Mean
over the calls that hold the span, in ms."""

from portbench.core.spans import frontend_self_ms


def read(ctx):
    return frontend_self_ms(ctx.trace)
