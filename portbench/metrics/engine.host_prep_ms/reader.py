"""engine.host_prep_ms: per call, from the call's entry to the launch of its
first payload upload (a host-to-device copy of one of the call's payload
blocks, whose sizes the harness takes from the engine's chunk plan): the
frontend's and the engine's host work before the upload. Mean over the
calls that upload, in ms."""

from portbench.core.trace import payload_copies


def read(ctx):
    vals = []
    for c in ctx.calls:
        recs = payload_copies(ctx.trace, c)
        if recs:
            first = min(ctx.trace.launched_at(d) for d in recs)
            vals.append((first - ctx.trace.calls[c["index"]][0]) / 1e3)
    return sum(vals) / len(vals) if vals else None
