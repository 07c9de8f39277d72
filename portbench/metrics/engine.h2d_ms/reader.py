"""engine.h2d_ms: per call, the device time of its payload uploads (the
host-to-device copies of its payload blocks). A call whose copies' bytes
differ from the bytes the engine counted (``transfer_counts()["h2d"]``) is
left out and named on standard error. Mean over the calls that upload,
in ms."""

import sys

from portbench.core.trace import payload_copies


def read(ctx):
    vals = []
    for c in ctx.calls:
        recs = payload_copies(ctx.trace, c)
        if not recs:
            continue
        moved = sum(d["bytes"] for d in recs)
        if moved != c["h2d"]:
            print("engine.h2d_ms: call {} copied {} B of payload, the engine counted {} B".format(
                c["index"], moved, c["h2d"]), file=sys.stderr)
            continue
        vals.append(sum(d["end"] - d["start"] for d in recs) / 1e3)
    return sum(vals) / len(vals) if vals else None
