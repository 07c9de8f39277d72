"""tfr.cwt_chunks: per call, the number of ``spt.specest.cwt`` spans, one a
transform of a chunk of trials. Mean over the calls that hold one, in
chunks."""

from portbench.core.roofline_cwt import CWT_SPAN
from portbench.core.spans import by_call


def read(ctx):
    counts = [n for n in (sum(1 for _, _, name in sp if name == CWT_SPAN)
                          for sp in by_call(ctx.trace).values()) if n]
    return sum(counts) / len(counts) if counts else None
