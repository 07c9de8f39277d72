"""tfr.cwt_ms: per call, the device time of every kernel launched inside
the call's ``spt.specest.cwt`` spans (one a chunk: the signal's and the
bank's transforms, their products, the power, its placement), counted by
where it was launched, not by name. Mean over the calls that launched
one, in ms."""

from portbench.core.roofline_cwt import cwt_kernel_ms


def read(ctx):
    vals = list(cwt_kernel_ms(ctx).values())
    return sum(vals) / len(vals) if vals else None
