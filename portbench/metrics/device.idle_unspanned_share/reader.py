"""device.idle_unspanned_share: the share of the traced window in which the
card was idle and no span of the program (``spt.*``, at any depth) was open
on the calls' thread, judged at each idle gap's middle: the idle time that
the program's spans cannot name. In %."""

from portbench.core.spans import unspanned_idle_share


def read(ctx):
    return unspanned_idle_share(ctx.trace)
