"""kernel.csd_roofline: the CSD kernel's share of its roofline over the
calls whose work holds a CSD sum: the least time the card could take for
those sums (``csd_bound`` of each call's shapes: F bins, trials x tapers
rows on this rank, C channels) over the device time of the kernels that
this folder's ``*.txt`` files list. In %."""

from portbench.core.roofline import csd_bound
from portbench.core.trace import kernel_share


def read(ctx):
    return kernel_share(ctx, "csd", lambda w: csd_bound(w["F"], w["rows"], w["C"])[0])
