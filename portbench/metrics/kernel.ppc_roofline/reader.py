"""kernel.ppc_roofline: the PPC kernel's share of its roofline over the
calls whose work holds a PPC sum: ``ppc_bound`` of each call's shapes (F
bins, trials on this rank, K tapers, C channels) over the device time of
the kernels that this folder's ``*.txt`` files list. In %."""

from portbench.core.roofline import ppc_bound
from portbench.core.trace import kernel_share


def read(ctx):
    return kernel_share(ctx, "ppc", lambda w: ppc_bound(w["F"], w["n"], w["K"], w["C"])[0])
