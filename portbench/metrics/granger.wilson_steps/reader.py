"""granger.wilson_steps: per call, the number of ``spt.granger.wilson_step``
spans (a step of either Wilson loop; one step of a batched loop counts
once). Mean over the calls that hold one, in steps."""

from portbench.core.spans import by_call

STEP = "spt.granger.wilson_step"


def read(ctx):
    counts = [n for n in (sum(1 for _, _, name in sp if name == STEP)
                          for sp in by_call(ctx.trace).values()) if n]
    return sum(counts) / len(counts) if counts else None
