"""granger.wilson_roofline: Wilson's share of its roofline over the calls
whose work holds a factorization: ``wilson_bound`` (F bins, N channels, the
call's ``spt.granger.wilson_step`` spans) summed over those calls, over the
device time of every kernel launched inside their Wilson spans
(``spt.granger.wilson``, ``spt.granger.wilson_twosided``). Kernels count
by where they were launched, not by name. In %."""

from portbench.core.roofline_fp64 import wilson_bound
from portbench.core.spans import by_call

WILSON = ("spt.granger.wilson", "spt.granger.wilson_twosided")
STEP = "spt.granger.wilson_step"


def read(ctx):
    spans = by_call(ctx.trace)
    bound_ms = kernel_ms = 0.0
    for c in ctx.calls:
        w = c["work"].get("wilson")
        sp = spans.get(c["index"], [])
        inside = [(s, e) for s, e, name in sp if name in WILSON]
        if w is None or not inside:
            continue
        ks = [d for d in ctx.trace.of_call(c["index"]) if d["cat"] == "kernel"
              and any(s <= ctx.trace.launched_at(d) <= e for s, e in inside)]
        if ks:
            kernel_ms += sum(d["end"] - d["start"] for d in ks) / 1e3
            steps = sum(1 for _, _, name in sp if name == STEP)
            bound_ms += wilson_bound(w["F"], w["N"], steps)[0]
    return 100.0 * bound_ms / kernel_ms if kernel_ms > 0 else None
