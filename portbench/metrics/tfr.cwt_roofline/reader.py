"""tfr.cwt_roofline: the wavelet transform's share of its roofline over the
calls whose work holds a transform: ``cwt_bound`` of each call's shapes
(trials, samples, channels and each scale's wavelet length) over the
device time of every kernel launched inside its ``spt.specest.cwt``
spans. In %."""

from portbench.core.roofline_cwt import cwt_bound, cwt_kernel_ms


def read(ctx):
    timed = cwt_kernel_ms(ctx)
    bound_ms = kernel_ms = 0.0
    for c in ctx.calls:
        w = c["work"].get("cwt")
        if w is None or c["index"] not in timed:
            continue
        kernel_ms += timed[c["index"]]
        bound_ms += cwt_bound(w["trials"], w["T"], w["C"], w["K"])[0]
    return 100.0 * bound_ms / kernel_ms if kernel_ms > 0 else None
