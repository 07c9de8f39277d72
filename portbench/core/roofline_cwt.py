"""The least work of a continuous wavelet transform's power, trial-averaged,
for ``tfr.cwt_roofline``: the bound of any FFT route, priced per scale so
that no grouping of scales into banks can read above it.

Per (trial, channel, scale) one complex inverse transform at the least
power of two L_s at or above T + K_s - 1 (the signal and the scale's K_s
wavelet samples, no wrap-around), charged 5 L_s log2 L_s operations; per
(trial, channel) one forward transform at the smallest of the L_s. Bytes:
the float32 input read once and the float32 averaged power (T, scales,
channels) written once. The products with the bank, the power and the
trial sum are left out: they only add.
"""

import bisect
import math

from .roofline import bound
from .spans import by_call


def fft_ops(L):
    """The operations charged to one complex transform of length L."""
    return 5 * L * math.log2(L)


def cwt_bound(trials, T, C, K):
    """(bound_ms, bound_by) of the trial-averaged power of `trials` trials of
    T samples and C channels over the scales whose wavelets have the
    lengths `K`: the larger of the operations over the FP32 peak and the
    bytes over the HBM rate (``core/roofline.py``)."""
    Ls = [1 << (T + k - 2).bit_length() for k in K]
    flops = trials * C * (sum(fft_ops(L) for L in Ls) + fft_ops(min(Ls)))
    nbytes = trials * T * C * 4 + T * len(K) * C * 4
    return bound(flops, nbytes)


#: the program's span around one transform (a chunk of a wavelet call)
CWT_SPAN = "spt.specest.cwt"


def cwt_kernel_ms(ctx):
    """``{call index: device ms}`` for the calls that launched a kernel
    inside a ``spt.specest.cwt`` span: the device time of every kernel
    launched inside the call's such spans (by where it was launched, not by
    name). The spans of a call do not overlap, so a launch is placed by
    bisection."""
    out = {}
    for i, sp in by_call(ctx.trace).items():
        inside = sorted((s, e) for s, e, name in sp if name == CWT_SPAN)
        if not inside:
            continue
        starts = [s for s, _ in inside]
        us = None
        for d in ctx.trace.of_call(i):
            if d["cat"] != "kernel":
                continue
            t = ctx.trace.launched_at(d)
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= inside[j][1]:
                us = (us or 0.0) + d["end"] - d["start"]
        if us is not None:
            out[i] = us / 1e3
    return out
