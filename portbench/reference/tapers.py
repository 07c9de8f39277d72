"""Taper banks with syncopy's mtmfft normalization, worked out here from
scipy's windows (the program's own taper tables are not used): DPSS with
NW = tapsmofrq * T / fs and K = floor(2 NW - 1) tapers, each scaled by
sqrt(T); any other window by sqrt(4/3) sqrt(T / sum(w)); then every taper
by sqrt(2) / T (syncopy specest/mtmfft.py and _norm_spec.py, no padding)."""

import numpy as np
from scipy.signal import windows


def n_tapers(tapsmofrq, n_samples, samplerate):
    nw = tapsmofrq * n_samples / samplerate
    return max(int(2 * nw - 1), 1)


def bank(call, n_samples, samplerate):
    """(K, T) float64 tapers of one call's parameters (``taper``,
    ``tapsmofrq``)."""
    taper = call.get("taper", "hann")
    if call.get("tapsmofrq") is not None:
        nw = call["tapsmofrq"] * n_samples / samplerate
        w = windows.dpss(n_samples, nw, Kmax=n_tapers(call["tapsmofrq"], n_samples, samplerate))
        w = np.atleast_2d(w) * np.sqrt(n_samples)
    else:
        w = np.atleast_2d(getattr(windows, taper)(n_samples)).astype(np.float64)
        w = w * (np.sqrt(4.0 / 3.0) * np.sqrt(n_samples / w.sum()))
    return w * (np.sqrt(2.0) / n_samples)


def to_tf32(x):
    """float32 `x` rounded to TF32 (10 explicit mantissa bits, to nearest):
    what a tensor core reads of a float32 operand."""
    import torch

    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def cmatmul_tf32(a, b):
    """Complex64 `a @ b` as tensor cores with TF32 compute it: every real
    operand rounded to TF32, products summed in float32."""
    import torch

    ar, ai, br, bi = (to_tf32(t) for t in (a.real, a.imag, b.real, b.imag))
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)
