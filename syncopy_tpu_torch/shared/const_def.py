# -*- coding: utf-8 -*-
#
# Constant definitions (parity: reference syncopy/shared/const_def.py:12-60).
#
# The spectral conversions here act on host numpy arrays; the device-side
# counterpart on torch tensors is ops/spectral.py::spectral_convert.

import numpy as np

__all__ = [
    "spectralDTypes",
    "spectralConversions",
    "availableTapers",
    "availablePaddingOpt",
    "generalParameters",
]

spectralDTypes = {
    "pow": np.float32,
    "abs": np.float32,
    "real": np.float32,
    "imag": np.float32,
    "angle": np.float32,
    "absreal": np.float32,
    "absimag": np.float32,
    "fourier": np.complex64,
    "complex": np.complex64,
}


def _xp(x):
    return np


#: conversions applied to complex Fourier coefficients to produce the
#: requested `output` (host numpy arrays)
spectralConversions = {
    "pow": lambda x: (x * _xp(x).conj(x)).real.astype(spectralDTypes["pow"]),
    "abs": lambda x: _xp(x).abs(x).astype(spectralDTypes["abs"]),
    "fourier": lambda x: x.astype(spectralDTypes["fourier"]),
    "real": lambda x: _xp(x).real(x).astype(spectralDTypes["real"]),
    "imag": lambda x: _xp(x).imag(x).astype(spectralDTypes["imag"]),
    "angle": lambda x: _xp(x).angle(x).astype(spectralDTypes["angle"]),
    "absreal": lambda x: _xp(x).abs(_xp(x).real(x)).astype(spectralDTypes["absreal"]),
    "absimag": lambda x: _xp(x).abs(_xp(x).imag(x)).astype(spectralDTypes["absimag"]),
}
spectralConversions["complex"] = spectralConversions["fourier"]

#: tapers available to freqanalysis/connectivityanalysis — the symmetric
#: scipy.signal.windows set minus get_window/exponential/dpss (dpss is
#: activated via `tapsmofrq`); reference const_def.py:40-46
from scipy.signal import windows as _sp_windows

availableTapers = [w for w in list(_sp_windows.__all__) if w not in ("get_window", "exponential", "dpss")]

availablePaddingOpt = ["maxperlen", "nextpow2"]

#: general, method-agnostic frontend parameters
generalParameters = (
    "method",
    "keeptrials",
    "samplerate",
    "foi",
    "foilim",
    "polyremoval",
    "out",
    "pad",
)
