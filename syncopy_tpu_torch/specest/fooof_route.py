# -*- coding: utf-8 -*-
#
# FOOOF post-processing chain for freqanalysis (reference
# freqanalysis.py:995-1051 + compRoutines.py:906-1060).
#
# Port of syncopy_tpu/specest/fooof_route.py: host numpy on the spectrum
# the engine read back once.

import numpy as np

from ..datatype.continuous_data import SpectralData
from ..shared.errors import SPYValueError, SPYWarning
from .fooofspy import fooofspy

__all__ = ["run_fooof"]


def run_fooof(spec, flavour, fooof_opt=None):
    """
    Run FOOOF on a trial-averaged power SpectralData; returns a new
    SpectralData holding the modeled spectra with fit diagnostics in
    ``.info``.
    """
    if len(spec.trials) != 1:
        raise SPYValueError(
            legal="trial-averaged spectrum (keeptrials=False)", varname="data",
            actual="{} trials".format(len(spec.trials)),
        )
    arr = np.asarray(spec.data)  # (1, nTaper, nFreq, nChannel)
    power = arr[0].mean(axis=0)  # (nFreq, nChannel)
    freqs = np.asarray(spec.freq)

    if freqs[0] == 0:
        SPYWarning("FOOOF requires strictly positive frequencies; dropping the DC bin")

    model, details = fooofspy(power, freqs, fooof_opt=fooof_opt, out_type=flavour)

    out = SpectralData(dimord=spec.dimord)
    out.data = model[None, None, :, :].astype(np.float32)
    out.samplerate = spec.samplerate
    out.trialdefinition = np.array([[0, 1, 0]])
    out.channel = np.asarray(spec.channel)
    out.freq = freqs
    out.taper = [spec.taper[0] if spec.taper is not None else "None"]
    for key, val in details.items():
        out.info["fooof_" + key] = val
    out._log = str(spec._log)
    out.log = "FOOOF ({}) fit: {} channel(s)".format(flavour, model.shape[1])
    out.cfg.update(spec.cfg)
    return out
