# -*- coding: utf-8 -*-
#
# connectivityanalysis: user-facing connectivity frontend (coh method).
#
# Port of syncopy_tpu/connectivity/connectivity_analysis.py. Coherence runs
# as in the JAX package's fused path: one single-trial stage (CrossSpectra)
# whose trial sum is normalized on the device, read back once in full.
# The other methods raise NotImplementedError naming the ROADMAP item that
# ports them.

import numpy as np

from ..datatype.continuous_data import AnalogData, CrossSpectralData, SpectralData
from ..shared.errors import SPYInfo, SPYTypeError, SPYValueError, not_ported
from ..shared.input_processors import (
    check_effective_parameters,
    check_passed_kwargs,
    process_foi,
    process_padding,
    process_taper,
)
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.parsers import data_parser, scalar_parser
from ..shared.tools import best_match, get_defaults, get_frontend_cfg

__all__ = ["connectivityanalysis"]

availableMethods = ("coh", "corr", "granger", "csd", "ppc")
connectivity_outputs = ("abs", "pow", "complex", "fourier", "angle", "real", "imag")

#: where each method that is not ported yet is queued
_NOT_PORTED = {
    "corr": "ROADMAP Queue 1 item 8 (CrossCovariance)",
    "granger": "ROADMAP Queue 1 item 7 (the Granger slice)",
    "csd": "ROADMAP Queue 1 item 8 (csd)",
    "ppc": "ROADMAP Queue 1 item 8 and Queue 2 item 2 (PPC)",
}


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def connectivityanalysis(
    data,
    method="coh",
    keeptrials=False,
    output="abs",
    foi=None,
    foilim=None,
    pad="maxperlen",
    channelcmb=None,
    polyremoval=0,
    tapsmofrq=None,
    nTaper=None,
    taper="hann",
    taper_opt=None,
    jackknife=False,
    parallel=None,
    **kwargs,
):
    """
    Perform connectivity analysis of AnalogData.

    Ported method: ``coh`` (coherence). ``corr``, ``granger``, ``csd`` and
    ``ppc`` raise NotImplementedError until their slices land.

    Parameters
    ----------
    data : :class:`~syncopy_tpu_torch.AnalogData`
        Time series.
    method : {"coh", "corr", "granger", "csd", "ppc"}
        Connectivity measure; only "coh" is ported.
    keeptrials : bool
        Must be False for "coh" (coherence is defined across trials).
    output : str
        "abs", "pow", "complex"/"fourier", "real", "imag" or "angle".
    foi, foilim : array_like / [fmin, fmax] / None
        Frequencies of interest.
    pad : "maxperlen", "nextpow2", or float
        Trial padding policy.
    channelcmb : [senders, receivers] or None
        Needs SpectralData input, as in the JAX package; not ported yet.
    polyremoval : {0, 1, None}
        Per-trial detrend order before tapering.
    tapsmofrq, nTaper, taper, taper_opt
        Multi-taper controls.
    jackknife : bool
        Leave-one-out error estimation; not ported yet.
    parallel : bool or None
        Accepted for API parity and ignored: the engine runs on one device.

    Returns
    -------
    :class:`~syncopy_tpu_torch.CrossSpectralData`
        ``(time, freq, channel_i, channel_j)`` coherence with replayable
        ``cfg``.

    Reference: connectivity_analysis.py:51.
    """
    data_parser(data, varname="data", empty=False)
    if not isinstance(data, (AnalogData, SpectralData)):
        raise SPYValueError(
            legal="either AnalogData or SpectralData as input", varname="data",
            actual=data.__class__.__name__,
        )
    defaults = get_defaults(connectivityanalysis)
    lcls = dict(locals())
    check_passed_kwargs(lcls, defaults, frontend_name="connectivity")

    if method not in availableMethods:
        raise SPYValueError(legal=str(availableMethods), varname="method", actual=method)
    if method in _NOT_PORTED:
        raise not_ported("method '{}'".format(method), _NOT_PORTED[method])
    if not isinstance(jackknife, bool):
        raise SPYTypeError(jackknife, "jackknife", "boolean")
    if jackknife:
        raise not_ported("jackknife", "ROADMAP Queue 1 item 8 (statistics/jackknifing.py)")

    if data.selection is not None:
        sinfo = data.selection.trialdefinition[:, :2]
    else:
        sinfo = data.sampleinfo
    lenTrials = np.atleast_1d(np.diff(sinfo).squeeze())
    nTrials = len(sinfo)

    if channelcmb is not None and not isinstance(data, SpectralData):
        raise SPYTypeError(
            data, "data", expected="SpectralData, `channelcmb` not supported for other data types"
        )
    if polyremoval is not None:
        scalar_parser(polyremoval, varname="polyremoval", ntype="int_like", lims=[0, 1])

    log_dict = {"method": method, "keeptrials": keeptrials, "polyremoval": polyremoval,
                "pad": pad, "channelcmb": channelcmb}
    new_cfg = get_frontend_cfg(defaults, lcls, kwargs)

    from .ST_compRoutines import CrossSpectra

    if nTrials == 1:
        raise SPYValueError(
            legal="multi-trial input data, spectral connectivity measures "
            "critically depend on trial averaging!",
            varname="data", actual="only one trial",
        )
    if keeptrials is not False:
        raise SPYValueError(
            legal="False, trial averaging needed for method {}!".format(method),
            varname="keeptrials", actual=str(keeptrials),
        )
    if not isinstance(data, AnalogData):
        raise not_ported("coherence from SpectralData",
                          "ROADMAP Queue 1 item 8 (SpectralDyadicProduct)")

    nSamples = process_padding(pad, lenTrials, data.samplerate)
    check_effective_parameters(CrossSpectra, defaults, lcls, besides=["jackknife", "channelcmb"])
    st_compRoutine = _setup_cross_spectra(
        data, nSamples, foi, foilim, tapsmofrq, nTaper, taper, taper_opt,
        polyremoval, lenTrials, log_dict,
    )

    if output not in connectivity_outputs:
        raise SPYValueError(
            legal="one of {}".format(connectivity_outputs), varname="output", actual=output
        )
    log_dict["output"] = output

    # coherence = trial-averaged CSD + normalization, the normalization
    # fused onto the single-trial stage's device-side trial sum
    out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    st_compRoutine.initialize(data, out._stackingDim, keeptrials=False)
    st_compRoutine.compute(
        data, out, log_dict=log_dict,
        post_device_fn=lambda csd_avg: _coh_post(csd_avg, output=output),
    )
    out.cfg.update(data.cfg)
    new_cfg.update({"output": output})
    out.cfg.update({"connectivityanalysis": new_cfg})
    return out


# ------------------------------------------------------------------------ #
# helpers
# ------------------------------------------------------------------------ #


def _coh_post(csd_avg, output="abs"):
    """Device-side coherence normalization of the trial-averaged CSD
    (reference AV_compRoutines.normalize_csd_cF)."""
    from ..ops.connectivity import normalize_csd

    return normalize_csd(csd_avg, output)


def _setup_cross_spectra(data, nSamples, foi, foilim, tapsmofrq, nTaper, taper,
                         taper_opt, polyremoval, lenTrials, log_dict):
    """Configure the implicit mtmfft+dyadic ST routine for AnalogData input
    (reference connectivity_analysis.py:775-872). The Granger settings
    (demeaned tapers, exact_fft) land with the Granger slice."""
    from .ST_compRoutines import CrossSpectra

    foi, foilim = process_foi(foi, foilim, data.samplerate)
    freqs = np.fft.rfftfreq(nSamples, 1 / data.samplerate)
    freq_idx = None
    if foi is not None:
        out_foi, freq_idx = best_match(freqs, foi, squash_duplicates=True)
    elif foilim is not None:
        out_foi, freq_idx = best_match(freqs, foilim, span=True)
    else:
        SPYInfo("Setting frequencies of interest to {:.1f}-{:.1f}Hz".format(freqs[0], freqs[-1]))
        out_foi = freqs

    taper, taper_opt = process_taper(
        taper, taper_opt, tapsmofrq, nTaper, keeptapers=False, foimax=out_foi.max(),
        samplerate=data.samplerate, nSamples=lenTrials.mean(), output="pow",
    )
    log_dict["foi"] = out_foi
    log_dict["taper"] = taper

    return CrossSpectra(
        samplerate=data.samplerate, nSamples=nSamples, taper=taper, taper_opt=taper_opt,
        polyremoval=polyremoval, freq_idx=freq_idx, foi=out_foi,
    )
