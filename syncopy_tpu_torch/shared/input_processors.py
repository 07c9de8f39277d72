# -*- coding: utf-8 -*-
#
# Frontend argument digestion: padding, foi, taper, effective-parameter
# checks.
#
# Parity target: reference syncopy/shared/input_processors.py:26-431.

import numbers
from inspect import signature

import numpy as np
from scipy.signal import windows as sp_windows

from ..ops.windows import get_dpss_pars, nextpow2
from .const_def import availablePaddingOpt, availableTapers, generalParameters
from .errors import SPYInfo, SPYValueError, SPYWarning
from .parsers import array_parser, scalar_parser

__all__ = [
    "process_padding",
    "process_foi",
    "process_taper",
    "check_effective_parameters",
    "check_passed_kwargs",
]


def process_padding(pad, lenTrials, samplerate):
    """
    Resolve the `pad` argument to the absolute post-padding trial length in
    samples (reference input_processors.py:26-91): 'maxperlen' pads to the
    longest trial, 'nextpow2' to the next power of two, a float to an
    absolute duration in seconds.
    """
    lenTrials = np.asarray(lenTrials)
    not_valid = not isinstance(pad, (numbers.Number, str))
    if isinstance(pad, str) and pad not in availablePaddingOpt:
        not_valid = True
    if isinstance(pad, bool):
        not_valid = True
    if not_valid:
        raise SPYValueError(
            legal="'maxperlen', 'nextpow2' or a float number", varname="pad", actual=str(pad)
        )

    if isinstance(pad, numbers.Number):
        scalar_parser(pad, varname="pad", lims=[lenTrials.max() / samplerate, np.inf])
        return int(pad * samplerate)
    if pad == "nextpow2":
        return nextpow2(int(lenTrials.max()))
    # maxperlen
    abs_pad = int(lenTrials.max())
    if lenTrials.min() != lenTrials.max():
        SPYInfo("Unequal trial lengths present, padding all trials to {} samples".format(abs_pad))
    return abs_pad


def process_foi(foi, foilim, samplerate):
    """Validate foi/foilim (mutually exclusive); returns the parsed pair
    (reference input_processors.py:93-176)."""
    if foi is not None and foilim is not None:
        raise SPYValueError(
            legal="either `foi` or `foilim` specification", varname="foi/foilim", actual="both"
        )
    if foi is not None:
        if isinstance(foi, str):
            if foi != "all":
                raise SPYValueError(legal="'all' or `None` or list/array", varname="foi", actual=foi)
            foi = None
        else:
            array_parser(foi, varname="foi", hasinf=False, hasnan=False, lims=[0, samplerate / 2], dims=(None,))
            foi = np.array(foi, dtype=float)
    if foilim is not None:
        if isinstance(foilim, str):
            if foilim != "all":
                raise SPYValueError(
                    legal="'all' or `None` or `[fmin, fmax]`", varname="foilim", actual=foilim
                )
            foilim = None
        else:
            array_parser(foilim, varname="foilim", hasinf=False, hasnan=False, lims=[0, samplerate / 2], dims=(2,))
            foilim = [float(f) for f in foilim]
            if foilim[0] > foilim[1]:
                SPYInfo("Sorting foilim low to high..")
                foilim = list(np.sort(foilim))
    return foi, foilim


def process_taper(taper, taper_opt, tapsmofrq, nTaper, keeptapers, foimax, samplerate, nSamples, output):
    """
    Validate taper selection and derive Slepian (dpss) parameters from
    `tapsmofrq` (reference input_processors.py:178-374). Returns
    ``(taper, taper_opt)`` with ``taper_opt`` holding `NW`/`Kmax` for
    multi-tapering.
    """
    if taper == "dpss":
        raise SPYValueError(
            legal="set `tapsmofrq` parameter directly for multi-tapering", varname="taper", actual=taper
        )
    if taper is None and tapsmofrq is None:
        return None, {}
    if taper not in availableTapers:
        raise SPYValueError(
            legal="'" + "or '".join(opt + "' " for opt in availableTapers), varname="taper", actual=str(taper)
        )
    if not isinstance(taper_opt, (dict, type(None))):
        raise SPYValueError("dict or None", "taper_opt", str(type(taper_opt)))

    if tapsmofrq is None:
        if nTaper is not None:
            SPYWarning("`nTaper` is only used for multi-tapering!")
        if keeptapers:
            SPYWarning("`keeptapers` is only used for multi-tapering!")
        params = signature(getattr(sp_windows, taper)).parameters
        supported_kws = [k for k in params if k not in ("M", "sym", "xp", "device")]
        if taper_opt is not None:
            if len(supported_kws) == 0:
                raise SPYValueError(
                    "`None`, taper '{}' has no additional parameters".format(taper),
                    varname="taper_opt", actual=str(taper_opt),
                )
            for key in taper_opt:
                if key not in supported_kws:
                    raise SPYValueError(
                        "one of {} for `taper='{}'`".format(supported_kws, taper), "taper_opt key", key
                    )
            for key in supported_kws:
                if key not in taper_opt:
                    raise SPYValueError(
                        "additional parameter '{}' for `taper='{}'`".format(key, taper), "taper_opt"
                    )
            return taper, taper_opt
        if len(supported_kws) > 0:
            raise SPYValueError(
                "additional parameters for taper '{}': {}".format(taper, supported_kws),
                varname="taper_opt",
            )
        return taper, {}

    # multi-tapering
    if taper != "hann":
        raise SPYValueError(
            "`None` for multi-tapering, just set `tapsmofrq`", varname="taper", actual=taper
        )
    if taper_opt is not None:
        SPYWarning(
            "For multi-tapering use `tapsmofrq` and `nTaper` to control frequency "
            "smoothing, `taper_opt` has no effect"
        )
    if not keeptapers and output != "pow":
        raise SPYValueError(
            legal="'pow'|False or '{}'|True, set either keeptapers=True or `output='pow'`!".format(output),
            varname="output|keeptapers",
            actual="'{}'|{}".format(output, keeptapers),
        )
    minBw = samplerate / nSamples
    maxBw = min(samplerate / 2 - 1 / nSamples, samplerate * (nSamples + 1) / (2 * nSamples))
    try:
        scalar_parser(tapsmofrq, varname="tapsmofrq", lims=[0, np.inf])
    except Exception:
        raise SPYValueError(
            legal="smoothing bandwidth in Hz, typical values are in the range 1-10Hz",
            varname="tapsmofrq", actual=str(tapsmofrq),
        )
    if tapsmofrq < minBw:
        SPYInfo("Setting tapsmofrq to the minimal attainable bandwidth of {:.2f}Hz".format(minBw))
        tapsmofrq = minBw
    if tapsmofrq > maxBw:
        SPYInfo("Setting tapsmofrq to the maximal attainable bandwidth of {:.2f}Hz".format(maxBw))
        tapsmofrq = maxBw
    NW, Kmax = get_dpss_pars(tapsmofrq, nSamples, samplerate)
    if nTaper is None:
        SPYInfo("Using {} taper(s) for multi-tapering".format(Kmax))
        return "dpss", {"NW": NW, "Kmax": Kmax}
    scalar_parser(nTaper, varname="nTaper", ntype="int_like", lims=[1, np.inf])
    if nTaper != Kmax:
        SPYWarning(
            "Manually setting the number of tapers is not recommended and may "
            "(strongly) distort the effective smoothing bandwidth! The optimal "
            "number of tapers is {}, you have chosen to use {}.".format(Kmax, nTaper)
        )
    return "dpss", {"NW": NW, "Kmax": int(nTaper)}


def check_effective_parameters(CR, defaults, lcls, besides=None):
    """
    Warn about frontend parameters that have no effect for the selected
    compute routine (reference input_processors.py:376-406).
    """
    expected = CR.valid_kws + ["parallel", "select", "chan_per_worker", "keeptrials", "out"]
    if besides is not None:
        expected += besides
    relevant = [key for key in defaults if key not in generalParameters]
    for key in relevant:
        if key not in expected and (lcls.get(key) != defaults.get(key)):
            SPYWarning(
                "option `{}` has no effect for the chosen method/routine `{}`".format(
                    key, CR.__name__ if hasattr(CR, "__name__") else CR.__class__.__name__
                )
            )


def check_passed_kwargs(lcls, defaults, frontend_name):
    """Warn about unknown kwargs (reference input_processors.py:408-431)."""
    relevant = list(lcls.get("kwargs", {}).keys())
    for key in relevant:
        if key not in defaults and key not in ("select", "parallel", "chan_per_worker"):
            SPYWarning(
                "option `{}` is not valid for `{}` and has no effect".format(key, frontend_name)
            )
