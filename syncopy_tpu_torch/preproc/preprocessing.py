# -*- coding: utf-8 -*-
#
# preprocessing: filtering / detrending / standardization frontend.
#
# Port of syncopy_tpu/preproc/preprocessing.py (parity target: reference
# syncopy/preproc/preprocessing.py:45-411): the same validation, errors,
# chain of steps, `nan_trials` and cfg. The routines run on the port's
# device (set_device); `parallel` resolves through parallel/mesh.py and
# shards every step's trials and channels over the mesh.

import numpy as np

from ..datatype.continuous_data import AnalogData
from ..shared.errors import SPYError, SPYValueError
from ..shared.input_processors import check_effective_parameters, check_passed_kwargs
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.parsers import array_parser, data_parser, scalar_parser
from ..shared.tools import get_defaults, get_frontend_cfg

__all__ = ["preprocessing"]

availableFilters = ("but", "firws")
availableFilterTypes = ("lp", "hp", "bp", "bs")
availableDirections = ("twopass", "onepass", "onepass-minphase")
availableWindows = ("hamming", "hann", "blackman")
hilbert_outputs = ("abs", "complex", "real", "imag", "absreal", "absimag", "angle")


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def preprocessing(
    data,
    filter_class="but",
    filter_type="lp",
    freq=None,
    order=None,
    direction="twopass",
    window="hamming",
    polyremoval=None,
    zscore=False,
    rectify=False,
    hilbert=False,
    keeptrials=True,
    parallel=None,
    **kwargs,
):
    """
    Preprocessing of continuous raw data: Butterworth (IIR) or windowed-sinc
    (FIR) filtering with lp/hp/bp/bs responses, detrending, z-scoring,
    rectification and Hilbert transform.

    Parameters
    ----------
    data : :class:`~syncopy_tpu_torch.AnalogData`
        Raw multi-channel time series.
    filter_class : {"but", "firws", None}
        Butterworth IIR (the hand-written float64 biquad-cascade kernel on
        the card) or windowed-sinc FIR (FFT convolution on the card); None
        applies only
        the non-filter steps (detrend/zscore/rectify/hilbert).
    filter_type : {"lp", "hp", "bp", "bs"}
        Low-pass, high-pass, band-pass, or band-stop response.
    freq : float or [f1, f2]
        Cutoff (lp/hp) or band edges (bp/bs) in Hz.
    order : int or None
        Filter order; None = reference defaults (but: 4; firws: data-driven
        transition-band rule).
    direction : {"twopass", "onepass", "onepass-minphase"}
        Filter direction; "twopass" is zero-phase forward-backward,
        "onepass-minphase" converts the FIR to minimum phase (firws only).
    window : str
        FIR design window (firws), e.g. "hamming", "blackman", "kaiser".
    polyremoval : {0, 1, None}
        Demean (0) or linearly detrend (1) each trial first.
    zscore : bool
        Standardize each channel per trial after filtering.
    rectify : bool
        Full-wave rectification (absolute value); exclusive with `hilbert`.
    hilbert : {False, "abs", "complex", "real", "imag", "absreal",
        "absimag", "angle"}
        Analytic-signal transform of the filtered data.
    keeptrials : bool
        If False, average the preprocessed trials.
    parallel : bool or None
        Resolved by parallel/mesh.py::resolve_parallel: every step shards
        its trials over the mesh's trial axis and its channels over the
        channel axis (the Butterworth kernel launches once per trial shard
        and chunk).

    Returns
    -------
    :class:`~syncopy_tpu_torch.AnalogData`
        Filtered data with identical trial layout and replayable ``cfg``.

    Reference: preprocessing.py:45.
    """
    data_parser(data, varname="data", dataclass="AnalogData", empty=False)

    defaults = get_defaults(preprocessing)
    lcls = dict(locals())
    check_passed_kwargs(lcls, defaults, frontend_name="preprocessing")
    new_cfg = get_frontend_cfg(defaults, lcls, kwargs)

    if filter_class is not None:
        if filter_class not in availableFilters:
            raise SPYValueError(legal=str(availableFilters), varname="filter_class", actual=str(filter_class))
        if not isinstance(filter_type, str) or filter_type not in availableFilterTypes:
            raise SPYValueError(legal=str(availableFilterTypes), varname="filter_type", actual=str(filter_type))
        if filter_type in ("lp", "hp"):
            scalar_parser(freq, varname="freq", lims=[0, data.samplerate / 2])
        else:
            array_parser(freq, varname="freq", hasinf=False, hasnan=False,
                         lims=[0, data.samplerate / 2], dims=(2,))
            if freq[0] == freq[1]:
                raise SPYValueError(legal="two different frequencies", varname="freq", actual=str(freq))
            freq = np.sort(freq)
        if order is not None:
            scalar_parser(order, varname="order", lims=[0, np.inf], ntype="int_like")
        else:
            order = 4 if filter_class == "but" else 1000
        if direction not in availableDirections:
            raise SPYValueError(legal=str(availableDirections), varname="direction", actual=str(direction))
        if filter_class == "but" and direction == "onepass-minphase":
            raise SPYValueError(
                legal="'onepass-minphase' is FIR only", varname="direction", actual=direction
            )
        if window not in availableWindows:
            raise SPYValueError(legal=str(availableWindows), varname="window", actual=str(window))
    elif polyremoval is None and zscore is False:
        raise SPYValueError(
            legal="a preprocessing method", varname="filter_class/polyremoval/zscore",
            actual="neither filtering, detrending or zscore requested",
        )

    if polyremoval is not None:
        scalar_parser(polyremoval, varname="polyremoval", ntype="int_like", lims=[0, 1])
    if not isinstance(zscore, bool):
        raise SPYValueError("either `True` or `False`", varname="zscore", actual=str(zscore))
    if not isinstance(rectify, bool):
        raise SPYValueError("either `True` or `False`", varname="rectify", actual=str(rectify))
    if rectify and hilbert:
        raise SPYValueError(
            legal="either rectification or Hilbert transform", varname="rectify/hilbert",
            actual=str((rectify, hilbert)),
        )
    if hilbert and hilbert is not True:
        if hilbert not in hilbert_outputs:
            raise SPYValueError(legal=str(hilbert_outputs), varname="hilbert", actual=str(hilbert))
    elif hilbert is True:
        hilbert = "abs"

    from .compRoutines import (
        ButFiltering,
        Detrending,
        Hilbert,
        Rectify,
        SincFiltering,
        Standardize,
    )

    log_dict = {"polyremoval": polyremoval, "zscore": zscore, "filter_class": filter_class}
    current = data

    # z-scoring pre-pass (reference preprocessing.py:227-235)
    if zscore:
        current = _run_chain_step(
            Standardize(polyremoval=polyremoval), current, keeptrials, log_dict,
            parallel=parallel,
        )
        polyremoval_filter = None
    else:
        polyremoval_filter = polyremoval

    if filter_class == "but":
        check_effective_parameters(
            ButFiltering, defaults, lcls, besides=["zscore", "rectify", "hilbert", "window"]
        )
        log_dict.update({"filter_type": filter_type, "freq": freq, "order": order,
                         "direction": direction})
        cr = ButFiltering(
            samplerate=data.samplerate, filter_type=filter_type, freq=freq, order=order,
            direction=direction, polyremoval=polyremoval_filter,
        )
        current = _run_chain_step(cr, current, keeptrials, log_dict, parallel=parallel)
    elif filter_class == "firws":
        check_effective_parameters(
            SincFiltering, defaults, lcls, besides=["zscore", "rectify", "hilbert"]
        )
        log_dict.update({"filter_type": filter_type, "freq": freq, "order": order,
                         "direction": direction, "window": window})
        cr = SincFiltering(
            samplerate=data.samplerate, filter_type=filter_type, freq=freq, order=order,
            direction=direction, window=window, polyremoval=polyremoval_filter,
        )
        current = _run_chain_step(cr, current, keeptrials, log_dict, parallel=parallel)
    elif filter_class is None and polyremoval is not None and not zscore:
        current = _run_chain_step(
            Detrending(polyremoval=polyremoval), current, keeptrials, log_dict,
            parallel=parallel,
        )

    if rectify:
        current = _run_chain_step(Rectify(), current, keeptrials, log_dict, parallel=parallel)
    elif hilbert:
        current = _run_chain_step(Hilbert(output=hilbert), current, keeptrials, log_dict,
                                  parallel=parallel)

    if current is data:
        raise SPYError("No preprocessing step was performed")

    current.cfg.update(data.cfg)
    current.cfg.update({"preprocessing": new_cfg})
    return current


def _run_chain_step(cr, data, keeptrials, log_dict, parallel=None):
    out = AnalogData(dimord=data.dimord)
    cr.initialize(data, out._stackingDim, keeptrials=keeptrials)
    cr.compute(data, out, log_dict=log_dict, parallel=parallel)
    # per-trial NaN flags from the aux side-channel -> trial indices
    # (reference res.info['nan_trials'], compRoutines.py:256)
    has_nan = cr.aux_info.get("has_nan")
    if has_nan is not None:
        out.info["nan_trials"] = [int(i) for i in np.where(np.asarray(has_nan))[0]]
    return out
