# -*- coding: utf-8 -*-
#
# Summary statistics over one dimension or over trials, and inter-trial
# coherence.
#
# Port of syncopy_tpu/statistics/summary_stats.py (mean, std, var, median,
# itc and their helpers). Trial statistics stream through the engine
# (TrialReduce, chunked on the device); var/std are the exact two-pass
# form (the mean, then the centred second moment).

import numpy as np
import torch

from ..shared.errors import SPYError, SPYValueError
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.parsers import data_parser
from .compRoutines import NumpyStatDim, TrialReduce, _propagate_dim_props

__all__ = ["mean", "std", "var", "median", "itc"]


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def mean(spy_data, dim, keeptrials=True, parallel=None, **kwargs):
    """Average a data object along one dimension.

    Parameters
    ----------
    spy_data : data object
        Any data class (AnalogData, SpectralData, CrossSpectralData, ...).
    dim : str
        A dimord label of `spy_data` (e.g. "channel", "freq", "time") or
        "trials" for the across-trial average (streamed on the device).
    keeptrials : bool
        For dimension statistics: keep per-trial results (ignored for
        dim="trials").
    parallel : bool or None
        Accepted for API parity and ignored: the engine runs on one device.

    Returns
    -------
    Same class as `spy_data` with the reduced dimension singleton.

    Reference: summary_stats.py:24.
    """
    return _statistics(spy_data, "mean", dim, keeptrials, **kwargs)


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def std(spy_data, dim, keeptrials=True, parallel=None, **kwargs):
    """Standard deviation along `dim`.

    Parameters as in :func:`~syncopy_tpu_torch.mean`; dim="trials"
    streams a centred-moment reduction on the device. Reference:
    summary_stats.py:58.
    """
    return _statistics(spy_data, "std", dim, keeptrials, **kwargs)


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def var(spy_data, dim, keeptrials=True, parallel=None, **kwargs):
    """Variance along `dim`.

    Parameters as in :func:`~syncopy_tpu_torch.mean`; dim="trials"
    streams a centred-moment reduction on the device. Reference:
    summary_stats.py:91.
    """
    return _statistics(spy_data, "var", dim, keeptrials, **kwargs)


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def median(spy_data, dim, keeptrials=True, parallel=None, **kwargs):
    """Median along `dim`.

    Parameters as in :func:`~syncopy_tpu_torch.mean`. The trial median is
    not supported (an order statistic over the trial stack); dimension
    medians run per trial. Reference: summary_stats.py:124.
    """
    return _statistics(spy_data, "median", dim, keeptrials, **kwargs)


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def itc(spec_data, parallel=None, **kwargs):
    """Inter-trial coherence of complex spectra.

    Parameters
    ----------
    spec_data : :class:`~syncopy_tpu_torch.SpectralData`
        Complex spectra (``output="fourier"``, trials kept).
    parallel : bool or None
        Accepted for API parity and ignored.

    Returns
    -------
    :class:`~syncopy_tpu_torch.SpectralData`
        Real-valued ITC (the modulus of the mean unit phasor, in [0, 1]),
        streamed across trials on the device.

    Reference: summary_stats.py:156-205.
    """
    data_parser(spec_data, varname="spec_data", dataclass="SpectralData", empty=False)
    if not np.issubdtype(np.dtype(spec_data.data.dtype), np.complexfloating):
        raise SPYValueError(
            legal="complex valued spectra, set `output='fourier'` in "
            "syncopy_tpu_torch.freqanalysis!",
            varname="spec_data", actual="real valued spectral data",
        )
    res = _trial_statistics(spec_data, operation="itc")
    res.cfg.update(spec_data.cfg)
    return res


def _statistics(spy_data, operation, dim, keeptrials=True, **kwargs):
    """Dimension statistics (NumpyStatDim) or trial statistics (streamed
    TrialReduce); reference summary_stats.py:207-319."""
    data_parser(spy_data, varname="spy_data", empty=False)
    if dim != "trials" and dim not in spy_data.dimord:
        raise SPYValueError(
            legal="one of {} or 'trials'".format(spy_data.dimord), varname="dim", actual=str(dim)
        )

    log_dict = {"operation": operation, "dim": dim, "keeptrials": keeptrials}

    if dim == "trials":
        if operation == "median":
            raise SPYError("Trial median not supported at the moment")
        out = _trial_statistics(spy_data, operation)
        out.log = "computed trial statistics {}".format(log_dict)
        out.cfg.update(spy_data.cfg)
        return out

    avCR = NumpyStatDim(operation=operation, axis=spy_data.dimord.index(dim))
    out = spy_data.__class__(dimord=spy_data.dimord)
    avCR.initialize(spy_data, spy_data._stackingDim, keeptrials=keeptrials)
    avCR.compute(spy_data, out, log_dict=log_dict)
    out.cfg.update(spy_data.cfg)
    return out


def _check_equal_trials(in_data):
    """The selection and its trial count (at least one)."""
    from ..datatype.selector import Selector

    sel = in_data.selection if in_data.selection is not None else Selector(in_data, None)
    n_trials = len(sel.trial_ids)
    if n_trials < 1:
        raise SPYValueError(legal="at least 1 trial", varname="in_data", actual="0 trials")
    return sel, n_trials


def _run_trial_reduce(in_data, mode, center=None, post_device_fn=None, log_dict=None,
                      double=False):
    """One streamed engine pass of :class:`TrialReduce` over `in_data`:
    chunked accumulation on the device (in float64 with `double`), host
    memory bounded by one chunk. Returns ``(routine, output object)``."""
    cr = TrialReduce(mode=mode, center=center, double=double)
    out = in_data.__class__(dimord=in_data.dimord)
    try:
        cr.initialize(in_data, in_data._stackingDim, keeptrials=False)
    except SPYValueError as exc:
        if "identical trial shapes" in str(exc):
            raise SPYValueError(
                legal="all trials to have the same shape",
                varname="in_data",
                actual="found trials of different shape",
            )
        raise
    cr.compute(in_data, out, log_dict=log_dict, post_device_fn=post_device_fn)
    return cr, out


def _streamed_trial_mean(in_data, double=False):
    """The trial average as a host array (pass 1 of two-pass statistics)."""
    _, out = _run_trial_reduce(in_data, "sum", log_dict={"operation": "mean", "dim": "trials"},
                               double=double)
    return np.asarray(out.data)


def _trial_statistics(in_data, operation="mean"):
    """A statistic over the trial axis, streamed through the engine
    (reference summary_stats.py:321-405); var and std are exact two-pass
    (the mean, then the centred second moment)."""
    sel, n_trials = _check_equal_trials(in_data)
    log_dict = {"operation": operation, "dim": "trials"}

    if operation == "mean":
        _, out_data = _run_trial_reduce(in_data, "sum", log_dict=log_dict)
    elif operation in ("var", "std"):
        center = _streamed_trial_mean(in_data)
        _, out_data = _run_trial_reduce(
            in_data, "centered_sq", center=center,
            post_device_fn=torch.sqrt if operation == "std" else None, log_dict=log_dict,
        )
    elif operation == "itc":
        taper_ax = in_data.dimord.index("taper")

        def post(resultant):
            return resultant.mean(dim=taper_ax, keepdim=True).abs()

        _, out_data = _run_trial_reduce(in_data, "unit_sum", post_device_fn=post,
                                        log_dict=log_dict)
    else:
        raise SPYValueError(legal="mean/var/std/itc", varname="operation", actual=operation)

    out_data._trialdefinition = sel.trialdefinition[0, :][None, :]
    reduced = "taper" if operation == "itc" else None
    _propagate_dim_props(in_data, out_data, sel, reduced_dim=reduced, label="itc")
    out_data._log = str(in_data._log)
    return out_data
