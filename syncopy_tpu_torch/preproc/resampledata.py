# -*- coding: utf-8 -*-
#
# resampledata: down-/resampling frontend.
#
# Port of syncopy_tpu/preproc/resampledata.py (parity target: reference
# syncopy/preproc/resampledata.py:31-230). `parallel` resolves through
# parallel/mesh.py and shards the trials and channels over the mesh.

import fractions

import numpy as np

from ..datatype.continuous_data import AnalogData
from ..shared.errors import SPYValueError
from ..shared.input_processors import check_effective_parameters, check_passed_kwargs
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.parsers import data_parser, scalar_parser
from ..shared.tools import get_defaults, get_frontend_cfg

__all__ = ["resampledata"]

availableMethods = ("downsample", "resample")


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def resampledata(
    data,
    resamplefs=1.0,
    method="resample",
    lpfreq=None,
    order=None,
    keeptrials=True,
    parallel=None,
    **kwargs,
):
    """
    Change the sampling rate: ``'downsample'`` (integer factor, optional
    explicit anti-alias filter) or ``'resample'`` (rational polyphase with
    implicit windowed-sinc anti-aliasing).

    Parameters
    ----------
    data : :class:`~syncopy_tpu_torch.AnalogData`
        Continuous data to resample.
    resamplefs : float
        Target sampling rate in Hz. "downsample" requires an integer
        division of ``data.samplerate``; "resample" accepts any rational
        ratio.
    method : {"resample", "downsample"}
        Polyphase rational resampling (implicit anti-alias FIR) or plain
        decimation (optionally preceded by an explicit filter via
        `lpfreq`).
    lpfreq : float or None
        Explicit anti-alias low-pass cutoff in Hz for "downsample";
        for "resample", overrides the implicit FIR's cutoff.
    order : int or None
        Anti-alias FIR order (None = reference default rule).
    keeptrials : bool
        If False, average the resampled trials.
    parallel : bool or None
        Resolved by parallel/mesh.py::resolve_parallel: the trials shard
        over the mesh's trial axis, the channels over its channel axis.

    Returns
    -------
    :class:`~syncopy_tpu_torch.AnalogData`
        Resampled data with samplerate ``resamplefs`` and rescaled
        trial definition.

    Reference: resampledata.py:31.
    """
    data_parser(data, varname="data", dataclass="AnalogData", empty=False)

    defaults = get_defaults(resampledata)
    lcls = dict(locals())
    check_passed_kwargs(lcls, defaults, frontend_name="resampledata")
    new_cfg = get_frontend_cfg(defaults, lcls, kwargs)

    if method not in availableMethods:
        raise SPYValueError(legal=str(availableMethods), varname="method", actual=str(method))
    scalar_parser(resamplefs, varname="resamplefs", lims=[np.finfo(float).eps, data.samplerate])
    if lpfreq is not None:
        # the anti-alias cut must sit at or below the NEW Nyquist
        # (reference resampledata.py lpfreq validation: "less or equals
        # <resamplefs/2>")
        scalar_parser(lpfreq, varname="lpfreq", lims=[0, resamplefs / 2])
    if order is not None:
        scalar_parser(order, varname="order", ntype="int_like", lims=[0, np.inf])

    from .compRoutines import Downsample, Resample, SincFiltering

    log_dict = {"method": method, "resamplefs": resamplefs, "origfs": data.samplerate}
    current = data

    if method == "downsample":
        if data.samplerate % resamplefs != 0:
            raise SPYValueError(
                legal="integer division of the original sampling rate for method 'downsample'",
                varname="resamplefs", actual=str(resamplefs),
            )
        check_effective_parameters(Downsample, defaults, lcls, besides=["lpfreq", "order"])
        # optional explicit anti-alias filter pre-pass (reference
        # resampledata.py:215-222)
        if lpfreq is not None:
            aa = SincFiltering(
                samplerate=data.samplerate, filter_type="lp", freq=lpfreq,
                order=order if order is not None else 1000, direction="twopass",
            )
            current = _run(aa, current, keeptrials, log_dict, parallel=parallel)
        cr = Downsample(samplerate=data.samplerate, new_samplerate=resamplefs)
        out = _run(cr, current, keeptrials, log_dict, parallel=parallel)
    else:
        check_effective_parameters(Resample, defaults, lcls)
        cr = Resample(
            samplerate=data.samplerate, new_samplerate=resamplefs, lpfreq=lpfreq, order=order
        )
        out = _run(cr, current, keeptrials, log_dict, parallel=parallel)

    out.cfg.update(data.cfg)
    out.cfg.update({"resampledata": new_cfg})
    return out


def _run(cr, data, keeptrials, log_dict, parallel=None):
    out = AnalogData(dimord=data.dimord)
    cr.initialize(data, out._stackingDim, keeptrials=keeptrials)
    cr.compute(data, out, log_dict=log_dict, parallel=parallel)
    return out


def _get_updn(orig_fs, new_fs):
    """Rational up/down factors for polyphase resampling (reference
    resampling.py:123-139). Near-irrational rate ratios can yield large
    factors — same caveat as the reference."""
    frac = fractions.Fraction.from_float(new_fs / orig_fs).limit_denominator()
    return frac.numerator, frac.denominator
