# -*- coding: utf-8 -*-
#
# Jackknife resampling: leave-one-out trial-average replicates and
# bias/variance estimates.
#
# Port of syncopy_tpu/statistics/jackknifing.py (trial_avg_replicates,
# bias_var, _propagate_cross_props). Both run as streamed engine passes:
# the trial mean, then the replicates (LOOAverage) or the centred second
# moment (TrialReduce); the replicate ensemble is never stacked on the
# device.

import numpy as np

from ..shared.errors import SPYError, SPYValueError

__all__ = ["trial_avg_replicates", "bias_var"]


def trial_avg_replicates(trl_ensemble, parallel=None):
    """
    An object whose k-th trial is the leave-one-out trial average without
    trial k (reference jackknifing.py:14-108): two engine passes, the
    trial mean, then ``avg + (avg - x_k)/(N - 1)`` per trial.
    """
    from ..datatype.selector import Selector
    from .compRoutines import LOOAverage
    from .summary_stats import _streamed_trial_mean

    sel = trl_ensemble.selection if trl_ensemble.selection is not None else Selector(trl_ensemble, None)
    n_trials = len(sel.trial_ids)
    if n_trials < 2:
        raise SPYValueError(legal="at least 2 trials", varname="trl_ensemble", actual=str(n_trials))

    avg = _streamed_trial_mean(trl_ensemble, parallel=parallel)

    replicates = trl_ensemble.__class__(dimord=trl_ensemble.dimord)
    cr = LOOAverage(n_trials=n_trials, avg=avg)
    try:
        cr.initialize(trl_ensemble, trl_ensemble._stackingDim, keeptrials=True)
    except SPYValueError as exc:
        if "matching non-stacking" in str(exc) or "identical trial shapes" in str(exc):
            raise SPYValueError(
                legal="equal trial shapes for jackknifing", varname="trl_ensemble",
                actual=str(exc),
            )
        raise
    cr.compute(trl_ensemble, replicates, log_dict={"operation": "jackknife LOO replicates"},
               parallel=parallel)
    _propagate_cross_props(trl_ensemble, replicates)
    return replicates


def bias_var(direct_estimate, replicates, parallel=None):
    """
    Jackknife bias and variance from the direct estimate and the
    replicate ensemble (reference jackknifing.py:111-186):
    ``bias = (N-1) (mean(rep) - direct)``,
    ``var = (N-1) sum_i |mean(rep) - rep_i|^2``.

    Both streamed passes accumulate in float64: the bias multiplies the
    mean's rounding by N - 1. The bias comes back in the inputs'
    precision, the variance in float32, as in the JAX package.
    """
    if len(direct_estimate.trials) != 1:
        raise SPYValueError(
            legal="original trial statistic with one remaining trial",
            varname="direct_estimate",
            actual="{} trials".format(len(direct_estimate.trials)),
        )
    n_trials = len(replicates.trials)
    if n_trials <= 1:
        raise SPYValueError(
            legal="jackknife replicates with at least 2 trials",
            varname="replicates", actual="{} trials".format(n_trials),
        )

    from .summary_stats import _run_trial_reduce, _streamed_trial_mean

    # two streamed passes: the replicate mean, then the centred second
    # moment
    jack_avg = _streamed_trial_mean(replicates, double=True, parallel=parallel)
    direct_host = np.asarray(direct_estimate.trials[0])
    if tuple(jack_avg.shape) != direct_host.shape:
        raise SPYError(
            "Got mismatching shapes for jackknife bias computation: "
            "jack: {}, original estimate: {}".format(tuple(jack_avg.shape), direct_host.shape)
        )
    _, m2_out = _run_trial_reduce(
        replicates, "centered_sq", center=jack_avg,
        log_dict={"operation": "jackknife variance", "dim": "trials"}, double=True,
        parallel=parallel,
    )
    bias_dtype = np.result_type(direct_host.dtype, replicates.data.dtype)
    bias_host = ((n_trials - 1) * (jack_avg - direct_host)).astype(bias_dtype)
    # the engine returns E|x - mean|^2; var = (N-1) * sum = (N-1) * N * E
    var_host = (n_trials - 1) * n_trials * np.asarray(m2_out.data)

    bias = direct_estimate.__class__(dimord=direct_estimate.dimord)
    bias.data = bias_host
    variance = direct_estimate.__class__(dimord=direct_estimate.dimord)
    variance.data = var_host.astype(np.float32)
    for obj in (bias, variance):
        if direct_estimate.samplerate is not None:
            obj.samplerate = direct_estimate.samplerate
        obj.trialdefinition = np.array(direct_estimate.trialdefinition)
        _propagate_cross_props(direct_estimate, obj)
    return bias, variance


def _propagate_cross_props(src, dst):
    for prop in ("channel", "channel_i", "channel_j", "freq", "taper"):
        if prop in src.dimord and hasattr(dst.__class__, prop):
            try:
                setattr(dst, prop, np.asarray(getattr(src, prop)))
            except Exception:
                pass
