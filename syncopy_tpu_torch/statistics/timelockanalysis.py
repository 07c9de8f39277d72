# -*- coding: utf-8 -*-
#
# timelockanalysis: trial average / variance / covariance of time-locked
# AnalogData.
#
# Port of syncopy_tpu/statistics/timelockanalysis.py (parity target:
# reference syncopy/statistics/timelockanalysis.py:37-264): streamed
# engine passes for the trial mean, the exact two-pass variance, the
# batched covariance and, for keeptrials, a chunked identity copy.
# `parallel` resolves through parallel/mesh.py and shards every engine
# pass over the mesh.

import numpy as np

from ..datatype.continuous_data import TimeLockData
from ..engine.routine import ComputationalRoutine
from ..shared.errors import SPYTypeError, SPYValueError, SPYInfo
from ..shared.input_processors import check_passed_kwargs
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.latency import create_trial_selection, get_analysis_window
from ..shared.parsers import data_parser
from ..shared.tools import get_defaults, get_frontend_cfg

__all__ = ["timelockanalysis"]


class _TimeLockCopy(ComputationalRoutine):
    """Chunked identity pass: stream the (selected, time-locked) trials
    into the output payload without a whole-ensemble host stack. The
    engine uploads trials in their own dtype, so the copy is bit-exact."""

    valid_kws = []

    def output_trial_shape(self, trial_shape):
        return tuple(trial_shape), self.in_dtype

    def process_single_trial(self, trial, **cfg):
        return trial

    def process_batch(self, batch, **cfg):
        return batch

    def process_metadata(self, data, out):
        pass  # the frontend attaches the trialdefinition itself


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def timelockanalysis(
    data,
    latency="maxperiod",
    covariance=False,
    ddof=None,
    trials="all",
    keeptrials=False,
    parallel=None,
    **kwargs,
):
    """
    Trial average/variance (and optional channel covariance) of AnalogData
    after latency-based time locking.

    Parameters
    ----------
    data : :class:`~syncopy_tpu_torch.AnalogData`
        Continuous data; trials are cut/padded to the latency window.
    latency : "maxperiod", "minperiod", "prestim", "poststim", or [t0, t1]
        Time-lock window relative to trial offsets.
    covariance : bool
        Also compute the (channel x channel) covariance across the
        time-locked samples (``cov`` dataset).
    ddof : int or None
        Delta degrees of freedom for variance/covariance (None = 1).
    trials : "all" or array_like
        Trial subset to include.
    keeptrials : bool
        Keep the time-locked single trials in the primary dataset
        (``avg``/``var`` are computed either way).
    parallel : bool or None
        Resolved by parallel/mesh.py::resolve_parallel: the engine passes
        (mean, variance, covariance, the copy) shard the trials over the
        mesh; the covariance splits its demeaning over the channel axis.

    Returns
    -------
    :class:`~syncopy_tpu_torch.TimeLockData`
        With ``avg``/``var`` (and optional ``cov``) datasets.

    Reference: timelockanalysis.py:37.
    """
    data_parser(data, varname="data", empty=False, dataclass="AnalogData")
    if ddof is not None:
        if not isinstance(ddof, int) or ddof < 0:
            raise SPYValueError("positive integer value", "ddof", str(ddof))
    if not isinstance(covariance, bool):
        raise SPYTypeError(covariance, varname="covariance", expected="bool")
    if not isinstance(keeptrials, bool):
        raise SPYTypeError(keeptrials, varname="keeptrials", expected="bool")

    defaults = get_defaults(timelockanalysis)
    lcls = dict(locals())
    check_passed_kwargs(lcls, defaults, frontend_name="timelockanalysis")
    new_cfg = get_frontend_cfg(defaults, lcls, kwargs)

    prior_selection = data._selection

    # legacy `trials` keyword acts as a trial selection
    if trials != "all":
        if data.selection is not None and data.selection.select.get("trials") is not None:
            raise SPYValueError(
                legal="either `trials != 'all'` or selection", varname="trials",
                actual="trial keyword and trial selection",
            )
        select = dict(data.selection.select) if data.selection is not None else {}
        select["trials"] = trials
        data.selection = select

    try:
        window = get_analysis_window(data, latency)
        # keep only trials fully covering the window, then cut to it
        select, num_discard = create_trial_selection(data, window)
        if num_discard > 0:
            SPYInfo("Discarded {} trial(s) not covering the latency window".format(num_discard))
        select["latency"] = window
        data.selection = select
        sel = data.selection

        # streamed engine passes (reference streams per trial through one
        # worker, summary_stats-style; a host np.stack of the whole
        # ensemble would be unbounded): trial mean, exact two-pass
        # variance, covariance CR, and, for keeptrials, a chunked
        # identity copy.
        from .compRoutines import Covariance
        from .summary_stats import _run_trial_reduce, _streamed_trial_mean

        n_trials = len(sel.trial_ids)
        try:
            avg = _streamed_trial_mean(data, parallel=parallel)
        except SPYValueError as exc:
            if "same shape" in str(exc) or "identical trial shapes" in str(exc):
                raise SPYValueError(
                    legal="time-locked trials of equal length", varname="latency",
                    actual=str(exc),
                )
            raise
        _, m2_out = _run_trial_reduce(
            data, "centered_sq", center=avg,
            log_dict={"operation": "timelock var"}, parallel=parallel,
        )
        var = np.asarray(m2_out.data)
        if n_trials > 1:
            var = var * (n_trials / (n_trials - 1.0))

        cov = None
        if covariance:
            from .compRoutines import EngineScratch

            eff_ddof = ddof if ddof is not None else 1
            cov_cr = Covariance(ddof=eff_ddof, demean=True)
            cov_scratch = EngineScratch()
            cov_cr.initialize(data, 0, keeptrials=keeptrials)
            cov_cr.compute(data, cov_scratch, log_dict={"operation": "timelock covariance"},
                           device_resident=False, parallel=parallel)
            cov_arr = np.asarray(cov_scratch.data)
            cov = cov_arr if keeptrials else cov_arr[0]

        out = TimeLockData(samplerate=data.samplerate)
        offset = int(sel.trialdefinition[0, 2])
        n_time = avg.shape[0]
        if keeptrials:
            # chunked identity pass: the time-locked per-trial data streams
            # into the output without a whole-ensemble host stack
            _copy_cr = _TimeLockCopy()
            _copy_cr.initialize(data, 0, keeptrials=True)
            _copy_cr.compute(data, out, log_dict={"operation": "timelock copy"},
                             parallel=parallel)
            trl = np.zeros((n_trials, 3))
            trl[:, 0] = np.arange(n_trials) * n_time
            trl[:, 1] = trl[:, 0] + n_time
            trl[:, 2] = offset
        else:
            out.data = np.asarray(avg)
            trl = np.array([[0, n_time, offset]])
        out.trialdefinition = trl
        out._register_dataset("avg", np.asarray(avg))
        out._register_dataset("var", np.asarray(var))
        if cov is not None:
            out._register_dataset("cov", np.asarray(cov))

        chan = np.asarray(data.channel)
        ch_sel = sel.channel
        if ch_sel is not None:
            chan = chan[ch_sel] if isinstance(ch_sel, slice) else chan[np.asarray(ch_sel)]
        out.channel = chan
        out._log = str(data._log)
        out.log = "timelockanalysis: latency={}, {} trials".format(window, n_trials)
        out.cfg.update(data.cfg)
        out.cfg.update({"timelockanalysis": new_cfg})
        return out
    finally:
        data._selection = prior_selection
