# -*- coding: utf-8 -*-
#
# spike_psth: peristimulus time histogram frontend for SpikeData.
#
# Copy of syncopy_tpu/statistics/spike_psth.py, which imports no jax
# (parity target: reference syncopy/statistics/spike_psth.py:37-248); host
# numpy on the port's SpikeData. Like every entry point of the port it
# checks the device setting first (no card and no set_device("cpu")
# raises). `parallel` resolves through parallel/mesh.py; the histogram
# is host numpy and uses no mesh, as in the JAX package.

import numpy as np

from ..datatype.continuous_data import TimeLockData
from ..engine.routine import default_device
from ..shared.errors import SPYTypeError, SPYValueError, SPYInfo
from ..shared.input_processors import check_passed_kwargs
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.latency import create_trial_selection, get_analysis_window
from ..shared.parsers import data_parser, scalar_parser
from ..shared.tools import get_defaults, get_frontend_cfg
from .psth import Rice_rule, get_chan_unit_combs, psth, sqrt_rule

__all__ = ["spike_psth"]

available_binsizes = {"rice": Rice_rule, "sqrt": sqrt_rule}
available_outputs = ("rate", "spikecount", "proportion")


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def spike_psth(
    data,
    binsize="rice",
    output="rate",
    latency="maxperiod",
    vartriallen=True,
    keeptrials=True,
    parallel=None,
    **kwargs,
):
    """
    Peristimulus time histogram of :class:`~syncopy_tpu_torch.SpikeData`.

    Parameters
    ----------
    data : :class:`~syncopy_tpu_torch.SpikeData`
        Spike samples with dimord ``["sample", "channel", "unit"]``.
    binsize : "rice", "sqrt", or float
        Bin width rule (Rice or square-root histogram rules on the
        average spike count) or an explicit width in seconds.
    output : {"rate", "spikecount", "proportion"}
        Firing rate (Hz), raw counts, or per-trial spike proportion.
    latency : "maxperiod", "minperiod", "prestim", "poststim", or [t0, t1]
        Analysis window relative to trial offsets; array = explicit window
        in seconds.
    vartriallen : bool
        Accept trials that do not fully cover the latency window (bins
        outside a trial contribute NaN and are excluded from averages).
    keeptrials : bool
        Keep per-trial histograms (the trial average/variance land in the
        ``avg``/``var`` datasets either way).
    parallel : bool or None
        Resolved by parallel/mesh.py::resolve_parallel and validated; the
        histogram is host numpy and uses no mesh, as in the JAX package.

    Returns
    -------
    :class:`~syncopy_tpu_torch.TimeLockData`
        Time-locked histograms, one channel per (channelN, unitM) pair,
        plus ``avg``/``var`` datasets.

    Reference: spike_psth.py:37.
    """
    default_device()
    data_parser(
        data, varname="data", dataclass="SpikeData", empty=False,
        dimord=["sample", "channel", "unit"],
    )
    if not isinstance(vartriallen, bool):
        raise SPYTypeError(vartriallen, varname="vartriallen", expected="Bool")
    if output not in available_outputs:
        raise SPYValueError(
            legal="one of {}".format(available_outputs), varname="output", actual=str(output)
        )
    if isinstance(binsize, str):
        if binsize not in available_binsizes:
            raise SPYValueError(
                legal="one of {}".format(list(available_binsizes)), varname="binsize",
                actual=binsize,
            )
    else:
        scalar_parser(binsize, varname="binsize", lims=[0, np.inf])

    defaults = get_defaults(spike_psth)
    lcls = dict(locals())
    check_passed_kwargs(lcls, defaults, frontend_name="spike_psth")
    new_cfg = get_frontend_cfg(defaults, lcls, kwargs)

    prior_selection = data._selection
    try:
        window = get_analysis_window(data, latency)
        if not isinstance(binsize, str) and binsize > (window[1] - window[0]):
            raise SPYValueError(
                legal="binsize less or equals {:.3g} (the analysis window)".format(
                    window[1] - window[0]),
                varname="binsize", actual=str(binsize),
            )
        if not vartriallen:
            select, num_discard = create_trial_selection(data, window)
            if num_discard > 0:
                SPYInfo("Discarded {} trial(s) not covering the latency window".format(num_discard))
            select["latency"] = list(window)
            data.selection = select
        else:
            # vartriallen: trials may cover the window only PARTIALLY
            # (maxperiod spans the union of all trials) — the histogram
            # bin edges bound the counted range, so the window must NOT go
            # through the selection (whose latency semantics require full
            # containment); uncovered bins are NaN-masked below
            if data.selection is None:
                data.selection = {}
        sel = data.selection

        trials = [sel.select_trial_array(data, k) for k in range(len(sel.trial_ids))]
        trl_def = sel.trialdefinition

        # bin edges over the analysis window
        n_events = int(sum(t.shape[0] for t in trials))
        if isinstance(binsize, str):
            nBins = available_binsizes[binsize](n_events)
            tbins = np.linspace(window[0], window[1], nBins + 1)
        else:
            nBins = int(np.ceil((window[1] - window[0]) / binsize))
            tbins = window[0] + np.arange(nBins + 1) * binsize

        combs = get_chan_unit_combs(trials)
        if combs.size == 0:
            raise SPYValueError(legal="at least one spike event", varname="data")

        counts = []
        for k, trl in enumerate(trials):
            tid = sel.trial_ids[k]
            trl_start = data.sampleinfo[tid, 0]
            onset = data._t0[tid]
            trl_end = data.sampleinfo[tid, 1]
            if trl.shape[0] == 0:
                counts.append(np.full((nBins, len(combs)), np.nan))
                continue
            c = psth(
                trl, trl_start, onset, trl_end, chan_unit_combs=combs, tbins=tbins,
                output=output, samplerate=data.samplerate,
            )
            if vartriallen:
                # mask bins outside this trial's coverage with NaN
                starts, ends = data.trialintervals[tid]
                centers = 0.5 * (tbins[:-1] + tbins[1:])
                outside = (centers < starts) | (centers > ends)
                c[outside, :] = np.nan
            counts.append(c)

        stack = np.stack(counts)  # (nTrials, nBins, nCombs)
        import warnings

        with warnings.catch_warnings():
            # all-NaN bins (uncovered window edges) legitimately yield NaN
            warnings.simplefilter("ignore", category=RuntimeWarning)
            avg = np.nanmean(stack, axis=0)
            var = np.nanvar(stack, axis=0, ddof=1 if stack.shape[0] > 1 else 0)

        out = TimeLockData(samplerate=1.0 / (tbins[1] - tbins[0]))
        bin_offset = int(round(tbins[0] / (tbins[1] - tbins[0])))
        if keeptrials:
            out.data = stack.reshape(-1, len(combs)).astype(np.float32)
            trl = np.zeros((stack.shape[0], 3))
            trl[:, 0] = np.arange(stack.shape[0]) * nBins
            trl[:, 1] = trl[:, 0] + nBins
            trl[:, 2] = bin_offset
        else:
            out.data = avg.astype(np.float32)
            trl = np.array([[0, nBins, bin_offset]])
        out.trialdefinition = trl
        out._register_dataset("avg", avg.astype(np.float32))
        out._register_dataset("var", var.astype(np.float32))
        out.channel = ["channel{}_unit{}".format(int(c), int(u)) for c, u in combs]
        out._log = str(data._log)
        out.log = "spike_psth: binsize={}, output={}, {} trials".format(binsize, output, stack.shape[0])
        out.cfg.update(data.cfg)
        out.cfg.update({"spike_psth": new_cfg})
        return out
    finally:
        data._selection = prior_selection
