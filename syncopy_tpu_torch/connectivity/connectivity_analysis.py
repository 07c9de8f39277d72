# -*- coding: utf-8 -*-
#
# connectivityanalysis: user-facing connectivity frontend (coh, corr, csd,
# ppc, granger; jackknife error estimates for coh and granger).
#
# Port of syncopy_tpu/connectivity/connectivity_analysis.py. A single-trial
# stage computes cross spectra, from AnalogData (CrossSpectra, PPCSpectra)
# or from complex SpectralData (SpectralDyadicProduct, with `channelcmb`);
# where trials are averaged, the normalization runs fused on the device
# onto the stage's trial sum, and the result is read back once, in full.
# - coh: the trial-averaged CSD, normalized.
# - csd: the single-trial (keeptrials=True) or averaged CSD.
# - ppc from AnalogData: the fused route, PPCSpectra (spectra and the
#   unit-phasor resultant in one pass, through the CUDA kernel on the
#   card) with PPCReduction's post. ppc from SpectralData: the two-pass
#   route, single-trial SpectralDyadicProduct then _compute_ppc.
# - granger: the averaged CSD (from AnalogData in float64 with demeaned
#   tapers), then GrangerCausality (regularization, Wilson, Granger in
#   complex128 on the device); with `channelcmb`, one batched
#   factorization of all 2x2 pair CSDs of every window. A CSD singular by
#   construction (the rank gate) and a device factorization that did not
#   converge go to the host float64 path, with a warning.
# - corr (AnalogData only): CrossCovariance's trial sum in the frequency
#   domain with the normalization fused on, or single-trial normalized
#   cross-covariances with keeptrials.
# - jackknife (coh, granger): the single-trial CSDs, their mean as the
#   direct estimate, the leave-one-out replicates (statistics/), the AV
#   routine on both, then bias and variance as the datasets jack_bias and
#   jack_var.
# Not ported: the SPY_TPU_FUSED_PPC switch back to the two-pass route from
# AnalogData and the SPY_GRANGER_HOST switch to the host factorization
# (the port has no environment knobs), and the triangular and Hermitian
# readback packs, workarounds for the TPU runtime's readback.

import numpy as np
import torch

from ..datatype.continuous_data import AnalogData, CrossSpectralData, SpectralData
from ..shared.errors import SPYInfo, SPYTypeError, SPYValueError, SPYWarning
from ..shared.input_processors import (
    check_effective_parameters,
    check_passed_kwargs,
    process_foi,
    process_padding,
    process_taper,
)
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.parsers import data_parser, scalar_parser, sequence_parser
from ..shared.profiling import spanned
from ..shared.tools import best_match, get_defaults, get_frontend_cfg

__all__ = ["connectivityanalysis"]

availableMethods = ("coh", "corr", "granger", "csd", "ppc")
connectivity_outputs = ("abs", "pow", "complex", "fourier", "angle", "real", "imag")

#: retry a device Granger factorization that did not converge with the
#: host float64 one (the JAX package's SPY_GRANGER_HOST_FALLBACK)
_GRANGER_HOST_FALLBACK = True


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
    Perform connectivity analysis of AnalogData or (complex) SpectralData.

    Methods: ``coh`` (coherence), ``corr`` (cross-correlation),
    ``granger`` (nonparametric Granger-Geweke causality via Wilson
    factorization), ``csd`` (single-trial/averaged cross-spectra), ``ppc``
    (pairwise phase consistency).

    Parameters
    ----------
    data : :class:`~syncopy_tpu_torch.AnalogData` or complex :class:`~syncopy_tpu_torch.SpectralData`
        Time series, or pre-computed single-trial Fourier spectra
        (``output="fourier"``, trials kept).
    method : {"coh", "corr", "granger", "csd", "ppc"}
        Connectivity measure (see above).
    keeptrials : bool
        Keep single-trial estimates ("csd"/"corr" only; the averaged
        measures are defined across trials).
    output : str
        For "coh": "abs", "pow", "complex"/"fourier", "real", "imag",
        "angle". Ignored (with a warning) by the other methods.
    foi, foilim : array_like / [fmin, fmax] / None
        Frequencies of interest (AnalogData input).
    pad : "maxperlen", "nextpow2", or float
        Trial padding policy ("corr" requires the default).
    channelcmb : [senders, receivers] or None
        Two channel lists restricting the pairwise computation (granger:
        one factorization per pair); needs SpectralData input. Results
        contain only the requested block.
    polyremoval : {0, 1, None}
        Per-trial detrend order before tapering.
    tapsmofrq, nTaper, taper, taper_opt
        Multi-taper controls (AnalogData input).
    jackknife : bool
        Leave-one-out trial jackknife for "coh" and "granger": the
        datasets ``jack_bias`` and ``jack_var`` of the result hold the
        bias and variance estimates. The leave-one-out CSDs must be full
        rank for Granger, i.e. ``(nTrials - 1) * nTapers >= nChannels``
        (a warning says so otherwise). Ignored with a warning by the other
        methods.
    parallel : bool or None
        Resolved by parallel/mesh.py::resolve_parallel and passed to every
        engine pass: the single-trial stage shards its trials (and, for the
        per-channel spectra, its channels) over the mesh; the averaged CSD,
        the regularization and Wilson run on the mesh's first position.

    Returns
    -------
    :class:`~syncopy_tpu_torch.CrossSpectralData`
        ``(time, freq, channel_i, channel_j)`` connectivity estimates with
        replayable ``cfg``; Granger convergence diagnostics land in
        ``out.info``; with `jackknife`, ``out._get_extra_dataset("jack_var")``
        and ``"jack_bias"``.

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
    if not isinstance(jackknife, bool):
        raise SPYTypeError(jackknife, "jackknife", "boolean")
    if jackknife and method not in ("coh", "granger"):
        SPYWarning("Jackknife is not available for method {}".format(method))
        jackknife = False
    if method != "coh" and output != defaults["output"]:
        SPYWarning("Setting `output` for method {} has no effect!".format(method))

    if data.selection is not None:
        sinfo = data.selection.trialdefinition[:, :2]
    else:
        sinfo = data.sampleinfo
    lenTrials = np.atleast_1d(np.diff(sinfo).squeeze())
    nTrials = len(sinfo)

    send_idx = rec_idx = None
    if channelcmb is not None:
        send_idx, rec_idx = _digest_channelcmb(data, channelcmb)
    if method == "corr" and pad != "maxperlen":
        raise SPYValueError(
            legal="'maxperlen', no padding needed/allowed for cross-correlations",
            varname="pad", actual=str(pad),
        )
    if polyremoval is not None:
        scalar_parser(polyremoval, varname="polyremoval", ntype="int_like", lims=[0, 1])

    log_dict = {"method": method, "keeptrials": keeptrials, "polyremoval": polyremoval,
                "pad": pad, "channelcmb": channelcmb}
    new_cfg = get_frontend_cfg(defaults, lcls, kwargs)

    from .ST_compRoutines import CrossCovariance, CrossSpectra, PPCSpectra, SpectralDyadicProduct

    # -- single-trial stage setup ---------------------------------------- #

    if method == "corr":
        if not isinstance(data, AnalogData):
            raise SPYValueError(
                legal="AnalogData instance as input for method corr", varname="data",
                actual=data.__class__.__name__,
            )
        if foi is not None:
            SPYWarning("Parameter `foi` has no effect for method `corr`")
        check_effective_parameters(CrossCovariance, defaults, lcls, besides=["jackknife"])
        st_compRoutine = CrossCovariance(
            samplerate=data.samplerate, polyremoval=polyremoval, norm=bool(keeptrials))
    elif nTrials == 1:
        raise SPYValueError(
            legal="multi-trial input data, spectral connectivity measures "
            "critically depend on trial averaging!",
            varname="data", actual="only one trial",
        )
    elif keeptrials is not False and method in ("coh", "ppc", "granger"):
        raise SPYValueError(
            legal="False, trial averaging needed for method {}!".format(method),
            varname="keeptrials", actual=str(keeptrials),
        )
    elif isinstance(data, AnalogData):
        nSamples = process_padding(pad, lenTrials, data.samplerate)
        check_effective_parameters(CrossSpectra, defaults, lcls, besides=["jackknife", "channelcmb"])
        # ppc from AnalogData: spectra and the unit-phasor reduction in one
        # engine pass (PPCSpectra); the per-trial CSD stack never exists
        st_compRoutine = _setup_cross_spectra(
            data, method, nSamples, foi, foilim, tapsmofrq, nTaper, taper, taper_opt,
            polyremoval, lenTrials, log_dict,
            cls=PPCSpectra if method == "ppc" else CrossSpectra,
        )
    else:
        # dtype check via the payload's dtype attribute: no element access
        if not np.issubdtype(np.dtype(data.data.dtype), np.complexfloating):
            raise SPYValueError(
                legal="complex valued spectra, set `output='fourier'` in "
                "syncopy_tpu_torch.freqanalysis!",
                varname="data", actual="real valued spectral data",
            )
        if method == "granger":
            _granger_spectral_input_notes(data)
        check_effective_parameters(
            SpectralDyadicProduct, defaults, lcls, besides=["jackknife", "channelcmb"]
        )
        if send_idx is not None and method in ("ppc", "csd"):
            st_compRoutine = SpectralDyadicProduct(send_idx=send_idx, rec_idx=rec_idx)
        else:
            st_compRoutine = SpectralDyadicProduct()

    if method == "coh":
        if output not in connectivity_outputs:
            raise SPYValueError(
                legal="one of {}".format(connectivity_outputs), varname="output", actual=output
            )
        log_dict["output"] = output

    # -- run the single-trial stage --------------------------------------- #

    st_out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    # ppc from SpectralData runs in two passes: single-trial cross spectra,
    # then the resultant reduction of _compute_ppc
    two_pass_ppc = method == "ppc" and not isinstance(data, AnalogData)
    st_keeptrials = bool(keeptrials or jackknife or two_pass_ppc)
    st_compRoutine.initialize(data, st_out._stackingDim, keeptrials=st_keeptrials)

    if st_keeptrials:
        st_compRoutine.compute(data, st_out, log_dict=log_dict, parallel=parallel)
    else:
        # the trial average's normalization, fused onto the device-side
        # trial sum; csd keeps the average as it is
        if method == "coh":
            post = lambda csd_avg: _coh_post(csd_avg, output=output)  # noqa: E731
        elif method == "ppc":
            from .AV_compRoutines import PPCReduction

            post = PPCReduction.make_post(st_compRoutine.numTrials)
        elif method == "corr":
            post = _corr_post
        else:
            post = lambda csd_avg: csd_avg  # noqa: E731
        st_compRoutine.compute(data, st_out, log_dict=log_dict, post_device_fn=post,
                               parallel=parallel)

    replicates = None
    if jackknife:
        from ..statistics.jackknifing import trial_avg_replicates
        from ..statistics.summary_stats import mean

        if method == "granger":
            _jackknife_rank_note(st_compRoutine, nTrials, len(data.channel))
        # the replicates first: then the single-trial stack can go
        replicates = trial_avg_replicates(st_out, parallel=parallel)
        st_out = mean(st_out, dim="trials", parallel=parallel)

    if method == "granger":
        out = _granger(st_out, st_compRoutine, nTrials, send_idx, rec_idx, data, log_dict,
                       parallel)
    elif jackknife:  # coh, in float64 until the bias is formed
        out = _normalize_cross_spectra(st_out, output, log_dict, double=True,
                                       parallel=parallel)
    elif two_pass_ppc:
        out = _compute_ppc(st_out, parallel)
    else:
        out = st_out
    if jackknife:
        _attach_jackknife(out, replicates, method, output, log_dict, parallel)
    if send_idx is not None and method == "coh":
        out = out.selectdata(channel_i=[str(c) for c in np.asarray(data.channel)[send_idx]])
        out = out.selectdata(channel_j=[str(c) for c in np.asarray(data.channel)[rec_idx]])
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


def _corr_post(ccov_avg):
    """Device-side cross-correlation normalization of the trial-averaged
    cross-covariance (reference AV_compRoutines.normalize_ccov_cF)."""
    from ..ops.connectivity import normalize_ccov

    return normalize_ccov(ccov_avg)


def _normalize_cross_spectra(csd, output, log_dict, keeptrials=False, double=False,
                             parallel=None):
    """Coherence of averaged CSDs through NormalizeCrossSpectra: one row
    (the direct estimate) or, with `keeptrials`, every jackknife
    replicate; in float64 with `double`."""
    from .AV_compRoutines import NormalizeCrossSpectra

    out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    av = NormalizeCrossSpectra(output=output, double=double)
    av.initialize(csd, out._stackingDim, keeptrials=keeptrials)
    if not keeptrials:
        av.pre_check()
    av.compute(csd, out, log_dict=log_dict, parallel=parallel)
    return out


def _jackknife_rank_note(st_compRoutine, nTrials, n_chan):
    """Warn when the leave-one-out CSDs are singular by construction: each
    trial adds rank <= nTapers, so (nTrials - 1) * nTapers < nChannels
    leaves every replicate without a Wilson factorization."""
    n_tap = _granger_n_tapers(st_compRoutine)
    if (nTrials - 1) * n_tap < n_chan:
        SPYWarning(
            "jackknife Granger with {} trials x {} taper(s) on {} channels: leave-one-out "
            "CSDs have rank {} < {} and are singular, so the factorization CANNOT "
            "converge. Use more trials/tapers or fewer channels.".format(
                nTrials, n_tap, n_chan, (nTrials - 1) * n_tap, n_chan)
        )


def _attach_jackknife(out, replicates, method, output, log_dict, parallel=None):
    """The AV stage on the leave-one-out `replicates` (coherence, or
    Granger with the JAX package's host float64 retry when a replicate did
    not converge), then ``jack_bias`` and ``jack_var`` registered on `out`
    (reference connectivity_analysis.py:434-460). Coherence runs in
    float64 here, its direct estimate `out` included: at N = 1000 trials
    float32 coherence leaves ~1e-4 of rounding in the bias (N - 1) (mean -
    direct). `out` and both datasets are returned in float32 (complex64),
    as in the JAX package."""
    from ..statistics.jackknifing import bias_var
    from .AV_compRoutines import GrangerCausality

    if method == "coh":
        jack_rep = _normalize_cross_spectra(replicates, output, log_dict, keeptrials=True,
                                            double=True, parallel=parallel)
    else:
        av = GrangerCausality()
        jack_rep = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
        av.initialize(replicates, jack_rep._stackingDim)
        av.compute(replicates, jack_rep, log_dict=log_dict, parallel=parallel)
        if jack_rep.info.get("converged") is False and _GRANGER_HOST_FALLBACK:
            # pairing a good point estimate with a diverged replicate's
            # variance would attach unreliable error bars silently
            SPYWarning(
                "Wilson factorization did not converge on at least one jackknife "
                "replicate (max rel. err {:.2e}) — recomputing the replicates with the "
                "host float64 factorization.".format(
                    float(jack_rep.info.get("max rel. err", float("nan"))))
            )
            jack_rep = _granger_host_replicates(replicates, av)
    bias, variance = bias_var(out, jack_rep, parallel=parallel)
    single = np.complex64 if np.iscomplexobj(np.asarray(out.data)) else np.float32
    out.data = np.asarray(out.data).astype(single)
    out._register_dataset("jack_var", np.asarray(variance.data))
    out._register_dataset("jack_bias", np.asarray(bias.data).astype(single))


def _digest_channelcmb(data, channelcmb):
    """Validate [senders, receivers] and return index arrays
    (reference connectivity_analysis.py:335-381)."""
    if not isinstance(data, SpectralData):
        raise SPYTypeError(
            data, "data", expected="SpectralData, `channelcmb` not supported for other data types"
        )
    if not isinstance(channelcmb, list) or len(channelcmb) != 2:
        raise SPYValueError(
            legal="list with exactly two elements: [senders, receivers]",
            varname="channelcmb",
            actual=str(channelcmb),
        )
    if data.selection is not None and data.selection.channel not in (slice(None), slice(None, None, 1)):
        raise SPYValueError("either channel selection or use channelcmb", "select/channelcmb", "both")
    senders, receivers = channelcmb
    sequence_parser(senders, varname="channelcmb[senders,")
    cmb_type = type(senders[0])
    if cmb_type not in (str, int) and not np.issubdtype(cmb_type, np.integer):
        raise SPYTypeError(senders[0], "channelcmb[senders,", "either `int` or `str`")
    labels = [str(c) for c in np.asarray(data.channel)]

    def to_idx(seq):
        idx = []
        for chan in seq:
            if isinstance(chan, str):
                if chan not in labels:
                    raise SPYValueError("names or indices of existing channels", "channelcmb", str(chan))
                idx.append(labels.index(chan))
            else:
                ichan = int(chan)
                if ichan < 0 or ichan >= len(labels):
                    raise SPYValueError("names or indices of existing channels", "channelcmb", str(chan))
                idx.append(ichan)
        return np.asarray(idx, dtype=int)

    return to_idx(senders), to_idx(receivers)


def _setup_cross_spectra(data, method, nSamples, foi, foilim, tapsmofrq, nTaper, taper,
                         taper_opt, polyremoval, lenTrials, log_dict, cls):
    """Configure the implicit mtmfft+dyadic ST routine for AnalogData input
    (reference connectivity_analysis.py:775-872). `cls` picks the routine
    class (CrossSpectra or its fused-PPC subclass). Granger takes every
    frequency, demeaned tapers and the float64 CSD (exact_fft)."""
    foi, foilim = process_foi(foi, foilim, data.samplerate)
    if method == "granger":
        if foi is not None or foilim is not None:
            raise SPYValueError(
                legal="no foi specification for Granger analysis", varname="foi/foilim",
                actual="foi or foilim specification",
            )
        if len(data.channel) / len(lenTrials) > 0.1:
            SPYWarning(
                "Multi-channel Granger analysis can be numerically unstable, it is "
                "recommended to have at least 10 times the number of trials compared "
                "to the number of channels. Try calculating in sub-groups of fewer channels!"
            )
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

    return cls(
        samplerate=data.samplerate, nSamples=nSamples, taper=taper, taper_opt=taper_opt,
        demean_taper=(method == "granger"), polyremoval=polyremoval,
        freq_idx=freq_idx, foi=out_foi, exact_fft=(method == "granger"),
    )


def _compute_ppc(st_out, parallel=None):
    """PPC from the single-trial cross-spectra via the streamed resultant
    identity (replaces reference connectivity_analysis.py:624-667): the
    engine sums unit cross-spectra chunk-wise on the device, so host memory
    stays bounded by one chunk."""
    from .AV_compRoutines import PPCReduction

    out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    cr = PPCReduction()
    cr.initialize(st_out, out._stackingDim, keeptrials=False)
    n_trials = cr.numTrials
    cr.compute(st_out, out, log_dict={"method": "ppc", "nTrials": n_trials},
               post_device_fn=PPCReduction.make_post(n_trials), parallel=parallel)
    out._log = str(st_out._log)
    out.log = "computed pairwise phase consistency over {} trials".format(n_trials)
    return out


# ------------------------------------------------------------------------ #
# Granger
# ------------------------------------------------------------------------ #


def _granger_spectral_input_notes(data):
    """Granger from SpectralData: note time-resolved input (one
    factorization per window) and warn when the spectra's provenance
    shows a plain float32 FFT (reference connectivity_analysis.py:225-258)."""
    n_time = data.data.shape[data.dimord.index("time")]
    if n_time != len(data.trials):
        SPYInfo(
            "time-resolved Granger: factorizing one CSD per sliding window "
            "({} windows per trial)".format(n_time // max(len(data.trials), 1))
        )
    fa_cfg = data.cfg.get("freqanalysis", None)
    if fa_cfg is not None and not fa_cfg.get("exact_fft", False):
        SPYWarning(
            "Granger from precomputed float32 'fourier' spectra is numerically "
            "degraded: the accumulated CSD carries plain-f32 rounding, which biases "
            "the Granger estimate by O(1e-2) absolute even when the factorization "
            "converges (and can make it fail outright). Recompute the spectra with "
            "freqanalysis(..., exact_fft=True), or run "
            "connectivityanalysis(method='granger') directly on the raw AnalogData "
            "(the float64 CSD then applies automatically)."
        )


def _granger(st_out, st_compRoutine, nTrials, send_idx, rec_idx, data, log_dict, parallel=None):
    """The AV stage of Granger on the averaged CSD `st_out` (reference
    connectivity_analysis.py:276-277, :379-432, :466-476): pairwise with
    `channelcmb`; else the host float64 path if the rank gate finds the
    CSD singular by construction; else the device factorization (each
    window the one-sided iteration leaves unconverged retried two-sided on
    the device), retried on the host if both forms failed. Every host
    route warns."""
    from .AV_compRoutines import GrangerCausality

    av = GrangerCausality()
    if send_idx is not None:
        out = _granger_pairwise(st_out, send_idx, rec_idx, data, av)
    elif _granger_rank_deficient(st_compRoutine, nTrials, st_out):
        n_tap, n_chan = _granger_n_tapers(st_compRoutine), len(st_out.channel_i)
        SPYWarning(
            "Granger with {} trials x {} taper(s) on {} channels: the averaged CSD "
            "has rank {} < {} and is singular, so no device factorization is tried; "
            "using the host float64 path on the regularized matrix. Results depend "
            "on the regularization; use more trials/tapers or fewer "
            "channels.".format(nTrials, n_tap, n_chan, nTrials * n_tap, n_chan)
        )
        out = _granger_host_full(st_out, av)
    else:
        out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
        av.initialize(st_out, out._stackingDim)
        av.pre_check()
        av.compute(st_out, out, log_dict=log_dict, parallel=parallel)
        if out.info.get("converged") is False and _GRANGER_HOST_FALLBACK:
            SPYWarning(
                "device Wilson factorization did not converge (max rel. err {:.2e}) "
                "— retrying with the host float64 factorization.".format(
                    float(out.info.get("max rel. err", float("nan"))))
            )
            out = _granger_host_full(st_out, av)
    # non-convergence is a result-quality problem: say so
    if out.info.get("converged") is False:
        SPYWarning(
            "Wilson factorization did NOT converge (max rel. err {:.2e}); the Granger "
            "estimates are unreliable. Typical cause: input spectra from a plain "
            "float32 FFT (see the exact_fft note above); otherwise raise nIter or "
            "loosen rtol.".format(float(out.info.get("max rel. err", float("nan"))))
        )
    return out


def _granger_n_tapers(st_compRoutine):
    """Taper count of the ST stage (Kmax for dpss, else 1)."""
    t_opt = (getattr(st_compRoutine, "cfg", None) or {}).get("taper_opt")
    return int((t_opt or {}).get("Kmax", 1) or 1)


def _granger_rank_deficient(st_compRoutine, nTrials, st_out):
    """True when the trial-averaged CSD is singular by construction: each
    trial adds rank <= nTapers per frequency, so nTrials * nTapers <
    nChannels has no Wilson factorization."""
    return nTrials * _granger_n_tapers(st_compRoutine) < len(np.asarray(st_out.channel_i))


def _granger_out(st_avg, G, channel_i, channel_j, info, log):
    """The Granger CrossSpectralData of `G` ``(nTime, F, N_i, N_j)``."""
    out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    out.data = G
    out.samplerate = st_avg.samplerate
    out.trialdefinition = np.array([[0, float(G.shape[0]), 0]])
    out.channel_i = np.asarray(channel_i)
    out.channel_j = np.asarray(channel_j)
    out.freq = np.asarray(st_avg.freq)
    for key, value in info.items():
        out.info[key] = value
    out._log = str(st_avg._log)
    out.log = log
    return out


def _granger_host(csds, cfg):
    """The host float64 route of Granger on each ``(F, N, N)`` CSD of the
    iterable `csds`: regularization, Wilson, Eq. 8. Returns G ``(n, F, N,
    N)`` float32 and, one entry a CSD, ``converged``, ``max rel. err``,
    ``reg. factor`` and ``initial cond. num``."""
    from ..ops.connectivity import granger_host, regularize_csd_host, wilson_sf_host

    G, rows = [], []
    for csd in csds:
        CSDreg, factor, ini_cn = regularize_csd_host(csd, cond_max=cfg["cond_max"], eps_max=1e-1)
        H, Sigma, conv, err = wilson_sf_host(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
        G.append(granger_host(CSDreg, H, Sigma).astype(np.float32))
        rows.append((bool(conv), float(err), float(factor), float(ini_cn)))
    return (np.stack(G),) + tuple(zip(*rows))


@spanned("spt.granger.host")
def _granger_host_full(st_avg, av_routine):
    """Full-matrix Granger with the host float64 factorization, one per
    sliding window of time-resolved input."""
    csd_windows = np.asarray(st_avg.trials[0])  # (nTime, F, N, N)
    G, convs, errs, factors, ini_cns = _granger_host(csd_windows, av_routine.cfg)
    return _granger_out(st_avg, G, st_avg.channel_i, st_avg.channel_j, {
        "converged": all(convs), "max rel. err": max(errs),
        "reg. factor": max(factors), "initial cond. num": max(ini_cns),
    }, "computed Granger causality (host float64 factorization)")


@spanned("spt.granger.host")
def _granger_host_replicates(replicates, av_routine):
    """Host float64 Granger of every jackknife replicate: the retry when a
    device factorization of the leave-one-out CSDs did not converge
    (reference connectivity_analysis.py:759-789)."""
    # one (F, N, N) CSD a replicate
    csds = (np.asarray(replicates.trials[k])[0] for k in range(len(replicates.trials)))
    G, convs, errs, _, _ = _granger_host(csds, av_routine.cfg)
    n_rep = len(G)
    jack_rep = _granger_out(replicates, G, replicates.channel_i, replicates.channel_j, {
        "converged": bool(np.all(convs)), "max rel. err": float(np.max(errs)),
    }, "computed {} jackknife Granger replicates (host float64)".format(n_rep))
    trl = np.zeros((n_rep, 3))
    trl[:, 0] = np.arange(n_rep)
    trl[:, 1] = trl[:, 0] + 1
    jack_rep.trialdefinition = trl
    return jack_rep


def _granger_pairwise(st_avg, send_idx, rec_idx, data, av_routine):
    """
    Pairwise Granger over (senders x receivers): one batched
    regularization, Wilson factorization and Granger formula over the
    ``(nTime, P, F, 2, 2)`` pair CSDs of every window, each factorized as
    it would be alone (reference connectivity_analysis.py:792-840, which
    keeps only the first window of time-resolved input).
    """
    from ..engine.routine import default_device
    from ..ops.connectivity import granger, regularize_csd, wilson_sf

    cfg = av_routine.cfg
    csd_avg = np.asarray(st_avg.trials[0])  # (nTime, F, N, N)
    pairs = np.array([(s, r) for s in send_idx for r in rec_idx])  # (P, 2)
    sub = csd_avg[:, :, pairs[:, :, None], pairs[:, None, :]].transpose(0, 2, 1, 3, 4)
    CSD = torch.from_numpy(np.ascontiguousarray(sub)).to(default_device(), torch.complex128)
    CSDreg, _, _ = regularize_csd(CSD, cond_max=cfg["cond_max"], eps_max=1e-1)
    H, Sigma, conv, err, _ = wilson_sf(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
    G_pairs = granger(CSDreg, H, Sigma)[..., 0, 1].to(torch.float32).cpu().numpy()  # (T, P, F)
    G = G_pairs.reshape(len(csd_avg), len(send_idx), len(rec_idx), -1).transpose(0, 3, 1, 2)
    channel = np.asarray(data.channel)
    return _granger_out(st_avg, G, channel[send_idx], channel[rec_idx], {
        "converged": bool(conv.all()), "max rel. err": float(err.amax()),
    }, "computed pairwise Granger causality for {} pairs".format(len(pairs)))
