# -*- coding: utf-8 -*-
#
# freqanalysis: user-facing (time-)frequency analysis frontend.
#
# Port of syncopy_tpu/specest/freqanalysis.py (parity target: reference
# syncopy/specest/freqanalysis.py:62-1064). Methods: mtmfft, mtmconvol,
# wavelet, superlet, welch (+ FOOOF outputs). The routines run on the
# port's device (set_device); `parallel` resolves through
# parallel/mesh.py and shards the trials and channels over the mesh,
# `chan_per_worker` is accepted and ignored.

import numpy as np

from ..datatype.continuous_data import SpectralData
from ..shared.errors import SPYTypeError, SPYValueError, SPYWarning
from ..shared.input_processors import (
    check_effective_parameters,
    check_passed_kwargs,
    process_foi,
    process_padding,
    process_taper,
)
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.parsers import array_parser, data_parser, scalar_parser
from ..shared.tools import best_match, get_defaults, get_frontend_cfg

__all__ = ["freqanalysis"]

availableMethods = ("mtmfft", "mtmconvol", "wavelet", "superlet", "welch")
availableWavelets = ("Morlet", "Paul", "DOG", "Ricker", "Marr", "Mexican_hat")
availableOutputs = (
    "pow", "abs", "fourier", "real", "imag", "angle", "absreal", "absimag",
    "fooof", "fooof_aperiodic", "fooof_peaks",
)


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def freqanalysis(
    data,
    method="mtmfft",
    output="pow",
    keeptrials=True,
    foi=None,
    foilim=None,
    pad="maxperlen",
    polyremoval=0,
    taper="hann",
    demean_taper=False,
    taper_opt=None,
    tapsmofrq=None,
    nTaper=None,
    keeptapers=False,
    toi="all",
    t_ftimwin=None,
    wavelet="Morlet",
    width=6,
    order=None,
    order_max=None,
    order_min=1,
    c_1=3,
    adaptive=False,
    out=None,
    fooof_opt=None,
    ft_compat=False,
    exact_fft=False,
    parallel=None,
    chan_per_worker=None,
    **kwargs,
):
    """
    Perform (time-)frequency analysis of :class:`~syncopy_tpu_torch.AnalogData`.

    Methods: ``mtmfft`` ((multi-)tapered FFT), ``mtmconvol`` (sliding-window
    STFT), ``wavelet`` (CWT), ``superlet`` (adaptive superresolution
    wavelets), ``welch`` (overlapping-segment averaged periodogram).
    FieldTrip-compatible ``cfg``/``select`` conventions apply.

    Parameters
    ----------
    data : :class:`~syncopy_tpu_torch.AnalogData`
        Multi-channel time-series with trial definition.
    method : {"mtmfft", "mtmconvol", "wavelet", "superlet", "welch"}
        Spectral estimation method (see above).
    output : str
        Result transform of the complex spectrum: "pow" (squared
        magnitude), "abs", "fourier" (complex), "real", "imag", "angle",
        "absreal", "absimag", or the FOOOF flavours "fooof",
        "fooof_aperiodic", "fooof_peaks" (mtmfft + keeptrials=False only).
    keeptrials : bool
        If False, average spectra across trials on the device.
    foi : array_like or None
        Frequencies of interest in Hz; snapped to the available FFT bins
        (``mtmfft``/``mtmconvol``) or used exactly (wavelet/superlet scales).
    foilim : [fmin, fmax] or None
        Frequency window of interest (mutually exclusive with `foi`).
    pad : "maxperlen", "nextpow2", or float
        Trial padding policy: longest-trial length, next power of two, or
        an absolute length in seconds.
    polyremoval : {0, 1, None}
        Per-trial polynomial detrend before tapering: 0 = demean,
        1 = linear detrend, None = off.
    taper : str or None
        Window function ("hann", anything in :mod:`scipy.signal.windows`);
        multi-tapering (dpss) comes with `tapsmofrq`.
    demean_taper : bool
        Demean the tapered segments (Granger pipelines set this).
    taper_opt : dict or None
        Extra taper parameters, e.g. ``{"Kmax": 5, "NW": 3}`` for dpss.
    tapsmofrq : float or None
        Spectral smoothing box in Hz (dpss); sets NW/Kmax automatically.
    nTaper : int or None
        Explicit dpss taper count (only with `tapsmofrq`).
    keeptapers : bool
        Keep the taper axis instead of averaging.
    toi : "all", float in [0, 1], or array_like
        Times of interest for time-resolved methods: "all" = every sample,
        a fraction = window overlap, or explicit time points in seconds.
    t_ftimwin : float
        mtmconvol/welch sliding-window length in seconds.
    wavelet : {"Morlet", "Paul", "DOG", "Ricker", "Marr", "Mexican_hat"}
        Mother wavelet for ``method="wavelet"``.
    width : float
        Morlet width parameter (nondimensional frequency).
    order : int or None
        Paul/DOG wavelet order.
    order_max, order_min : int
        Superlet order range (adaptive superresolution span).
    c_1 : int
        Superlet base cycle count.
    adaptive : bool
        Superlets: scale the order with frequency (ASLT) instead of a
        fixed multiplicative set.
    out : :class:`~syncopy_tpu_torch.SpectralData` or None
        Pre-allocated (empty) output object (None = create new).
    fooof_opt : dict or None
        FOOOF fit options (peak_width_limits, max_n_peaks, ...).
    ft_compat : bool
        Mirror FieldTrip's spectral normalization conventions exactly.
    exact_fft : bool
        mtmfft: detrend, taper and FFT in float64, rounded to complex64 at
        the end (spectra for Granger; no limit on the trial length).
    parallel, chan_per_worker
        Resolved by parallel/mesh.py::resolve_parallel: the trials shard
        over the mesh's trial axis, the channels over its channel axis
        (`chan_per_worker` is accepted and ignored).

    Returns
    -------
    :class:`~syncopy_tpu_torch.SpectralData`
        Complex or real spectra with dimord ``["time", "taper", "freq",
        "channel"]`` and replayable ``cfg`` provenance.

    Reference: syncopy/specest/freqanalysis.py:62.
    """
    data_parser(data, varname="data", dataclass="AnalogData", empty=False)

    if method not in availableMethods:
        raise SPYValueError(legal=str(availableMethods), varname="method", actual=str(method))
    if output not in availableOutputs:
        raise SPYValueError(legal=str(availableOutputs), varname="output", actual=str(output))
    if not isinstance(keeptrials, bool):
        raise SPYTypeError(keeptrials, varname="keeptrials", expected="bool")
    if polyremoval is not None:
        scalar_parser(polyremoval, varname="polyremoval", ntype="int_like", lims=[0, 1])

    defaults = get_defaults(freqanalysis)
    lcls = dict(locals())
    check_passed_kwargs(lcls, defaults, frontend_name="freqanalysis")
    new_cfg = get_frontend_cfg(defaults, lcls, kwargs)

    # fooof outputs ride on mtmfft
    fooof_flavour = None
    if output.startswith("fooof"):
        if method != "mtmfft":
            raise SPYValueError(
                legal="method 'mtmfft' for FOOOF outputs", varname="method", actual=method
            )
        if keeptrials:
            raise SPYValueError(
                legal="keeptrials=False for FOOOF (fits require a trial-averaged "
                "spectrum)", varname="keeptrials", actual="True",
            )
        fooof_flavour = output
        output = "pow"

    # (selected) trial geometry (selector trialdefinition already carries
    # the post-selection per-trial lengths)
    if data.selection is not None:
        trl_def = data.selection.trialdefinition
    else:
        trl_def = data.trialdefinition
    lenTrials = (trl_def[:, 1] - trl_def[:, 0]).astype(int)
    if lenTrials.size == 0:
        raise SPYValueError(legal="at least one trial", varname="data")
    tStart = trl_def[:, 2] / data.samplerate
    tEnd = tStart + lenTrials / data.samplerate

    foi, foilim = process_foi(foi, foilim, data.samplerate)

    # -- method dispatch ------------------------------------------------- #

    if method == "mtmfft":
        nSamples = process_padding(pad, lenTrials, data.samplerate)
        taper, taper_opt = process_taper(
            taper, taper_opt, tapsmofrq, nTaper, keeptapers,
            foimax=data.samplerate / 2, samplerate=data.samplerate,
            nSamples=nSamples, output=output,
        )
        freqs = np.fft.rfftfreq(nSamples, 1.0 / data.samplerate)
        freq_idx = None
        if foi is not None:
            _, freq_idx = best_match(freqs, foi, squash_duplicates=True)
        elif foilim is not None:
            _, freq_idx = best_match(freqs, foilim, span=True)

        from .compRoutines import MultiTaperFFT

        check_effective_parameters(MultiTaperFFT, defaults, lcls)
        specestMethod = MultiTaperFFT(
            samplerate=data.samplerate,
            nfft=nSamples,
            taper=taper,
            taper_opt=taper_opt,
            demean_taper=demean_taper,
            output=output,
            keeptapers=keeptapers,
            polyremoval=polyremoval,
            freq_idx=freq_idx,
            ft_compat=ft_compat,
            exact_fft=exact_fft,
        )
        log_dict = {"method": method, "output": output, "taper": taper,
                    "tapsmofrq": tapsmofrq, "pad": pad}

    elif method in ("mtmconvol", "welch"):
        if method == "welch" and output != "pow":
            raise SPYValueError(
                legal="'pow', Welch estimates are real-valued power averages",
                varname="output", actual=output,
            )
        if t_ftimwin is None:
            raise SPYValueError(
                legal="window length `t_ftimwin` (in seconds)", varname="t_ftimwin",
                actual="None",
            )
        scalar_parser(
            t_ftimwin, varname="t_ftimwin",
            lims=[1 / data.samplerate, lenTrials.min() / data.samplerate],
        )
        nperseg = int(t_ftimwin * data.samplerate)

        if method == "welch":
            # Welch averages segments and tapers by construction (reference
            # test_welch.py:391-415 rejects conflicting settings outright)
            if keeptapers:
                raise SPYValueError(
                    legal="keeptapers=False: Welch averages tapers by definition",
                    varname="keeptapers", actual="True",
                )
            if isinstance(toi, (str, list, np.ndarray)):
                raise SPYValueError(
                    legal="a scalar overlap fraction in [0, 1) for `toi`",
                    varname="toi", actual=str(toi),
                )

        toi = _process_toi(toi, method, tStart, tEnd, data.samplerate)

        taper, taper_opt = process_taper(
            taper, taper_opt, tapsmofrq, nTaper, keeptapers,
            foimax=data.samplerate / 2, samplerate=data.samplerate,
            nSamples=nperseg, output=output,
        )
        freqs = np.fft.rfftfreq(nperseg, 1.0 / data.samplerate)
        freq_idx = None
        out_foi = freqs
        if foi is not None:
            _, freq_idx = best_match(freqs, foi, squash_duplicates=True)
            out_foi = freqs[freq_idx]
        elif foilim is not None:
            _, freq_idx = best_match(freqs, foilim, span=True)
            out_foi = freqs[freq_idx]

        from .compRoutines import MultiTaperFFTConvol

        check_effective_parameters(MultiTaperFFTConvol, defaults, lcls)
        specestMethod = MultiTaperFFTConvol(
            samplerate=data.samplerate,
            nperseg=nperseg,
            toi=toi,
            taper=taper,
            taper_opt=taper_opt,
            output=output,
            keeptapers=keeptapers,
            polyremoval=polyremoval,
            freq_idx=freq_idx,
            foi=out_foi,
            time_average=(method == "welch"),
        )
        log_dict = {"method": method, "output": output, "taper": taper,
                    "t_ftimwin": t_ftimwin, "toi": toi if not isinstance(toi, np.ndarray) else "array"}

    elif method == "wavelet":
        from ..ops.wavelet import DOG, Morlet, Paul, Ricker, get_optimal_wavelet_scales

        if wavelet not in availableWavelets:
            raise SPYValueError(legal=str(availableWavelets), varname="wavelet", actual=str(wavelet))
        if wavelet == "Morlet":
            scalar_parser(width, varname="width", lims=[1, np.inf])
            wfun = Morlet(width)
        elif wavelet == "Paul":
            wfun = Paul(int(order) if order is not None else 4)
        elif wavelet == "DOG":
            wfun = DOG(int(order) if order is not None else 2)
        else:
            # "Ricker" / "Marr" / "Mexican_hat" all name the 2nd-order DOG
            # (reference freqanalysis.py:55,280)
            wfun = Ricker()
            if output not in ("abs", "real", "pow"):
                SPYWarning("Ricker wavelet is real-valued; consider output='real'")

        toi = _process_toi(toi, method, tStart, tEnd, data.samplerate, allow_percent=False)

        if foi is None and foilim is not None:
            foi = np.arange(foilim[0], foilim[1] + 1)
        if foi is not None:
            scales = wfun.scale_from_period(1.0 / foi)
            out_foi = np.asarray(foi, dtype=float)
        else:
            scales = get_optimal_wavelet_scales(
                wfun.scale_from_period, int(lenTrials.min()), 1.0 / data.samplerate
            )
            out_foi = 1.0 / wfun.fourier_period(scales)

        from .compRoutines import WaveletTransform

        check_effective_parameters(WaveletTransform, defaults, lcls)
        specestMethod = WaveletTransform(
            samplerate=data.samplerate,
            scales=scales,
            wavelet=wfun,
            toi=toi,
            output=output,
            polyremoval=polyremoval,
            foi=out_foi,
        )
        log_dict = {"method": method, "output": output, "wavelet": wavelet, "width": width}

    else:  # superlet
        from ..ops.wavelet import MorletSL, get_optimal_wavelet_scales

        if order_max is None:
            raise SPYValueError(
                legal="`order_max` (maximal superlet order)", varname="order_max", actual="None"
            )
        scalar_parser(order_max, varname="order_max", ntype="int_like", lims=[1, np.inf])
        scalar_parser(order_min, varname="order_min", ntype="int_like", lims=[1, order_max])
        scalar_parser(c_1, varname="c_1", ntype="int_like", lims=[1, np.inf])

        toi = _process_toi(toi, method, tStart, tEnd, data.samplerate, allow_percent=False)

        if foi is None and foilim is not None:
            foi = np.arange(foilim[0], foilim[1] + 1)
        if foi is not None:
            scales = MorletSL.scale_from_period(1.0 / np.asarray(foi, dtype=float))
            out_foi = np.asarray(foi, dtype=float)
        else:
            scales = get_optimal_wavelet_scales(
                MorletSL.scale_from_period, int(lenTrials.min()), 1.0 / data.samplerate
            )
            out_foi = 1.0 / MorletSL.fourier_period(scales)
        # adaptive SLT needs scales ordered high -> low (foi low -> high)
        if adaptive and scales.size > 1 and np.any(np.diff(scales) > 0):
            sorter = np.argsort(scales)[::-1]
            scales = scales[sorter]
            out_foi = np.asarray(out_foi)[sorter]

        from .compRoutines import SuperletTransform

        check_effective_parameters(SuperletTransform, defaults, lcls)
        specestMethod = SuperletTransform(
            samplerate=data.samplerate,
            scales=scales,
            order_max=order_max,
            order_min=order_min,
            c_1=c_1,
            adaptive=adaptive,
            toi=toi,
            output=output,
            polyremoval=polyremoval,
            foi=out_foi,
        )
        log_dict = {"method": method, "output": output, "order_max": order_max,
                    "adaptive": adaptive}

    # -- execution ------------------------------------------------------- #

    if out is not None:
        data_parser(out, varname="out", dataclass="SpectralData", empty=True)
    else:
        out = SpectralData(dimord=SpectralData._defaultDimord)

    specestMethod.initialize(data, out._stackingDim, keeptrials=keeptrials)
    specestMethod.compute(data, out, log_dict=log_dict, parallel=parallel)

    if fooof_flavour is not None:
        from .fooof_route import run_fooof

        out = run_fooof(out, fooof_flavour, fooof_opt)

    # chained provenance: carry the input's cfg, then our own
    out.cfg.update(data.cfg)
    out.cfg.update({"freqanalysis": new_cfg})
    return out


def _process_toi(toi, method, tStart, tEnd, samplerate, allow_percent=True):
    """Digest the `toi` argument (reference freqanalysis.py:674-790)."""
    if isinstance(toi, str):
        if toi != "all":
            raise SPYValueError(legal="'all', scalar or array", varname="toi", actual=toi)
        if method == "welch":
            raise SPYValueError(
                legal="toi to be a float in range [0, 1] for method='welch'",
                varname="toi", actual=toi,
            )
        return "all"
    if np.issubdtype(type(toi), np.number):
        if not allow_percent:
            raise SPYValueError(
                legal="'all' or array of time-points for this method", varname="toi", actual=str(toi)
            )
        scalar_parser(toi, varname="toi", lims=[0, 1])
        return float(toi)
    if method == "welch":
        raise SPYValueError(
            legal="toi to be a float in range [0, 1] for method='welch'",
            varname="toi", actual=str(toi),
        )
    array_parser(
        toi, varname="toi", hasinf=False, hasnan=False,
        lims=[tStart.min(), tEnd.max()], dims=(None,),
    )
    toi = np.asarray(toi, dtype=float)
    if np.any(np.diff(toi) < 0):
        raise SPYValueError(legal="ordered list/array of time-points", varname="toi", actual="unsorted")
    return toi
