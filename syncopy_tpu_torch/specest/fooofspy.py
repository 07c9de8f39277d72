# -*- coding: utf-8 -*-
#
# FOOOF-style spectral parametrization: aperiodic (1/f) + gaussian peaks.
#
# Port of syncopy_tpu/specest/fooofspy.py (numpy and scipy only, copied;
# parity target: reference syncopy/specest/fooofspy.py:27, which wraps the
# `fooof` package). Since the upstream package is an optional dependency,
# the fitting algorithm of Donoghue et al. 2020 (Nat Neurosci 23:1655) is
# implemented here directly: robust aperiodic fit in log-log space,
# iterative gaussian peak extraction on the flattened spectrum, joint
# refit, and a final aperiodic refit on the peak-removed spectrum.
#
# The fit runs on the host (scipy curve_fit per channel), as in the
# reference: its input is one trial-averaged spectrum of a few hundred
# bins per channel, read back from the device once, and the
# Levenberg-Marquardt iterations have data-dependent trip counts.

import numpy as np
from scipy.optimize import curve_fit

__all__ = ["fooofspy"]

default_fooof_opt = {
    "peak_width_limits": (0.5, 12.0),
    "max_n_peaks": np.inf,
    "min_peak_height": 0.0,
    "peak_threshold": 2.0,
    "aperiodic_mode": "fixed",
}


def _aperiodic(freqs, *params):
    if len(params) == 2:  # fixed: offset, exponent
        offset, exponent = params
        return offset - exponent * np.log10(freqs)
    offset, knee, exponent = params  # knee
    return offset - np.log10(knee + freqs**exponent)


def _gaussian_model(freqs, *params):
    out = np.zeros_like(freqs)
    for k in range(0, len(params), 3):
        ctr, hgt, wid = params[k : k + 3]
        out = out + hgt * np.exp(-((freqs - ctr) ** 2) / (2 * wid**2))
    return out


def _fit_aperiodic(freqs, log_power, mode):
    guess = (log_power[0], 1.0) if mode == "fixed" else (log_power[0], 1.0, 1.0)
    try:
        popt, _ = curve_fit(_aperiodic, freqs, log_power, p0=guess, maxfev=5000)
    except RuntimeError:
        popt = np.asarray(guess)
    return np.asarray(popt)


def _robust_aperiodic(freqs, log_power, mode):
    popt = _fit_aperiodic(freqs, log_power, mode)
    # refit on the points close to the initial fit (drop peak regions)
    resid = log_power - _aperiodic(freqs, *popt)
    thresh = np.percentile(resid, 2.5)
    mask = resid <= np.percentile(resid, 97.5)
    mask &= resid >= thresh - 10  # keep lower envelope
    if mask.sum() > max(3, len(popt)):
        try:
            popt, _ = curve_fit(_aperiodic, freqs[mask], log_power[mask], p0=popt, maxfev=5000)
        except RuntimeError:
            pass
    return np.asarray(popt)


def fooofspy(data_arr, in_freqs, freq_range=None, fooof_opt=None, out_type="fooof"):
    """
    Parameterize power spectra into aperiodic + periodic components.

    Parameters
    ----------
    data_arr : (nFreq, nChannels) ndarray — linear power spectra
    in_freqs : (nFreq,) frequencies
    freq_range : optional [lo, hi] fit range
    fooof_opt : dict with keys of `default_fooof_opt`
    out_type : {'fooof', 'fooof_aperiodic', 'fooof_peaks'}

    Returns
    -------
    spectra : (nFreq, nChannels) modeled spectra (linear scale)
    details : dict with per-channel aperiodic_params, peak_params (list of
        [center, height, width]), r_squared, error, n_peaks
    """
    if in_freqs is None:
        raise ValueError("input frequencies are required and must not be None")
    valid_out_types = ("fooof", "fooof_aperiodic", "fooof_peaks")
    if out_type not in valid_out_types:
        raise ValueError(
            "out_type must be one of {}, got '{}'".format(valid_out_types, out_type)
        )
    opt = dict(default_fooof_opt)
    if fooof_opt:
        unknown = set(fooof_opt) - set(default_fooof_opt)
        if unknown:
            raise ValueError(
                "invalid fooof_opt entries: {} (accepted keys: {})".format(
                    sorted(unknown), sorted(default_fooof_opt)
                )
            )
        opt.update(fooof_opt)

    freqs = np.asarray(in_freqs, dtype=float)
    data_arr = np.atleast_2d(np.asarray(data_arr, dtype=float))
    if data_arr.shape[0] != freqs.size:
        data_arr = data_arr.T
    if data_arr.shape[0] != freqs.size:
        raise ValueError(
            "signal length {} must match the number of frequency labels {}".format(
                data_arr.shape[0] if data_arr.shape[0] != freqs.size else data_arr.shape[1],
                freqs.size,
            )
        )
    mask = freqs > 0
    if freq_range is not None:
        mask &= (freqs >= freq_range[0]) & (freqs <= freq_range[1])
    f = freqs[mask]

    n_chan = data_arr.shape[1]
    out = np.zeros((freqs.size, n_chan))
    details = {
        "aperiodic_params": [], "gaussian_params": [], "peak_params": [],
        "n_peaks": [], "r_squared": [], "error": [],
        # reference parity (syncopy/specest/fooofspy.py:27-200): the
        # effective settings travel with the results so frontends/users can
        # replay the fit
        "settings_used": {
            "out_type": out_type,
            "freq_range": list(freq_range) if freq_range is not None else None,
            "fooof_opt": {
                k: (list(v) if isinstance(v, tuple) else v) for k, v in opt.items()
            },
        },
    }

    for ch in range(n_chan):
        log_pow = np.log10(np.maximum(data_arr[mask, ch], 1e-20))
        ap = _robust_aperiodic(f, log_pow, opt["aperiodic_mode"])
        flat = log_pow - _aperiodic(f, *ap)

        # iterative peak search
        peaks = []
        work = flat.copy()
        while len(peaks) < opt["max_n_peaks"]:
            idx = int(np.argmax(work))
            height = work[idx]
            if height <= opt["peak_threshold"] * np.std(work):
                break
            if height < opt["min_peak_height"]:
                break
            ctr = f[idx]
            # half-height width estimate
            half = height / 2
            lo = idx
            while lo > 0 and work[lo] > half:
                lo -= 1
            hi = idx
            while hi < len(work) - 1 and work[hi] > half:
                hi += 1
            fwhm = max(f[hi] - f[lo], np.diff(f).min())
            wid = np.clip(fwhm / 2.355, opt["peak_width_limits"][0], opt["peak_width_limits"][1])
            peaks.append([ctr, height, wid])
            work = work - _gaussian_model(f, ctr, height, wid)

        # joint gaussian refit on the flattened spectrum
        if peaks:
            p0 = np.ravel(peaks)
            lo_b, hi_b = [], []
            for ctr, hgt, wid in peaks:
                lo_b += [f[0], 0.0, opt["peak_width_limits"][0] / 2]
                hi_b += [f[-1], np.inf, opt["peak_width_limits"][1] * 2]
            try:
                p_fit, _ = curve_fit(
                    _gaussian_model, f, flat, p0=p0, bounds=(lo_b, hi_b), maxfev=5000
                )
                peaks = [list(p_fit[k : k + 3]) for k in range(0, len(p_fit), 3)]
            except (RuntimeError, ValueError):
                pass

        peak_log = _gaussian_model(f, *np.ravel(peaks)) if peaks else np.zeros_like(f)
        # final aperiodic refit on peak-removed spectrum
        ap = _fit_aperiodic(f, log_pow - peak_log, opt["aperiodic_mode"])
        ap_log = _aperiodic(f, *ap)
        model_log = ap_log + peak_log

        ss_res = np.sum((log_pow - model_log) ** 2)
        ss_tot = np.sum((log_pow - log_pow.mean()) ** 2)
        r2 = 1 - ss_res / ss_tot if ss_tot > 0 else 1.0
        mae = np.mean(np.abs(log_pow - model_log))

        if out_type == "fooof":
            model = 10**model_log
        elif out_type == "fooof_aperiodic":
            model = 10**ap_log
        else:  # fooof_peaks
            model = 10**peak_log

        col = np.zeros(freqs.size)
        col[mask] = model
        out[:, ch] = col
        details["aperiodic_params"].append([float(x) for x in ap])
        # gaussian_params: the raw gaussian parameters [CF, height, sigma];
        # peak_params: the fooof convention [CF, PW, BW] with PW the full
        # peak model's height over the aperiodic fit AT the center
        # frequency (overlapping gaussians stack) and BW = 2*sigma
        # (reference fooof semantics, syncopy tests access both)
        details["gaussian_params"].append([[float(x) for x in p] for p in peaks])
        pk = []
        for ctr, hgt, wid in peaks:
            pw = float(_gaussian_model(np.asarray([ctr]), *np.ravel(peaks))[0])
            pk.append([float(ctr), pw, float(2 * wid)])
        details["peak_params"].append(pk)
        details["n_peaks"].append(len(peaks))
        details["r_squared"].append(float(r2))
        details["error"].append(float(mae))

    return out, details
