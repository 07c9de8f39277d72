# -*- coding: utf-8 -*-
#
# Plotting dispatch: singlepanelplot / multipanelplot.
#
# Parity target: reference syncopy/plotting/spy_plotting.py:13-53 +
# sp_plotting.py / mp_plotting.py / spike_plotting.py per-class plotters.

import numpy as np

from ..shared.errors import SPYError, SPYWarning
from . import _plotting as _plt

__all__ = ["singlepanelplot", "multipanelplot"]


def singlepanelplot(data, **show_kwargs):
    """
    Plot (selected) data in a single panel: line plots for AnalogData /
    1d spectra / cross-spectra, images for time-frequency spectra, raster
    plots for SpikeData (reference spy_plotting.py:13).
    Returns (fig, ax).
    """
    plotter = _get_plotter(data, single=True)
    return plotter(data, **show_kwargs)


def multipanelplot(data, **show_kwargs):
    """One panel per channel (reference spy_plotting.py:53).
    Returns (fig, axs)."""
    plotter = _get_plotter(data, single=False)
    return plotter(data, **show_kwargs)


def _get_plotter(data, single):
    name = data.__class__.__name__
    table = {
        ("AnalogData", True): plot_analog_single,
        ("AnalogData", False): plot_analog_multi,
        ("TimeLockData", True): plot_analog_single,
        ("TimeLockData", False): plot_analog_multi,
        ("SpectralData", True): plot_spectral_single,
        ("SpectralData", False): plot_spectral_multi,
        ("CrossSpectralData", True): plot_crossspectral_single,
        ("CrossSpectralData", False): plot_crossspectral_single,
        ("SpikeData", True): plot_spike_single,
        ("SpikeData", False): plot_spike_multi,
    }
    plotter = table.get((name, single))
    if plotter is None:
        raise SPYError("Plotting not supported for {}".format(name))
    return plotter


def _select_show(data, show_kwargs):
    """Apply selection kwargs transiently and return (array, sel)."""
    trials = show_kwargs.pop("trials", None)
    if trials is None and len(data.trials) > 1:
        SPYWarning("Plotting only the first trial; use `trials=` to select")
        trials = 0
    arr = data.show(squeeze=False, trials=trials, **show_kwargs)
    if isinstance(arr, list):
        arr = arr[0]
    return arr


def _reuse_or_new(ax, maker, **kwargs):
    """ax-reuse/overlay support (reference sp_plotting ax handling): draw
    into a caller-provided axes instead of a fresh figure."""
    if ax is not None:
        return ax.figure, ax
    return maker(**kwargs)


def plot_analog_single(data, shifted=True, ax=None, **show_kwargs):
    arr = _select_show(data, dict(show_kwargs))
    fig, ax = _reuse_or_new(ax, _plt.mk_line_figax)
    time = np.arange(arr.shape[0]) / data.samplerate
    chan_sel = show_kwargs.get("channel")
    labels = _channel_labels(data, chan_sel)
    _plt.plot_lines(ax, time, arr.reshape(arr.shape[0], -1), shifted=shifted, label=labels)
    fig.tight_layout()
    return fig, ax


def plot_analog_multi(data, **show_kwargs):
    arr = _select_show(data, dict(show_kwargs))
    arr = arr.reshape(arr.shape[0], -1)
    nrows, ncols = _calc_layout(arr.shape[1])
    fig, axs = _plt.mk_multi_line_figax(nrows, ncols)
    time = np.arange(arr.shape[0]) / data.samplerate
    labels = _channel_labels(data, show_kwargs.get("channel"))
    for k, ax in enumerate(axs.flatten()):
        if k < arr.shape[1]:
            ax.plot(time, arr[:, k])
            ax.set_title(labels[k] if k < len(labels) else "", fontsize=_plt.pltConfig["mTitleSize"])
        else:
            ax.axis("off")
    fig.tight_layout()
    return fig, axs


def _is_time_freq(data):
    return data.data.shape[data.dimord.index("time")] > len(data.trials)


def _tf_fetch(data, show_kwargs):
    """TF image array for plotting. Fast path: a device-resident TFR is
    sliced and box-averaged down to the plot resolution
    (pltConfig["maxPlotTime"] columns) on the device before the readback,
    which then carries only the view; otherwise the trial is read through
    :func:`show` from the host payload. Returns ``(array,
    decimation_factor)``."""
    max_time = _plt.pltConfig["maxPlotTime"]
    trials = show_kwargs.pop("trials", None)
    if trials is None and len(data.trials) > 1:
        SPYWarning("Plotting only the first trial; use `trials=` to select")
        trials = 0
    res = getattr(data, "_device_resident", None)
    scalar_trial = trials is None or (
        np.isscalar(trials) and np.issubdtype(type(trials), np.number))
    if (res is not None and res.consumable_by(data) and data.selection is None
            and not show_kwargs and max_time and scalar_trial):
        pos = 0 if trials is None else int(trials)
        if 0 <= pos < len(data.trials):
            return res.fetch_trial_view(pos, max_time=max_time)
    arr = data.show(squeeze=False, trials=trials, **show_kwargs)
    if isinstance(arr, list):
        arr = arr[0]
    if np.iscomplexobj(arr):
        arr = np.abs(arr)
    return arr, 1


def _tf_time_axis(data, n_rows, factor, latency=None):
    """Plot time axis honoring decimation and irregular (uneven toi) axes.
    A `latency` show-kwarg subsets the irregular points BEFORE the prefix
    slice (the data rows were subset the same way)."""
    irr = getattr(data, "irregular_time", None)
    if irr is not None:
        pts = np.asarray(irr, dtype=float)
        if isinstance(latency, str) and latency != "all":
            # shorthand ('maxperiod'/'minperiod'/'prestim'/'poststim'):
            # resolve to the numeric window the selector used
            from ..shared.latency import get_analysis_window

            latency = get_analysis_window(data, latency)
        if latency is not None and not isinstance(latency, str):
            lat = np.asarray(latency, dtype=float)
            pts = pts[(pts >= lat[0]) & (pts <= lat[1])]
        if factor > 1:
            t_out = len(pts) // factor
            pts = pts[: t_out * factor].reshape(t_out, factor).mean(axis=1)
        return pts[:n_rows]
    return (np.arange(n_rows) * factor + (factor - 1) / 2.0) / data.samplerate


def plot_spectral_single(data, logscale=True, ax=None, **show_kwargs):
    if _is_time_freq(data):
        kwargs = dict(show_kwargs)
        arr, factor = _tf_fetch(data, kwargs)
        arr = arr.mean(axis=1) if arr.ndim == 4 else arr  # average tapers
        fig, ax = _reuse_or_new(ax, _plt.mk_img_figax)
        time = _tf_time_axis(data, arr.shape[0], factor,
                             latency=show_kwargs.get("latency"))
        spec = arr.reshape(arr.shape[0], len(data.freq), -1)[:, :, 0]
        _plt.plot_tfreq(ax, spec.T, time, data.freq)
        labels = _channel_labels(data, show_kwargs.get("channel"))
        if labels:
            ax.set_title(str(labels[0]), fontsize=_plt.pltConfig["sTitleSize"])
        fig.tight_layout()
        return fig, ax
    arr = _select_show(data, dict(show_kwargs))
    arr = np.abs(arr)
    arr = arr.mean(axis=1) if arr.ndim == 4 else arr
    arr = arr.reshape(-1, len(data.freq), arr.shape[-1])[0]
    fig, ax = _reuse_or_new(ax, _plt.mk_line_figax, xlabel="frequency (Hz)", ylabel="power")
    if logscale:
        ax.set_yscale("log")
    labels = _channel_labels(data, show_kwargs.get("channel"))
    _plt.plot_lines(ax, np.asarray(data.freq), arr, label=labels)
    fig.tight_layout()
    return fig, ax


def plot_spectral_multi(data, logscale=True, **show_kwargs):
    labels = _channel_labels(data, show_kwargs.get("channel"))
    if _is_time_freq(data):
        # one time-frequency image per channel, shared color scale
        # (reference mp_plotting.py:90-152)
        arr, factor = _tf_fetch(data, dict(show_kwargs))
        arr = arr.mean(axis=1) if arr.ndim == 4 else arr  # average tapers
        arr = arr.reshape(arr.shape[0], len(data.freq), -1)  # (T, F, C)
        n_chan = arr.shape[-1]
        nrows, ncols = _calc_layout(n_chan)
        fig, axs = _plt.mk_multi_img_figax(nrows, ncols)
        time = _tf_time_axis(data, arr.shape[0], factor,
                             latency=show_kwargs.get("latency"))
        vmax = float(np.abs(arr).max())
        for k, ax in enumerate(axs.flatten()):
            if k < n_chan:
                _plt.plot_tfreq(ax, np.abs(arr[:, :, k]).T, time, data.freq, vmax=vmax)
                ax.set_title(labels[k] if k < len(labels) else "",
                             fontsize=_plt.pltConfig["mTitleSize"])
            else:
                ax.axis("off")
        fig.tight_layout()
        fig.subplots_adjust(wspace=0.05)
        return fig, axs
    arr = _select_show(data, dict(show_kwargs))
    arr = np.abs(arr)
    arr = arr.mean(axis=1) if arr.ndim == 4 else arr
    arr = arr.reshape(-1, len(data.freq), arr.shape[-1])[0]
    nrows, ncols = _calc_layout(arr.shape[-1])
    fig, axs = _plt.mk_multi_line_figax(nrows, ncols, xlabel="frequency (Hz)", ylabel="power")
    for k, ax in enumerate(axs.flatten()):
        if k < arr.shape[-1]:
            ax.plot(np.asarray(data.freq), arr[:, k])
            if logscale:
                ax.set_yscale("log")
            ax.set_title(labels[k] if k < len(labels) else "", fontsize=_plt.pltConfig["mTitleSize"])
        else:
            ax.axis("off")
    fig.tight_layout()
    return fig, axs


def plot_crossspectral_single(data, **show_kwargs):
    ch_i = show_kwargs.pop("channel_i", 0)
    ch_j = show_kwargs.pop("channel_j", 1 if len(data.channel_j) > 1 else 0)
    arr = data.show(squeeze=False, channel_i=ch_i, channel_j=ch_j, **show_kwargs)
    if isinstance(arr, list):
        arr = arr[0]
    arr = np.abs(arr).reshape(arr.shape[0], arr.shape[1])
    is_lag = data.freq is None or len(np.atleast_1d(data.freq)) == 1
    if arr.shape[0] > 1 and arr.shape[1] <= 1:
        # cross-correlation: time axis = lags
        fig, ax = _plt.mk_line_figax(xlabel="lag (s)", ylabel="corr")
        lags = np.arange(arr.shape[0]) / data.samplerate
        _plt.plot_lines(ax, lags, arr[:, 0])
    else:
        fig, ax = _plt.mk_line_figax(xlabel="frequency (Hz)", ylabel="connectivity")
        _plt.plot_lines(ax, np.asarray(data.freq), arr[0] if arr.shape[0] == 1 else arr.mean(axis=0))
    fig.tight_layout()
    return fig, ax


def _spike_axis_labels(data, on_yaxis):
    if on_yaxis == "unit":
        return [str(u) for u in np.asarray(data.unit)]
    if on_yaxis == "channel":
        return [str(c) for c in np.asarray(data.channel)]
    return None


def _raster_one_trial(ax, data, arr, on_yaxis):
    """Scatter one trial's spikes with `on_yaxis` ('unit' or 'channel')
    grouping the y coordinate (reference spike_plotting.py:21-84)."""
    scol = data.dimord.index("sample")
    ycol = data.dimord.index(on_yaxis)
    times = arr[:, scol] / data.samplerate
    ax.scatter(times, arr[:, ycol], s=4, marker="|")


def plot_spike_single(data, on_yaxis="unit", ax=None, **show_kwargs):
    """
    Spike raster with `on_yaxis` in {'unit', 'channel', 'trials'}
    (reference spike_plotting.py:21-84): 'unit'/'channel' rasterize one
    trial grouped by that id; 'trials' rasterizes ONE unit across trials
    (select it via ``unit=``).
    """
    if on_yaxis not in ("unit", "channel", "trials"):
        raise SPYError("on_yaxis must be 'unit', 'channel' or 'trials'")
    trials = show_kwargs.pop("trials", None)

    if on_yaxis == "trials":
        arrs = data.show(squeeze=False, trials=trials, **show_kwargs)
        if not isinstance(arrs, list):
            arrs = [arrs]
        ucol = data.dimord.index("unit")
        units = np.unique(np.concatenate([a[:, ucol] for a in arrs if len(a)]))
        if units.size != 1:
            raise SPYError("Please select a single unit for on_yaxis='trials'")
        fig, ax = _reuse_or_new(ax, _plt.mk_line_figax, xlabel="time (s)", ylabel="trials")
        scol = data.dimord.index("sample")
        for k, a in enumerate(arrs):
            ax.scatter(a[:, scol] / data.samplerate, np.full(len(a), k), s=4, marker="|")
        labels = ["trial" + str(k) for k in range(len(arrs))]
        ax.set_title(str(np.asarray(data.unit)[int(units[0])]))
    else:
        if trials is None and len(data.trials) > 1:
            SPYWarning("Plotting only the first trial; use `trials=` to select")
            trials = 0
        arr = data.show(squeeze=False, trials=trials, **show_kwargs)
        if isinstance(arr, list):
            arr = arr[0]
        fig, ax = _reuse_or_new(ax, _plt.mk_line_figax, xlabel="time (s)", ylabel=on_yaxis)
        _raster_one_trial(ax, data, arr, on_yaxis)
        labels = _spike_axis_labels(data, on_yaxis)
    if labels is not None and len(labels) <= 25:
        ax.set_yticks(np.arange(len(labels)), labels)
        ax.set_ylabel("")
    fig.tight_layout()
    return fig, ax


def plot_spike_multi(data, on_yaxis="unit", **show_kwargs):
    """One raster panel per trial (max 25), spikes grouped by `on_yaxis`
    (reference spike_plotting.py:87-180)."""
    if on_yaxis not in ("unit", "channel"):
        raise SPYError("on_yaxis must be 'unit' or 'channel' for multipanel rasters")
    trials = show_kwargs.pop("trials", None)
    arrs = data.show(squeeze=False, trials=trials, **show_kwargs)
    if not isinstance(arrs, list):
        arrs = [arrs]
    if len(arrs) > 25:
        raise SPYError("Please select at most 25 trials for multipanel rasters")
    nrows, ncols = _calc_layout(len(arrs))
    fig, axs = _plt.mk_multi_line_figax(nrows, ncols, xlabel="time (s)", ylabel=on_yaxis)
    labels = _spike_axis_labels(data, on_yaxis)
    for k, ax in enumerate(axs.flatten()):
        if k < len(arrs):
            _raster_one_trial(ax, data, arrs[k], on_yaxis)
            ax.set_title("trial" + str(k), fontsize=_plt.pltConfig["mTitleSize"])
            if labels is not None and len(labels) <= 25:
                ax.set_yticks(np.arange(len(labels)), labels)
        else:
            ax.axis("off")
    fig.tight_layout()
    return fig, axs


def _channel_labels(data, chan_sel):
    try:
        labels = np.asarray(data.channel)
    except Exception:
        return []
    if chan_sel is None:
        return list(labels)
    idx = np.atleast_1d(chan_sel)
    out = []
    for c in idx:
        if isinstance(c, str):
            out.append(c)
        else:
            out.append(labels[int(c)])
    return out


def _calc_layout(nAx):
    ncols = int(np.ceil(np.sqrt(nAx)))
    nrows = int(np.ceil(nAx / ncols))
    return nrows, ncols
