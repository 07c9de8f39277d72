# -*- coding: utf-8 -*-
#
# Low-level figure helpers (parity: reference syncopy/plotting/_plotting.py:24-173).

import numpy as np

from ..shared.errors import SPYError
from .config import apply_style, pltConfig  # noqa: F401  (pltConfig re-export)


def _import_plt():
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        apply_style(matplotlib)
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        raise SPYError("Plotting requires the optional dependency 'matplotlib'")


def mk_line_figax(xlabel="time (s)", ylabel="signal (a.u.)"):
    plt = _import_plt()
    fig, ax = plt.subplots(1, 1, figsize=pltConfig["sFigSize"])
    ax.tick_params(axis="both", which="major", labelsize=pltConfig["sTickSize"])
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    ax.set_xlabel(xlabel, fontsize=pltConfig["sLabelSize"])
    ax.set_ylabel(ylabel, fontsize=pltConfig["sLabelSize"])
    return fig, ax


def mk_multi_line_figax(nrows, ncols, xlabel="time (s)", ylabel="signal (a.u.)"):
    plt = _import_plt()
    x_size = ncols * pltConfig["mXSize"]
    y_size = nrows * pltConfig["mYSize"]
    fig, axs = plt.subplots(nrows, ncols, figsize=(x_size, y_size), sharex=True, sharey=True, squeeze=False)
    for ax in axs.flatten():
        ax.tick_params(axis="both", which="major", labelsize=pltConfig["mTickSize"])
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    for ax in axs[-1]:
        ax.set_xlabel(xlabel, fontsize=pltConfig["mLabelSize"])
    for ax in axs[:, 0]:
        ax.set_ylabel(ylabel, fontsize=pltConfig["mLabelSize"])
    return fig, axs


def plot_lines(ax, data_x, data_y, shifted=False, **pkwargs):
    if shifted and data_y.ndim > 1:
        offsets = np.nanmax(np.abs(data_y)) * np.arange(data_y.shape[1])
        data_y = data_y + offsets
    ax.plot(data_x, data_y, **pkwargs)
    if "label" in pkwargs:
        ax.legend(fontsize=pltConfig["sLegendSize"])


def mk_img_figax(xlabel="time (s)", ylabel="frequency (Hz)"):
    plt = _import_plt()
    fig, ax = plt.subplots(1, 1, figsize=pltConfig["sFigSize"])
    ax.tick_params(axis="both", which="major", labelsize=pltConfig["sTickSize"])
    ax.set_xlabel(xlabel, fontsize=pltConfig["sLabelSize"])
    ax.set_ylabel(ylabel, fontsize=pltConfig["sLabelSize"])
    return fig, ax


def mk_multi_img_figax(nrows, ncols, xlabel="time (s)", ylabel="frequency (Hz)"):
    plt = _import_plt()
    x_size = ncols * pltConfig["mXSize"]
    y_size = nrows * pltConfig["mYSize"]
    fig, axs = plt.subplots(nrows, ncols, figsize=(x_size, y_size), sharex=True, sharey=True, squeeze=False)
    for ax in axs.flatten():
        ax.tick_params(axis="both", which="major", labelsize=pltConfig["mTickSize"])
    for ax in axs[-1]:
        ax.set_xlabel(xlabel, fontsize=pltConfig["mLabelSize"])
    for ax in axs[:, 0]:
        ax.set_ylabel(ylabel, fontsize=pltConfig["mLabelSize"])
    return fig, axs


def plot_tfreq(ax, data_yx, times, freqs, **pkwargs):
    extent = [times[0], times[-1], freqs[0], freqs[-1]]
    pkwargs.setdefault("cmap", pltConfig["cmap"])
    ax.imshow(data_yx[::-1], aspect="auto", extent=extent, **pkwargs)
