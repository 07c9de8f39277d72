# -*- coding: utf-8 -*-
#
# Plotting style layer (parity: reference syncopy/plotting/config.py:1-71).
#
# Applied lazily on first plot via :func:`apply_style` — never at import
# (headless compute sessions must not pay a matplotlib import). Opt out
# with ``SPY_PLOT_STYLE=0`` or :func:`use_style(False)`.

import os

foreground = "#2E3440"  # nord0
background = "#fcfcfc"  # hint of gray

#: rc overrides applied on top of the colorblind style
rc_props = {
    "patch.edgecolor": foreground,
    "text.color": foreground,
    "axes.facecolor": background,
    "figure.facecolor": background,
    "axes.edgecolor": foreground,
    "axes.labelcolor": foreground,
    "xtick.color": foreground,
    "ytick.color": foreground,
    "legend.framealpha": 0,
    "figure.edgecolor": background,
    "savefig.facecolor": background,
    "savefig.edgecolor": background,
}

#: global sizing knobs for single-/multi-panel figures (reference
#: config.py:46-62); mutate to restyle, e.g.
#: ``spy.plotting.config.pltConfig["cmap"] = "viridis"``
pltConfig = {
    "sTitleSize": 10,
    "sLabelSize": 8,
    "sTickSize": 8,
    "sLegendSize": 8,
    "sFigSize": (6.4, 4.2),
    "mTitleSize": 12,
    "mLabelSize": 10,
    "mTickSize": 9,
    "mLegendSize": 9,
    "mXSize": 3.2,
    "mYSize": 2.4,
    "mMaxAxes": 25,
    "cmap": "magma",
    #: time columns of a time-frequency image; a device-resident TFR is
    #: box-averaged down to it on the device before the readback
    "maxPlotTime": 1024,
}

_style_enabled = os.environ.get("SPY_PLOT_STYLE", "1") != "0"
_style_applied = False


def use_style(enabled=True):
    """Enable/disable the syncopy_tpu matplotlib style (rc overrides +
    colorblind palette). Takes effect on the next figure."""
    global _style_enabled, _style_applied
    _style_enabled = bool(enabled)
    _style_applied = False


def apply_style(mpl):
    """Idempotently apply the style to an imported matplotlib module."""
    global _style_applied
    if not _style_enabled or _style_applied:
        return
    try:
        import matplotlib.style as mstyle

        for name in ("seaborn-v0_8-colorblind", "seaborn-colorblind"):
            if name in mstyle.available:
                mstyle.use(name)
                break
        mpl.rcParams.update(rc_props)
    except Exception:
        pass  # styling must never break plotting
    _style_applied = True
