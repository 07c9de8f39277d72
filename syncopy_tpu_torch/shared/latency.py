# -*- coding: utf-8 -*-
#
# Latency (analysis time window) processing.
#
# Parity target: reference syncopy/shared/latency.py:17-150.

import numpy as np

from .errors import SPYValueError
from .parsers import array_parser

__all__ = ["get_analysis_window", "create_trial_selection", "available_latencies"]

available_latencies = ["maxperiod", "minperiod", "prestim", "poststim"]


def _trial_intervals(data):
    if data.selection is not None:
        trl = data.selection.trialdefinition
    else:
        trl = data.trialdefinition
    lens = trl[:, 1] - trl[:, 0]
    irr = getattr(data, "irregular_time", None)
    if irr is not None:
        # irregular (uneven toi) axis: the bookkeeping samplerate
        # misrepresents the time range — use the EXACT points (all trials
        # share them; such outputs are time-locked by construction)
        pts = np.asarray(irr, dtype=float)
        starts = np.full(trl.shape[0], pts.min())
        ends = np.array([pts[: int(n)].max() for n in lens], dtype=float)
        return starts, ends
    fs = data.samplerate
    starts = trl[:, 2] / fs
    ends = (lens - 1 + trl[:, 2]) / fs
    return starts, ends


def get_analysis_window(data, latency):
    """Resolve `latency` to a [start, end] window in seconds
    (reference latency.py:17-96)."""
    trl_starts, trl_ends = _trial_intervals(data)

    if isinstance(latency, str):
        if latency not in available_latencies:
            raise SPYValueError(
                legal="one of {}".format(available_latencies), varname="latency", actual=latency
            )
        if latency == "minperiod":
            window = [np.max(trl_starts), np.min(trl_ends)]
            if window[0] > window[1]:
                raise SPYValueError(
                    legal="overlapping trials", varname="latency",
                    actual="{} - no common time window for all trials".format(latency),
                )
        elif latency == "maxperiod":
            window = [np.min(trl_starts), np.max(trl_ends)]
        elif latency == "prestim":
            if not np.any(trl_starts < 0):
                raise SPYValueError(
                    legal="pre-stimulus recordings", varname="latency",
                    actual="no pre-stimulus (t < 0) events",
                )
            window = [np.min(trl_starts), 0]
        else:  # poststim
            if not np.any(trl_ends > 0):
                raise SPYValueError(
                    legal="post-stimulus recordings", varname="latency",
                    actual="no post-stimulus (t > 0) events",
                )
            window = [0, np.max(trl_ends)]
    else:
        array_parser(latency, varname="latency", lims=[-np.inf, np.inf], dims=(2,))
        if latency[0] > trl_ends.max():
            raise SPYValueError(
                legal="start of latency window < {}s".format(trl_ends.max()),
                varname="latency[0]", actual=str(latency[0]),
            )
        if latency[1] < trl_starts.min():
            raise SPYValueError(
                legal="end of latency window > {}s".format(trl_starts.min()),
                varname="latency[1]", actual=str(latency[1]),
            )
        if latency[0] > latency[1]:
            raise SPYValueError(
                legal="start < end latency window", varname="latency",
                actual="start={}, end={}".format(latency[0], latency[1]),
            )
        window = [float(latency[0]), float(latency[1])]
    return window


def create_trial_selection(data, window):
    """Trials that completely cover `window`; returns (select-dict,
    numDiscard) (reference latency.py:99-150)."""
    trl_starts, trl_ends = _trial_intervals(data)
    fits = (trl_starts <= window[0]) & (trl_ends >= window[1])
    if data.selection is not None:
        all_ids = np.asarray(data.selection.trial_ids)
        select = dict(data.selection.select)
    else:
        all_ids = np.arange(len(data.trials))
        select = {}
    keep = all_ids[fits]
    num_discard = int(len(all_ids) - len(keep))
    if len(keep) == 0:
        raise SPYValueError(
            legal="at least one trial covering the latency window",
            varname="latency", actual="no trial completely covers the window",
        )
    select["trials"] = [int(k) for k in keep]
    return select, num_discard
