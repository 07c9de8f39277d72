# -*- coding: utf-8 -*-
#
# Peristimulus time histogram kernel.
#
# Copy of syncopy_tpu/statistics/psth.py, which imports no jax (parity
# target: reference syncopy/statistics/psth.py:7-230). Spike events are
# tiny, ragged integer tables: they stay on the host (numpy histograms).

import numpy as np

__all__ = ["psth", "get_chan_unit_combs", "Rice_rule", "sqrt_rule"]


def _calc_time(samples, trl_start, onset, samplerate):
    """Trigger-relative spike times in seconds
    (reference psth.py:173-181)."""
    return (samples - trl_start + onset) / samplerate


def Rice_rule(nSamples):
    """nBins = int(2 * n^(1/3)), truncating (reference psth.py:225-230)."""
    return int(2 * nSamples ** (1 / 3))


def sqrt_rule(nSamples):
    """nBins = ceil(sqrt(n)) (reference psth.py:204-210)."""
    return int(np.ceil(np.sqrt(nSamples)))


def get_chan_unit_combs(trials):
    """All unique (channel, unit) combinations over a list of spike-data
    arrays `[sample, channel, unit]` (reference psth.py:184-201)."""
    combs = []
    for trl in trials:
        arr = np.asarray(trl)
        if arr.size == 0:
            continue
        combs.append(np.unique(arr[:, 1:3], axis=0))
    if not combs:
        return np.zeros((0, 2), dtype=int)
    return np.unique(np.vstack(combs), axis=0)


def psth(trl_dat, trl_start, onset, trl_end, chan_unit_combs=None, tbins=None,
         output="rate", samplerate=1000):
    """
    Single-trial PSTH over all (channel, unit) combinations
    (reference psth.py:7-170).

    Returns ``(nBins, nCombs)`` counts/rates/proportions.
    """
    trl_dat = np.asarray(trl_dat)
    samples = trl_dat[:, 0]
    channels = trl_dat[:, 1]
    units = trl_dat[:, 2]

    times = _calc_time(samples, trl_start, onset, samplerate)

    if tbins is None:
        nBins = Rice_rule(len(times))
        tbins = np.linspace(times.min(), times.max(), nBins + 1)
    else:
        tbins = np.asarray(tbins)
        nBins = len(tbins) - 1

    if chan_unit_combs is None:
        chan_unit_combs = get_chan_unit_combs([trl_dat])

    counts = np.zeros((nBins, len(chan_unit_combs)))
    for ci, (chan, unit) in enumerate(chan_unit_combs):
        mask = (channels == chan) & (units == unit)
        if not mask.any():
            continue
        hist, _ = np.histogram(times[mask], bins=tbins)
        counts[:, ci] = hist

    if output == "rate":
        widths = np.diff(tbins)
        counts = counts / widths[:, None]
    elif output == "proportion":
        # reference code semantics (psth.py:163-168): each (chan, unit)
        # column SUMS to 1 over the time bins (not area = 1)
        total = counts.sum(axis=0, keepdims=True).copy()
        total[total == 0] = 1.0
        counts = counts / total
    return counts
