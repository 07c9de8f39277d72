# -*- coding: utf-8 -*-
#
# Synthetic spike data (parity: reference syncopy/synthdata/spikes.py:17).

import numpy as np

__all__ = ["poisson_noise"]


def poisson_noise(
    nTrials=10,
    nSpikes=10000,
    nChannels=3,
    nUnits=10,
    intensity=0.1,
    samplerate=10000,
    seed=None,
):
    """
    Poisson (Gamma-renewal) spike trains with unit-specific rates.

    Returns a :class:`~syncopy_tpu.SpikeData` with `nSpikes` events spread
    over `nTrials` trials, `nChannels` channels and `nUnits` units; inter-
    spike intervals are exponential with rate ``intensity * samplerate``
    scaled per unit.
    """
    from ..datatype.discrete_data import SpikeData

    rng = np.random.default_rng(seed)

    spikes_per_trial = np.full(nTrials, nSpikes // nTrials)
    spikes_per_trial[: nSpikes % nTrials] += 1

    # unit-specific rate modulation
    unit_rates = intensity * (0.5 + rng.uniform(size=nUnits))

    data_rows = []
    trl_rows = []
    sample_cursor = 0
    for tr in range(nTrials):
        n_tr = int(spikes_per_trial[tr])
        units = rng.integers(0, nUnits, size=n_tr)
        channels = rng.integers(0, nChannels, size=n_tr)
        isi = rng.exponential(1.0 / (unit_rates[units] * samplerate) * samplerate)
        samples = sample_cursor + np.sort(np.cumsum(np.maximum(isi, 1)).astype(np.int64))
        data_rows.append(np.column_stack([samples, channels, units]))
        trl_len = int(samples[-1] - sample_cursor + 1) if n_tr else 1
        trl_rows.append([sample_cursor, sample_cursor + trl_len, 0])
        sample_cursor += trl_len

    data = np.concatenate(data_rows, axis=0).astype(np.int64)
    trl = np.array(trl_rows, dtype=float)
    return SpikeData(data=data, samplerate=samplerate, trialdefinition=trl)
