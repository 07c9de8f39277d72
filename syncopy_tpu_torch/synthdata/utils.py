# -*- coding: utf-8 -*-
#
# @collect_trials: wrap single-trial generators into multi-trial AnalogData.
#
# Parity target: reference syncopy/synthdata/utils.py:20-60.

import functools
from inspect import signature

import numpy as np

from ..shared.kwarg_decorators import unwrap_cfg
from ..shared.parsers import scalar_parser

__all__ = ["collect_trials"]


def collect_trials(trial_func):
    """
    Wrap a single-trial generator (returning an ``nSamples x nChannels``
    ndarray) into a multi-trial :class:`~syncopy_tpu.AnalogData` factory.

    Adds kwargs ``nTrials`` (default 100; ``None`` returns the bare
    single-trial array), ``samplerate`` (forwarded if the generator accepts
    it), ``seed`` and ``seed_per_trial``.
    """

    @unwrap_cfg
    @functools.wraps(trial_func)
    def wrapper_synth(*args, nTrials=100, samplerate=1000, seed=None, seed_per_trial=True, **tf_kwargs):
        from ..datatype.continuous_data import AnalogData

        params = signature(trial_func).parameters
        if "samplerate" in params:
            tf_kwargs["samplerate"] = samplerate

        if nTrials is None:
            if "seed" in params:
                tf_kwargs["seed"] = seed
            return trial_func(*args, **tf_kwargs)

        scalar_parser(nTrials, "nTrials", ntype="int_like", lims=[1, np.inf])
        seed_array = None
        if seed is not None and seed_per_trial:
            rng = np.random.default_rng(seed)
            seed_array = rng.integers(1_000_000, size=nTrials)

        trls = []
        for k in range(int(nTrials)):
            if "seed" in params:
                tf_kwargs["seed"] = (
                    int(seed_array[k]) if seed_array is not None else seed
                )
            trls.append(np.asarray(trial_func(*args, **tf_kwargs)))

        adata = AnalogData(data=trls, samplerate=samplerate)
        # center trials around 0 offset like typical epoched data? reference
        # keeps offset 0 -> do the same
        return adata

    return wrapper_synth
