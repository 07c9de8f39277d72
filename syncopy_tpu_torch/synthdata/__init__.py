# -*- coding: utf-8 -*-
from .analog import (  # noqa: F401
    white_noise,
    linear_trend,
    harmonic,
    phase_diffusion,
    ar2_network,
    red_noise,
    ar2_peak_freq,
    mk_RandomAdjMat,
    ar2_network_batched,
    ar2_network_device,
)
from .spikes import poisson_noise  # noqa: F401
from .utils import collect_trials  # noqa: F401
