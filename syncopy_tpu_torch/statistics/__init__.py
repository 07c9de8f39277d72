# -*- coding: utf-8 -*-
from .summary_stats import mean, std, var, median, itc  # noqa: F401
from .spike_psth import spike_psth  # noqa: F401
from .timelockanalysis import timelockanalysis  # noqa: F401
