# -*- coding: utf-8 -*-
from .summary_stats import mean, std, var, median, itc  # noqa: F401
