# -*- coding: utf-8 -*-
from .freqanalysis import freqanalysis  # noqa: F401
