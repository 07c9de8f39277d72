# -*- coding: utf-8 -*-
from .connectivity_analysis import connectivityanalysis  # noqa: F401
