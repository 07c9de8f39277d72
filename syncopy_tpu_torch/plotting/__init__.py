# -*- coding: utf-8 -*-
from .spy_plotting import singlepanelplot, multipanelplot  # noqa: F401
