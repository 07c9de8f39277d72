# -*- coding: utf-8 -*-
from .preprocessing import preprocessing  # noqa: F401
from .resampledata import resampledata  # noqa: F401
