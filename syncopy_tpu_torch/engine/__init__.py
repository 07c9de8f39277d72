# -*- coding: utf-8 -*-
from .routine import ComputationalRoutine  # noqa: F401
