# -*- coding: utf-8 -*-
from .base_data import BaseData, FauxTrial  # noqa: F401
from .continuous_data import (  # noqa: F401
    ContinuousData,
    AnalogData,
    SpectralData,
    CrossSpectralData,
    TimeLockData,
)
from .discrete_data import DiscreteData, SpikeData, EventData  # noqa: F401
from .selector import Selector  # noqa: F401
from .util import TrialIndexer, TimeIndexer, setup_storage  # noqa: F401
from .methods.definetrial import definetrial  # noqa: F401
from .methods.redefinetrial import redefinetrial  # noqa: F401
from .methods.selectdata import selectdata  # noqa: F401
from .methods.show import show  # noqa: F401
from .methods.copy import copy  # noqa: F401
from .methods.concat import concat  # noqa: F401
