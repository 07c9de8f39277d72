# -*- coding: utf-8 -*-
from .save_spy_container import save  # noqa: F401
from .load_spy_container import load  # noqa: F401
from .utils import cleanup, clear, hash_file  # noqa: F401
from .load_ft import load_ft_raw  # noqa: F401
from .load_tdt import load_tdt  # noqa: F401
from .load_nwb import load_nwb  # noqa: F401
