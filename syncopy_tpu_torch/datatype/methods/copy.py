# -*- coding: utf-8 -*-
#
# copy: deep copy of a data object (reference datatype/methods/copy.py:20).

import numpy as np

__all__ = ["copy"]


def copy(data):
    """Return an independent deep copy of `data` (payload included)."""
    cls = data.__class__
    new = cls.__new__(cls)
    # fresh init without data
    cls.__init__(new)
    if data.data is not None:
        new.data = np.array(data.data)
        for name, arr in data._registered_datasets.items():
            if arr is not None:
                new._register_dataset(name, np.array(arr))
    if data._trialdefinition is not None:
        new._trialdefinition = np.array(data._trialdefinition)
    # dimensional properties
    for attr in ("_samplerate", "_channel", "_freq", "_taper", "_channel_i", "_channel_j", "_unit", "_dimord"):
        if hasattr(data, attr):
            val = getattr(data, attr)
            setattr(new, attr, np.array(val) if isinstance(val, np.ndarray) else (list(val) if isinstance(val, list) else val))
    new._cfg = data.cfg.copy()
    new._info = type(data.info)(dict(data.info))
    new._log = str(data._log)
    new.log = "copy of {}".format(data.__class__.__name__)
    return new
