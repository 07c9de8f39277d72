# -*- coding: utf-8 -*-
#
# show: materialize (selected) data as a numpy array.
#
# Parity target: reference syncopy/datatype/methods/show.py:15.

import numpy as np


__all__ = ["show"]


def show(data, squeeze=True, **kwargs):
    """
    Return (selected) data as a numpy array.

    Parameters
    ----------
    data : Syncopy data object
        Object to read from.
    squeeze : bool
        Drop singleton dimensions from the result.
    **kwargs
        Selection keywords (``trials``, ``channel``, ``latency``,
        ``frequency``, ...) applied as a transient in-place selection; an
        existing in-place selection is honored when no kwargs are given.

    Returns
    -------
    numpy.ndarray or list of arrays
        One array per selected trial (a single trial returns the bare
        array).
    """
    if data.data is None:
        return None

    had_selection = data.selection is not None
    if kwargs:
        prior = data.selection
        data.selection = {k: v for k, v in kwargs.items() if v is not None}
    elif not had_selection:
        data.selection = {}

    try:
        sel = data.selection
        arrs = [sel.select_trial_array(data, k) for k in range(len(sel.trial_ids))]
    finally:
        if kwargs:
            data._selection = prior
        elif not had_selection:
            data._selection = None

    if not arrs:
        return np.empty((0,))
    # reference semantics (methods/show.py:190-194): a single selected trial
    # returns the bare array, multiple trials return a LIST of arrays
    if len(arrs) == 1:
        return np.squeeze(arrs[0]) if squeeze else arrs[0]
    return [np.squeeze(a) if squeeze else a for a in arrs]
