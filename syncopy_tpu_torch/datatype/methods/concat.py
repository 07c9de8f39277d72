# -*- coding: utf-8 -*-
#
# concat: concatenate two syncopy_tpu objects along a non-time dimension.
#
# Parity target: reference syncopy/datatype/methods/concat.py:24-200 (the
# `SpyConcat` CR becomes a per-trial host concatenation — metadata-bound,
# not compute-bound).

import numpy as np

from ...shared.errors import SPYTypeError, SPYValueError

__all__ = ["concat"]


def concat(spy_obj1, spy_obj2, dim="channel", copy=True):
    """
    Concatenate `spy_obj2` onto `spy_obj1` along dimension `dim`.

    Parameters
    ----------
    spy_obj1, spy_obj2 : Syncopy data objects
        Same class, same trial layout.
    dim : str
        Any dimord entry except the stacking/time dimension
        (e.g. "channel").
    copy : bool
        Return a new object (True) or extend `spy_obj1` (False).

    Returns
    -------
    The concatenated object.
    """
    from ..base_data import BaseData

    for obj in (spy_obj1, spy_obj2):
        if not isinstance(obj, BaseData):
            raise SPYTypeError(obj, varname="spy_obj", expected="syncopy_tpu data object")
    if spy_obj1.__class__ != spy_obj2.__class__:
        raise SPYValueError(
            legal="objects of the same class",
            varname="spy_obj2",
            actual="{} vs {}".format(spy_obj1.__class__.__name__, spy_obj2.__class__.__name__),
        )
    if spy_obj1.dimord != spy_obj2.dimord:
        raise SPYValueError(legal="matching dimord", varname="spy_obj2")
    if dim not in spy_obj1.dimord:
        raise SPYValueError(
            legal="dim in {}".format(spy_obj1.dimord), varname="dim", actual=str(dim)
        )
    if dim == spy_obj1._stackingDimLabel:
        raise SPYValueError(
            legal="non-stacking dimension", varname="dim", actual=dim
        )
    ax = spy_obj1.dimord.index(dim)

    t1 = [np.asarray(t) for t in spy_obj1.trials]
    t2 = [np.asarray(t) for t in spy_obj2.trials]
    if len(t1) != len(t2):
        raise SPYValueError(
            legal="equal trial counts", varname="spy_obj2",
            actual="{} vs {}".format(len(t1), len(t2)),
        )
    for a, b in zip(t1, t2):
        sa = list(a.shape)
        sb = list(b.shape)
        sa.pop(ax)
        sb.pop(ax)
        if sa != sb:
            raise SPYValueError(
                legal="matching trial shapes off the concat axis", varname="spy_obj2",
                actual="{} vs {}".format(a.shape, b.shape),
            )

    res = [np.concatenate([a, b], axis=ax) for a, b in zip(t1, t2)]

    cls = spy_obj1.__class__
    out = cls.__new__(cls)
    cls.__init__(out)
    out._dimord = spy_obj1.dimord
    out.data = np.concatenate(res, axis=spy_obj1._stackingDim)
    out._trialdefinition = np.array(spy_obj1.trialdefinition)
    if getattr(spy_obj1, "samplerate", None) is not None:
        out.samplerate = spy_obj1.samplerate
    if dim == "channel":
        out.channel = np.concatenate([np.asarray(spy_obj1.channel), np.asarray(spy_obj2.channel)])
    elif "channel" in spy_obj1.dimord and hasattr(out, "channel"):
        out.channel = np.asarray(spy_obj1.channel)
    if "freq" in spy_obj1.dimord:
        if dim == "freq":
            out.freq = np.concatenate([np.asarray(spy_obj1.freq), np.asarray(spy_obj2.freq)])
        else:
            out.freq = np.asarray(spy_obj1.freq)
    if "taper" in spy_obj1.dimord:
        if dim == "taper":
            out.taper = np.concatenate([np.asarray(spy_obj1.taper), np.asarray(spy_obj2.taper)])
        else:
            out.taper = np.asarray(spy_obj1.taper)
    out._log = str(spy_obj1._log)
    out.log = "concatenated two {} objects along '{}'".format(cls.__name__, dim)
    return out
