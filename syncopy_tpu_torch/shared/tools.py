# -*- coding: utf-8 -*-
#
# General-purpose tools: StructDict, SerializableDict, get_defaults,
# get_frontend_cfg, best_match.
#
# Parity target: reference syncopy/shared/tools.py:20-376.

import inspect
import json

import numpy as np

from .errors import SPYTypeError, SPYValueError

__all__ = [
    "StructDict",
    "SerializableDict",
    "get_defaults",
    "get_frontend_cfg",
    "best_match",
]


class StructDict(dict):
    """
    Dictionary with attribute access (FieldTrip-style ``cfg`` struct).

    Parity: reference tools.py:20-90. ``cfg.method = "mtmfft"`` works like
    ``cfg["method"] = "mtmfft"``; nested dicts are converted on access.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self

    def __getattr__(self, name):
        # only called when normal attribute lookup fails
        raise AttributeError("'StructDict' object has no attribute '{}'".format(name))

    def __repr__(self):
        if not self:
            return "Empty StructDict"
        maxlen = max(len(str(k)) for k in self.keys())
        lines = ["syncopy_tpu StructDict"]
        for key, value in self.items():
            lines.append("   {0:>{w}} : {1}".format(str(key), str(value), w=maxlen))
        return "\n".join(lines)

    def copy(self):
        return StructDict(dict.copy(self))

    def __deepcopy__(self, memo):
        import copy as _copy

        new = StructDict()
        memo[id(self)] = new
        for key, value in self.items():
            new[_copy.deepcopy(key, memo)] = _copy.deepcopy(value, memo)
        return new


def _json_sanitize(value, stringify_keys=True):
    """Convert numpy scalars/arrays/ranges to JSON-compatible builtins;
    ``stringify_keys=False`` keeps dict keys as-is (cfg normalization)."""
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, range):
        return list(value)
    if isinstance(value, dict):
        return {
            (str(k) if stringify_keys else k): _json_sanitize(v, stringify_keys)
            for k, v in value.items()
        }
    if isinstance(value, (list, tuple)):
        return [_json_sanitize(v, stringify_keys) for v in value]
    return value


class SerializableDict(dict):
    """
    Dictionary that only admits JSON-serializable keys/values
    (used for the ``.info`` property; reference tools.py:93-164).
    """

    def __init__(self, *args, **kwargs):
        super().__init__()
        tmp = dict(*args, **kwargs)
        for key, value in tmp.items():
            self[key] = value

    def __setitem__(self, key, value):
        key = _json_sanitize(key)
        value = _json_sanitize(value)
        try:
            json.dumps(key)
            json.dumps(value)
        except TypeError:
            raise SPYTypeError(value, varname=str(key), expected="JSON-serializable value")
        super().__setitem__(key, value)


def get_defaults(obj):
    """
    Parse the signature of callable `obj` and return a StructDict of
    keyword arguments and their default values (reference tools.py:346-375).
    """
    if not callable(obj):
        raise SPYTypeError(obj, varname="obj", expected="callable")
    dct = {
        k: v.default
        for k, v in inspect.signature(obj).parameters.items()
        if v.default is not v.empty and v.name != "cfg"
    }
    return StructDict(dct)


def get_frontend_cfg(defaults, lcls, kwargs):
    """
    Assemble the replayable ``cfg`` for a frontend call: defaults overridden
    by the actual local argument values plus extra kwargs (reference
    tools.py:167-221).
    """
    cfg = StructDict()
    for key in defaults:
        if key in lcls:
            cfg[key] = _plain_value(lcls[key])
    for key, value in kwargs.items():
        if key not in ("parallel", "chan_per_worker"):
            cfg[key] = _plain_value(value)
    if lcls.get("kwargs"):
        for key, value in lcls["kwargs"].items():
            if key == "select":
                cfg[key] = _plain_value(value)
    return cfg


def _plain_value(value):
    """Normalize a cfg entry to plain JSON-serializable Python (reference
    tools.py:125-164): numpy arrays/ranges become lists, numpy scalars
    become int/float, dicts (``select``) are normalized recursively — so a
    cfg survives a save/load JSON round-trip comparing EQUAL to the
    original (tests/test_cfg.py:66-90 replay semantics)."""
    return _json_sanitize(value, stringify_keys=False)


def best_match(source, selection, span=False, tol=None, squash_duplicates=False):
    """
    Find the closest matches of `selection` inside the 1d array `source`.

    Parameters
    ----------
    source : 1d array
        Values to match against (e.g. the frequency axis).
    selection : array_like
        Query values, or a ``[lo, hi]`` interval with ``span=True``.
    span : bool
        Treat `selection` as a closed interval and return all of `source`
        inside it.
    tol : float or None
        If set, raise :class:`SPYValueError` when any query deviates by
        >= `tol` from every source element.
    squash_duplicates : bool
        Drop repeated matches (keeping first-occurrence order).

    Returns
    -------
    (values, idx) : tuple of arrays
        With ``source[idx] == values``.

    Parity: reference tools.py:224-345 (same semantics, fresh implementation).
    """
    source = np.asarray(source)
    if np.issubdtype(type(selection), np.number):
        selection = [selection]
    selection = np.asarray(selection)

    if tol is not None:
        # every query must be within tol of at least... reference requires
        # within tol of *all* source elements? No: of its own best match.
        dev = np.abs(selection[:, None] - source[None, :]).min(axis=1)
        if np.any(dev >= tol):
            raise SPYValueError(
                legal="all elements of `selection` within a {0:2.4f}-band around `source`".format(tol),
                varname="selection",
                actual="deviation up to {0:2.4f}".format(float(dev.max())),
            )

    if span:
        idx = np.where((source >= selection[0]) & (source <= selection[1]))[0]
        return source[idx], idx

    order = None
    src_sorted = source
    if source.size > 1 and np.any(np.diff(source) < 0):
        order = np.argsort(source, kind="stable")
        src_sorted = source[order]

    pos = np.searchsorted(src_sorted, selection, side="left")
    left = np.clip(pos - 1, 0, src_sorted.size - 1)
    right = np.clip(pos, 0, src_sorted.size - 1)
    choose_left = (pos == src_sorted.size) | (
        np.abs(selection - src_sorted[left]) < np.abs(selection - src_sorted[right])
    )
    idx = np.where(choose_left, left, right)

    if squash_duplicates:
        _, first = np.unique(idx, return_index=True)
        idx = idx[np.sort(first)]

    if order is not None:
        idx = order[idx]
    return source[idx], idx
