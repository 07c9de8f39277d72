# -*- coding: utf-8 -*-
#
# Defensive input validation.
#
# Parity target: reference syncopy/shared/parsers.py:17-788
# (io_parser, scalar_parser, array_parser, data_parser, filename_parser,
# sequence_parser). Fresh implementations with the same contracts.

import numbers
import os

import numpy as np

from .errors import SPYIOError, SPYTypeError, SPYValueError

__all__ = [
    "io_parser",
    "scalar_parser",
    "array_parser",
    "data_parser",
    "filename_parser",
    "sequence_parser",
]


def io_parser(fs_loc, varname="", isfile=True, ext="", exists=True):
    """
    Validate a filesystem location (reference parsers.py:17-130).

    Returns the absolute, user-expanded path.
    """
    if not isinstance(fs_loc, (str, os.PathLike)):
        raise SPYTypeError(fs_loc, varname=varname, expected="str")
    fs_loc = os.path.abspath(os.path.expanduser(str(fs_loc)))

    if exists and not os.path.exists(fs_loc):
        raise SPYIOError(fs_loc, exists=False)
    if not exists and os.path.exists(fs_loc):
        raise SPYIOError(fs_loc, exists=True)

    if exists:
        if isfile and not os.path.isfile(fs_loc):
            raise SPYValueError(legal="file", varname=varname, actual="directory")
        if not isfile and not os.path.isdir(fs_loc):
            raise SPYValueError(legal="directory", varname=varname, actual="file")

    if ext:
        exts = [ext] if isinstance(ext, str) else list(ext)
        if not any(fs_loc.endswith(e) for e in exts):
            raise SPYValueError(
                legal="extension(s) {}".format(exts), varname=varname, actual=fs_loc
            )
    return fs_loc


def scalar_parser(var, varname="", ntype=None, lims=None):
    """
    Validate a scalar (reference parsers.py:133-222).

    Parameters
    ----------
    ntype : None or "int_like"
        "int_like" demands `var` has no fractional part.
    lims : None or [lo, hi]
        Closed interval the value must fall into.
    """
    if var is None or not isinstance(var, numbers.Number) or isinstance(var, bool):
        raise SPYTypeError(var, varname=varname, expected="scalar")
    if isinstance(var, complex):
        value = var
        if var.imag != 0:
            if ntype == "int_like":
                raise SPYValueError(legal="integer-like scalar", varname=varname, actual=str(var))
    else:
        value = float(var)

    if ntype is not None:
        if ntype == "int_like":
            if isinstance(var, complex) or int(var) != var:
                raise SPYValueError(legal="integer-like scalar", varname=varname, actual=str(var))
        else:
            raise SPYValueError(legal="'int_like' or None", varname="ntype", actual=str(ntype))

    if lims is not None:
        if isinstance(var, complex):
            inside = lims[0] <= var.real <= lims[1] and lims[0] <= var.imag <= lims[1]
        else:
            inside = lims[0] <= value <= lims[1]
        if not inside:
            raise SPYValueError(
                legal="value in [{}, {}]".format(lims[0], lims[1]),
                varname=varname,
                actual=str(var),
            )
    return var


def array_parser(
    var,
    varname="",
    ntype=None,
    hasinf=None,
    hasnan=None,
    lims=None,
    dims=None,
):
    """
    Validate array-likes (reference parsers.py:225-494).

    Parameters
    ----------
    ntype : None or str
        expected dtype kind, e.g. "numeric", "int_like", "str", "bool"
    hasinf / hasnan : None or bool
        `False` forbids inf/nan entries.
    lims : None or [lo, hi]
        closed bounds for all (numeric) entries
    dims : None, int or tuple
        expected number of dimensions (int) or expected shape; `None` entries
        in a tuple mean "any size along this axis".
    """
    if not isinstance(var, (list, tuple, np.ndarray, range)):
        raise SPYTypeError(var, varname=varname, expected="array_like")
    arr = np.asarray(var)

    if ntype is not None:
        if ntype in ("numeric", "int_like"):
            if not np.issubdtype(arr.dtype, np.number):
                raise SPYTypeError(var, varname=varname, expected="numeric array")
            if ntype == "int_like" and not np.all(np.equal(np.mod(arr[~np.isnan(arr.astype(float))] if arr.size else arr, 1), 0)):
                raise SPYValueError(legal="integer-like array", varname=varname)
        elif ntype == "str":
            if not (arr.dtype.kind in ("U", "S", "O")):
                raise SPYTypeError(var, varname=varname, expected="string array")
        elif ntype == "bool":
            if arr.dtype.kind != "b":
                raise SPYTypeError(var, varname=varname, expected="boolean array")
        else:
            raise SPYValueError(legal="'numeric', 'int_like', 'str' or 'bool'", varname="ntype", actual=str(ntype))

    if np.issubdtype(arr.dtype, np.number):
        farr = arr.astype(np.complex128) if np.iscomplexobj(arr) else arr.astype(np.float64)
        if hasinf is False and np.any(np.isinf(farr)):
            raise SPYValueError(legal="finite values", varname=varname, actual="inf")
        if hasnan is False and np.any(np.isnan(farr)):
            raise SPYValueError(legal="non-NaN values", varname=varname, actual="NaN")
        if lims is not None:
            vals = farr[np.isfinite(farr)] if farr.size else farr
            if vals.size and (np.any(vals.real < lims[0]) or np.any(vals.real > lims[1])):
                raise SPYValueError(
                    legal="all values in [{}, {}]".format(lims[0], lims[1]),
                    varname=varname,
                )

    if dims is not None:
        if isinstance(dims, int):
            # allow squeezable vectors for 1d expectation (reference behavior)
            if arr.ndim != dims and not (dims == 1 and arr.squeeze().ndim <= 1):
                raise SPYValueError(
                    legal="{}-dimensional array".format(dims),
                    varname=varname,
                    actual="{}-dimensional".format(arr.ndim),
                )
        else:
            if arr.ndim != len(dims):
                raise SPYValueError(
                    legal="{}-dimensional array".format(len(dims)),
                    varname=varname,
                    actual="{}-dimensional".format(arr.ndim),
                )
            for k, size in enumerate(dims):
                if size is not None and arr.shape[k] != size:
                    raise SPYValueError(
                        legal="axis {} of length {}".format(k, size),
                        varname=varname,
                        actual=str(arr.shape),
                    )
    return arr


def data_parser(
    data,
    varname="",
    dataclass=None,
    writable=None,
    empty=None,
    dimord=None,
):
    """
    Validate syncopy_tpu data objects (reference parsers.py:497-586).
    """
    from ..datatype.base_data import BaseData

    if not isinstance(data, BaseData):
        raise SPYTypeError(data, varname=varname, expected="syncopy_tpu data object")
    if dataclass is not None:
        if data.__class__.__name__ != str(dataclass).replace("Data", "") + "Data" and data.__class__.__name__ != str(dataclass):
            raise SPYValueError(
                legal=str(dataclass), varname=varname, actual=data.__class__.__name__
            )
    if empty is not None:
        if empty and data.data is not None:
            raise SPYValueError(legal="empty object", varname=varname, actual="non-empty")
        if not empty and data.data is None:
            raise SPYValueError(legal="non-empty object", varname=varname, actual="empty")
    if writable is not None:
        if writable != data.is_writable:
            raise SPYValueError(
                legal="{} object".format("writable" if writable else "read-only"),
                varname=varname,
                actual="mode '{}'".format(data.mode),
            )
    if dimord is not None:
        if data.dimord != list(dimord):
            raise SPYValueError(legal=str(dimord), varname=varname + ".dimord", actual=str(data.dimord))
    return data


def filename_parser(filename, is_in_valid_container=None):
    """
    Decompose a syncopy container/file path into its parts
    (reference parsers.py:589-732).

    Returns a dict with keys: filename, container, folder, tag, basename,
    extension.
    """
    from .filetypes import FILE_EXT

    if filename is None:
        return {
            "filename": None,
            "container": None,
            "folder": None,
            "tag": None,
            "basename": None,
            "extension": None,
        }
    filename = os.path.abspath(os.path.expanduser(str(filename)))
    folder, base = os.path.split(filename)
    container = None
    tag = None

    if base.endswith(FILE_EXT["dir"]):
        # a container directory was given
        return {
            "filename": None,
            "container": base,
            "folder": folder,
            "tag": None,
            "basename": base[: -len(FILE_EXT["dir"])],
            "extension": FILE_EXT["dir"],
        }

    ext = None
    for fext in FILE_EXT["data"] + (FILE_EXT["info"],):
        if base.endswith(fext):
            ext = fext
            break
    if ext is None:
        raise SPYValueError(
            legal="filename with extension in {}".format(FILE_EXT["data"]),
            varname="filename",
            actual=base,
        )
    basename = base[: -len(ext)]
    parent = os.path.basename(folder)
    if parent.endswith(FILE_EXT["dir"]):
        container = parent
        cbase = parent[: -len(FILE_EXT["dir"])]
        if basename.startswith(cbase + "_"):
            tag = basename[len(cbase) + 1 :]
        folder_out = folder
    else:
        if is_in_valid_container:
            raise SPYValueError(
                legal="file inside a *{} container".format(FILE_EXT["dir"]),
                varname="filename",
                actual=filename,
            )
        folder_out = folder
    return {
        "filename": base,
        "container": container,
        "folder": folder_out,
        "tag": tag,
        "basename": basename,
        "extension": ext,
    }


def sequence_parser(seq, varname="", content_type=None):
    """
    Validate that `seq` is a sequence (list/tuple/1d-array), optionally of a
    given element type (reference parsers.py:735-788).
    """
    if isinstance(seq, str) or not hasattr(seq, "__iter__"):
        raise SPYTypeError(seq, varname=varname, expected="sequence")
    if content_type is not None:
        for el in seq:
            if not isinstance(el, content_type):
                raise SPYTypeError(el, varname=varname, expected=str(content_type))
    return list(seq)
