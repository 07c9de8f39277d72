# -*- coding: utf-8 -*-
#
# save: persist a syncopy_tpu object to a .spy container (HDF5 + JSON info).
#
# Parity target: reference syncopy/io/save_spy_container.py:25-341.
# On-disk format: `<container>.spy/<basename>[_tag].<ext>` HDF5 file holding
# the `data` dataset (+ registered extra datasets + `trialdefinition`) with
# dimensional attributes, and a sidecar `...<ext>.info` JSON with
# provenance (cfg, log, info, checksum).

import json
import os

import numpy as np

from ..shared.errors import SPYError, SPYIOError, SPYTypeError, SPYValueError
from ..shared.filetypes import FILE_EXT, extension_by_class
from ..shared.kwarg_decorators import unwrap_cfg
from ..shared.tools import _json_sanitize
from ..datatype.base_data import _h5py
from .utils import hash_file

__all__ = ["save"]


@unwrap_cfg
def save(out, container=None, tag=None, filename=None, overwrite=False, memuse=100):
    """
    Save `out` to disk.

    Parameters
    ----------
    out : Syncopy data object
        The object to save (any dataclass).
    container : str or None
        Path to a ``*.spy`` container directory (created on demand).
    tag : str or None
        Label distinguishing multiple objects inside one container.
    filename : str or None
        Explicit target path (mutually exclusive with `container`/`tag`).
    overwrite : bool
        Replace an existing file of the same name.
    memuse : int
        Host-RAM budget in MB for the copy loop (larger payloads stream
        chunk-wise).

    Returns
    -------
    The saved object, now backed by the new file (with ``.info`` sidecar).
    """
    from ..datatype.base_data import BaseData

    h5py = _h5py()
    if not isinstance(out, BaseData):
        raise SPYTypeError(out, varname="out", expected="syncopy_tpu data object")
    if out.data is None:
        raise SPYError("Cannot save empty object")

    ext = extension_by_class(out.__class__.__name__)
    if ext is None:
        raise SPYValueError(legal="saveable data class", varname="out", actual=out.__class__.__name__)

    if container is None and filename is None:
        if out._filename is None:
            raise SPYValueError(
                legal="`container` or `filename`", varname="save", actual="neither given"
            )
        filename = out.filename

    if container is not None:
        if filename is not None:
            raise SPYValueError(
                legal="either `container` or `filename`, not both", varname="container"
            )
        container = os.path.abspath(os.path.expanduser(container))
        if not container.endswith(FILE_EXT["dir"]):
            container += FILE_EXT["dir"]
        os.makedirs(container, exist_ok=True)
        basename = os.path.basename(container)[: -len(FILE_EXT["dir"])]
        if tag is not None:
            basename = "{}_{}".format(basename, tag)
        filename = os.path.join(container, basename + ext)
    else:
        filename = os.path.abspath(os.path.expanduser(filename))
        if not filename.endswith(ext):
            filename += ext

    if os.path.exists(filename) and not overwrite and filename != out._filename:
        raise SPYIOError(filename, exists=True)

    tmp_name = filename + ".tmp_save"
    with h5py.File(tmp_name, "w") as f:
        f.create_dataset("data", data=np.asarray(out.data))
        if out.trialdefinition is not None:
            f.create_dataset("trialdefinition", data=out.trialdefinition)
        for name, arr in out._registered_datasets.items():
            if arr is not None:
                f.create_dataset(name, data=np.asarray(arr))
        f.attrs["dimord"] = [str(d) for d in out.dimord]
        f.attrs["_version"] = out._version
        f.attrs["_log"] = out.log
        f.attrs["dataclass"] = out.__class__.__name__
        for prop in ("samplerate",):
            val = getattr(out, prop, None)
            if val is not None:
                f.attrs[prop] = val
        for prop in ("channel", "channel_i", "channel_j", "taper", "unit"):
            if hasattr(out.__class__, prop):
                try:
                    val = getattr(out, prop)
                except Exception:
                    continue
                if val is not None:
                    f.attrs[prop] = [str(v) for v in np.asarray(val).ravel()]
        if hasattr(out.__class__, "freq"):
            try:
                freq = getattr(out, "freq")
            except Exception:
                freq = None
            if freq is not None:
                f.attrs["freq"] = np.asarray(freq, dtype=float)

    # object may currently hold this very file open -> detach before replace
    was_backed = isinstance(out.data, h5py.Dataset)
    if was_backed:
        out._data = np.asarray(out.data)
        extra = {k: (np.asarray(v) if v is not None else None) for k, v in out._registered_datasets.items()}
        out._close_hdf()
        out._extra_datasets.update(extra)
    os.replace(tmp_name, filename)

    # the very first read-write open of a fresh HDF5 file finalizes the
    # superblock (changing bytes once); do it before checksumming so stored
    # hashes stay valid across subsequent r+ opens
    h5py.File(filename, "r+").close()

    info = {
        "dataclass": out.__class__.__name__,
        "filename": os.path.basename(filename),
        "dimord": out.dimord,
        "_version": out._version,
        "_log": out.log,
        "cfg": _json_sanitize(dict(out.cfg)),
        "info": _json_sanitize(dict(out.info)),
        "file_checksum": hash_file(filename),
        "order": "C",
    }
    with open(filename + FILE_EXT["info"], "w") as fj:
        json.dump(info, fj, indent=2, default=str)

    # re-attach the object to the saved file (read/write, no longer temp);
    # a device-resident copy of the payload goes with the old payload, as
    # it would through the data setter: a write into the file must not
    # leave it stale
    res = getattr(out, "_device_resident", None)
    if res is not None:
        res.release()
        out._device_resident = None
    f = h5py.File(filename, "r+")
    out._hdfFile = f
    out._data = f["data"]
    for name in list(out._extra_datasets):
        if name in f:
            out._extra_datasets[name] = f[name]
    out._filename = filename
    out._is_temp_file = False
    out.log = "saved to {}".format(filename)
    return filename
