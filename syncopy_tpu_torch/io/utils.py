# -*- coding: utf-8 -*-
#
# Storage hygiene: cleanup of session temp files, file hashing.
#
# Parity target: reference syncopy/io/utils.py:49-270.

import hashlib
import os
import shutil
import time

from ..shared.errors import SPYTypeError, SPYInfo

__all__ = ["cleanup", "clear", "hash_file"]


def hash_file(fname, bsize=65536):
    """SHA1 content hash of a file (reference io/utils.py:49).

    HDF5 files are hashed over their dataset/attribute *contents* rather
    than raw bytes — the HDF5 superblock changes while a read-write handle
    is open, which would make raw-byte hashes unstable.
    """
    try:
        import h5py

        if h5py.is_hdf5(fname):
            return _hash_hdf5_content(fname)
    except Exception:
        pass
    hash_obj = hashlib.sha1()
    with open(fname, "rb") as f:
        for block in iter(lambda: f.read(bsize), b""):
            hash_obj.update(block)
    return hash_obj.hexdigest()


def _hash_hdf5_content(fname):
    import h5py
    import numpy as np

    def attr_bytes(value):
        arr = np.asarray(value)
        if arr.dtype == object or arr.dtype.kind in ("U", "S"):
            return repr([str(v) for v in arr.ravel()]).encode()
        return arr.tobytes()

    hash_obj = hashlib.sha1()
    with h5py.File(fname, "r") as f:

        def visit(name, obj):
            hash_obj.update(name.encode())
            for key in sorted(obj.attrs):
                hash_obj.update(key.encode())
                hash_obj.update(attr_bytes(obj.attrs[key]))
            if isinstance(obj, h5py.Dataset):
                hash_obj.update(str(obj.shape).encode())
                hash_obj.update(str(obj.dtype).encode())
                hash_obj.update(np.ascontiguousarray(obj[()]).tobytes())

        for key in sorted(f.attrs):
            hash_obj.update(key.encode())
            hash_obj.update(attr_bytes(f.attrs[key]))
        f.visititems(visit)
    return hash_obj.hexdigest()


def cleanup(older_than=24, interactive=False, only_current_session=False):
    """
    Remove temp-storage files of dead sessions older than `older_than` hours
    (reference io/utils.py:63). Non-interactive by default (the reference
    prompts; pass ``interactive=True`` for parity, but stdin-less runtimes
    get auto-deletion). With ``only_current_session=True`` only files created
    by THIS Python session are considered.

    Parameters
    ----------
    older_than : int or float
        Age threshold in hours for dead-session files.
    interactive : bool
        Prompt before deleting (reference parity); stdin-less runtimes
        auto-delete.
    only_current_session : bool
        Restrict to files created by this Python session.
    """
    from ..datatype.util import __sessionid__, live_session_ids, storage_dir

    if not isinstance(older_than, (int, float)):
        raise SPYTypeError(older_than, varname="older_than", expected="number of hours")
    sdir = storage_dir()
    if not os.path.isdir(sdir):
        return []
    # sessions with a live-process marker must never be reaped in a
    # dead-session sweep — neither THIS session nor any other process
    # sharing the storage dir (reference cleanup only targets sessions
    # that are gone, io/utils.py:63-120)
    live = live_session_ids(sdir) | {__sessionid__}
    now = time.time()
    removed = []
    for entry in os.listdir(sdir):
        path = os.path.join(sdir, entry)
        if entry.startswith(".session_"):
            continue  # liveness markers manage themselves
        try:
            age_h = (now - os.path.getmtime(path)) / 3600.0
        except OSError:
            continue
        if age_h < older_than:
            continue
        if only_current_session:
            if __sessionid__ not in entry:
                continue
        elif any(sess in entry for sess in live):
            continue
        if interactive:
            from ..shared.queries import user_yesno

            if not user_yesno("Remove {} (age {:.1f} h)?".format(path, age_h)):
                continue
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.unlink(path)
            removed.append(path)
        except OSError:
            pass
    if removed:
        SPYInfo("Removed {} stale session file(s)".format(len(removed)))
    return removed


def clear():
    """
    Flush this session's temp storage of files not referenced by any live
    object (reference io/utils.py:213).
    """
    import gc

    from ..datatype.base_data import BaseData
    from ..datatype.util import __sessionid__, storage_dir

    gc.collect()
    live = set()
    for obj in gc.get_objects():
        try:
            if isinstance(obj, BaseData) and obj._filename:
                live.add(os.path.abspath(obj._filename))
        except Exception:
            continue
    sdir = storage_dir()
    removed = []
    if os.path.isdir(sdir):
        # the session id that names this session's files (gen_session_filename)
        prefix = "spy_{}".format(__sessionid__)
        for entry in os.listdir(sdir):
            path = os.path.abspath(os.path.join(sdir, entry))
            if entry.startswith(prefix) and path not in live:
                try:
                    os.unlink(path)
                    removed.append(path)
                except OSError:
                    pass
    return removed
