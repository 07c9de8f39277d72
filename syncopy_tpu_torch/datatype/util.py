# -*- coding: utf-8 -*-
#
# Storage-session runtime + lazy indexers.
#
# Parity target: reference syncopy/datatype/util.py:16-189 (TrialIndexer,
# TimeIndexer, setup_storage) and syncopy/__init__.py:112-135 (session
# storage dir). Redesign notes: objects default to in-memory numpy storage
# (TPU-native: host RAM is the staging area for HBM); disk backing via HDF5
# is opt-in/automatic for large data, so the tmp-storage dir is only used
# for disk-backed objects.

import os
import uuid

import numpy as np

from ..shared.errors import SPYTypeError, SPYValueError

__all__ = ["TrialIndexer", "TimeIndexer", "setup_storage", "get_dir_size"]

#: unique id of this Python session
__sessionid__ = uuid.uuid4().hex[:8]


def storage_dir():
    """Root dir for disk-backed temp objects ($SPYTMPDIR overrides)."""
    if os.environ.get("SPYTMPDIR"):
        return os.path.abspath(os.path.expanduser(os.environ["SPYTMPDIR"]))
    spydir = os.environ.get("SPYDIR", os.path.join(os.path.expanduser("~"), ".spy"))
    return os.path.join(spydir, "tpu_tmp_storage")


def setup_storage(storage_dir_path=None):
    """
    Create the session storage directory; returns ``(path, size_gb, n_files)``
    of pre-existing content (reference datatype/util.py:138).
    """
    sdir = storage_dir_path or storage_dir()
    os.makedirs(sdir, exist_ok=True)
    _ensure_session_marker(sdir)
    size, nfiles = get_dir_size(sdir, unit="GB")
    return sdir, size, nfiles


def _marker_name(sess, pid):
    return ".session_{}_{}".format(sess, pid)


def _ensure_session_marker(sdir):
    """Liveness marker for THIS session: cleanup sweeps in other processes
    must not reap a running session's temp files (the reference only
    targets sessions that are gone, io/utils.py:63)."""
    path = os.path.join(sdir, _marker_name(__sessionid__, os.getpid()))
    if not os.path.exists(path):
        try:
            with open(path, "w") as f:
                f.write(str(os.getpid()))
        except OSError:
            pass


def live_session_ids(sdir):
    """Session ids with a marker whose owning process is still alive;
    stale markers (dead pids) are removed along the way."""
    live = set()
    try:
        entries = os.listdir(sdir)
    except OSError:
        return live
    for entry in entries:
        if not entry.startswith(".session_"):
            continue
        parts = entry.split("_")
        if len(parts) != 3:
            continue
        sess, pid_s = parts[1], parts[2]
        try:
            os.kill(int(pid_s), 0)
            live.add(sess)
        except (ProcessLookupError, ValueError):
            try:
                os.unlink(os.path.join(sdir, entry))
            except OSError:
                pass
        except PermissionError:
            live.add(sess)  # pid exists, owned by someone else
    return live


def get_dir_size(start_path=".", unit="B"):
    """Recursively compute directory size (reference datatype/util.py:96)."""
    total = 0
    nfiles = 0
    for dirpath, _, filenames in os.walk(start_path):
        for fname in filenames:
            fp = os.path.join(dirpath, fname)
            try:
                if not os.path.islink(fp):
                    total += os.path.getsize(fp)
                    nfiles += 1
            except OSError:
                pass
    scales = {"B": 1, "KB": 1e3, "MB": 1e6, "GB": 1e9}
    key = str(unit).upper()
    if key not in scales:
        from ..shared.errors import SPYValueError

        raise SPYValueError(legal="one of " + str(sorted(scales)),
                            varname="unit", actual=str(unit))
    scale = scales[key]
    return total / scale if scale != 1 else total, nfiles


def gen_session_filename(extension):
    """Generate a unique filename inside the session storage dir."""
    sdir, _, _ = setup_storage()
    fname = "spy_{sess}_{rand}{ext}".format(
        sess=__sessionid__, rand=uuid.uuid4().hex[:8], ext=extension
    )
    return os.path.join(sdir, fname)


class TrialIndexer:
    """
    Lazy list-like access to single trials: ``data.trials[i]`` loads trial
    `i` as a numpy array (reference datatype/util.py:16).
    """

    def __init__(self, data_object, idx_list):
        self.data_object = data_object
        self.idx_list = list(idx_list)
        self._len = len(self.idx_list)

    def __getitem__(self, trialno):
        if not np.issubdtype(type(trialno), np.number):
            raise SPYTypeError(trialno, "trial index", "int")
        trialno = int(trialno)
        if trialno not in self.idx_list:
            raise SPYValueError(
                legal="index of existing trial {}".format(self.idx_list),
                varname="trialno",
                actual=str(trialno),
            )
        return self.data_object._get_trial(trialno)

    def __iter__(self):
        for i in self.idx_list:
            yield self.data_object._get_trial(i)

    def __len__(self):
        return self._len

    def __repr__(self):
        return "{} element iterable".format(self._len)


class TimeIndexer:
    """
    Lazy access to per-trial time axes: ``data.time[i]`` returns the time
    array (seconds) of trial `i` (reference datatype/util.py:61).

    `points` (optional) overrides the uniform reconstruction with explicit
    per-trial time points — used for outputs whose time axis is NOT
    uniformly sampled (e.g. mtmconvol at unevenly spaced `toi`); such
    outputs are time-locked, so one array serves every trial.
    """

    def __init__(self, trialdefinition, samplerate, idx_list, points=None):
        self.trialdefinition = trialdefinition
        self.samplerate = samplerate
        self.idx_list = list(idx_list)
        self._len = len(self.idx_list)
        self.points = None if points is None else np.asarray(points, dtype=float)

    def construct_time_array(self, trialno):
        if self.points is not None:
            return self.points.copy()
        start, stop, offset = self.trialdefinition[trialno, :3]
        return (np.arange(0, stop - start) + offset) / self.samplerate

    def __getitem__(self, trialno):
        if not np.issubdtype(type(trialno), np.number):
            raise SPYTypeError(trialno, "trial index", "int")
        trialno = int(trialno)
        if trialno not in self.idx_list:
            raise SPYValueError(
                legal="index of existing trial {}".format(self.idx_list),
                varname="trialno",
                actual=str(trialno),
            )
        return self.construct_time_array(trialno)

    def __iter__(self):
        for i in self.idx_list:
            yield self.construct_time_array(i)

    def __len__(self):
        return self._len

    def __repr__(self):
        return "{} element iterable".format(self._len)


def cleanup_session_storage():
    """Delete this session's temp files."""
    sdir = storage_dir()
    if not os.path.isdir(sdir):
        return
    for fname in os.listdir(sdir):
        if __sessionid__ in fname:
            try:
                os.unlink(os.path.join(sdir, fname))
            except OSError:
                pass
