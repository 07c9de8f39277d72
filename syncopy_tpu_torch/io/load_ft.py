# -*- coding: utf-8 -*-
#
# load_ft_raw: import MATLAB/FieldTrip ft_datatype_raw structures.
#
# Parity target: reference syncopy/io/load_ft.py:24-552 (MAT v7.3 via h5py
# streaming; pre-7.3 via scipy.io.loadmat).

import os

import numpy as np

from ..shared.errors import SPYIOError, SPYWarning

__all__ = ["load_ft_raw"]


def load_ft_raw(filename, list_only=False, select_structures=None, include_fields=None, mem_use=4000):
    """
    Read FieldTrip ``ft_datatype_raw`` struct(s) from a ``.mat`` file into
    :class:`~syncopy_tpu.AnalogData` object(s).

    `mem_use` is the host-RAM budget in MB (reference load_ft.py:211-366):
    MAT v7.3 structs whose total payload exceeds it are STREAMED trial by
    trial into a disk-backed HDF5 dataset — the full recording is never in
    RAM (a single trial must still fit: <= 0.4 * `mem_use`). Smaller
    structs load in-memory. Pre-7.3 files go through scipy and always load
    in-memory (the format is not chunkable).

    Parameters
    ----------
    filename : str
        ``.mat`` file (v7.3 HDF5-based or pre-7.3).
    list_only : bool
        Only list the struct names found, load nothing.
    select_structures : sequence of str or None
        Restrict loading to these struct names.
    include_fields : sequence of str or None
        Extra struct fields to attach to ``.info`` (e.g. "cfg").
    mem_use : int
        Host-RAM budget in MB (streaming rule above).

    Returns a dict mapping struct name -> AnalogData (fields beyond
    trial/time/label/fsample/trialinfo are attached to ``.info`` when listed
    in `include_fields`). With ``list_only=True``, just the struct names.
    """
    fpath = os.path.abspath(os.path.expanduser(str(filename)))
    if not os.path.isfile(fpath):
        raise SPYIOError(fpath, exists=False)

    try:
        import h5py

        with h5py.File(fpath, "r") as f:
            is_v73 = True
            names = [k for k in f.keys() if not k.startswith("#")]
    except OSError:
        is_v73 = False
        names = None

    if is_v73:
        return _load_v73(fpath, names, list_only, select_structures, include_fields, mem_use)
    return _load_pre73(fpath, list_only, select_structures, include_fields)


def _struct_to_adata(trials, times, labels, fsample, trialinfo=None):
    from ..datatype.continuous_data import AnalogData

    arrs = []
    offsets = []
    for trl, tvec in zip(trials, times):
        arr = np.asarray(trl)
        # FieldTrip stores trials as [channel x time]; syncopy is [time x channel]
        if arr.shape[0] == len(labels) and (arr.ndim == 2):
            arr = arr.T
        arrs.append(arr.astype(np.float32, copy=False))
        offsets.append(int(round(float(np.asarray(tvec).ravel()[0]) * fsample)))

    adata = AnalogData(data=arrs, samplerate=float(fsample))
    trl = adata.trialdefinition
    trl[:, 2] = offsets
    if trialinfo is not None and np.asarray(trialinfo).size:
        ti = np.atleast_2d(np.asarray(trialinfo, dtype=float))
        if ti.shape[0] != trl.shape[0] and ti.shape[1] == trl.shape[0]:
            ti = ti.T
        if ti.shape[0] == trl.shape[0]:
            trl = np.hstack([trl, ti])
    adata.trialdefinition = trl
    adata.channel = [str(l) for l in labels]
    return adata


def _load_v73(fpath, names, list_only, select_structures, include_fields, mem_use=4000):
    import h5py

    if list_only:
        return names
    if select_structures is not None:
        names = [n for n in names if n in select_structures]
    out = {}
    with h5py.File(fpath, "r") as f:
        for name in names:
            grp = f[name]
            if not all(k in grp for k in ("trial", "time", "label")):
                SPYWarning("skipping '{}': not an ft_datatype_raw struct".format(name))
                continue

            labels = []
            for r in np.asarray(grp["label"]).ravel():
                raw = np.asarray(f[r]).ravel()
                labels.append("".join(chr(int(c)) for c in raw))

            trial_refs = np.asarray(grp["trial"]).ravel()
            time_refs = np.asarray(grp["time"]).ravel()

            # shape census WITHOUT reading payloads (h5py datasets expose
            # .shape lazily) — decides in-RAM vs disk-backed streaming
            trl_shapes = [f[r].shape for r in trial_refs]
            itemsize = f[trial_refs[0]].dtype.itemsize
            total_mb = sum(int(np.prod(s)) for s in trl_shapes) * itemsize / 1e6
            max_trl_mb = max(int(np.prod(s)) for s in trl_shapes) * itemsize / 1e6
            if max_trl_mb >= 0.4 * mem_use:
                from ..shared.errors import SPYValueError

                raise SPYValueError(
                    legal="{:.1f} or more MB (one trial must fit in 40% of "
                          "the budget)".format(2.5 * max_trl_mb),
                    varname="mem_use", actual=str(mem_use),
                )

            # offsets from the first time sample only (never the full vector)
            offsets = [float(np.asarray(f[r][tuple([0] * f[r].ndim)])) for r in time_refs]
            if "fsample" in grp:
                fsample = float(np.asarray(grp["fsample"]).ravel()[0])
            else:
                tv0 = np.asarray(f[time_refs[0]]).ravel()
                fsample = 1.0 / float(np.mean(np.diff(tv0)))
            trialinfo = np.asarray(grp["trialinfo"]).T if "trialinfo" in grp else None

            if total_mb > mem_use:
                adata = _stream_trials_to_hdf5(f, trial_refs, trl_shapes, labels, fsample)
            else:
                raw_trials = [np.asarray(f[r]) for r in trial_refs]
                # MATLAB HDF5 stores [chan x time] transposed on disk as
                # [time x chan]; undo so _struct_to_adata's FT-layout
                # heuristic applies uniformly
                trials = [t.T for t in raw_trials]
                times = [np.full(1, off) for off in offsets]
                adata = _struct_to_adata(trials, times, labels, fsample, None)

            trl = adata.trialdefinition
            trl[:, 2] = np.rint(np.asarray(offsets) * fsample)
            if trialinfo is not None and np.asarray(trialinfo).size:
                ti = np.atleast_2d(np.asarray(trialinfo, dtype=float))
                if ti.shape[0] != trl.shape[0] and ti.shape[1] == trl.shape[0]:
                    ti = ti.T
                if ti.shape[0] == trl.shape[0]:
                    trl = np.hstack([trl, ti])
            adata.trialdefinition = trl

            if include_fields:
                for fld in include_fields:
                    if fld in grp:
                        try:
                            adata.info[fld] = np.asarray(grp[fld]).tolist()
                        except Exception:
                            pass
            adata.log = "loaded struct '{}' from MAT v7.3 file {} ({})".format(
                name, fpath, "streamed to HDF5" if total_mb > mem_use else "in-memory"
            )
            out[name] = adata
    return out


def _stream_trials_to_hdf5(f, trial_refs, trl_shapes, labels, fsample):
    """Memory-bounded v7.3 import: copy each trial's stored [time x chan]
    block straight into a disk-backed AnalogData HDF5 dataset (reference
    load_ft.py:280-300) — peak RAM is one trial."""
    import h5py

    from ..datatype.continuous_data import AnalogData

    # stored layout is [time x chan] (MATLAB transposes [chan x time] on
    # write); detect channel-major storage via the label count
    time_major = trl_shapes[0][1] == len(labels)
    n_chan = len(labels)
    trl_samples = [s[0] if time_major else s[1] for s in trl_shapes]
    bounds = np.concatenate([[0], np.cumsum(trl_samples)]).astype(int)

    adata = AnalogData(dimord=["time", "channel"])
    h5f = h5py.File(adata.filename, "w")
    dset = h5f.create_dataset("data", shape=(int(bounds[-1]), n_chan), dtype=np.float32)
    for k, ref in enumerate(trial_refs):
        block = f[ref]
        arr = np.asarray(block, dtype=np.float32)
        if not time_major:
            arr = arr.T
        dset[bounds[k] : bounds[k + 1]] = arr
    adata._data = dset
    adata._hdfFile = h5f
    adata._is_temp_file = True
    adata.trialdefinition = np.column_stack(
        [bounds[:-1], bounds[1:], np.zeros(len(trial_refs))]
    )
    adata.samplerate = float(fsample)
    adata.channel = [str(l) for l in labels]
    return adata


def _load_pre73(fpath, list_only, select_structures, include_fields):
    from scipy.io import loadmat

    mat = loadmat(fpath, squeeze_me=True, struct_as_record=False)
    names = [k for k in mat.keys() if not k.startswith("__")]
    if list_only:
        return names
    if select_structures is not None:
        names = [n for n in names if n in select_structures]
    out = {}
    for name in names:
        st = mat[name]
        if not hasattr(st, "trial") or not hasattr(st, "label"):
            SPYWarning("skipping '{}': not an ft_datatype_raw struct".format(name))
            continue
        trials = st.trial if isinstance(st.trial, (list, np.ndarray)) else [st.trial]
        if isinstance(trials, np.ndarray) and trials.dtype == object:
            trials = list(trials)
        elif isinstance(trials, np.ndarray) and trials.ndim == 2:
            trials = [trials]
        times = st.time if isinstance(st.time, (list, np.ndarray)) else [st.time]
        if isinstance(times, np.ndarray) and times.dtype == object:
            times = list(times)
        elif isinstance(times, np.ndarray) and times.ndim == 1:
            times = [times]
        labels = [str(l) for l in np.atleast_1d(st.label)]
        fsample = float(getattr(st, "fsample", 1.0 / float(np.mean(np.diff(np.asarray(times[0]).ravel())))))
        trialinfo = getattr(st, "trialinfo", None)
        adata = _struct_to_adata(trials, times, labels, fsample, trialinfo)
        if include_fields:
            for fld in include_fields:
                if hasattr(st, fld):
                    try:
                        adata.info[fld] = np.asarray(getattr(st, fld)).tolist()
                    except Exception:
                        pass
        out[name] = adata
    return out
