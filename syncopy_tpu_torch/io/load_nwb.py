# -*- coding: utf-8 -*-
#
# load_nwb: import Neurodata-Without-Borders files.
#
# Parity target: reference syncopy/io/load_nwb.py:44-410. Reads NWB's HDF5
# layout directly via h5py (pynwb optional — used for validation only when
# installed):
#
# - ElectricalSeries (acquisition + processing modules) -> AnalogData, with
#   `memuse`-bounded block streaming into disk-backed HDF5 for large series
#   (reference :302-346), per-channel `channel_conversion` gains and
#   electrode-table channel labels (reference :326-362),
# - TTL-pulse series -> EventData (reference :254-295),
# - Units tables -> SpikeData with the samplerate taken from the recorded
#   series (reference :365-399),
# - intervals/trials (incl. `offset` column) and intervals/epochs ->
#   trialdefinitions (reference :220-237).

import os

import numpy as np

from ..shared.errors import SPYIOError, SPYValueError, SPYWarning

__all__ = ["load_nwb"]


def _series_rate(grp):
    if "starting_time" in grp and "rate" in grp["starting_time"].attrs:
        return float(grp["starting_time"].attrs["rate"])
    if "timestamps" in grp:
        ts = np.asarray(grp["timestamps"][:1000]).ravel()
        if ts.size > 1:
            return 1.0 / float(np.mean(np.diff(ts)))
    return None


def _channel_labels(f, grp, n_channels):
    """Channel names via the series' electrode-table region (reference
    load_nwb.py:348-362): discard when missing, mismatched, or all equal."""
    if "electrodes" not in grp:
        return None
    try:
        idx = np.asarray(grp["electrodes"]).ravel().astype(int)
        table = f.get("general/extracellular_ephys/electrodes")
        if table is None:
            return None
        for col in ("label", "location"):
            if col in table:
                raw = np.asarray(table[col])
                labels = [
                    v.decode() if isinstance(v, bytes) else str(v) for v in raw[idx]
                ]
                if len(labels) != n_channels:
                    SPYWarning(
                        "Found {} channel names for data with {} channels; "
                        "discarding channel names.".format(len(labels), n_channels)
                    )
                    return None
                if len(set(labels)) == 1 and len(labels) > 1:
                    continue  # all-equal (e.g. one location): not usable as names
                return labels
    except Exception:
        return None
    return None


def _is_ttl(name, grp):
    ndt = grp.attrs.get("neurodata_type", b"")
    ndt = ndt.decode() if isinstance(ndt, bytes) else str(ndt)
    return "TTL" in name.upper() or ndt == "TTLs"


def _stream_series(f, grp, conversion, gains, memuse_mb):
    """memuse-bounded ElectricalSeries import: copy sample blocks straight
    into a disk-backed AnalogData HDF5 dataset (reference :302-346)."""
    import h5py

    from ..datatype.continuous_data import AnalogData

    dset_in = grp["data"]
    shape = dset_in.shape if len(dset_in.shape) == 2 else (dset_in.shape[0], 1)
    adata = AnalogData(dimord=["time", "channel"])
    h5f = h5py.File(adata.filename, "w")
    dset = h5f.create_dataset("data", shape=shape, dtype=np.float32)
    n_block = max(1, int(memuse_mb * 1e6 / (shape[1] * 4)))
    for r0 in range(0, shape[0], n_block):
        blk = np.asarray(dset_in[r0 : r0 + n_block]).astype(np.float32)
        if blk.ndim == 1:
            blk = blk[:, None]
        blk *= conversion
        if gains is not None:
            blk *= gains[None, :]
        dset[r0 : r0 + blk.shape[0]] = blk
    adata._data = dset
    adata._hdfFile = h5f
    adata._is_temp_file = True
    return adata


def _validate_nwb(fpath):
    """
    Structural NWB 2.x validation (the reference shells out to
    ``python -m pynwb.validate``, load_nwb.py:37,88; pynwb is not a
    dependency here, so the schema invariants the reader relies on are
    checked directly with h5py). Raises SPYValueError on violations.
    """
    import h5py

    problems = []
    try:
        with h5py.File(fpath, "r") as f:
            ver = f.attrs.get("nwb_version", b"")
            ver = ver.decode() if isinstance(ver, bytes) else str(ver)
            if not ver.startswith("2"):
                problems.append("nwb_version missing or not 2.x (got {!r})".format(ver))
            for req in ("identifier", "session_description", "session_start_time"):
                if req not in f:
                    problems.append("required root dataset '{}' missing".format(req))
            acq = f.get("acquisition")
            if acq is not None and not isinstance(acq, h5py.Group):
                problems.append("/acquisition is not a group")
            for name, grp in (acq.items() if isinstance(acq, h5py.Group) else ()):
                if isinstance(grp, h5py.Group) and "data" in grp:
                    if "timestamps" not in grp and "starting_time" not in grp:
                        problems.append(
                            "series '{}' has neither timestamps nor starting_time".format(name)
                        )
            units = f.get("units")
            if isinstance(units, h5py.Group) and "spike_times" in units:
                if "spike_times_index" not in units:
                    problems.append("units table missing spike_times_index")
            elif units is not None and not isinstance(units, h5py.Group):
                problems.append("/units is not a group")
    except OSError as exc:
        # not an HDF5 file at all — exactly what validate= is for
        problems.append("not readable as HDF5 ({})".format(exc))
    if problems:
        raise SPYValueError(
            legal="valid NWB 2.x file", varname="filename",
            actual="; ".join(problems),
        )


def load_nwb(filename, memuse=3000, container=None, validate=False,
             default_spike_data_samplerate=None):
    """
    Read an NWB file. Returns a single data object or a dict of objects
    (one per acquisition series / processing module found). Series larger
    than `memuse` MB are streamed into disk-backed storage. With
    `container`, every loaded object is additionally saved into the given
    ``*.spy`` container folder (reference load_nwb.py:243-375); with
    `validate=True` the file's NWB 2.x structure is checked first.

    Parameters
    ----------
    filename : str
        Path to the ``.nwb`` file.
    memuse : int
        Host-RAM budget in MB; larger acquisitions stream to disk-backed
        HDF5 storage.
    container : str or None
        Optional ``*.spy`` container to additionally save every object to.
    validate : bool
        Check NWB 2.x structure before reading.
    default_spike_data_samplerate : float or None
        Samplerate for spike series that do not declare one.

    Returns
    -------
    A single data object, or a dict keyed by series name.
    """
    import h5py

    fpath = os.path.abspath(os.path.expanduser(str(filename)))
    if not os.path.isfile(fpath):
        raise SPYIOError(fpath, exists=False)
    if container is not None and not isinstance(container, str):
        # fail in milliseconds, not after a multi-GB streamed import
        from ..shared.errors import SPYTypeError

        raise SPYTypeError(container, varname="container", expected="str")
    if validate:
        _validate_nwb(fpath)

    from ..datatype.continuous_data import AnalogData
    from ..datatype.discrete_data import EventData, SpikeData

    objects = {}
    rates = []
    with h5py.File(fpath, "r") as f:
        # ElectricalSeries under /acquisition and /processing/*/*
        series_groups = []
        if "acquisition" in f:
            for name, grp in f["acquisition"].items():
                if isinstance(grp, h5py.Group) and "data" in grp:
                    series_groups.append((name, grp))
        if "processing" in f:
            for mod in f["processing"].values():
                if not isinstance(mod, h5py.Group):
                    continue
                for name, grp in mod.items():
                    if isinstance(grp, h5py.Group) and "data" in grp:
                        series_groups.append((name, grp))
                    elif isinstance(grp, h5py.Group):
                        for sub, sgrp in grp.items():
                            if isinstance(sgrp, h5py.Group) and "data" in sgrp:
                                series_groups.append((sub, sgrp))

        for name, grp in series_groups:
            rate = _series_rate(grp)

            if _is_ttl(name, grp):
                # TTL pulses -> EventData [sample, eventid] (reference :254-295)
                vals = np.asarray(grp["data"]).ravel().astype(int)
                if "timestamps" in grp:
                    ts = np.asarray(grp["timestamps"]).ravel()
                    res = float(grp["timestamps"].attrs.get("resolution", 0) or 0)
                    sr = 1.0 / res if res > 0 else (rate or 1000.0)
                    samples = np.round(ts * sr).astype(np.int64)
                else:
                    sr = rate or 1000.0
                    samples = np.arange(vals.size, dtype=np.int64)
                evt = EventData(
                    data=np.column_stack([samples, vals]).astype(np.int64),
                    samplerate=float(sr),
                )
                objects[name] = evt
                continue

            conversion = float(grp["data"].attrs.get("conversion", 1.0))
            gains = None
            if "channel_conversion" in grp:
                gains = np.asarray(grp["channel_conversion"]).ravel().astype(np.float32)
            n_chan = grp["data"].shape[1] if len(grp["data"].shape) == 2 else 1
            n_bytes = int(np.prod(grp["data"].shape)) * 4

            if n_bytes > memuse * 1e6:
                adata = _stream_series(f, grp, conversion, gains, memuse)
            else:
                data = np.asarray(grp["data"]).astype(np.float32)
                if data.ndim == 1:
                    data = data[:, None]
                data *= conversion
                if gains is not None:
                    data *= gains[None, :]
                adata = AnalogData(data=data)
            adata.samplerate = rate or 1.0
            if rate:
                rates.append(rate)
            labels = _channel_labels(f, grp, n_chan)
            if labels is not None:
                adata.channel = labels
            objects[name] = adata

        # Units table -> SpikeData (reference :365-399)
        if "units" in f and "spike_times" in f["units"]:
            st = np.asarray(f["units"]["spike_times"])
            idx = np.asarray(f["units"]["spike_times_index"])
            if "samplerate" in f["units"]:
                # syncopy extension column: exact spike-sample restoration
                # (reference load_nwb.py:385-393 reads the same column)
                sr = float(np.asarray(f["units"]["samplerate"]).ravel()[0])
            else:
                sr = default_spike_data_samplerate or (max(rates) if rates else 1000.0)
            rows = []
            prev = 0
            for unit_id, stop in enumerate(idx):
                times = st[prev:int(stop)]
                prev = int(stop)
                for t in times:
                    rows.append([int(round(t * sr)), 0, unit_id])
            if rows:
                arr = np.asarray(rows, dtype=np.int64)
                arr = arr[np.argsort(arr[:, 0], kind="stable")]
                sdata = SpikeData(data=arr, samplerate=sr)
                sdata.channel = ["channel0"]
                objects["units"] = sdata

        # trials table (preferred) or epochs (reference :220-237)
        trials_grp = f.get("intervals/trials", f.get("trials"))
        if trials_grp is None or "start_time" not in trials_grp:
            trials_grp = f.get("intervals/epochs", f.get("epochs"))
        if trials_grp is not None and "start_time" in trials_grp:
            starts = np.asarray(trials_grp["start_time"])
            stops = np.asarray(trials_grp["stop_time"])
            offs = (
                np.asarray(trials_grp["offset"])
                if "offset" in trials_grp
                else np.zeros(len(starts))
            )
            for obj in objects.values():
                sr = obj.samplerate
                trl = np.column_stack(
                    [np.round(starts * sr), np.round(stops * sr), np.round(offs * sr)]
                )
                nmax = obj.data.shape[0] if "sample" not in obj.dimord else None
                if nmax is not None:
                    trl[:, 1] = np.minimum(trl[:, 1], nmax)
                try:
                    obj.trialdefinition = trl
                except Exception:
                    pass

    if not objects:
        raise SPYValueError(
            legal="NWB file with ElectricalSeries or Units", varname="filename", actual=fpath
        )

    if container is not None:
        from .save_spy_container import save

        for name, obj in objects.items():
            save(obj, container=container, tag=name)

    if len(objects) == 1:
        return next(iter(objects.values()))
    return objects
