# -*- coding: utf-8 -*-
#
# NWB export: write AnalogData / TimeLockData / SpikeData to NWB files.
#
# Parity target: reference syncopy/io/nwb.py:40-329. The reference requires
# pynwb; this writer emits the NWB 2.x on-disk HDF5 schema DIRECTLY via
# h5py — same metadata depth (device + electrode group/location tables,
# processing-module placement for derived data, units with per-unit
# location/group/samplerate and waveform means) with no optional
# dependency. When pynwb happens to be installed the produced files load
# through it unchanged; they always roundtrip through ``load_nwb``.
#
# Layout written (NWB 2.x):
#   /                          NWBFile (namespace=core)
#   /general/devices/array                     Device
#   /general/extracellular_ephys/shank0        ElectrodeGroup (+device link)
#   /general/extracellular_ephys/electrodes    DynamicTable (x,y,z,imp,
#                                              location,filtering,group,
#                                              group_name,label)
#   /acquisition/<name>        ElectricalSeries        (raw data)
#   /processing/ecephys/LFP/<name>  ElectricalSeries   (derived data)
#   /intervals/trials          TimeIntervals (start,stop,offset)
#   /intervals/epochs          TimeIntervals (start,stop,tags)
#   /units                     Units (spike_times+index, electrodes,
#                              location, group, samplerate[, waveform_mean])

from datetime import datetime, timezone
from uuid import uuid4

import numpy as np

from ..shared.errors import SPYError, SPYValueError

__all__ = ["_analog_to_nwb", "_timelock_to_nwb", "_spike_to_nwb"]

_STR = None  # lazy h5py string dtype


def _str_dt():
    import h5py

    global _STR
    if _STR is None:
        _STR = h5py.string_dtype(encoding="utf-8")
    return _STR


def _set_type(obj, neurodata_type, namespace="core"):
    obj.attrs["neurodata_type"] = neurodata_type
    obj.attrs["namespace"] = namespace
    obj.attrs["object_id"] = str(uuid4())


def _vector(table, name, values, description, dtype=None):
    """Add a VectorData column dataset to a DynamicTable group."""
    if dtype is None and len(values) and isinstance(values[0], str):
        dtype = _str_dt()
    dset = table.create_dataset(name, data=np.asarray(values, dtype=dtype))
    dset.attrs["description"] = description
    _set_type(dset, "VectorData", "hdmf-common")
    return dset


def _dyn_table(parent, name, description, neurodata_type="DynamicTable",
               namespace="hdmf-common"):
    tbl = parent.create_group(name)
    tbl.attrs["description"] = description
    tbl.attrs["colnames"] = np.asarray([], dtype=_str_dt())
    _set_type(tbl, neurodata_type, namespace)
    return tbl


def _finish_table(tbl, n_rows, colnames):
    ids = tbl.create_dataset("id", data=np.arange(n_rows, dtype=np.int64))
    _set_type(ids, "ElementIdentifiers", "hdmf-common")
    tbl.attrs["colnames"] = np.asarray(colnames, dtype=_str_dt())


def _init_nwbfile(f):
    """Root NWBFile structure + required metadata (reference nwb.py:40-74
    fills the same fields with 'unknown' placeholders)."""
    _set_type(f["/"], "NWBFile")
    f.attrs["nwb_version"] = "2.5.0"
    now = datetime.now(timezone.utc).isoformat()
    f.create_dataset("file_create_date", data=np.asarray([now], dtype=_str_dt()))
    f.create_dataset("identifier", data=str(uuid4()), dtype=_str_dt())
    f.create_dataset("session_description", data="syncopy_tpu export", dtype=_str_dt())
    f.create_dataset("session_start_time", data=now, dtype=_str_dt())
    f.create_dataset("timestamps_reference_time", data=now, dtype=_str_dt())
    for grp in ("acquisition", "analysis", "processing", "stimulus/presentation",
                "stimulus/templates", "general"):
        f.require_group(grp)
    g = f["general"]
    for name, val in (("experimenter", ["unknown"]), ("institution", "unknown"),
                      ("lab", "unknown"), ("session_id", "session_0001")):
        if isinstance(val, list):
            g.create_dataset(name, data=np.asarray(val, dtype=_str_dt()))
        else:
            g.create_dataset(name, data=val, dtype=_str_dt())


def _add_electrodes(f, labels):
    """Device + electrode group + full electrode DynamicTable (reference
    _add_electrodes, nwb.py:76-135: one device, one shank group, per-
    electrode x/y/z/imp/filtering/location/label columns)."""
    device = f.require_group("general/devices").create_group("array")
    device.attrs["description"] = "Unknown array"
    device.attrs["manufacturer"] = "Unknown manufacturer"
    _set_type(device, "Device")

    ephys = f.require_group("general/extracellular_ephys")
    shank = ephys.create_group("shank0")
    shank.attrs["description"] = "electrode group for shank 0"
    shank.attrs["location"] = "unknown brain area"
    _set_type(shank, "ElectrodeGroup")
    shank["device"] = device  # hard link, as pynwb writes it

    n = len(labels)
    tbl = _dyn_table(ephys, "electrodes", "metadata about extracellular electrodes")
    _vector(tbl, "x", np.zeros(n), "x coordinate")
    _vector(tbl, "y", np.zeros(n), "y coordinate")
    _vector(tbl, "z", np.zeros(n), "z coordinate")
    _vector(tbl, "imp", np.full(n, np.nan), "impedance")
    _vector(tbl, "filtering", ["unknown"] * n, "hardware filtering")
    # reference stores the channel NAME in `location` and a synthetic
    # shank label in `label` (nwb.py:120-128); the importer prefers
    # `label`, so put the channel names there and keep `location` too
    _vector(tbl, "location", [str(c) for c in labels], "channel location")
    _vector(tbl, "label", [str(c) for c in labels], "label of electrode")
    _vector(tbl, "group_name", ["shank0"] * n, "electrode group name")
    import h5py

    grp_refs = tbl.create_dataset(
        "group", data=np.asarray([shank.ref] * n, dtype=h5py.ref_dtype)
    )
    grp_refs.attrs["description"] = "electrode group reference"
    _set_type(grp_refs, "VectorData", "hdmf-common")
    _finish_table(tbl, n, ["x", "y", "z", "imp", "filtering", "location",
                           "label", "group_name", "group"])
    return tbl


def _region(series, table, indices, description="all electrodes"):
    dset = series.create_dataset("electrodes", data=np.asarray(indices, dtype=np.int64))
    dset.attrs["description"] = description
    dset.attrs["table"] = table.ref
    _set_type(dset, "DynamicTableRegion", "hdmf-common")


def _electrical_series(parent, name, data, rate, table, description,
                       n_channels, comments="Exported by syncopy_tpu"):
    series = parent.create_group(name)
    series.attrs["description"] = description
    series.attrs["comments"] = comments
    _set_type(series, "ElectricalSeries")
    d = series.create_dataset("data", data=np.asarray(data))
    d.attrs["unit"] = "volts"
    d.attrs["conversion"] = 1.0
    d.attrs["resolution"] = -1.0
    st = series.create_dataset("starting_time", data=0.0)
    st.attrs["rate"] = float(rate)
    st.attrs["unit"] = "seconds"
    # region size = electrode-table rows (NOT a data axis: non-default
    # dimords put time on axis 1)
    _region(series, table, list(range(n_channels)))
    return series


def _add_intervals(f, trialdefinition, samplerate, save_as="both"):
    """Trials (+offset column, a syncopy extension the importer restores)
    and epochs tables (reference _add_trials_to_nwbfile, nwb.py:212-246)."""
    if trialdefinition is None:
        return
    trl = np.asarray(trialdefinition, dtype=np.float64) / float(samplerate)
    iv = f.require_group("intervals")
    if save_as in ("both", "trials"):
        tbl = _dyn_table(iv, "trials", "experimental trials",
                         neurodata_type="TimeIntervals", namespace="core")
        _vector(tbl, "start_time", trl[:, 0], "start of trial (s)")
        _vector(tbl, "stop_time", trl[:, 1], "end of trial (s)")
        _vector(tbl, "offset", trl[:, 2], "trigger offset of the trial (s)")
        _finish_table(tbl, trl.shape[0], ["start_time", "stop_time", "offset"])
    if save_as in ("both", "epochs"):
        tbl = _dyn_table(iv, "epochs", "experimental epochs",
                         neurodata_type="TimeIntervals", namespace="core")
        _vector(tbl, "start_time", trl[:, 0], "start of epoch (s)")
        _vector(tbl, "stop_time", trl[:, 1], "end of epoch (s)")
        tags = _vector(tbl, "tags",
                       ["trial {}".format(i) for i in range(trl.shape[0])],
                       "user-defined tags")
        idx = tbl.create_dataset(
            "tags_index", data=np.arange(1, trl.shape[0] + 1, dtype=np.uint64)
        )
        idx.attrs["target"] = tags.ref
        _set_type(idx, "VectorIndex", "hdmf-common")
        _finish_table(tbl, trl.shape[0], ["start_time", "stop_time", "tags"])


def _analog_to_nwb(adata, outpath, nwbfile=None, with_trialdefinition=True,
                   is_raw=True, elec_series_name="ElectricalSeries"):
    """AnalogData/TimeLockData -> NWB (reference
    _analog_timelocked_to_nwbfile, nwb.py:140-210): raw data lands in
    /acquisition, derived data in an LFP container inside the 'ecephys'
    processing module."""
    import h5py

    if nwbfile is not None:
        raise SPYValueError(
            legal="None (the h5py-based exporter writes a fresh file)",
            varname="nwbfile", actual=str(type(nwbfile)),
        )
    if adata.data is None:
        raise SPYError("cannot export empty object to NWB")
    labels = [str(c) for c in np.asarray(adata.channel)]
    with h5py.File(str(outpath), "w") as f:
        _init_nwbfile(f)
        table = _add_electrodes(f, labels)
        if is_raw:
            parent = f["acquisition"]
        else:
            # derived (preprocessed) data: LFP container inside the
            # 'ecephys' processing module (reference nwb.py:201-204)
            module = f["processing"].create_group("ecephys")
            module.attrs["description"] = str(adata._log)[-512:] or "derived data"
            _set_type(module, "ProcessingModule")
            parent = module.create_group("LFP")
            _set_type(parent, "LFP")
        _electrical_series(
            parent, elec_series_name, np.asarray(adata.data),
            adata.samplerate or 1.0, table, "Electrical time series dataset",
            n_channels=len(labels),
        )
        if with_trialdefinition:
            _add_intervals(f, adata.trialdefinition, adata.samplerate or 1.0)
    return str(outpath)


def _timelock_to_nwb(tldata, outpath, with_trialdefinition=True, is_raw=False):
    # reference continuous_data.py:965 defaults is_raw=True for the kwarg
    # but time-locked averages are derived data — both placements supported
    return _analog_to_nwb(tldata, outpath,
                          with_trialdefinition=with_trialdefinition, is_raw=is_raw)


def _spike_to_nwb(sdata, outpath, nwbfile=None, with_trialdefinition=True,
                  unit_info=None):
    """SpikeData -> NWB Units table (reference _spikedata_to_nwbfile,
    nwb.py:249-329): per-unit spike times (seconds), location/group
    metadata, the samplerate column the importer uses to restore sample
    indices, and waveform means when a waveform dataset is attached."""
    import h5py

    if nwbfile is not None:
        raise SPYValueError(
            legal="None (the h5py-based exporter writes a fresh file)",
            varname="nwbfile", actual=str(type(nwbfile)),
        )
    sr = float(sdata.samplerate or 1.0)
    data = np.asarray(sdata.data)
    ucol = sdata.dimord.index("unit")
    scol = sdata.dimord.index("sample")
    unit_ids = np.unique(data[:, ucol])
    if unit_info is None:
        unit_info = {}
    elif not isinstance(unit_info, dict):
        raise SPYValueError(
            legal="dict with optional 'location'/'group' sub-dicts",
            varname="unit_info", actual=str(type(unit_info)),
        )
    # partial dicts are fine: missing keys default to 'unknown' per unit
    locations_map = unit_info.get("location", {})
    groups_map = unit_info.get("group", {})

    waveform = sdata._get_extra_dataset("waveform") if hasattr(sdata, "_get_extra_dataset") else None
    if waveform is not None:
        # materialize ONCE — per-unit fancy reads of an HDF5-backed
        # waveform dataset would re-read the full payload per unit
        waveform = np.asarray(waveform)

    with h5py.File(str(outpath), "w") as f:
        _init_nwbfile(f)
        table = _add_electrodes(f, [str(c) for c in np.asarray(sdata.channel)]
                                if sdata.channel is not None else ["channel0"])
        units = _dyn_table(f["/"], "units", "Autogenerated by syncopy_tpu",
                           neurodata_type="Units", namespace="core")
        all_times, index, wf_means = [], [], []
        locations, groups = [], []
        for uid in unit_ids:
            rows = data[:, ucol] == uid
            times = np.sort(data[rows, scol]).astype(np.float64) / sr
            all_times.extend(times.tolist())
            index.append(len(all_times))
            locations.append(str(locations_map.get(uid, "unknown")))
            groups.append(str(groups_map.get(uid, "unknown")))
            if waveform is not None:
                wf_means.append(waveform[rows].mean(axis=0))
        st = _vector(units, "spike_times", np.asarray(all_times, dtype=np.float64),
                     "observed spike times (s)")
        sti = units.create_dataset(
            "spike_times_index", data=np.asarray(index, dtype=np.uint64)
        )
        sti.attrs["target"] = st.ref
        _set_type(sti, "VectorIndex", "hdmf-common")
        _vector(units, "location", locations, "the anatomical location of this unit")
        _vector(units, "group", groups, "the group of the unit")
        _vector(units, "samplerate", np.full(len(unit_ids), sr),
                "the samplerate of the unit (same as the data's)")
        cols = ["spike_times", "location", "group", "samplerate"]
        if wf_means:
            _vector(units, "waveform_mean", np.stack(wf_means, axis=0),
                    "per-unit mean spike waveform")
            cols.append("waveform_mean")
        ids = units.create_dataset("id", data=np.asarray(unit_ids, dtype=np.int64))
        _set_type(ids, "ElementIdentifiers", "hdmf-common")
        units.attrs["colnames"] = np.asarray(cols, dtype=_str_dt())
        _region(units, table, [0] * len(unit_ids), "electrode of each unit")
        if with_trialdefinition:
            _add_intervals(f, sdata.trialdefinition, sr)
    return str(outpath)
