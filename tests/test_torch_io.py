# -*- coding: utf-8 -*-
# The port's io/ against syncopy_tpu on the CPU. Every .spy round trip is
# held bitwise (data, trialdefinition, labels, samplerate, info, cfg,
# attached datasets), for each data class and for computed results; a
# container written by either package loads in the other to the same
# object. FieldTrip (pre-7.3 and v7.3), TDT (.sev and .tsq/.tev blocks)
# and NWB files are built as tests/test_io.py builds them and read by both
# packages' loaders; NWB export and the MNE converters (through
# tests/mne_stub/ where mne is absent, as tests/test_mne_conv.py does) are
# held to the JAX package's results. Also: the port's clear() removes an
# orphaned session file, where the JAX package's removes nothing.

import os
import struct
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
from scipy.io import savemat

try:
    import mne  # noqa: F401
except ImportError:
    sys.path.insert(0, str(Path(__file__).parent / "mne_stub"))
    import mne  # noqa: F401

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
import test_io  # the file builders of the JAX package's io tests
from syncopy_tpu_torch.shared.errors import SPYIOError, SPYTypeError, SPYValueError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


FS = 500.0
LABELS = ("channel", "channel_i", "channel_j", "taper", "unit", "freq")
KINDS = ("analog", "spectral", "crossspectral", "timelock", "spike", "event")


def _arrays(kind, seed=0):
    """Constructor keywords of one data object of `kind`, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "analog":
        return dict(data=rng.normal(size=(600, 4)).astype("f4"), samplerate=FS,
                    trialdefinition=np.array([[0, 200, -50], [200, 400, 0], [400, 600, 10]], float),
                    channel=["ch{}".format(k) for k in range(4)])
    if kind == "spectral":
        spec = rng.normal(size=(3, 2, 17, 4)) + 1j * rng.normal(size=(3, 2, 17, 4))
        return dict(data=spec.astype("c8"), samplerate=FS,
                    trialdefinition=np.array([[0, 1, 0], [1, 2, 0], [2, 3, 0]], float),
                    freq=np.arange(17) * 2.0, taper=["dpss1", "dpss2"],
                    channel=["a", "b", "c", "d"])
    if kind == "crossspectral":
        csd = rng.normal(size=(2, 9, 3, 3)) + 1j * rng.normal(size=(2, 9, 3, 3))
        return dict(data=csd.astype("c8"), samplerate=FS,
                    trialdefinition=np.array([[0, 1, 0], [1, 2, 0]], float),
                    freq=np.linspace(0, 250, 9), channel_i=["x", "y", "z"],
                    channel_j=["x", "y", "z"])
    if kind == "timelock":
        return dict(data=rng.normal(size=(300, 3)).astype("f4"), samplerate=FS,
                    trialdefinition=np.array([[0, 150, -30], [150, 300, -30]], float),
                    channel=["e1", "e2", "e3"])
    if kind == "spike":
        n = 40
        data = np.column_stack([np.sort(rng.integers(0, 900, n)), rng.integers(0, 2, n),
                                rng.integers(0, 3, n)]).astype(int)
        return dict(data=data, samplerate=1000.0,
                    trialdefinition=np.array([[0, 300, -100], [300, 600, -100], [600, 900, -100]], float),
                    channel=["c0", "c1"], unit=["u0", "u1", "u2"])
    n = 12
    data = np.column_stack([np.sort(rng.integers(0, 900, n)), rng.integers(1, 5, n)]).astype(int)
    return dict(data=data, samplerate=1000.0,
                trialdefinition=np.array([[0, 450, 0], [450, 900, 0]], float))


_CLASS = {"analog": "AnalogData", "spectral": "SpectralData",
          "crossspectral": "CrossSpectralData", "timelock": "TimeLockData",
          "spike": "SpikeData", "event": "EventData"}


def _make(pkg, kind, seed=0):
    obj = getattr(pkg, _CLASS[kind])(**_arrays(kind, seed))
    obj.info = {"subject": "s{}".format(seed), "gain": [1.0, 2.5]}
    return obj


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _file_log(obj):
    """The log as stored in the file: without the entry load() appends."""
    return obj._log.rsplit("\n\n|===", 1)[0]


def _labels(obj):
    """The label and axis properties an object of its class has."""
    out = {}
    for name in LABELS:
        try:
            val = getattr(obj, name)
        except AttributeError:  # e.g. CrossSpectralData.channel
            continue
        if val is not None:
            out[name] = np.asarray(val).tolist()
    return out


def _assert_same_object(got, want, logs=False):
    assert type(got).__name__ == type(want).__name__
    assert list(got.dimord) == list(want.dimord)
    _bitwise(got.data, want.data)
    _bitwise(got.trialdefinition, want.trialdefinition)
    assert got.samplerate == want.samplerate
    assert _labels(got) == _labels(want)
    assert dict(got.info) == dict(want.info)
    assert dict(got.cfg) == dict(want.cfg)
    want_extra = {k: v for k, v in want._extra_datasets.items() if v is not None}
    assert sorted(k for k, v in got._extra_datasets.items() if v is not None) == sorted(want_extra)
    for name, arr in want_extra.items():
        _bitwise(got._extra_datasets[name], arr)
    if logs:
        assert _file_log(got) == _file_log(want)


def _close(*objs):
    for obj in objs:
        obj._close_hdf()


# ---------------------------------------------------------------------- #
# .spy containers
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", KINDS)
def test_container_round_trip_is_bitwise(kind, tmp_path):
    obj = _make(spt, kind)
    ref = _make(spt, kind)
    log = obj.log
    spt.save(obj, container=str(tmp_path / "c.spy"), tag=kind)
    back = spt.load(str(tmp_path / "c.spy"), tag=kind, checksum=True)
    assert isinstance(back.data, h5py.Dataset)
    _assert_same_object(back, ref)
    assert _file_log(back) == log
    _close(obj, back)


def _computed(kind):
    """Results of the port's frontends on one seeded AnalogData."""
    rng = np.random.default_rng(3)
    data = rng.normal(size=(4 * 250, 3)).astype("f4")
    trl = np.column_stack([np.arange(4) * 250, np.arange(1, 5) * 250, np.full(4, -25)]).astype(float)
    adata = spt.from_arrays(data, trl, FS)
    if kind == "coherence":
        return spt.connectivityanalysis(adata, method="coh", tapsmofrq=4)
    if kind == "fourier":
        return spt.freqanalysis(adata, method="mtmfft", tapsmofrq=4, output="fourier",
                                keeptapers=True)
    return spt.timelockanalysis(adata, covariance=True)


@pytest.mark.parametrize("kind", ["coherence", "fourier", "timelock"])
def test_computed_result_round_trip_is_bitwise(kind, tmp_path):
    out = _computed(kind)
    ref = out.copy()
    spt.save(out, filename=str(tmp_path / "res"))
    back = spt.load(out.filename, checksum=True)
    _assert_same_object(back, ref)
    _close(out, back)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_container_loads_in_the_port(kind, tmp_path):
    spy.save(_make(spy, kind), container=str(tmp_path / "j.spy"))
    got = spt.load(str(tmp_path / "j.spy"), checksum=True)
    want = spy.load(str(tmp_path / "j.spy"), checksum=True)
    assert type(got).__module__.startswith("syncopy_tpu_torch.")
    _assert_same_object(got, want, logs=True)
    _assert_same_object(got, _make(spt, kind))
    _close(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_port_container_loads_in_jax(kind, tmp_path):
    spt.save(_make(spt, kind), container=str(tmp_path / "p.spy"))
    got = spy.load(str(tmp_path / "p.spy"), checksum=True)
    want = spt.load(str(tmp_path / "p.spy"), checksum=True)
    assert type(got).__module__.startswith("syncopy_tpu.")
    _assert_same_object(got, want, logs=True)
    _close(got, want)


def test_multi_object_container_and_filters(tmp_path):
    c = str(tmp_path / "multi.spy")
    spt.save(_make(spt, "analog"), container=c, tag="raw")
    spt.save(_make(spt, "spike"), container=c, tag="units")
    both = spt.load(c)
    assert sorted(both) == ["multi_raw.analog", "multi_units.spike"]
    assert isinstance(spt.load(c, dataclass="SpikeData"), spt.SpikeData)
    assert isinstance(spt.load(c, tag="raw"), spt.AnalogData)
    _close(*both.values())


def test_save_refuses_then_overwrites(tmp_path):
    a = _make(spt, "analog")
    spt.save(a, filename=str(tmp_path / "x"))
    with pytest.raises(SPYIOError):
        spt.save(_make(spt, "analog", seed=1), filename=str(tmp_path / "x"))
    b = _make(spt, "analog", seed=1)
    spt.save(b, filename=str(tmp_path / "x"), overwrite=True)
    back = spt.load(str(tmp_path / "x.analog"))
    _bitwise(back.data, _arrays("analog", seed=1)["data"])
    with pytest.raises(SPYTypeError):
        spt.save(np.zeros(3), filename=str(tmp_path / "y"))


def test_checksum_mismatch_is_detected(tmp_path):
    a = _make(spt, "analog")
    spt.save(a, filename=str(tmp_path / "x"))
    fname = a.filename
    _close(a)
    with h5py.File(fname, "r+") as f:
        f["data"][0, 0] += 1.0
    with pytest.raises(SPYValueError, match="checksum"):
        spt.load(fname, checksum=True)


# ---------------------------------------------------------------------- #
# FieldTrip, TDT, NWB
# ---------------------------------------------------------------------- #


def test_fieldtrip_pre73_matches_jax(tmp_path):
    fname = str(tmp_path / "ft.mat")
    savemat(fname, {"data": test_io.TestFieldTrip()._mk_ft_struct()})
    _assert_same_object(spt.load_ft_raw(fname)["data"], spy.load_ft_raw(fname)["data"])
    assert spt.load_ft_raw(fname, list_only=True) == spy.load_ft_raw(fname, list_only=True)


@pytest.mark.parametrize("mem_use", [0.015, 4000])
def test_fieldtrip_v73_matches_jax(mem_use, tmp_path):
    fname = str(tmp_path / "ft73.mat")
    test_io.TestFieldTripStreaming()._write_v73(fname)
    got = spt.load_ft_raw(fname, mem_use=mem_use)["data"]
    want = spy.load_ft_raw(fname, mem_use=mem_use)["data"]
    assert isinstance(got.data, h5py.Dataset) == (mem_use < 1)
    _assert_same_object(got, want)


def test_tdt_sev_matches_jax(tmp_path):
    d = tmp_path / "block"
    d.mkdir()
    sig = np.sin(np.arange(1000) / 10).astype("f4")
    for ch in (1, 2):
        header = bytearray(40)
        header[24:25] = struct.pack("<B", 0)  # float32
        header[32:36] = struct.pack("<f", 1017.25)
        with open(d / "stream_ch{}.sev".format(ch), "wb") as f:
            f.write(bytes(header))
            (sig * ch).tofile(f)
    _assert_same_object(spt.load_tdt(str(d)), spy.load_tdt(str(d)))


@pytest.mark.parametrize("kwargs", [{}, {"stream": "EEGx"}, {"start_code": 23000, "end_code": 30020}])
def test_tdt_block_matches_jax(kwargs, tmp_path):
    d = tmp_path / "block"
    d.mkdir()
    test_io.TestTDTBlock()._write_multistore_block(d)
    _assert_same_object(spt.load_tdt(str(d), **kwargs), spy.load_tdt(str(d), **kwargs))


@pytest.mark.parametrize("memuse", [0.001, 3000])
def test_nwb_matches_jax(memuse, tmp_path):
    fname = str(tmp_path / "deep.nwb")
    test_io.TestNWBDepth()._write_nwb(fname)
    with h5py.File(fname, "a") as f:
        units = f.create_group("units")
        units.create_dataset("spike_times", data=np.array([0.01, 0.02, 0.05]))
        units.create_dataset("spike_times_index", data=np.array([2, 3]))
    got, want = spt.load_nwb(fname, memuse=memuse), spy.load_nwb(fname, memuse=memuse)
    assert sorted(got) == sorted(want) == ["ElectricalSeries", "TTL_pulses", "units"]
    for key in want:
        _assert_same_object(got[key], want[key])


def test_nwb_export_round_trip_matches_jax(tmp_path):
    kw = _arrays("analog")
    for pkg, name in ((spt, "port"), (spy, "jax")):
        obj = pkg.AnalogData(**kw)
        obj.save_nwb(str(tmp_path / (name + ".nwb")))
    got = spt.load_nwb(str(tmp_path / "port.nwb"))
    want = spy.load_nwb(str(tmp_path / "jax.nwb"))
    _assert_same_object(got, want)
    # the float32 payload through NWB's conversion, within float32 rounding
    np.testing.assert_allclose(np.asarray(got.data), kw["data"], rtol=1e-6, atol=1e-7)
    # each package reads the other's file to the same object
    _assert_same_object(spy.load_nwb(str(tmp_path / "port.nwb")), want)


def test_nwb_export_spikes_and_timelock_match_jax(tmp_path):
    for kind in ("spike", "timelock"):
        for pkg, name in ((spt, "port"), (spy, "jax")):
            _make(pkg, kind).save_nwb(str(tmp_path / "{}_{}.nwb".format(kind, name)))
        got = spt.load_nwb(str(tmp_path / "{}_port.nwb".format(kind)))
        want = spy.load_nwb(str(tmp_path / "{}_jax.nwb".format(kind)))
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for key in want:
                _assert_same_object(got[key], want[key])
        else:
            _assert_same_object(got, want)


# ---------------------------------------------------------------------- #
# MNE
# ---------------------------------------------------------------------- #


def test_mne_raw_round_trip_matches_jax():
    kw = _arrays("analog")
    kw["trialdefinition"] = np.array([[0, 600, 100]], float)
    raws = [pkg.raw_adata_to_mne_raw(pkg.AnalogData(**kw)) for pkg in (spt, spy)]
    np.testing.assert_array_equal(raws[0].get_data(), raws[1].get_data())
    assert raws[0].ch_names == raws[1].ch_names and raws[0].first_samp == raws[1].first_samp == 100
    _assert_same_object(spt.raw_mne_to_adata(raws[0]), spy.raw_mne_to_adata(raws[1]))


def test_mne_epochs_round_trip_matches_jax():
    kw = _arrays("timelock")
    eps = [pkg.tldata_to_mne_epochs(pkg.AnalogData(**kw)) for pkg in (spt, spy)]
    np.testing.assert_array_equal(eps[0].get_data(), eps[1].get_data())
    assert eps[0].tmin == eps[1].tmin
    _assert_same_object(spt.mne_epochs_to_tldata(eps[0]), spy.mne_epochs_to_tldata(eps[1]))
    with pytest.raises(SPYTypeError):
        spt.raw_adata_to_mne_raw(np.zeros((10, 2)))


# ---------------------------------------------------------------------- #
# session storage: clear()
# ---------------------------------------------------------------------- #


def _orphan(util):
    """A session file no live object references (what a crashed
    computation leaves behind), named as the package names its files."""
    fname = util.gen_session_filename(".analog")
    with h5py.File(fname, "w") as f:
        f.create_dataset("data", data=np.zeros((4, 2), "f4"))
    return fname


def test_clear_removes_orphaned_session_files(tmp_path, monkeypatch):
    from syncopy_tpu_torch.datatype import util

    monkeypatch.setenv("SPYTMPDIR", str(tmp_path))
    live = spt.AnalogData(data=np.zeros((50, 2), dtype="f4"), samplerate=50)
    live_name = live.to_hdf()
    orphan = _orphan(util)
    assert os.path.basename(orphan).startswith("spy_" + spt.__sessionid__)
    removed = spt.clear()
    assert removed == [os.path.abspath(orphan)]
    assert not os.path.exists(orphan)
    assert os.path.exists(live_name)
    np.testing.assert_array_equal(np.asarray(live.data), 0)
    del live


def test_jax_clear_uses_a_second_session_id(tmp_path, monkeypatch):
    """syncopy_tpu.clear() builds its prefix from syncopy_tpu.__sessionid__
    (syncopy_tpu/io/utils.py:142,155), but files are named with
    syncopy_tpu.datatype.util.__sessionid__ (datatype/util.py:22, :118): two
    different ids, so it never removes an orphaned session file. Recorded
    as it stands; the port names and clears with one id."""
    from syncopy_tpu.datatype import util

    monkeypatch.setenv("SPYTMPDIR", str(tmp_path))
    assert spy.__sessionid__ != util.__sessionid__
    orphan = _orphan(util)
    assert spy.clear() == []
    assert os.path.exists(orphan)
    assert spt.__sessionid__ is spt.datatype.util.__sessionid__
