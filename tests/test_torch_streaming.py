# -*- coding: utf-8 -*-
# The port's host-memory spill and out-of-memory recovery
# (engine/routine.py): a result over DEFAULT_HOST_BUDGET lands in a
# disk-backed h5py dataset (eagerly, or when a resident result is read
# back), round-trips through save and load, and never falls back to RAM
# without h5py; a chunk dispatch that runs out of device memory once
# empties the trial store, reads the residents back and runs again on the
# same device, while a second out-of-memory error and every other error
# propagate. Mirrors tests/test_streaming.py. Spilled results are held
# bitwise to the in-memory ones.

import sys

import h5py
import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import resident, routine
from syncopy_tpu_torch.engine.resident import DeferredArray
from syncopy_tpu_torch.preproc.compRoutines import ButFiltering
from syncopy_tpu_torch.shared.errors import SPYError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    previous = spt.set_device("cpu")
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)


@pytest.fixture()
def adata():
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(20 * 500, 8)).astype("f4")
    trl = np.zeros((20, 3))
    trl[:, 0] = np.arange(20) * 500
    trl[:, 1] = trl[:, 0] + 500
    return spt.from_arrays(arr, trl, 1000.0)


def _spec(data):
    return spt.freqanalysis(data, method="mtmfft", taper="hann")


@pytest.mark.parametrize("resident_on", [True, False])
def test_a_large_result_lands_in_an_hdf5_dataset(adata, monkeypatch, resident_on):
    ref = _spec(adata)
    monkeypatch.setattr(routine, "DEFAULT_HOST_BUDGET", 1024)  # 1 kB
    if not resident_on:
        monkeypatch.setattr(resident, "RESIDENT_BUDGET", 0)
    spec = _spec(adata)
    if resident_on:
        # resident until touched; the shape is free
        assert isinstance(spec._data, DeferredArray) and spec.data.shape[0] == 20
        # the first element access reads it back, into a dataset on disk
        assert np.asarray(spec.trials[0]).shape == (1, 1, 251, 8)
    assert isinstance(spec.data, h5py.Dataset) and spec._is_temp_file
    assert np.array_equal(spec.data[()], np.asarray(ref.data))


def test_a_spilled_read_back_releases_its_records(adata, monkeypatch):
    # a dataset on disk cannot be made read-only, so the records go: a
    # write into it cannot leave them stale
    monkeypatch.setattr(routine, "DEFAULT_HOST_BUDGET", 1024)
    spec = _spec(adata)
    res = spec._device_resident
    assert res.records is not None
    np.asarray(spec.data)
    assert isinstance(spec.data, h5py.Dataset) and res.records is None
    assert not res.consumable_by(spec)


def test_a_spilled_result_round_trips(adata, monkeypatch, tmp_path):
    monkeypatch.setattr(routine, "DEFAULT_HOST_BUDGET", 1024)
    spec = _spec(adata)
    spt.save(spec, container=str(tmp_path / "diskspec"))
    loaded = spt.load(str(tmp_path / "diskspec.spy"))
    assert loaded == spec
    monkeypatch.setattr(routine, "DEFAULT_HOST_BUDGET", 16 * 1024**3)
    assert np.array_equal(np.asarray(loaded.data), np.asarray(_spec(adata).data))


def test_a_spill_without_h5py_raises(adata, monkeypatch):
    monkeypatch.setattr(routine, "DEFAULT_HOST_BUDGET", 1024)
    monkeypatch.setattr(resident, "RESIDENT_BUDGET", 0)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py fails
    with pytest.raises(SPYError, match="h5py"):
        _spec(adata)


def test_an_averaged_result_over_the_budget_spills(adata, monkeypatch):
    ref = spt.freqanalysis(adata, method="mtmfft", taper="hann", keeptrials=False)
    monkeypatch.setattr(routine, "DEFAULT_HOST_BUDGET", 1024)
    avg = spt.freqanalysis(adata, method="mtmfft", taper="hann", keeptrials=False)
    assert isinstance(avg.data, h5py.Dataset)
    assert np.array_equal(avg.data[()], np.asarray(ref.data))


# ------------------------------------------------------------------------ #
# out-of-memory recovery
# ------------------------------------------------------------------------ #


def _failing_batches(monkeypatch, errors):
    """Make ButFiltering.process_batch raise the queued `errors` first."""
    original = ButFiltering.process_batch
    calls = []

    def process_batch(self, batch, **cfg):
        calls.append(batch.device)
        if errors:
            raise errors.pop(0)
        return original(self, batch, **cfg)

    monkeypatch.setattr(ButFiltering, "process_batch", process_batch)
    return calls


def _lowpass(data):
    return spt.preprocessing(data, filter_class="but", filter_type="lp", freq=100, order=4)


def test_out_of_memory_once_evicts_and_retries(adata, monkeypatch):
    ref = _lowpass(adata)
    routine.clear_device_cache()
    # a resident result, and its upload in the trial store
    earlier = _spec(adata)
    assert isinstance(earlier._data, DeferredArray) and routine._DEVICE_CACHE
    calls = _failing_batches(monkeypatch, [torch.OutOfMemoryError("synthetic")])
    out = _lowpass(adata)
    # the store was emptied and the earlier resident read back, then the
    # chunk ran again on the same device
    assert len(calls) == 2 and calls[0] == calls[1]
    assert earlier._device_resident.records is None
    assert isinstance(earlier._data, np.ndarray)
    assert np.array_equal(np.asarray(out.data), np.asarray(ref.data))


def test_a_second_out_of_memory_error_propagates(adata, monkeypatch):
    calls = _failing_batches(monkeypatch, [torch.OutOfMemoryError("first"),
                                           torch.OutOfMemoryError("second")])
    with pytest.raises(torch.OutOfMemoryError, match="second"):
        _lowpass(adata)
    assert len(calls) == 2


def test_other_errors_propagate_without_eviction(adata, monkeypatch):
    _spec(adata)
    assert routine._DEVICE_CACHE
    calls = _failing_batches(monkeypatch, [RuntimeError("not a memory error")])
    with pytest.raises(RuntimeError, match="not a memory error"):
        _lowpass(adata)
    assert len(calls) == 1 and routine._DEVICE_CACHE
