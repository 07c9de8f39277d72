# -*- coding: utf-8 -*-
# The engine's per-call plan (engine/routine.py::initialize,
# datatype/selector.py::Selector): whole trials of continuous data are
# planned from arrays (the trial lengths in sampleinfo, one indexer for
# all trials), a latency window or discrete data one trial at a time.
# Each case holds the plan to the same quantities computed here by a
# plain loop over the selected trials: the buckets (shapes, order of
# first appearance, positions), the output shapes per bucket and per
# trial, the output shape, the selected trialdefinition (values and
# dtype), the time indexers and the host-gather plan; plan_counts() says
# which path ran. A structural check counts the per-trial helpers one
# coherence call over 1000 trials runs: a few, not one per trial.

import collections

import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from syncopy_tpu_torch.datatype.selector import Selector
from syncopy_tpu_torch.engine import routine

torch.set_num_threads(1)

FS = 1000.0


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    previous = spt.set_device("cpu")
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)


class _Halve(routine.ComputationalRoutine):
    """A trial (n, ...) to (n // 2, ...): the output's stacking extent
    follows the trial's."""

    def output_trial_shape(self, trial_shape):
        return (trial_shape[0] // 2,) + tuple(trial_shape[1:]), np.dtype(np.float32)


def _analog(lens, n_chan=3, extra_cols=0, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(int(np.sum(lens)), n_chan)).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    trl = np.zeros((len(lens), 3 + extra_cols))
    trl[:, 0], trl[:, 1] = bounds[:-1], bounds[1:]
    trl[:, 2] = -np.arange(len(lens)) * 3
    trl[:, 3:] = rng.integers(0, 9, size=(len(lens), extra_cols))
    return data, trl


def _from_arrays(lens, **kw):
    data, trl = _analog(lens, **kw)
    return spt.from_arrays(data, trl, FS)


#: three trial lengths interleaved, first seen in the order 50, 40, 60
RAGGED = [50, 40, 60, 40, 50, 60, 60, 40, 50, 40, 50]


def _equal():
    return _from_arrays([48] * 12), True, "vectorized"


def _equal_averaged():
    return _from_arrays([48] * 12), False, "vectorized"


def _ragged():
    return _from_arrays(RAGGED, extra_cols=2), True, "vectorized"


def _subset():
    data = _from_arrays(RAGGED, extra_cols=1)
    data.selection = {"trials": [7, 2, 9, 2, 0, 5]}
    return data, True, "vectorized"


def _channel_slice():
    data = _from_arrays(RAGGED, n_chan=5)
    data.selection = {"channel": [1, 2, 3]}
    return data, True, "vectorized"


def _channel_list():
    data = _from_arrays(RAGGED, n_chan=5)
    data.selection = {"channel": [4, 0, 2], "trials": [3, 1, 8]}
    return data, True, "vectorized"


def _latency_all():
    data = _from_arrays(RAGGED)
    data.selection = {"latency": "all"}
    return data, True, "vectorized"


def _hdf5(tmp_path):
    import h5py

    arr, trl = _analog(RAGGED, extra_cols=1)
    f = h5py.File(str(tmp_path / "payload.h5"), "w")
    dset = f.create_dataset("data", data=arr)
    data = spt.AnalogData(data=dset, samplerate=FS)
    data.trialdefinition = trl
    data.selection = {"trials": [4, 0, 6, 2]}
    return data, True, "vectorized"


def _latency_window():
    data = _from_arrays(RAGGED)
    data.selection = {"latency": [-0.005, 0.02]}
    return data, True, "per_trial"


def _spikes():
    rng = np.random.default_rng(3)
    samples = np.sort(rng.choice(6 * 200, size=90, replace=False))
    spikes = np.column_stack([samples, rng.integers(0, 2, 90),
                              rng.integers(0, 2, 90)]).astype(int)
    starts = np.arange(6) * 200
    trl = np.column_stack([starts, starts + 200, np.full(6, -20)]).astype(float)
    return spt.SpikeData(data=spikes, samplerate=FS, trialdefinition=trl), True, "per_trial"


def _resident():
    data = _from_arrays(RAGGED)
    out = spt.preprocessing(data, filter_class="but", filter_type="lp", freq=100, order=4)
    assert isinstance(out._data, routine.DeferredArray)
    return out, True, "vectorized"


CASES = {
    "equal": _equal,
    "equal_averaged": _equal_averaged,
    "three_lengths": _ragged,
    "subset_unsorted_repeated": _subset,
    "channel_slice": _channel_slice,
    "channel_list": _channel_list,
    "latency_all": _latency_all,
    "hdf5": _hdf5,
    "latency_window": _latency_window,
    "spikes": _spikes,
    "resident": _resident,
}


def _reference_time(data, sel):
    """Each selected trial's time (or, for discrete data, row) indexer."""
    lat = sel.select.get("latency")
    out = []
    for tid in sel.trial_ids:
        if "sample" in data.dimord:
            n = data._get_trial(tid).shape[0]
            out.append(slice(0, n, 1) if n > 1 else (slice(0, 1, 1) if n else []))
            continue
        n = int(data.sampleinfo[tid, 1] - data.sampleinfo[tid, 0])
        if lat is None or lat == "all":
            out.append(slice(None))
            continue
        tvec = (np.arange(n) + data._t0[tid]) / data.samplerate
        idx = np.flatnonzero((tvec >= lat[0]) & (tvec <= lat[1]))
        out.append(slice(int(idx[0]), int(idx[-1]) + 1, 1))
    return out


def _reference_trialdefinition(data, sel, time):
    trl_old = data.trialdefinition
    rows = []
    for tsel, tid in zip(time, sel.trial_ids):
        start, stop, offset = trl_old[tid, 0], trl_old[tid, 1], trl_old[tid, 2]
        extra = trl_old[tid, 3:]
        if "time" in data.dimord:
            t0, t1, step = tsel.indices(int(stop - start))
            rows.append(np.concatenate([[0, len(range(t0, t1, step)), offset + t0], extra]))
        else:
            rows.append(np.concatenate([[start, stop, offset], extra]))
    trl = np.vstack(rows)
    if "time" in data.dimord:
        bounds = np.cumsum(np.concatenate([[0], trl[:, 1] - trl[:, 0]]))
        trl[:, 0], trl[:, 1] = bounds[:-1], bounds[1:]
    return trl


def _reference_plan(cr, data, sel, keeptrials):
    """The plan's quantities by a loop over the selected trials, each
    materialized."""
    shapes = [tuple(np.asarray(sel.select_trial_array(data, k)).shape)
              for k in range(len(sel.trial_ids))]
    buckets = {}
    for pos, shp in enumerate(shapes):
        buckets.setdefault(shp, []).append(pos)
    out_per = {shp: cr.output_trial_shape(shp) for shp in buckets}
    ordered = [out_per[shp][0] for shp in shapes]
    total = list(ordered[0])
    if keeptrials:
        total[0] = sum(o[0] for o in ordered)
    return buckets, out_per, ordered, tuple(total)


def _reference_gather(data, sel):
    starts, lens = [], []
    for tid in sel.trial_ids:
        start, stop = data.sampleinfo[tid]
        starts.append(int(start))
        lens.append(int(stop - start))
    return np.asarray(starts), np.asarray(lens), sel.trial_indexer(data, 0)[1:]


@pytest.mark.parametrize("case", list(CASES))
def test_the_plan_matches_a_per_trial_loop(case, tmp_path):
    make = CASES[case]
    data, keeptrials, path = make(tmp_path) if case == "hdf5" else make()
    routine.reset_plan_counts()
    cr = _Halve()
    cr.initialize(data, 0, keeptrials=keeptrials)
    assert routine.plan_counts() == {"vectorized": int(path == "vectorized"),
                                     "per_trial": int(path == "per_trial")}
    sel = cr.selector
    assert sel.time_trivial == (path == "vectorized" and "time" in data.dimord)
    fast_plan = cr._fast_plan
    if case == "resident" or path == "per_trial":
        # a DeferredArray payload (its host gather is planned once read
        # back), a time selection or discrete data: no vectorized gather
        assert fast_plan is None

    time = _reference_time(data, sel)
    assert sel.time == time
    trl = _reference_trialdefinition(data, sel, time)
    assert sel.trialdefinition.dtype == trl.dtype
    assert sel.trialdefinition.shape == trl.shape
    assert sel.trialdefinition.tobytes() == trl.tobytes()

    buckets, out_per, ordered, total = _reference_plan(cr, data, sel, keeptrials)
    assert list(cr.buckets.items()) == list(buckets.items())
    assert all(type(p) is int for ps in cr.buckets.values() for p in ps)
    assert all(type(n) is int for shp in cr.buckets for n in shp)
    assert list(cr.out_per_trial_shapes.items()) == list(out_per.items())
    assert cr._per_trial_out_shapes_ordered == ordered
    assert cr.outputShape == total
    assert cr.dtype == np.float32 and cr.numTrials == len(sel.trial_ids)

    if fast_plan is not None:
        starts, lens, others = _reference_gather(data, sel)
        assert sorted(fast_plan) == ["hdf5", "lens", "others", "starts"]
        for got, want in ((fast_plan["starts"], starts), (fast_plan["lens"], lens)):
            assert got.dtype == np.int64 and np.array_equal(got, want)
        assert len(fast_plan["others"]) == len(others)
        assert all(a is b for a, b in zip(fast_plan["others"], others))
        assert fast_plan["hdf5"] == (case == "hdf5")


def test_averaging_trials_of_three_lengths_raises():
    cr = _Halve()
    with pytest.raises(spt.shared.errors.SPYValueError, match="identical trial shapes"):
        cr.initialize(_from_arrays(RAGGED), 0, keeptrials=False)


def test_a_coherence_call_plans_without_a_loop_over_trials(monkeypatch):
    data = _from_arrays([32] * 1000, n_chan=2)
    calls = collections.Counter()
    indexer, shape = Selector.trial_indexer, routine.ComputationalRoutine._selected_trial_shape

    def counted_indexer(self, *args):
        calls["trial_indexer"] += 1
        return indexer(self, *args)

    def counted_shape(self, *args):
        calls["_selected_trial_shape"] += 1
        return shape(self, *args)

    monkeypatch.setattr(Selector, "trial_indexer", counted_indexer)
    monkeypatch.setattr(routine.ComputationalRoutine, "_selected_trial_shape", counted_shape)
    routine.reset_plan_counts()
    spt.connectivityanalysis(data, method="coh", tapsmofrq=2)
    assert routine.plan_counts() == {"vectorized": 1, "per_trial": 0}
    # one shape, the gather plan and the store key: a few, not one a trial
    assert calls["_selected_trial_shape"] == 1
    assert 1 <= calls["trial_indexer"] <= 4
