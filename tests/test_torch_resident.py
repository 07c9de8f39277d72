# -*- coding: utf-8 -*-
# Device-resident outputs of the port (engine/resident.py), against the
# port's own host route (the resident budget monkeypatched to 0) and
# against syncopy_tpu on JAX-CPU, whose resident route is the reference
# (tests/test_resident.py): a chain stays on the device until its last
# stage, reads its metadata without a readback, falls back to the host on
# a selection or a mutation, evicts by materializing, and consumes, splits
# and views resident records. Bars: the resident route equals the host
# route bitwise where both run the same chunks; a consumer that splits
# the producer's records sums in another order, 1e-6 of the maximum;
# against the JAX package the tolerances of test_torch_preproc.py (1e-6
# of the JAX maximum for the IIR filter, 1e-5 for FFT routes, coherence
# 1e-5 absolute); plot views 1e-5 of the maximum (a float32 box average on
# the device against numpy's, or against the JAX package's device view).

import gc

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import resident, routine
from syncopy_tpu_torch.engine.resident import DeferredArray

torch.set_num_threads(1)

FS = 1000.0
IIR_TOL = 1e-6
FFT_TOL = 1e-5
VIEW_TOL = 1e-5
SPLIT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly, start from an empty trial
    store and no residents; restore the setting after."""
    previous = spt.set_device("cpu")
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)


def _arrays(lens=(256,) * 20, n_chan=4, seed=7):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(int(np.sum(lens)), n_chan)).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    trl = np.zeros((len(lens), 3))
    trl[:, 0], trl[:, 1], trl[:, 2] = bounds[:-1], bounds[1:], -50
    return data, trl


@pytest.fixture()
def adata():
    data, trl = _arrays()
    return spt.from_arrays(data, trl, FS)


def _jax_object(data, trl):
    jdata = spy.AnalogData(data=data, samplerate=FS)
    jdata.trialdefinition = trl
    return jdata


def _host_route(fn, *args, **kwargs):
    """`fn` with residency off (the resident budget at 0)."""
    saved = resident.RESIDENT_BUDGET
    resident.RESIDENT_BUDGET = 0
    try:
        return fn(*args, **kwargs)
    finally:
        resident.RESIDENT_BUDGET = saved


def _is_resident(obj):
    return isinstance(obj._data, DeferredArray) and not obj._device_resident.materialized


def _lowpass(data):
    return spt.preprocessing(data, filter_class="but", filter_type="lp", freq=100, order=4)


def _bandpass(data):
    return spt.preprocessing(data, filter_class="but", filter_type="bp", freq=[30, 100],
                             order=4)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------------------ #
# chains
# ------------------------------------------------------------------------ #


def test_chain_stays_on_the_device(adata):
    pre = _lowpass(adata)
    assert _is_resident(pre)
    spec = spt.freqanalysis(pre, method="mtmfft", output="fourier", keeptrials=True)
    # consuming `pre` did not read it back
    assert _is_resident(pre) and _is_resident(spec)
    coh = spt.connectivityanalysis(spec, method="coh")
    assert _is_resident(spec)
    assert coh.data.shape[-1] == 4 and isinstance(coh.data, np.ndarray)


def test_bandpass_resample_coherence_chain_moves_the_input_once(adata):
    routine.reset_transfer_counts()
    bp = _bandpass(adata)
    rs = spt.resampledata(bp, resamplefs=250)
    coh = spt.connectivityanalysis(rs, method="coh", tapsmofrq=2)
    counts = routine.transfer_counts()
    assert _is_resident(bp) and _is_resident(rs)
    # one upload of the input, padded to the band-pass chunk; the
    # coherence is the only result that came back
    chunk = 32  # 20 trials: the next power of two
    assert counts["h2d"] == chunk * 256 * 4 * 4 and counts["h2d_aux"] == 0
    assert counts["d2h"] == coh.data.nbytes
    # the band-pass's per-trial NaN flags, one byte a trial
    assert counts["d2h_aux"] == 20


@pytest.mark.parametrize("chain", ["fourier", "resample"])
def test_chain_matches_the_host_route_bitwise(adata, chain):
    def run(data):
        if chain == "fourier":
            pre = _lowpass(data)
            mid = spt.freqanalysis(pre, method="mtmfft", output="fourier", keeptrials=True)
            return pre, mid, spt.connectivityanalysis(mid, method="coh")
        pre = _bandpass(data)
        mid = spt.resampledata(pre, resamplefs=250)
        return pre, mid, spt.connectivityanalysis(mid, method="coh", tapsmofrq=2)

    on = run(adata)
    routine.clear_device_cache()
    off = _host_route(run, adata)
    assert not isinstance(off[0]._data, DeferredArray)
    for got, want in zip(on, off):
        assert np.array_equal(np.asarray(got.data), np.asarray(want.data))


def test_chain_matches_the_jax_chain():
    """The resident chain of both packages (band-pass, resample to 250 Hz,
    coherence): 1e-6 / 1e-5 of the JAX maximum, coherence 1e-5 absolute."""
    data, trl = _arrays(lens=(1000,) * 6, n_chan=3, seed=24)
    pdata, jdata = spt.from_arrays(data, trl, FS), _jax_object(data, trl)
    kw = dict(filter_class="but", filter_type="bp", freq=[30.0, 100.0], order=4)
    bp, bp_ref = spt.preprocessing(pdata, **kw), spy.preprocessing(jdata, **kw)
    rs = spt.resampledata(bp, resamplefs=250.0)
    rs_ref = spy.resampledata(bp_ref, resamplefs=250.0)
    coh = spt.connectivityanalysis(rs, method="coh", tapsmofrq=4)
    coh_ref = spy.connectivityanalysis(rs_ref, method="coh", tapsmofrq=4)
    # both packages kept their intermediates on their device
    assert _is_resident(bp) and _is_resident(rs)
    assert type(bp_ref._data).__name__ == "DeferredArray"
    assert _rel_err(np.asarray(bp.data), np.asarray(bp_ref.data)) <= IIR_TOL
    assert _rel_err(np.asarray(rs.data), np.asarray(rs_ref.data)) <= FFT_TOL
    assert np.abs(np.asarray(coh.data) - np.asarray(coh_ref.data)).max() <= 1e-5


def test_metadata_without_materialization(adata):
    spec = spt.freqanalysis(adata, method="mtmfft", output="pow", keeptrials=True)
    assert spec.data.shape == (20, 1, 129, 4)
    assert spec.data.dtype == np.float32 and spec.data.ndim == 4
    assert spec.data.nbytes == 20 * 129 * 4 * 4 and len(spec.data) == 20
    assert len(spec.freq) == 129 and len(spec.channel) == 4 and len(spec.trials) == 20
    assert "device-resident" in str(spec)
    assert _is_resident(spec)
    # the first element access reads the payload back
    assert np.asarray(spec.trials[0]).shape == (1, 1, 129, 4)
    assert isinstance(spec._data, np.ndarray) and "in-memory" in str(spec)


def test_a_selection_falls_back_to_the_host(adata):
    pre = _lowpass(adata)
    spt.selectdata(pre, trials=[0, 2, 4], inplace=True)
    spec = spt.freqanalysis(pre, method="mtmfft", output="pow")
    pre._selection = None
    assert not isinstance(pre._data, DeferredArray)  # read back once
    pre2 = _host_route(_lowpass, adata)
    spt.selectdata(pre2, trials=[0, 2, 4], inplace=True)
    spec2 = _host_route(spt.freqanalysis, pre2, method="mtmfft", output="pow")
    assert np.array_equal(np.asarray(spec.data), np.asarray(spec2.data))


def test_a_mutation_after_seal_stops_consumption(adata):
    pre = _lowpass(adata)
    res = pre._device_resident
    assert res.consumable_by(pre)
    # a new trialdefinition invalidates the trial -> record mapping ...
    pre.trialdefinition = pre.trialdefinition
    assert not res.consumable_by(pre)
    spec = spt.freqanalysis(pre, method="mtmfft", output="pow")
    # ... so the consumer read it back; the payload stays exact
    assert res.materialized
    pre2 = _host_route(_lowpass, adata)
    assert np.array_equal(np.asarray(pre.data), np.asarray(pre2.data))
    spec2 = _host_route(spt.freqanalysis, pre2, method="mtmfft", output="pow")
    assert np.array_equal(np.asarray(spec.data), np.asarray(spec2.data))


def test_ragged_trials_round_trip():
    rng = np.random.default_rng(3)
    trls = [rng.normal(size=(n, 3)).astype("f4") for n in (300, 400, 300, 400)]
    ad = spt.AnalogData(data=trls, samplerate=FS)
    kw = dict(filter_class="firws", filter_type="lp", freq=80)
    pre = spt.preprocessing(ad, **kw)
    assert _is_resident(pre)
    # two buckets of record shapes; the consumer takes both from the device
    assert sorted({r.trial_shape for r in pre._device_resident.records}) == [(300, 3), (400, 3)]
    spec = spt.freqanalysis(pre, method="mtmfft", output="pow")
    assert _is_resident(pre)
    pre2 = _host_route(spt.preprocessing, ad, **kw)
    spec2 = _host_route(spt.freqanalysis, pre2, method="mtmfft", output="pow")
    assert np.array_equal(np.asarray(pre.data), np.asarray(pre2.data))
    assert np.array_equal(np.asarray(spec.data), np.asarray(spec2.data))


def test_the_budget_evicts_by_materializing(adata, monkeypatch):
    # one 5120 x 4 float32 result pins 81920 bytes: 120 kB holds one, not two
    monkeypatch.setattr(resident, "RESIDENT_BUDGET", 120000)
    first = _lowpass(adata)
    assert _is_resident(first)
    second = spt.preprocessing(adata, filter_class="but", filter_type="hp", freq=10, order=4)
    assert _is_resident(second)
    # the first was read back and its device tensors dropped, not lost
    assert first._device_resident.materialized and first._device_resident.records is None
    ref = _host_route(_lowpass, adata)
    assert np.array_equal(np.asarray(first.data), np.asarray(ref.data))


def test_read_back_results_hold_no_more_than_the_budget(adata, monkeypatch):
    # each 5120 x 4 float32 result holds 81920 bytes: 200 kB holds two
    budget = 200000
    monkeypatch.setattr(resident, "RESIDENT_BUDGET", budget)
    results = []
    for freq in (60, 80, 100, 120):
        pre = spt.preprocessing(adata, filter_class="but", filter_type="lp", freq=freq,
                                order=4)
        np.asarray(pre.data)  # read back; its records stay until room is needed
        results.append(pre)
    held = sum(p._device_resident.nbytes_device for p in results
               if p._device_resident.records is not None)
    assert 0 < held <= budget and resident._registry_account()[0] == held
    # the newest kept its records, the oldest were dropped first
    assert results[-1]._device_resident.records is not None
    assert results[0]._device_resident.records is None
    ref = _host_route(spt.preprocessing, adata, filter_class="but", filter_type="lp",
                      freq=60, order=4)
    assert np.array_equal(np.asarray(results[0].data), np.asarray(ref.data))


def test_an_admission_that_reads_the_input_back_keeps_the_fast_gather(adata, monkeypatch):
    # the 81920-byte input and the 41280-byte spectrum do not fit 100 kB
    # together, so the spectrum's admission reads the input back: the run
    # then gathers whole chunks from the host payload, not trial by trial
    monkeypatch.setattr(resident, "RESIDENT_BUDGET", 100000)
    pre = _lowpass(adata)
    assert _is_resident(pre)
    plans = []
    gather = routine.ComputationalRoutine._gather_batch

    def spy_gather(self, data, chunk_pos):
        plans.append(self._fast_plan)
        return gather(self, data, chunk_pos)

    monkeypatch.setattr(routine.ComputationalRoutine, "_gather_batch", spy_gather)
    spec = spt.freqanalysis(pre, method="mtmfft", output="pow", keeptrials=True)
    assert pre._device_resident.records is None and _is_resident(spec)
    assert plans and all(p is not None for p in plans)
    ref = _host_route(spt.freqanalysis, _host_route(_lowpass, adata), method="mtmfft",
                      output="pow", keeptrials=True)
    assert np.array_equal(np.asarray(spec.data), np.asarray(ref.data))


def test_a_read_back_result_is_read_only_while_its_records_exist(adata):
    """An in-place write cannot make the records stale: it raises while
    they exist, and once they are dropped the next analysis sees it."""
    pre = _lowpass(adata)
    s1 = spt.freqanalysis(pre, method="mtmfft", output="pow")
    arr = np.asarray(pre.data)
    with pytest.raises(ValueError, match="read-only"):
        pre.data[:] *= 2
    assert pre._device_resident.consumable_by(pre)
    assert np.array_equal(np.asarray(spt.freqanalysis(pre, method="mtmfft",
                                                      output="pow").data),
                          np.asarray(s1.data))
    routine.clear_device_cache()
    assert arr.flags.writeable
    pre.data[:] *= 2
    s2 = spt.freqanalysis(pre, method="mtmfft", output="pow")
    assert np.allclose(np.asarray(s2.data), 4 * np.asarray(s1.data), rtol=1e-5, atol=0)


def test_jax_in_place_write_into_a_read_back_result_is_stale():
    """The JAX package's form of the fault (ROADMAP Queue 3): its read-back
    array stays writable while the records stay consumable, so an in-place
    write is not seen by the next analysis, which consumes the old records
    (syncopy_tpu/engine/resident.py consumable_by)."""
    from syncopy_tpu.engine import routine as jroutine

    data, trl = _arrays()
    jroutine.clear_device_cache()
    try:
        jpre = spy.preprocessing(_jax_object(data, trl), filter_class="but",
                                 filter_type="lp", freq=100, order=4)
        s1 = spy.freqanalysis(jpre, method="mtmfft", output="pow")
        np.asarray(jpre.data)
        jpre.data[:] *= 2
        stale = spy.freqanalysis(jpre, method="mtmfft", output="pow")
        assert np.array_equal(np.asarray(stale.data), np.asarray(s1.data))
    finally:
        jroutine.clear_device_cache()


def test_a_result_over_the_budget_takes_the_host_route(adata, monkeypatch):
    monkeypatch.setattr(resident, "RESIDENT_BUDGET", 1000)
    pre = _lowpass(adata)
    assert isinstance(pre._data, np.ndarray) and pre._device_resident is None


def test_save_materializes(adata, tmp_path):
    spec = spt.freqanalysis(adata, method="mtmfft", output="pow", keeptrials=True)
    assert _is_resident(spec)
    spt.save(spec, container=str(tmp_path / "resident_spec"))
    loaded = spt.load(str(tmp_path / "resident_spec.spy"))
    host = _host_route(spt.freqanalysis, adata, method="mtmfft", output="pow",
                       keeptrials=True)
    # the whole payload was written, and the object now reads the saved file
    assert np.array_equal(np.asarray(loaded.data), np.asarray(host.data))
    assert spec.data.file.filename == loaded.data.file.filename
    assert np.array_equal(np.asarray(spec.data), np.asarray(host.data))
    # a write into that file must not leave device records stale: they go
    # with the old payload, and a consumer reads the file
    assert spec._device_resident is None
    avg = spt.mean(spec, dim="trials")
    ref = _host_route(spt.mean, host, dim="trials")
    assert np.array_equal(np.asarray(avg.data), np.asarray(ref.data))


def test_the_registry_prunes_dead_objects(adata):
    n0 = len([r for r in resident._REGISTRY if r() is not None])
    pre = _lowpass(adata)
    assert len([r for r in resident._REGISTRY if r() is not None]) == n0 + 1
    del pre
    gc.collect()
    pinned, alive = resident._registry_account()
    assert len(alive) == n0 and pinned == 0
    routine.clear_device_cache()
    assert resident._REGISTRY == []


def test_clear_reads_every_resident_back(adata):
    pre = _lowpass(adata)
    routine.clear_device_cache()
    assert isinstance(pre._data, np.ndarray) and pre._device_resident.records is None
    ref = _host_route(_lowpass, adata)
    assert np.array_equal(pre.data, ref.data)


def test_device_resident_false_and_true(adata):
    from syncopy_tpu_torch.preproc.compRoutines import ButFiltering

    def run(flag):
        out = spt.AnalogData(dimord=adata.dimord)
        cr = ButFiltering(samplerate=FS, filter_type="lp", freq=100, order=4,
                          direction="twopass", polyremoval=None)
        cr.initialize(adata, out._stackingDim, keeptrials=True)
        cr.compute(adata, out, device_resident=flag)
        return out

    # False reads the result back; True, the default, keeps it within budget
    assert isinstance(run(False)._data, np.ndarray)
    assert _is_resident(run(True))


# ------------------------------------------------------------------------ #
# streamed reductions consume resident inputs
# ------------------------------------------------------------------------ #


@pytest.fixture()
def spec(adata):
    return spt.freqanalysis(adata, method="mtmfft", output="fourier", keeptrials=True)


def _stack(spec):
    return np.stack([np.asarray(t) for t in spec.trials])


def test_itc_consumes_a_resident_input(spec):
    assert _is_resident(spec)
    res = spt.itc(spec)
    assert _is_resident(spec), "itc read its input back"
    stack = _stack(spec)
    unit = stack / np.abs(stack)
    want = np.abs(unit.mean(axis=0).mean(axis=0, keepdims=True))
    assert np.allclose(np.asarray(res.data), want, rtol=0, atol=1e-6)


def test_var_and_std_consume_a_resident_input(spec):
    v = spt.var(spec, dim="trials")
    s = spt.std(spec, dim="trials")
    assert _is_resident(spec), "var/std read their input back"
    stack = _stack(spec)
    want = np.mean(np.abs(stack - stack.mean(axis=0)) ** 2, axis=0)
    assert np.allclose(np.asarray(v.data), want, rtol=0, atol=1e-6)
    assert np.allclose(np.asarray(s.data), np.sqrt(want), rtol=0, atol=1e-6)


def test_two_pass_ppc_consumes_a_resident_input(spec):
    ppc = spt.connectivityanalysis(spec, method="ppc")
    assert _is_resident(spec)
    ref = _host_route(spt.connectivityanalysis, spec, method="ppc")
    assert np.array_equal(np.asarray(ppc.data), np.asarray(ref.data))
    s = _stack(spec)[:, 0]  # (trials, tapers, freq, channel)
    csd = np.einsum("nkfi,nkfj->nfij", s, np.conj(s)) / s.shape[1]
    unit = csd / np.abs(csd)
    n = unit.shape[0]
    want = (np.abs(unit.sum(axis=0)) ** 2 - n) / (n * (n - 1))
    assert np.abs(np.asarray(ppc.data)[0] - want).max() <= 1e-5


def test_the_jackknife_consumes_its_resident_stack(adata, monkeypatch):
    made = []
    original = resident.DeviceResident.__init__

    def track(self, *args, **kwargs):
        original(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(resident.DeviceResident, "__init__", track)
    res = spt.connectivityanalysis(adata, method="coh", jackknife=True)
    # the single-trial CSD stack went resident, and the replicates and the
    # trial mean were formed from it without a readback
    assert made and not made[0].materialized
    ref = _host_route(spt.connectivityanalysis, adata, method="coh", jackknife=True)
    for name in ("jack_var", "jack_bias"):
        got = np.asarray(res._get_extra_dataset(name))
        want = np.asarray(ref._get_extra_dataset(name))
        assert np.array_equal(got, want), name
    assert np.array_equal(np.asarray(res.data), np.asarray(ref.data))


# ------------------------------------------------------------------------ #
# a consumer with smaller chunks splits the producer's records
# ------------------------------------------------------------------------ #


def test_a_consumer_splits_producer_records(spec, monkeypatch):
    assert len(spec._device_resident.records) == 1  # one 20-trial record
    monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 4)
    made = []
    original = routine.ComputationalRoutine._run

    def keep(self, data, out):
        made.append(self)
        return original(self, data, out)

    monkeypatch.setattr(routine.ComputationalRoutine, "_run", keep)
    res = spt.itc(spec)
    assert _is_resident(spec)
    plan = made[-1].chunk_plan[0]
    assert plan["source"] == "resident" and plan["chunk"] == 4
    assert plan["rows"] == [4] * 5
    stack = _stack(spec)
    unit = stack / np.abs(stack)
    want = np.abs(unit.mean(axis=0).mean(axis=0, keepdims=True))
    assert np.allclose(np.asarray(res.data), want, rtol=0, atol=1e-6)


def test_a_split_keeptrials_consumer(adata, monkeypatch):
    pre = _lowpass(adata)
    monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 8)  # chunks of 8, 8 and 4
    spec = spt.freqanalysis(pre, method="mtmfft", output="pow", keeptrials=True)
    assert _is_resident(pre)
    pre2 = _host_route(_lowpass, adata)
    spec2 = _host_route(spt.freqanalysis, pre2, method="mtmfft", output="pow",
                        keeptrials=True)
    # trial by trial, so the split changes nothing
    assert np.array_equal(np.asarray(spec.data), np.asarray(spec2.data))


def test_a_split_fused_sum_pads_its_tail(adata, monkeypatch):
    rs = spt.resampledata(_bandpass(adata), resamplefs=250)
    monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 8)  # 8 + 8 + 4, the tail padded
    coh = spt.connectivityanalysis(rs, method="coh", tapsmofrq=2)
    assert _is_resident(rs)
    ref = _host_route(spt.connectivityanalysis, rs, method="coh", tapsmofrq=2)
    got, want = np.asarray(coh.data), np.asarray(ref.data)
    assert np.abs(got - want).max() <= SPLIT_TOL * np.abs(want).max()


# ------------------------------------------------------------------------ #
# the plot-resolution view
# ------------------------------------------------------------------------ #


def _tfr(pkg, output="pow"):
    d = pkg.synthdata.harmonic(freq=40, samplerate=500, nTrials=3, nSamples=1000, nChannels=2)
    return pkg.freqanalysis(d, method="wavelet", output=output,
                            foi=np.arange(10, 60, 10.0), keeptrials=True)


def test_the_view_matches_host_decimation_and_the_jax_view():
    tf, tf_ref = _tfr(spt), _tfr(spy)
    res = tf._device_resident
    assert res is not None and res.consumable_by(tf)
    routine.reset_transfer_counts()
    view, factor = res.fetch_trial_view(1, max_time=100)
    assert factor == 10 and view.shape == (100, 1, 5, 2)
    assert routine.transfer_counts()["d2h"] == view.nbytes  # only the view came back
    assert _is_resident(tf)
    want_jax, factor_jax = tf_ref._device_resident.fetch_trial_view(1, max_time=100)
    assert factor_jax == factor
    assert _rel_err(view, np.asarray(want_jax)) <= VIEW_TOL
    full = np.asarray(tf.data)[1000:2000]
    want = full.reshape(100, 10, *full.shape[1:]).mean(axis=1)
    assert _rel_err(view, want) <= VIEW_TOL


def test_the_view_takes_the_magnitude_of_complex_values():
    tf, tf_ref = _tfr(spt, "fourier"), _tfr(spy, "fourier")
    view, factor = tf._device_resident.fetch_trial_view(0, max_time=250)
    assert not np.iscomplexobj(view) and factor == 4
    want_jax, _ = tf_ref._device_resident.fetch_trial_view(0, max_time=250)
    assert _rel_err(view, np.asarray(want_jax)) <= VIEW_TOL
    full = np.abs(np.asarray(tf.data)[:1000])
    want = full.reshape(250, 4, *full.shape[1:]).mean(axis=1)
    assert _rel_err(view, want) <= VIEW_TOL
    raw, _ = tf._device_resident.fetch_trial_view(0, max_time=250, magnitude=False)
    assert np.iscomplexobj(raw)


def test_the_view_after_materialization():
    tf = _tfr(spt)
    res = tf._device_resident
    full = np.asarray(tf.data)  # reads back
    view, factor = res.fetch_trial_view(2, max_time=100)
    assert view.shape[0] == 100 and factor == 10
    want = full[2000:3000].reshape(100, 10, *full.shape[1:]).mean(axis=1)
    assert _rel_err(view, want) <= VIEW_TOL
    routine.clear_device_cache()  # the device tensors are gone: host path
    view2, _ = res.fetch_trial_view(2, max_time=100)
    assert np.array_equal(view, view2)


def test_the_plot_takes_the_decimated_view(monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setenv("MPLBACKEND", "Agg")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tf = _tfr(spt)
    calls = []
    original = resident.DeviceResident.fetch_trial_view

    def spy_view(self, *args, **kwargs):
        calls.append(kwargs.get("max_time"))
        return original(self, *args, **kwargs)

    monkeypatch.setattr(resident.DeviceResident, "fetch_trial_view", spy_view)
    from syncopy_tpu_torch.plotting import config

    monkeypatch.setitem(config.pltConfig, "maxPlotTime", 100)
    fig, ax = spt.singlepanelplot(tf, trials=0)
    assert calls == [100]
    assert ax.get_images()[0].get_array().shape[1] == 100
    assert _is_resident(tf)
    plt.close(fig)
    fig, ax = spt.singlepanelplot(tf, trials=[1])  # a list: the host path
    assert ax.get_images() and calls == [100]
    plt.close(fig)
