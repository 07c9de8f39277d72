# -*- coding: utf-8 -*-
# Parity of the port's timelockanalysis and spike_psth against
# syncopy_tpu on JAX-CPU (x64), from the same seeded numpy arrays.
# timelockanalysis: latency windows (every preset and explicit ones),
# discarded trials, covariance with ddof, keeptrials and selections; avg,
# var, cov and the kept trials within 1e-5 of the JAX maximum (float32 trial
# sums on both sides, in other orders). spike_psth: all three outputs,
# both bin rules and an explicit width, vartriallen both ways; the same
# host numpy code on both sides, so the histograms are equal.

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.shared.errors import SPYError

torch.set_num_threads(1)

FS = 1000.0
REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


def _both(lens, offsets, n_chan=3, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(int(np.sum(lens)), n_chan)).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    trl = np.column_stack([bounds[:-1], bounds[1:], offsets]).astype(float)
    jdata = spy.AnalogData(data=data, samplerate=FS)
    jdata.trialdefinition = trl
    return spt.from_arrays(data, trl, FS), jdata


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def assert_same_timelock(out, ref):
    _close(out.data, ref.data)
    for name in ("avg", "var", "cov"):
        got, want = getattr(out, name), getattr(ref, name)
        assert (got is None) == (want is None)
        if want is not None:
            _close(got, want)
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.samplerate == ref.samplerate
    assert list(out.channel) == list(ref.channel)
    assert list(out.cfg) == list(ref.cfg)


def _run(func, pdata, jdata, **kw):
    return getattr(spt, func)(pdata, **kw), getattr(spy, func)(jdata, **kw)


# ------------------------------------------------------------------------ #
# timelockanalysis
# ------------------------------------------------------------------------ #

#: trials of 300 samples at offsets -100 .. -60: every window preset keeps
#: some and discards others
LENS, OFFSETS = [300, 300, 280, 300, 320], [-100, -80, -100, -60, -100]


@pytest.mark.parametrize("latency", ["minperiod", "prestim", "poststim", [-0.05, 0.15],
                                     [0.0, 0.1]])
def test_timelock_latency_windows(latency):
    pdata, jdata = _both(LENS, OFFSETS, seed=1)
    out, ref = _run("timelockanalysis", pdata, jdata, latency=latency)
    assert_same_timelock(out, ref)


def test_timelock_maxperiod():
    """The default window: the union of the trials, which trials of equal
    length and offset cover and the unequal ones of LENS do not."""
    pdata, jdata = _both([300] * 5, [-100] * 5, seed=12)
    out, ref = _run("timelockanalysis", pdata, jdata)
    assert_same_timelock(out, ref)
    pdata, jdata = _both(LENS, OFFSETS, seed=12)
    with pytest.raises(SPYError) as got:
        spt.timelockanalysis(pdata)
    with pytest.raises(spy.shared.errors.SPYError) as want:
        spy.timelockanalysis(jdata)
    assert type(got.value).__name__ == type(want.value).__name__


@pytest.mark.parametrize("ddof", [None, 0, 3])
@pytest.mark.parametrize("keeptrials", [False, True])
def test_timelock_covariance(ddof, keeptrials):
    pdata, jdata = _both([300] * 6, [-100] * 6, seed=2)
    out, ref = _run("timelockanalysis", pdata, jdata, covariance=True, ddof=ddof,
                    keeptrials=keeptrials)
    assert_same_timelock(out, ref)
    assert np.asarray(out.cov).shape == ((6, 3, 3) if keeptrials else (3, 3))


def test_timelock_keeptrials_and_discarded_trials():
    """minperiod discards no trial; an explicit late window discards the
    trials that end before it, and the kept trials are cut to the window."""
    pdata, jdata = _both(LENS, OFFSETS, seed=3)
    out, ref = _run("timelockanalysis", pdata, jdata, latency=[0.0, 0.21], keeptrials=True)
    assert_same_timelock(out, ref)
    assert out.trialdefinition.shape[0] < len(LENS)


def test_timelock_trials_keyword_and_selection():
    pdata, jdata = _both([300] * 6, [-100] * 6, n_chan=4, seed=4)
    out, ref = _run("timelockanalysis", pdata, jdata, trials=[0, 2, 5])
    assert_same_timelock(out, ref)
    sel = {"channel": ["channel2", "channel4"], "trials": [1, 3, 4]}
    out, ref = _run("timelockanalysis", pdata, jdata, covariance=True, select=sel)
    assert_same_timelock(out, ref)
    assert list(out.channel) == ["channel2", "channel4"]


def test_timelock_several_engine_chunks(monkeypatch):
    pdata, jdata = _both([300] * 7, [-100] * 7, seed=5)
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 20_000)
    out, ref = _run("timelockanalysis", pdata, jdata, covariance=True, keeptrials=True)
    assert_same_timelock(out, ref)


def test_timelock_of_filtered_data():
    """The port's own band-passed data through timelockanalysis."""
    pdata, jdata = _both([300] * 6, [-100] * 6, seed=6)
    kw = dict(filter_class="but", filter_type="bp", freq=[30.0, 100.0])
    bp, bp_ref = _run("preprocessing", pdata, jdata, **kw)
    out, ref = _run("timelockanalysis", bp, bp_ref, covariance=True)
    assert_same_timelock(out, ref)


@pytest.mark.parametrize("kw", [dict(ddof=-1), dict(ddof=1.5), dict(covariance="yes"),
                                dict(keeptrials=1), dict(latency="sometime"),
                                dict(latency=[0.5, 0.1])])
def test_timelock_rejects_what_the_jax_package_rejects(kw):
    pdata, jdata = _both([300] * 3, [-100] * 3, seed=7)
    with pytest.raises(SPYError) as got:
        spt.timelockanalysis(pdata, **kw)
    with pytest.raises(spy.shared.errors.SPYError) as want:
        spy.timelockanalysis(jdata, **kw)
    assert type(got.value).__name__ == type(want.value).__name__


def test_timelock_no_card_and_no_request_raises(monkeypatch):
    pdata, _ = _both([300] * 3, [-100] * 3, seed=8)
    spikes, _ = _spikes(seed=8)
    spt.set_device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"set_device\("):
        spt.timelockanalysis(pdata)
    with pytest.raises(RuntimeError, match=r"set_device\("):
        spt.spike_psth(spikes)


# ------------------------------------------------------------------------ #
# spike_psth
# ------------------------------------------------------------------------ #


def _spikes(seed, n_trials=4, trial_len=1000, n_spikes=400, offsets=None):
    """[sample, channel, unit] spike table over `n_trials` trials, two
    channels of two units each, and its trialdefinition."""
    rng = np.random.default_rng(seed)
    samples = np.sort(rng.choice(n_trials * trial_len, size=n_spikes, replace=False))
    data = np.column_stack([samples, rng.integers(0, 2, n_spikes),
                            rng.integers(0, 2, n_spikes)]).astype(int)
    starts = np.arange(n_trials) * trial_len
    offs = np.full(n_trials, -200) if offsets is None else np.asarray(offsets)
    trl = np.column_stack([starts, starts + trial_len, offs]).astype(float)
    return (spt.SpikeData(data=data, samplerate=FS, trialdefinition=trl),
            spy.SpikeData(data=data, samplerate=FS, trialdefinition=trl))


def assert_same_psth(out, ref):
    for name in ("data", "avg", "var"):
        got, want = np.asarray(getattr(out, name)), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.samplerate == ref.samplerate
    assert list(out.channel) == list(ref.channel)
    assert list(out.cfg) == list(ref.cfg)


@pytest.mark.parametrize("output", ["rate", "spikecount", "proportion"])
@pytest.mark.parametrize("binsize", ["rice", "sqrt", 0.05])
def test_spike_psth_matches_jax(output, binsize):
    pdata, jdata = _spikes(seed=9)
    out, ref = _run("spike_psth", pdata, jdata, output=output, binsize=binsize)
    assert_same_psth(out, ref)


@pytest.mark.parametrize("vartriallen", [True, False])
@pytest.mark.parametrize("keeptrials", [True, False])
def test_spike_psth_trial_lengths_and_keeptrials(vartriallen, keeptrials):
    """Trials at other offsets: with vartriallen the bins outside a trial
    are NaN; without it the trials not covering the window are dropped."""
    pdata, jdata = _spikes(seed=10, offsets=[-200, -100, -300, -200])
    out, ref = _run("spike_psth", pdata, jdata, vartriallen=vartriallen, keeptrials=keeptrials,
                    latency="maxperiod" if vartriallen else [-0.1, 0.5], binsize=0.05)
    assert_same_psth(out, ref)


@pytest.mark.parametrize("kw", [dict(output="density"), dict(binsize="scott"),
                                dict(binsize=-0.1), dict(binsize=5.0), dict(vartriallen=1)])
def test_spike_psth_rejects_what_the_jax_package_rejects(kw):
    pdata, jdata = _spikes(seed=11)
    with pytest.raises(SPYError) as got:
        spt.spike_psth(pdata, **kw)
    with pytest.raises(spy.shared.errors.SPYError) as want:
        spy.spike_psth(jdata, **kw)
    assert type(got.value).__name__ == type(want.value).__name__
