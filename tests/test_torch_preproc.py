# -*- coding: utf-8 -*-
# Parity of the port's preprocessing and resampledata against syncopy_tpu
# on JAX-CPU (x64), from the same seeded numpy arrays: every filter class,
# type and direction, detrending, z-scoring, rectification, the seven
# Hilbert outputs, keeptrials=False, selections, ragged trials, NaN trials,
# several engine chunks, the frontends' rejections, and the chain into
# freqanalysis and connectivityanalysis. Bars, relative to the JAX
# maximum: 1e-6 for the IIR routes (float64 inside on both sides, one
# float32 rounding on the way in and one out), 1e-5 for the FFT routes
# (float32 FFTs on both sides); Hilbert angles only where the envelope
# exceeds 1e-3 of its maximum (the angle of a near-zero value is
# rounding).

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import iir_kernels as ik
from syncopy_tpu_torch.shared.errors import SPYError, SPYValueError

torch.set_num_threads(1)

FS = 1000.0
IIR_TOL = 1e-6
FFT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


def _both(lens, n_chan=3, seed=0, offsets=None, nan_at=()):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(int(np.sum(lens)), n_chan)).astype(np.float32)
    for row, col in nan_at:
        data[row, col] = np.nan
    bounds = np.concatenate([[0], np.cumsum(lens)])
    trl = np.zeros((len(lens), 3))
    trl[:, 0] = bounds[:-1]
    trl[:, 1] = bounds[1:]
    if offsets is not None:
        trl[:, 2] = offsets
    jdata = spy.AnalogData(data=data, samplerate=FS)
    jdata.trialdefinition = trl
    return spt.from_arrays(data, trl, FS), jdata


def _rel_err(got, want):
    ok = ~np.isnan(want)
    return float(np.abs(got[ok] - want[ok]).max() / np.abs(want[ok]).max())


def assert_same(out, ref, tol, magnitude=None):
    """Equal data within `tol` of the JAX maximum (NaN where JAX has NaN),
    equal trialdefinition, samplerate, channels, info and cfg keys."""
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if magnitude is not None:
        keep = magnitude > 1e-3 * np.nanmax(magnitude)
        assert keep.mean() > 0.5
        diff = np.angle(np.exp(1j * (got[keep] - want[keep])))
        assert np.abs(diff).max() < tol * np.pi
    else:
        assert _rel_err(got, want) <= tol
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.samplerate == ref.samplerate
    assert list(out.channel) == list(ref.channel)
    assert dict(out.info) == dict(ref.info)
    assert list(out.cfg) == list(ref.cfg)


def _run(func, pdata, jdata, **kw):
    return getattr(spt, func)(pdata, **kw), getattr(spy, func)(jdata, **kw)


FILTER_TYPES = [("lp", 40.0), ("hp", 20.0), ("bp", [30.0, 100.0]), ("bs", [45.0, 55.0])]


# ------------------------------------------------------------------------ #
# filters
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("ftype, freq", FILTER_TYPES)
@pytest.mark.parametrize("direction", ["twopass", "onepass"])
def test_butterworth_matches_jax(ftype, freq, direction):
    pdata, jdata = _both([300] * 4, seed=1)
    before = ik.sosfilt_batch.launches
    out, ref = _run("preprocessing", pdata, jdata, filter_class="but", filter_type=ftype,
                    freq=freq, order=4, direction=direction)
    assert ik.sosfilt_batch.launches == before  # the CPU takes the plain version
    assert_same(out, ref, IIR_TOL)
    assert out.info["nan_trials"] == []


@pytest.mark.parametrize("order", [1, 3, 8])
def test_butterworth_orders(order):
    pdata, jdata = _both([250] * 3, seed=order)
    out, ref = _run("preprocessing", pdata, jdata, filter_class="but", filter_type="bp",
                    freq=[20.0, 80.0], order=order)
    assert_same(out, ref, IIR_TOL)


@pytest.mark.parametrize("ftype, freq", FILTER_TYPES)
@pytest.mark.parametrize("direction", ["twopass", "onepass", "onepass-minphase"])
def test_windowed_sinc_matches_jax(ftype, freq, direction):
    pdata, jdata = _both([300] * 4, seed=2)
    out, ref = _run("preprocessing", pdata, jdata, filter_class="firws", filter_type=ftype,
                    freq=freq, order=100, direction=direction)
    assert_same(out, ref, FFT_TOL)


@pytest.mark.parametrize("window", ["hann", "blackman"])
def test_windowed_sinc_windows_and_default_order(window):
    pdata, jdata = _both([400] * 3, seed=3)
    out, ref = _run("preprocessing", pdata, jdata, filter_class="firws", filter_type="lp",
                    freq=60.0, window=window)
    assert_same(out, ref, FFT_TOL)


@pytest.mark.parametrize("filter_class, tol", [("but", IIR_TOL), ("firws", FFT_TOL)])
@pytest.mark.parametrize("polyremoval", [0, 1])
def test_polyremoval_before_the_filter(filter_class, tol, polyremoval):
    pdata, jdata = _both([300] * 3, seed=4)
    out, ref = _run("preprocessing", pdata, jdata, filter_class=filter_class, filter_type="hp",
                    freq=15.0, order=4 if filter_class == "but" else 100,
                    polyremoval=polyremoval)
    assert_same(out, ref, tol)


@pytest.mark.parametrize("polyremoval", [None, 0, 1])
def test_detrend_and_zscore_without_a_filter(polyremoval):
    pdata, jdata = _both([300] * 3, seed=5)
    kw = dict(filter_class=None, polyremoval=polyremoval, zscore=polyremoval != 0)
    out, ref = _run("preprocessing", pdata, jdata, **kw)
    assert_same(out, ref, FFT_TOL)


@pytest.mark.parametrize("filter_class, tol", [("but", IIR_TOL), ("firws", FFT_TOL)])
def test_zscore_then_filter(filter_class, tol):
    pdata, jdata = _both([300] * 3, seed=6)
    out, ref = _run("preprocessing", pdata, jdata, filter_class=filter_class, filter_type="lp",
                    freq=80.0, order=4 if filter_class == "but" else 100, zscore=True,
                    polyremoval=1)
    assert_same(out, ref, tol)


def test_rectify():
    pdata, jdata = _both([300] * 3, seed=7)
    out, ref = _run("preprocessing", pdata, jdata, filter_class="but", filter_type="bp",
                    freq=[30.0, 100.0], rectify=True)
    assert_same(out, ref, IIR_TOL)
    assert (np.asarray(out.data) >= 0).all()


@pytest.mark.parametrize("output", [True, "abs", "complex", "real", "imag", "absreal",
                                    "absimag", "angle"])
def test_hilbert_outputs(output):
    pdata, jdata = _both([300] * 3, seed=8)
    kw = dict(filter_class="firws", filter_type="bp", freq=[8.0, 40.0], order=100)
    out, ref = _run("preprocessing", pdata, jdata, hilbert=output, **kw)
    magnitude = None
    if output == "angle":
        magnitude = np.asarray(spy.preprocessing(jdata, hilbert="abs", **kw).data)
    assert_same(out, ref, FFT_TOL, magnitude=magnitude)
    assert np.asarray(out.data).dtype == (np.complex64 if output == "complex" else np.float32)


# ------------------------------------------------------------------------ #
# trials, selections, NaNs, chunks
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("filter_class, tol", [("but", IIR_TOL), ("firws", FFT_TOL)])
def test_keeptrials_false(filter_class, tol):
    pdata, jdata = _both([300] * 5, seed=9)
    out, ref = _run("preprocessing", pdata, jdata, filter_class=filter_class, filter_type="bp",
                    freq=[30.0, 100.0], order=4 if filter_class == "but" else 100,
                    keeptrials=False)
    assert_same(out, ref, tol)
    assert np.asarray(out.data).shape == (300, 3)


@pytest.mark.parametrize("filter_class, tol", [("but", IIR_TOL), ("firws", FFT_TOL)])
def test_channel_and_trial_selection(filter_class, tol):
    pdata, jdata = _both([300] * 5, n_chan=4, seed=10, offsets=[-100] * 5)
    sel = {"trials": [0, 2, 3], "channel": ["channel2", "channel4"]}
    out, ref = _run("preprocessing", pdata, jdata, filter_class=filter_class, filter_type="lp",
                    freq=50.0, order=4 if filter_class == "but" else 100, select=sel)
    assert_same(out, ref, tol)
    assert list(out.channel) == ["channel2", "channel4"]


@pytest.mark.parametrize("filter_class, tol", [("but", IIR_TOL), ("firws", FFT_TOL)])
def test_ragged_trials(filter_class, tol):
    pdata, jdata = _both([300, 250, 300, 201, 250], seed=11, offsets=[0, -50, 10, 0, -20])
    out, ref = _run("preprocessing", pdata, jdata, filter_class=filter_class, filter_type="bp",
                    freq=[30.0, 100.0], order=4 if filter_class == "but" else 100)
    assert_same(out, ref, tol)


@pytest.mark.parametrize("kw, tol", [
    (dict(filter_class="but", filter_type="bp", freq=[30.0, 100.0]), IIR_TOL),
    (dict(filter_class="but", filter_type="lp", freq=40.0, direction="onepass"), IIR_TOL),
    (dict(filter_class="firws", filter_type="bp", freq=[30.0, 100.0], order=100), FFT_TOL),
    (dict(filter_class=None, polyremoval=0), FFT_TOL),
])
def test_nan_trials(kw, tol):
    """NaN samples in trials 1 and 3 (the first sample of trial 3): both
    packages flag the same trials and poison the same samples."""
    pdata, jdata = _both([200] * 5, seed=12, nan_at=[(250, 1), (600, 0)])
    out, ref = _run("preprocessing", pdata, jdata, **kw)
    assert_same(out, ref, tol)
    assert out.info["nan_trials"] == [1, 3]


@pytest.mark.parametrize("func, kw, tol", [
    ("preprocessing", dict(filter_class="but", filter_type="bp", freq=[30.0, 100.0]), IIR_TOL),
    ("preprocessing", dict(filter_class="firws", filter_type="hp", freq=20.0, order=100,
                           hilbert="abs"), FFT_TOL),
    ("resampledata", dict(resamplefs=250.0, method="resample"), FFT_TOL),
    ("resampledata", dict(resamplefs=250.0, method="downsample", lpfreq=100.0), FFT_TOL),
])
def test_several_engine_chunks(monkeypatch, func, kw, tol):
    """A budget of one or two trials a chunk: the same result as JAX."""
    pdata, jdata = _both([300] * 5 + [250] * 2, seed=13)
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 60_000)
    out, ref = _run(func, pdata, jdata, **kw)
    assert_same(out, ref, tol)


def test_butterworth_chunk_size_follows_its_workspace():
    """The IIR routine declares its float64 scratch: the engine sizes its
    chunks by it."""
    from syncopy_tpu_torch.preproc.compRoutines import ButFiltering

    cr = ButFiltering(samplerate=FS, filter_type="bp", freq=[30.0, 100.0], order=4)
    assert cr.device_bytes_per_trial((1000, 64), None, None) == 1054 * 64 * 8 + 4 * 1000 * 64 * 4
    onepass = ButFiltering(samplerate=FS, filter_type="bp", freq=[30.0, 100.0], order=4,
                           direction="onepass")
    assert onepass.device_bytes_per_trial((1000, 64), None, None) == 1000 * 64 * (8 + 16)


# ------------------------------------------------------------------------ #
# resampledata
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("resamplefs", [250.0, 750.0, 300.0, 500.0])
def test_resample_matches_jax(resamplefs):
    pdata, jdata = _both([300] * 4, seed=14, offsets=[-100] * 4)
    out, ref = _run("resampledata", pdata, jdata, resamplefs=resamplefs, method="resample")
    assert_same(out, ref, FFT_TOL)
    assert out.samplerate == resamplefs


@pytest.mark.parametrize("kw", [dict(lpfreq=100.0), dict(order=200), dict(lpfreq=60.0, order=150)])
def test_resample_with_lpfreq_and_order(kw):
    pdata, jdata = _both([300] * 3, seed=15)
    out, ref = _run("resampledata", pdata, jdata, resamplefs=250.0, method="resample", **kw)
    assert_same(out, ref, FFT_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(lpfreq=100.0), dict(lpfreq=100.0, order=200)])
def test_downsample_matches_jax(kw):
    pdata, jdata = _both([300, 301, 299], seed=16, offsets=[-40, 0, 8])
    out, ref = _run("resampledata", pdata, jdata, resamplefs=250.0, method="downsample", **kw)
    assert_same(out, ref, FFT_TOL)


@pytest.mark.parametrize("method", ["resample", "downsample"])
def test_resampledata_keeptrials_false_and_selection(method):
    pdata, jdata = _both([300] * 5, n_chan=4, seed=17)
    sel = {"trials": [1, 2, 4], "channel": ["channel1", "channel3"]}
    out, ref = _run("resampledata", pdata, jdata, resamplefs=250.0, method=method,
                    keeptrials=False, select=sel)
    assert_same(out, ref, FFT_TOL)


def test_resampledata_ragged_trials():
    pdata, jdata = _both([300, 250, 303], seed=18, offsets=[0, -50, 3])
    out, ref = _run("resampledata", pdata, jdata, resamplefs=200.0, method="resample")
    assert_same(out, ref, FFT_TOL)


# ------------------------------------------------------------------------ #
# rejections, provenance, the device setting
# ------------------------------------------------------------------------ #


PREPROC_REJECTIONS = [
    dict(filter_class="cheby"),
    dict(filter_type="notch", freq=40.0),
    dict(filter_type="lp", freq=600.0),
    dict(filter_type="lp", freq=[10.0, 20.0]),
    dict(filter_type="bp", freq=[10.0, 10.0]),
    dict(filter_type="bp", freq=40.0),
    dict(filter_type="lp", freq=40.0, order=-2),
    dict(filter_type="lp", freq=40.0, order=2.5),
    dict(filter_type="lp", freq=40.0, direction="sideways"),
    dict(filter_type="lp", freq=40.0, direction="onepass-minphase"),
    dict(filter_class="firws", filter_type="lp", freq=40.0, window="kaiser"),
    dict(filter_class=None),
    dict(filter_type="lp", freq=40.0, polyremoval=2),
    dict(filter_type="lp", freq=40.0, zscore="yes"),
    dict(filter_type="lp", freq=40.0, rectify=1),
    dict(filter_type="lp", freq=40.0, rectify=True, hilbert="abs"),
    dict(filter_type="lp", freq=40.0, hilbert="power"),
]


def _same_rejection(func, pdata, jdata, kw):
    """Both packages raise the same class of error for `kw`."""
    with pytest.raises(SPYError) as got:
        getattr(spt, func)(pdata, **kw)
    with pytest.raises(spy.shared.errors.SPYError) as want:
        getattr(spy, func)(jdata, **kw)
    assert type(got.value).__name__ == type(want.value).__name__


@pytest.mark.parametrize("kw", PREPROC_REJECTIONS)
def test_preprocessing_rejects_what_the_jax_package_rejects(kw):
    pdata, jdata = _both([200] * 2, seed=19)
    _same_rejection("preprocessing", pdata, jdata, kw)


RESAMPLE_REJECTIONS = [
    dict(method="nearest"),
    dict(resamplefs=0.0),
    dict(resamplefs=2000.0),
    dict(resamplefs=250.0, lpfreq=200.0),
    dict(resamplefs=250.0, order=-1),
    dict(resamplefs=300.0, method="downsample"),
]


@pytest.mark.parametrize("kw", RESAMPLE_REJECTIONS)
def test_resampledata_rejects_what_the_jax_package_rejects(kw):
    pdata, jdata = _both([200] * 2, seed=20)
    _same_rejection("resampledata", pdata, jdata, kw)


def test_rejects_other_data_classes():
    spec = spt.freqanalysis(_both([200] * 2, seed=21)[0], method="mtmfft")
    with pytest.raises(SPYValueError):
        spt.preprocessing(spec, filter_type="lp", freq=40.0)
    with pytest.raises(SPYValueError):
        spt.resampledata(spec, resamplefs=250.0)


def test_cfg_provenance_and_replay():
    pdata, jdata = _both([300] * 3, seed=22)
    pdata.cfg.update({"previous": {"a": 1}})
    jdata.cfg.update({"previous": {"a": 1}})
    kw = dict(filter_class="but", filter_type="bp", freq=[30.0, 100.0], order=3)
    out, ref = _run("preprocessing", pdata, jdata, **kw)
    assert list(out.cfg) == list(ref.cfg) == ["previous", "preprocessing"]
    assert out.cfg["preprocessing"] == ref.cfg["preprocessing"]
    replay = spt.preprocessing(pdata, cfg=out.cfg)
    assert np.array_equal(np.asarray(replay.data), np.asarray(out.data))
    rs, rs_ref = _run("resampledata", out, ref, resamplefs=250.0)
    assert list(rs.cfg) == list(rs_ref.cfg) == ["previous", "preprocessing", "resampledata"]


@pytest.mark.parametrize("func, kw", [
    ("preprocessing", dict(filter_class="but", filter_type="lp", freq=40.0)),
    ("resampledata", dict(resamplefs=250.0)),
])
def test_no_card_and_no_request_raises(monkeypatch, func, kw):
    pdata, _ = _both([200] * 2, seed=23)
    spt.set_device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"set_device\("):
        getattr(spt, func)(pdata, **kw)


# ------------------------------------------------------------------------ #
# the chain: band-pass, resample, spectra and coherence
# ------------------------------------------------------------------------ #


def test_chain_into_freqanalysis_and_coherence():
    """BASELINE config #5's chain at a small size: band-pass, resample to
    250 Hz, multitaper spectra and coherence, each held to the JAX chain
    (spectra 1e-5 of the JAX maximum, coherence 1e-5 absolute)."""
    pdata, jdata = _both([1000] * 6, n_chan=3, seed=24)
    bp, bp_ref = _run("preprocessing", pdata, jdata, filter_class="but", filter_type="bp",
                      freq=[30.0, 100.0], order=4)
    assert_same(bp, bp_ref, IIR_TOL)
    rs, rs_ref = _run("resampledata", bp, bp_ref, resamplefs=250.0, method="resample")
    assert_same(rs, rs_ref, FFT_TOL)
    spec, spec_ref = _run("freqanalysis", rs, rs_ref, method="mtmfft", tapsmofrq=4,
                          keeptrials=False)
    assert _rel_err(np.asarray(spec.data), np.asarray(spec_ref.data)) <= FFT_TOL
    assert np.allclose(spec.freq, spec_ref.freq, rtol=0, atol=1e-12)
    coh, coh_ref = _run("connectivityanalysis", rs, rs_ref, method="coh", tapsmofrq=4)
    got, want = np.asarray(coh.data), np.asarray(coh_ref.data)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5
