# -*- coding: utf-8 -*-
# Parity of the port's statistics (syncopy_tpu_torch.statistics) against
# syncopy_tpu on the CPU, on the same seeded numpy inputs:
# - trial mean, var, std (AnalogData, complex SpectralData,
#   CrossSpectralData) and itc, within 1e-6 of the JAX package (float32
#   sums over a few trials; the JAX package's own tests hold var to 1e-5);
# - dimension mean, var, std and median, trials kept and averaged;
# - the routines alone: TrialReduce's three modes, NumpyStatDim, and
#   LOOAverage against the JAX package's trial_avg_replicates;
# - the engine's auxiliary per-trial inputs through multi-chunk runs:
#   per-trial and broadcast, real and complex, padded rows zero.

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu.statistics import compRoutines as jcr
from syncopy_tpu.statistics import jackknifing as jjk
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.shared.errors import SPYError, SPYValueError
from syncopy_tpu_torch.statistics import compRoutines as pcr
from syncopy_tpu_torch.statistics import jackknifing as pjk

torch.set_num_threads(1)

#: bar for statistics against the JAX package (absolute, data of unit scale)
STAT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


def _analog(n_trials=7, T=50, C=3, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_trials * T, C)).astype(np.float32)
    trl = np.array([[k * T, (k + 1) * T, 0] for k in range(n_trials)])
    jd = spy.AnalogData(data=data, samplerate=100.0)
    jd.trialdefinition = trl
    return spt.from_arrays(data, trl, 100.0), jd


def _spectral(n_trials=6, n_time=2, K=3, F=5, C=2, seed=1):
    rng = np.random.default_rng(seed)
    shape = (n_trials * n_time, K, F, C)
    spec = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    trl = np.array([[k * n_time, (k + 1) * n_time, 0] for k in range(n_trials)])
    freq = np.arange(F, dtype=float)
    jd = spy.SpectralData(data=spec, samplerate=10.0, freq=freq)
    jd.trialdefinition = trl
    return spt.SpectralData(data=spec, samplerate=10.0, freq=freq, trialdefinition=trl), jd


def _cross(n_trials=5, F=4, C=3, seed=2, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    shape = (n_trials, F, C, C)
    arr = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    arr = (arr + np.conj(np.swapaxes(arr, -1, -2))).astype(dtype)
    trl = np.array([[k, k + 1, 0] for k in range(n_trials)])
    kw = dict(data=arr, samplerate=10.0, trialdefinition=trl, freq=np.arange(F, dtype=float))
    from syncopy_tpu.datatype.continuous_data import CrossSpectralData as JaxCross

    return spt.CrossSpectralData(**kw), JaxCross(**kw)


def _same(out, ref, tol=STAT_TOL):
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() < tol
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.dimord == ref.dimord
    for prop in ("channel", "channel_i", "channel_j", "freq", "taper"):
        if prop in out.dimord:
            assert np.array_equal(np.asarray(getattr(out, prop)), np.asarray(getattr(ref, prop)))


# ------------------------------------------------------------------------ #
# frontends
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("operation", ["mean", "var", "std"])
@pytest.mark.parametrize("kind", ["analog", "spectral", "cross"])
def test_trial_statistics_match_jax(kind, operation):
    pdata, jdata = {"analog": _analog, "spectral": _spectral, "cross": _cross}[kind]()
    out = getattr(spt, operation)(pdata, dim="trials")
    ref = getattr(spy, operation)(jdata, dim="trials")
    _same(out, ref)
    assert len(out.trials) == 1


def test_itc_matches_jax():
    pdata, jdata = _spectral(n_trials=9, K=3)
    out, ref = spt.itc(pdata), spy.itc(jdata)
    _same(out, ref)
    got = np.asarray(out.data)
    assert got.dtype == np.float32 and got.shape[1] == 1 and (got <= 1 + 1e-6).all()
    assert list(out.taper) == ["itc"]


@pytest.mark.parametrize("keeptrials", [True, False])
@pytest.mark.parametrize("operation", ["mean", "var", "std", "median"])
@pytest.mark.parametrize("dim", ["time", "channel"])
def test_dimension_statistics_match_jax(dim, operation, keeptrials):
    pdata, jdata = _analog(n_trials=4, T=30, C=4, seed=5)
    out = getattr(spt, operation)(pdata, dim=dim, keeptrials=keeptrials)
    ref = getattr(spy, operation)(jdata, dim=dim, keeptrials=keeptrials)
    _same(out, ref)


def test_dimension_statistics_of_spectra_ignore_nan():
    pdata, jdata = _spectral()
    spec = np.asarray(pdata.data).copy()
    spec[0, 1, 2, 0] = np.nan
    pdata.data = spec
    jdata.data = spec
    for operation in ("mean", "var"):
        out = getattr(spt, operation)(pdata, dim="freq")
        ref = getattr(spy, operation)(jdata, dim="freq")
        _same(out, ref)
        assert np.isfinite(np.asarray(out.data)).all()


def test_statistics_refusals():
    pdata, _ = _analog()
    with pytest.raises(SPYError, match="median"):
        spt.median(pdata, dim="trials")
    with pytest.raises(SPYValueError, match="dim"):
        spt.mean(pdata, dim="freq")
    with pytest.raises(SPYValueError, match="same shape"):
        data = np.asarray(pdata.data)
        ragged = spt.from_arrays(data[:90], np.array([[0, 50, 0], [50, 90, 0]]), 100.0)
        spt.mean(ragged, dim="trials")
    with pytest.raises(SPYValueError, match="complex"):
        real = spt.SpectralData(data=np.ones((2, 1, 3, 2), np.float32), samplerate=1.0,
                                trialdefinition=np.array([[0, 1, 0], [1, 2, 0]]))
        spt.itc(real)


def test_trial_statistics_with_a_selection():
    pdata, jdata = _analog(n_trials=8, seed=6)
    sel = {"trials": [1, 2, 5, 6]}
    _same(spt.var(pdata, dim="trials", select=sel), spy.var(jdata, dim="trials", select=sel))
    assert pdata.selection is None


# ------------------------------------------------------------------------ #
# routines
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("mode", ["sum", "unit_sum", "centered_sq"])
def test_trial_reduce_modes_match_jax(mode):
    """The masked batch sum of each mode on a padded batch whose padding
    rows are NaN: the where-mask keeps them out."""
    rng = np.random.default_rng(3)
    batch = (rng.normal(size=(8, 2, 3)) + 1j * rng.normal(size=(8, 2, 3))).astype(np.complex64)
    batch[6:] = np.nan
    center = batch[:6].mean(axis=0)
    aux = (center[None].repeat(8, axis=0),) if mode == "centered_sq" else ()
    cr = pcr.TrialReduce(mode=mode)
    got = cr.process_batch_sum(torch.from_numpy(batch), 6, *(torch.from_numpy(a) for a in aux),
                               **cr.cfg)
    want = jcr.TrialReduce(mode=mode).process_batch_sum(
        jnp.asarray(batch), jnp.int32(6), *(jnp.asarray(a) for a in aux), mode=mode)
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and np.isfinite(got).all()
    assert np.abs(got - want).max() < STAT_TOL


@pytest.mark.parametrize("operation", ["mean", "std", "var", "median"])
def test_numpy_stat_dim_matches_jax(operation):
    rng = np.random.default_rng(4)
    trial = rng.normal(size=(11, 5)).astype(np.float32)
    trial[3, 2] = np.nan
    for axis in (0, 1):
        got = pcr.NumpyStatDim(operation, axis).process_single_trial(
            torch.from_numpy(trial), operation=operation, axis=axis).numpy()
        want = np.asarray(jcr.NumpyStatDim(operation, axis).process_single_trial(
            jnp.asarray(trial), operation=operation, axis=axis))
        assert got.shape == want.shape
        assert np.abs(got - want).max() < STAT_TOL


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_loo_replicates_match_jax(dtype):
    pdata, jdata = _cross(n_trials=6, dtype=dtype)
    out, ref = pjk.trial_avg_replicates(pdata), jjk.trial_avg_replicates(jdata)
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    tol = 1e-6 if dtype == np.complex64 else 1e-14
    assert np.abs(got - want).max() / np.abs(want).max() < tol
    arr = np.asarray(pdata.data).astype(np.complex128)
    loo = (arr.sum(axis=0)[None] - arr) / 5
    assert np.abs(got - loo).max() / np.abs(loo).max() < tol
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert np.array_equal(out.channel_i, ref.channel_i)


def test_loo_takes_the_form_that_keeps_its_bits():
    """At n = 1000 float32 trials each replicate is the float32 value of
    avg + (avg - x)/(n - 1), bit for bit, and within one ulp of the
    float64 leave-one-out average of the same float32 avg."""
    rng = np.random.default_rng(8)
    n = 1000
    x = (1 + 0.01 * rng.normal(size=(n, 64))).astype(np.float32)
    avg = x.mean(axis=0, dtype=np.float64).astype(np.float32)
    got = pcr.LOOAverage(n, avg).process_batch(
        torch.from_numpy(x), torch.from_numpy(avg)[None], n_trials=n).numpy()
    assert np.array_equal(got, avg + (avg - x) / np.float32(n - 1))
    want = (n * avg.astype(np.float64)[None] - x) / (n - 1)
    assert np.abs(got - want).max() <= np.finfo(np.float32).eps * np.abs(want).max()


def test_jackknife_bias_var_match_jax():
    pdata, jdata = _cross(n_trials=7, seed=9)
    preps, jreps = pjk.trial_avg_replicates(pdata), jjk.trial_avg_replicates(jdata)
    pdirect, jdirect = spt.mean(pdata, dim="trials"), spy.mean(jdata, dim="trials")
    for got, want in zip(pjk.bias_var(pdirect, preps), jjk.bias_var(jdirect, jreps)):
        _same(got, want, tol=1e-5)
    with pytest.raises(SPYValueError):
        pjk.bias_var(preps, preps)


# ------------------------------------------------------------------------ #
# the engine's auxiliary per-trial inputs
# ------------------------------------------------------------------------ #


class _Shift(routine.ComputationalRoutine):
    """Each trial minus its own complex offset (a per-trial aux input) and
    times a shared complex factor (a broadcast one); records the padded
    aux rows the fused path receives."""

    def __init__(self, offsets, factor):
        super().__init__()
        self._offsets, self._factor = offsets, factor
        self.padded_rows = []

    def output_trial_shape(self, trial_shape):
        return tuple(trial_shape), np.dtype(np.complex64)

    def per_trial_inputs(self, data, trial_positions):
        return (self._offsets[trial_positions],
                np.broadcast_to(self._factor, (len(trial_positions),) + self._factor.shape))

    def process_batch(self, batch, offsets, factor, **cfg):
        assert offsets.shape[0] == factor.shape[0] == batch.shape[0]
        return (batch - offsets[:, None, None]) * factor

    def process_batch_sum(self, batch, n_valid, offsets, factor, **cfg):
        assert offsets.shape[0] == factor.shape[0] == batch.shape[0]
        self.padded_rows.append((offsets[n_valid:], factor[n_valid:]))
        return self.process_batch(batch[:n_valid], offsets[:n_valid], factor[:n_valid]).sum(dim=0)

    def process_metadata(self, data, out):
        out.trialdefinition = self.default_trialdefinition(data, out)


@pytest.mark.parametrize("keeptrials", [True, False])
def test_aux_inputs_through_many_chunks(monkeypatch, keeptrials):
    """7 trials in chunks of 2 (the last one padded): every chunk gets its
    own rows of the per-trial input and the shared row of the broadcast
    one, complex, and padding rows are zeros."""
    T, C = 20, 2
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 2 * 2 * T * C * 20)
    pdata, _ = _analog(n_trials=7, T=T, C=C, seed=11)
    offsets = (np.arange(7) + 0.5j * np.arange(7)).astype(np.complex64)
    factor = np.array([[2 - 1j] * C] * T, dtype=np.complex64)
    cr = _Shift(offsets, factor)
    cr.initialize(pdata, 0, keeptrials=keeptrials)
    out = spt.AnalogData(dimord=["time", "channel"])
    cr.compute(pdata, out)
    x = np.asarray(pdata.data).reshape(7, T, C)
    per_trial = (x - offsets[:, None, None]) * factor
    want = per_trial.reshape(7 * T, C) if keeptrials else per_trial.mean(axis=0)
    assert np.abs(np.asarray(out.data) - want).max() / np.abs(want).max() < STAT_TOL
    if not keeptrials:
        assert len(cr.padded_rows) == 4
        assert [len(o) for o, _ in cr.padded_rows] == [0, 0, 0, 1]
        pad_offset, pad_factor = cr.padded_rows[-1]
        assert not pad_offset.any() and not pad_factor.any()


def test_trial_var_through_many_chunks(monkeypatch):
    """The centred second moment's broadcast mean reaches every chunk."""
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 2 * 2 * 40 * 1 * 4 * 2)
    pdata, jdata = _spectral(n_trials=9)
    _same(spt.var(pdata, dim="trials"), spy.var(jdata, dim="trials"))


def test_statistics_exported_at_the_top_level():
    from syncopy_tpu_torch import statistics

    for name in ("mean", "std", "var", "median", "itc"):
        assert getattr(spt, name) is getattr(statistics, name)
