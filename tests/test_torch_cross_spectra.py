# -*- coding: utf-8 -*-
# Parity tests for the port's CrossSpectra compute routine against the JAX
# package's: the fused trial sum (process_batch_sum) that runs the tiled
# CSD kernel, the single-trial cross spectra, and the engine's per-trial
# path. The JAX side runs on the CPU through its compensated-sum branch.

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from syncopy_tpu.connectivity.ST_compRoutines import CrossSpectra as JaxCrossSpectra
from syncopy_tpu.datatype.continuous_data import AnalogData as JaxAnalogData
from syncopy_tpu.datatype.continuous_data import CrossSpectralData as JaxCrossSpectralData
from syncopy_tpu.shared.input_processors import process_taper
from syncopy_tpu_torch import AnalogData, CrossSpectralData, from_arrays
from syncopy_tpu_torch.connectivity.ST_compRoutines import CrossSpectra
from syncopy_tpu_torch.engine import routine

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = routine.set_device("cpu")
    yield
    routine.set_device(previous)

FS = 1000.0


def _routines(T, tapsmofrq, **extra):
    taper, taper_opt = process_taper(
        "hann", None, tapsmofrq, None, keeptapers=False, foimax=FS / 2,
        samplerate=FS, nSamples=T, output="pow",
    )
    kw = dict(samplerate=FS, nSamples=T, taper=taper, taper_opt=taper_opt, **extra)
    return CrossSpectra(**kw), JaxCrossSpectra(**kw)


@pytest.mark.parametrize("polyremoval, tapsmofrq", [(0, 4), (1, 4), (None, None)])
def test_process_batch_sum_matches_jax(polyremoval, tapsmofrq):
    B, T, C, nv = 40, 250, 16, 33
    cr, jcr = _routines(T, tapsmofrq, polyremoval=polyremoval)
    x = np.random.default_rng(6).normal(size=(B, T, C)).astype(np.float32)
    x[nv:] = np.nan  # padding rows past n_valid are masked, never summed
    got = cr.process_batch_sum(torch.from_numpy(x), nv, **cr.cfg).numpy()
    want = np.asarray(jcr.process_batch_sum(jnp.asarray(x), jnp.int32(nv), **jcr.cfg))
    assert got.shape == want.shape == (1, T // 2 + 1, C, C)
    assert got.dtype == np.complex64
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_process_batch_sum_with_freq_idx():
    B, T, C, nv = 8, 200, 4, 8
    freq_idx = np.arange(10, 40, 3)
    cr, jcr = _routines(T, 4, freq_idx=freq_idx)
    x = np.random.default_rng(7).normal(size=(B, T, C)).astype(np.float32)
    got = cr.process_batch_sum(torch.from_numpy(x), nv, **cr.cfg).numpy()
    want = np.asarray(jcr.process_batch_sum(jnp.asarray(x), jnp.int32(nv), **jcr.cfg))
    assert got.shape == (1, len(freq_idx), C, C)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_process_single_trial_matches_jax():
    T, C = 300, 5
    cr, jcr = _routines(T, 4)
    x = np.random.default_rng(8).normal(size=(T, C)).astype(np.float32)
    got = cr.process_single_trial(torch.from_numpy(x), **cr.cfg).numpy()
    want = np.asarray(jcr.process_single_trial(jnp.asarray(x), **jcr.cfg))
    assert got.shape == want.shape == cr.output_trial_shape((T, C))[0]
    assert got.dtype == cr.output_trial_shape((T, C))[1]
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_exact_fft_not_ported_yet():
    """exact_fft, once unported, is the float64 CSD Granger takes: the
    padded trial sum and the single-trial CSD against the JAX package's
    double-float32 ones (DC bin with power: no demeaned taper here)."""
    T, C = 100, 3
    cr, jcr = _routines(T, 4, exact_fft=True)
    batch = np.random.default_rng(14).normal(size=(4, T, C)).astype(np.float32)
    batch[3] = np.nan  # a padding row
    got = cr.process_batch_sum(torch.from_numpy(batch), 3, **cr.cfg).numpy()
    want = np.asarray(jcr.process_batch_sum(jnp.asarray(batch), jnp.int32(3), **jcr.cfg))
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
    one = cr.process_single_trial(torch.from_numpy(batch[0]), **cr.cfg).numpy()
    assert np.abs(one - cr.process_batch_sum(torch.from_numpy(batch[:1]), 1, **cr.cfg).numpy()
                  ).max() == 0


def test_engine_keeps_single_trials_like_jax():
    """keeptrials=True through both engines: per-trial cross spectra of
    ragged trials stacked along time."""
    lens = [200, 250, 200]
    rng = np.random.default_rng(10)
    data = rng.normal(size=(sum(lens), 3)).astype(np.float32)
    trl = np.zeros((3, 3))
    trl[:, 1] = np.cumsum(lens)
    trl[1:, 0] = trl[:-1, 1]
    jdata = JaxAnalogData(data=data, samplerate=FS)
    jdata.trialdefinition = trl
    cr, jcr = _routines(250, 4)
    out, jout = CrossSpectralData(), JaxCrossSpectralData()
    pdata = from_arrays(data, trl, FS)
    cr.initialize(pdata, out._stackingDim, keeptrials=True)
    cr.compute(pdata, out)
    jcr.initialize(jdata, jout._stackingDim, keeptrials=True)
    jcr.compute(jdata, jout)
    got, want = np.asarray(out.data), np.asarray(jout.data)
    assert got.shape == want.shape == (3, 126, 3, 3)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    assert np.array_equal(out.trialdefinition, jout.trialdefinition)


class _TrialMean(routine.ComputationalRoutine):
    """Per-trial channel means: a routine without a fused trial sum."""

    def output_trial_shape(self, trial_shape):
        return (1, trial_shape[1]), np.dtype(np.float32)

    def process_single_trial(self, trial, **cfg):
        return trial.mean(dim=0, keepdim=True)

    def process_metadata(self, data, out):
        pass


@pytest.mark.parametrize("keeptrials", [True, False])
def test_engine_generic_path(monkeypatch, keeptrials):
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 2 * 50 * 2 * 4 * 2)  # 2-trial chunks
    data = np.random.default_rng(11).normal(size=(250, 2)).astype(np.float32)
    trl = np.array([[0, 50, 0], [50, 100, 0], [100, 150, 0], [150, 200, 0], [200, 250, 0]])
    adata = from_arrays(data, trl, FS)
    cr = _TrialMean()
    out = AnalogData()
    cr.initialize(adata, 0, keeptrials=keeptrials)
    cr.compute(adata, out)
    means = data.reshape(5, 50, 2).mean(axis=1)
    want = means if keeptrials else means.mean(axis=0, keepdims=True)
    assert np.abs(np.asarray(out.data) - want).max() < 1e-6
