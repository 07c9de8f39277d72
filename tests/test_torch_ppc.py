# -*- coding: utf-8 -*-
# Parity of the port's PPC and cross-spectra slice against syncopy_tpu on
# the CPU: PPCSpectra.process_batch_sum (the fused route that runs the PPC
# kernel), PPCReduction, SpectralDyadicProduct, and connectivityanalysis
# with method="ppc" and "csd" from AnalogData and coh/csd/ppc from complex
# SpectralData, with and without channelcmb. The same numpy arrays build
# both packages' data objects; metadata must be equal.

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu.connectivity.AV_compRoutines import PPCReduction as JaxPPCReduction
from syncopy_tpu.connectivity.ST_compRoutines import PPCSpectra as JaxPPCSpectra
from syncopy_tpu.connectivity.ST_compRoutines import SpectralDyadicProduct as JaxSDP
from syncopy_tpu.shared.input_processors import process_taper
from syncopy_tpu_torch.connectivity import ST_compRoutines
from syncopy_tpu_torch.connectivity.AV_compRoutines import PPCReduction
from syncopy_tpu_torch.connectivity.ST_compRoutines import PPCSpectra, SpectralDyadicProduct
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import csd_kernels, ppc_kernels
from syncopy_tpu_torch.shared.errors import SPYTypeError, SPYValueError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)

FS = 1000.0
#: PPC is a difference of O(1) terms: bars are absolute
PPC_TOL = 1e-5
#: cross spectra scale with the data: bars are relative to the maximum
CSD_REL_TOL = 1e-5
#: the fused resultant sum, per unit phasor (test_connectivity.py bar)
RESULTANT_TOL = 1e-4


def _arrays(lens, n_chan, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(int(np.sum(lens)), n_chan)).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    trl = np.zeros((len(lens), 3))
    trl[:, 0] = bounds[:-1]
    trl[:, 1] = bounds[1:]
    return data, trl


def _analog(lens, n_chan, seed=0):
    data, trl = _arrays(lens, n_chan, seed)
    jax_data = spy.AnalogData(data=data, samplerate=FS)
    jax_data.trialdefinition = trl
    return spt.from_arrays(data, trl, FS), jax_data


def _spectral(n_trials, n_time, K, F, C, seed=0):
    """Complex (nTrials * nTime, K, F, C) spectra in both packages."""
    rng = np.random.default_rng(seed)
    shape = (n_trials * n_time, K, F, C)
    spec = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    trl = np.zeros((n_trials, 3))
    trl[:, 0] = np.arange(n_trials) * n_time
    trl[:, 1] = trl[:, 0] + n_time
    freq = np.arange(F) * 2.0
    jax_data = spy.SpectralData(data=spec, samplerate=FS, freq=freq)
    jax_data.trialdefinition = trl
    return spt.SpectralData(data=spec, samplerate=FS, freq=freq, trialdefinition=trl), jax_data


def _assert_meta(out, ref):
    assert out.dimord == ref.dimord
    assert np.array_equal(out.freq, ref.freq)
    assert np.array_equal(out.channel_i, ref.channel_i)
    assert np.array_equal(out.channel_j, ref.channel_j)
    assert out.samplerate == ref.samplerate
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.cfg.keys() == ref.cfg.keys()
    assert out.cfg["connectivityanalysis"] == ref.cfg["connectivityanalysis"]


def _assert_same(out, ref, tol, relative=False):
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert np.isfinite(got).all()
    scale = np.abs(want).max() if relative else 1.0
    assert np.abs(got - want).max() / scale < tol
    _assert_meta(out, ref)


# -- compute routines -------------------------------------------------------- #


def _ppc_routines(T, tapsmofrq, **extra):
    taper, taper_opt = process_taper(
        "hann", None, tapsmofrq, None, keeptapers=False, foimax=FS / 2,
        samplerate=FS, nSamples=T, output="pow",
    )
    kw = dict(samplerate=FS, nSamples=T, taper=taper, taper_opt=taper_opt, **extra)
    return PPCSpectra(**kw), JaxPPCSpectra(**kw)


@pytest.mark.parametrize("tapsmofrq, freq_idx", [(4, None), (None, None), (4, np.arange(5, 60, 4))])
def test_ppc_process_batch_sum_matches_jax(tapsmofrq, freq_idx):
    B, T, C, nv = 24, 250, 6, 19
    cr, jcr = _ppc_routines(T, tapsmofrq, freq_idx=freq_idx)
    x = np.random.default_rng(12).normal(size=(B, T, C)).astype(np.float32)
    x[nv:] = np.nan  # padding trials past n_valid are masked, never summed
    got = cr.process_batch_sum(torch.from_numpy(x), nv, **cr.cfg).numpy()
    want = np.asarray(jcr.process_batch_sum(jnp.asarray(x), jnp.int32(nv), **jcr.cfg))
    n_freq = T // 2 + 1 if freq_idx is None else len(freq_idx)
    assert got.shape == want.shape == (1, n_freq, C, C)
    assert got.dtype == np.complex64
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < RESULTANT_TOL
    assert np.allclose(got[0][:, np.arange(C), np.arange(C)].real, nv, atol=1e-3)


def test_ppc_process_single_trial_matches_jax():
    T, C = 300, 4
    cr, jcr = _ppc_routines(T, 4)
    x = np.random.default_rng(13).normal(size=(T, C)).astype(np.float32)
    got = cr.process_single_trial(torch.from_numpy(x), **cr.cfg).numpy()
    want = np.asarray(jcr.process_single_trial(jnp.asarray(x), **jcr.cfg))
    assert got.shape == want.shape == cr.output_trial_shape((T, C))[0]
    assert np.abs(got - want).max() < 1e-5


def test_ppc_reduction_matches_jax():
    rng = np.random.default_rng(14)
    shape = (7, 2, 5, 3, 3)  # (B, nTime, F, C, C)
    z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    z[5:] = 0  # padding trials: 0/0 phase units, masked
    got = PPCReduction().process_batch_sum(torch.from_numpy(z), 5).numpy()
    want = np.asarray(JaxPPCReduction().process_batch_sum(jnp.asarray(z), 5))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-5
    post = PPCReduction.make_post(5)(torch.from_numpy(got / 5)).numpy()
    jpost = np.asarray(JaxPPCReduction.make_post(5)(jnp.asarray(want / 5)))
    assert post.dtype == jpost.dtype == np.float32
    assert np.abs(post - jpost).max() < PPC_TOL


@pytest.mark.parametrize("cmb", [None, ([0, 2], [1, 3, 4])])
def test_spectral_dyadic_product_matches_jax(cmb):
    rng = np.random.default_rng(15)
    B, T, K, F, C, nv = 6, 2, 3, 7, 5, 4
    shape = (B, T, K, F, C)
    x = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    x[nv:] = np.nan
    kw = {} if cmb is None else {"send_idx": cmb[0], "rec_idx": cmb[1]}
    cr, jcr = SpectralDyadicProduct(**kw), JaxSDP(**kw)
    got = cr.process_batch_sum(torch.from_numpy(x), nv, **cr.cfg).numpy()
    want = np.asarray(jcr.process_batch_sum(jnp.asarray(x), jnp.int32(nv), **jcr.cfg))
    assert got.shape == want.shape == cr.output_trial_shape(shape[1:])[0]
    assert np.abs(got - want).max() / np.abs(want).max() < CSD_REL_TOL
    one = cr.process_single_trial(torch.from_numpy(x[0]), **cr.cfg).numpy()
    jone = np.asarray(jcr.process_single_trial(jnp.asarray(x[0]), **jcr.cfg))
    assert one.shape == jone.shape and one.dtype == np.complex64
    assert np.abs(one - jone).max() / np.abs(jone).max() < CSD_REL_TOL


# -- connectivityanalysis from AnalogData ----------------------------------- #


@pytest.mark.parametrize("lens, n_chan, kw", [
    ([500] * 20, 8, {"tapsmofrq": 2}),
    ([800, 1000, 1000, 900, 800, 1000], 3, {"tapsmofrq": 3}),
    ([400] * 12, 4, {"tapsmofrq": 4, "select": {"trials": [0, 2, 3, 7, 8, 11]}}),
    ([500] * 10, 4, {"tapsmofrq": 2, "foilim": [20, 80]}),
    ([300] * 8, 3, {"taper": "hann", "polyremoval": 1, "foi": [10, 20, 41]}),
])
def test_ppc_matches_jax(lens, n_chan, kw):
    pdata, jdata = _analog(lens, n_chan, seed=len(lens))
    out = spt.connectivityanalysis(pdata, method="ppc", **kw)
    ref = spy.connectivityanalysis(jdata, method="ppc", **kw)
    _assert_same(out, ref, PPC_TOL)
    got = np.asarray(out.data)
    assert np.allclose(got[0][:, np.arange(n_chan), np.arange(n_chan)], 1.0, atol=1e-5)


@pytest.mark.parametrize("scale", [1e-13, 1e10])
def test_ppc_is_scale_invariant(scale):
    """PPC depends on phases only: the same trials in tesla (MEG, 1e-13)
    or at 1e10 give PPC at scale 1, through the fused kernel route."""
    data, trl = _arrays([500] * 12, 4, seed=21)
    want = np.asarray(spt.connectivityanalysis(
        spt.from_arrays(data, trl, FS), method="ppc", tapsmofrq=2).data)
    got = np.asarray(spt.connectivityanalysis(
        spt.from_arrays((data * scale).astype(np.float32), trl, FS), method="ppc",
        tapsmofrq=2).data)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < PPC_TOL


def test_ppc_forced_multi_chunk(monkeypatch):
    """A tiny chunk budget splits 21 trials into padded chunks of 4."""
    T, C = 250, 4
    pdata, jdata = _analog([T] * 21, C, seed=8)
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 4 * T * C * 4 * 2)
    calls = []
    orig = ST_compRoutines.PPCSpectra.process_batch_sum

    def counting(self, batch, n_valid, **cfg):
        calls.append((batch.shape[0], n_valid))
        return orig(self, batch, n_valid, **cfg)

    monkeypatch.setattr(ST_compRoutines.PPCSpectra, "process_batch_sum", counting)
    out = spt.connectivityanalysis(pdata, method="ppc", tapsmofrq=4)
    ref = spy.connectivityanalysis(jdata, method="ppc", tapsmofrq=4)
    _assert_same(out, ref, PPC_TOL)
    assert calls == [(4, 4)] * 5 + [(4, 1)]


@pytest.mark.parametrize("keeptrials", [False, True])
def test_csd_matches_jax(keeptrials):
    pdata, jdata = _analog([400, 400, 300, 400, 400], 5, seed=16)
    kw = dict(method="csd", tapsmofrq=4, keeptrials=keeptrials)
    out = spt.connectivityanalysis(pdata, **kw)
    ref = spy.connectivityanalysis(jdata, **kw)
    _assert_same(out, ref, CSD_REL_TOL, relative=True)
    # ragged trials are padded to the longest: one (1, 201, 5, 5) block each
    assert out.data.shape == ((5 if keeptrials else 1), 201, 5, 5)


def test_ppc_rejects_keeptrials_and_single_trial():
    pdata, _ = _analog([200] * 4, 2)
    with pytest.raises(SPYValueError):
        spt.connectivityanalysis(pdata, method="ppc", keeptrials=True)
    single, _ = _analog([200], 2)
    with pytest.raises(SPYValueError):
        spt.connectivityanalysis(single, method="ppc")


def test_channelcmb_needs_spectral_data():
    pdata, _ = _analog([200] * 4, 3)
    with pytest.raises(SPYTypeError):
        spt.connectivityanalysis(pdata, method="csd", channelcmb=[[0], [1]])


def test_launch_counters_stay_zero_on_cpu():
    pdata, _ = _analog([200] * 4, 2, seed=9)
    ppc_kernels.ppc_accumulate_tiled.launches = 0
    csd_kernels.csd_accumulate.launches = 0
    spt.connectivityanalysis(pdata, method="ppc", tapsmofrq=4)
    spt.connectivityanalysis(pdata, method="csd", tapsmofrq=4)
    assert ppc_kernels.ppc_accumulate_tiled.launches == 0
    assert csd_kernels.csd_accumulate.launches == 0


# -- connectivityanalysis from SpectralData --------------------------------- #

CMB = [["channel1", "channel3"], ["channel2", "channel5", "channel6"]]


@pytest.mark.parametrize("method", ["coh", "csd", "ppc"])
@pytest.mark.parametrize("channelcmb", [None, CMB])
def test_spectral_input_matches_jax(method, channelcmb):
    """coh, csd and ppc from complex SpectralData; ppc takes the two-pass
    route (single-trial dyadic product, then the resultant reduction).
    csd with channelcmb is held against the JAX package's full csd cut to
    the block: its own channelcmb csd reads back through a Hermitian pack
    that assumes a square block (ROADMAP Queue 3)."""
    pdata, jdata = _spectral(12, 1, 2, 30, 6, seed=17)
    kw = dict(method=method, channelcmb=channelcmb)
    out = spt.connectivityanalysis(pdata, **kw)
    tol, rel = (CSD_REL_TOL, True) if method == "csd" else (PPC_TOL, False)
    if method == "csd" and channelcmb is not None:
        full = spy.connectivityanalysis(jdata, method="csd")
        want = np.asarray(full.data)[:, :, [0, 2]][:, :, :, [1, 4, 5]]
        got = np.asarray(out.data)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() / np.abs(want).max() < tol
        assert list(out.channel_i) == CMB[0] and list(out.channel_j) == CMB[1]
        assert np.array_equal(out.freq, full.freq)
        assert np.array_equal(out.trialdefinition, full.trialdefinition)
        return
    ref = spy.connectivityanalysis(jdata, **kw)
    _assert_same(out, ref, tol, relative=rel)
    if channelcmb is not None:
        assert out.data.shape[-2:] == (2, 3)


def test_spectral_input_time_resolved_csd_and_selection():
    """Two time windows per trial, a trial selection and a frequency
    selection: the per-window compensated sum and the selector's freq."""
    pdata, jdata = _spectral(9, 2, 3, 20, 4, seed=18)
    kw = dict(method="csd", select={"trials": [0, 1, 4, 5, 8], "frequency": [6, 30]})
    out = spt.connectivityanalysis(pdata, **kw)
    ref = spy.connectivityanalysis(jdata, **kw)
    _assert_same(out, ref, CSD_REL_TOL, relative=True)
    assert out.data.shape[0] == 2


def test_spectral_input_rejects_real_spectra_and_ignores_taper_options():
    pdata, jdata = _spectral(4, 1, 1, 5, 2)
    with pytest.warns(RuntimeWarning, match="tapsmofrq"):
        out = spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4)
    _assert_same(out, spy.connectivityanalysis(jdata, method="coh", tapsmofrq=4), PPC_TOL)
    real = spt.SpectralData(data=np.ones((4, 1, 5, 2), np.float32), samplerate=FS,
                            trialdefinition=np.asarray(pdata.trialdefinition))
    with pytest.raises(SPYValueError):
        spt.connectivityanalysis(real, method="coh")
