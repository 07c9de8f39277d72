# -*- coding: utf-8 -*-
# Parity of the port's time-resolved freqanalysis against syncopy_tpu on
# the CPU: mtmconvol (toi "all", an overlap fraction, even and uneven
# arrays with out.time held to the request, odd nperseg, windows at both
# trial edges, per-trial centres, ragged trials, outputs, tapers),
# wavelet (the Morlet, Paul, DOG and Ricker families, optimal scales,
# outputs, explicit toi), superlet (multiplicative and adaptive, the
# magnitude and the complex routes, outputs incl. fourier and angle);
# op-level cwt, superlet, superlet_weights, _scale_buckets and
# WaveletAnalysis; and the engine's workspace hook (chunks sized by the FFT
# bank's bytes give the single-chunk result bit for bit). Bars as in
# test_torch_specest.py: 1e-5 of the JAX maximum; angles only where the
# magnitude exceeds 1e-3 of its maximum.

import jax
import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu.ops import wavelet as jwavelet
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import wavelet as pwavelet
from syncopy_tpu_torch.shared.errors import SPYValueError
from syncopy_tpu_torch.specest import compRoutines as pcr
from test_torch_specest import FS, REL_TOL, _both, _rel_err, assert_same_spectra

torch.set_num_threads(1)

FOI = np.array([12.0, 30.0, 55.0, 90.0, 140.0])


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


def _run(pdata, jdata, **kw):
    return spt.freqanalysis(pdata, **kw), spy.freqanalysis(jdata, **kw)


def _check_angle(pdata, jdata, **kw):
    """output='angle' against the JAX package, compared where the JAX
    magnitude ('abs') exceeds 1e-3 of its maximum."""
    out, ref = _run(pdata, jdata, output="angle", **kw)
    magnitude = np.asarray(spy.freqanalysis(jdata, output="abs", **kw).data)
    assert_same_spectra(out, ref, magnitude=magnitude)


# ------------------------------------------------------------------------ #
# mtmconvol
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("toi, n_time", [
    ("all", 300),
    (0.5, 6),
    (np.linspace(0.0, 0.3, 13), 13),  # even, from the first sample to the trial end
    (np.array([0.0, 0.013, 0.05, 0.051, 0.2, 0.299, 0.3]), 7),  # uneven, both edges
])
def test_mtmconvol_toi(toi, n_time):
    """Odd nperseg (101): centre c takes trial samples from c - 50 on;
    centres 0 and T put half a window past each edge, zero-extended."""
    pdata, jdata = _both([300] * 3, seed=20)
    out, ref = _run(pdata, jdata, method="mtmconvol", t_ftimwin=0.101, toi=toi)
    assert_same_spectra(out, ref)
    assert out.data.shape == (3 * n_time, 1, 51, 3)
    if isinstance(toi, np.ndarray):
        assert np.allclose(out.time[0], toi, rtol=0, atol=1e-9)
        assert (out.irregular_time is None) == (n_time == 13)


def test_mtmconvol_per_trial_centres():
    """Trials with different offsets: one toi array gives each trial its
    own centres (the engine's auxiliary per-trial inputs)."""
    pdata, jdata = _both([400] * 3, seed=21, offsets=[-100, 0, 50])
    toi = np.array([0.05, 0.1, 0.2, 0.3])
    out, ref = _run(pdata, jdata, method="mtmconvol", t_ftimwin=0.064, toi=toi,
                    output="fourier")
    assert_same_spectra(out, ref)


@pytest.mark.parametrize("output", ["pow", "fourier", "imag"])
def test_mtmconvol_multitaper_outputs(output):
    pdata, jdata = _both([256] * 3, seed=22)
    out, ref = _run(pdata, jdata, method="mtmconvol", t_ftimwin=0.1, toi=0.75,
                    tapsmofrq=15, keeptapers=True, output=output)
    assert_same_spectra(out, ref)
    assert list(out.taper) == ["dpss0", "dpss1"]


def test_mtmconvol_angle():
    pdata, jdata = _both([256] * 3, seed=23)
    _check_angle(pdata, jdata, method="mtmconvol", t_ftimwin=0.08, toi=0.5, taper="hamming")


@pytest.mark.parametrize("kw", [
    dict(keeptrials=False, polyremoval=1, foilim=[20, 200]),
    dict(keeptrials=False, polyremoval=None, foi=[15, 60, 61, 300], taper=None),
])
def test_mtmconvol_trial_average_and_options(kw):
    pdata, jdata = _both([300] * 4, seed=24)
    out, ref = _run(pdata, jdata, method="mtmconvol", t_ftimwin=0.05, toi=0.8, **kw)
    assert_same_spectra(out, ref)


def test_mtmconvol_ragged_trials():
    """Ragged trials give ragged nTime when kept; averaging rejects them."""
    pdata, jdata = _both([300, 250, 300, 199], seed=25)
    out, ref = _run(pdata, jdata, method="mtmconvol", t_ftimwin=0.05, toi=0.5)
    assert_same_spectra(out, ref)
    assert list(np.diff(out.trialdefinition[:, :2]).ravel()) == [12, 10, 12, 8]
    with pytest.raises(SPYValueError):
        spt.freqanalysis(pdata, method="mtmconvol", t_ftimwin=0.05, toi=0.5, keeptrials=False)
    with pytest.raises(spy.shared.errors.SPYValueError):
        spy.freqanalysis(jdata, method="mtmconvol", t_ftimwin=0.05, toi=0.5, keeptrials=False)


# ------------------------------------------------------------------------ #
# wavelet
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("wavelet, extra", [
    ("Morlet", {"width": 5}),
    ("Paul", {"order": 6}),
    ("DOG", {"order": 4}),
    ("Ricker", {}),
    ("Marr", {}),
])
def test_wavelet_families(wavelet, extra):
    pdata, jdata = _both([300] * 3, seed=30)
    out, ref = _run(pdata, jdata, method="wavelet", wavelet=wavelet, foi=FOI, **extra)
    assert_same_spectra(out, ref)
    assert out.data.shape == (900, 1, FOI.size, 3)


@pytest.mark.parametrize("output", ["fourier", "abs", "real", "absimag"])
def test_wavelet_outputs(output):
    pdata, jdata = _both([300] * 3, seed=31)
    out, ref = _run(pdata, jdata, method="wavelet", foilim=[20, 60], output=output)
    assert_same_spectra(out, ref)


def test_wavelet_angle():
    pdata, jdata = _both([300] * 3, seed=32)
    _check_angle(pdata, jdata, method="wavelet", foi=FOI)


@pytest.mark.parametrize("kw", [
    dict(),  # the optimal scales
    dict(foi=FOI, toi=np.array([0.01, 0.1, 0.15, 0.29]), polyremoval=1),
    dict(foi=FOI, keeptrials=False, polyremoval=None),
])
def test_wavelet_scales_toi_and_average(kw):
    pdata, jdata = _both([300] * 4, seed=33)
    out, ref = _run(pdata, jdata, method="wavelet", **kw)
    assert_same_spectra(out, ref)
    if "toi" in kw:
        assert np.allclose(out.time[0], kw["toi"], rtol=0, atol=1e-9)


# ------------------------------------------------------------------------ #
# superlet
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("output", ["pow", "abs", "fourier"])
def test_superlet_outputs(adaptive, output):
    pdata, jdata = _both([300] * 3, seed=40)
    out, ref = _run(pdata, jdata, method="superlet", order_max=4, order_min=1, c_1=3,
                    adaptive=adaptive, foi=FOI, output=output)
    assert_same_spectra(out, ref)


@pytest.mark.parametrize("adaptive", [False, True])
def test_superlet_angle(adaptive):
    """The complex route's geometric mean takes the principal complex log,
    as jnp.log does; its phase agrees."""
    pdata, jdata = _both([300] * 3, seed=41)
    _check_angle(pdata, jdata, method="superlet", order_max=3, adaptive=adaptive, foi=FOI)


@pytest.mark.parametrize("kw", [
    dict(order_max=2, c_1=2),  # the optimal scales
    dict(order_max=3, foi=FOI[::-1], adaptive=True, toi=np.array([0.0, 0.1, 0.2])),
    dict(order_max=3, order_min=2, foilim=[40, 48], keeptrials=False),
])
def test_superlet_scales_toi_and_average(kw):
    pdata, jdata = _both([300] * 3, seed=42)
    out, ref = _run(pdata, jdata, method="superlet", **kw)
    assert_same_spectra(out, ref)


# ------------------------------------------------------------------------ #
# ops
# ------------------------------------------------------------------------ #


SCALES = jwavelet.Morlet(6).scale_from_period(1.0 / np.array([4.0, 9.0, 25.0, 70.0, 160.0]))


@pytest.mark.parametrize("name, param", [("Morlet", 6), ("Paul", 4), ("DOG", 2)])
def test_cwt_matches_jax(name, param):
    """Several length buckets (the 4 Hz scale needs the longest FFT); the
    power route for the Morlet."""
    rng = np.random.default_rng(50)
    x = rng.normal(size=(2, 400, 3)).astype(np.float32)
    Ls = [pwavelet.nextpow2(400 + int(np.ceil(10 * s * FS)) + 1) for s in SCALES]
    assert len(pwavelet._scale_buckets(Ls)) > 1
    for power_only in (False, True) if name == "Morlet" else (False,):
        got = pwavelet.cwt(torch.from_numpy(x), getattr(pwavelet, name)(param), SCALES, 1 / FS,
                           power_only=power_only)
        want = np.asarray(jax.vmap(lambda xi: jwavelet.cwt(
            xi, getattr(jwavelet, name)(param), SCALES, 1 / FS, power_only=power_only))(x))
        assert got.dtype == (torch.float32 if power_only else torch.complex64)
        assert got.shape == want.shape
        assert _rel_err(got.numpy(), want) <= REL_TOL


@pytest.mark.parametrize("adaptive", [False, True])
def test_superlet_op_matches_jax(adaptive, monkeypatch):
    """Both routes, in blocks of one scale and in one block."""
    rng = np.random.default_rng(51)
    x = rng.normal(size=(2, 300, 2)).astype(np.float32)
    scales = pwavelet.MorletSL.scale_from_period(1.0 / np.array([10.0, 25.0, 60.0, 130.0]))
    kw = dict(order_max=4, order_min=1, c_1=3, adaptive=adaptive, dt=1 / FS)
    for magnitude_only in (True, False):
        want = np.asarray(jax.vmap(lambda xi: jwavelet.superlet(
            xi, scales, magnitude_only=magnitude_only, **kw))(x))
        got = pwavelet.superlet(torch.from_numpy(x), scales, magnitude_only=magnitude_only, **kw)
        assert _rel_err(got.numpy(), want) <= REL_TOL
        with monkeypatch.context() as m:
            m.setattr(pwavelet, "_SCALE_BLOCK_BYTES", 1)
            blocked = pwavelet.superlet(torch.from_numpy(x), scales,
                                        magnitude_only=magnitude_only, **kw)
        assert torch.equal(blocked, got)


@pytest.mark.parametrize("adaptive", [False, True])
def test_superlet_weights_and_scale_buckets_equal_jax(adaptive):
    scales = pwavelet.MorletSL.scale_from_period(1.0 / np.linspace(5, 150, 17))
    w, orders = pwavelet.superlet_weights(scales, 5, 2, adaptive)
    jw, jorders = jwavelet.superlet_weights(scales, 5, 2, adaptive)
    assert np.array_equal(w, jw) and orders == jorders
    Ls = [256, 2048, 256, 512, 1024, 4096, 512, 128, 2048]
    for max_buckets in (1, 2, 4, 9):
        assert (pwavelet._scale_buckets(Ls, max_buckets)
                == jwavelet._scale_buckets(Ls, max_buckets))
    assert np.array_equal(pwavelet.get_optimal_wavelet_scales(pwavelet.Morlet(6).scale_from_period,
                                                              700, 1 / FS),
                          jwavelet.get_optimal_wavelet_scales(jwavelet.Morlet(6).scale_from_period,
                                                              700, 1 / FS))


def test_wavelet_analysis_matches_jax():
    rng = np.random.default_rng(52)
    x = np.cumsum(rng.normal(size=(128, 2)), axis=0).astype(np.float32)
    got = pwavelet.WaveletAnalysis(x, dt=1 / FS, dj=0.25)
    want = jwavelet.WaveletAnalysis(x, dt=1 / FS, dj=0.25)
    assert np.array_equal(got.scales, want.scales)
    assert _rel_err(got.wavelet_transform, want.wavelet_transform) <= REL_TOL
    assert _rel_err(got.wavelet_power, want.wavelet_power) <= REL_TOL
    assert np.allclose(got.global_wavelet_spectrum, want.global_wavelet_spectrum, rtol=1e-5)
    assert np.allclose(got.reconstruction(), want.reconstruction(), rtol=1e-4, atol=1e-4)
    assert got.wavelet_variance == pytest.approx(want.wavelet_variance, rel=1e-5)
    assert got.s0 == pytest.approx(want.s0)
    assert np.array_equal(got.inside_coi, want.inside_coi)
    assert pwavelet.WaveletTransform is pwavelet.WaveletAnalysis


# ------------------------------------------------------------------------ #
# the engine's workspace hook
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("cls, kw", [
    (pcr.WaveletTransform, dict(method="wavelet", foi=FOI)),
    (pcr.SuperletTransform, dict(method="superlet", order_max=3, foi=FOI, output="fourier")),
])
def test_chunks_follow_the_workspace_hook(cls, kw, monkeypatch):
    """A budget of 2.5 trials' FFT-bank workspace gives chunks of 2, where
    the input and output bytes alone would fit all 6 trials in one; the
    result equals the single-chunk one bit for bit."""
    pdata, _ = _both([300] * 6, seed=60)
    single = np.asarray(spt.freqanalysis(pdata, **kw).data)
    seen = []
    orig = cls.process_batch

    def counting(self, batch, *aux, **cfg):
        shp = tuple(batch.shape[1:])
        out_shape, out_dtype = self.out_per_trial_shapes[shp]
        io_bytes = (np.prod(shp) * 4 + np.prod(out_shape) * out_dtype.itemsize) * 2
        seen.append((batch.shape[0], io_bytes,
                     self.device_bytes_per_trial(shp, out_shape, out_dtype)))
        return orig(self, batch, *aux, **cfg)

    monkeypatch.setattr(cls, "process_batch", counting)
    spt.freqanalysis(pdata, **kw)
    (size, io_bytes, workspace), = seen
    assert size == 6
    budget = int(2.5 * workspace)
    assert routine.chunk_trials(io_bytes, 6, budget) == 8  # what the i/o alone would give
    seen.clear()
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", budget)
    chunked = np.asarray(spt.freqanalysis(pdata, **kw).data)
    assert [size for size, _, _ in seen] == [2, 2, 2]
    assert np.array_equal(chunked, single)
