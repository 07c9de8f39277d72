# -*- coding: utf-8 -*-
# The port's synthdata against syncopy_tpu on the CPU. The numpy
# generators must equal the JAX package's bitwise for the same seed. The
# device AR(2) generator draws its noise with torch, so its bits cannot
# equal jax.random's: its recursion (_ar2_scan) is held to the JAX
# package's numpy recursion (_ar2_single) fed the same noise, within 1e-5
# of the maximum (float32 matmul order), and its output to the same seed
# (bitwise) and to the process's spectral peak (within 2 bins of
# ar2_peak_freq over 200 trials, as the JAX generator is).

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu.synthdata.analog import _ar2_single
from syncopy_tpu_torch.synthdata.analog import _ar2_scan

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


SCAN_REL_TOL = 1e-5
ALPHAS = (0.55, -0.8)


def _adj(n_chan):
    adj = np.zeros((n_chan, n_chan), dtype=np.float32)
    adj[1, 0] = 0.25  # channel 1 drives channel 0
    return adj


GENERATORS = {
    "white_noise": lambda pkg: pkg.synthdata.white_noise(nTrials=4, nSamples=200, nChannels=3, seed=5),
    "white_noise_shared_seed": lambda pkg: pkg.synthdata.white_noise(
        nTrials=3, nSamples=100, nChannels=2, seed=5, seed_per_trial=False),
    "linear_trend": lambda pkg: pkg.synthdata.linear_trend(y_max=3.0, nTrials=2, nSamples=150, nChannels=2),
    "harmonic": lambda pkg: pkg.synthdata.harmonic(freq=30, samplerate=500, nTrials=3, nSamples=300, nChannels=2),
    "phase_diffusion": lambda pkg: pkg.synthdata.phase_diffusion(
        freq=20, eps=0.2, samplerate=400, nTrials=3, nSamples=250, nChannels=3, rand_ini=True, seed=9),
    "phase_diffusion_phase": lambda pkg: pkg.synthdata.phase_diffusion(
        freq=20, samplerate=400, nTrials=2, nSamples=250, nChannels=2, return_phase=True, seed=3),
    "ar2_network": lambda pkg: pkg.synthdata.ar2_network(
        AdjMat=_adj(3), nTrials=3, nSamples=300, samplerate=200, seed=11),
    "ar2_network_default": lambda pkg: pkg.synthdata.ar2_network(nTrials=2, nSamples=200, seed=1),
    "red_noise": lambda pkg: pkg.synthdata.red_noise(alpha=0.9, nTrials=3, nSamples=200, nChannels=4, seed=2),
    "poisson_noise": lambda pkg: pkg.synthdata.poisson_noise(
        nTrials=4, nSpikes=300, nChannels=3, nUnits=2, samplerate=1000, seed=4),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_numpy_generator_equals_jax(name):
    got, want = GENERATORS[name](spt), GENERATORS[name](spy)
    assert type(got).__module__.startswith("syncopy_tpu_torch.")
    assert type(got).__name__ == type(want).__name__
    g, w = np.asarray(got.data), np.asarray(want.data)
    assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert np.array_equal(got.trialdefinition, want.trialdefinition)
    assert got.samplerate == want.samplerate


def test_single_trial_generators_and_helpers_equal_jax():
    for pkg_out in zip(*[(pkg.synthdata.white_noise(nTrials=None, nSamples=50, seed=3),
                          pkg.synthdata.mk_RandomAdjMat(nChannels=6, seed=8),
                          pkg.synthdata.ar2_peak_freq(0.55, -0.8, 1000))
                         for pkg in (spt, spy)]):
        got, want = (np.asarray(x) for x in pkg_out)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        spt.synthdata.ar2_peak_freq(0.9, 0.1)


def _single_noise(n_samples, n_chan, seed):
    """The noise _ar2_single draws for `seed`."""
    return np.random.default_rng(seed).normal(size=(n_samples, n_chan)).astype(np.float32)


@pytest.mark.parametrize("n_chan,adj", [(2, "drive"), (5, "random"), (3, "none")])
def test_ar2_scan_matches_the_numpy_recursion(n_chan, adj):
    adj = {"drive": _adj(n_chan), "random": spy.synthdata.mk_RandomAdjMat(n_chan, seed=4),
           "none": np.zeros((n_chan, n_chan), np.float32)}[adj]
    seeds = [3, 17, 29]
    want = np.stack([_ar2_single(adj, 400, ALPHAS, s) for s in seeds])
    noise = torch.from_numpy(np.stack([_single_noise(400, n_chan, s) for s in seeds]))
    m1 = torch.from_numpy(np.diag(np.full(n_chan, ALPHAS[0], np.float32)) + adj.T)
    got = _ar2_scan(noise, m1, ALPHAS[1])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < SCAN_REL_TOL, err
    # the first two samples are the noise itself, and the noise is untouched
    assert np.array_equal(got[:, :2].numpy(), want[:, :2])
    assert np.array_equal(noise.numpy()[0], _single_noise(400, n_chan, seeds[0]))


def test_ar2_network_device_is_deterministic_and_stays_on_the_setting():
    a = spt.synthdata.ar2_network_device(8, AdjMat=_adj(3), nSamples=120, seed=7)
    b = spt.synthdata.ar2_network_device(8, AdjMat=_adj(3), nSamples=120, seed=7)
    c = spt.synthdata.ar2_network_device(8, AdjMat=_adj(3), nSamples=120, seed=8)
    assert isinstance(a, torch.Tensor) and a.device.type == "cpu" and a.dtype == torch.float32
    assert tuple(a.shape) == (8, 120, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    batched = spt.synthdata.ar2_network_batched(8, AdjMat=_adj(3), nSamples=120, seed=7)
    assert isinstance(batched, np.ndarray) and np.array_equal(batched, a.numpy())


def test_ar2_network_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spt.set_device("cuda:0")
    with pytest.raises(RuntimeError, match=r"set_device\("):
        spt.synthdata.ar2_network_device(2, nSamples=10)


def _peak_bins(x, fs):
    """Bin of the trial-averaged periodogram's peak, per channel, and the
    frequency resolution."""
    power = (np.abs(np.fft.rfft(x, axis=1)) ** 2).mean(axis=0)
    return power.argmax(axis=0), fs / x.shape[1]


def test_ar2_network_device_spectral_peak():
    fs = 1000.0
    peak = spy.synthdata.ar2_peak_freq(*ALPHAS, fs)
    got = spt.synthdata.ar2_network_device(200, AdjMat=_adj(2), nSamples=500, seed=42).numpy()
    want = spy.synthdata.ar2_network_batched(200, AdjMat=_adj(2), nSamples=500, seed=42)
    for x in (got, want):
        bins, df = _peak_bins(x, fs)
        # channel 1 drives channel 0 and receives no input itself
        assert abs(bins[1] - round(peak / df)) <= 2, (bins * df, peak)
