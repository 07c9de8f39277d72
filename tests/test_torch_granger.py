# -*- coding: utf-8 -*-
# Parity of the port's Granger causality (connectivityanalysis(method=
# "granger")) against syncopy_tpu on the CPU. The JAX side runs with x64
# on (tests/conftest.py), so it takes its complex128 route, the one the
# port carries over.
# - ops: regularize_csd (both routes), psd_topup, wilson_sf (alone and
#   batched) and granger on the same seeded complex128 CSDs, within 1e-8,
#   and the host float64 copies; G's dependence on a zero-power DC bin's
#   rounding noise, a fault both packages share;
# - end to end from AnalogData: the CSD stage against the JAX package's
#   exact_fft stage, and the whole call against the JAX package's Granger
#   routine on the port's averaged CSD, within 1e-5 on G. The whole JAX
#   call from AnalogData is not reproducible to that bar even against
#   itself (test_jax_analog_granger_moves_with_float32_dc_rounding);
# - end to end from SpectralData (full, time-resolved, channelcmb, and
#   time-resolved channelcmb against the JAX package's full-matrix result
#   window by window), the rank gate and the non-convergence fallback (on
#   and off), within 1e-5 on G; G's dependence on the channel order, a
#   fault both packages share;
# - the same from spectra the port makes itself (spt.freqanalysis), held
#   to the JAX package's spectra within 1e-6;
# - the errors, the aux-info channel of the engine.

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu.connectivity import AV_compRoutines as jav
from syncopy_tpu.connectivity.ST_compRoutines import CrossSpectra as JaxCrossSpectra
from syncopy_tpu.datatype.continuous_data import CrossSpectralData as JaxCrossSpectralData
from syncopy_tpu.ops import connectivity as jops
from syncopy_tpu.shared.input_processors import process_taper
from syncopy_tpu_torch.connectivity import AV_compRoutines as pav
from syncopy_tpu_torch.connectivity import connectivity_analysis as pca
from syncopy_tpu_torch.connectivity.ST_compRoutines import CrossSpectra
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import connectivity as pops
from syncopy_tpu_torch.shared.errors import SPYValueError

torch.set_num_threads(1)

#: bar for G end to end (absolute)
G_TOL = 1e-5
#: bar for the ops on the same complex128 input (relative to the maximum)
OPS_TOL = 1e-8


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


def _network(n_chan, n_trials, n_samples, seed):
    """(trials, samples, channels) float64 AR(2) network: 0.55/-0.8 poles
    (a spectral peak at 0.2 of the sampling rate), channel 1 drives 0."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n_chan, n_chan))
    adj[1, 0] = 0.25
    m1 = np.diag(np.full(n_chan, 0.55)) + adj.T
    x = rng.normal(size=(n_trials, n_samples, n_chan))
    for t in range(2, n_samples):
        x[:, t] += x[:, t - 1] @ m1.T - 0.8 * x[:, t - 2]
    return x


def _csd(n_chan, n_trials, n_samples, seed, demean=True):
    """Seeded complex128 (F, N, N) trial-averaged hann CSD; with `demean`
    its DC bin is float64 rounding noise, as in Granger's own CSD."""
    x = _network(n_chan, n_trials, n_samples, seed)
    x = x - x.mean(axis=1, keepdims=True)
    tapered = np.hanning(n_samples)[None, :, None] * x
    if demean:
        tapered = tapered - tapered.mean(axis=1, keepdims=True)
    spec = np.fft.rfft(tapered, axis=1)
    return np.einsum("bfi,bfj->fij", spec, spec.conj()) / n_trials


#: the ops' inputs: well conditioned with a DC bin of power, ill
#: conditioned (5 trials on 5 channels), and a demeaned zero-power DC bin
CSDS = {
    "dc_power": lambda: _csd(5, 60, 96, 0, demean=False),
    "ill_conditioned": lambda: _csd(5, 5, 96, 1),
    "zero_power_dc": lambda: _csd(4, 40, 128, 2),
}


def _jax_route(monkeypatch, route):
    """Pick the regularization route in both packages."""
    monkeypatch.setenv("SPY_TPU_FAST_REG", "1" if route == "bisection" else "0")
    monkeypatch.setattr(pops, "_FAST_REG_MIN_CHAN", 0 if route == "bisection" else 10**6)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


# ------------------------------------------------------------------------ #
# ops
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("route", ["eigvalsh", "bisection"])
@pytest.mark.parametrize("case", sorted(CSDS))
def test_regularize_csd_matches_jax(monkeypatch, case, route):
    _jax_route(monkeypatch, route)
    C = CSDS[case]()
    want, weps, wcond = jops.regularize_csd(jnp.asarray(C), cond_max=1e4, eps_max=1e-1)
    got, eps, cond = pops.regularize_csd(torch.from_numpy(C), cond_max=1e4, eps_max=1e-1)
    assert got.dtype == torch.complex128
    assert _rel(got.numpy(), want) < OPS_TOL
    assert float(eps) == float(weps)
    assert abs(float(cond) / float(wcond) - 1) < 1e-6
    if case == "ill_conditioned":
        assert float(eps) > 0  # the loading is what this case exercises


@pytest.mark.parametrize("case", sorted(CSDS))
def test_wilson_sf_matches_jax(case):
    CSDreg = pops.regularize_csd(torch.from_numpy(CSDS[case]()), cond_max=1e4,
                                 eps_max=1e-1)[0].numpy()
    H, Sigma, conv, err, n_iter = pops.wilson_sf(torch.from_numpy(CSDreg), nIter=100, rtol=5e-6)
    wH, wSigma, wconv, werr = jops.wilson_sf(jnp.asarray(CSDreg), nIter=100, rtol=5e-6)
    assert H.shape == tuple(wH.shape) and Sigma.shape == tuple(wSigma.shape)
    assert _rel(H.numpy(), wH) < OPS_TOL
    assert _rel(Sigma.numpy(), wSigma) < OPS_TOL
    assert bool(conv) == bool(wconv)
    if bool(wconv):
        assert abs(float(err) - float(werr)) <= 1e-3 * float(werr)
    else:  # the ill-conditioned case does not converge in either package
        assert float(err) >= 5e-6 and float(werr) >= 5e-6
    assert 0 < int(n_iter) <= 100


@pytest.mark.parametrize("case", sorted(CSDS))
def test_granger_matches_jax(case):
    C = pops.regularize_csd(torch.from_numpy(CSDS[case]()), cond_max=1e4, eps_max=1e-1)[0]
    H, Sigma = pops.wilson_sf(C, nIter=100, rtol=5e-6)[:2]
    got = pops.granger(C, H, Sigma).numpy()
    want = np.asarray(jops.granger(jnp.asarray(C.numpy()), jnp.asarray(H.numpy()),
                                   jnp.asarray(Sigma.numpy())))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < OPS_TOL
    if case == "zero_power_dc":
        assert (got[0] == 0).all()  # the zero-power bin is returned as 0


def test_psd_topup_matches_jax():
    """The safety net for shared regularization: bins without a Cholesky
    factor are lifted until they have one, the others left as they are; a
    leading batch dim as for replicates."""
    C = CSDS["dc_power"]()
    lam_min = np.linalg.eigvalsh(C).min(axis=1)
    eye = np.eye(C.shape[1])
    for k, below in ((3, 1e-6), (7, 2e-6)):  # slightly indefinite bins
        C[k] -= (lam_min[k] + below * np.abs(np.diagonal(C[k])).mean()) * eye
    batch = np.stack([C, CSDS["dc_power"]()])
    got = pops.psd_topup(torch.from_numpy(batch)).numpy()
    want = np.stack([np.asarray(jops.psd_topup(jnp.asarray(c))) for c in batch])
    assert _rel(got, want) < 1e-14
    changed = np.abs(got - batch).max(axis=(2, 3)) > 0
    assert changed[0].nonzero()[0].tolist() == [3, 7] and not changed[1].any()
    assert (np.linalg.eigvalsh(got[0][[3, 7]]).min(axis=1) > 0).all()


def test_host_oracle_matches_jax():
    """The port's numpy copies of the host float64 path."""
    C = CSDS["zero_power_dc"]()
    got = pops.regularize_csd_host(C, cond_max=1e4, eps_max=1e-1)
    want = jops.regularize_csd_host(C, cond_max=1e4, eps_max=1e-1)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    H, Sigma, conv, err = pops.wilson_sf_host(got[0], nIter=100, rtol=5e-6)
    wH, wSigma, wconv, werr = jops.wilson_sf_host(got[0], nIter=100, rtol=5e-6)
    assert np.array_equal(H, wH) and np.array_equal(Sigma, wSigma)
    assert (conv, err) == (wconv, werr)
    assert np.array_equal(pops.granger_host(got[0], H, Sigma),
                          jops.granger_host(got[0], H, Sigma))


def test_device_and_host_wilson_agree():
    """The one-sided torch iteration and the two-sided host one stop at
    the same step of the same iteration."""
    C = pops.regularize_csd(torch.from_numpy(CSDS["zero_power_dc"]()), cond_max=1e4,
                            eps_max=1e-1)[0]
    H, Sigma, conv, err, _ = pops.wilson_sf(C, nIter=100, rtol=5e-6)
    hH, hSigma, hconv, herr = pops.wilson_sf_host(C.numpy(), nIter=100, rtol=5e-6)
    assert _rel(H.numpy(), hH) < OPS_TOL and _rel(Sigma.numpy(), hSigma) < OPS_TOL
    assert bool(conv) == hconv and abs(float(err) - herr) <= 1e-3 * herr


#: both batched device forms, which share one loop
WILSON_FORMS = pytest.mark.parametrize("wilson", [pops.wilson_sf, pops.wilson_sf_twosided],
                                       ids=["one_sided", "two_sided"])


@WILSON_FORMS
def test_batched_wilson_stops_each_element_where_it_would_alone(wilson):
    """A batch of (49, 4, 4) CSDs that stop at different steps: by the
    tolerance (two of them), by the step limit, and at once on a NaN
    factor. Each element stops at the step where it stops alone, with the
    same factor (the batched products may round differently in the last
    bits), and the NaN element leaves the others untouched. Both forms
    stop these elements at the same steps."""
    cases = [(60, 0, False), (6, 6, False), (5, 1, True), (40, 2, True)]
    Cs = [pops.regularize_csd(torch.from_numpy(_csd(4, n, 96, seed, demean=demean)),
                              cond_max=1e4, eps_max=1e-1)[0]
          for n, seed, demean in cases]
    Cs[3][5] = -Cs[3][5]  # negative definite at one bin: NaN Cholesky factor
    H, Sigma, conv, err, n_iter = wilson(torch.stack(Cs), nIter=40, rtol=5e-6)
    for b, C in enumerate(Cs):
        h, s, c, e, n = wilson(C, nIter=40, rtol=5e-6)
        assert int(n_iter[b]) == int(n) and bool(conv[b]) == bool(c)
        assert np.allclose(float(err[b]), float(e), rtol=1e-6, equal_nan=True)
        if b < 3:
            assert _rel(H[b].numpy(), h.numpy()) < 1e-12
            assert _rel(Sigma[b].numpy(), s.numpy()) < 1e-12
    assert conv.tolist() == [True, True, False, False]
    assert n_iter[2] == 40 and n_iter[3] == 1 and 1 < n_iter[0] != n_iter[1] < 40


@WILSON_FORMS
def test_singular_input_gives_nan_not_an_exception(wilson):
    """A CSD without a Cholesky factor and a singular psi give NaN
    through cholesky_ex / inv_ex, as the JAX package does, and no
    exception."""
    C = torch.from_numpy(CSDS["zero_power_dc"]())
    C[5] = -C[5]  # negative definite at one bin
    H, Sigma, conv, err, n_iter = wilson(C, nIter=20, rtol=5e-6)
    assert not bool(conv) and torch.isnan(err) and int(n_iter) == 1
    assert pops._inv_nan(torch.zeros((2, 3, 3), dtype=torch.complex128)).isnan().all()
    lo, hi, lam_max = pops.csd_lam_extents(C[None])
    assert torch.isfinite(lo).all() and (lo <= hi).all()


def test_granger_moves_with_the_dc_rounding_noise():
    """A fault of the complex128 route, recorded in both packages: with a
    demeaned taper the DC bin's CSD is rounding noise. Wilson leaves it
    out of its error but not out of its iteration, and the discrete
    minimum-phase factor depends on its log-power. Other noise of the same
    size at DC alone moves G by over 1e-4, equally in both packages; so G
    is reproducible across two float64 CSD computations only to that."""
    C = CSDS["zero_power_dc"]()
    noise = np.random.default_rng(9).normal(size=(40, 4, 2)) @ [1, 1j]  # (40, 4)
    other = C.copy()
    other[0] = noise.T @ noise.conj() * (np.abs(C[0]).max() / 40)

    def both(csd):
        got = pops.regularize_csd(torch.from_numpy(csd), cond_max=1e4, eps_max=1e-1)[0]
        got = pops.granger(got, *pops.wilson_sf(got, nIter=100, rtol=5e-6)[:2]).numpy()
        want = jops.regularize_csd(jnp.asarray(csd), cond_max=1e4, eps_max=1e-1)[0]
        want = np.asarray(jops.granger(want, *jops.wilson_sf(want, nIter=100, rtol=5e-6)[:2]))
        assert np.abs(got - want).max() < OPS_TOL
        return got

    assert np.abs(both(C) - both(other))[1:].max() > 1e-4


# ------------------------------------------------------------------------ #
# end to end from AnalogData
# ------------------------------------------------------------------------ #


def _dhamala():
    return spy.synthdata.ar2_network(nTrials=120, samplerate=200, nSamples=1000, seed=42)


def _network6():
    adj = spy.synthdata.mk_RandomAdjMat(nChannels=6, seed=3)
    return spy.synthdata.ar2_network(nTrials=100, AdjMat=adj, samplerate=200, nSamples=600,
                                     seed=5)


def _port_analog(jdata):
    return spt.from_arrays(np.asarray(jdata.data), np.asarray(jdata.trialdefinition),
                           jdata.samplerate)


def _assert_granger_equal(out, ref):
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < G_TOL
    assert out.info["converged"] == ref.info["converged"]
    for key in ("reg. factor",):
        if key in ref.info:
            assert out.info[key] == ref.info[key]
    assert out.dimord == ref.dimord
    assert np.array_equal(out.freq, ref.freq)
    assert np.array_equal(out.channel_i, ref.channel_i)
    assert np.array_equal(out.channel_j, ref.channel_j)


ANALOG = {"dhamala": _dhamala, "network6": _network6}


@pytest.mark.parametrize("tapsmofrq", [None, 3])
@pytest.mark.parametrize("name", sorted(ANALOG))
def test_granger_csd_stage_matches_jax(name, tapsmofrq):
    """The float64 CSD (exact_fft) against the JAX package's double-float32
    one: equal off the demeaned DC bin to float32 rounding; at DC both are
    rounding noise."""
    jdata = ANALOG[name]()
    x = np.asarray(jdata.data)
    n_trials = len(jdata.trials)
    T = x.shape[0] // n_trials
    taper, taper_opt = process_taper("hann", None, tapsmofrq, None, keeptapers=False,
                                     foimax=100, samplerate=200.0, nSamples=T, output="pow")
    kw = dict(samplerate=200.0, nSamples=T, taper=taper, taper_opt=taper_opt,
              demean_taper=True, polyremoval=0, exact_fft=True)
    batch = x.reshape(n_trials, T, -1)
    got = CrossSpectra(**kw).process_batch_sum(torch.from_numpy(batch), n_trials,
                                               **CrossSpectra(**kw).cfg)[0].numpy()
    jcr = JaxCrossSpectra(**kw)
    want = np.asarray(jcr.process_batch_sum(jnp.asarray(batch), jnp.int32(n_trials),
                                            **jcr.cfg))[0]
    assert got.dtype == np.complex64
    scale = np.abs(want).max()
    assert np.abs(got[1:] - want[1:]).max() / scale < 1e-6
    assert np.abs(got[0]).max() / scale < 1e-12 and np.abs(want[0]).max() / scale < 1e-12


@pytest.mark.parametrize("tapsmofrq", [None, 3])
@pytest.mark.parametrize("name", sorted(ANALOG))
def test_analog_granger_matches_jax(monkeypatch, name, tapsmofrq):
    """The whole port call against the JAX package's Granger routine
    (its engine, regularization, Wilson, Granger and diagnostics) on the
    port's averaged CSD."""
    jdata = ANALOG[name]()
    seen = {}
    orig = pca._granger

    def capture(st_out, *args):
        seen["csd"] = st_out
        return orig(st_out, *args)

    monkeypatch.setattr(pca, "_granger", capture)
    kw = {} if tapsmofrq is None else {"tapsmofrq": tapsmofrq}
    out = spt.connectivityanalysis(_port_analog(jdata), method="granger", **kw)
    csd = seen["csd"]
    jin = JaxCrossSpectralData(data=np.asarray(csd.data), samplerate=csd.samplerate,
                               trialdefinition=np.asarray(csd.trialdefinition),
                               channel_i=np.asarray(csd.channel_i),
                               channel_j=np.asarray(csd.channel_j), freq=np.asarray(csd.freq))
    ref = JaxCrossSpectralData(dimord=list(JaxCrossSpectralData._defaultDimord))
    av = jav.GrangerCausality(rtol=5e-6, nIter=100, cond_max=1e4)
    av.initialize(jin, ref._stackingDim)
    av.compute(jin, ref)
    _assert_granger_equal(out, ref)
    assert out.info["max rel. err"] < 5e-6 and ref.info["max rel. err"] < 5e-6
    assert abs(out.info["initial cond. num"] / ref.info["initial cond. num"] - 1) < 1e-6
    assert out.data.shape[:2] == (1, 501 if name == "dhamala" else 301)
    assert np.array_equal(out.channel_i, jdata.channel)
    if name == "dhamala":
        f40 = np.argmin(np.abs(out.freq - 40))
        G = np.asarray(out.data)[0, f40]
        assert G[1, 0] > 0.3 and G[0, 1] < 0.1  # channel 1 drives channel 0
    assert out.cfg["connectivityanalysis"]["method"] == "granger"


def test_jax_analog_granger_moves_with_float32_dc_rounding():
    """A fault of the JAX package, recorded (it stays as it is): it tapers
    and demeans in float32, so its demeaned DC bin holds float32 rounding
    noise, which steers the factorization. A constant offset of 2^-20,
    which the demean removes, moves its Granger by over 1e-4; the port's
    float64 stage gives the same G to the bit."""
    jdata = _dhamala()
    x = np.asarray(jdata.data)
    shifted = (x.astype(np.float64) + 2.0**-20).astype(np.float32)
    trl = np.asarray(jdata.trialdefinition)

    def jax_granger(arr):
        jd = spy.AnalogData(data=arr, samplerate=200.0)
        jd.trialdefinition = trl
        return np.asarray(spy.connectivityanalysis(jd, method="granger").data)

    def port_granger(arr):
        return np.asarray(spt.connectivityanalysis(spt.from_arrays(arr, trl, 200.0),
                                                   method="granger").data)

    assert np.abs(jax_granger(x) - jax_granger(shifted)).max() > 1e-4
    assert np.array_equal(port_granger(x), port_granger(shifted))


# ------------------------------------------------------------------------ #
# end to end from SpectralData
# ------------------------------------------------------------------------ #


def _both_spectral(jspec):
    """The port's and a fresh JAX SpectralData built from one array."""
    arr = np.asarray(jspec.data)
    trl = np.asarray(jspec.trialdefinition)
    freq = np.asarray(jspec.freq)
    jd = spy.SpectralData(data=arr, samplerate=jspec.samplerate, freq=freq)
    jd.trialdefinition = trl
    return spt.SpectralData(data=arr, samplerate=jspec.samplerate, freq=freq,
                            trialdefinition=trl), jd


def test_spectral_granger_matches_jax():
    data = spy.synthdata.ar2_network(nTrials=80, samplerate=200, nSamples=800, seed=1)
    spec = spy.freqanalysis(data, method="mtmfft", taper="hann", output="fourier",
                            polyremoval=0, demean_taper=True, keeptrials=True)
    pd, jd = _both_spectral(spec)
    out = spt.connectivityanalysis(pd, method="granger")
    ref = spy.connectivityanalysis(jd, method="granger")
    _assert_granger_equal(out, ref)
    assert out.info["converged"] and out.info["max rel. err"] < 5e-6


def test_time_resolved_granger_matches_jax():
    data = spy.synthdata.ar2_network(nTrials=40, samplerate=200, nSamples=800, seed=3)
    spec = spy.freqanalysis(data, method="mtmconvol", t_ftimwin=1.25, toi=0.5, taper=None,
                            output="fourier", polyremoval=0, demean_taper=True)
    pd, jd = _both_spectral(spec)
    out = spt.connectivityanalysis(pd, method="granger")
    ref = spy.connectivityanalysis(jd, method="granger")
    _assert_granger_equal(out, ref)
    n_win = np.asarray(spec.data).shape[0] // len(spec.trials)
    assert out.data.shape[0] == n_win > 3
    assert out.info["converged"]


@pytest.mark.parametrize("cmb", [[[1], [0]], [[0, 1], [2]], [["channel3"], ["channel1", "channel2"]]])
def test_pairwise_granger_matches_jax(cmb):
    adj = np.zeros((3, 3), dtype=np.float32)
    adj[1, 0] = adj[2, 1] = 0.25
    data = spy.synthdata.ar2_network(nTrials=60, AdjMat=adj, samplerate=200, nSamples=400,
                                     seed=4)
    spec = spy.freqanalysis(data, method="mtmfft", taper="hann", output="fourier",
                            polyremoval=0, demean_taper=True, keeptrials=True)
    pd, jd = _both_spectral(spec)
    out = spt.connectivityanalysis(pd, method="granger", channelcmb=cmb)
    ref = spy.connectivityanalysis(jd, method="granger", channelcmb=cmb)
    _assert_granger_equal(out, ref)
    assert out.info["max rel. err"] == pytest.approx(ref.info["max rel. err"], rel=1e-3)


def _port_spectra(jdata, **kw):
    """The port's own spectra (spt.freqanalysis) of `jdata`'s arrays, held
    to the JAX package's spectra of the same arrays within 1e-6 of their
    maximum."""
    pdata = spt.from_arrays(np.asarray(jdata.data), np.asarray(jdata.trialdefinition),
                            jdata.samplerate)
    pspec = spt.freqanalysis(pdata, **kw)
    got, want = np.asarray(pspec.data), np.asarray(spy.freqanalysis(jdata, **kw).data)
    assert got.shape == want.shape and got.dtype == want.dtype == np.complex64
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    return pspec


def _jax_twin(pspec):
    """A JAX SpectralData of the same array as the port's spectra: the
    Granger stage is compared on one CSD (see the module's header)."""
    jd = spy.SpectralData(data=np.asarray(pspec.data), samplerate=pspec.samplerate,
                          freq=np.asarray(pspec.freq))
    jd.trialdefinition = np.asarray(pspec.trialdefinition)
    return jd


def test_spectral_granger_from_the_ports_spectra():
    """test_spectral_granger_matches_jax with spectra the port made."""
    data = spy.synthdata.ar2_network(nTrials=80, samplerate=200, nSamples=800, seed=1)
    pspec = _port_spectra(data, method="mtmfft", taper="hann", output="fourier",
                          polyremoval=0, demean_taper=True, keeptrials=True)
    out = spt.connectivityanalysis(pspec, method="granger")
    ref = spy.connectivityanalysis(_jax_twin(pspec), method="granger")
    _assert_granger_equal(out, ref)
    assert out.info["converged"] and out.info["max rel. err"] < 5e-6


def test_time_resolved_granger_from_the_ports_spectra():
    """test_time_resolved_granger_matches_jax with spectra the port made."""
    data = spy.synthdata.ar2_network(nTrials=40, samplerate=200, nSamples=800, seed=3)
    pspec = _port_spectra(data, method="mtmconvol", t_ftimwin=1.25, toi=0.5, taper=None,
                          output="fourier", polyremoval=0, demean_taper=True)
    out = spt.connectivityanalysis(pspec, method="granger")
    ref = spy.connectivityanalysis(_jax_twin(pspec), method="granger")
    _assert_granger_equal(out, ref)
    assert out.data.shape[0] == 7 and out.info["converged"]


def test_pairwise_granger_from_the_ports_exact_spectra():
    """test_pairwise_granger_matches_jax with exact_fft spectra the port
    made: the float32 warning stays off, as the spectra's cfg says."""
    adj = np.zeros((3, 3), dtype=np.float32)
    adj[1, 0] = adj[2, 1] = 0.25
    data = spy.synthdata.ar2_network(nTrials=60, AdjMat=adj, samplerate=200, nSamples=400,
                                     seed=4)
    pspec = _port_spectra(data, method="mtmfft", taper="hann", output="fourier",
                          polyremoval=0, demean_taper=True, keeptrials=True, exact_fft=True)
    cmb = [[0, 1], [2]]
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="Granger from precomputed float32")
        out = spt.connectivityanalysis(pspec, method="granger", channelcmb=cmb)
    ref = spy.connectivityanalysis(_jax_twin(pspec), method="granger", channelcmb=cmb)
    _assert_granger_equal(out, ref)


def _mtmconvol_spectra():
    """The time-resolved spectra of test_time_resolved_granger_matches_jax:
    2 channels, 7 windows a trial."""
    data = spy.synthdata.ar2_network(nTrials=40, samplerate=200, nSamples=800, seed=3)
    return spy.freqanalysis(data, method="mtmconvol", t_ftimwin=1.25, toi=0.5, taper=None,
                            output="fourier", polyremoval=0, demean_taper=True)


def _channels_in_order(jspec, order):
    """A JAX SpectralData of `jspec` holding only the channels `order`, in
    that order."""
    jd = spy.SpectralData(data=np.ascontiguousarray(np.asarray(jspec.data)[..., order]),
                          samplerate=jspec.samplerate, freq=np.asarray(jspec.freq))
    jd.trialdefinition = np.asarray(jspec.trialdefinition)
    return jd


@pytest.mark.parametrize("cmb", [[[1], [0]], [[0], [1]]])
def test_time_resolved_pairwise_granger_keeps_every_window(cmb):
    """channelcmb on time-resolved spectra factorizes every window: each
    window equals the JAX package's full-matrix time-resolved Granger of
    the pair's two channels, sender first (the order a pair's 2x2 CSD has,
    see test_granger_depends_on_the_channel_order)."""
    spec = _mtmconvol_spectra()
    pd, _ = _both_spectral(spec)
    out = spt.connectivityanalysis(pd, method="granger", channelcmb=cmb)
    full = spy.connectivityanalysis(_channels_in_order(spec, [cmb[0][0], cmb[1][0]]),
                                    method="granger")
    got, want = np.asarray(out.data), np.asarray(full.data)
    n_win = np.asarray(spec.data).shape[0] // len(spec.trials)
    assert got.shape == (n_win, len(spec.freq), 1, 1) and n_win == 7
    for t in range(n_win):
        assert np.abs(got[t, :, 0, 0] - want[t, :, 0, 1]).max() < G_TOL
    assert out.info["converged"]
    assert np.array_equal(out.trialdefinition, full.trialdefinition)
    assert list(out.channel_i) == [str(np.asarray(pd.channel)[cmb[0][0]])]


def test_jax_pairwise_granger_keeps_only_the_first_window():
    """A fault of the JAX package, recorded (it stays as it is): its
    channelcmb route takes the first window's CSD of time-resolved input
    and returns one window, with no warning."""
    spec = _mtmconvol_spectra()
    _, jd = _both_spectral(spec)
    got = np.asarray(spy.connectivityanalysis(jd, method="granger", channelcmb=[[1], [0]]).data)
    full = np.asarray(spy.connectivityanalysis(_channels_in_order(spec, [1, 0]),
                                               method="granger").data)
    assert got.shape == (1, len(spec.freq), 1, 1) and full.shape[0] == 7
    assert np.abs(got[0, :, 0, 0] - full[0, :, 0, 1]).max() < G_TOL
    assert min(np.abs(got[0, :, 0, 0] - full[t, :, 0, 1]).max() for t in range(1, 7)) > 0.1


def test_granger_depends_on_the_channel_order():
    """A fault of the factorization, recorded in both packages: Wilson
    starts from the Cholesky factor of the zero-lag covariance, which
    depends on the channel order, and converges (to 1e-10 and below) to
    factors whose Granger spectra differ by ~1e-3, not by rounding. So a
    pair's G depends on which channel comes first in its CSD."""
    spec = _mtmconvol_spectra()
    for package in (spt, spy):
        G = []
        for order in ([0, 1], [1, 0]):
            pd, jd = _both_spectral(_channels_in_order(spec, order))
            out = package.connectivityanalysis(pd if package is spt else jd, method="granger")
            assert out.info["converged"]
            G.append(np.asarray(out.data))
        assert np.abs(G[0][..., 1, 0] - G[1][..., 0, 1]).max() > 1e-4


# ------------------------------------------------------------------------ #
# the rank gate and the non-convergence fallback
# ------------------------------------------------------------------------ #


def _small_spectral(n_trials, n_chan, seed):
    data = spy.synthdata.white_noise(nTrials=n_trials, nSamples=128, nChannels=n_chan,
                                     seed=seed)
    spec = spy.freqanalysis(data, method="mtmfft", taper="hann", output="fourier",
                            polyremoval=0, demean_taper=True, keeptrials=True)
    return _both_spectral(spec)


def test_rank_gate_takes_the_host_path_like_jax():
    """4 trials x 1 taper on 6 channels: a singular CSD, so both packages
    take the host path on the regularized matrix. The spectra hold small
    integers, so both CSDs are exact and equal: the regularized matrix
    would otherwise amplify their last-bit differences."""
    spec = np.random.default_rng(7).integers(-8, 9, size=(4, 1, 33, 6, 2))
    spec = (spec[..., 0] + 1j * spec[..., 1]).astype(np.complex64)
    trl = np.array([[k, k + 1, 0] for k in range(4)])
    pd = spt.SpectralData(data=spec, samplerate=64.0, freq=np.arange(33.0),
                          trialdefinition=trl)
    jd = spy.SpectralData(data=spec, samplerate=64.0, freq=np.arange(33.0))
    jd.trialdefinition = trl
    with pytest.warns(RuntimeWarning, match="host float64 path on the regularized matrix"):
        out = spt.connectivityanalysis(pd, method="granger")
    with pytest.warns(RuntimeWarning, match="host float64 path on the regularized matrix"):
        ref = spy.connectivityanalysis(jd, method="granger")
    _assert_granger_equal(out, ref)
    assert "host float64" in out.log
    assert out.info["max rel. err"] == ref.info["max rel. err"]


@pytest.mark.parametrize("fallback", [True, False])
def test_nonconvergence_falls_back_to_the_host_like_jax(monkeypatch, fallback):
    """An unattainable rtol: the device result does not converge, the host
    float64 retry runs with its warning, and the final warning says so.
    With the fallback off (the port's module constant, the JAX package's
    SPY_GRANGER_HOST_FALLBACK=0) the device result stays, with the final
    warning only."""
    for module in (pav, jav):
        orig = module.GrangerCausality.__init__

        def unattainable(self, rtol=5e-6, nIter=100, cond_max=1e4, _orig=orig):
            _orig(self, rtol=1e-300, nIter=2, cond_max=cond_max)

        monkeypatch.setattr(module.GrangerCausality, "__init__", unattainable)
    monkeypatch.setattr(pca, "_GRANGER_HOST_FALLBACK", fallback)
    monkeypatch.setenv("SPY_GRANGER_HOST_FALLBACK", "1" if fallback else "0")
    pd, jd = _small_spectral(10, 2, 5)
    with pytest.warns(RuntimeWarning) as port_warnings:
        out = spt.connectivityanalysis(pd, method="granger")
    with pytest.warns(RuntimeWarning) as jax_warnings:
        ref = spy.connectivityanalysis(jd, method="granger")
    for record in (port_warnings, jax_warnings):
        text = " ".join(str(w.message) for w in record)
        assert ("retrying with the host float64 factorization" in text) == fallback
        assert "did NOT converge" in text
    _assert_granger_equal(out, ref)
    assert out.info["converged"] is False
    assert ("host float64" in out.log) == fallback


def test_no_host_path_when_the_device_converges(monkeypatch, recwarn):
    def refuse(*args):
        raise AssertionError("the host path ran")

    monkeypatch.setattr(pca, "_granger_host_full", refuse)
    out = spt.connectivityanalysis(_port_analog(_network6()), method="granger")
    assert out.info["converged"]
    assert not [w for w in recwarn.list if "host float64" in str(w.message)]


# ------------------------------------------------------------------------ #
# errors and the engine's aux-info channel
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("kw, error, match", [
    ({"foi": [10, 20]}, SPYValueError, "foi"),
    ({"foilim": [10, 20]}, SPYValueError, "foi"),
    ({"keeptrials": True}, SPYValueError, "keeptrials"),
])
def test_granger_rejects(kw, error, match):
    pdata = _port_analog(spy.synthdata.ar2_network(nTrials=20, samplerate=200, nSamples=200,
                                                   seed=0))
    with pytest.raises(error, match=match):
        spt.connectivityanalysis(pdata, method="granger", **kw)


class _MeanWithInfo(routine.ComputationalRoutine):
    """Per-trial means with one per-trial and one per-chunk info key."""

    aux_per_trial = frozenset(["first"])

    def output_trial_shape(self, trial_shape):
        return (1, trial_shape[1]), np.dtype(np.float32)

    def process_batch(self, batch, **cfg):
        info = {"first": batch[:, 0, 0], "chunk_trials": torch.tensor(batch.shape[0])}
        return batch.mean(dim=1, keepdim=True), info

    def process_metadata(self, data, out):
        pass


def test_engine_collects_aux_info_per_trial(monkeypatch):
    # (input + output bytes) x 2 = 816 bytes a trial: 2-trial chunks
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 2000)
    data = np.random.default_rng(12).normal(size=(250, 2)).astype(np.float32)
    trl = np.array([[0, 50, 0], [50, 100, 0], [100, 150, 0], [150, 200, 0], [200, 250, 0]])
    adata = spt.from_arrays(data, trl, 1000.0)
    cr = _MeanWithInfo()
    out = spt.AnalogData()
    cr.initialize(adata, 0, keeptrials=True)
    cr.compute(adata, out)
    assert np.array_equal(cr.aux_info["first"], data[::50, 0])
    assert cr.aux_info["chunk_trials"].tolist() == [2, 2, 1]  # one value per chunk
    assert np.abs(np.asarray(out.data) - data.reshape(5, 50, 2).mean(axis=1)).max() < 1e-6
