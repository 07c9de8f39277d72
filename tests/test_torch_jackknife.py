# -*- coding: utf-8 -*-
# Parity of the port's jackknife (connectivityanalysis(..., jackknife=
# True)) against syncopy_tpu on the CPU.
# - coh: the direct estimate, jack_var and jack_bias within 1e-5 of the
#   JAX package (the bar of tests/test_resident.py:241-242) and of an
#   explicit float64 leave-one-out loop; several chunks; output flavours.
# - granger, held as tests/test_torch_granger.py holds Granger (the JAX
#   package's AnalogData Granger moves with its float32 DC rounding noise,
#   ~1e-3): the replicate CSDs off DC against the JAX package's, and the
#   JAX complex128 GrangerCausality.process_batch on the port's replicate
#   CSDs within 1e-5 on G, with jack_var and jack_bias from those G.
# - the replicate routine alone: the shared regularization of the
#   replicates' mean against the JAX routine within 1e-8, groups under
#   the memory budget, the two-sided device retry of a replicate the
#   one-sided iteration leaves unconverged (against the host iteration);
#   the rank warning; the forced host fallback.

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu.connectivity import AV_compRoutines as jav
from syncopy_tpu.connectivity import connectivity_analysis as jca
from syncopy_tpu.datatype.continuous_data import CrossSpectralData as JaxCross
from syncopy_tpu.statistics import jackknifing as jjk
from syncopy_tpu_torch.connectivity import AV_compRoutines as pav
from syncopy_tpu_torch.connectivity import connectivity_analysis as pca
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.statistics import jackknifing as pjk

torch.set_num_threads(1)

#: bar for coherence, jack_var and jack_bias against the JAX package
JACK_TOL = 1e-5
#: bar for G of the replicates on the same CSDs (absolute)
G_TOL = 1e-5
#: bar for the replicate routine on the same complex input (absolute)
OPS_TOL = 1e-8


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


def _port(jdata):
    return spt.from_arrays(np.asarray(jdata.data), np.asarray(jdata.trialdefinition),
                           jdata.samplerate)


def _jack(obj, name):
    return np.asarray(obj._get_extra_dataset(name))


def _capture(monkeypatch, module, name, store):
    """Wrap ``module.name`` so that each call's positional arguments and
    result land in ``store[name]``."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        result = orig(*args, **kwargs)
        store.setdefault(name, []).append((args, result))
        return result

    monkeypatch.setattr(module, name, wrapper)


def _ar2(n_trials=14, n_samples=300, seed=33, n_chan=None):
    kw = {}
    if n_chan is not None:
        kw["AdjMat"] = spy.synthdata.mk_RandomAdjMat(nChannels=n_chan, seed=seed)
    return spy.synthdata.ar2_network(nTrials=n_trials, samplerate=200, nSamples=n_samples,
                                     seed=seed, **kw)


# ------------------------------------------------------------------------ #
# coherence
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("output", ["abs", "pow", "complex"])
@pytest.mark.parametrize("tapsmofrq", [None, 3])
def test_coh_jackknife_matches_jax(tapsmofrq, output):
    jdata = _ar2(n_chan=3)
    kw = dict(method="coh", jackknife=True, output=output)
    if tapsmofrq is not None:
        kw["tapsmofrq"] = tapsmofrq
    out = spt.connectivityanalysis(_port(jdata), **kw)
    ref = spy.connectivityanalysis(jdata, **kw)
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() < JACK_TOL
    for name in ("jack_var", "jack_bias"):
        mine, theirs = _jack(out, name), _jack(ref, name)
        assert mine.shape == theirs.shape == want.shape and mine.dtype == theirs.dtype
        assert np.abs(mine - theirs).max() < JACK_TOL
    assert (_jack(out, "jack_var") >= 0).all()
    assert np.array_equal(out.freq, ref.freq) and np.array_equal(out.channel_i, ref.channel_i)
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.cfg["connectivityanalysis"] == ref.cfg["connectivityanalysis"]


def test_coh_jackknife_against_an_explicit_loop(monkeypatch):
    """Leave-one-out coherences of the port's single-trial CSDs in
    float64: the replicate mean, then (N - 1) times the sum of squared
    deviations and the bias (N - 1)(mean - direct)."""
    jdata = _ar2(n_trials=10, n_samples=200, seed=4)
    seen = {}
    _capture(monkeypatch, pjk, "trial_avg_replicates", seen)
    out = spt.connectivityanalysis(_port(jdata), method="coh", tapsmofrq=4, jackknife=True)
    ((ensemble,), _), = seen["trial_avg_replicates"]
    csd = np.asarray(ensemble.data).astype(np.complex128)  # (N, F, C, C), a row a trial
    n = csd.shape[0]
    loo = (csd.sum(axis=0)[None] - csd) / (n - 1)

    def coh(c):
        d = np.sqrt(np.abs(np.einsum("...ii->...i", c)))
        return np.abs(c) / (d[..., :, None] * d[..., None, :])

    reps = coh(loo)
    avg = reps.mean(axis=0)
    var = (n - 1) * np.sum(np.abs(reps - avg[None]) ** 2, axis=0)
    bias = (n - 1) * (avg - coh(csd.mean(axis=0)))
    assert np.abs(_jack(out, "jack_var")[0] - var).max() < JACK_TOL
    assert np.abs(_jack(out, "jack_bias")[0] - bias).max() < JACK_TOL


def test_coh_jackknife_through_many_chunks(monkeypatch):
    jdata = _ar2(n_trials=13, n_samples=160, seed=6)
    want = spt.connectivityanalysis(_port(jdata), method="coh", jackknife=True)
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 3 * 2 * 81 * 2 * 2 * 8 * 2)
    got = spt.connectivityanalysis(_port(jdata), method="coh", jackknife=True)
    for name in ("jack_var", "jack_bias"):
        assert np.abs(_jack(got, name) - _jack(want, name)).max() < JACK_TOL


@pytest.mark.parametrize("method", ["csd", "ppc"])
def test_jackknife_only_for_coh_and_granger(method):
    pdata = _port(_ar2(n_trials=4, n_samples=100, seed=1))
    with pytest.warns(RuntimeWarning, match="Jackknife is not available"):
        out = spt.connectivityanalysis(pdata, method=method, jackknife=True)
    assert _jack(out, "jack_var").ndim == 0


# ------------------------------------------------------------------------ #
# Granger
# ------------------------------------------------------------------------ #


@pytest.mark.parametrize("tapsmofrq", [None, 3])
def test_granger_jackknife_matches_the_jax_routine(monkeypatch, tapsmofrq):
    jdata = _ar2(n_trials=16, n_samples=240, seed=5)
    kw = {} if tapsmofrq is None else {"tapsmofrq": tapsmofrq}
    seen, jseen = {}, {}
    _capture(monkeypatch, pjk, "trial_avg_replicates", seen)
    _capture(monkeypatch, pjk, "bias_var", seen)
    _capture(monkeypatch, jjk, "trial_avg_replicates", jseen)
    out = spt.connectivityanalysis(_port(jdata), method="granger", jackknife=True, **kw)
    spy.connectivityanalysis(jdata, method="granger", jackknife=True, **kw)

    # the replicate CSDs: the JAX package's come from float32 spectra, the
    # port's from float64 ones; equal off the demeaned DC bin
    (_, port_reps), = seen["trial_avg_replicates"]
    (_, jax_reps), = jseen["trial_avg_replicates"]
    prep, jrep = np.asarray(port_reps.data), np.asarray(jax_reps.data)
    assert prep.shape == jrep.shape == (16, len(out.freq), 2, 2)
    scale = np.abs(jrep).max()
    assert np.abs(prep[:, 1:] - jrep[:, 1:]).max() / scale < 1e-6
    assert np.abs(prep[:, 0]).max() / scale < 1e-6 and np.abs(jrep[:, 0]).max() / scale < 1e-6

    # the JAX complex128 routine on the port's replicate CSDs
    ((direct, jack_rep), _), = seen["bias_var"]
    cfg = dict(rtol=5e-6, nIter=100, cond_max=1e4)
    G_jax, info = jav.GrangerCausality(**cfg).process_batch(jnp.asarray(prep[:, None]), **cfg)
    G_jax = np.asarray(G_jax)[:, 0]
    G_port = np.asarray(jack_rep.data).reshape(G_jax.shape)
    assert np.isfinite(G_port).all() and np.abs(G_port - G_jax).max() < G_TOL
    assert jack_rep.info["converged"] is bool(np.asarray(info["converged"]).all()) is True
    assert jack_rep.info["reg. factor"] == float(np.asarray(info["reg. factor"])[0])

    # jack_var and jack_bias from those G and the port's direct estimate
    n = len(G_jax)
    mean = G_jax.mean(axis=0, dtype=np.float64)
    bias = (n - 1) * (mean - np.asarray(direct.data)[0])
    var = (n - 1) * ((G_jax - mean[None]) ** 2).sum(axis=0)
    assert np.abs(_jack(out, "jack_bias")[0] - bias).max() < (n - 1) * G_TOL
    assert np.abs(_jack(out, "jack_var")[0] - var).max() < 1e-3 * var.max()
    assert out.info["converged"] and _jack(out, "jack_var").shape == out.data.shape


def _replicate_csds(n_trials, n_chan, n_samples, seed):
    """(R, 1, F, N, N) complex64 leave-one-out hann CSDs of a seeded AR(2)
    network: trials ~ channels, so the regularization has work to do."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_trials, n_samples, n_chan))
    for t in range(2, n_samples):
        x[:, t] += 0.55 * x[:, t - 1] - 0.8 * x[:, t - 2]
    x[:, :, 0] += 0.25 * np.roll(x[:, :, 1], 1, axis=1)
    spec = np.fft.rfft(np.hanning(n_samples)[None, :, None] * x, axis=1)
    csd = np.einsum("bfi,bfj->bfij", spec, spec.conj())
    loo = (csd.sum(axis=0)[None] - csd) / (n_trials - 1)
    return loo[:, None].astype(np.complex64)


@pytest.mark.parametrize("n_trials, n_chan", [(9, 3), (7, 8)])
def test_replicate_routine_matches_jax(n_trials, n_chan):
    """One regularization of the replicates' mean, shared, then a Cholesky
    top-up and one batched Wilson per group; the JAX routine factorizes the
    replicates one after the other."""
    batch = _replicate_csds(n_trials, n_chan, 64, seed=n_chan)
    cfg = dict(rtol=5e-6, nIter=100, cond_max=1e4)
    G, info = pav.GrangerCausality(**cfg).process_batch(torch.from_numpy(batch), **cfg)
    G_jax, info_jax = jav.GrangerCausality(**cfg).process_batch(jnp.asarray(batch), **cfg)
    assert G.shape == tuple(G_jax.shape) and G.dtype == torch.float32
    assert np.abs(G.numpy() - np.asarray(G_jax)).max() < OPS_TOL
    for key in ("converged", "reg. factor"):
        assert np.array_equal(info[key].numpy(), np.asarray(info_jax[key]))
    # the initial condition number of a singular mean reaches 3e10: its
    # smallest eigenvalue is rounding, known to ~1e-16 of the largest
    assert np.allclose(info["initial cond. num"].numpy(), np.asarray(info_jax["initial cond. num"]),
                       rtol=1e-4)
    assert np.allclose(info["max rel. err"].numpy(), np.asarray(info_jax["max rel. err"]),
                       rtol=1e-3)
    if n_chan == 8:  # 6 trials a replicate on 8 channels: the largest loading
        assert float(info["reg. factor"][0]) == -1


def test_replicate_groups_under_the_memory_budget(monkeypatch):
    batch = torch.from_numpy(_replicate_csds(9, 3, 64, seed=3))
    cfg = dict(rtol=5e-6, nIter=100, cond_max=1e4)
    one, info_one = pav.GrangerCausality(**cfg).process_batch(batch, **cfg)
    F = batch.shape[2]
    monkeypatch.setattr(pav, "_REPLICATE_BYTES", 2 * pav._WILSON_TENSORS * F * 9 * 16)
    groups, info = pav.GrangerCausality(**cfg).process_batch(batch, **cfg)
    assert np.abs(groups.numpy() - one.numpy()).max() < 1e-10
    assert np.array_equal(info["converged"].numpy(), info_one["converged"].numpy())


@pytest.mark.parametrize("n_trials, n_chan", [(9, 3), (12, 5)])
def test_two_sided_wilson_is_the_host_iteration(n_trials, n_chan):
    """wilson_sf_twosided, batched, stops where wilson_sf_host stops, with
    its factor."""
    from syncopy_tpu_torch.ops import connectivity as pops

    batch = torch.from_numpy(_replicate_csds(n_trials, n_chan, 64, seed=n_chan)[:4, 0])
    CSD = pops.psd_topup(pops.regularize_csd(batch.to(torch.complex128), cond_max=1e4,
                                             eps_max=1e-1)[0])
    H, Sigma, conv, err, n_iter = pops.wilson_sf_twosided(CSD, nIter=100, rtol=5e-6)
    for b in range(len(CSD)):
        hH, hSigma, hconv, herr = pops.wilson_sf_host(CSD[b].numpy(), nIter=100, rtol=5e-6)
        assert np.abs(H[b].numpy() - hH).max() / np.abs(hH).max() < OPS_TOL
        assert np.abs(Sigma[b].numpy() - hSigma).max() / np.abs(hSigma).max() < OPS_TOL
        assert bool(conv[b]) == hconv and abs(float(err[b]) - herr) <= 1e-3 * herr


def test_unconverged_replicates_retry_on_the_device(monkeypatch):
    """A replicate the one-sided iteration leaves unconverged is factorized
    again by the two-sided one, on the same device: its G is the host
    path's on the same regularized CSD, and every replicate converged."""
    from syncopy_tpu_torch.ops import connectivity as pops

    real = pav.wilson_sf

    def second_fails(CSD, nIter=100, rtol=1e-6):
        H, Sigma, conv, err, n_iter = real(CSD, nIter=nIter, rtol=rtol)
        conv[1], err[1], H[1] = False, 1e3, float("nan")
        return H, Sigma, conv, err, n_iter

    monkeypatch.setattr(pav, "wilson_sf", second_fails)
    batch = torch.from_numpy(_replicate_csds(9, 3, 64, seed=3))
    cfg = dict(rtol=5e-6, nIter=100, cond_max=1e4)
    G, info = pav.GrangerCausality(**cfg).process_batch(batch, **cfg)
    assert info["converged"].all() and np.isfinite(G.numpy()).all()
    rows = batch[:, 0].to(torch.complex128)
    shift, eps, _ = pops.csd_reg_params(rows.mean(dim=0), cond_max=1e4, eps_max=1e-1)
    reg = pops.psd_topup(pops.apply_csd_reg(rows[1], shift, eps, eps_max=1e-1)).numpy()
    H, Sigma, conv, _ = pops.wilson_sf_host(reg, nIter=100, rtol=5e-6)
    want = pops.granger_host(reg, H, Sigma).astype(np.float32)
    assert conv and np.abs(G[1, 0].numpy() - want).max() < 1e-6


def test_jackknife_rank_warning_like_jax(monkeypatch):
    """4 trials x 1 hann taper on 8 channels: leave-one-out rank 3 < 8."""
    monkeypatch.setattr(pca, "_GRANGER_HOST_FALLBACK", False)
    monkeypatch.setenv("SPY_GRANGER_HOST_FALLBACK", "0")
    jdata = spy.synthdata.white_noise(nTrials=4, nSamples=64, nChannels=8, seed=7)
    for package, data in ((spt, _port(jdata)), (spy, jdata)):
        with pytest.warns(RuntimeWarning) as record:
            package.connectivityanalysis(data, method="granger", taper="hann", jackknife=True)
        text = " ".join(str(w.message) for w in record)
        assert "leave-one-out CSDs have rank 3 < 8" in text and "singular" in text


def test_replicate_host_fallback_forced(monkeypatch):
    """Every device factorization, one- and two-sided, reports
    non-convergence: the direct estimate and the replicates are redone on
    the host, with the JAX package's warnings, and equal its host routine
    on the same CSDs."""
    for name in ("wilson_sf", "wilson_sf_twosided"):
        def diverged(CSD, nIter=100, rtol=1e-6, _real=getattr(pav, name)):
            H, Sigma, conv, err, n_iter = _real(CSD, nIter=nIter, rtol=rtol)
            return H, Sigma, torch.zeros_like(conv), torch.full_like(err, 1e3), n_iter

        monkeypatch.setattr(pav, name, diverged)
    seen = {}
    _capture(monkeypatch, pjk, "bias_var", seen)
    _capture(monkeypatch, pca, "_granger_host_replicates", seen)
    jdata = _ar2(n_trials=12, n_samples=160, seed=5)
    with pytest.warns(RuntimeWarning) as record:
        out = spt.connectivityanalysis(_port(jdata), method="granger", tapsmofrq=3,
                                       jackknife=True)
    text = " ".join(str(w.message) for w in record)
    assert "recomputing the replicates" in text and "retrying with the host" in text
    assert out.info["converged"]
    ((replicates, _), _), = seen["_granger_host_replicates"]
    ((_, jack_rep), _), = seen["bias_var"]
    jin = JaxCross(data=np.asarray(replicates.data), samplerate=replicates.samplerate,
                   trialdefinition=np.asarray(replicates.trialdefinition),
                   freq=np.asarray(replicates.freq))
    want = jca._granger_host_replicates(jin, jav.GrangerCausality(rtol=5e-6, nIter=100,
                                                                   cond_max=1e4))
    assert np.array_equal(np.asarray(jack_rep.data), np.asarray(want.data))
    assert np.array_equal(jack_rep.trialdefinition, want.trialdefinition)
    var = _jack(out, "jack_var")
    assert np.isfinite(var).all() and (var >= 0).all() and var.shape == out.data.shape


def test_no_replicate_host_path_when_the_device_converges(monkeypatch, recwarn):
    def refuse(*args):
        raise AssertionError("the host path ran")

    monkeypatch.setattr(pca, "_granger_host_replicates", refuse)
    monkeypatch.setattr(pca, "_granger_host_full", refuse)
    out = spt.connectivityanalysis(_port(_ar2(n_trials=12, n_samples=160, seed=2)),
                                   method="granger", jackknife=True)
    assert out.info["converged"]
    assert not [w for w in recwarn.list if "host float64" in str(w.message)]


def test_jackknife_bias_at_many_trials_needs_float64_coherence(monkeypatch):
    """At 1000 trials the bias (N - 1)(mean(rep) - direct) multiplies the
    replicate coherence's rounding by 999: in float32 that alone is ~1e-4,
    so the port forms the replicate coherence, its mean and the direct
    estimate in float64. The port's jack_bias and jack_var against float64
    from its own single-trial CSDs, and the float32 replicate stage's
    bias, on 1000 trials x 8 channels x 200 samples."""
    from syncopy_tpu_torch.ops.connectivity import normalize_csd

    n, T, C = 1000, 200, 8
    data = np.random.default_rng(0).normal(size=(n * T, C)).astype(np.float32)
    trl = np.array([[k * T, (k + 1) * T, 0] for k in range(n)])
    seen = {}
    _capture(monkeypatch, pjk, "trial_avg_replicates", seen)
    out = spt.connectivityanalysis(spt.from_arrays(data, trl, 1000.0), method="coh",
                                   tapsmofrq=10, jackknife=True)
    ((ensemble,), _), = seen["trial_avg_replicates"]
    csd32 = torch.from_numpy(np.asarray(ensemble.data))  # (n, F, C, C) complex64, a row a trial
    csd = csd32.to(torch.complex128)
    S = csd.sum(dim=0)
    reps = normalize_csd((S[None] - csd) / (n - 1)).double()
    mean = reps.mean(dim=0)
    bias = ((n - 1) * (mean - normalize_csd(S / n).double())).numpy()
    var = ((n - 1) * ((reps - mean) ** 2).sum(dim=0)).numpy()
    assert np.abs(_jack(out, "jack_bias")[0] - bias).max() < JACK_TOL
    assert np.abs(_jack(out, "jack_var")[0] - var).max() / np.abs(var).max() < JACK_TOL

    avg32 = csd32.to(torch.complex128).mean(dim=0).to(torch.complex64)
    reps32 = normalize_csd(avg32 + (avg32 - csd32) / (n - 1))  # float32
    bias32 = ((n - 1) * (reps32.mean(dim=0) - normalize_csd(avg32))).double().numpy()
    assert np.abs(bias32 - bias).max() > 10 * JACK_TOL
