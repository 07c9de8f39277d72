# -*- coding: utf-8 -*-
#
# Mesh invariance of the port (the twin of tests/test_mesh_invariance.py):
# every frontend computes on a 4 x 2 (trial x channel) mesh of eight CPU
# positions what it computes with parallel=False, at the JAX mesh
# tolerance ATOL = 1e-6, Granger included: the port's Granger CSD is
# float64 and keeps its channels whole on the mesh, so its sharded Granger
# sits far inside the JAX package's 2e-2 (measured max |d| 1.8e-7 at 2
# channels and 1.0e-7 at 16 on the CPU: each trial shard's CSD partial is
# rounded to complex64 before the shards are summed). Coherence and PPC on the port's mesh are also held to
# the JAX package on its own 4 x 2 `testmesh`, at the port's coh/ppc
# parity tolerances (1e-5, tests/test_torch_connectivity.py and
# tests/test_torch_ppc.py). The mesh really splits: the coherence chunk
# of 12 trials is four blocks of 4 rows, the last all padding (n_valid 0),
# and the channel stage runs on 2-channel pieces.

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.connectivity import ST_compRoutines
from syncopy_tpu_torch.engine import routine

torch.set_num_threads(1)

ATOL = 1e-6
#: the port's Granger on the mesh against parallel=False (measured max
#: |d| 1.8e-7 on the CPU; the JAX package's bound is 2e-2)
GRANGER_ATOL = ATOL
#: the port's coh/ppc parity with the JAX package
PARITY_TOL = 1e-5


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    previous = spt.set_device("cpu")
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)
    spt.cluster_cleanup()


@pytest.fixture(scope="module")
def mesh():
    """The counterpart of the JAX tests' `testmesh`: 4 x 2 positions, all
    on the CPU."""
    return spt.make_mesh(n_trial=4, n_channel=2, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def adata():
    return spt.synthdata.ar2_network(nTrials=12, AdjMat=np.zeros((4, 4)), nSamples=400, seed=8)


def _both(frontend, data, mesh, **kw):
    solo = frontend(data, parallel=False, **kw)
    with spt.use_mesh(mesh):
        dist = frontend(data, parallel=True, **kw)
    return np.asarray(solo.data), np.asarray(dist.data)


def test_mtmfft(adata, mesh):
    a, b = _both(spt.freqanalysis, adata, mesh, method="mtmfft", tapsmofrq=2, keeptrials=True)
    assert np.allclose(a, b, atol=ATOL)


def test_mtmfft_trialaverage(adata, mesh):
    a, b = _both(spt.freqanalysis, adata, mesh, method="mtmfft", taper="hann",
                 keeptrials=False)
    assert np.allclose(a, b, atol=ATOL)


def test_wavelet(adata, mesh):
    a, b = _both(spt.freqanalysis, adata, mesh, method="wavelet", foi=np.arange(10, 60, 10.0))
    assert np.allclose(a, b, atol=ATOL)


def test_superlet(adata, mesh):
    a, b = _both(spt.freqanalysis, adata, mesh, method="superlet",
                 foi=np.arange(10, 60, 10.0), order_max=5)
    assert np.allclose(a, b, atol=ATOL)


def test_mtmconvol(adata, mesh):
    a, b = _both(spt.freqanalysis, adata, mesh, method="mtmconvol", t_ftimwin=0.1,
                 taper="hann")
    assert np.allclose(a, b, atol=ATOL, equal_nan=True)


def test_coherence(adata, mesh, monkeypatch):
    made, pieces = [], []
    original_run = routine.ComputationalRoutine._run
    original_stage = ST_compRoutines.CrossSpectra.channel_stage

    def keep(self, data, out):
        made.append(self)
        return original_run(self, data, out)

    def stage(self, batch, **cfg):
        pieces.append(tuple(batch.shape))
        return original_stage(self, batch, **cfg)

    monkeypatch.setattr(routine.ComputationalRoutine, "_run", keep)
    monkeypatch.setattr(ST_compRoutines.CrossSpectra, "channel_stage", stage)
    a, b = _both(spt.connectivityanalysis, adata, mesh, method="coh", tapsmofrq=2)
    assert np.allclose(a, b, atol=ATOL)
    plan = made[-1].chunk_plan[0]
    assert plan["chunk"] == 16 and plan["shard_rows"] == [[4, 4, 4, 0]]
    # one unsplit stage without the mesh, then a 2-channel piece per
    # channel position of every trial shard
    assert pieces[0] == (16, 400, 4) and pieces[1:] == [(4, 400, 2)] * 8


def test_coherence_matches_the_jax_mesh(adata, mesh, testmesh):
    jdata = spy.synthdata.ar2_network(nTrials=12, AdjMat=np.zeros((4, 4)), nSamples=400,
                                      seed=8)
    with spt.use_mesh(mesh):
        got = np.asarray(spt.connectivityanalysis(adata, method="coh", tapsmofrq=2).data)
    with spy.use_mesh(testmesh):
        want = np.asarray(spy.connectivityanalysis(jdata, method="coh", tapsmofrq=2).data)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < PARITY_TOL


def test_granger(mesh):
    AdjMat = np.zeros((2, 2))
    AdjMat[0, 1] = 0.25
    ad = spt.synthdata.ar2_network(nTrials=40, AdjMat=AdjMat, nSamples=500, seed=8)
    solo = spt.connectivityanalysis(ad, method="granger", tapsmofrq=3, parallel=False)
    with spt.use_mesh(mesh):
        dist = spt.connectivityanalysis(ad, method="granger", tapsmofrq=3, parallel=True)
    assert solo.info["converged"] and dist.info["converged"]
    a, b = np.asarray(solo.data), np.asarray(dist.data)
    assert np.allclose(a, b, atol=GRANGER_ATOL)
    band = slice(20, 80)
    assert a[0, band, 0, 1].mean() > 5 * abs(a[0, band, 1, 0]).mean()
    assert b[0, band, 0, 1].mean() > 5 * abs(b[0, band, 1, 0]).mean()


def test_granger_wide_channel_bound(mesh):
    """The 16-channel coupled network of the JAX test: the mesh's
    deviation under the bound and far below the estimator's own
    trial-sampling noise (the half-split delta)."""
    C, nT, nS = 16, 160, 300
    Adj = spt.synthdata.mk_RandomAdjMat(nChannels=C, max_coupling=2.0 / C, seed=3)
    ad = spt.synthdata.ar2_network(nTrials=nT, AdjMat=Adj, nSamples=nS, seed=3)
    solo = spt.connectivityanalysis(ad, method="granger", tapsmofrq=3, parallel=False)
    with spt.use_mesh(mesh):
        dist = spt.connectivityanalysis(ad, method="granger", tapsmofrq=3, parallel=True)
    assert solo.info["converged"] and dist.info["converged"]
    a, b = np.asarray(solo.data), np.asarray(dist.data)
    d = np.abs(a - b)
    assert d.max() < GRANGER_ATOL
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999
    h1 = spt.connectivityanalysis(ad, method="granger", tapsmofrq=3, parallel=False,
                                  select={"trials": list(range(nT // 2))})
    h2 = spt.connectivityanalysis(ad, method="granger", tapsmofrq=3, parallel=False,
                                  select={"trials": list(range(nT // 2, nT))})
    est = np.asarray(h1.data) - np.asarray(h2.data)
    assert np.sqrt((d ** 2).mean()) < np.sqrt((est ** 2).mean()) / 5


def test_ppc(adata, mesh):
    a, b = _both(spt.connectivityanalysis, adata, mesh, method="ppc", tapsmofrq=2)
    assert np.allclose(a, b, atol=ATOL, equal_nan=True)


def test_ppc_matches_the_jax_mesh(adata, mesh, testmesh):
    jdata = spy.synthdata.ar2_network(nTrials=12, AdjMat=np.zeros((4, 4)), nSamples=400,
                                      seed=8)
    with spt.use_mesh(mesh):
        got = np.asarray(spt.connectivityanalysis(adata, method="ppc", tapsmofrq=2).data)
    with spy.use_mesh(testmesh):
        want = np.asarray(spy.connectivityanalysis(jdata, method="ppc", tapsmofrq=2).data)
    assert got.shape == want.shape
    assert np.nanmax(np.abs(got - want)) < PARITY_TOL


def test_corr(adata, mesh):
    a, b = _both(spt.connectivityanalysis, adata, mesh, method="corr")
    assert np.allclose(a, b, atol=ATOL)


def test_preprocessing(adata, mesh):
    a, b = _both(spt.preprocessing, adata, mesh, filter_class="but", filter_type="lp", freq=80)
    assert np.allclose(a, b, atol=ATOL)


def test_resample(adata, mesh):
    a, b = _both(spt.resampledata, adata, mesh, method="resample", resamplefs=250)
    assert np.allclose(a, b, atol=ATOL)


def test_itc(adata, mesh):
    spec = spt.freqanalysis(adata, method="mtmfft", taper="hann", output="fourier",
                            keeptrials=True)
    a = np.asarray(spt.itc(spec, parallel=False).data)
    with spt.use_mesh(mesh):
        b = np.asarray(spt.itc(spec, parallel=True).data)
    assert np.allclose(a, b, atol=ATOL)


def test_selection_on_mesh(adata, mesh):
    # uneven selected trial count (9 over 4 trial shards) still matches
    sel = {"trials": list(range(9)), "channel": [2, 0, 1]}
    a, b = _both(spt.freqanalysis, adata, mesh, method="mtmfft", taper="hann", select=sel)
    assert np.allclose(a, b, atol=ATOL)


def test_selectdata_copies_on_the_mesh(adata, mesh):
    """selectdata's materializing copy is an engine pass on the mesh: the
    same payload as the host gather, left on the mesh for the next
    analysis."""
    sel = {"trials": [1, 4, 5, 7, 11], "channel": [3, 1], "latency": [0.05, 0.3]}
    host = spt.selectdata(adata, parallel=False, **sel)
    with spt.use_mesh(mesh):
        dist = spt.selectdata(adata, **sel)
        assert dist._device_resident is not None
        assert {len(r.shards) for r in dist._device_resident.records} == {3}
        np.testing.assert_array_equal(np.asarray(dist.data), np.asarray(host.data))
    np.testing.assert_array_equal(dist.trialdefinition, host.trialdefinition)
    np.testing.assert_array_equal(dist.channel, host.channel)
