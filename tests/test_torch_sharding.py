# -*- coding: utf-8 -*-
#
# Sharding in the port (the twin of tests/test_sharding.py, without its
# multi-host and graft-entry classes: tests/test_torch_multihost.py runs
# the port's cluster): the halo'd time-sharded FIR, STFT
# and CWT and the mesh-sharded Wilson factorization and Granger, each held
# to the JAX package's sharded version on its 4 x 2 `testmesh` and to the
# port's unsharded function, on a 4 x 2 mesh of CPU positions; every
# ValueError guard of the JAX routines, the halos exactly as long as the
# local shard; the engine's channel axis; a trial shard with n_valid = 0;
# and a chain made device-resident on a mesh, consumed on the same mesh
# (bitwise equal to the host route), on another mesh and without one
# (re-split device to device), or through the host where the producer's
# chunk is not a multiple of the consumer's trial shards (the kernels on a
# second card: tests/test_torch_cuda.py). Tolerances:
# FIR, STFT and CWT 1e-5 absolute (the JAX test's), Wilson 1e-8 of the
# maximum in complex128 (tests/test_torch_granger.py's OPS_TOL), engine
# results 1e-6 (the JAX mesh tolerance).

import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import resident, routine
from syncopy_tpu_torch.ops import connectivity as pcon
from syncopy_tpu_torch.ops import filtering as pfilt
from syncopy_tpu_torch.ops import stft as pstft
from syncopy_tpu_torch.ops import wavelet as pwav
from syncopy_tpu_torch.ops.windows import make_tapers

torch.set_num_threads(1)

HALO_TOL = 1e-5
OPS_TOL = 1e-8
ATOL = 1e-6


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
    return spt.make_mesh(n_trial=4, n_channel=2, devices=["cpu"] * 8)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1)


# ------------------------------------------------------------------------ #
# the mesh module
# ------------------------------------------------------------------------ #


class TestMeshHelpers:
    def test_positions_may_repeat_a_device(self, mesh):
        assert mesh.shape == {"trial": 4, "channel": 2}
        assert mesh.device == torch.device("cpu")
        assert mesh == spt.make_mesh(n_trial=4, n_channel=2, devices=["cpu"] * 8)
        assert mesh != spt.make_mesh(n_trial=2, n_channel=4, devices=["cpu"] * 8)

    def test_shard_batch_and_gather(self, mesh):
        from syncopy_tpu_torch.parallel import mesh as pmesh

        x = np.arange(10 * 6 * 4, dtype=np.float32).reshape(10, 6, 4)
        shards, n = pmesh.shard_batch(x, mesh, channel_axis_pos=2)
        assert n == 10 and len(shards) == 4
        assert all(len(p) == 2 and p[0].shape == (3, 6, 2) for p in shards)
        rows = [pmesh.gather_shards(p, "cpu", dim=2) for p in shards]
        padded = np.concatenate([x, np.zeros((2, 6, 4), np.float32)])
        np.testing.assert_array_equal(pmesh.gather_shards(rows, "cpu").numpy(), padded)
        # an uneven channel count stays whole
        shards, _ = pmesh.shard_batch(x[:, :, :3], mesh, channel_axis_pos=2)
        assert all(len(p) == 1 and p[0].shape == (3, 6, 3) for p in shards)
        whole, n = pmesh.shard_batch(x, None)
        assert n == 10 and torch.equal(whole, torch.from_numpy(x))
        assert pmesh.pad_to_multiple(10, 4) == 12 and pmesh.pad_to_multiple(7, 1) == 7
        assert pmesh.trial_sharding(mesh, 3, 2).channel_axis == 2
        one_column = spt.make_mesh(n_trial=4, devices=["cpu"] * 4)
        assert pmesh.trial_sharding(one_column, 3, 2).channel_axis is None
        assert pmesh.replicated_sharding(mesh).ndim is None

    def test_halo_exchange_zero_extends_the_edges(self, mesh):
        from syncopy_tpu_torch.parallel import mesh as pmesh

        x = torch.arange(12.0)[:, None]
        blocks = pmesh.split_along(x, pmesh.axis_devices(mesh, "trial"))
        ext = pmesh.halo_exchange(blocks, 2, 1)
        assert [e[:, 0].tolist() for e in ext] == [
            [0, 0, 0, 1, 2, 3], [1, 2, 3, 4, 5, 6], [4, 5, 6, 7, 8, 9], [7, 8, 9, 10, 11, 0]]

    def test_a_position_must_be_of_the_ports_device_type(self):
        with pytest.raises(spt.shared.errors.SPYValueError, match="port's device"):
            spt.parallel.check_mesh(spt.make_mesh(devices=["cpu", "cuda:0"]))

    def test_init_distributed_without_a_cluster_is_a_no_op(self, mesh):
        spt.init_distributed()
        spt.init_distributed(num_processes=1)
        assert not torch.distributed.is_initialized()
        assert (spt.parallel.process_rank(), spt.parallel.process_count()) == (0, 1)
        assert not mesh.crosses_processes and (mesh.ranks == 0).all()
        assert spt.make_mesh().ranks.tolist() == [[0]]

    def test_init_distributed_maps_the_jax_keywords(self, monkeypatch):
        import datetime

        calls = []

        def record(**kwargs):
            calls.append(kwargs)
            raise RuntimeError("recorded")

        monkeypatch.setattr(torch.distributed, "init_process_group", record)
        with pytest.raises(spt.shared.errors.SPYParallelError, match="rank 1 of 2"):
            spt.init_distributed(coordinator_address="localhost:1234", num_processes=2,
                                 process_id=1, timeout=5)
        assert calls == [{"backend": "gloo", "init_method": "tcp://localhost:1234",
                          "world_size": 2, "rank": 1,
                          "timeout": datetime.timedelta(seconds=5)}]
        # a cluster request names all three; it never goes on single-host
        with pytest.raises(spt.shared.errors.SPYValueError, match="process_id"):
            spt.init_distributed(num_processes=2, process_id=0)
        assert len(calls) == 1 and not torch.distributed.is_initialized()


# ------------------------------------------------------------------------ #
# halo'd FIR
# ------------------------------------------------------------------------ #


class TestHaloFIR:
    def test_matches_unsharded_and_jax(self, mesh, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.filtering import apply_fir_time_sharded as jax_fir_sharded

        rng = np.random.default_rng(0)
        x = rng.normal(size=(1600, 4)).astype("f4")
        kern = pfilt.design_wsinc("hamming", 200, 0.1, "lp")  # odd length 201
        ref = pfilt.apply_fir(torch.from_numpy(x)[None], kern)[0].numpy()
        got = pfilt.apply_fir_time_sharded(x, kern, mesh, axis_name="trial")
        assert len(got) == 4 and all(t.shape == (400, 4) for t in got)
        assert got.shape == (1600, 4)
        got = got.gather().numpy()
        assert np.abs(got - ref).max() < HALO_TOL
        want = np.asarray(jax_fir_sharded(jnp.asarray(x), kern, testmesh, axis_name="trial"))
        assert np.abs(got - want).max() < HALO_TOL

    def test_halo_as_long_as_the_shard(self, mesh):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(400, 2)).astype("f4")  # 100 samples a shard
        kern = pfilt.design_wsinc("hamming", 200, 0.1, "lp")  # halo 100
        ref = pfilt.apply_fir(torch.from_numpy(x)[None], kern)[0].numpy()
        got = pfilt.apply_fir_time_sharded(x, kern, mesh).gather().numpy()
        assert np.abs(got - ref).max() < HALO_TOL
        with pytest.raises(ValueError, match="halo"):
            pfilt.apply_fir_time_sharded(x[:396], kern, mesh)  # 99 a shard

    def test_rejects_even_kernel(self, mesh):
        with pytest.raises(ValueError):
            pfilt.apply_fir_time_sharded(np.zeros((800, 2), "f4"), np.ones(10), mesh)

    def test_rejects_indivisible_length(self, mesh):
        with pytest.raises(ValueError, match="divisible"):
            pfilt.apply_fir_time_sharded(np.zeros((802, 2), "f4"), np.ones(11), mesh)


# ------------------------------------------------------------------------ #
# the engine's channel axis, new paths on the mesh
# ------------------------------------------------------------------------ #


class TestChannelAxisSharding:
    def test_engine_results_invariant(self, mesh):
        data = spt.synthdata.white_noise(nTrials=8, nSamples=512, nChannels=8, seed=0)
        seq = spt.freqanalysis(data, method="mtmfft", taper="hann")
        with spt.use_mesh(mesh):
            par = spt.freqanalysis(data, method="mtmfft", taper="hann")
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=ATOL)

    def test_cross_spectra_with_channel_sharding(self, mesh):
        data = spt.synthdata.ar2_network(nTrials=16, samplerate=200, nSamples=512, seed=1)
        seq = spt.connectivityanalysis(data, method="coh", tapsmofrq=3)
        with spt.use_mesh(mesh):
            par = spt.connectivityanalysis(data, method="coh", tapsmofrq=3)
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=1e-5)

    def test_flags_of_channel_pieces_combine(self, mesh):
        """The preprocessing NaN flags of the two channel pieces combine
        by "any": a NaN in either half flags the trial."""
        rng = np.random.default_rng(3)
        data = rng.normal(size=(6 * 200, 4)).astype("f4")
        data[250, 3] = np.nan  # trial 1, second channel piece
        data[1000, 0] = np.nan  # trial 5, first channel piece
        trl = np.column_stack([np.arange(6) * 200, np.arange(1, 7) * 200, np.zeros(6)])
        adata = spt.from_arrays(data, trl, 1000.0)
        seq = spt.preprocessing(adata, filter_class="but", filter_type="lp", freq=80)
        with spt.use_mesh(mesh):
            par = spt.preprocessing(adata, filter_class="but", filter_type="lp", freq=80)
        np.testing.assert_array_equal(par.info["nan_trials"], seq.info["nan_trials"])
        assert list(par.info["nan_trials"]) == [1, 5]


class TestShardedNewPaths:
    def test_welch_on_mesh(self, mesh):
        d = spt.synthdata.white_noise(nTrials=8, nSamples=512, nChannels=4, seed=21)
        seq = spt.freqanalysis(d, method="welch", t_ftimwin=0.25, toi=0.5)
        with spt.use_mesh(mesh):
            par = spt.freqanalysis(d, method="welch", t_ftimwin=0.25, toi=0.5)
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=ATOL)

    def test_csd_on_mesh(self, mesh):
        d = spt.synthdata.ar2_network(nTrials=16, samplerate=200, nSamples=400, seed=22)
        seq = spt.connectivityanalysis(d, method="csd", tapsmofrq=2)
        with spt.use_mesh(mesh):
            par = spt.connectivityanalysis(d, method="csd", tapsmofrq=2)
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=ATOL)

    @pytest.mark.parametrize("method", ["coh", "ppc"])
    def test_a_shard_of_padding_only(self, method, monkeypatch):
        """5 trials on 4 trial shards: a chunk of 8, blocks of 2 rows, the
        last block all padding; the fused kernels' n_valid = 0 sums
        nothing."""
        made = []
        original = routine.ComputationalRoutine._run

        def keep(self, data, out):
            made.append(self)
            return original(self, data, out)

        monkeypatch.setattr(routine.ComputationalRoutine, "_run", keep)
        d = spt.synthdata.white_noise(nTrials=5, nSamples=300, nChannels=3, seed=4)
        seq = spt.connectivityanalysis(d, method=method, tapsmofrq=4)
        mesh = spt.make_mesh(n_trial=4, devices=["cpu"] * 4)
        with spt.use_mesh(mesh):
            par = spt.connectivityanalysis(d, method=method, tapsmofrq=4)
        assert made[-1].chunk_plan[0]["shard_rows"] == [[2, 2, 1, 0]]
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=ATOL,
                           equal_nan=True)


# ------------------------------------------------------------------------ #
# mesh-sharded Wilson and Granger
# ------------------------------------------------------------------------ #


def _make_csd(N=6, seed=0):
    """Trial-averaged Hann CSD (float64, numpy) of a coupled AR(2)
    network: 101 one-sided bins, not divisible by the 4 positions."""
    adj = spt.synthdata.mk_RandomAdjMat(N, conn_thresh=0.8, max_coupling=0.15, seed=seed)
    adj = adj / max(1.0, 3 * np.abs(np.linalg.eigvals(adj)).max())
    ad = spt.synthdata.ar2_network(AdjMat=adj, nTrials=40, nSamples=200, seed=seed)
    x = np.stack([np.asarray(ad.trials[k], dtype=np.float64) for k in range(40)])
    X = np.fft.rfft(np.hanning(200)[None, :, None] * (x - x.mean(axis=1, keepdims=True)),
                    axis=1)
    return np.einsum("bfi,bfj->fij", X, X.conj()) / 40


class TestShardedWilson:
    def test_matches_single_device_and_jax(self, mesh, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import wilson_sf_sharded as jax_wilson_sharded

        CSD = _make_csd()
        H0, S0, conv0, err0, n0 = pcon.wilson_sf(torch.from_numpy(CSD))
        H1, S1, conv1, err1, n1 = pcon.wilson_sf_sharded(CSD, mesh=mesh, axis_name="trial")
        assert bool(conv0) and bool(conv1) and int(n0) == int(n1)
        assert _rel(H1, H0) < OPS_TOL and _rel(S1, S0) < OPS_TOL
        wH, wS, wconv, werr = jax_wilson_sharded(jnp.asarray(CSD), mesh=testmesh,
                                                 axis_name="trial")
        assert bool(wconv)
        assert _rel(H1, np.asarray(wH)) < OPS_TOL and _rel(S1, np.asarray(wS)) < OPS_TOL

    def test_more_positions_than_rows(self):
        """8 positions along the axis, 6 channel rows: two positions hold no
        row block, every position a frequency block."""
        CSD = _make_csd(seed=1)
        wide = spt.make_mesh(n_trial=8, devices=["cpu"] * 8)
        H0, S0 = pcon.wilson_sf(torch.from_numpy(CSD))[:2]
        H1, S1 = pcon.wilson_sf_sharded(CSD, mesh=wide)[:2]
        assert _rel(H1, H0) < OPS_TOL and _rel(S1, S0) < OPS_TOL

    def test_factorization_property(self, mesh):
        CSD = _make_csd(seed=3)
        H, Sigma, conv, err, _ = pcon.wilson_sf_sharded(CSD, mesh=mesh)
        rebuilt = np.einsum("fij,jk,flk->fil", H.numpy(), Sigma.numpy(), np.conj(H.numpy()))
        assert bool(conv) and np.abs(rebuilt - CSD).max() / np.abs(CSD).max() < 1e-4

    def test_granger_sharded_info(self, mesh, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import granger_sharded as jax_granger_sharded

        CSD = _make_csd(seed=5)
        G, info = pcon.granger_sharded(CSD, mesh=mesh, axis_name="trial")
        G = G.numpy()
        assert G.shape == CSD.shape and np.all(np.isfinite(G)) and np.all(G >= 0)
        assert info["converged"] and info["max rel. err"] < 5e-6
        C = torch.from_numpy(CSD)
        Creg = pcon.regularize_csd(C, cond_max=1e4, eps_max=1e-1)[0]
        want = pcon.granger(Creg, *pcon.wilson_sf(Creg, nIter=100, rtol=5e-6)[:2]).numpy()
        assert np.abs(G - want).max() < OPS_TOL
        jG, jinfo = jax_granger_sharded(jnp.asarray(CSD), mesh=testmesh, axis_name="trial")
        assert jinfo["converged"] and np.abs(G - np.asarray(jG)).max() < 1e-5

    def test_active_mesh_default(self, mesh):
        with spt.use_mesh(mesh):
            H, Sigma, conv, err, _ = pcon.wilson_sf_sharded(_make_csd(seed=7))
        assert bool(conv)

    def test_no_mesh_raises(self):
        assert spt.active_mesh() is None
        with pytest.raises(ValueError):
            pcon.wilson_sf_sharded(_make_csd())
        with pytest.raises(ValueError):
            pcon.granger_sharded(_make_csd())

    def test_a_position_of_another_device_type_raises(self):
        with pytest.raises(spt.shared.errors.SPYValueError, match="port's device"):
            pcon.wilson_sf_sharded(_make_csd(), mesh=spt.make_mesh(devices=["cuda:0"]))


# ------------------------------------------------------------------------ #
# time-sharded STFT and CWT
# ------------------------------------------------------------------------ #


class TestTimeShardedTransforms:
    def test_stft_matches_unsharded_and_jax(self, mesh, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.stft import mtmconvol_time_sharded as jax_stft_sharded

        rng = np.random.default_rng(2)
        T, C, nperseg = 1024, 3, 64
        x = rng.normal(size=(T, C)).astype("f4")
        tapers = make_tapers("hann", None, nperseg, nperseg, 1000.0)
        ref = pstft.mtmconvol(torch.from_numpy(x)[None], torch.from_numpy(tapers), nperseg,
                              hop=1, n_time=T)[0].numpy()
        got = pstft.mtmconvol_time_sharded(x, tapers, nperseg, mesh, axis_name="trial")
        assert len(got) == 4 and got.shape == ref.shape
        got = got.gather().numpy()
        assert np.abs(got - ref).max() < HALO_TOL
        want = np.asarray(jax_stft_sharded(jnp.asarray(x), tapers, nperseg, testmesh,
                                           axis_name="trial"))
        assert np.abs(got - want).max() < HALO_TOL

    def test_stft_power_dpss(self, mesh):
        rng = np.random.default_rng(3)
        T, C, nperseg = 512, 2, 128  # local shards exactly nperseg long
        x = rng.normal(size=(T, C)).astype("f4")
        tapers = make_tapers("dpss", {"Kmax": 3, "NW": 2}, nperseg, nperseg, 1000.0)
        ref = pstft.mtmconvol(torch.from_numpy(x)[None], torch.from_numpy(tapers), nperseg,
                              hop=1, n_time=T, output="pow", keeptapers=False)[0].numpy()
        got = pstft.mtmconvol_time_sharded(x, tapers, nperseg, mesh, output="pow",
                                           keeptapers=False).gather().numpy()
        assert np.abs(got - ref).max() < 1e-4

    def test_stft_guards(self, mesh):
        tapers = make_tapers("hann", None, 64, 64, 1000.0)
        with pytest.raises(ValueError, match="divisible"):
            pstft.mtmconvol_time_sharded(np.zeros((1026, 1), "f4"), tapers, 64, mesh)
        with pytest.raises(ValueError, match="shorter than nperseg"):
            pstft.mtmconvol_time_sharded(np.zeros((252, 1), "f4"), tapers, 64, mesh)

    def test_cwt_matches_unsharded_and_jax(self, mesh, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.wavelet import Morlet as JaxMorlet
        from syncopy_tpu.ops.wavelet import cwt_time_sharded as jax_cwt_sharded

        rng = np.random.default_rng(4)
        T, C = 2048, 2
        dt = 1.0 / 1000.0
        x = rng.normal(size=(T, C)).astype("f4")
        scales = np.array([0.01, 0.02, 0.04])
        ref = pwav.cwt(torch.from_numpy(x), pwav.Morlet(6), scales, dt).numpy()
        got = pwav.cwt_time_sharded(x, pwav.Morlet(6), scales, dt, mesh)
        assert len(got) == 4 and got.shape == ref.shape
        got = got.gather().numpy()
        assert np.abs(got - ref).max() < HALO_TOL
        want = np.asarray(jax_cwt_sharded(jnp.asarray(x), JaxMorlet(6), scales, dt, testmesh))
        assert np.abs(got - want).max() < HALO_TOL

    def test_cwt_halo_as_long_as_the_shard(self, mesh):
        rng = np.random.default_rng(5)
        dt = 1.0 / 1000.0
        scales = np.array([0.0398])  # halo ceil(199) + 1 = 200 samples
        x = rng.normal(size=(800, 1)).astype("f4")  # 200 a shard
        ref = pwav.cwt(torch.from_numpy(x), pwav.Morlet(6), scales, dt).numpy()
        got = pwav.cwt_time_sharded(x, pwav.Morlet(6), scales, dt, mesh).gather().numpy()
        assert np.abs(got - ref).max() < HALO_TOL
        with pytest.raises(ValueError, match="halo"):
            pwav.cwt_time_sharded(x[:796], pwav.Morlet(6), scales, dt, mesh)

    def test_cwt_halo_guard(self, mesh):
        with pytest.raises(ValueError, match="halo"):
            pwav.cwt_time_sharded(np.zeros((1024, 1), "f4"), pwav.Morlet(6), np.array([1.0]),
                                  1.0 / 1000.0, mesh)
        with pytest.raises(ValueError, match="divisible"):
            pwav.cwt_time_sharded(np.zeros((1022, 1), "f4"), pwav.Morlet(6), np.array([0.01]),
                                  1.0 / 1000.0, mesh)

    def test_long_trial_runs_sharded(self, mesh):
        T = 1 << 18
        t = np.arange(T, dtype="f4") / 1000.0
        x = np.sin(2 * np.pi * 40 * t)[:, None].astype("f4")
        scales = np.array([0.004, 0.008])
        spec = pwav.cwt_time_sharded(x, pwav.Morlet(6), scales, 1.0 / 1000.0, mesh)
        mid = spec[2]  # the third of four positions: samples T/2 .. 3T/4
        power = np.abs(mid[:, :1024, 0].numpy())
        assert power[0].mean() > power[1].mean()


# ------------------------------------------------------------------------ #
# device-resident records on a mesh
# ------------------------------------------------------------------------ #


def _chain_input(n_trials=20, seed=7):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_trials * 256, 4)).astype(np.float32)
    trl = np.column_stack([np.arange(n_trials) * 256, np.arange(1, n_trials + 1) * 256,
                           np.full(n_trials, -50)])
    return spt.from_arrays(data, trl, 1000.0)


def _chain(adata):
    pre = spt.preprocessing(adata, filter_class="but", filter_type="bp", freq=[10, 80])
    rs = spt.resampledata(pre, resamplefs=250)
    return pre, rs, spt.connectivityanalysis(rs, method="coh", tapsmofrq=2)


def _host_route(fn, *args):
    saved = resident.RESIDENT_BUDGET
    resident.RESIDENT_BUDGET = 0
    try:
        return fn(*args)
    finally:
        resident.RESIDENT_BUDGET = saved


class TestResidentOnAMesh:
    def test_same_mesh_matches_the_host_route_bitwise(self, mesh):
        adata = _chain_input()
        with spt.use_mesh(mesh):
            routine.reset_transfer_counts()
            pre, rs, coh = _chain(adata)
            moved = routine.transfer_counts()
            _, _, ref = _host_route(_chain, adata)
        # one upload of the input (its 20 trials padded to the chunk of
        # 32), the coherence read back, nothing else
        assert moved["h2d"] == adata.data.nbytes * 32 // 20
        assert moved["d2h"] == np.asarray(coh.data).nbytes
        for obj in (pre, rs):
            res = obj._device_resident
            assert not res.materialized
            # one tensor per trial shard that holds rows: 8 + 8 + 4 of 32
            assert [[t.shape[0] for t in r.shards] for r in res.records] == [[8, 8, 4]]
            assert res.nbytes_device == sum(t.numel() * t.element_size()
                                            for r in res.records for t in r.shards)
        np.testing.assert_array_equal(np.asarray(coh.data), np.asarray(ref.data))

    @pytest.mark.parametrize("consumer", ["other mesh", "no mesh"])
    def test_another_consumer_resplits(self, mesh, consumer, monkeypatch):
        """Records of 8 + 8 + 4 rows on four trial shards, consumed by two
        trial shards of 16 rows (or one chunk without a mesh): re-split
        device to device, no upload."""
        made = []
        original = routine.ComputationalRoutine._run

        def keep(self, data, out):
            made.append(self)
            return original(self, data, out)

        monkeypatch.setattr(routine.ComputationalRoutine, "_run", keep)
        adata = _chain_input()
        with spt.use_mesh(mesh):
            pre = spt.preprocessing(adata, filter_class="but", filter_type="lp", freq=80)
        assert [[t.shape[0] for t in r.shards] for r in pre._device_resident.records] == \
            [[8, 8, 4]]
        other = spt.make_mesh(n_trial=2, devices=["cpu"] * 2) if consumer == "other mesh" \
            else None
        routine.reset_transfer_counts()
        with spt.use_mesh(other):
            spec = spt.freqanalysis(pre, method="mtmfft", taper="hann", keeptrials=True)
        assert routine.transfer_counts()["h2d"] == 0
        assert made[-1].chunk_plan[0]["source"] == "resident"
        want = spt.freqanalysis(spt.from_arrays(np.array(pre.data), np.array(pre.trialdefinition),
                                                pre.samplerate),
                                method="mtmfft", taper="hann", keeptrials=True, parallel=False)
        assert np.abs(np.asarray(spec.data) - np.asarray(want.data)).max() < ATOL

    def test_a_chunk_not_a_multiple_of_the_shards_takes_the_host(self, monkeypatch):
        adata = _chain_input(n_trials=3)
        pre = spt.preprocessing(adata, filter_class="but", filter_type="lp", freq=80,
                                parallel=False)
        assert {r.chunk for r in pre._device_resident.records} == {4}
        made = []
        original = routine.ComputationalRoutine._run

        def keep(self, data, out):
            made.append(self)
            return original(self, data, out)

        monkeypatch.setattr(routine.ComputationalRoutine, "_run", keep)
        wide = spt.make_mesh(n_trial=8, devices=["cpu"] * 8)
        with spt.use_mesh(wide):
            spec = spt.freqanalysis(pre, method="mtmfft", taper="hann")
        assert made[-1].chunk_plan[0]["source"] == "upload"
        want = spt.freqanalysis(pre, method="mtmfft", taper="hann", parallel=False)
        assert np.abs(np.asarray(spec.data) - np.asarray(want.data)).max() < ATOL

    def test_eviction_frees_every_shard(self, mesh, monkeypatch):
        adata = _chain_input()
        with spt.use_mesh(mesh):
            first = spt.preprocessing(adata, filter_class="but", filter_type="lp", freq=80)
            monkeypatch.setattr(resident, "RESIDENT_BUDGET",
                                first._device_resident.nbytes_device)
            spt.preprocessing(adata, filter_class="but", filter_type="hp", freq=20)
        assert first._device_resident.materialized and first._device_resident.records is None
        want = spt.preprocessing(adata, filter_class="but", filter_type="lp", freq=80,
                                 parallel=False)
        np.testing.assert_array_equal(np.asarray(first.data), np.asarray(want.data))
