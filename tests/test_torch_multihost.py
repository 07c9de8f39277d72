# -*- coding: utf-8 -*-
#
# The port's multi-host runtime (the twin of tests/test_sharding.py::
# TestMultiHostDistributed): two processes of
# syncopy_tpu_torch/parallel/multihost_worker.py join a torch.distributed
# cluster on the CPU over gloo through spt.init_distributed, build
# make_mesh() over the positions of both ranks and run coh, csd, ppc and
# granger (tapsmofrq=2), mtmfft with keeptrials, the order-4 Butterworth
# band-pass, timelockanalysis with covariance and the coh jackknife on 41
# trials of a seeded AR(2) network, in chunks of 16 trials (three chunks,
# the last ragged). One spawn per mesh shape runs every frontend: 2 x 1
# (one position a rank), 4 x 1 (two a rank, an all-padding shard in the
# last chunk) and 2 x 2 (each rank one trial shard of two channel
# positions). Each worker checks its result bitwise against rank 0's and
# against a one-process mesh of the same shape, and against its own
# parallel=False call (1e-6, the mesh invariance bar; 1e-5 for the
# jackknife) and float64 (1e-5); here every rank's saved result is held
# bitwise to rank 0's and to a one-process mesh in this process, and to
# the JAX package's parallel=False result at each quantity's parity bar:
# coherence, PPC, mtmfft, timelock and the jackknife 1e-5
# (tests/test_torch_connectivity.py, test_torch_ppc.py,
# test_torch_specest.py, test_torch_timelock.py, test_torch_jackknife.py),
# cross spectra 1e-5 of the maximum, the band-pass 1e-6 of the maximum
# (test_torch_preproc.py). Granger is held to the port's parallel=False
# at the mesh bar instead: the JAX package's AnalogData Granger differs
# from the port's by 1e-3..1e-2 through the demeaned DC bin's rounding
# (tests/test_torch_granger.py compares them on one CSD). The unit tests:
# the keyword mapping of init_distributed and a real one-process join, a
# coordinator that never answers, Mesh.ranks in the key, channel
# positions across ranks, residency off and a resident input read back
# on a cross-process mesh.
#
# The same spawns run the worker's sharded group: apply_fir_time_sharded,
# mtmconvol_time_sharded, cwt_time_sharded, wilson_sf_sharded and
# granger_sharded on the mesh's trial axis over both ranks (a (512, 4)
# recording, a 6-channel CSD of 33 bins). Each rank's gathered result is
# held here bitwise to rank 0's and to the routine on a one-process mesh
# of the same shape in this process, and to the JAX package's sharded
# routine on its 4 x 2 `testmesh` at tests/test_torch_sharding.py's bars
# (FIR, STFT and CWT 1e-5 absolute, Wilson 1e-8 of the maximum, Granger
# that file's quantities); the units: halos as long as the blocks between
# positions of one rank and of two, Wilson on the channel axis (rank 1
# owns none of its positions), Wilson on 3 channels (on 4 x 1, more
# positions than rows), the bytes of the halos and the gather against
# their count from the shapes, and a rank that dies inside Wilson's loop.

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.parallel import mesh as pmesh
from syncopy_tpu_torch.parallel import multihost_worker as worker
from syncopy_tpu_torch.shared.errors import SPYParallelError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a spawn of two ranks may take, and each rank's collective timeout
SPAWN_TIMEOUT, RANK_TIMEOUT = 60, 30

#: mesh shape -> (positions a rank, --mesh)
SHAPES = {"2x1": 1, "4x1": 2, "2x2": 2}
SHARDED = ["apply_fir_time_sharded", "mtmconvol_time_sharded", "cwt_time_sharded",
           "wilson_sf_sharded", "granger_sharded"]
#: tests/test_torch_sharding.py's bars
HALO_TOL, OPS_TOL = 1e-5, 1e-8
FRONTENDS = ["coh", "csd", "ppc", "granger", "mtmfft", "bandpass", "timelock",
             "coh_jackknife"]
#: each quantity's bar against the JAX package: (tolerance, relative to the
#: maximum)
JAX_TOL = {"coh": (1e-5, False), "csd": (1e-5, True), "ppc": (1e-5, False),
           "mtmfft": (1e-5, True), "bandpass": (1e-6, True), "timelock": (1e-5, True),
           "coh_jackknife": (1e-5, False)}
GRANGER_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _compute_on_cpu(monkeypatch):
    previous = spt.set_device("cpu")
    # the worker's chunks of 16 trials
    monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 16)
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)
    spt.cluster_cleanup()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(rank_args, timeout=SPAWN_TIMEOUT, program=("-m", worker.__name__)):
    """Run `program` (the worker) once per entry of `rank_args` (its extra
    arguments) as the ranks of one cluster; returns their (return code,
    output)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    port = str(_free_port())
    world = str(len(rank_args))
    procs = [subprocess.Popen(
        [sys.executable, *program, str(r), world, port, "--device", "cpu", "--backend", "gloo",
         "--timeout", str(RANK_TIMEOUT), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for r, extra in enumerate(rank_args)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.fixture(scope="module", params=list(SHAPES))
def cluster(request, tmp_path_factory):
    """Every rank's results of one two-process run on a mesh shape."""
    shape = request.param
    out = _out_dir(tmp_path_factory, shape)
    args = ["--size", "small", "--reps", "0", "--positions", str(SHAPES[shape]), "--mesh",
            shape, "--out", str(out)]
    for r, (rc, text) in enumerate(_spawn([args, args])):
        assert rc == 0, "rank {} failed:\n{}".format(r, text[-4000:])
        assert "MULTIHOST OK rank {}/2 mesh={}".format(r, shape) in text
    return shape, [dict(np.load(str(out / "rank{}.npz".format(r)))) for r in range(2)]


def _out_dir(tmp_path_factory, shape):
    out = tmp_path_factory.getbasetemp() / ("multihost_" + shape)
    out.mkdir(exist_ok=True)
    return out


@pytest.fixture(scope="module")
def sharded(cluster, tmp_path_factory):
    """Every rank's sharded-group results of the same run: (shape,
    [rank 0's, rank 1's])."""
    shape, _ = cluster
    out = _out_dir(tmp_path_factory, shape)
    return shape, [dict(np.load(str(out / "rank{}_sharded.npz".format(r)))) for r in range(2)]


@pytest.fixture(scope="module")
def adata():
    return worker.small_data(spt)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's parallel=False results on the same data, by
    frontend."""
    n_trials, n_samples, n_chan, seed = worker.SMALL
    adj = np.zeros((n_chan, n_chan))
    adj[0, 1] = adj[2, 3] = 0.25
    jdata = spy.synthdata.ar2_network(nTrials=n_trials, AdjMat=adj, nSamples=n_samples,
                                      seed=seed)

    def conn(method, **kw):
        out = spy.connectivityanalysis(jdata, method=method, tapsmofrq=2, parallel=False, **kw)
        res = {"data": np.asarray(out.data)}
        if kw.get("jackknife"):
            for name in ("jack_var", "jack_bias"):
                res[name] = np.asarray(out._get_extra_dataset(name))
        return res

    tl = spy.timelockanalysis(jdata, covariance=True, parallel=False)
    return {
        "coh": conn("coh"), "csd": conn("csd"), "ppc": conn("ppc"),
        "mtmfft": {"data": np.asarray(spy.freqanalysis(
            jdata, method="mtmfft", tapsmofrq=2, keeptrials=True, parallel=False).data)},
        "bandpass": {"data": np.asarray(spy.preprocessing(
            jdata, filter_class="but", filter_type="bp", freq=[30, 100], order=4,
            parallel=False).data)},
        "timelock": {"avg": np.asarray(tl.avg), "var": np.asarray(tl.var),
                     "cov": np.asarray(tl.cov)},
        "coh_jackknife": conn("coh", jackknife=True),
    }


def _keys(results, frontend):
    return sorted(k.split("/", 1)[1] for k in results if k.startswith(frontend + "/"))


# ------------------------------------------------------------------------ #
# the frontends on a mesh over two processes
# ------------------------------------------------------------------------ #


def test_every_rank_holds_the_same_bits(cluster):
    _, (r0, r1) = cluster
    assert sorted(r0) == sorted(r1)
    assert {k.split("/")[0] for k in r0} == set(FRONTENDS)
    for k in r0:
        assert r0[k].dtype == r1[k].dtype and r0[k].tobytes() == r1[k].tobytes(), k


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_bitwise_equal_to_the_one_process_mesh(cluster, adata, frontend):
    shape, (r0, _) = cluster
    n_trial, n_chan = map(int, shape.split("x"))
    local = spt.make_mesh(n_trial=n_trial, n_channel=n_chan, devices=["cpu"] * (n_trial * n_chan))
    with spt.use_mesh(local):
        want = worker.frontends(spt, "small")[frontend](adata)
    assert sorted(want) == _keys(r0, frontend)
    for k, v in want.items():
        got = r0["{}/{}".format(frontend, k)]
        assert got.dtype == v.dtype and got.shape == v.shape and got.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_matches_the_jax_package(cluster, adata, jax_results, frontend):
    _, (r0, _) = cluster
    if frontend == "granger":
        want = worker.frontends(spt, "small")["granger"](adata, parallel=False)
        tol, rel = GRANGER_ATOL, False
    else:
        want = jax_results[frontend]
        tol, rel = JAX_TOL[frontend]
    assert sorted(want) == _keys(r0, frontend)
    for k, v in want.items():
        got = r0["{}/{}".format(frontend, k)]
        assert got.shape == v.shape, k
        err = np.nanmax(np.abs(got - v))
        if rel:
            err /= np.nanmax(np.abs(v))
        assert err < tol, (k, err)


def test_a_failing_rank_ends_its_peer():
    # rank 0 asks for a 2 x 1 mesh of its own two positions, which does
    # not span the cluster, and raises; rank 1 then fails in its first
    # collective instead of waiting
    t0 = time.perf_counter()
    base = ["--size", "small", "--reps", "0", "--positions", "2", "--timeout", "20"]
    (rc0, out0), (rc1, out1) = _spawn([base + ["--mesh", "2x1"], base + ["--mesh", "2x2"]])
    assert rc0 != 0 and "does not span the cluster" in out0
    assert rc1 != 0 and "MULTIHOST OK" not in out1
    assert time.perf_counter() - t0 < SPAWN_TIMEOUT


# ------------------------------------------------------------------------ #
# init_distributed and the mesh's owner ranks
# ------------------------------------------------------------------------ #


def test_init_distributed_joins_a_one_process_cluster():
    assert spt.init_distributed() is None and not torch.distributed.is_initialized()
    spt.init_distributed(coordinator_address="localhost:{}".format(_free_port()),
                         num_processes=1, process_id=0, local_devices=["cpu", "cpu"],
                         timeout=20)
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert (pmesh.process_rank(), pmesh.process_count()) == (0, 1)
        mesh = spt.make_mesh()
        assert mesh.shape == {"trial": 2, "channel": 1}
        assert mesh.ranks.tolist() == [[0], [0]] and not mesh.crosses_processes
        assert spt.esi_cluster_setup(n_workers=1).ranks.tolist() == [[0]]
        with pytest.raises(SPYParallelError, match="already"):
            spt.init_distributed(coordinator_address="localhost:1", num_processes=1,
                                 process_id=0)
    finally:
        torch.distributed.destroy_process_group()
    # once the group is gone the process is a single host again
    assert pmesh.process_count() == 1 and spt.make_mesh().devices.size == 1


def test_a_coordinator_that_never_answers_raises_within_the_timeout():
    t0 = time.perf_counter()
    with pytest.raises(SPYParallelError, match="could not join"):
        spt.init_distributed(coordinator_address="localhost:{}".format(_free_port()),
                             num_processes=2, process_id=1, timeout=3)
    assert time.perf_counter() - t0 < 30
    assert not torch.distributed.is_initialized() and pmesh.process_count() == 1


def test_mesh_ranks_enter_the_key():
    a = spt.make_mesh(devices=["cpu", "cpu"])
    b = spt.make_mesh(devices=["cpu", "cpu"], ranks=[0, 1])
    assert a.ranks.tolist() == [[0], [0]] and b.ranks.tolist() == [[0], [1]]
    assert a != b and a.key != b.key and hash(a) != hash(b)
    assert "ranks=[0, 1]" in repr(b) and "ranks=[0, 0]" in repr(a)
    assert b.crosses_processes and not a.crosses_processes
    with pytest.raises(spt.shared.errors.SPYValueError, match="one rank per device"):
        spt.make_mesh(devices=["cpu", "cpu"], ranks=[0])


def test_channel_positions_across_ranks_raise(monkeypatch):
    monkeypatch.setattr(pmesh, "process_count", lambda: 2)
    split = spt.make_mesh(n_trial=1, n_channel=2, devices=["cpu", "cpu"], ranks=[0, 1])
    with pytest.raises(SPYParallelError, match="channel positions"):
        pmesh.check_mesh(split)
    # a trial shard's channel positions in one process each: accepted
    pmesh.check_mesh(spt.make_mesh(n_trial=2, n_channel=2, devices=["cpu"] * 4,
                                   ranks=[0, 0, 1, 1]))
    # a rank the cluster does not have
    monkeypatch.setattr(pmesh, "process_count", lambda: 1)
    with pytest.raises(SPYParallelError, match="1 process"):
        pmesh.check_mesh(spt.make_mesh(devices=["cpu", "cpu"], ranks=[0, 1]))


def _decisions(monkeypatch, call):
    """The resident decisions of the routines `call` runs on a mesh whose
    second position belongs to a second process: each routine stops
    before its chunks move (they would need the peer)."""
    seen = []

    def stop(self, data, out):
        seen.append((self._shared, self._resident_mode, self._plan_resident_consume(data)))
        raise RuntimeError("stopped")

    monkeypatch.setattr(pmesh, "process_count", lambda: 2)
    monkeypatch.setattr(routine.ComputationalRoutine, "_run", stop)
    with spt.use_mesh(spt.make_mesh(devices=["cpu", "cpu"], ranks=[0, 1])):
        with pytest.raises(RuntimeError, match="stopped"):
            call()
    return seen


def test_residency_is_off_on_a_cross_process_mesh(monkeypatch, adata):
    bp = dict(filter_class="but", filter_type="bp", freq=[30, 100], order=4)
    seen = _decisions(monkeypatch, lambda: spt.preprocessing(adata, **bp))
    assert seen == [(True, False, None)]
    monkeypatch.undo()
    # the same call in one process keeps its rows on the device
    monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 16)
    resident = spt.preprocessing(adata, **bp)
    assert isinstance(resident._data, routine.DeferredArray)
    # on a cross-process mesh that resident input is read back, not consumed
    seen = _decisions(monkeypatch, lambda: spt.connectivityanalysis(
        resident, method="coh", tapsmofrq=2))
    assert seen == [(True, False, None)]


# ------------------------------------------------------------------------ #
# the sharded routines on a mesh over two processes
# ------------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def one_process():
    """The worker's sharded group on one-process meshes of each shape in
    this process: ``{shape: {routine: {key: numpy array}}}``, filled as
    the shapes come."""
    return {}


def _one_process(one_process, shape):
    if shape not in one_process:
        n_trial, n_chan = map(int, shape.split("x"))
        mesh = spt.make_mesh(n_trial=n_trial, n_channel=n_chan,
                             devices=["cpu"] * (n_trial * n_chan))
        cases = worker.sharded_cases(spt, "small", torch.device("cpu"))
        one_process[shape] = {name: {k: v.numpy() for k, v in case.whole(
            case.run(mesh), torch.device("cpu")).items()} for name, case in cases.items()}
    return one_process[shape]


@pytest.fixture(scope="module")
def jax_sharded(testmesh):
    """The JAX package's sharded routines on its 4 x 2 `testmesh`, on the
    worker's small inputs."""
    import jax.numpy as jnp

    from syncopy_tpu.ops.connectivity import granger_sharded, wilson_sf_sharded
    from syncopy_tpu.ops.filtering import apply_fir_time_sharded
    from syncopy_tpu.ops.stft import mtmconvol_time_sharded
    from syncopy_tpu.ops.wavelet import Morlet, cwt_time_sharded
    from syncopy_tpu_torch.ops import filtering as pfilt
    from syncopy_tpu_torch.ops.windows import make_tapers

    T, C, seed = worker.SMALL_RECORDING
    x = jnp.asarray(np.random.default_rng(seed).normal(size=(T, C)).astype("f4"))
    csd = jnp.asarray(worker.small_csd(spt))
    tapers = make_tapers("hann", None, 16, 16, worker.FS)
    H, Sigma, conv, _ = wilson_sf_sharded(csd, mesh=testmesh, axis_name="trial")
    G, info = granger_sharded(csd, mesh=testmesh, axis_name="trial")
    assert bool(conv) and info["converged"]
    return {
        "apply_fir_time_sharded": {"data": apply_fir_time_sharded(
            x, pfilt.design_wsinc("hamming", 8, 0.1, "lp"), testmesh, axis_name="trial")},
        "mtmconvol_time_sharded": {"data": mtmconvol_time_sharded(
            x, tapers, 16, testmesh, axis_name="trial")},
        "cwt_time_sharded": {"data": cwt_time_sharded(
            x, Morlet(6), np.array([0.005, 0.01, 0.02]), 1.0 / worker.FS, testmesh)},
        "wilson_sf_sharded": {"H": H, "Sigma": Sigma},
        "granger_sharded": {"G": G},
    }


def _sharded_keys(results, routine):
    return sorted(k.split("/", 1)[1] for k in results if k.startswith(routine + "/"))


@pytest.mark.parametrize("routine", SHARDED)
def test_sharded_every_rank_holds_the_same_bits(sharded, routine):
    _, (r0, r1) = sharded
    keys = _sharded_keys(r0, routine)
    assert keys and keys == _sharded_keys(r1, routine)
    for k in keys:
        a, b = r0[routine + "/" + k], r1[routine + "/" + k]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("routine", SHARDED)
def test_sharded_bitwise_equal_to_the_one_process_mesh(sharded, one_process, routine):
    shape, (r0, _) = sharded
    want = _one_process(one_process, shape)[routine]
    assert sorted(want) == _sharded_keys(r0, routine)
    for k, v in want.items():
        got = r0[routine + "/" + k]
        assert got.dtype == v.dtype and got.shape == v.shape and got.tobytes() == v.tobytes(), k


@pytest.mark.parametrize("routine", SHARDED)
def test_sharded_matches_the_jax_package(sharded, jax_sharded, routine):
    _, (r0, _) = sharded
    for k, v in jax_sharded[routine].items():
        got, want = r0[routine + "/" + k], np.asarray(v)
        assert got.shape == want.shape, k
        if routine == "wilson_sf_sharded":
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1)
            assert err < OPS_TOL, (k, err)
        else:
            err = np.abs(got - want).max()
            assert err < (1e-5 if routine == "granger_sharded" else HALO_TOL), (k, err)
    if routine == "granger_sharded":
        # test_torch_sharding.py::TestShardedWilson::test_granger_sharded_info's
        # quantities: convergence, its error, G >= 0 and the port's
        # unsharded route within OPS_TOL
        from syncopy_tpu_torch.ops import connectivity as pcon

        G = r0["granger_sharded/G"]
        max_err = r0["granger_sharded/info"][worker.GRANGER_INFO.index("max rel. err")]
        assert r0["granger_sharded/converged"] and max_err < 5e-6
        assert np.all(np.isfinite(G)) and np.all(G >= 0)
        reg = pcon.regularize_csd(torch.from_numpy(worker.small_csd(spt)), cond_max=1e4,
                                  eps_max=1e-1)[0]
        want = pcon.granger(reg, *pcon.wilson_sf(reg, nIter=100, rtol=5e-6)[:2]).numpy()
        assert np.abs(G - want).max() < OPS_TOL


def test_halos_as_long_as_the_blocks_across_ranks(sharded):
    # 16 samples over the trial axis' positions, halos of a whole block
    # each way: on 4 x 1 one neighbour of each block is of the same rank
    # and one of the other rank
    shape, results = sharded
    n_pos = int(shape.split("x")[0])
    x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    blocks = pmesh.split_along(x, ["cpu"] * n_pos)
    n = 16 // n_pos
    want = pmesh.halo_exchange(blocks, n, n)
    got = {}
    for res in results:
        got.update({int(k.rsplit("/", 1)[1]): v for k, v in res.items()
                    if k.startswith("local/halo_exchange/")})
    assert sorted(got) == list(range(n_pos))
    for i, w in enumerate(want):
        assert w.shape == (3 * n, 3) and np.array_equal(got[i], w.numpy()), i


def test_a_rank_without_positions_on_the_axis(sharded, one_process):
    # the channel axis is the mesh's first row, all of it rank 0's: rank 1
    # sends nothing, receives each step's error of every frequency block
    # (one per channel position, 8 bytes each), then Sigma and the whole
    # of Hfunc
    shape, (r0, r1) = sharded
    name = "wilson_sf_sharded_channel_axis"
    want = _one_process(one_process, shape)[name]
    steps = int(want["n_iter"])
    F, N = want["H"].shape[:2]
    n_blocks = int(shape.split("x")[1])
    assert want["converged"] and steps == int(r1[name + "/n_iter"])
    for k, v in want.items():
        for res in (r0, r1):
            assert res[name + "/" + k].tobytes() == v.tobytes(), k
    sent, received, _, _ = r1["local/{}/bytes".format(name)]
    assert sent == 0 and received == 8 * n_blocks * steps + (F + 1) * N * N * 16


def test_more_positions_than_wilson_rows(sharded, one_process):
    # 3 channel rows: on 4 x 1 the fourth position holds a frequency block
    # but no row block
    from syncopy_tpu_torch.ops import connectivity as pcon

    shape, (r0, _) = sharded
    name = "wilson_sf_sharded_3ch"
    want = _one_process(one_process, shape)[name]
    for k, v in want.items():
        assert r0[name + "/" + k].tobytes() == v.tobytes(), k
    H0, S0 = pcon.wilson_sf(torch.from_numpy(worker.small_csd(spt)[:, :3, :3].copy()))[:2]
    for got, ref in ((r0[name + "/H"], H0.numpy()), (r0[name + "/Sigma"], S0.numpy())):
        assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1) < OPS_TOL


def test_the_halo_and_gather_bytes_match_their_count(sharded):
    # one boundary between the ranks on every shape: each rank sends its
    # edge samples to the other and receives the other's, then gathers
    # the other's half of the result
    T, C, _ = worker.SMALL_RECORDING
    halos = {"apply_fir_time_sharded": (4, 4, C * 4),
             "mtmconvol_time_sharded": (8, 8, 9 * C * 8),
             "cwt_time_sharded": (101, 101, 3 * C * 8)}
    _, results = sharded
    for name, (left, right, sample_bytes) in halos.items():
        for r, res in enumerate(results):
            # rank 0 sends the end of its block (rank 1's left halo) and
            # receives the start of rank 1's (its right halo)
            sends, receives = (left, right) if r == 0 else (right, left)
            assert tuple(res["local/{}/bytes".format(name)]) == (
                sends * C * 4, receives * C * 4, T // 2 * sample_bytes, T // 2 * sample_bytes), name


DIE_IN_WILSON = """
import os, sys
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.ops import connectivity as pcon
from syncopy_tpu_torch.parallel import multihost_worker as worker
rank, world, port = map(int, sys.argv[1:4])
spt.set_device("cpu")
spt.init_distributed(coordinator_address="localhost:{}".format(port), num_processes=world,
                     process_id=rank, timeout=float(sys.argv[sys.argv.index("--timeout") + 1]))
plus, steps = pcon._plus_operator_onesided, []
def dying(*args):
    steps.append(1)
    if rank == 1 and len(steps) == 3:
        os._exit(7)
    return plus(*args)
pcon._plus_operator_onesided = dying
pcon.wilson_sf_sharded(worker.small_csd(spt), mesh=spt.make_mesh())
print("WILSON DONE", flush=True)
"""


def test_a_rank_that_dies_inside_wilson_ends_its_peer():
    # rank 1 leaves in its third step; rank 0 fails in that step's
    # exchange, well inside its rank timeout
    t0 = time.perf_counter()
    (rc0, out0), (rc1, out1) = _spawn([[], []], program=("-c", DIE_IN_WILSON))
    assert rc1 == 7 and "WILSON DONE" not in out1
    assert rc0 != 0 and "WILSON DONE" not in out0
    assert time.perf_counter() - t0 < RANK_TIMEOUT
