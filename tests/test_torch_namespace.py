# -*- coding: utf-8 -*-
# The port's top-level namespace, its one-card mesh and its profiler, on
# the CPU: every name of syncopy_tpu.__all__ resolves in syncopy_tpu_torch
# (the twin of tests/test_packagesetup.py::TestNamespace); a mesh of one
# device, and one of two positions, computes what parallel=None does;
# profile() writes a trace file.

import json
import os

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.parallel import mesh as pmesh
from syncopy_tpu_torch.shared.errors import SPYParallelError, SPYValueError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The CPU for the port and no active mesh; both restored after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)
    spt.cluster_cleanup()


@pytest.mark.parametrize("name", spy.__all__)
def test_every_jax_name_resolves(name):
    assert name in spt.__all__
    got, want = getattr(spt, name), getattr(spy, name)
    assert callable(got) == callable(want)
    if isinstance(want, type):
        assert isinstance(got, type) and got.__name__ == want.__name__
        assert got.__module__.startswith("syncopy_tpu_torch.")


def test_port_only_names_and_aliases():
    for name in ("from_arrays", "set_device", "raw_adata_to_mne_raw", "raw_mne_to_adata",
                 "tldata_to_mne_epochs", "mne_epochs_to_tldata", "active_mesh",
                 "esi_cluster_setup", "init_distributed", "WaveletAnalysis", "WaveletTransform"):
        assert callable(getattr(spt, name)), name
    assert spt.Marr is spt.Ricker and spt.Mexican_hat is spt.Ricker
    assert spt.synthdata.__name__ == "syncopy_tpu_torch.synthdata"
    assert spt.mne_conv.__name__ == "syncopy_tpu_torch.io.mne_conv"


def test_one_session_id_and_the_storage_dir(tmp_path, monkeypatch):
    from syncopy_tpu_torch.datatype import util

    assert isinstance(spt.__sessionid__, str) and len(spt.__sessionid__) == 8
    assert spt.__sessionid__ is util.__sessionid__
    assert spt.__storage__ == util.storage_dir()
    monkeypatch.setenv("SPYTMPDIR", str(tmp_path / "store"))
    name = util.gen_session_filename(".analog")
    assert os.path.basename(name).startswith("spy_" + spt.__sessionid__)
    assert os.path.isdir(tmp_path / "store")


def _adata(seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(4 * 200, 3)).astype("f4")
    trl = np.column_stack([np.arange(4) * 200, np.arange(1, 5) * 200, np.zeros(4)])
    return spt.from_arrays(data, trl, 500.0)


def _coh(**kwargs):
    return np.asarray(spt.connectivityanalysis(_adata(), method="coh", tapsmofrq=4, **kwargs).data)


def test_one_device_mesh_computes_what_parallel_none_does():
    want = _coh()
    mesh = spt.make_mesh()
    assert mesh.shape == {"trial": 1, "channel": 1} and mesh.device == torch.device("cpu")
    with spt.use_mesh(mesh):
        assert spt.active_mesh() is mesh
        assert pmesh.resolve_parallel(None) is mesh
        np.testing.assert_array_equal(_coh(), want)
        np.testing.assert_array_equal(_coh(parallel=True), want)
    assert spt.active_mesh() is None
    installed = spt.esi_cluster_setup(n_workers=1, partition="8GBXS")
    assert spt.active_mesh() is installed
    np.testing.assert_array_equal(_coh(parallel=None), want)
    np.testing.assert_array_equal(_coh(parallel=False), want)
    spt.cluster_cleanup()
    assert spt.active_mesh() is None
    with pytest.warns(RuntimeWarning, match="ONE device"):
        np.testing.assert_array_equal(_coh(parallel=True), want)
    spt.init_distributed()


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_two_position_mesh_computes_what_parallel_none_does(shape):
    want = _coh()
    mesh = spt.make_mesh(n_trial=shape[0], n_channel=shape[1], devices=["cpu", "cpu"])
    assert mesh.shape == {"trial": shape[0], "channel": shape[1]}
    with spt.use_mesh(mesh):
        got = _coh()
        np.testing.assert_allclose(_coh(parallel=True), got, rtol=0, atol=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_coh(parallel=False), want)
    # the visible devices are one CPU: no mesh of two without `devices`
    with pytest.raises(SPYParallelError):
        spt.make_mesh(n_trial=2)
    with pytest.raises(SPYParallelError):
        spt.esi_cluster_setup(n_workers=2)


def test_mesh_must_hold_the_ports_device():
    mesh = spt.make_mesh(devices=["cuda:0"])
    with spt.use_mesh(mesh):
        with pytest.raises(SPYValueError, match="port's device"):
            spt.connectivityanalysis(_adata(), method="coh", tapsmofrq=4)
    with pytest.raises(SPYValueError, match="parallel"):
        spt.freqanalysis(_adata(), method="mtmfft", parallel="yes")


def test_profile_writes_a_trace_on_the_cpu(tmp_path):
    with spt.profile(str(tmp_path / "traces")) as logdir:
        spt.freqanalysis(_adata(), method="mtmfft", tapsmofrq=4)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    with spt.Timer() as t:
        pass
    assert t.seconds >= 0
