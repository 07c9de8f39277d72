# -*- coding: utf-8 -*-
# End-to-end parity of the port's connectivityanalysis(method="coh")
# against syncopy_tpu on the CPU: the same numpy arrays build both
# packages' AnalogData (syncopy_tpu_torch.from_arrays), and the coherence
# must agree to < 1e-5 (the bar of test_connectivity.py:1366-1406) with
# equal metadata. Also: the port and its statistics import no jax, and the
# kernel's launch counter stays 0 on the CPU.

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.connectivity import ST_compRoutines
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import csd_kernels
from syncopy_tpu_torch.shared.errors import SPYValueError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)

COH_TOL = 1e-5
FS = 1000.0


def _arrays(lens, n_chan, seed):
    """Stacked (samples, channels) float32 payload and its trialdefinition."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(int(np.sum(lens)), n_chan)).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    trl = np.zeros((len(lens), 3))
    trl[:, 0] = bounds[:-1]
    trl[:, 1] = bounds[1:]
    return data, trl


def _both(lens, n_chan, seed=0):
    data, trl = _arrays(lens, n_chan, seed)
    jax_data = spy.AnalogData(data=data, samplerate=FS)
    jax_data.trialdefinition = trl
    return spt.from_arrays(data, trl, FS), jax_data


def _assert_same(out, ref, coh_abs=None):
    """Equal data and metadata; for the angle flavour pass |coherency| as
    `coh_abs`: angles are compared where it exceeds 1e-3, with the phase
    error scaled by it (an error of the coherency across its direction)."""
    got, want = np.asarray(out.data), np.asarray(ref.data)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert np.isfinite(got).all()
    if coh_abs is not None:
        keep = coh_abs > 1e-3
        diff = np.angle(np.exp(1j * (got[keep] - want[keep])))  # wrap at +-pi
        assert np.abs(diff * coh_abs[keep]).max() < COH_TOL
    else:
        assert np.abs(got - want).max() < COH_TOL
    assert out.dimord == ref.dimord
    assert np.array_equal(out.freq, ref.freq)
    assert np.array_equal(out.channel_i, ref.channel_i)
    assert np.array_equal(out.channel_j, ref.channel_j)
    assert out.samplerate == ref.samplerate
    assert np.array_equal(out.trialdefinition, ref.trialdefinition)
    assert out.cfg.keys() == ref.cfg.keys()
    assert out.cfg["connectivityanalysis"] == ref.cfg["connectivityanalysis"]


def test_equal_trials():
    pdata, jdata = _both([500] * 20, 8)
    out = spt.connectivityanalysis(pdata, method="coh", tapsmofrq=2)
    ref = spy.connectivityanalysis(jdata, method="coh", tapsmofrq=2)
    _assert_same(out, ref)
    assert out.data.shape == (1, 251, 8, 8)
    assert np.allclose(np.asarray(out.data)[0, :, np.arange(8), np.arange(8)], 1.0, atol=1e-5)


def test_ragged_trials():
    pdata, jdata = _both([800, 1000, 1000, 900, 800], 3, seed=7)
    out = spt.connectivityanalysis(pdata, method="coh", tapsmofrq=3)
    ref = spy.connectivityanalysis(jdata, method="coh", tapsmofrq=3)
    _assert_same(out, ref)


def test_trial_selection():
    pdata, jdata = _both([400] * 12, 4, seed=3)
    sel = {"trials": [0, 2, 3, 7, 8, 11]}
    out = spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4, select=sel)
    ref = spy.connectivityanalysis(jdata, method="coh", tapsmofrq=4, select=sel)
    _assert_same(out, ref)
    assert pdata.selection is None  # the transient selection is undone


def test_latency_selection():
    """A time selection takes the engine's per-trial gather path."""
    pdata, jdata = _both([500] * 8, 3, seed=10)
    kw = dict(method="coh", tapsmofrq=4, select={"latency": [0.1, 0.35]})
    out = spt.connectivityanalysis(pdata, **kw)
    ref = spy.connectivityanalysis(jdata, **kw)
    _assert_same(out, ref)


def test_hdf5_backed_data(tmp_path):
    """An h5py dataset payload takes the engine's HDF5 gather branch."""
    import h5py

    data, trl = _arrays([300] * 6, 3, seed=11)
    with h5py.File(tmp_path / "payload.h5", "w") as f:
        f.create_dataset("data", data=data)
    with h5py.File(tmp_path / "payload.h5", "r") as f:
        pdata = spt.from_arrays(data, trl, FS)
        pdata.data = f["data"]
        pdata.trialdefinition = trl
        out = spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4)
    jdata = spy.AnalogData(data=data, samplerate=FS)
    jdata.trialdefinition = trl
    _assert_same(out, spy.connectivityanalysis(jdata, method="coh", tapsmofrq=4))


def test_channel_selection_and_polyremoval():
    pdata, jdata = _both([400] * 6, 5, seed=4)
    kw = dict(method="coh", tapsmofrq=4, polyremoval=1,
              select={"channel": ["channel1", "channel3", "channel4"]})
    out = spt.connectivityanalysis(pdata, **kw)
    ref = spy.connectivityanalysis(jdata, **kw)
    _assert_same(out, ref)
    assert out.data.shape[-1] == 3


@pytest.mark.parametrize("foi_kw, first, last", [
    ({"foilim": [20, 80]}, 20, 80),
    ({"foi": [10, 20.3, 20.5, 41]}, 10, 42),
])
def test_frequency_selection(foi_kw, first, last):
    pdata, jdata = _both([500] * 10, 4, seed=5)
    kw = dict(method="coh", tapsmofrq=2, **foi_kw)
    out = spt.connectivityanalysis(pdata, **kw)
    ref = spy.connectivityanalysis(jdata, **kw)
    _assert_same(out, ref)
    assert out.freq[0] == first and out.freq[-1] == last


@pytest.mark.parametrize("output", ["pow", "complex", "fourier", "real", "imag", "angle"])
def test_output_flavours(output):
    pdata, jdata = _both([300] * 8, 3, seed=6)
    out = spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4, output=output)
    ref = spy.connectivityanalysis(jdata, method="coh", tapsmofrq=4, output=output)
    coh_abs = None
    if output == "angle":
        coh_abs = np.asarray(spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4).data)
    _assert_same(out, ref, coh_abs)


@pytest.mark.parametrize("output", ["abs", "complex"])
def test_coherence_from_the_ports_own_spectra(output):
    """The chain inside the port: spt.freqanalysis' fourier spectra (within
    1e-6 of the JAX package's) through connectivityanalysis give the
    coherence of the same AnalogData."""
    pdata, jdata = _both([400] * 10, 4, seed=12)
    kw = dict(method="mtmfft", tapsmofrq=4, output="fourier", keeptapers=True)
    spec = spt.freqanalysis(pdata, **kw)
    got, want = np.asarray(spec.data), np.asarray(spy.freqanalysis(jdata, **kw).data)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    chained = np.asarray(spt.connectivityanalysis(spec, method="coh", output=output).data)
    direct = np.asarray(spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4,
                                                 output=output).data)
    assert chained.shape == direct.shape and chained.dtype == direct.dtype
    assert np.abs(chained - direct).max() < COH_TOL


def test_forced_multi_chunk(monkeypatch):
    """A tiny chunk budget splits 21 trials into padded chunks of 4."""
    T, C = 250, 4
    pdata, jdata = _both([T] * 21, C, seed=8)
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 4 * T * C * 4 * 2)
    calls = []
    orig = ST_compRoutines.CrossSpectra.process_batch_sum

    def counting(self, batch, n_valid, **cfg):
        calls.append((batch.shape[0], n_valid))
        return orig(self, batch, n_valid, **cfg)

    monkeypatch.setattr(ST_compRoutines.CrossSpectra, "process_batch_sum", counting)
    out = spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4)
    ref = spy.connectivityanalysis(jdata, method="coh", tapsmofrq=4)
    _assert_same(out, ref)
    assert calls == [(4, 4)] * 5 + [(4, 1)]


def test_chunk_trials_rule():
    assert routine.chunk_trials(512 * 1024, 1000) == 1024
    assert routine.chunk_trials(512 * 1024, 1000, budget=100 * 512 * 1024) == 64
    assert routine.chunk_trials(1, 5) == 8
    assert routine.chunk_trials(10**12, 5) == 1


def test_launch_counter_stays_zero_on_cpu():
    pdata, _ = _both([200] * 4, 2, seed=9)
    csd_kernels.csd_accumulate_tiled.launches = 0
    spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4)
    assert csd_kernels.csd_accumulate_tiled.launches == 0


def _coh(data, trl, package):
    if package is spt:
        adata = spt.from_arrays(data, trl, FS)
    else:
        adata = spy.AnalogData(data=data, samplerate=FS)
        adata.trialdefinition = trl
    return np.asarray(package.connectivityanalysis(adata, method="coh", tapsmofrq=4).data)


@pytest.mark.parametrize("scale", [1e-13, 1e-17])
def test_coherence_is_scale_invariant(scale):
    """Data in tesla (MEG, amplitude ~1e-13): S_ii * S_jj underflows
    float32, so the denominator is formed as sqrt(S_ii) * sqrt(S_jj). The
    JAX package forms the product and returns non-finite values there (a
    fault of the reference, recorded here; it stays as it is)."""
    data, trl = _arrays([400] * 10, 4, seed=13)
    want = _coh(data, trl, spt)
    assert np.abs(want - _coh(data, trl, spy)).max() < COH_TOL  # parity at scale 1
    tiny = data * np.float32(scale)
    got = _coh(tiny, trl, spt)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < COH_TOL
    if scale == 1e-13:
        assert not np.isfinite(_coh(tiny, trl, spy)).all()


def test_coherence_rejects_keeptrials_and_single_trial():
    pdata, _ = _both([200] * 4, 2)
    with pytest.raises(SPYValueError):
        spt.connectivityanalysis(pdata, method="coh", keeptrials=True)
    single, _ = _both([200], 2)
    with pytest.raises(SPYValueError):
        spt.connectivityanalysis(single, method="coh")


def test_data_methods_outside_the_slice_not_ported_yet(tmp_path):
    """The data methods that once raised here are ported (arithmetic,
    save, plotting, NWB export; tests/test_torch_io.py and its siblings
    hold them to the JAX package), and so are the mesh over several
    positions (tests/test_torch_mesh_invariance.py) and the multi-host
    runtime, a no-op without a cluster that asks for all three cluster
    keywords (tests/test_torch_multihost.py joins one)."""
    import matplotlib.pyplot as plt

    pdata, jdata = _both([100, 150], 3)
    np.testing.assert_array_equal((pdata + 1).data, (jdata + 1).data)
    pdata.save(str(tmp_path / "x"))
    assert os.path.isfile(str(tmp_path / "x.spy" / "x.analog"))
    fig, _ = pdata.singlepanelplot(trials=0)
    plt.close(fig)
    pdata.save_nwb(str(tmp_path / "x.nwb"))
    assert os.path.isfile(str(tmp_path / "x.nwb"))
    pdata._close_hdf()
    assert spt.make_mesh(devices=["cpu", "cpu"]).shape == {"trial": 2, "channel": 1}
    spt.init_distributed()
    assert spt.parallel.process_count() == 1
    with pytest.raises(spt.shared.errors.SPYValueError, match="process_id"):
        spt.init_distributed(coordinator_address="localhost:1234", num_processes=2)


def test_from_arrays_builds_the_same_object():
    pdata, jdata = _both([100, 150], 3)
    assert np.array_equal(pdata.data, jdata.data)
    assert np.array_equal(pdata.trialdefinition, jdata.trialdefinition)
    assert np.array_equal(pdata.channel, jdata.channel)
    assert pdata.samplerate == jdata.samplerate


@pytest.mark.parametrize("module", [
    "syncopy_tpu_torch",
    "syncopy_tpu_torch.statistics",
    "syncopy_tpu_torch.statistics.jackknifing",
    "syncopy_tpu_torch.connectivity.AV_compRoutines",
    "syncopy_tpu_torch.specest",
    "syncopy_tpu_torch.ops.wavelet",
    "syncopy_tpu_torch.io",
    "syncopy_tpu_torch.plotting",
    "syncopy_tpu_torch.synthdata",
    "syncopy_tpu_torch.parallel",
    "syncopy_tpu_torch.shared.profiling",
    "syncopy_tpu_torch.datatype.methods.arithmetic",
    "syncopy_tpu_torch.engine.resident",
])
def test_import_pulls_in_no_jax(module):
    code = ("import sys, " + module + "; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'syncopy_tpu.'))"
            " or m == 'syncopy_tpu']; "
            "assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=repo)
    assert proc.returncode == 0, proc.stderr
