# -*- coding: utf-8 -*-
# The port's device trial store (engine/routine.py): repeated analyses of
# the same (selected) payload reuse its uploaded chunks; a new payload
# through the setter, a new trialdefinition or another selection uploads
# again; the store is an LRU by bytes; an unfingerprintable selection
# bypasses it and says so once. Mirrors tests/test_device_cache.py, and
# records one fault both packages share: an in-place write into a numpy
# payload leaves a stale entry. Results from the store are held bitwise
# to the uploaded route; a one-channel selection against the full
# payload's channel within 1e-6 (the JAX test's bar: float32 FFTs of
# another batch layout).

import logging

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The CPU, asked for explicitly, and an empty store before and after."""
    previous = spt.set_device("cpu")
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)


@pytest.fixture()
def adata():
    """10 equal-length trials of white noise, 1 kHz, 4 channels."""
    return spt.synthdata.white_noise(nTrials=10, nSamples=1000, nChannels=4, seed=42)


def _fa(data, **kw):
    kw.setdefault("taper", "hann")
    return spt.freqanalysis(data, method="mtmfft", **kw)


def test_a_second_call_hits_the_store(adata):
    routine.reset_transfer_counts()
    s1 = _fa(adata)
    first = routine.transfer_counts()["h2d"]
    assert len(routine._DEVICE_CACHE) == 1 and first == 16 * 1000 * 4 * 4
    routine.reset_transfer_counts()
    s2 = _fa(adata)
    assert routine.transfer_counts()["h2d"] == 0
    assert np.array_equal(np.asarray(s1.data), np.asarray(s2.data))


def test_the_store_is_shared_across_analyses(adata):
    _fa(adata)
    n = len(routine._DEVICE_CACHE)
    # the same gather plan and chunking reuse the same upload
    routine.reset_transfer_counts()
    _fa(adata, taper=None)
    assert len(routine._DEVICE_CACHE) == n and routine.transfer_counts()["h2d"] == 0


def test_a_new_payload_through_the_setter_invalidates(adata):
    s1 = _fa(adata)
    adata.data = np.asarray(adata.data) * 2  # bumps the cache token
    s2 = _fa(adata)
    assert np.allclose(np.asarray(s2.data), 4 * np.asarray(s1.data), rtol=1e-5, atol=0)


def test_a_trialdefinition_change_invalidates(adata):
    _fa(adata)
    adata.trialdefinition = adata.trialdefinition[:5]
    s2 = _fa(adata)
    assert s2.data.shape[0] == 5


def test_selections_do_not_collide(adata):
    a = _fa(adata, select={"channel": [0]})
    b = _fa(adata, select={"channel": [1]})
    raw = _fa(adata)
    assert len(routine._DEVICE_CACHE) == 3
    # one channel's FFT against four channels': float32 rounding apart (the
    # JAX test's bar)
    assert np.allclose(np.asarray(a.data)[..., 0], np.asarray(raw.data)[..., 0], atol=1e-6)
    assert np.allclose(np.asarray(b.data)[..., 0], np.asarray(raw.data)[..., 1], atol=1e-6)
    assert not np.allclose(np.asarray(a.data)[..., 0], np.asarray(b.data)[..., 0], atol=1e-6)


def test_nothing_fits_a_tiny_store(adata, monkeypatch):
    monkeypatch.setattr(routine, "DEVICE_CACHE_BYTES", 1)
    _fa(adata)
    assert len(routine._DEVICE_CACHE) == 0


def test_lru_eviction_by_bytes(adata, monkeypatch):
    # one channel's upload is 16 x 1000 x 1 float32 = 64000 bytes: two fit
    monkeypatch.setattr(routine, "DEVICE_CACHE_BYTES", 2 * 64000)
    for ch in (0, 1):
        _fa(adata, select={"channel": [ch]})
    _fa(adata, select={"channel": [0]})  # channel 0 is now the most recent
    _fa(adata, select={"channel": [2]})  # evicts channel 1
    assert len(routine._DEVICE_CACHE) == 2 and routine._DEVICE_CACHE_SIZE[0] == 2 * 64000
    routine.reset_transfer_counts()
    _fa(adata, select={"channel": [0]})
    assert routine.transfer_counts()["h2d"] == 0
    _fa(adata, select={"channel": [1]})
    assert routine.transfer_counts()["h2d"] == 64000


def test_clear(adata):
    _fa(adata)
    routine.clear_device_cache()
    assert routine._DEVICE_CACHE_SIZE[0] == 0 and not routine._DEVICE_CACHE
    assert spt.clear_device_cache is routine.clear_device_cache


def test_an_unfingerprintable_selection_bypasses_and_logs_once(adata, monkeypatch, caplog):
    from syncopy_tpu_torch.datatype.selector import Selector

    orig = Selector.trial_indexer

    class _NoRepr(tuple):
        def __repr__(self):
            raise RuntimeError("synthetic unfingerprintable selection")

    def wrapped(self, data, k):
        # the real indexer tuple, but its repr, which only the fingerprint
        # needs, fails
        return _NoRepr(orig(self, data, k))

    monkeypatch.setattr(Selector, "trial_indexer", wrapped)
    monkeypatch.setattr(routine, "_FINGERPRINT_BYPASS_LOGGED", False)
    logger = logging.getLogger("syncopy_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        s1 = _fa(adata)
        assert len(routine._DEVICE_CACHE) == 0
        bypass = [r for r in caplog.records if "trial store is bypassed" in r.getMessage()]
        assert len(bypass) == 1
        s2 = _fa(adata)
        bypass = [r for r in caplog.records if "trial store is bypassed" in r.getMessage()]
        assert len(bypass) == 1
        assert np.array_equal(np.asarray(s1.data), np.asarray(s2.data))
    finally:
        logger.removeHandler(caplog.handler)


def test_a_fingerprintable_selection_is_stored(adata):
    _fa(adata, select={"channel": [0, 1]})
    assert len(routine._DEVICE_CACHE) == 1


def test_the_engine_passes_of_timelockanalysis_share_one_upload(adata):
    """The trial mean, the centred second moment and the covariance chunk
    the same selection alike: the first call uploads the payload once, a
    second call not at all (the mean row of the second pass still goes up
    as its auxiliary input)."""
    routine.reset_transfer_counts()
    first = spt.timelockanalysis(adata, covariance=True)
    counts = routine.transfer_counts()
    assert counts["h2d"] == 16 * 1000 * 4 * 4
    routine.reset_transfer_counts()
    second = spt.timelockanalysis(adata, covariance=True)
    counts = routine.transfer_counts()
    assert counts["h2d"] == 0 and counts["h2d_aux"] == 1000 * 4 * 4
    for name in ("avg", "var", "cov"):
        assert np.array_equal(np.asarray(getattr(first, name)),
                              np.asarray(getattr(second, name)))


# ------------------------------------------------------------------------ #
# a fault of both packages: the token moves only through the setter
# ------------------------------------------------------------------------ #


def test_an_in_place_write_leaves_a_stale_entry(adata):
    """`data.data[:] *= 2` writes the numpy payload without bumping the
    cache token, so the next analysis reads the stored upload of the old
    values (ROADMAP Queue 3). clear_device_cache(), or a new payload
    through the setter, gives the new values."""
    s1 = _fa(adata)
    adata.data[:] *= 2
    stale = _fa(adata)
    assert np.array_equal(np.asarray(stale.data), np.asarray(s1.data))
    routine.clear_device_cache()
    fresh = _fa(adata)
    assert np.allclose(np.asarray(fresh.data), 4 * np.asarray(s1.data), rtol=1e-5, atol=0)


def test_jax_in_place_write_leaves_a_stale_entry():
    """The same fault in the JAX package (syncopy_tpu/engine/routine.py
    keys its store on the token that only the setter bumps)."""
    from syncopy_tpu.engine import routine as jroutine

    jroutine.clear_device_cache()
    try:
        jdata = spy.synthdata.white_noise(nTrials=10, nSamples=1000, nChannels=4, seed=42)
        s1 = spy.freqanalysis(jdata, method="mtmfft", taper="hann")
        jdata.data[:] *= 2
        stale = spy.freqanalysis(jdata, method="mtmfft", taper="hann")
        assert np.array_equal(np.asarray(stale.data), np.asarray(s1.data))
        jroutine.clear_device_cache()
        fresh = spy.freqanalysis(jdata, method="mtmfft", taper="hann")
        assert np.allclose(np.asarray(fresh.data), 4 * np.asarray(s1.data), rtol=1e-5, atol=0)
    finally:
        jroutine.clear_device_cache()


# ------------------------------------------------------------------------ #
# the store key of whole trials: built from the trial ids, their starts
# and lengths and one indexer, and alike in every process
# ------------------------------------------------------------------------ #


def _uploads(data, select):
    routine.reset_transfer_counts()
    _fa(data, select=select)
    return routine.transfer_counts()["h2d"]


def test_the_same_trial_subset_hits_on_a_second_call(adata):
    assert _uploads(adata, {"trials": [3, 1, 4, 1]}) > 0
    assert _uploads(adata, {"trials": [3, 1, 4, 1]}) == 0


def test_another_trial_subset_of_the_same_size_misses(adata):
    assert _uploads(adata, {"trials": [3, 1, 4]}) > 0
    assert _uploads(adata, {"trials": [3, 1, 5]}) > 0
    assert len(routine._DEVICE_CACHE) == 2


def test_a_permutation_of_the_same_trials_misses(adata):
    first = _fa(adata, select={"trials": [3, 1, 4]})
    routine.reset_transfer_counts()
    second = _fa(adata, select={"trials": [1, 3, 4]})
    assert routine.transfer_counts()["h2d"] > 0 and len(routine._DEVICE_CACHE) == 2
    assert np.array_equal(np.asarray(first.data)[[1, 0, 2]], np.asarray(second.data))


def test_another_channel_list_misses(adata):
    first = _fa(adata, select={"channel": [0, 3, 1]})
    routine.reset_transfer_counts()
    second = _fa(adata, select={"channel": [0, 1, 3]})
    assert routine.transfer_counts()["h2d"] > 0 and len(routine._DEVICE_CACHE) == 2
    # float32 FFTs of another batch layout: the file's 1e-6 bar
    want = np.asarray(first.data)[..., [0, 2, 1]]
    assert np.abs(np.asarray(second.data) - want).max() <= 1e-6 * np.abs(want).max()


STORE_KEYS = """
import sys
import torch
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine
rank, world, port = map(int, sys.argv[1:4])
spt.set_device("cpu")
spt.init_distributed(coordinator_address="localhost:{}".format(port), num_processes=world,
                     process_id=rank, backend="gloo", timeout=30.0)
data = spt.synthdata.white_noise(nTrials=10, nSamples=200, nChannels=4, seed=42)
with spt.use_mesh(spt.make_mesh()):
    for select in (None, {"trials": [3, 1, 4, 1]}, {"channel": [0, 3, 1]}):
        spt.freqanalysis(data, method="mtmfft", taper="hann", select=select)
    routine.reset_transfer_counts()
    spt.freqanalysis(data, method="mtmfft", taper="hann", select={"trials": [3, 1, 4, 1]})
print("H2D", routine.transfer_counts()["h2d"])
print("KEYS", sorted(repr(key[1:]) for key in routine._DEVICE_CACHE), flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def test_two_ranks_build_equal_store_keys():
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", STORE_KEYS, str(r), "2", port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=repo,
                              env=dict(os.environ, PYTHONPATH=repo))
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        lines.append([ln for ln in out.splitlines() if ln.startswith(("H2D", "KEYS"))])
    # the second call of a selection hits on both ranks, and the three
    # selections' keys are the same in both processes
    assert lines[0][0] == lines[1][0] == "H2D 0"
    assert lines[0][1] == lines[1][1] and lines[0][1].count("(") >= 3
