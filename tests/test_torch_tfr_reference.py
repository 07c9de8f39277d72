# -*- coding: utf-8 -*-
# The port's Morlet power against the benchmark's plain float64 reference
# (portbench/reference/tfr.py: syncopy's per-scale sampled wavelet and
# linear 'same' convolution, nothing of the port's banks or buckets) on the
# CPU, trial-averaged and per trial, with foi down to 5 Hz so that both of
# the port's length buckets occur; the reference against a direct
# np.convolve; the reference imports neither package nor JAX; its float16
# control fails the limit that the program passes; and the CWT's span and
# counters (ops/wavelet.py::cwt_counts) follow the engine's chunk plan.

import glob
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from portbench.reference import tfr as ref
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import wavelet as pwavelet

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench" / "configs" / "tfr64.json"
FS = 1000.0
#: 6 trials of 1000 samples and 3 channels; 5 Hz needs the 4096-point
#: bucket (1000 + 1937 wavelet samples), the others fit 2048
CFG = {"trials": 6, "samples": 1000, "channels": 3, "samplerate": FS}
FOI = [5.0, 10.0, 40.0, 100.0, 150.0]
ARGS = {"method": "wavelet", "wavelet": "Morlet", "width": 6, "foi": FOI, "output": "pow"}
#: the program's float32 transforms (complex64 FFTs of up to 4096 points)
#: against float64: ~4e-7 of a row's largest power here; 1e-5 leaves 25x
#: above that and lies 10x below the float16 control's reading
REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The CPU, asked for explicitly, and an empty trial store before and
    after."""
    previous = spt.set_device("cpu")
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)


def _payload(cfg=CFG, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg["trials"] * cfg["samples"], cfg["channels"])).astype("f4")


def _adata(payload, cfg=CFG):
    n, T = cfg["trials"], cfg["samples"]
    trl = np.column_stack([np.arange(n) * T, np.arange(1, n + 1) * T, np.zeros(n)])
    return spt.from_arrays(payload, trl, cfg["samplerate"])


def _tfr(adata, **kw):
    return np.asarray(spt.freqanalysis(adata, **ARGS, **kw).data)


def test_trial_average_matches_the_reference():
    payload = _payload()
    got = _tfr(_adata(payload), keeptrials=False)
    assert got.shape == (1000, 1, len(FOI), 3)
    want = ref.expected(payload, CFG, ARGS, "cpu")
    assert ref.compare(got, want) <= REL_TOL


def test_kept_trials_match_the_reference():
    payload = _payload()
    got = _tfr(_adata(payload), keeptrials=True).reshape(6, 1000, len(FOI), 3)
    (want,) = [p.numpy() for p in ref.power_blocks(payload, CFG, ARGS, "cpu")]
    for k in range(6):
        assert ref.compare(got[k], want[k]) <= REL_TOL, k
    # the trial average of the kept trials is the averaged call's
    assert ref.compare(got.mean(axis=0), want.mean(axis=0)) <= REL_TOL


@pytest.mark.parametrize("foi", [5.0, 150.0])
def test_reference_is_a_linear_same_convolution(foi):
    """One trial and channel, one scale, against np.convolve in full mode
    cropped at (K - 1) // 2: the 5 Hz wavelet (1937 samples) is longer than
    the trial, the 150 Hz one (65) shorter."""
    cfg = dict(CFG, trials=1, channels=1)
    payload = _payload(cfg, seed=11)
    args = dict(ARGS, foi=[foi])
    (got,) = ref.power_blocks(payload, cfg, args, "cpu")
    x = payload[:, 0].astype(np.float64)
    x = x - x.mean()
    (s,) = ref.scales(args)
    h = ref.wavelet(s, 1 / FS, 6.0)
    K = h.size
    assert K == int(np.ceil(10 * s * FS))
    w = np.convolve(x, h, mode="full")[(K - 1) // 2 : (K - 1) // 2 + 1000]
    want = np.abs(w) ** 2
    assert np.abs(got[0, :, 0, 0].numpy() - want).max() <= 1e-12 * want.max()


def test_reference_imports_neither_package_nor_jax():
    code = ("import sys; import portbench.reference.tfr; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'syncopy_tpu', 'syncopy_tpu_torch')])")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_the_control_fails_the_limit_the_program_passes():
    limit = json.loads(CONFIG.read_text())["limits"]["tfr_max_rel_err"]
    payload = _payload()
    want = ref.expected(payload, CFG, ARGS, "cpu")
    program = ref.compare(_tfr(_adata(payload), keeptrials=False), want)
    control = ref.compare(ref.control(payload, CFG, ARGS, "cpu"), want)
    assert program <= limit < control


def _planned_call(monkeypatch, **kw):
    """One call in chunks of 2 trials (the chunk budget cut to 4 MB, under
    the workspace's ~2 MB a trial); returns the routine's chunk plan."""
    monkeypatch.setattr(routine, "DEFAULT_CHUNK_BUDGET", 4 * 1024**2)
    seen = []
    initialize = routine.ComputationalRoutine.initialize

    def watch(self, *a, **k):
        seen.append(self)
        return initialize(self, *a, **k)

    monkeypatch.setattr(routine.ComputationalRoutine, "initialize", watch)
    _tfr(_adata(_payload()), **kw)
    (cr,) = seen
    return cr.chunk_plan


@pytest.mark.parametrize("keeptrials", [False, True])
def test_cwt_counts_follow_the_chunk_plan(monkeypatch, keeptrials):
    pwavelet.reset_cwt_counts()
    (plan,) = _planned_call(monkeypatch, keeptrials=keeptrials)
    assert plan["chunk"] == 2 and plan["rows"] == [2, 2, 2]
    chunks, rows = len(plan["rows"]), sum(plan["rows"])
    counts = pwavelet.cwt_counts()
    assert counts["calls"] == chunks
    # leading rows x channels x scales, by bucket: 5 Hz alone at 4096
    assert counts["transforms"] == {4096: rows * 3 * 1, 2048: rows * 3 * 4}
    # one bank a bucket a chunk, complex64
    assert counts["bank_uploads"] == 2 * chunks
    assert counts["bank_bytes"] == chunks * (4096 * 1 + 2048 * 4) * 8
    pwavelet.reset_cwt_counts()
    assert pwavelet.cwt_counts() == {"calls": 0, "transforms": {}, "bank_uploads": 0,
                                     "bank_bytes": 0}


def test_cwt_span_once_per_chunk_under_the_profiler(tmp_path, monkeypatch):
    with spt.profile(str(tmp_path)) as logdir:
        (plan,) = _planned_call(monkeypatch, keeptrials=False)
    (path,) = glob.glob(logdir + "/*.json")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"]
    (front,) = [e for e in events if e["name"] == "spt.freqanalysis"]
    cwt = [e for e in events if e["name"] == "spt.specest.cwt"]
    assert len(cwt) == len(plan["rows"]) == 3
    for e in cwt:
        assert front["ts"] <= e["ts"] and e["ts"] + e["dur"] <= front["ts"] + front["dur"]


def test_cwt_span_makes_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span made a record_function with no profiler running")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    pwavelet.reset_cwt_counts()
    _planned_call(monkeypatch, keeptrials=False)
    assert pwavelet.cwt_counts()["calls"] == 3
