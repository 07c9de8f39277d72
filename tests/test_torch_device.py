# -*- coding: utf-8 -*-
# The port's device setting: it computes on cuda:0 unless
# syncopy_tpu_torch.set_device("cpu") asks for the CPU, and without a card
# it raises instead of falling back. With the CPU asked for, the entry
# point matches syncopy_tpu on the CPU.

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import syncopy_tpu as spy
import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine

torch.set_num_threads(1)

FS = 1000.0
TOL = 1e-5


@contextlib.contextmanager
def cpu_setting():
    """The CPU for the port inside the block, the old setting after it."""
    previous = spt.set_device("cpu")
    try:
        yield
    finally:
        spt.set_device(previous)


@pytest.fixture
def on_cpu():
    with cpu_setting():
        yield


def _both(seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(3 * 250, 4)).astype(np.float32)
    trl = np.array([[0, 250, 0], [250, 500, 0], [500, 750, 0]], dtype=float)
    jax_data = spy.AnalogData(data=data, samplerate=FS)
    jax_data.trialdefinition = trl
    return spt.from_arrays(data, trl, FS), jax_data


def test_no_card_and_no_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pdata, _ = _both()
    with pytest.raises(RuntimeError, match=r"set_device\("):
        spt.connectivityanalysis(pdata, method="coh", tapsmofrq=4)


@pytest.mark.parametrize("method", ["coh", "csd", "ppc"])
def test_cpu_on_request_matches_reference(on_cpu, method):
    pdata, jdata = _both(1)
    got = np.asarray(spt.connectivityanalysis(pdata, method=method, tapsmofrq=4).data)
    want = np.asarray(spy.connectivityanalysis(jdata, method=method, tapsmofrq=4).data)
    assert routine.default_device() == torch.device("cpu")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() < TOL * max(1.0, float(np.abs(want).max()))


def test_setting_restored_after_the_block():
    before = routine._device
    with cpu_setting():
        assert routine.default_device() == torch.device("cpu")
    assert routine._device == before == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        spt.set_device("meta")
    assert routine._device == before


def test_default_is_the_first_card():
    code = "import syncopy_tpu_torch as spt; print(spt.set_device('cpu'))"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=repo)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "cuda:0"
