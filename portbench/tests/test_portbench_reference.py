"""The plain references agree with the port's CPU path at tiny sizes, and
their controls (one precision lower) do not."""

import importlib
import warnings

import numpy as np
import pytest
import torch

from portbench.core import guard, manifest
from portbench.datagen import north_star

CFG = {"trials": 24, "samples": 200, "channels": 4, "samplerate": 200.0}


@pytest.fixture(scope="module")
def spt():
    import syncopy_tpu_torch as spt

    previous = spt.set_device("cpu")
    yield spt
    spt.set_device(previous)


def run_port(spt, args, seed=11, cfg=CFG):
    payload = north_star.make(cfg, seed, 0, "cpu")
    adata = spt.from_arrays(payload, north_star.trialdefinition(cfg), cfg["samplerate"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = spt.connectivityanalysis(adata, **args)
    return payload, np.asarray(out.data)


@pytest.mark.parametrize("method", ["coh", "ppc"])
def test_multitaper_references_agree(spt, method):
    ref = importlib.import_module("portbench.reference." + method)
    args = {"method": method, "tapsmofrq": 2}
    payload, got = run_port(spt, args)
    want = ref.expected(payload, CFG, args, "cpu")
    nums = ref.check(got, want, CFG)
    assert max(nums.values()) < 1e-6, nums
    low = ref.check(ref.control(payload, CFG, args, "cpu"), want, CFG)
    # the control fails the complex bins' number by far
    name = "{}_max_abs_err".format(method)
    assert low[name] > 30 * nums[name], (low, nums)


def test_ppc_real_bins_interval():
    """In the real bins the reference's interval holds its own PPC; a sign
    flipped outside the ambiguous trials, or a term lost, lies outside."""
    from portbench.reference import ppc

    payload = north_star.make(CFG, 12, 0, "cpu")
    args = {"method": "ppc", "tapsmofrq": 2}
    want = ppc.expected(payload, CFG, args, "cpu")
    real = want["ppc"][ppc.real_bins(CFG)]
    assert (want["real_lo"] <= real + 1e-12).all() and (real <= want["real_hi"] + 1e-12).all()
    assert ppc.check(want["ppc"], want, CFG)["ppc_real_bins_excess"] < 1e-12
    n = CFG["trials"]
    bad = want["ppc"].copy()
    # |U| one unit term away: (|U| + 2)^2 - |U|^2 over n (n - 1)
    u = np.sqrt(want["ppc"][0, 0, 1] * n * (n - 1) + n)
    bad[0, 0, 1] = ((u + 2) ** 2 - n) / (n * (n - 1))
    assert ppc.check(bad, want, CFG)["ppc_real_bins_excess"] > 1e-3
    assert ppc.check(bad, want, CFG)["ppc_max_abs_err"] < 1e-12


def test_work_shapes():
    from portbench.reference import coh, ppc

    cfg = {"trials": 1000, "samples": 1000, "channels": 128, "samplerate": 1000.0}
    args = {"method": "coh", "tapsmofrq": 2}
    assert coh.work(cfg, args, 250) == {"csd": {"F": 501, "rows": 750, "C": 128}}
    assert ppc.work(cfg, args, 1000) == {"ppc": {"F": 501, "n": 1000, "K": 3, "C": 128}}


def test_taper_count_and_bank():
    from portbench.reference import tapers

    assert tapers.n_tapers(2, 1000, 1000.0) == 3
    w = tapers.bank({"tapsmofrq": 2}, 1000, 1000.0)
    assert w.shape == (3, 1000)
    # syncopy's normalization: each DPSS taper has unit energy, times
    # sqrt(T), times sqrt(2) / T
    assert np.allclose((w ** 2).sum(axis=1), 2.0 / 1000)


def test_to_tf32_rounds_to_ten_bits():
    from portbench.reference import tapers

    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -9, 3.0], dtype=torch.float32)
    got = tapers.to_tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, 3.0]


def test_references_import_nothing_of_the_program():
    for path in sorted((manifest.BENCH_DIR / "reference").glob("*.py")):
        names = guard.imports_of(path)
        assert not names & (guard.FORBIDDEN | {"syncopy_tpu_torch"}), (path.name, names)
        assert "syncopy_tpu_torch" not in path.read_text(), path.name
