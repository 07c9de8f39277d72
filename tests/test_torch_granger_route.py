# -*- coding: utf-8 -*-
# The port's direct Granger route on the CPU, held to the benchmark's plain
# reference (portbench/reference/granger.py: its own float64 CSD, the
# regularization, the two-sided complex128 Wilson and Eq. 8, importing
# nothing of the port), and its retry: a window that the one-sided Wilson
# leaves unconverged is factorized again by the two-sided form on the
# device, before any host path, and the windows that converged keep their
# bits. ops/connectivity.py's wilson_counts() says which forms ran.

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from portbench.datagen import ar2_network
from portbench.reference import granger as ref
from syncopy_tpu_torch.connectivity import AV_compRoutines as pav
from syncopy_tpu_torch.connectivity import connectivity_analysis as pca
from syncopy_tpu_torch.ops import connectivity as pops

torch.set_num_threads(1)

#: the benchmark's configuration, cut to the CPU
CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "granger128.json"

#: G against the plain reference (absolute): the two float64 CSDs round to
#: complex64 apart in a few last bits, which Wilson carries into G at
#: ~2e-7 here; the reference with its factorization in complex64 lands
#: ~1.7e-6 off
REF_TOL = 5e-7


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The CPU, asked for explicitly, and Wilson's counters from zero."""
    previous = spt.set_device("cpu")
    pops.reset_wilson_counts()
    yield
    spt.set_device(previous)


def _config(trials=200, samples=250, channels=8):
    cfg = json.loads(CONFIG.read_text())
    cfg.update(trials=trials, samples=samples, channels=channels, samplerate=float(samples))
    return cfg


def _analog(cfg, seed):
    payload = ar2_network.make(cfg, seed, 0, "cpu")
    return payload, spt.from_arrays(payload, ar2_network.trialdefinition(cfg),
                                    cfg["samplerate"])


def _refuse_host(monkeypatch):
    def refuse(*args):
        raise AssertionError("the host path ran")

    monkeypatch.setattr(pca, "_granger_host_full", refuse)


@pytest.mark.parametrize("seed", [0, 2147483651])
def test_direct_route_matches_the_plain_reference(monkeypatch, seed):
    """200 trials x 8 channels x 250 samples of the AR(2) network: one
    one-sided factorization on the device, G within REF_TOL of the
    reference, and the causality 1 -> 0 at the AR peak."""
    _refuse_host(monkeypatch)
    cfg = _config()
    payload, adata = _analog(cfg, seed)
    out = spt.connectivityanalysis(adata, method="granger")
    G = np.asarray(out.data)
    want = ref.compute(payload, cfg, {"method": "granger"}, "cpu")
    assert ref.check(G, want, cfg)["granger_max_abs_err"] < REF_TOL
    assert out.info["converged"] and out.info["max rel. err"] < 5e-6
    counts = pops.wilson_counts()
    assert counts["one_sided"] == 1 and counts["two_sided"] == counts["host"] == 0
    peak = int(np.argmin(np.abs(np.asarray(out.freq) - 0.2 * cfg["samplerate"])))
    assert G[0, peak, 1, 0] > 0.3 > G[0, peak, 0, 1]


def _windows():
    """Time-resolved spectra of the AR(2) network, several windows a trial."""
    _, adata = _analog(_config(trials=40, samples=800, channels=3), 3)
    return spt.freqanalysis(adata, method="mtmconvol", t_ftimwin=0.4, toi=0.5, taper=None,
                            output="fourier", polyremoval=0)


def _flaky(window):
    """wilson_sf as it is, but reporting `window` unconverged."""
    real = pops.wilson_sf

    def wilson_sf(CSD, **kw):
        H, Sigma, conv, err, it = real(CSD, **kw)
        conv = conv.clone()
        conv[window] = False
        return H, Sigma, conv, err, it

    return wilson_sf


def test_an_unconverged_window_is_factorized_again_on_the_device(monkeypatch):
    spec = _windows()
    base = np.asarray(spt.connectivityanalysis(spec, method="granger").data)
    n_win = base.shape[0]
    assert n_win > 2
    seen = {}
    stage = pca._granger

    def keep(st_out, *args):
        seen["csd"] = np.asarray(st_out.trials[0])
        return stage(st_out, *args)

    monkeypatch.setattr(pca, "_granger", keep)
    monkeypatch.setattr(pav, "wilson_sf", _flaky(1))
    _refuse_host(monkeypatch)
    pops.reset_wilson_counts()
    out = spt.connectivityanalysis(spec, method="granger")
    G = np.asarray(out.data)
    counts = pops.wilson_counts()
    assert counts["one_sided"] == n_win and counts["two_sided"] == 1 and counts["host"] == 0
    assert counts["two_sided_steps"] > 0
    assert out.info["converged"] and out.info["max rel. err"] < 5e-6
    # the windows that converged keep their bits
    others = [t for t in range(n_win) if t != 1]
    assert np.array_equal(G[others], base[others])
    # the retried window is the host float64 factorization's
    CSDreg = pops.regularize_csd(torch.from_numpy(seen["csd"][1]).to(torch.complex128),
                                 cond_max=1e4, eps_max=1e-1)[0].numpy()
    H, Sigma, conv, _ = pops.wilson_sf_host(CSDreg, nIter=100, rtol=5e-6)
    assert conv
    assert np.abs(G[1] - pops.granger_host(CSDreg, H, Sigma)).max() < 1e-6


def test_only_what_both_forms_fail_reaches_the_host(monkeypatch):
    """Both device forms reporting window 0 unconverged: the frontend's
    host float64 retry runs, once, with its warning."""
    spec = _windows()
    monkeypatch.setattr(pav, "wilson_sf", _flaky(0))
    real = pops.wilson_sf_twosided

    def twosided(CSD, **kw):
        H, Sigma, conv, err, it = real(CSD, **kw)
        return H, Sigma, torch.zeros_like(conv), err, it

    monkeypatch.setattr(pav, "wilson_sf_twosided", twosided)
    with pytest.warns(RuntimeWarning, match="retrying with the host float64"):
        out = spt.connectivityanalysis(spec, method="granger")
    counts = pops.wilson_counts()
    assert counts["two_sided"] == 1 and counts["host"] == out.data.shape[0]
    assert "host float64" in out.log
