# -*- coding: utf-8 -*-
# The port's spans (shared/profiling.py::span) on the CPU: with no
# profiler running a span makes no record_function; under spt.profile()
# every frontend call leaves the engine's stages nested under its
# spt.<frontend> span in the Chrome trace, a call served from the trial
# store leaves no gather, the count of spans per call does not grow with
# the trials, a trial shard dispatches under one span of its own, the
# mesh's transfers between ranks are spanned, and a Granger call's
# regularization, Wilson factorizations, steps and formula are spanned
# inside it, one step span per step that wilson_counts() counts.

import glob
import json
import socket

import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from syncopy_tpu_torch.connectivity import AV_compRoutines as pav
from syncopy_tpu_torch.engine import routine
from syncopy_tpu_torch.ops import connectivity as pops
from syncopy_tpu_torch.parallel import mesh as pmesh
from syncopy_tpu_torch.shared import profiling
from syncopy_tpu_torch.shared.profiling import span

torch.set_num_threads(1)

#: the engine's spans that every averaged coh or ppc call opens, whichever
#: route its payload takes
ENGINE = ("spt.engine.initialize", "spt.engine.store_key", "spt.engine.dispatch",
          "spt.engine.post", "spt.engine.readback", "spt.engine.finalize")


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The CPU, asked for explicitly, and an empty trial store before and
    after."""
    previous = spt.set_device("cpu")
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)


def _adata(n_trials=8, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_trials * 200, 3)).astype("f4")
    trl = np.column_stack([np.arange(n_trials) * 200, np.arange(1, n_trials + 1) * 200,
                           np.zeros(n_trials)])
    return spt.from_arrays(data, trl, 500.0)


def _traced(tmp_path, *calls):
    """Run each of `calls` under spt.profile(); returns, per call, its
    spans as (start, end, name, depth among the spans), in order."""
    with spt.profile(str(tmp_path)) as logdir:
        for call in calls:
            call()
    (path,) = glob.glob(logdir + "/*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("spt.")), key=lambda s: (s[0], -s[1]))
    per_call, stack = [], []
    for s, e, name in spans:
        while stack and stack[-1] <= s:
            stack.pop()
        if not stack:
            per_call.append([])
        per_call[-1].append((s, e, name, len(stack)))
        stack.append(e)
    assert len(per_call) == len(calls)
    return per_call


def _names(spans):
    return [name for _, _, name, _ in spans]


def test_span_off_makes_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span made a record_function with no profiler running")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with span("spt.test"):
        pass
    assert span("spt.a") is span("spt.b") is profiling._OFF
    # a whole frontend call, every span of the port in it, makes none
    spt.connectivityanalysis(_adata(), method="coh", tapsmofrq=4)
    # the control: under a profiler the same span reaches the patched op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="made a record_function"):
            with span("spt.test"):
                pass


@pytest.mark.parametrize("method", ["coh", "ppc"])
def test_spans_nest_under_the_frontend(tmp_path, method):
    adata = _adata()
    fresh, stored = _traced(
        tmp_path, *[lambda: spt.connectivityanalysis(adata, method=method, tapsmofrq=4)] * 2)
    for spans in (fresh, stored):
        s0, e0, name, depth = spans[0]
        assert (name, depth) == ("spt.connectivityanalysis", 0)
        for s, e, name, depth in spans[1:]:
            assert s0 <= s and e <= e0 and depth == 1, (name, depth)
        assert set(ENGINE) <= set(_names(spans))
        assert _names(spans).count("spt.engine.initialize") == 1
    # the first call gathers and uploads its one block; the second takes
    # the trial store's route and gathers nothing
    assert _names(fresh).count("spt.engine.gather") == 1
    assert _names(fresh).count("spt.engine.upload") == 1
    assert "spt.engine.gather" not in _names(stored)
    assert "spt.engine.upload" not in _names(stored)


@pytest.mark.parametrize("method", ["coh", "ppc"])
def test_span_count_does_not_grow_with_the_trials(tmp_path, method):
    few, many = _adata(8), _adata(64)
    counts = [len(spans) for spans in _traced(
        tmp_path,
        lambda: spt.connectivityanalysis(few, method=method, tapsmofrq=4),
        lambda: spt.connectivityanalysis(many, method=method, tapsmofrq=4))]
    assert counts[0] == counts[1]


def test_a_trial_shard_dispatches_under_a_span_of_its_own(tmp_path):
    mesh = spt.make_mesh(n_trial=2, devices=["cpu"] * 2)
    adata = _adata()
    with spt.use_mesh(mesh):
        (spans,) = _traced(tmp_path, lambda: spt.connectivityanalysis(adata, method="coh",
                                                                      tapsmofrq=4))
    names = _names(spans)
    assert names.count("spt.engine.dispatch") == 2
    assert names.count("spt.engine.gather") == names.count("spt.engine.upload") == 2


def test_a_resident_input_is_taken_under_its_span(tmp_path):
    adata = _adata()
    spec = spt.freqanalysis(adata, method="mtmfft", tapsmofrq=4, output="fourier",
                            keeptapers=True)
    assert spec._device_resident is not None
    (spans,) = _traced(tmp_path, lambda: spt.connectivityanalysis(spec, method="coh"))
    names = _names(spans)
    assert names.count("spt.engine.resident") == 1
    assert "spt.engine.gather" not in names and "spt.engine.store_key" not in names


def test_the_mesh_transfers_are_spanned(tmp_path):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    spt.init_distributed(coordinator_address="localhost:{}".format(port), num_processes=1,
                         process_id=0, backend="gloo", local_devices=["cpu"], timeout=60)
    try:
        x = torch.arange(6.0).reshape(2, 3)
        got = []

        def move():
            got.append(pmesh.share_from(x, 0, "cpu")[0])
            got.extend(pmesh.exchange([pmesh.Move(x, 0, 0, "cpu", (2, 3), x.dtype)]))

        with spt.profile(str(tmp_path)) as logdir:
            move()
    finally:
        torch.distributed.destroy_process_group()
    assert all(torch.equal(g, x) for g in got)
    (path,) = glob.glob(logdir + "/*.json")
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("spt.mesh.share_from") == 1 and names.count("spt.mesh.exchange") == 1


def _inside(spans, outer, inner):
    """Whether every `inner` span lies within some `outer` span."""
    outs = [(s, e) for s, e, name, _ in spans if name == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for s, e, name, _ in spans if name == inner)


@pytest.mark.parametrize("retry", [False, True])
def test_granger_spans_nest_and_count_the_steps(tmp_path, monkeypatch, retry):
    """A Granger call: its regularization, Wilson and formula spans nest
    under spt.connectivityanalysis, each step under its factorization, one
    step span per step counted; with the one-sided form reporting the CSD
    unconverged, the two-sided retry and its steps as well."""
    if retry:
        real = pops.wilson_sf

        def unconverged(CSD, **kw):
            H, Sigma, conv, err, it = real(CSD, **kw)
            return H, Sigma, torch.zeros_like(conv), err, it

        monkeypatch.setattr(pav, "wilson_sf", unconverged)
    adata = _adata(40)
    pops.reset_wilson_counts()
    (spans,) = _traced(tmp_path, lambda: spt.connectivityanalysis(adata, method="granger"))
    names = _names(spans)
    counts = pops.wilson_counts()
    assert spans[0][2] == "spt.connectivityanalysis" and spans[0][3] == 0
    assert all(depth >= 1 for _, _, _, depth in spans[1:])
    for name in ("spt.granger.regularize", "spt.granger.wilson", "spt.granger.formula"):
        assert names.count(name) == 1, name
    assert names.count("spt.granger.wilson_twosided") == int(retry) == counts["two_sided"]
    assert names.count("spt.granger.wilson_step") == (counts["one_sided_steps"]
                                                      + counts["two_sided_steps"])
    assert counts["one_sided_steps"] > 0 and (counts["two_sided_steps"] > 0) == retry
    steps = [sp for sp in spans if sp[2] == "spt.granger.wilson_step"]
    assert all(any(s0 <= s and e <= e0 for s0, e0, name, _ in spans
                   if name in ("spt.granger.wilson", "spt.granger.wilson_twosided"))
               for s, e, _, _ in steps)
    assert "spt.granger.host" not in names and counts["host"] == 0


def test_the_host_path_is_spanned(tmp_path, monkeypatch):
    """An unattainable rtol: the host float64 retry runs under its span."""
    orig = pav.GrangerCausality.__init__

    def unattainable(self, rtol=5e-6, nIter=100, cond_max=1e4):
        orig(self, rtol=1e-300, nIter=2, cond_max=cond_max)

    monkeypatch.setattr(pav.GrangerCausality, "__init__", unattainable)
    adata = _adata(40)
    pops.reset_wilson_counts()
    with pytest.warns(RuntimeWarning, match="retrying with the host float64"):
        (spans,) = _traced(tmp_path, lambda: spt.connectivityanalysis(adata, method="granger"))
    names = _names(spans)
    assert names.count("spt.granger.host") == 1 and pops.wilson_counts()["host"] == 1
    assert _inside(spans, "spt.connectivityanalysis", "spt.granger.host")
