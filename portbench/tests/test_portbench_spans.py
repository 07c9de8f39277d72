"""Each reader of the program's spans (``spt.*``) on a small synthetic trace
gives the value counted by hand, and finds nothing to read in a trace
without them."""

import pytest

from portbench.core import cell, manifest
from portbench.core.trace import Trace

METRICS = manifest.BENCH_DIR / "metrics"


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def span(name, start_ms, end_ms, tid=1):
    return x("user_annotation", name, start_ms * 1e3, (end_ms - start_ms) * 1e3, tid=tid)


def device(name, start_ms, end_ms, corr):
    cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
    return [x("cuda_runtime", "cudaLaunchKernel", start_ms * 1e3 - 5.0, 5.0, correlation=corr),
            x(cat, name, start_ms * 1e3, (end_ms - start_ms) * 1e3, tid=7, correlation=corr)]


def events(with_spans=True):
    """Two calls of 100 ms at 0 and 200 ms (ms below).

    Call 0: ``spt.connectivityanalysis`` 1-91 around initialize 2-12 (with
    an initialize 4-8 nested in it), store_key 12-14, gather 15-25, upload
    25-30, dispatch 30-40, share_from 40-45, readback 50-80, finalize
    80-86; the card busy 25.01-30, 31-41 and 60-80.

    Call 1: ``spt.connectivityanalysis`` 201-261 around a nested frontend
    span 202-210, initialize 211-231 and finalize 240-244; the card busy
    232-240. A span of another thread covers 100-190."""
    evs = [span("portbench.call.0", 0, 100), span("portbench.call.1", 200, 300)]
    evs += device("Memcpy HtoD (Pageable -> Device)", 25.01, 30, 1)
    evs += device("csd_accumulate_kernel", 31, 41, 2)
    evs += device("Memcpy DtoH (Device -> Pageable)", 60, 80, 3)
    evs += device("ppc_accumulate_kernel", 232, 240, 4)
    evs.append(x("cpu_op", "aten::copy_", 60e3, 20e3))
    if with_spans:
        evs += [span("spt.connectivityanalysis", 1, 91),
                span("spt.engine.initialize", 2, 12), span("spt.engine.initialize", 4, 8),
                span("spt.engine.store_key", 12, 14), span("spt.engine.gather", 15, 25),
                span("spt.engine.upload", 25, 30), span("spt.engine.dispatch", 30, 40),
                span("spt.mesh.share_from", 40, 45), span("spt.engine.readback", 50, 80),
                span("spt.engine.finalize", 80, 86),
                span("spt.connectivityanalysis", 201, 261),
                span("spt.freqanalysis", 202, 210), span("spt.engine.initialize", 211, 231),
                span("spt.engine.finalize", 240, 244),
                span("spt.engine.dispatch", 100, 190, tid=2)]
    return evs


def read(name, with_spans=True):
    calls = [{"index": 0, "trials": 1000}, {"index": 1, "trials": 1000}]
    return cell.read_metric({"name": name, "dir": METRICS / name},
                            {"calls": calls, "trace": Trace(events(with_spans))})


#: by hand: call 0's frontend self time 90 - (10 + 2 + 10 + 5 + 10 + 5 + 30
#: + 6) = 12 ms, call 1's 60 - (20 + 4) = 36 ms (a nested frontend span is
#: the frontend's own); plan 10 + 2 and 20 ms (the nested initialize once);
#: gather 10 ms in call 0 alone; finalize 6 and 4 ms. The card idles 0-25.01,
#: 30-31, 41-60 (under spans), 80-232 and 240-300 (under none: the middles
#: 156 and 270 lie outside every span of the calls' thread) in a 300 ms
#: window.
WANT = {"frontend.host_ms": (12 + 36) / 2, "engine.plan_ms": (12 + 20) / 2,
        "engine.gather_ms": 10.0, "engine.finalize_ms": (6 + 4) / 2,
        "device.idle_unspanned_share": 100 * (152 + 60) / 300}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_counts_by_hand(name):
    assert read(name) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_without_spans(name):
    assert read(name, with_spans=False) is None
