"""The Morlet TFR cell at a tiny size on the CPU: sound runs, traced and not,
come out correct, ``half_batch`` and ``altered`` turn them false; the
reference holds the port's CPU path and its control fails the limit;
``cwt_bound`` against the cell's shapes counted by hand; and the cell's
three readers on a small synthetic trace."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from portbench.core import cell, manifest, roofline_cwt
from portbench.core.trace import Trace
from portbench.reference import tfr
from portbench.tests import tiny

METRICS = manifest.BENCH_DIR / "metrics"
CELL = "tfr64.store"
CONFIG = manifest.BENCH_DIR / "configs" / "tfr64.json"
#: the tiny cut: 12 trials of 3 channels, 400 samples at the cell's 1 kHz
#: (every foi kept, so both length buckets occur)
TINY = {"trials": 12, "samples": 400, "channels": 3}
READERS = ("tfr.cwt_ms", "tfr.cwt_roofline", "tfr.cwt_chunks")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("tfr"))
    path = root / "portbench" / "configs" / "tfr64.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    path.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, trace):
    rc, res, err = tiny.run(root, CELL, seconds=1.0, trace=trace)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is True, res
    assert set(res["checks"]) == {"tfr_max_rel_err", "calls_off_path"}
    assert res["checks"]["calls_off_path"]["value"] == 0
    assert "chunk sources {'trial store': " in err
    if trace:
        # the CPU has no kernels: the device time, the roofline and the
        # idle share find none
        assert set(res["metrics"]) == {"tfr.cwt_chunks"}
        assert res["metrics"]["tfr.cwt_chunks"]["value"] == 1
    else:
        assert {"trials_per_s", "setup_s"} == set(res["metrics"])


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_fault_is_not_correct(root, fault):
    rc, res, err = tiny.run(root, CELL, seconds=1.0, fault=fault)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is False, res


def test_reference_holds_the_port_and_its_control_fails(root):
    """calibrate.py on the CPU: every program reading within the limit,
    every float16 control reading above it."""
    proc = subprocess.run([sys.executable, "portbench/calibrate.py", "--config", "tfr64",
                           "--seeds", "3", "--control-seeds", "3", "--device", "cpu"],
                          cwd=str(root), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")][:-1]
    limit = json.loads(CONFIG.read_text())["limits"]["tfr_max_rel_err"]
    assert len(rows) == 6
    for r in rows:
        assert (r["tfr_max_rel_err"] <= limit) == (r["side"] == "program"), r


def test_cwt_bound_counted_by_hand():
    cfg = json.loads(CONFIG.read_text())
    K = tfr.supports(cfg, cfg["calls"]["tfr"]["args"])
    # 5 Hz: s = 0.19360 s, 1937 samples, so 1000 + 1937 - 1 needs 4096;
    # 10 Hz: 969 samples, 2048; every other scale fits 2048 too
    assert K[:2] == [1937, 969] and len(K) == 30 and max(K[1:]) < 1049
    per_row = 29 * 5 * 2048 * 11 + 5 * 4096 * 12 + 5 * 2048 * 11
    ms, by = roofline_cwt.cwt_bound(512, 1000, 64, K)
    assert by == "operations"
    assert ms == pytest.approx(512 * 64 * per_row / 67e12 * 1e3)
    assert ms == pytest.approx(1.77288, rel=1e-4)
    # one sample, one short scale: the bytes bound it
    ms, by = roofline_cwt.cwt_bound(1000, 1, 1, [1])
    assert by == "bytes" and ms == pytest.approx((1000 * 4 + 4) / 3.35e12 * 1e3)
    assert roofline_cwt.fft_ops(1024) == 5 * 1024 * 10


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def span(name, start_ms, end_ms):
    return x("user_annotation", name, start_ms * 1e3, (end_ms - start_ms) * 1e3)


def kernel(start_ms, end_ms, launch_ms, corr, name="vector_fft"):
    return [x("cuda_runtime", "cudaLaunchKernel", launch_ms * 1e3, 5.0, correlation=corr),
            x("kernel", name, start_ms * 1e3, (end_ms - start_ms) * 1e3, tid=7,
              correlation=corr)]


def events():
    """Two calls (ms). Call 0, 0-100: spt.specest.cwt 10-20 and 30-40,
    kernels launched at 11 and 31 (3 ms each), one launched at 50, outside
    (the trial sum, 8 ms). Call 1, 200-300: one spt.specest.cwt 210-250
    with two kernels launched at 211 and 221 (2 and 4 ms)."""
    evs = [span("portbench.call.0", 0, 100), span("spt.specest.cwt", 10, 20),
           span("spt.specest.cwt", 30, 40), span("portbench.call.1", 200, 300),
           span("spt.specest.cwt", 210, 250)]
    for k, (s, e, launch) in enumerate([(12, 15, 11), (32, 35, 31), (51, 59, 50),
                                        (212, 214, 211), (222, 226, 221)]):
        evs += kernel(s, e, launch, k + 1)
    return evs


WORK = {"cwt": {"trials": 512, "T": 1000, "C": 64, "K": [1937, 969, 646]}}


def calls():
    return [{"index": i, "kind": "tfr", "trials": 512, "payload_blocks": [], "h2d": 0,
             "work": WORK} for i in (0, 1)]


def read(name, evs=None):
    return cell.read_metric({"name": name, "dir": METRICS / name},
                            {"calls": calls(), "trace": Trace(evs or events())})


def test_cwt_readers():
    assert read("tfr.cwt_ms") == pytest.approx((6 + 6) / 2)
    assert read("tfr.cwt_chunks") == pytest.approx((2 + 1) / 2)
    w = WORK["cwt"]
    bound = roofline_cwt.cwt_bound(w["trials"], w["T"], w["C"], w["K"])[0] * 2
    assert read("tfr.cwt_roofline") == pytest.approx(100 * bound / 12)
    assert math.isfinite(read("tfr.cwt_roofline"))


def test_cwt_readers_find_nothing_without_the_spans():
    evs = [e for e in events() if not e["name"].startswith("spt.")]
    assert all(read(n, evs) is None for n in READERS)


def test_the_cell_reports_its_metrics():
    bench = manifest.load()
    _, config, mix, e2e, layer = manifest.resolve(bench, CELL)
    assert set(READERS) | {"device.idle_share"} == {m["name"] for m in layer}
    assert {m["layer"] for m in layer if m["name"] in READERS} == {"specest: CWT"}
    assert {m["name"] for m in e2e} == {"trials_per_s", "setup_s"}
    assert mix["datasets"] == 1 and mix["expect_source"] == "trial store"
    assert config["reduced"] == [] and set(config["limits"]) == {"tfr_max_rel_err"}
    args = config["calls"][config["default_call"]]["args"]
    assert args["foi"] == list(range(5, 151, 5)) and args["keeptrials"] is False
    assert (config["trials"], config["samples"], config["channels"]) == (512, 1000, 64)
    assert np.isclose(config["samplerate"], 1000.0)
