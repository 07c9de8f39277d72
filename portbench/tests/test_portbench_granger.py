"""The Granger cell at a tiny size on the CPU: sound runs, traced and not,
come out correct; ``half_batch`` and ``altered`` turn them false, and
``stale`` turns false a twin of the cell whose mix alternates two datasets
(the cell analyses one dataset, whose stale result is the same result);
the reference against the port's CPU path and its control against the
limit; ``wilson_bound`` against shapes counted by hand; and the cell's
three readers on a small synthetic trace."""

import json
import subprocess
import sys

import numpy as np
import pytest

from portbench.core import cell, manifest, roofline_fp64
from portbench.core.trace import Trace
from portbench.tests import tiny

METRICS = manifest.BENCH_DIR / "metrics"
CELL = "granger128.store"
#: the tiny cut: 60 trials of 4 channels, 128 samples at 128 Hz (the AR(2)
#: peak at 25.6 Hz)
TINY = {"trials": 60, "samples": 128, "channels": 4, "samplerate": 128.0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    bench = manifest.load()
    bench["workloads"].append({"name": "granger128.twin", "config": "granger128",
                               "traffic": "fresh", "chips": 1, "why": "stale's twin"})
    root = tiny.make_root(tmp_path_factory.mktemp("granger"), bench)
    path = root / "portbench" / "configs" / "granger128.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    path.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, trace):
    rc, res, err = tiny.run(root, CELL, seconds=1.0, trace=trace)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is True, res
    assert set(res["checks"]) == {"granger_max_abs_err", "calls_off_path"}
    assert res["checks"]["calls_off_path"]["value"] == 0
    assert "chunk sources {'trial store': " in err
    if trace:
        # the CPU has no kernels: the roofline and the idle share find none
        assert {"granger.wilson_ms", "granger.wilson_steps"} == set(res["metrics"])
        assert res["metrics"]["granger.wilson_steps"]["value"] >= 1
    else:
        assert {"trials_per_s", "setup_s"} == set(res["metrics"])


@pytest.mark.parametrize("workload,fault", [(CELL, "half_batch"), (CELL, "altered"),
                                            ("granger128.twin", "stale")])
def test_fault_is_not_correct(root, workload, fault):
    rc, res, err = tiny.run(root, workload, seconds=3.0 if fault == "stale" else 1.0,
                            fault=fault)
    assert rc == 0 and res is not None, err[-3000:]
    assert fault != "stale" or res["attempted"] > 1, res
    assert res["correct"] is False, res


def test_reference_holds_the_port_and_its_control_fails(root):
    """calibrate.py on the CPU: every program reading within the limit,
    every complex64 control reading above it."""
    proc = subprocess.run([sys.executable, "portbench/calibrate.py", "--config", "granger128",
                           "--seeds", "3", "--control-seeds", "3", "--device", "cpu"],
                          cwd=str(root), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")][:-1]
    limit = json.loads((root / "portbench" / "configs" / "granger128.json").read_text())[
        "limits"]["granger_max_abs_err"]
    for r in rows:
        assert (r["granger_max_abs_err"] <= limit) == (r["side"] == "program"), r


def test_wilson_bound_counted_by_hand():
    # F = 501, N = 128: 5 products of 8 N^3 a bin, 42.03 GFLOP, over
    # 67 TFLOP/s; 4 tensors of 501 x 128 x 128 x 16 B (525 MB) over 3.35 TB/s
    ms, by = roofline_fp64.wilson_bound(501, 128, 1)
    assert by == "operations"
    assert ms == pytest.approx(5 * 8 * 128**3 * 501 / 67e12 * 1e3)
    assert ms == pytest.approx(0.62727, rel=1e-4)
    assert roofline_fp64.wilson_bound(501, 128, 60)[0] == pytest.approx(60 * ms)
    # N = 2: 320 FLOP against 256 B a bin, so the bytes bound it
    ms, by = roofline_fp64.wilson_bound(1000, 2, 3)
    assert by == "bytes" and ms == pytest.approx(3 * 1000 * 256 / 3.35e12 * 1e3)


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def span(name, start_ms, end_ms):
    return x("user_annotation", name, start_ms * 1e3, (end_ms - start_ms) * 1e3)


def kernel(start_ms, end_ms, launch_ms, corr, name="zgemm"):
    return [x("cuda_runtime", "cudaLaunchKernel", launch_ms * 1e3, 5.0, correlation=corr),
            x("kernel", name, start_ms * 1e3, (end_ms - start_ms) * 1e3, tid=7,
              correlation=corr)]


def events():
    """Two calls (ms). Call 0, 0-100: spt.granger.wilson 10-40 with three
    steps, kernels launched at 12, 22 and 32 (4 ms each) and one launched
    at 50, outside (8 ms). Call 1, 200-300: spt.granger.wilson 210-220
    (one step, a 2 ms kernel), then spt.granger.wilson_twosided 230-260
    (two steps, a 6 ms kernel)."""
    evs = [span("portbench.call.0", 0, 100), span("spt.granger.wilson", 10, 40),
           span("spt.granger.wilson_step", 11, 20), span("spt.granger.wilson_step", 21, 30),
           span("spt.granger.wilson_step", 31, 40),
           span("portbench.call.1", 200, 300), span("spt.granger.wilson", 210, 220),
           span("spt.granger.wilson_step", 211, 220),
           span("spt.granger.wilson_twosided", 230, 260),
           span("spt.granger.wilson_step", 231, 245), span("spt.granger.wilson_step", 246, 260)]
    for k, (s, e, launch) in enumerate([(13, 17, 12), (23, 27, 22), (33, 37, 32), (51, 59, 50),
                                        (212, 214, 211.5), (240, 246, 239)]):
        evs += kernel(s, e, launch, k + 1)
    return evs


def calls():
    return [{"index": i, "kind": "granger", "trials": 1000, "payload_blocks": [], "h2d": 0,
             "work": {"wilson": {"F": 501, "N": 128}}} for i in (0, 1)]


def read(name, evs=None):
    return cell.read_metric({"name": name, "dir": METRICS / name},
                            {"calls": calls(), "trace": Trace(evs or events())})


def test_wilson_readers():
    assert read("granger.wilson_ms") == pytest.approx((30 + 10 + 30) / 2)
    assert read("granger.wilson_steps") == pytest.approx((3 + 3) / 2)
    bound = roofline_fp64.wilson_bound(501, 128, 3)[0] * 2
    assert read("granger.wilson_roofline") == pytest.approx(100 * bound / (12 + 2 + 6))


def test_wilson_readers_find_nothing_without_the_spans():
    evs = [e for e in events() if not e["name"].startswith("spt.")]
    assert all(read(n, evs) is None for n in ("granger.wilson_ms", "granger.wilson_steps",
                                              "granger.wilson_roofline"))


def test_the_cell_reports_the_three_metrics():
    bench = manifest.load()
    _, config, mix, e2e, layer = manifest.resolve(bench, CELL)
    names = {m["name"] for m in layer}
    assert {"granger.wilson_ms", "granger.wilson_steps", "granger.wilson_roofline",
            "device.idle_share"} == names
    assert {m["name"] for m in e2e} == {"trials_per_s", "setup_s"}
    assert mix["datasets"] == 1 and mix["expect_source"] == "trial store"
    assert config["reduced"] == [] and np.isclose(config["samplerate"], 1000.0)
