"""Whole runs of the harness on the CPU at a tiny size (``--device cpu``
skips its look for a card): sound runs come out correct, and each fault
planted under the timed path turns ``correct`` false."""

import json

import pytest

from portbench.tests import tiny

CELLS = ("coh128.store", "coh128x4.fresh")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(root, workload, trace):
    rc, res, err = tiny.run(root, workload, seconds=1.0, trace=trace)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is True, res
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in bench[kind] if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) <= allowed
    if not trace:
        assert set(res["metrics"]) == allowed
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    # the compared numbers are the last lines of standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail), tail
    assert "of it the program's libraries" in err


@pytest.mark.parametrize("workload,fault", [
    ("coh128.store", "stale"), ("coh128.store", "half_batch"), ("coh128.store", "altered"),
    ("coh128x4.fresh", "stale"), ("coh128x4.fresh", "no_exchange"),
    ("coh128x4.fresh", "half_batch"),
    ("coh128x4.fresh", "altered")])
def test_fault_is_not_correct(root, workload, fault):
    # a stale result is wrong only from the second timed call on (the first
    # returns the warm-up's result, of the same dataset): give it calls
    rc, res, err = tiny.run(root, workload, seconds=3.0 if fault == "stale" else 1.0,
                            fault=fault)
    assert rc == 0 and res is not None, err[-3000:]
    assert fault != "stale" or res["attempted"] > 1, res
    assert res["correct"] is False, res


def test_guard_refuses_a_run_that_loaded_jax(root):
    rc, res, err = tiny.run(root, "coh128.store", seconds=0.5, fault="load_jax")
    assert rc != 0 and res is None
    assert "jax" in err.strip().splitlines()[-1]


def test_no_card_no_result(root):
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "coh128.store",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=str(root),
                          capture_output=True, text=True, timeout=120)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_bench_files_alone_give_no_result(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "syncopy_tpu_torch").unlink()
    rc, res, err = tiny.run(root, "coh128.store", seconds=0.5)
    assert rc != 0 and res is None
