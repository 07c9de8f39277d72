"""The controls: each reference one precision lower, put in the program's
place, fails at least one of its configuration's limits (here at a tiny
size; ``portbench/calibrate.py`` reads the same on the card at the cells'
own sizes). And a cuda-marked run of a cell on the card."""

import json
import subprocess
import sys

import pytest

from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("config", ["coh128"])
def test_control_fails_a_limit(root, config):
    proc = subprocess.run([sys.executable, "portbench/calibrate.py", "--config", config,
                           "--seeds", "2", "--control-seeds", "2", "--device", "cpu"],
                          cwd=str(root), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1])
    limits = json.loads((root / "portbench" / "configs" / "{}.json".format(config))
                        .read_text())["limits"]
    # sound runs stay within every limit
    assert all(v <= limits[k] for k, v in summary["lower"].items()), summary
    # the control fails at least one, for each of the configuration's methods
    rows = [json.loads(ln) for ln in lines[:-1]]
    for kind in {r["kind"] for r in rows}:
        ctl = [r for r in rows if r["kind"] == kind and r["side"] == "control"]
        assert ctl and all(any(r[k] > limits[k] for k in limits if k in r) for r in ctl), ctl


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_store_cell_on_the_card(card):
    root = tiny.BENCH_DIR.parent
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "coh128.store",
                           "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
                          cwd=str(root), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["kind"] == card
