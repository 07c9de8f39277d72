"""A checkout in a temporary directory for the harness's tests: a copy of
this folder, ``BENCHMARK.json`` with every configuration cut to a size the
CPU runs in seconds, and a link to the port's package."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

#: the cut: a few trials, channels and samples, at a rate that keeps 3
#: DPSS tapers (tapsmofrq 2 over 200 samples at 200 Hz)
TINY = {"coh128": {"trials": 24, "samples": 200, "channels": 4, "samplerate": 200.0},
        "coh128x4": {"trials": 24, "samples": 200, "channels": 4, "samplerate": 200.0}}


def make_root(tmp, bench=None):
    """A checkout under `tmp` with tiny configurations; returns its path."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    os.symlink(ROOT / "syncopy_tpu_torch", root / "syncopy_tpu_torch")
    if bench is None:
        with open(ROOT / "BENCHMARK.json") as f:
            bench = json.load(f)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f, indent=1)
    for c in bench["configs"]:
        path = root / c["file"]
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TINY.get(c["name"], {}))
        with open(path, "w") as f:
            json.dump(cfg, f, indent=1)
    return root


def run(root, workload, seed=5, seconds=1.0, trace=0, fault=None, timeout=240):
    """One CPU run of `workload` in checkout `root`: (exit code, last line
    of standard output parsed or None, standard error)."""
    cmd = [sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu"]
    if fault:
        cmd += ["--fault", fault]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(cmd, cwd=str(root), capture_output=True, text=True, timeout=timeout,
                          env=env)
    lines = proc.stdout.strip().splitlines()
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except ValueError:
            result = None
    return proc.returncode, result, proc.stderr
