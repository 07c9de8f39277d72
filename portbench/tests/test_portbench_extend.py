"""A cell, a traffic mix, a configuration with a frontend of its own, a
reference, and metrics (per-layer and end-to-end) added as new files and
new BENCHMARK.json entries are picked up, and no file that was there
changes."""

import hashlib
import json

from portbench.core import manifest
from portbench.tests import tiny

#: a reference for freqanalysis's multitaper power, written as a new file
PSD = '''"""Multitaper power, trial- and taper-averaged, in float64."""

import numpy as np
import torch

from . import coh


def expected(payload, cfg, args, device):
    spec = coh.spectra(payload, cfg, args, device, torch.float64, 0, cfg["trials"])
    return (spec.abs() ** 2).mean(dim=(0, 1)).cpu().numpy()


def check(got, want, cfg):
    d = np.abs(np.asarray(got, np.float64).reshape(want.shape) - want) / want.max()
    return {"psd_max_rel_err": float(d.max())}


def control(payload, cfg, args, device):
    return expected(payload, cfg, args, device).astype(np.float16)


def work(cfg, args, trials):
    return {}
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_found(tmp_path):
    root = tiny.make_root(tmp_path)
    before = digests(root)
    bench_dir = root / "portbench"
    cfg = json.loads((bench_dir / "configs" / "coh128.json").read_text())
    cfg.update(name="psd16", channels=3, trials=16, default_call="psd",
               calls={"psd": {"frontend": "freqanalysis", "reference": "psd",
                              "args": {"method": "mtmfft", "tapsmofrq": 2, "output": "pow",
                                       "keeptrials": False}},
                      "ppc": cfg["calls"]["ppc"]},
               limits=dict(cfg["limits"], psd_max_rel_err=1e-5))
    (bench_dir / "configs" / "psd16.json").write_text(json.dumps(cfg))
    (bench_dir / "reference" / "psd.py").write_text(PSD)
    (bench_dir / "traffic" / "psd_ppc.json").write_text(json.dumps(
        {"calls": ["default", "ppc"], "datasets": 2, "clear_store": True,
         "expect_source": "upload"}))
    for name, body in (("test.calls_traced", "float(len(ctx.calls))"),
                       ("calls_per_s", "len(ctx.calls) / ctx.window_s")):
        (bench_dir / "metrics" / name).mkdir()
        (bench_dir / "metrics" / name / "reader.py").write_text(
            "def read(ctx):\n    return {}\n".format(body))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "psd16", "source": "https://example.org/psd16",
                             "file": "portbench/configs/psd16.json", "reduced": [],
                             "why": "a configuration added by files alone"})
    bench["workloads"].append({"name": "psd16.psd_ppc", "config": "psd16",
                               "traffic": "psd_ppc", "chips": 1, "why": "added by files"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["psd16.psd_ppc"]})
    bench["per_layer"].append({"name": "test.calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "trials_per_s", "workloads": ["psd16.psd_ppc"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    manifest.resolve(bench, "psd16.psd_ppc", bench_dir, root)

    rc, res, err = tiny.run(root, "psd16.psd_ppc", seconds=1.0, trace=1)
    assert rc == 0 and res is not None, err[-3000:]
    assert res["correct"] is True, res
    assert res["metrics"]["test.calls_traced"]["value"] == res["attempted"]
    assert {"psd_max_rel_err", "ppc_max_abs_err"} <= set(res["checks"])
    rc, res, err = tiny.run(root, "psd16.psd_ppc", seconds=1.0, trace=0)
    assert rc == 0 and res["correct"] is True, err[-3000:]
    assert {"trials_per_s", "setup_s", "calls_per_s"} == set(res["metrics"])
    rc, res, err = tiny.run(root, "psd16.psd_ppc", seconds=1.0, fault="altered")
    assert rc == 0 and res["correct"] is False
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
