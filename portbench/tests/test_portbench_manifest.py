"""BENCHMARK.json resolves, and keeps the benchmark's rules: names and
units of the allowed characters, every cell's metrics, the four-chip
share, the bounds and the window's length."""

import json
import re

import pytest

from portbench.core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell, config, mix, e2e, layer = manifest.resolve(bench, w["name"])
        assert config["name"] == w["config"]
        assert {m["name"] for m in e2e} >= {"setup_s", "trials_per_s"}
        assert layer, w["name"]
        for m in e2e + layer:
            assert (m["dir"] / "reader.py").is_file()
        for call in config["calls"].values():
            assert (manifest.BENCH_DIR / "reference" / "{}.py".format(call["reference"])).is_file()
            assert {"frontend", "reference", "args"} <= set(call)
        assert (manifest.BENCH_DIR / "datagen" / "{}.py".format(config["generator"])).is_file()
        assert config.get("ranks", 1) <= cell["chips"]
        assert set(config["limits"]) >= {"coh_max_abs_err"}


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds"} | set(KEYS)
    for key, keys in KEYS.items():
        names = [it["name"] for it in bench[key]]
        assert len(set(names)) == len(names), key
        for it in bench[key]:
            assert keys <= set(it) <= keys | {"workloads"} and (
                key in ("end_to_end", "per_layer") or "workloads" not in it), it
            assert NAME.match(it["name"]), it["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [c["why"] for c in bench["configs"] + bench["workloads"]] + \
            [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_every_cell_reports_enough(bench):
    cells = {w["name"] for w in bench["workloads"]}
    assert {w["config"] for w in bench["workloads"]} == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(bench, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(bench, w["name"], "per_layer")
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in [x["name"] for x in
                                  manifest.metrics_of(bench, cell, "end_to_end")]


def test_four_chip_share(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_bounds_and_window(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_paths_hold_the_files(bench):
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and (manifest.ROOT / c["file"]).is_file()
        assert json.loads((manifest.ROOT / c["file"]).read_text())["name"] == c["name"]
