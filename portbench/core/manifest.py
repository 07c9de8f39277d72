"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``). Every metric that the cell
reports, end-to-end or per-layer, has a folder ``metrics/<name>/`` with a
``reader.py`` and, where it needs them, kernel-name ``*.txt`` files. A
configuration's ``generator`` names ``datagen/<name>.py`` and each of its
calls' ``reference`` names ``reference/<name>.py``. Adding a cell, a mix, a
configuration or a metric adds files and entries; no file that exists is
edited.
"""

import json
from pathlib import Path

#: the harness's own folder and the checkout root
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class ManifestError(ValueError):
    pass


def _json(path):
    with open(path) as f:
        return json.load(f)


def load(root=ROOT):
    """The parsed BENCHMARK.json at `root`."""
    return _json(Path(root) / "BENCHMARK.json")


def metrics_of(bench, cell, kind):
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
    reports: those whose ``workloads`` list holds it, or that have none."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def resolve(bench, cell_name, bench_dir=BENCH_DIR, root=ROOT):
    """Everything one run of `cell_name` needs, by name: ``(cell, config,
    traffic, end_to_end metrics, per_layer metrics)``. The configuration
    and the traffic are the parsed files; a metric is its manifest entry
    with ``dir``, the folder of its reader."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise ManifestError("no cell {!r} in BENCHMARK.json".format(cell_name))
    cell = cells[cell_name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(Path(root) / entry["file"])
    if config.get("ranks", 1) > cell["chips"]:
        raise ManifestError("cell {} asks for {} chips and its configuration for {} ranks".format(
            cell_name, cell["chips"], config["ranks"]))
    traffic = _json(Path(bench_dir) / "traffic" / "{}.json".format(cell["traffic"]))
    found = {}
    for kind in ("end_to_end", "per_layer"):
        found[kind] = []
        for m in metrics_of(bench, cell_name, kind):
            d = Path(bench_dir) / "metrics" / m["name"]
            if not (d / "reader.py").is_file():
                raise ManifestError("metric {} has no {}".format(m["name"], d / "reader.py"))
            found[kind].append(dict(m, dir=d))
    return cell, config, traffic, found["end_to_end"], found["per_layer"]
