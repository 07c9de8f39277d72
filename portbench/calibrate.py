#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from; not part of a
benchmark run.

    python3 portbench/calibrate.py --config coh128 --seeds 12 --control-seeds 3

For each of `--seeds` seeds (from `--first-seed`), makes dataset 0 of the
configuration from that seed, runs each of its call kinds once through the
program on one card, exactly as the timed path calls it, and prints the
numbers that ``check`` compares (the lower readings: program against the
float64 reference), with what the reference's ``look`` reads beside them. For `--control-seeds` of them it puts each reference's
``control`` (the same math one precision lower) in the program's place
and prints the same numbers (the upper readings). The last line is a JSON
summary: per number, the largest program reading and the smallest control
reading. ``--device cpu`` runs it on the CPU at whatever size the
configuration file states (the harness's tests use it at a tiny size).
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--calls", default=None, help="comma-separated call kinds (default all)")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--root", default=str(ROOT))
    args = p.parse_args(argv)
    root = Path(args.root)
    sys.path.insert(0, str(root))
    import torch

    import syncopy_tpu_torch as spt
    from portbench.core import guard

    with open(root / "portbench" / "configs" / "{}.json".format(args.config)) as f:
        cfg = json.load(f)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    spt.set_device(dev)
    gen = importlib.import_module("portbench.datagen." + cfg["generator"])
    kinds = args.calls.split(",") if args.calls else list(cfg["calls"])
    refs = {k: importlib.import_module("portbench.reference." + cfg["calls"][k]["reference"])
            for k in kinds}
    trl = gen.trialdefinition(cfg)
    lower, upper = {}, {}
    for n in range(args.seeds):
        seed = args.first_seed + n
        payload = gen.make(cfg, seed, 0, dev)
        adata = spt.from_arrays(payload, trl, cfg["samplerate"])
        for k in kinds:
            call = cfg["calls"][k]
            spt.clear_device_cache()
            t0 = time.perf_counter()
            got = np.asarray(getattr(spt, call["frontend"])(adata, **call["args"]).data)
            wall = time.perf_counter() - t0
            want = refs[k].expected(payload, cfg, call["args"], dev)
            nums = refs[k].check(got, want, cfg)
            seen = refs[k].look(got, want, cfg) if hasattr(refs[k], "look") else {}
            print(json.dumps({"seed": seed, "kind": k, "side": "program", "wall_s": wall, **nums,
                              "look": seen}), flush=True)
            for name, v in nums.items():
                lower[name] = max(lower.get(name, 0.0), v)
            if n < args.control_seeds:
                low = refs[k].control(payload, cfg, call["args"], dev)
                nums = refs[k].check(low, want, cfg)
                seen = refs[k].look(low, want, cfg) if hasattr(refs[k], "look") else {}
                print(json.dumps({"seed": seed, "kind": k, "side": "control", **nums,
                                  "look": seen}), flush=True)
                for name, v in nums.items():
                    upper[name] = min(upper.get(name, float("inf")), v)
        del adata, payload
        spt.clear_device_cache()
    found = guard.forbidden()
    if found:
        print("calibrate: loaded {}".format(found), file=sys.stderr)
        return 1
    print(json.dumps({"config": args.config, "seeds": args.seeds,
                      "control_seeds": args.control_seeds, "lower": lower, "upper": upper,
                      "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
