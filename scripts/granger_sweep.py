#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Which datasets of the Granger benchmark's data maker take Wilson's
two-sided retry, on one CUDA card.

    python3 scripts/granger_sweep.py --first-seed 3200000100 --seeds 44
    python3 scripts/granger_sweep.py --seed-list 3200000110,3200000130

For each seed, dataset 0 of ``portbench/configs/granger128.json`` (the
data of ``portbench/run.py --workload granger128.store --seed <seed>``),
two calls of ``connectivityanalysis(method="granger")``, the second
timed; prints one JSON line a seed with the walls, the Wilson counters of
the second call (``ops/connectivity.py::wilson_counts``: one-sided,
two-sided and host factorizations and the device steps), its convergence
diagnostics and its peak device memory, and, for the first seed and every
seed that took the retry, G's largest difference from the float64
reference (``portbench/reference/granger.py``).
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--first-seed", type=int, default=3_200_000_100)
    parser.add_argument("--seeds", type=int, default=44)
    parser.add_argument("--seed-list", default=None, help="comma-separated seeds")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import syncopy_tpu_torch as spt
    from portbench.datagen import ar2_network as gen
    from portbench.reference import granger as ref
    from syncopy_tpu_torch.ops import connectivity as pc

    if not torch.cuda.is_available():
        print("granger_sweep: no CUDA card", file=sys.stderr)
        return 3
    seeds = ([int(s) for s in args.seed_list.split(",")] if args.seed_list
             else range(args.first_seed, args.first_seed + args.seeds))
    with open(os.path.join(REPO, "portbench", "configs", "granger128.json")) as f:
        cfg = json.load(f)
    dev = torch.device("cuda", 0)
    spt.set_device(dev)
    trl = gen.trialdefinition(cfg)
    for k, seed in enumerate(seeds):
        payload = gen.make(cfg, seed, 0, dev)
        adata = spt.from_arrays(payload, trl, cfg["samplerate"])
        walls = []
        for _ in range(2):
            pc.reset_wilson_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = spt.connectivityanalysis(adata, method="granger")
            G = np.asarray(out.data)
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        row = {"seed": seed, "walls": walls, "counts": pc.wilson_counts(),
               "converged": bool(out.info["converged"]),
               "max_rel_err": float(out.info["max rel. err"]),
               "peak": int(torch.cuda.max_memory_allocated(dev))}
        if k == 0 or row["counts"]["two_sided"]:
            want = ref.expected(payload, cfg, {"method": "granger"}, dev)
            row.update(ref.check(G, want, cfg))
        print(json.dumps(row), flush=True)
        del adata, payload
        spt.clear_device_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
