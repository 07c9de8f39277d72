#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the ``syncopy_tpu_torch`` package. Set-up (import, card, libraries built
into ``build/`` on a checkout's first run, data made from the seed, one
warm call of each of the cell's call kinds), then closed-loop calls for
``--seconds``, then the check of a sample of the window's results against
the plain references. The last line of standard output is the result's
JSON; the numbers compared, each beside its limit, are the last lines of
standard error. ``--trace 1`` profiles the window and reports the cell's
per-layer metrics instead of its end-to-end ones.

Exits non-zero without a result when no CUDA card (or fewer than the cell
asks for) is present, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: the program's build and kernel caches, at fixed paths inside the checkout
CACHE = ROOT / ".portbench_cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    # the harness's own: the CPU for its tests, a planted fault for its
    # tests, and the ranks it starts
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from portbench.core import cell

    opts = cell.Options(workload=args.workload, seed=args.seed, seconds=args.seconds,
                        trace=args.trace, device=args.device, fault=args.fault, rank=args.rank,
                        world=args.world, port=args.port, t_start=T_START, root=ROOT,
                        bench_dir=BENCH_DIR)
    return cell.main(opts)


if __name__ == "__main__":
    sys.exit(main())
