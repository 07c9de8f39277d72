#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Factorize one averaged Granger CSD with the port and with the JAX
package, on the CPU, and compare.

    python3 scripts/granger_compare_jax.py DIR/granger_csd64.npz

The file comes from ``python3 chip_smoke.py --save-csd DIR``: the port's
complex64 (F, N, N) CSD of the north-star Granger call and the G the
card computed from it. The script runs, each on that CSD with rtol 5e-6,
nIter 100 and cond_max 1e4:

- the port (``syncopy_tpu_torch.ops.connectivity``: regularize_csd,
  wilson_sf, granger; complex128, on the CPU), with its step count;
- the JAX package's complex128 route (x64 on), the one the port carries
  over: its error at the stop says whether it stopped at the port's step;
- the JAX package's float32 route (x64 off, in a child process): the
  double-float32 machinery, compensated-residual Newton refinement and
  g-forcing of excluded bins, the stack its TPU path runs.

It prints each one's converged flag, error and host seconds (CPU times,
not a device metric), and the largest |G| differences between them and
against the card's G. The last line is a JSON object with the numbers.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, N_ITER, COND_MAX = 5e-6, 100, 1e4


def jax_granger(csd, x64):
    """The JAX package's regularize_csd, wilson_sf and granger on `csd`."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    import jax.numpy as jnp

    from syncopy_tpu.ops import connectivity as jops

    t0 = time.perf_counter()
    C = jnp.asarray(csd.astype(np.complex128 if x64 else np.complex64))
    reg, eps, _ = jops.regularize_csd(C, cond_max=COND_MAX, eps_max=1e-1)
    H, Sigma, conv, err = jops.wilson_sf(reg, nIter=N_ITER, rtol=RTOL)
    G = np.asarray(jops.granger(reg, H, Sigma), dtype=np.float64)
    return G, bool(conv), float(err), float(eps), time.perf_counter() - t0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("npz", help="granger_csd64.npz from chip_smoke.py --save-csd")
    parser.add_argument("--jax-f32-to", metavar="NPY", help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    saved = np.load(args.npz)
    csd = saved["csd"]

    if args.jax_f32_to:  # the child: the JAX float32 route alone
        G, conv, err, eps, seconds = jax_granger(csd, x64=False)
        np.save(args.jax_f32_to, G)
        print(json.dumps({"converged": conv, "err": err, "eps": eps, "seconds": seconds}))
        return 0

    import torch

    from syncopy_tpu_torch.ops import connectivity as pc

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    reg, eps, _ = pc.regularize_csd(torch.from_numpy(csd).to(torch.complex128),
                                    cond_max=COND_MAX, eps_max=1e-1)
    H, Sigma, conv, err, steps = pc.wilson_sf(reg, nIter=N_ITER, rtol=RTOL)
    G_port = pc.granger(reg, H, Sigma).numpy()
    port = {"converged": bool(conv), "err": float(err), "steps": int(steps),
            "eps": float(eps), "seconds": time.perf_counter() - t0}

    f32_path = os.path.join(os.path.dirname(os.path.abspath(args.npz)), "granger_jax_f32.npy")
    child = subprocess.run([sys.executable, os.path.abspath(__file__), args.npz,
                            "--jax-f32-to", f32_path], capture_output=True, text=True,
                           check=True, timeout=3000)
    jax_f32 = json.loads(child.stdout.strip().splitlines()[-1])
    G_f32 = np.load(f32_path)
    G_f64, conv64, err64, eps64, sec64 = jax_granger(csd, x64=True)
    jax_f64 = {"converged": conv64, "err": err64, "eps": eps64, "seconds": sec64,
               "same_stop_as_port": abs(err64 / port["err"] - 1) < 1e-3}

    G_card = saved["G"].astype(np.float64)

    def diff(a, b):
        d = np.abs(a - b)
        return {"max": float(d.max()), "dc_adjacent": float(d[1].max()),
                "past_bin_5": float(d[6:].max())}

    result = {"shape": list(csd.shape), "port_cpu": port, "jax_complex128": jax_f64,
              "jax_float32_stack": jax_f32,
              "G_port_cpu_vs_jax_complex128": diff(G_port, G_f64),
              "G_jax_float32_stack_vs_complex128": diff(G_f32, G_f64),
              "G_card_vs_port_cpu": diff(G_card, G_port)}
    for key, value in result.items():
        print("{}: {}".format(key, value))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
