#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Split the port's coherence jackknife call into its engine passes on one
CUDA card.

    python3 scripts/jackknife_profile.py [--trials 1000]

On chip_smoke.py's north-star data (float32 normal noise from seed 0,
1000 samples at 1 kHz, 64 channels; the first --trials trials) it makes
one call of ``connectivityanalysis(method="coh", tapsmofrq=2,
jackknife=True)`` and prints, for each engine pass (the single-trial
CSDs, their mean, the leave-one-out replicates, the float64 coherence of
the direct estimate and of the replicates, and bias_var's two float64
trial reductions), its synchronized wall and the host seconds of its
gather; then the seconds and gigabytes of every device-to-host copy, the
call's wall, its peak device memory and its peak host RSS.
"""

import argparse
import collections
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trials", type=int, default=1000)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("jackknife_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import syncopy_tpu_torch as spt
    from syncopy_tpu_torch.engine import routine

    spt.set_device("cuda:0")
    print(torch.cuda.get_device_name(0))
    seconds = collections.defaultdict(float)
    compute, gather = routine.ComputationalRoutine.compute, routine.ComputationalRoutine._gather_batch
    copy_to_host = torch.Tensor.copy_

    def timed_compute(self, *a, **k):
        t0 = time.perf_counter()
        compute(self, *a, **k)
        torch.cuda.synchronize()
        flags = {key: v for key, v in self.cfg.items() if key in ("mode", "double", "exact_fft")}
        seconds["{} {}, wall".format(type(self).__name__, flags)] += time.perf_counter() - t0

    def timed_gather(self, *a, **k):
        t0 = time.perf_counter()
        batch = gather(self, *a, **k)
        seconds["{}, host gather".format(type(self).__name__)] += time.perf_counter() - t0
        return batch

    def timed_copy(self, src, *a, **k):
        if not (self.device.type == "cpu" and src.device.type == "cuda"):
            return copy_to_host(self, src, *a, **k)
        t0 = time.perf_counter()
        out = copy_to_host(self, src, *a, **k)
        seconds["device-to-host copies, s"] += time.perf_counter() - t0
        seconds["device-to-host copies, GB"] += src.numel() * src.element_size() / 1e9
        return out

    n = min(args.trials, cs.N_TRIALS)
    data, trl = cs.north_star_data()
    adata = spt.from_arrays(data[: n * cs.N_SAMPLES], trl[:n], cs.FS)
    routine.ComputationalRoutine.compute = timed_compute
    routine.ComputationalRoutine._gather_batch = timed_gather
    torch.Tensor.copy_ = timed_copy
    torch.cuda.reset_peak_memory_stats()
    try:
        with cs.HostPeak() as host:
            t0 = time.perf_counter()
            spt.connectivityanalysis(adata, method="coh", tapsmofrq=2, jackknife=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        routine.ComputationalRoutine.compute = compute
        routine.ComputationalRoutine._gather_batch = gather
        torch.Tensor.copy_ = copy_to_host
    for key, value in seconds.items():
        print("  {}: {:.3f}".format(key, value))
    print("coh jackknife, {} trials: wall {:.3f} s; peak device memory {:.3f} GB; peak host RSS "
          "{:.3f} GB{}".format(n, wall, torch.cuda.max_memory_allocated() / 1e9, host.gb,
                               " (since the process started)" if host.since_start else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
