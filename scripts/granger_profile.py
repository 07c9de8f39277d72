#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Profile the port's Granger call on one CUDA card.

    python3 scripts/granger_profile.py [--channels 64,128] [--top 12]

For each channel count it builds chip_smoke.py's AR(2) network (1000
trials x 1000 samples at 1 kHz, numpy seed 7), makes one warm call of
``connectivityanalysis(method="granger")``, then traces one more under
``torch.profiler`` (CPU and CUDA activities). It prints the traced call's
wall, the device time summed over every kernel and copy, the device's
busy share of the wall, then the kernels and copies with the most device
time and the operators (aten ops) whose kernels take the most, each with
its count and milliseconds. The profiler's own cost inflates the traced
wall; the busy share is a lower bound for that reason.
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the profiler's own bookkeeping, which it reports as device activity
PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--channels", default="64,128")
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("granger_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import syncopy_tpu_torch as spt

    CUDA = torch.autograd.DeviceType.CUDA
    spt.set_device("cuda:0")
    print(torch.cuda.get_device_name(0))
    for n_chan in (int(c) for c in args.channels.split(",")):
        data = cs.ar2_network(n_chan)
        trl = np.zeros((cs.N_TRIALS, 3))
        trl[:, 0] = np.arange(cs.N_TRIALS) * cs.N_SAMPLES
        trl[:, 1] = trl[:, 0] + cs.N_SAMPLES
        adata = spt.from_arrays(data, trl, cs.FS)
        spt.connectivityanalysis(adata, method="granger")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            spt.connectivityanalysis(adata, method="granger")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == CUDA and e.name not in PROFILER_OWN]
        device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3  # kernels, copies
        print("granger {} ch traced call: wall {:.1f} ms, device time {:.1f} ms in {} "
              "kernels and copies, busy {:.1f}% of the wall".format(
                  n_chan, 1e3 * wall, device_ms, len(events), 100 * device_ms / (1e3 * wall)))
        rows = [r for r in prof.key_averages() if r.key not in PROFILER_OWN]
        kernels = sorted((r for r in rows if r.device_type == CUDA),
                         key=lambda r: r.self_device_time_total, reverse=True)
        ops = sorted((r for r in rows if r.device_type != CUDA),
                     key=lambda r: r.device_time_total, reverse=True)
        for title, table, total in (("kernels and copies", kernels, "self_device_time_total"),
                                    ("operators, device time of their kernels", ops,
                                     "device_time_total")):
            print(" {}:".format(title))
            for row in table[: args.top]:
                print("  {:<64s} {:>6d} calls {:>10.3f} ms".format(
                    row.key[:64], row.count, getattr(row, total) / 1e3))
        del adata, data
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
