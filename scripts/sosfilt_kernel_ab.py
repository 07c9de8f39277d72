#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Compare builds of the port's Butterworth cascade source
(``csrc/sosfilt.cu``, ``sosfilt_launch``) on one CUDA card, in one process,
at the main-path shape and on one long recording.

    python3 scripts/sosfilt_kernel_ab.py --parent build/parent/sosfilt.cu \\
        [--variant FMA=0 --variant UNROLL=16,MIN_BLOCKS=3 ...] [--rounds 3]

Each source is built with nvcc (the port's flags plus ``-Xptxas -v``) into
``build/ab/``; the script prints the registers and spills ptxas reports for
the S = 1, 4, 8 and run-time instances (twopass and onepass) and the
resident blocks and warps per SM the runtime grants the S = 4 twopass
instance. It checks every build against float64 scipy ``sosfiltfilt`` /
``sosfilt`` (max|got - scipy| / max|scipy| < 1e-6) at S = 1, 4, 8 and 10
(the run-time instance), at T = 2 and 5 with S = 8 (the wavefront's
prologue and epilogue overlap the whole trial) and with a NaN trial, every
build but the parent against the plain version at 2 float32 ulps of the
maximum (2^-22 max|plain|; the parent's order of additions is not the plain
version's, so its distance is reported only), and two launches for bitwise
equality. Then it times the builds in turns (parent, change, variants, ...,
reversed, for ``--rounds`` rounds): the median of 20 CUDA-event timings at
(N, T, C) = (1000, 1000, 64), order-4 band-pass (S = 4, padlen 27), and of
3 on one (1, 250000, 64) recording, each after warm-ups. A variant is the
current source with ``constexpr int NAME = VALUE;`` lines replaced (knobs
of this script, not of the library: the library builds the source as it
is). The last line is a JSON object with every median.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from syncopy_tpu_torch.ops import _nvcc  # noqa: E402
from syncopy_tpu_torch.ops import iir_kernels as ik  # noqa: E402
from syncopy_tpu_torch.ops.filtering import butter_sos  # noqa: E402

SOURCE = ROOT / "syncopy_tpu_torch" / "csrc" / "sosfilt.cu"
OUT_DIR = ROOT / "build" / "ab"
FS = 1000.0
#: against float64 scipy, relative to its maximum
REL_TOL = 1e-6
#: against the plain version: 2 float32 ulps of the maximum
PLAIN_TOL = 2.0 ** -22
BENCH = (1000, 1000, 64)
LONG = (1, 250_000, 64)
#: the H100 SXM's published FP64 peak outside the tensor cores, and HBM rate
PEAK_FP64_FLOPS, PEAK_HBM_BYTES = 34e12, 3.35e12
#: (label, design) of the checks: (order, freq, type, (N, T, C), NaN trial)
CHECKS = [
    ("S=1 lp order 1", (1, 40.0, "lp", (3, 1000, 33), False)),
    ("S=4 bp order 4", (4, [30.0, 100.0], "bp", (16, 1000, 64), True)),
    ("S=8 bp order 8", (8, [30.0, 100.0], "bp", (3, 700, 40), True)),
    ("S=8 bp order 8, T=2", (8, [30.0, 100.0], "bp", (3, 2, 33), False)),
    ("S=8 bp order 8, T=5", (8, [30.0, 100.0], "bp", (3, 5, 33), True)),
    ("S=10 bp order 10 (run-time)", (10, [60.0, 200.0], "bp", (2, 600, 40), True)),
]


def build(label, source_text):
    """nvcc one source; returns (ctypes lib, {instance: ptxas line})."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "sosfilt_{}.cu".format(label)
    src.write_text(source_text)
    so = OUT_DIR / "sosfilt_{}.so".format(label)
    nvcc = _nvcc._find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    proc = subprocess.run([nvcc, *_nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}".format(label, proc.stderr))
    lib = ctypes.CDLL(str(so))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sosfilt_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, ctypes.c_int, ptr]
    lib.sosfilt_launch.restype = ctypes.c_int
    lib.sosfilt_occupancy.argtypes = [i64, ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
    lib.sosfilt_occupancy.restype = ctypes.c_int
    # per kernel entry "S=<s> twopass|onepass": registers and spills
    ptxas, entry, spills = {}, None, ""
    for ln in proc.stderr.splitlines():
        if "Compiling entry" in ln:
            m = re.search(r"sosfilt_kernelILi(\d+)ELb([01])E", ln)
            entry = None if m is None else "S={} {}".format(
                "run-time" if m.group(1) == "0" else m.group(1),
                "twopass" if m.group(2) == "1" else "onepass")
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln and entry is not None:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            stores = int(re.search(r"(\d+) bytes spill stores", spills).group(1))
            loads = int(re.search(r"(\d+) bytes spill loads", spills).group(1))
            ptxas[entry] = {"registers": regs, "spill_stores": stores, "spill_loads": loads}
            entry = None
    return lib, ptxas


def occupancy(lib, n_sections=4):
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    if lib.sosfilt_occupancy(n_sections, ctypes.byref(threads), ctypes.byref(blocks)) != 0:
        raise RuntimeError("occupancy query failed")
    return {"threads": threads.value, "blocks_per_sm": blocks.value,
            "warps_per_sm": threads.value * blocks.value // 32}


def variant_source(base, spec):
    text = base
    for item in spec.split(","):
        name, value = item.split("=")
        pattern = r"constexpr int {} = \d+;".format(re.escape(name))
        if not re.search(pattern, text):
            raise ValueError("no constexpr int {} in the source".format(name))
        text = re.sub(pattern, "constexpr int {} = {};".format(name, int(value)), text)
    return text


class Launcher:
    """One build's launches on one (N, T, C) float32 batch, with its output
    and scratch allocated once."""

    def __init__(self, lib, x, sos, twopass=True):
        N, T, C = x.shape
        self.lib, self.x, self.twopass = lib, x, twopass
        self.args = (N, T, C, sos.shape[0], ik.sosfilt_padlen(sos, T) if twopass else 0)
        self.sos = torch.from_numpy(np.ascontiguousarray(sos)).to(x.device)
        self.out = torch.empty_like(x)
        self.scratch = (torch.empty((N, T + 2 * self.args[4], C), dtype=torch.float64,
                                    device=x.device) if twopass else None)

    def __call__(self):
        rc = self.lib.sosfilt_launch(
            self.x.data_ptr(), self.sos.data_ptr(),
            None if self.scratch is None else self.scratch.data_ptr(), self.out.data_ptr(),
            *self.args, int(self.twopass), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError("sosfilt launch failed: cudaError {}".format(rc))
        return self.out


def scipy_ref(x, sos, twopass):
    from scipy import signal

    xd = x.astype(np.float64)
    if twopass:
        return signal.sosfiltfilt(sos, xd, axis=1, padlen=ik.sosfilt_padlen(sos, x.shape[1]))
    return signal.sosfilt(sos, xd, axis=1)


def rel_err(got, want):
    """max|got - want| / max|want| over the finite entries of `want`; NaN
    where `want` has NaN, or inf."""
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    ok = ~np.isnan(want)
    return float(np.abs(got[ok] - want[ok]).max() / np.abs(want[ok]).max()) if ok.any() else 0.0


def check(label, lib, enforce_plain):
    """Every design of CHECKS, both directions: scipy, the plain version,
    determinism. Raises on a failed check."""
    worst = {"scipy": 0.0, "plain": 0.0}
    for name, (order, freq, ftype, shape, nan_trial) in CHECKS:
        sos = butter_sos(order, freq, ftype, FS)
        x = np.random.default_rng(order + shape[1]).normal(size=shape).astype(np.float32)
        if nan_trial:
            x[1, shape[1] // 2, shape[2] // 2] = np.nan
        dev = torch.from_numpy(x).to("cuda")
        for twopass in (True, False):
            run = Launcher(lib, dev, sos, twopass)
            got = run().cpu().numpy()
            again = run().cpu().numpy()
            err = rel_err(got, scipy_ref(x, sos, twopass))
            plain = ik.sosfilt_batch_plain(dev, sos, twopass).cpu().numpy()
            plain_err = rel_err(got, plain)
            same = np.array_equal(got, again, equal_nan=True)
            print("{} {} {}: rel err vs float64 scipy {:.3e}, vs the plain version {:.3e} "
                  "({:.2f} float32 ulps of the maximum); two launches bitwise equal: {}".format(
                      label, name, "twopass" if twopass else "onepass", err, plain_err,
                      plain_err / PLAIN_TOL * 2, same))
            worst["scipy"] = max(worst["scipy"], err)
            worst["plain"] = max(worst["plain"], plain_err)
            if not (err < REL_TOL and same and (plain_err <= PLAIN_TOL or not enforce_plain)):
                raise AssertionError("{} fails {} ({})".format(label, name, twopass))
    return worst


def cuda_ms(fn, reps, warmup):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bounds(N, T, C, n_sections, pad):
    """(bound ms, bound_by, pipe ms): 9 FP64 operations per (extended
    sample, section, pass) against the float32 input and output once; the
    pipe adds the float64 scratch written and read once."""
    E = T + 2 * pad
    t_ops = 9.0 * N * C * E * n_sections * 2 / PEAK_FP64_FLOPS * 1e3
    nbytes = 2.0 * N * T * C * 4
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    pipe = (nbytes + 2.0 * N * E * C * 8) / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations", pipe) if t_ops >= t_bytes else (t_bytes, "bytes", pipe)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent commit's sosfilt.cu")
    ap.add_argument("--variant", action="append", default=[], help="NAME=VALUE[,NAME=VALUE]")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sosfilt_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())

    base = SOURCE.read_text()
    sources = {}
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    sources["change"] = base
    for spec in args.variant:
        sources[spec] = variant_source(base, spec)
    libs, result = {}, {"device": torch.cuda.get_device_name(0), "power": smi.stdout.strip()}
    for label, text in sources.items():
        libs[label], ptxas = build(re.sub(r"[^A-Za-z0-9_]+", "_", label), text)
        occ = occupancy(libs[label])
        for inst in ("S=1", "S=4", "S=8", "S=run-time"):
            print("{} {}: {}".format(label, inst, ", ".join(
                "{} {} registers, {} B spill stores, {} B spill loads".format(
                    k.split()[1], v["registers"], v["spill_stores"], v["spill_loads"])
                for k, v in sorted(ptxas.items()) if k.split()[0] == inst)))
        print("{}: S = 4 twopass occupancy {}".format(label, occ))
        result["{} S=4 twopass".format(label)] = dict(ptxas.get("S=4 twopass", {}), **occ)

    for label, lib in libs.items():
        worst = check(label, lib, enforce_plain=label != "parent")
        result["{} worst rel err scipy".format(label)] = worst["scipy"]
        result["{} worst rel err plain".format(label)] = worst["plain"]

    sos = butter_sos(4, [30.0, 100.0], "bp", FS)
    gen = torch.Generator(device="cuda").manual_seed(10)
    x_bench = torch.randn(BENCH, device="cuda", generator=gen)
    x_long = torch.randn(LONG, device="cuda", generator=gen)
    runs = {label: (Launcher(lib, x_bench, sos), Launcher(lib, x_long, sos))
            for label, lib in libs.items()}
    # each build's distance to the first at the main-path shape
    first = None
    for label, (bench, _) in runs.items():
        out = bench().clone()
        if first is None:
            first = out
        print("{} at {}: max |diff| to {} {:.3e}".format(
            label, BENCH, next(iter(runs)), float((out - first).abs().max())))
    del first, out
    pad = ik.sosfilt_padlen(sos, BENCH[1])
    bound_ms, bound_by, pipe_ms = bounds(*BENCH, sos.shape[0], pad)
    long_steps = 2 * (LONG[1] + 2 * pad)
    order = list(libs) + list(reversed(libs))
    samples = {(label, shape): [] for label in libs for shape in ("bench", "long")}
    for _ in range(args.rounds):
        for label in order:
            bench, long = runs[label]
            samples[(label, "bench")].append(cuda_ms(bench, 20, 2))
            samples[(label, "long")].append(cuda_ms(long, 3, 1))
    print("bound at {}: {:.4f} ms ({}), with the float64 scratch {:.4f} ms".format(
        BENCH, bound_ms, bound_by, pipe_ms))
    result.update({"bound_ms": bound_ms, "bound_by": bound_by, "pipe_ms": pipe_ms})
    for label in libs:
        bench = statistics.median(samples[(label, "bench")])
        long = statistics.median(samples[(label, "long")])
        print("{} at {}: median {:.4f} ms of {} medians ({}); {:.1f}% of the bound, {:.1f}% of "
              "the pipe bound".format(label, BENCH, bench, args.rounds * 2, ", ".join(
                  "{:.4f}".format(t) for t in samples[(label, "bench")]),
                  100 * bound_ms / bench, 100 * pipe_ms / bench))
        print("{} on {}: median {:.4f} ms ({}); {:.2f} ns a step of {} steps".format(
            label, LONG, long, ", ".join("{:.4f}".format(t) for t in samples[(label, "long")]),
            1e6 * long / long_steps, long_steps))
        result["{} bench ms".format(label)] = bench
        result["{} long ms".format(label)] = long
        result["{} long ns a step".format(label)] = 1e6 * long / long_steps
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
