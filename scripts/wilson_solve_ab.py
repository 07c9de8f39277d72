#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Time the port's Wilson solve kernel (``csrc/wilson_solve.cu``: X = psi^-1 U
for a batch of complex128 (N, N) matrices) on one CUDA card, in one process,
against the step it replaced and the library calls, at the shapes of
Wilson's step in the Granger benchmark.

    python3 scripts/wilson_solve_ab.py [--rounds 3]

The source is compiled with nvcc (the port's flags plus ``-Xptxas -v``)
into ``build/ab/``; the script prints each kernel instance's registers and
spills from ptxas and the resident blocks per SM the runtime grants at N =
128, checks the build against the plain version (relative to the largest
|X|, 1e-9) and two launches for bitwise equality, then, at (bins, N) =
(501, 128) and (1000, 128), times in turns for ``--rounds`` rounds (the
bare launch, scratch allocated once; the port's wrapper ``wilson_solve``,
which allocates its output and scratch; the parent's step
``_inv_nan(psi) @ U``; the plain version ``wilson_solve_plain``;
``torch.linalg.solve``), each time the median of 20 CUDA-event timings
after 2 warm-ups. The bound: 4/3 N^3 complex multiply-adds a bin at 8 FP64
operations over the FP64 pipes' 34 TFLOP/s (and the tensor cores' 67),
against psi and U read and X written once over 3.35 TB/s. The last line is
a JSON object with every median.

    python3 scripts/wilson_solve_ab.py --small-n [--rounds 3]

builds the source a second time with ``SMALL_N = 0``, so that every N takes
the block instance, checks both builds at N = 1 to 17 and times their bare
launches in turns, with the plain version, at the small-N shapes of
pairwise and jackknife Granger: whether the warp instance earns its keep.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from syncopy_tpu_torch.ops import _nvcc  # noqa: E402

SOURCE = ROOT / "syncopy_tpu_torch" / "csrc" / "wilson_solve.cu"
OUT_DIR = ROOT / "build" / "ab"
REL_TOL = 1e-9
SHAPES = [(501, 128), (1000, 128)]
SMALL_SHAPES = [(4096, 2), (16384, 2), (501, 4), (1503, 8), (1503, 16)]
PIPES_FLOPS, TENSOR_FLOPS, HBM_BYTES = 34e12, 67e12, 3.35e12


def build(small_n=None):
    """nvcc the source, with its ``SMALL_N`` set to `small_n` if given;
    returns (ctypes lib, ptxas lines)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text, tag = SOURCE.read_text(), "wilson_solve"
    if small_n is not None:
        line = "constexpr int SMALL_N = "
        head, rest = text.split(line, 1)
        text = head + line + "{};".format(small_n) + rest.split(";", 1)[1]
        tag += "_small{}".format(small_n)
    src = OUT_DIR / (tag + ".cu")
    src.write_text(text)
    so = OUT_DIR / (tag + ".so")
    nvcc = _nvcc._find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    proc = subprocess.run([nvcc, *_nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n{}".format(proc.stderr))
    lib = ctypes.CDLL(str(so))
    ptr, i64, pint = ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)
    lib.wilson_solve_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr]
    lib.wilson_solve_launch.restype = ctypes.c_int
    lib.wilson_solve_occupancy.argtypes = [i64, pint, pint]
    lib.wilson_solve_occupancy.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in proc.stderr.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return lib, ptxas


def bare(lib, psi, U, X, S):
    N = psi.shape[-1]
    rc = lib.wilson_solve_launch(psi.data_ptr(), U.data_ptr(), X.data_ptr(), S.data_ptr(),
                                 psi.numel() // (N * N), N,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("launch failed: cudaError {}".format(rc))
    return X


def median_ms(fn, reps=20, warm=2):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def inputs(bins, N, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    psi = torch.randn((bins, N, N), dtype=torch.complex128, device=dev, generator=gen)
    psi += 2 * N ** 0.5 * torch.eye(N, dtype=torch.complex128, device=dev)
    U = torch.randn((bins, N, N), dtype=torch.complex128, device=dev, generator=gen)
    return psi, U


def bound_ms(bins, N):
    flops = 4 / 3 * N ** 3 * 8 * bins
    nbytes = 3 * bins * N * N * 16
    return {"pipes_ms": flops / PIPES_FLOPS * 1e3, "tensor_ms": flops / TENSOR_FLOPS * 1e3,
            "bytes_ms": nbytes / HBM_BYTES * 1e3}


def small_n(lib, rounds, dev):
    """The warp instance (this source) against the block instance alone
    (``SMALL_N = 0``) at SMALL_SHAPES, bare launches in turns."""
    from syncopy_tpu_torch.ops import wilson_kernels as wk

    libs = {"warp": lib, "block": build(small_n=0)[0]}
    for N in range(1, 18):
        psi, U = inputs(37, N, dev, seed=N)
        want = wk.wilson_solve_plain(psi, U)
        S = torch.empty((37, N, 2 * N), dtype=psi.dtype, device=dev)
        for name, build_lib in libs.items():
            err = float((bare(build_lib, psi, U, torch.empty_like(psi), S) - want).abs().max()
                        / want.abs().max())
            if not err < REL_TOL:
                raise AssertionError("the {} build fails its check at N = {}".format(name, N))
    print("checks at N = 1 to 17: both builds within {:g} of the plain version".format(REL_TOL))
    result = {}
    for bins, N in SMALL_SHAPES:
        psi, U = inputs(bins, N, dev, seed=bins + N)
        X = torch.empty_like(psi)
        S = torch.empty((bins, N, 2 * N), dtype=psi.dtype, device=dev)
        calls = {name: (lambda b=b: bare(b, psi, U, X, S)) for name, b in libs.items()}
        calls["plain"] = lambda: wk.wilson_solve_plain(psi, U)
        got = {k: [] for k in calls}
        for r in range(rounds):
            for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                got[k].append(median_ms(calls[k]))
        row = {k: statistics.median(v) for k, v in got.items()}
        result["{}x{}".format(bins, N)] = row
        print("({}, {}): ".format(bins, N) + ", ".join(
            "{} {:.4f} ms".format(k, v) for k, v in row.items()))
    print(json.dumps(result))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--small-n", action="store_true",
                        help="time the warp instance against the block instance at small N")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("wilson_solve_ab: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print("card: {} | {} | torch {} cuda {}".format(torch.cuda.get_device_name(0), smi,
                                                  torch.__version__, torch.version.cuda))
    from syncopy_tpu_torch.ops import connectivity as pc
    from syncopy_tpu_torch.ops import wilson_kernels as wk

    lib, ptxas = build()
    print("ptxas:")
    for ln in ptxas:
        print("   ", ln)
    if args.small_n:
        small_n(lib, args.rounds, dev)
        return 0
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.wilson_solve_occupancy(128, ctypes.byref(threads), ctypes.byref(blocks))
    print("N = 128: {} threads a block, {} blocks per SM (rc {})".format(
        threads.value, blocks.value, rc))
    for bins, N in [(64, 128), (40, 33), (64, 7), (8, 256)]:
        psi, U = inputs(bins, N, dev, seed=N)
        X = torch.empty_like(psi)
        S = torch.empty((bins, N, 2 * N), dtype=psi.dtype, device=dev)
        got = bare(lib, psi, U, X, S).clone()
        want = wk.wilson_solve_plain(psi, U)
        err = float((got - want).abs().max() / want.abs().max())
        same = bool(torch.equal(got, bare(lib, psi, U, torch.empty_like(psi), S)))
        print("check ({}, {}): rel err {:.3e}, bitwise repeat {}".format(bins, N, err, same))
        if not (err < REL_TOL and same):
            raise AssertionError("the kernel fails its check at ({}, {})".format(bins, N))

    result = {}
    for bins, N in SHAPES:
        psi, U = inputs(bins, N, dev, seed=bins + N)
        X = torch.empty_like(psi)
        S = torch.empty((bins, N, 2 * N), dtype=psi.dtype, device=dev)
        calls = {
            "kernel": lambda: bare(lib, psi, U, X, S),
            "wrapper": lambda: wk.wilson_solve(psi, U),
            "parent_step": lambda: pc._inv_nan(psi) @ U,
            "plain": lambda: wk.wilson_solve_plain(psi, U),
            "linalg_solve": lambda: torch.linalg.solve(psi, U),
        }
        order = list(calls)
        got = {k: [] for k in order}
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                got[k].append(median_ms(calls[k]))
        row = {k: statistics.median(v) for k, v in got.items()}
        row.update(bound_ms(bins, N))
        row["rounds"] = got
        result["{}x{}".format(bins, N)] = row
        print("({}, {}): ".format(bins, N) + ", ".join(
            "{} {:.4f} ms".format(k, row[k]) for k in order + ["pipes_ms", "tensor_ms", "bytes_ms"]))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
