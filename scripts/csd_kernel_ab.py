#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Compare builds of the port's CSD kernel source (both instances: the tiled
``csd_accumulate_tiled_launch`` and the untiled ``csd_accumulate_launch``)
on one CUDA card, in one process, at the bench shapes, with the library
calls beside them.

    python3 scripts/csd_kernel_ab.py --parent build/parent/csd_accumulate.cu \\
        [--variant STAGES=2,MIN_BLOCKS=7 ...] [--rounds 3]

Each source is built with nvcc (the port's flags plus ``-Xptxas -v``) into
``build/ab/``; the script prints each kernel's registers and spills from
ptxas, the resident blocks per SM the runtime grants (where the source
exports ``csd_accumulate_occupancy``), checks every build against a
complex128 oracle (max|got - oracle| / max|oracle| < 1e-5) and two
launches for bitwise equality, then times the builds in turns (parent,
change, variants, ..., reversed, for ``--rounds`` rounds; each time the
median of 20 CUDA-event timings after 2 warm-ups). A variant is the
current source with ``constexpr int NAME = VALUE;`` lines replaced.

Shapes: tiled (N, F, C, n_valid) = (3072, 501, 64, 3000) with NaN rows
past n_valid; untiled (F, N, C) = (501, 3000, 64). The last line is a JSON
object with every median.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from syncopy_tpu_torch.ops import _nvcc  # noqa: E402

SOURCE = ROOT / "syncopy_tpu_torch" / "csrc" / "csd_accumulate.cu"
OUT_DIR = ROOT / "build" / "ab"
REL_TOL = 1e-5


def build(label, source_text):
    """nvcc one source; returns (ctypes lib, ptxas lines)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "{}.cu".format(label)
    src.write_text(source_text)
    so = OUT_DIR / "{}.so".format(label)
    nvcc = _nvcc._find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    proc = subprocess.run([nvcc, *_nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}".format(label, proc.stderr))
    lib = ctypes.CDLL(str(so))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.csd_accumulate_tiled_launch.argtypes = [ptr, ptr, i64, i64, i64, i64, ptr]
    lib.csd_accumulate_tiled_launch.restype = ctypes.c_int
    lib.csd_accumulate_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.csd_accumulate_launch.restype = ctypes.c_int
    # per kernel entry: "<instance>: N registers, S spill stores, L spill loads"
    ptxas, entry = [], "?"
    for ln in proc.stderr.splitlines():
        if "Compiling entry" in ln:
            entry = "planar" if "PlanarRows" in ln else "interleaved"
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            ptxas.append("{}: {} registers, {}".format(entry, regs, spills))
    return lib, ptxas


def occupancy(lib, planar):
    try:
        fn = lib.csd_accumulate_occupancy
    except AttributeError:
        return None
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    if fn(int(planar), ctypes.byref(threads), ctypes.byref(blocks)) != 0:
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


#: (label, [(text in the source, its replacement), ...]): builds that
#: leave out one part of the work, to see what each part costs
DIAGNOSTICS = {
    # every row of a stage reads the staged values of the slice's first row,
    # so the loads hoist out of the row loop
    "no_lds": [("const int r = slice * ROWS_PER_SLICE + k;",
                "const int r = slice * ROWS_PER_SLICE + 0 * k;")],
    # only the prologue's stages are copied; the loop computes on them again
    "no_copy": [("if (s + STAGES - 1 < n_stages) issue(", "if (false) issue(")],
    # no barrier at the top of the stage loop
    "no_bar": [("cp_async_wait<STAGES - 2>();\n        __syncthreads();",
                "cp_async_wait<STAGES - 2>();")],
    # all three: the FMAs, the group folds and the stores remain
    "fma_only": [("const int r = slice * ROWS_PER_SLICE + k;",
                  "const int r = slice * ROWS_PER_SLICE + 0 * k;"),
                 ("if (s + STAGES - 1 < n_stages) issue(", "if (false) issue("),
                 ("cp_async_wait<STAGES - 2>();\n        __syncthreads();",
                  "cp_async_wait<STAGES - 2>();")],
}


def diagnostic_sources(base):
    out = {}
    for label, edits in DIAGNOSTICS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError("diagnostic {}: {!r} is not once in the source".format(label, old))
            text = text.replace(old, new)
        out[label] = text
    return out


def sample_clocks(fn, seconds=2.0):
    """nvidia-smi's SM clock, power draw and limit sampled while `fn` runs
    back to back for about `seconds`."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < 0.05:
        fn()
        n += 1
    torch.cuda.synchronize()
    per_s = max(1, int(n / (time.perf_counter() - t0)))
    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
             "--format=csv,noheader", "-lms", "250"]
    proc = subprocess.Popen(query, stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(int(per_s * seconds)):
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        lines = proc.communicate(timeout=30)[0].strip().splitlines()
    return lines


def cuda_ms(fn, reps=20, warmup=2):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent commit's csd_accumulate.cu")
    ap.add_argument("--variant", action="append", default=[], help="NAME=VALUE[,NAME=VALUE]")
    ap.add_argument("--diagnostics", action="store_true",
                    help="also time builds of the current source that leave out one part of "
                         "the work (see DIAGNOSTICS); their results are wrong by design, so "
                         "their check is reported and not enforced")
    ap.add_argument("--clocks", action="store_true",
                    help="sample the SM clock and power with nvidia-smi while the current "
                         "tiled kernel runs in a loop for about two seconds")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--f-values", default="",
                    help="comma-separated frequency counts at which to time every build's tiled "
                         "kernel as well (N, C, n_valid as at the bench shape)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("csd_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    assert not torch.backends.cuda.matmul.allow_tf32

    base = SOURCE.read_text()
    sources = {}
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    sources["change"] = base
    for spec in args.variant:
        sources[spec] = variant_source(base, spec)
    diagnostic = set()
    if args.diagnostics:
        for label, text in diagnostic_sources(base).items():
            sources[label] = text
            diagnostic.add(label)
    libs = {}
    for label, text in sources.items():
        safe_label = re.sub(r"[^A-Za-z0-9_]+", "_", label)
        libs[label], ptxas = build(safe_label, text)
        print("{}: {}".format(label, " | ".join(ptxas)))
        print("{}: occupancy tiled {}, untiled {}".format(
            label, occupancy(libs[label], False), occupancy(libs[label], True)))

    N, F, C, nv = 3072, 501, 64, 3000
    gen = torch.Generator(device="cuda").manual_seed(7)
    spec = torch.randn((N, F, C), dtype=torch.complex64, device="cuda", generator=gen)
    spec[nv:] = float("nan")
    re_p = torch.randn((F, nv, C), device="cuda", generator=gen)
    im_p = torch.randn((F, nv, C), device="cuda", generator=gen)
    out = torch.empty((F, C, C), dtype=torch.complex64, device="cuda")
    out_re = torch.empty((F, C, C), device="cuda")
    out_im = torch.empty((F, C, C), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def tiled(lib):
        rc = lib.csd_accumulate_tiled_launch(spec.data_ptr(), out.data_ptr(), N, F, C, nv, stream)
        if rc != 0:
            raise RuntimeError("tiled launch failed: cudaError {}".format(rc))

    def untiled(lib):
        rc = lib.csd_accumulate_launch(re_p.data_ptr(), im_p.data_ptr(), out_re.data_ptr(),
                                       out_im.data_ptr(), F, nv, C, stream)
        if rc != 0:
            raise RuntimeError("untiled launch failed: cudaError {}".format(rc))

    rows = spec[:nv].to(torch.complex128).permute(1, 0, 2)
    want_t = torch.matmul(rows.transpose(1, 2), rows.conj())
    del rows
    z128 = torch.complex(re_p.double(), im_p.double())
    want_u = torch.matmul(z128.transpose(1, 2), z128.conj())
    del z128
    for label, lib in libs.items():
        tiled(lib)
        first = out.clone()
        tiled(lib)
        torch.cuda.synchronize()
        err_t = ((out.to(torch.complex128) - want_t).abs().max() / want_t.abs().max()).item()
        untiled(lib)
        first_u = torch.complex(out_re, out_im)
        untiled(lib)
        torch.cuda.synchronize()
        got_u = torch.complex(out_re, out_im)
        err_u = ((got_u.to(torch.complex128) - want_u).abs().max() / want_u.abs().max()).item()
        same = torch.equal(first, out) and torch.equal(first_u, got_u)
        print("{}: rel err tiled {:.3e}, untiled {:.3e}; two launches bitwise equal: {}".format(
            label, err_t, err_u, same))
        if label not in diagnostic and not (err_t < REL_TOL and err_u < REL_TOL and same):
            raise AssertionError("{} fails the oracle or determinism check".format(label))

    s = spec[:nv]
    z = torch.complex(re_p, im_p)
    library = {
        "tiled": lambda: torch.einsum("nfi,nfj->fij", s, s.conj()),
        "untiled": lambda: torch.matmul(z.transpose(1, 2), z.conj()),
    }
    order = list(libs) + list(reversed(libs))
    samples = {(label, kind): [] for label in libs for kind in ("tiled", "untiled")}
    lib_samples = {kind: [] for kind in library}
    for _ in range(args.rounds):
        for kind, fn in library.items():
            lib_samples[kind].append(cuda_ms(fn))
        for label in order:
            samples[(label, "tiled")].append(cuda_ms(lambda: tiled(libs[label])))
            samples[(label, "untiled")].append(cuda_ms(lambda: untiled(libs[label])))
    result = {"device": torch.cuda.get_device_name(0), "power": smi.stdout.strip()}
    for (label, kind), ms in samples.items():
        print("{} {}: median {:.4f} ms of {} medians ({})".format(
            label, kind, statistics.median(ms), len(ms), ", ".join("{:.4f}".format(t) for t in ms)))
        result["{} {}".format(label, kind)] = statistics.median(ms)
    for kind, ms in lib_samples.items():
        print("library {}: median {:.4f} ms ({})".format(
            kind, statistics.median(ms), ", ".join("{:.4f}".format(t) for t in ms)))
        result["library {}".format(kind)] = statistics.median(ms)
    if args.clocks:
        for line in sample_clocks(lambda: tiled(libs["change"])):
            print("clocks while the tiled kernel runs: {}".format(line))
    del spec, re_p, im_p, z, s
    for f_count in [int(v) for v in args.f_values.split(",") if v]:
        spec_f = torch.randn((N, f_count, C), dtype=torch.complex64, device="cuda", generator=gen)
        out_f = torch.empty((f_count, C, C), dtype=torch.complex64, device="cuda")
        for label, lib in libs.items():
            ms = cuda_ms(lambda: lib.csd_accumulate_tiled_launch(
                spec_f.data_ptr(), out_f.data_ptr(), N, f_count, C, nv, stream))
            print("{} tiled at F = {}: {:.4f} ms, {:.3f} us per frequency".format(
                label, f_count, ms, 1e3 * ms / f_count))
            result["{} tiled F={}".format(label, f_count)] = ms
        del spec_f, out_f
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
