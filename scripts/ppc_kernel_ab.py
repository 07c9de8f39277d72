#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Compare builds of the port's PPC resultant kernel source
(``ppc_accumulate_tiled_launch``) on one CUDA card, in one process, at the
bench chunk.

    python3 scripts/ppc_kernel_ab.py --parent build/parent/ppc_accumulate.cu \\
        [--variant STAGES=2,MIN_BLOCKS=3 ...] [--diagnostics] [--k-values 1,4,7] \\
        [--rounds 3]

Each source is built with nvcc (the port's flags plus ``-Xptxas -v``) into
``build/ab/``; the script prints each kernel instance's registers and
spills from ptxas and the resident blocks and warps per SM the runtime
grants (where the source exports ``ppc_accumulate_occupancy``), checks
every build against a complex128 oracle (max|got - oracle| / n_valid <
1e-5, an exactly Hermitian U with the diagonal n_valid + 0j) at data
scales 1, 1e-13 and 1e10, and two launches for bitwise equality, then
times the builds in turns (parent, change, variants, ..., reversed, for
``--rounds`` rounds; each time the median of 20 CUDA-event timings after 2
warm-ups). A variant is the current source with ``constexpr int NAME =
VALUE;`` lines replaced; a diagnostic build leaves out one part of the
work (see DIAGNOSTICS), so its check is reported and not enforced, and
the parent's checks at scales other than 1 are reported only (it drops
every term there).

Shape: (N, K, F, C) = (1024, 3, 501, 64), n_valid = 1000, NaN trials past
n_valid. ``--k-values`` also times every build at other taper counts (N,
F, C, n_valid as at the bench chunk). The last line is a JSON object with
every median.
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

SOURCE = ROOT / "syncopy_tpu_torch" / "csrc" / "ppc_accumulate.cu"
OUT_DIR = ROOT / "build" / "ab"
TOL = 1e-5
SCALES = (1.0, 1e-13, 1e10)
N, K, F, C, NV = 1024, 3, 501, 64, 1000


def build(label, source_text):
    """nvcc one source; returns (ctypes lib, ptxas lines)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "ppc_{}.cu".format(label)
    src.write_text(source_text)
    so = OUT_DIR / "ppc_{}.so".format(label)
    nvcc = _nvcc._find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    proc = subprocess.run([nvcc, *_nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}".format(label, proc.stderr))
    lib = ctypes.CDLL(str(so))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ppc_accumulate_tiled_launch.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.ppc_accumulate_tiled_launch.restype = ctypes.c_int
    # per kernel entry: "K=<instance>: N registers, S spill stores, L spill loads"
    ptxas, entry, spills = [], "?", ""
    for ln in proc.stderr.splitlines():
        if "Compiling entry" in ln:
            m = re.search(r"ppc_accumulate_kernelILi(\d+)E", ln)
            entry = "K=" + (("runtime" if m.group(1) == "0" else m.group(1)) if m else "any")
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            ptxas.append("{}: {} registers, {}".format(entry, regs, spills))
    return lib, ptxas


def occupancy(lib, k):
    try:
        fn = lib.ppc_accumulate_occupancy
    except AttributeError:
        return None
    fn.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    if fn(k, ctypes.byref(threads), ctypes.byref(blocks)) != 0:
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


_UNIT_BODY = """    const float t = fmaf(fabsf(re), 0.5f, fmaf(fabsf(im), 0.5f, 0x1p-126f));
    const float s = __int_as_float((__float_as_int(t) & 0x7f800000) ^ 0x7f800000);
    const float rs = re * s;
    const float is = im * s;
    const float r = rsqrt_approx(fmaf(rs, rs, fmaf(is, is, 0x1p-80f)));
    ur = fmaf(rs, r, ur);
    ui = fmaf(is, r, ui);"""

#: (label, [(text in the source, its replacement), ...]): builds that
#: leave out one part of the work, to see what each part costs. (A build
#: that reads one staged row for every row is no measure of the shared
#: loads: the compiler then hoists the identical trials' work out of the
#: loop.)
DIAGNOSTICS = {
    # only the prologue's stages are copied; the loop computes on them again
    "no_copy": [("if (s + STAGES - 1 < n_stages) issue(", "if (false) issue(")],
    # no barrier at the top of the stage loop
    "no_bar": [("cp_async_wait<STAGES - 2>();\n        __syncthreads();",
                "cp_async_wait<STAGES - 2>();")],
    # the phasor without the exact power-of-two scaling (wrong far from 1)
    "no_scale": [("const float s = __int_as_float((__float_as_int(t) & 0x7f800000) ^ 0x7f800000);",
                  "const float s = 1.f;")],
    # no phasor: the trial's Gram adds into U as it is
    "no_norm": [(_UNIT_BODY, "    ur += re;\n    ui += im;")],
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


def ppc_oracle(spec, n_valid, chunk=32):
    """complex128 ``sum_{n < n_valid} csd_n / |csd_n|`` on the card."""
    n_f, n_c = spec.shape[2], spec.shape[3]
    U = torch.zeros((n_f, n_c, n_c), dtype=torch.complex128, device=spec.device)
    for b0 in range(0, n_valid, chunk):
        s = spec[b0 : min(b0 + chunk, n_valid)].to(torch.complex128)
        cs = torch.matmul(s.permute(0, 2, 3, 1), s.conj().permute(0, 2, 1, 3))
        mag = cs.abs()
        U += torch.where(mag > 0, cs / torch.where(mag > 0, mag, 1.0), 0).sum(dim=0)
    return U


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent commit's ppc_accumulate.cu")
    ap.add_argument("--variant", action="append", default=[], help="NAME=VALUE[,NAME=VALUE]")
    ap.add_argument("--diagnostics", action="store_true",
                    help="also time builds of the current source that leave out one part of "
                         "the work (see DIAGNOSTICS)")
    ap.add_argument("--k-values", default="",
                    help="comma-separated taper counts at which to time every build as well")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ppc_kernel_ab: no CUDA device available", file=sys.stderr)
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
    diagnostic = set()
    if args.diagnostics:
        for label, text in diagnostic_sources(base).items():
            sources[label] = text
            diagnostic.add(label)
    k_values = [int(v) for v in args.k_values.split(",") if v]
    libs = {}
    for label, text in sources.items():
        safe_label = re.sub(r"[^A-Za-z0-9_]+", "_", label)
        libs[label], ptxas = build(safe_label, text)
        print("{}: {}".format(label, " | ".join(ptxas)))
        print("{}: occupancy {}".format(label, {k: occupancy(libs[label], k)
                                                for k in sorted({K, *k_values})}))

    gen = torch.Generator(device="cuda").manual_seed(36)
    spec = torch.randn((N, K, F, C), dtype=torch.complex64, device="cuda", generator=gen)
    spec[NV:] = float("nan")
    out = torch.empty((F, C, C), dtype=torch.complex64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, x, k=K):
        rc = lib.ppc_accumulate_tiled_launch(x.data_ptr(), out.data_ptr(), N, k, F, C, NV, stream)
        if rc != 0:
            raise RuntimeError("launch failed: cudaError {}".format(rc))

    result = {"device": torch.cuda.get_device_name(0), "power": smi.stdout.strip()}
    for scale in SCALES:
        x = spec if scale == 1.0 else spec * scale
        want = ppc_oracle(x, NV)
        for label, lib in libs.items():
            launch(lib, x)
            first = out.clone()
            launch(lib, x)
            torch.cuda.synchronize()
            err = ((out.to(torch.complex128) - want).abs().max() / NV).item()
            herm = bool(torch.equal(out, out.transpose(1, 2).conj()))
            diag = torch.diagonal(out, dim1=-2, dim2=-1)
            diag_ok = bool((diag.real - NV).abs().max() < 1e-3) and not bool(diag.imag.any())
            same = torch.equal(first, out)
            print("{} at scale {:g}: err/n {:.3e}, exactly Hermitian {}, diagonal n_valid + 0j "
                  "{}, two launches bitwise equal {}".format(label, scale, err, herm, diag_ok, same))
            result["{} err/n at {:g}".format(label, scale)] = err
            enforced = label not in diagnostic and (label != "parent" or scale == 1.0)
            if enforced and not (err < TOL and herm and diag_ok and same):
                raise AssertionError("{} fails the oracle or determinism check at scale {:g}".format(
                    label, scale))
        del want
        if x is not spec:
            del x
        torch.cuda.empty_cache()

    order = list(libs) + list(reversed(libs))
    samples = {label: [] for label in libs}
    for _ in range(args.rounds):
        for label in order:
            samples[label].append(cuda_ms(lambda: launch(libs[label], spec)))
    for label, ms in samples.items():
        print("{}: median {:.4f} ms of {} medians ({})".format(
            label, statistics.median(ms), len(ms), ", ".join("{:.4f}".format(t) for t in ms)))
        result[label] = statistics.median(ms)
    for k in k_values:
        x = torch.randn((N, k, F, C), dtype=torch.complex64, device="cuda", generator=gen)
        for label, lib in libs.items():
            ms = cuda_ms(lambda: launch(lib, x, k))
            print("{} at K = {}: {:.4f} ms".format(label, k, ms))
            result["{} K={}".format(label, k)] = ms
        del x
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
