#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Run the PyTorch port (syncopy_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA card must be present; prints its name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit`` reports them;
2. build: compiles the two CUDA libraries from csrc/ (three kernels) in
   parallel, one nvcc each, and prints the seconds of each;
3. kernel: csd_accumulate_tiled on the card against its plain PyTorch
   version and a complex128 oracle at seven shapes, incl. NaN padding
   rows, n_valid = 0, n_valid ending inside a staging stage and odd C
   (33, 70); two launches bitwise equal; times kernel, plain version and
   the library call (one complex64 einsum) at the bench shape;
4. kernel: csd_accumulate (untiled, (F, N, C) float32 planes) against its
   plain version and a complex128 oracle at six shapes, incl. odd C;
   two launches bitwise equal; kernel, plain version and the library
   call (one complex matmul) timed at (501, 3000, 64);
5. kernel: ppc_accumulate_tiled against its plain version and a
   complex128 oracle at eleven shapes, incl. NaN padding trials,
   n_valid = 0, K = 1, 4, 5 and 9 (the run-time-K instance), C = 33, 70
   and 128, and at spectrum scales 1e-13 and 1e10 (where the unit phasor
   must stay exact); timed at the bench chunk (1024, 3, 501, 64);
6. coh main path: connectivityanalysis(method="coh", tapsmofrq=2) on 1000
   trials x 64 channels x 1000 samples at 1 kHz (float32, seed 0),
   checked against a float64 computation of the same math, then timed;
7. ppc main path: connectivityanalysis(method="ppc", tapsmofrq=2) on the
   same data, checked against a float64 computation, then timed; then
   once more on the data x 1e-13 (MEG in tesla), checked against the
   float64 PPC of that data.

Each main path runs with the launch counters set to 0 just before it and
read just after. The line before the last is a JSON object with each
kernel's launches (csd_accumulate is on no path of the port: the JAX
package calls it only from its Pallas probe), error, times and bound (the
least time the card could take: operations over the FP32 peak against
bytes over the HBM rate, from this run's shapes); the last line is
``{"ok": true, "device": {...}}``. TF32 stays off throughout, asserted.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: bar for the kernel and its plain version: max|got - oracle| / max|oracle|
KERNEL_REL_TOL = 1e-5
#: bar for coherence against the float64 computation (absolute)
COH_ABS_TOL = 1e-5
#: bar for the PPC resultant: max|got - oracle| / max(n_valid, 1); U sums
#: n_valid unit phasors
PPC_KERNEL_TOL = 1e-5
#: bar for PPC against the float64 computation (absolute)
PPC_ABS_TOL = 1e-5

N_TRIALS, N_SAMPLES, N_CHANNELS, FS = 1000, 1000, 64, 1000.0

#: the H100 SXM's published peaks: FP32 outside the tensor cores, HBM
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak
    and bytes (each input read once, each output written once) over the
    HBM rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def csd_bound(F, n, C):
    """The CSD kernels' bound: the upper triangle's 8 FP32 operations per
    (row, f, i <= j) against n complex64 rows in and (F, C, C) complex64
    out."""
    return bound(8 * F * n * C * (C + 1) / 2, F * n * C * 8 + F * C * C * 8)


def ppc_bound(F, n, K, C):
    """The PPC kernel's bound: per (trial, f, i <= j) term ~(8K + 6) FP32
    operations (the K-taper Gram, 8K; magnitude, IEEE sqrt and reciprocal,
    the scaled phasor into U, ~6: 30 at K = 3) against n * K complex64
    rows in and (F, C, C) complex64 out."""
    return bound((8 * K + 6) * F * n * C * (C + 1) / 2, F * n * K * C * 8 + F * C * C * 8)


def check_deterministic(name, fn):
    """Two launches of a kernel on one input must be bitwise equal."""
    import torch

    first, second = fn(), fn()
    torch.cuda.synchronize()
    if isinstance(first, tuple):
        same = all(torch.equal(a, b) for a, b in zip(first, second))
    else:
        same = torch.equal(first, second)
    if not same:
        raise AssertionError("{}: two launches differ".format(name))
    print("{}: two launches bitwise equal".format(name))


def cuda_ms(fn, reps=20, warmup=2):
    """Median milliseconds of `fn` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def csd_oracle(spec, n_valid):
    """complex128 ``sum_{n < n_valid} s[n,f,i] conj(s[n,f,j])`` on the card."""
    import torch

    rows = spec[:n_valid].to(torch.complex128).permute(1, 0, 2)  # (F, n, C)
    return torch.matmul(rows.transpose(1, 2), rows.conj())


def check_kernel(ck, N, F, C, n_valid, nan_rows, seed):
    """One kernel case; returns (max_abs_err, spec) or raises."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    spec = torch.randn((N, F, C), dtype=torch.complex64, device="cuda", generator=gen)
    if nan_rows:
        spec[n_valid:] = float("nan")
    got = ck.csd_accumulate_tiled(spec, n_valid)
    plain = ck.csd_accumulate_tiled_plain(spec, n_valid)
    torch.cuda.synchronize()
    want = csd_oracle(spec, n_valid)
    name = "(N, F, C, n_valid) = ({}, {}, {}, {}){}".format(
        N, F, C, n_valid, " NaN rows" if nan_rows else "")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output not finite at " + name)
    if n_valid == 0:
        if not bool((got == 0).all()):
            raise AssertionError("n_valid = 0 must give exact zeros")
        print("kernel {}: exact zeros".format(name))
        return 0.0, spec
    scale = want.abs().max().item()
    err = (got.to(torch.complex128) - want).abs().max().item()
    plain_err = (plain.to(torch.complex128) - want).abs().max().item()
    herm = (got - got.transpose(1, 2).conj()).abs().max().item()
    print("kernel {}: rel err {:.3e}, plain rel err {:.3e}, hermitian defect {:.3e}".format(
        name, err / scale, plain_err / scale, herm))
    if not err / scale < KERNEL_REL_TOL:
        raise AssertionError("kernel rel err {:.3e} >= {}".format(err / scale, KERNEL_REL_TOL))
    if not plain_err / scale < KERNEL_REL_TOL:
        raise AssertionError("plain rel err {:.3e} >= {}".format(plain_err / scale, KERNEL_REL_TOL))
    if herm != 0.0:
        raise AssertionError("kernel output not exactly Hermitian")
    return err, spec


def check_untiled(ck, F, N, C, seed):
    """One csd_accumulate case; returns (max_abs_err, re, im) or raises."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    re = torch.randn((F, N, C), device="cuda", generator=gen)
    im = torch.randn((F, N, C), device="cuda", generator=gen)
    got_re, got_im = ck.csd_accumulate(re, im)
    plain_re, plain_im = ck.csd_accumulate_plain(re, im)
    torch.cuda.synchronize()
    got, plain = torch.complex(got_re, got_im), torch.complex(plain_re, plain_im)
    rows = torch.complex(re.double(), im.double())  # (F, N, C)
    want = torch.matmul(rows.transpose(1, 2), rows.conj())
    scale = want.abs().max().item()
    err = (got.to(torch.complex128) - want).abs().max().item()
    plain_err = (plain.to(torch.complex128) - want).abs().max().item()
    herm = (got - got.transpose(1, 2).conj()).abs().max().item()
    print("untiled (F, N, C) = ({}, {}, {}): rel err {:.3e}, plain rel err {:.3e}, "
          "hermitian defect {:.3e}".format(F, N, C, err / scale, plain_err / scale, herm))
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("untiled kernel output not finite")
    if not err / scale < KERNEL_REL_TOL:
        raise AssertionError("untiled rel err {:.3e} >= {}".format(err / scale, KERNEL_REL_TOL))
    if not plain_err / scale < KERNEL_REL_TOL:
        raise AssertionError("untiled plain rel err {:.3e} >= {}".format(
            plain_err / scale, KERNEL_REL_TOL))
    if herm != 0.0:
        raise AssertionError("untiled kernel output not exactly Hermitian")
    return err, re, im


def ppc_oracle(spec, n_valid, chunk=32):
    """complex128 resultant of unit per-trial CSDs on the card, in trial
    chunks: ``sum_{n < n_valid} csd_n / |csd_n|``."""
    import torch

    N, K, F, C = spec.shape
    U = torch.zeros((F, C, C), dtype=torch.complex128, device=spec.device)
    for b0 in range(0, n_valid, chunk):
        s = spec[b0 : min(b0 + chunk, n_valid)].to(torch.complex128)
        cs = torch.matmul(s.permute(0, 2, 3, 1), s.conj().permute(0, 2, 1, 3))
        mag = cs.abs()
        U += torch.where(mag > 0, cs / torch.where(mag > 0, mag, 1.0), 0).sum(dim=0)
    return U


def check_ppc(pk, N, K, F, C, n_valid, nan_trials, seed, scale=1.0):
    """One ppc_accumulate_tiled case on a spectrum of standard normal
    values times `scale`; returns (max_abs_err, spec) or raises."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    spec = torch.randn((N, K, F, C), dtype=torch.complex64, device="cuda", generator=gen)
    if scale != 1.0:
        spec *= scale
    if nan_trials:
        spec[n_valid:] = float("nan")
    got = pk.ppc_accumulate_tiled(spec, n_valid)
    plain = pk.ppc_accumulate_tiled_plain(spec, n_valid)
    torch.cuda.synchronize()
    name = "(N, K, F, C, n_valid) = ({}, {}, {}, {}, {}){}{}".format(
        N, K, F, C, n_valid, " NaN trials" if nan_trials else "",
        "" if scale == 1.0 else " x {:g}".format(scale))
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("ppc kernel output not finite at " + name)
    if n_valid == 0:
        if not bool((got == 0).all()):
            raise AssertionError("ppc n_valid = 0 must give exact zeros")
        print("ppc {}: exact zeros".format(name))
        return 0.0, spec
    want = ppc_oracle(spec, n_valid)
    err = (got.to(torch.complex128) - want).abs().max().item()
    plain_err = (plain.to(torch.complex128) - want).abs().max().item()
    herm = (got - got.transpose(1, 2).conj()).abs().max().item()
    diag = torch.diagonal(got, dim1=-2, dim2=-1)
    diag_err = (diag.real - n_valid).abs().max().item()
    diag_im = diag.imag.abs().max().item()
    print("ppc {}: err/n {:.3e}, plain err/n {:.3e}, diagonal - n {:.3e}, diagonal imag "
          "{:.1e}, hermitian defect {:.3e}".format(
              name, err / n_valid, plain_err / n_valid, diag_err, diag_im, herm))
    if not err / n_valid < PPC_KERNEL_TOL:
        raise AssertionError("ppc err/n {:.3e} >= {}".format(err / n_valid, PPC_KERNEL_TOL))
    if not plain_err / n_valid < PPC_KERNEL_TOL:
        raise AssertionError("ppc plain err/n {:.3e} >= {}".format(
            plain_err / n_valid, PPC_KERNEL_TOL))
    if not diag_err < 1e-3 or diag_im != 0.0:
        raise AssertionError("ppc diagonal must be n_valid + 0j")
    if herm != 0.0:
        raise AssertionError("ppc kernel output not exactly Hermitian")
    return err, spec


def ppc_f64(data, taper, taper_opt, chunk=25):
    """Float64 PPC of the same math on the card, in trial chunks: demean,
    the port's taper bank, rfft, per-trial Gram over tapers, unit phasor,
    sum over trials, (|U|^2 - n) / (n (n - 1))."""
    import torch

    from syncopy_tpu_torch.ops.windows import make_tapers

    x_all = torch.from_numpy(data).to("cuda").reshape(N_TRIALS, N_SAMPLES, N_CHANNELS)
    tapers = torch.from_numpy(
        make_tapers(taper, taper_opt, N_SAMPLES, N_SAMPLES, FS)).to("cuda", torch.float64)
    U = torch.zeros((N_SAMPLES // 2 + 1, N_CHANNELS, N_CHANNELS), dtype=torch.complex128,
                    device="cuda")
    for b0 in range(0, N_TRIALS, chunk):
        x = x_all[b0 : b0 + chunk].double()
        x = x - x.mean(dim=1, keepdim=True)
        spec = torch.fft.rfft(tapers[None, :, :, None] * x[:, None], n=N_SAMPLES, dim=2)
        cs = torch.matmul(spec.permute(0, 2, 3, 1), spec.conj().permute(0, 2, 1, 3))
        mag = cs.abs()
        U += torch.where(mag > 0, cs / torch.where(mag > 0, mag, 1.0), 0).sum(dim=0)
    n = N_TRIALS
    return ((U.abs() ** 2 - n) / (n * (n - 1))).cpu().numpy()


def coherence_f64(data, taper, taper_opt):
    """Float64 coherence of the same math on the card: demean, the port's
    taper bank, rfft, trial x taper CSD sum, normalization."""
    import torch

    from syncopy_tpu_torch.ops.windows import make_tapers

    x = torch.from_numpy(data).to("cuda", torch.float64).reshape(N_TRIALS, N_SAMPLES, N_CHANNELS)
    x = x - x.mean(dim=1, keepdim=True)
    tapers = torch.from_numpy(
        make_tapers(taper, taper_opt, N_SAMPLES, N_SAMPLES, FS)).to("cuda", torch.float64)
    spec = torch.fft.rfft(tapers[None, :, :, None] * x[:, None], n=N_SAMPLES, dim=2)
    del x
    rows = spec.reshape(-1, spec.shape[2], N_CHANNELS).permute(1, 0, 2)  # (F, BK, C)
    csd = torch.matmul(rows.transpose(1, 2), rows.conj())
    del spec, rows
    diag = torch.diagonal(csd, dim1=-2, dim2=-1).real
    return (csd.abs() / torch.sqrt(diag[:, :, None] * diag[:, None, :])).cpu().numpy()


def main():
    import torch

    # -- 1. device ------------------------------------------------------- #
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    device_name = torch.cuda.get_device_name(0)
    print("torch {} cuda {} on {}".format(torch.__version__, torch.version.cuda, device_name))

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import syncopy_tpu_torch as spt
    spt.set_device("cuda:0")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must stay off for the float32 matmuls")
    from syncopy_tpu_torch.engine.routine import chunk_trials
    from syncopy_tpu_torch.ops import csd_kernels as ck
    from syncopy_tpu_torch.ops import ppc_kernels as pk
    from syncopy_tpu_torch.shared.input_processors import process_taper

    # -- 2. build: one nvcc per library, all started together ------------- #
    def timed_build(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = {name: pool.submit(timed_build, load) for name, load in [
            ("csd_accumulate (tiled + untiled)", ck.load_csd_kernel),
            ("ppc_accumulate", pk.load_ppc_kernel)]}
        builds = {name: fut.result() for name, fut in builds.items()}
    for name, seconds in builds.items():
        print("build {}: {:.2f} s (nvcc, then load)".format(name, seconds))
    print("build, both libraries: {:.2f} s".format(time.perf_counter() - t0))
    for planar, name in [(False, "csd_accumulate_tiled"), (True, "csd_accumulate")]:
        threads, blocks = ck.kernel_occupancy(planar)
        print("{}: {} threads a block, {} blocks ({} warps) resident per SM".format(
            name, threads, blocks, threads * blocks // 32))
    ppc_threads, ppc_blocks = pk.kernel_occupancy(3)
    ppc_warps = ppc_threads * ppc_blocks // 32
    print("ppc_accumulate_tiled (K = 3): {} threads a block, {} blocks ({} warps) resident "
          "per SM".format(ppc_threads, ppc_blocks, ppc_warps))

    # -- 3. kernel against plain version and oracle ----------------------- #
    for seed, (N, F, C, nv, nan_rows) in enumerate([
        (111, 101, 24, 87, False),
        (40, 17, 8, 25, True),
        (3, 2, 4, 3, False),
        (3, 2, 4, 0, False),
        # the staging ring's edges: n_valid inside a 32-row stage and off
        # the 3-stage ring, NaN rows behind it; odd C past one 32-wide tile
        (64, 5, 33, 37, True),
        (320, 3, 70, 301, True),
    ]):
        check_kernel(ck, N, F, C, nv, nan_rows, seed)
    bench_n_valid = N_TRIALS * 3
    bench_err, spec = check_kernel(ck, 3072, 501, N_CHANNELS, bench_n_valid, True, 7)
    check_deterministic("csd_accumulate_tiled at (3072, 501, 64, 3000)",
                        lambda: ck.csd_accumulate_tiled(spec, bench_n_valid))
    kernel_ms = cuda_ms(lambda: ck.csd_accumulate_tiled(spec, bench_n_valid))
    plain_ms = cuda_ms(lambda: ck.csd_accumulate_tiled_plain(spec, bench_n_valid))
    s_valid = spec[:bench_n_valid]
    library_ms = cuda_ms(lambda: torch.einsum("nfi,nfj->fij", s_valid, s_valid.conj()))
    bound_ms, bound_by = csd_bound(501, bench_n_valid, N_CHANNELS)
    print("kernel at (3072, 501, 64, 3000): {:.4f} ms, plain version {:.4f} ms, library "
          "(einsum) {:.4f} ms (median of 20, CUDA events); bound {:.4f} ms ({}), {:.1f}% of "
          "it".format(kernel_ms, plain_ms, library_ms, bound_ms, bound_by,
                      100 * bound_ms / kernel_ms))
    del spec, s_valid
    torch.cuda.empty_cache()

    # -- 4. untiled kernel against plain version and oracle --------------- #
    for seed, (F, N, C) in enumerate([(5, 12, 8), (2, 1, 4), (1, 8, 128), (3, 37, 33),
                                      (2, 301, 70)]):
        check_untiled(ck, F, N, C, 20 + seed)
    untiled_err, re, im = check_untiled(ck, 501, 3000, N_CHANNELS, 26)
    check_deterministic("csd_accumulate at (501, 3000, 64)", lambda: ck.csd_accumulate(re, im))
    untiled_ms = cuda_ms(lambda: ck.csd_accumulate(re, im))
    untiled_plain_ms = cuda_ms(lambda: ck.csd_accumulate_plain(re, im))
    z = torch.complex(re, im)
    untiled_library_ms = cuda_ms(lambda: torch.matmul(z.transpose(1, 2), z.conj()))
    untiled_bound_ms, untiled_bound_by = csd_bound(501, 3000, N_CHANNELS)
    print("untiled kernel at (501, 3000, 64): {:.4f} ms, plain version {:.4f} ms, library "
          "(complex matmul) {:.4f} ms (median of 20, CUDA events); bound {:.4f} ms ({}), "
          "{:.1f}% of it".format(untiled_ms, untiled_plain_ms, untiled_library_ms,
                                 untiled_bound_ms, untiled_bound_by,
                                 100 * untiled_bound_ms / untiled_ms))
    del re, im, z
    torch.cuda.empty_cache()

    # -- 5. PPC kernel against plain version and oracle -------------------- #
    for seed, (N, K, F, C, nv, nan_trials, scale) in enumerate([
        (21, 3, 11, 8, 17, False, 1.0),
        (16, 2, 8, 4, 16, False, 1.0),
        (13, 2, 9, 6, 9, True, 1.0),
        (4, 1, 3, 4, 0, False, 1.0),
        (37, 5, 7, 70, 30, False, 1.0),
        # K = 1 and 4 with n_valid inside a stage, C = 33 and 128, the
        # run-time-K instance (K = 9), and spectra at MEG scale (1e-13,
        # |csd| ~ 1e-26, where the JAX body's squares underflow) and 1e10
        (40, 1, 9, 33, 37, True, 1.0),
        (24, 4, 5, 128, 21, True, 1.0),
        (30, 9, 4, 40, 27, True, 1.0),
        (64, 3, 21, 64, 61, True, 1e-13),
        (64, 3, 21, 64, 61, True, 1e10),
    ]):
        check_ppc(pk, N, K, F, C, nv, nan_trials, 30 + seed, scale)
    check_ppc(pk, 1024, 3, 501, N_CHANNELS, N_TRIALS, True, 36, 1e-13)
    ppc_err, spec = check_ppc(pk, 1024, 3, 501, N_CHANNELS, N_TRIALS, True, 36)
    check_deterministic("ppc_accumulate_tiled at (1024, 3, 501, 64, 1000)",
                        lambda: pk.ppc_accumulate_tiled(spec, N_TRIALS))
    ppc_ms = cuda_ms(lambda: pk.ppc_accumulate_tiled(spec, N_TRIALS))
    ppc_plain_ms = cuda_ms(lambda: pk.ppc_accumulate_tiled_plain(spec, N_TRIALS), reps=5, warmup=1)
    # no single PyTorch call computes the resultant of unit per-trial CSDs
    ppc_bound_ms, ppc_bound_by = ppc_bound(501, N_TRIALS, 3, N_CHANNELS)
    print("ppc kernel at (1024, 3, 501, 64, 1000): {:.4f} ms (median of 20), plain version "
          "{:.4f} ms (median of 5), CUDA events; bound {:.4f} ms ({}), {:.1f}% of it; {} warps "
          "per SM".format(ppc_ms, ppc_plain_ms, ppc_bound_ms, ppc_bound_by,
                          100 * ppc_bound_ms / ppc_ms, ppc_warps))
    del spec
    torch.cuda.empty_cache()

    # -- 6. coh main path ------------------------------------------------- #
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N_TRIALS * N_SAMPLES, N_CHANNELS)).astype("f4")
    trl = np.zeros((N_TRIALS, 3))
    trl[:, 0] = np.arange(N_TRIALS) * N_SAMPLES
    trl[:, 1] = trl[:, 0] + N_SAMPLES
    adata = spt.from_arrays(data, trl, FS)

    ck.csd_accumulate_tiled.launches = 0
    ck.csd_accumulate.launches = 0
    pk.ppc_accumulate_tiled.launches = 0
    coh = spt.connectivityanalysis(adata, method="coh", tapsmofrq=2)
    torch.cuda.synchronize()
    launches = ck.csd_accumulate_tiled.launches
    untiled_launches = ck.csd_accumulate.launches

    n_chunks = -(-N_TRIALS // chunk_trials(N_SAMPLES * N_CHANNELS * 4 * 2, N_TRIALS))
    if launches != n_chunks:
        raise AssertionError("kernel launched {} times for {} chunks".format(launches, n_chunks))
    got = np.asarray(coh.data)
    if got.shape != (1, 501, N_CHANNELS, N_CHANNELS):
        raise AssertionError("coherence shape {}".format(got.shape))
    if not np.isfinite(got).all():
        raise AssertionError("coherence not finite")
    taper, taper_opt = process_taper(
        "hann", None, 2, None, keeptapers=False, foimax=FS / 2, samplerate=FS,
        nSamples=N_SAMPLES, output="pow")
    coh_err = float(np.abs(got[0] - coherence_f64(data, taper, taper_opt)).max())
    print("main path: {} kernel launches for {} chunk(s); taper {} {}; coherence max abs "
          "err vs float64 {:.3e}".format(launches, n_chunks, taper, taper_opt, coh_err))
    if not coh_err < COH_ABS_TOL:
        raise AssertionError("coherence err {:.3e} >= {}".format(coh_err, COH_ABS_TOL))
    torch.cuda.empty_cache()

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        spt.connectivityanalysis(adata, method="coh", tapsmofrq=2)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print("main path warm wall: median {:.4f} s of 5 ({}), {:.1f} trials/s".format(
        wall, ", ".join("{:.4f}".format(w) for w in walls), N_TRIALS / wall))

    # -- 7. ppc main path ------------------------------------------------- #
    ck.csd_accumulate_tiled.launches = 0
    ck.csd_accumulate.launches = 0
    pk.ppc_accumulate_tiled.launches = 0
    ppc = spt.connectivityanalysis(adata, method="ppc", tapsmofrq=2)
    torch.cuda.synchronize()
    ppc_launches = pk.ppc_accumulate_tiled.launches
    untiled_launches += ck.csd_accumulate.launches
    if ppc_launches != n_chunks:
        raise AssertionError("ppc kernel launched {} times for {} chunks".format(
            ppc_launches, n_chunks))
    got = np.asarray(ppc.data)
    if got.shape != (1, 501, N_CHANNELS, N_CHANNELS) or got.dtype != np.float32:
        raise AssertionError("ppc shape {} dtype {}".format(got.shape, got.dtype))
    if not np.isfinite(got).all():
        raise AssertionError("ppc not finite")
    diag_err = float(np.abs(got[0][:, np.arange(N_CHANNELS), np.arange(N_CHANNELS)] - 1).max())
    ppc_abs_err = float(np.abs(got[0] - ppc_f64(data, taper, taper_opt)).max())
    print("ppc main path: {} kernel launches for {} chunk(s); diagonal - 1 {:.3e}; ppc max "
          "abs err vs float64 {:.3e}".format(ppc_launches, n_chunks, diag_err, ppc_abs_err))
    if not diag_err < 1e-5:
        raise AssertionError("ppc diagonal err {:.3e} >= 1e-5".format(diag_err))
    if not ppc_abs_err < PPC_ABS_TOL:
        raise AssertionError("ppc err {:.3e} >= {}".format(ppc_abs_err, PPC_ABS_TOL))
    torch.cuda.empty_cache()

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        spt.connectivityanalysis(adata, method="ppc", tapsmofrq=2)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print("ppc main path warm wall: median {:.4f} s of 5 ({}), {:.1f} trials/s".format(
        wall, ", ".join("{:.4f}".format(w) for w in walls), N_TRIALS / wall))

    # the same call on data in tesla (MEG): PPC is invariant to the scale
    tiny = data * np.float32(1e-13)
    got = np.asarray(spt.connectivityanalysis(
        spt.from_arrays(tiny, trl, FS), method="ppc", tapsmofrq=2).data)
    if not np.isfinite(got).all():
        raise AssertionError("ppc at data scale 1e-13 not finite")
    tiny_err = float(np.abs(got[0] - ppc_f64(tiny, taper, taper_opt)).max())
    print("ppc main path at data scale 1e-13: max abs err vs float64 {:.3e}".format(tiny_err))
    if not tiny_err < PPC_ABS_TOL:
        raise AssertionError("ppc err at data scale 1e-13 {:.3e} >= {}".format(
            tiny_err, PPC_ABS_TOL))
    del tiny

    print(json.dumps({"kernels": [{
        "name": "csd_accumulate_tiled",
        "route": "cuda",
        "source": "syncopy_tpu_torch/csrc/csd_accumulate.cu",
        "replaces": "syncopy_tpu/ops/pallas_kernels.py:140",
        "launches": launches,
        "max_abs_err": bench_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        "name": "csd_accumulate",
        "route": "cuda",
        "source": "syncopy_tpu_torch/csrc/csd_accumulate.cu",
        "replaces": "syncopy_tpu/ops/pallas_kernels.py:43",
        "launches": untiled_launches,
        "max_abs_err": untiled_err,
        "ms": untiled_ms,
        "plain_ms": untiled_plain_ms,
        "bound_ms": untiled_bound_ms,
        "bound_by": untiled_bound_by,
        "library_ms": untiled_library_ms,
    }, {
        "name": "ppc_accumulate_tiled",
        "route": "cuda",
        "source": "syncopy_tpu_torch/csrc/ppc_accumulate.cu",
        "replaces": "syncopy_tpu/ops/pallas_kernels.py:249",
        "launches": ppc_launches,
        "max_abs_err": ppc_err,
        "ms": ppc_ms,
        "plain_ms": ppc_plain_ms,
        "bound_ms": ppc_bound_ms,
        "bound_by": ppc_bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
