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
   then once more on the data x 1e-13 (MEG in tesla), checked against the
   float64 coherence of that data;
7. ppc main path: connectivityanalysis(method="ppc", tapsmofrq=2) on the
   same data, checked against a float64 computation, then timed; then
   once more on the data x 1e-13 (MEG in tesla), checked against the
   float64 PPC of that data;
8. granger main path: connectivityanalysis(method="granger") (hann taper)
   on 1000 trials x 64 channels x 1000 samples of a seeded AR(2) network
   in which channel 1 drives channel 0 (the JAX package's granger_device
   row). It must take the device route (no host fallback, no warning),
   converge with max rel. err < 5e-6, show the drive at the 200 Hz peak
   and match, within 1e-5, the float64 two-sided factorization of its own
   CSD (the JAX package's host path, transcribed into torch on the card).
   Its CSD is held against an independent float64 CSD. Prints the warm
   wall, a stage split, both regularization routes' times, the inverse's
   share of a Wilson step and the peak device memory; then the same at
   128 channels (the Cholesky-bisection route), without the oracle;
9. coh jackknife: connectivityanalysis(method="coh", tapsmofrq=2,
   jackknife=True) on the first 500 trials of phase 6's data, cut from
   1000 to bound the script's time (``--jackknife-trials 1000`` runs the
   north-star shape, whose 1000 x 501 x 64 x 64 complex64 single-trial CSD
   stack, 16.4 GB, goes through the host; 8.2 GB at 500). Checked against
   float64 on the card in trial groups (the CSD sum, the leave-one-out
   coherences and their mean, then the centred second moment): the
   coherence to 1e-5, jack_var relative to its maximum, jack_bias
   absolute;
10. granger jackknife: connectivityanalysis(method="granger",
   jackknife=True) on 200 trials x 16 channels x 1000 samples of phase 8's
   AR(2) network, all 200 replicates (the JAX package's
   granger_jackknife16_device row): the device route, every replicate
   converged with max rel. err < 5e-6, four replicates (and any the
   routine had to factorize again two-sided) within 1e-5 of phase 8's
   two-sided float64 factorization of the same regularized replicate
   CSD, jack_var and jack_bias against float64 numpy from the replicates;
   prints replicates/s;
11. corr: connectivityanalysis(method="corr") on phase 6's data at 64
   channels, checked against a float64 FFT cross-correlation on the card
   to 1e-5; then at 128 channels (BASELINE config #3's width), timed.
12. mtmfft: freqanalysis(method="mtmfft", tapsmofrq=2) on phase 6's data
   (BASELINE config #1 at north-star width): output "pow" with trials
   kept (128 MB out) and averaged, "fourier" with tapers kept (770 MB
   out), each held to a float64 demean, taper and rfft on the card; the
   fourier spectra through connectivityanalysis(method="coh") against
   phase 6's coherence to 1e-5; output "fooof" on the trial average (the
   host fit, timed, its info keys);
13. mtmconvol (500 trials, hann windows of 250 samples at 16 explicit
   times) and welch (1000 trials, 256-sample windows, half overlap), the
   JAX package's mtmconvol_device and welch_device rows, each held to a
   float64 STFT on the card;
14. wavelet (Morlet(6) power at every sample, 30 frequencies from 10 to
   150 Hz, 512 trials) and superlet (15 frequencies from 10 to 100 Hz,
   orders 1 to 5, c_1 = 3, multiplicative, 64 trials), the
   wavelet_tfr_device and superlet_device rows, held on their first 16
   trials to float64 linear convolutions at the exact length (the
   superlet's geometric mean over orders in float64).
Phases 9 to 14 each print their warm wall, peak device memory and peak
host RSS, and the launch counters, which stay at 0 there: these paths
run no CUDA kernel of the port. Phases 12 to 14 also print trials/s, the
bytes read back with their copy time, and a stage split (gather, pad and
upload; compute; readback) replayed with a synchronize after each step.

Each main path runs with the launch counters set to 0 just before it and
read just after. The line before the last is a JSON object with each
kernel's launches (csd_accumulate is on no path of the port: the JAX
package calls it only from its Pallas probe), error, times and bound (the
least time the card could take: operations over the FP32 peak against
bytes over the HBM rate, from this run's shapes); the Granger path
launches none of them. The last line is ``{"ok": true, "device":
{...}}``. TF32 stays off throughout, asserted.

    python3 chip_smoke.py --save-csd DIR

also writes the 64-channel Granger CSD and the port's result there
(``granger_csd64.npz``), for scripts/granger_compare_jax.py;
``--jackknife-trials N`` sets phase 9's trial count.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
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

#: bar for Granger against the float64 factorization of its CSD (absolute)
GRANGER_ABS_TOL = 1e-5
#: bar for the port's Granger CSD against an independent float64 one,
#: relative to its maximum, off the demeaned DC bin (both round to complex64)
GRANGER_CSD_REL_TOL = 1e-6

#: bars for the jackknife against float64: jack_var relative to its
#: maximum, jack_bias absolute
JACK_VAR_REL_TOL = 1e-5
JACK_BIAS_ABS_TOL = 1e-5
#: trials of the coherence jackknife by default (the north star has 1000)
JACK_COH_TRIALS = 500
#: the Granger jackknife's shape (the JAX package's granger_jackknife16_device row)
JACK_GRANGER_TRIALS, JACK_GRANGER_CHANNELS = 200, 16
#: bar for the cross-correlation against a float64 FFT cross-correlation
CORR_ABS_TOL = 1e-5
#: bar for freqanalysis outputs against float64 on the card, relative to
#: the oracle's maximum
SPEC_REL_TOL = 1e-5
#: trials of phase 13's mtmconvol and phase 14's wavelet and superlet (the
#: JAX package's device_bench rows), and of their float64 oracles
STFT_TRIALS, WAVELET_TRIALS, SUPERLET_TRIALS, TF_ORACLE_TRIALS = 500, 512, 64, 16

N_TRIALS, N_SAMPLES, N_CHANNELS, FS = 1000, 1000, 64, 1000.0

#: the Granger network (the JAX package's granger_device row): AR(2)
#: poles, the coupling channel 1 -> channel 0, the numpy seed
AR2_ALPHAS, AR2_COUPLING, AR2_SEED = (0.55, -0.8), 0.25, 7

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


def ar2_network(n_chan, seed=AR2_SEED, n_trials=N_TRIALS):
    """(trials x samples, channels) float32 AR(2) network from numpy, all
    trials at once: x_t = M1 x_{t-1} + a2 x_{t-2} + e_t with M1 = a1 I +
    AdjMat^T and AdjMat[1, 0] the coupling (channel 1 drives channel 0);
    the first two samples are the noise itself."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_trials, N_SAMPLES, n_chan), dtype=np.float32)
    m1t = np.float32(AR2_ALPHAS[0]) * np.eye(n_chan, dtype=np.float32)  # M1^T
    m1t[1, 0] = AR2_COUPLING
    a2 = np.float32(AR2_ALPHAS[1])
    for t in range(2, N_SAMPLES):
        x[:, t] += x[:, t - 1] @ m1t + a2 * x[:, t - 2]
    return x.reshape(-1, n_chan)


def granger_csd_f64(data, n_chan, chunk=100):
    """The Granger CSD computed apart from the port, in float64 on the
    card: demean, the port's Hann taper, demeaned taper, rfft, trial sum of
    the outer products over trials; rounded to complex64 as the port
    rounds its own. Returns complex128 (F, C, C)."""
    import torch

    from syncopy_tpu_torch.ops.windows import make_tapers

    x_all = torch.from_numpy(data).to("cuda").reshape(N_TRIALS, N_SAMPLES, n_chan)
    taper = torch.from_numpy(
        make_tapers("hann", None, N_SAMPLES, N_SAMPLES, FS)[0]).to("cuda", torch.float64)
    csd = torch.zeros((N_SAMPLES // 2 + 1, n_chan, n_chan), dtype=torch.complex128,
                      device="cuda")
    for b0 in range(0, N_TRIALS, chunk):
        x = x_all[b0 : b0 + chunk].double()
        x = taper[None, :, None] * (x - x.mean(dim=1, keepdim=True))
        spec = torch.fft.rfft(x - x.mean(dim=1, keepdim=True), dim=1)  # (b, F, C)
        csd += torch.einsum("bfi,bfj->fij", spec, spec.conj())
    return (csd / N_TRIALS).to(torch.complex64).to(torch.complex128)


def granger_oracle(csd, rtol, n_iter=100, cond_max=1e4, eps_max=1e-1, regularize=True):
    """The port's host float64 path (regularize_csd_host, wilson_sf_host,
    granger_host) transcribed into torch, on the complex128 (F, N, N)
    `csd`'s device: PSD repair and the loading chosen by SVD condition
    numbers (unless `regularize` is False: `csd` is regularized already);
    Wilson on the two-sided spectrum with an LU inverse a step and FFTs
    over all 2F - 2 bins; Eq. 8. Returns (G, converged, err, steps, eps)."""
    import torch

    F, N = csd.shape[0], csd.shape[-1]
    eye = torch.eye(N, dtype=csd.dtype, device=csd.device)
    eps = 0.0
    if regularize:
        lam = torch.linalg.eigvalsh((csd + csd.mH) / 2)
        floor = 1e-6 * lam.abs().amax(dim=1)
        lam_min = lam.amin(dim=1)
        csd = csd + torch.where(lam_min < floor, floor - lam_min, 0.0)[:, None, None] * eye
        if torch.linalg.cond(csd).amax().item() >= cond_max:
            eps = -1.0
            for cand in np.logspace(-10, np.log10(eps_max), 15):
                if torch.linalg.cond(csd + cand * eye).amax().item() < cond_max:
                    eps = float(cand)
                    break
        csd = csd + (eps_max if eps < 0 else eps) * eye

    C = (csd + csd.mH) / 2
    scale = torch.diagonal(C, dim1=1, dim2=2).abs().mean()
    C = C / scale
    full = torch.cat([C, C[1 : F - 1].flip(0).conj()])  # (M, N, N)
    power = torch.diagonal(full, dim1=1, dim2=2).abs().mean(dim=1)
    valid = (power > 1e-9 * power.max())[:, None, None]
    gamma0 = torch.fft.fft(full, dim=0)[0]
    psi0 = torch.linalg.cholesky(((gamma0 + gamma0.mH) / 2).real).mT.to(C.dtype)
    psi = psi0.expand(full.shape[0], N, N).clone()
    U = torch.linalg.cholesky(full)
    n_lag = full.shape[0] // 2
    err, prev_err, converged, steps = float("inf"), float("inf"), False, 0
    for steps in range(1, n_iter + 1):
        g = torch.linalg.inv(psi) @ U
        g = g @ g.mH + eye
        beta = torch.fft.ifft(g, dim=0).real.to(C.dtype)
        beta[0] *= 0.5
        g0 = beta[0].clone()
        beta[n_lag] *= 0.5
        beta[n_lag + 1 :] = 0
        S = torch.triu(g0)
        S = S - S.mH
        psi = psi @ (torch.fft.fft(beta, dim=0) + S)
        psi0 = psi0 @ (g0 + S)
        rel = (full - psi @ psi.mH).abs() / full.abs()
        err = torch.where(valid, rel, 0.0).max().item()
        if err < rtol:
            converged = True
            break
        if err < 1e-2 and prev_err - err < 1e-4 * err:
            break
        prev_err = err
    Sigma = (psi0 @ psi0.mT) * scale
    H = (psi @ torch.linalg.inv(psi0))[:F]

    auto = torch.diagonal(csd, dim1=1, dim2=2).abs()  # (F, N)
    cov = torch.diagonal(Sigma).abs()
    denom = cov[:, None] - Sigma.mT.abs() ** 2 / cov[None, :]
    dpow = auto.mean(dim=1)
    keep = (dpow > 1e-9 * dpow.max())[:, None, None]
    Smat = auto[:, None, :]
    ratio = torch.where(keep, Smat / torch.where(keep, Smat - denom * H.mT.abs() ** 2, 1.0), 1.0)
    return torch.log(ratio), converged, err, steps, eps


def wall_ms(fn, reps=3):
    """Median milliseconds of `fn` by the host clock, synchronized."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def granger_stages(adata, n_chan):
    """The Granger call's steps replayed one by one with a synchronize
    after each: the engine's gather, pad and upload, the float64 CSD
    (detrend + taper, rfft, Gram), the readback and the AV stage's upload,
    regularization, Wilson, the Granger formula. Returns (ms by stage,
    Wilson steps, the averaged complex128 CSD on the card)."""
    import torch

    from syncopy_tpu_torch.connectivity.ST_compRoutines import CrossSpectra
    from syncopy_tpu_torch.ops import connectivity as pc

    def timed(key, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms[key] = ms.get(key, 0.0) + 1e3 * (time.perf_counter() - t0)
        return res

    cr = CrossSpectra(samplerate=FS, nSamples=N_SAMPLES, taper="hann", taper_opt=None,
                      demean_taper=True, polyremoval=0, exact_fft=True)
    cr.initialize(adata, 0, keeptrials=False)
    (shp, positions), = cr.buckets.items()
    chunk = cr._chunk_size(shp, len(positions), 4)
    ms, acc = {}, None
    for c0 in range(0, len(positions), chunk):
        pos = positions[c0 : c0 + chunk]

        def gather():
            batch = cr._gather_batch(adata, pos)
            pad = np.zeros((chunk - len(pos),) + batch.shape[1:], batch.dtype)
            batch = np.concatenate([batch, pad], axis=0)
            return torch.from_numpy(np.ascontiguousarray(batch)).to("cuda")

        dev = timed("host gather, pad, upload", gather)
        tapered, K, nfft = timed("detrend + taper, float64", lambda: cr._tapered_batch(
            dev, cr.cfg, torch.float64))
        valid = torch.arange(tapered.shape[0], device="cuda") < len(pos)
        tapered = timed("detrend + taper, float64",
                        lambda: torch.where(valid[:, None, None, None], tapered, 0.0))
        spec = timed("rfft, float64", lambda: cr._batch_spectra(tapered, nfft, cr.cfg))
        del tapered

        def gram():
            B, _, F, C = spec.shape
            rows = spec.permute(2, 0, 1, 3).reshape(F, B * K, C)
            return (torch.matmul(rows.transpose(1, 2), rows.conj()) / K).to(torch.complex64)

        res = timed("Gram, complex128 matmul", gram)
        del spec
        acc = res if acc is None else acc + res
    host = timed("readback", lambda: (acc / len(positions)).cpu().numpy())
    csd = timed("AV upload", lambda: torch.from_numpy(host).to("cuda", torch.complex128))
    reg = timed("regularization", lambda: pc.regularize_csd(csd, cond_max=1e4, eps_max=1e-1)[0])
    H, Sigma, _, _, steps = timed("Wilson", lambda: pc.wilson_sf(reg, nIter=100, rtol=5e-6))
    timed("Granger formula + readback", lambda: pc.granger(reg, H, Sigma).float().cpu())
    return ms, int(steps), csd


def granger_phase(spt, n_chan, oracle, save_csd=None):
    """The Granger main path at `n_chan` channels: one checked call (counts
    and peak memory), the float64 oracle if `oracle`, timings. Returns
    the printed summary as a dict."""
    import torch

    from syncopy_tpu_torch.connectivity import connectivity_analysis as pca
    from syncopy_tpu_torch.ops import connectivity as pc
    from syncopy_tpu_torch.ops import csd_kernels as ck
    from syncopy_tpu_torch.ops import ppc_kernels as pk

    t0 = time.perf_counter()
    data = ar2_network(n_chan)
    trl = np.zeros((N_TRIALS, 3))
    trl[:, 0] = np.arange(N_TRIALS) * N_SAMPLES
    trl[:, 1] = trl[:, 0] + N_SAMPLES
    adata = spt.from_arrays(data, trl, FS)
    print("granger {} ch: AR(2) network made in {:.2f} s".format(n_chan, time.perf_counter() - t0))

    # the averaged CSD the call factorizes, kept for the oracle
    seen = {}
    granger_stage = pca._granger

    def keep_csd(st_out, *args):
        seen["csd"] = np.asarray(st_out.data)[0]
        return granger_stage(st_out, *args)

    ck.csd_accumulate_tiled.launches = 0
    ck.csd_accumulate.launches = 0
    pk.ppc_accumulate_tiled.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pca._granger = keep_csd
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = spt.connectivityanalysis(adata, method="granger")
            torch.cuda.synchronize()
    finally:
        pca._granger = granger_stage
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = (ck.csd_accumulate_tiled.launches, ck.csd_accumulate.launches,
                pk.ppc_accumulate_tiled.launches)
    if launches != (0, 0, 0):
        raise AssertionError("granger launched kernels {}".format(launches))
    host_route = [str(w.message) for w in caught if "host float64" in str(w.message)
                  or "did NOT converge" in str(w.message)]
    if host_route or "host float64" in out.log:
        raise AssertionError("granger took the host route: {}".format(host_route or out.log))
    info = dict(out.info)
    G = np.asarray(out.data)
    f_peak = int(np.argmin(np.abs(np.asarray(out.freq) - 200.0)))
    print("granger {} ch: info {}; G at {:g} Hz: 1 -> 0 {:.4f}, 0 -> 1 {:.4f}; peak device "
          "memory {:.3f} GB; kernel launches {}".format(
              n_chan, info, out.freq[f_peak], G[0, f_peak, 1, 0], G[0, f_peak, 0, 1],
              peak_gb, launches))
    if G.shape != (1, N_SAMPLES // 2 + 1, n_chan, n_chan) or G.dtype != np.float32:
        raise AssertionError("granger shape {} dtype {}".format(G.shape, G.dtype))
    if not np.isfinite(G).all():
        raise AssertionError("granger not finite")
    if not (info["converged"] is True and info["max rel. err"] < 5e-6):
        raise AssertionError("granger did not converge: {}".format(info))
    if not (G[0, f_peak, 1, 0] > 0.3 and G[0, f_peak, 0, 1] < 0.1):
        raise AssertionError("granger misses the drive 1 -> 0 at the AR peak")
    if save_csd:
        os.makedirs(save_csd, exist_ok=True)
        np.savez(os.path.join(save_csd, "granger_csd{}.npz".format(n_chan)), csd=seen["csd"],
                 G=G[0], **{k.replace(" ", "_").replace(".", ""): v for k, v in info.items()})

    summary = {"info": info, "peak_gb": peak_gb}
    if oracle:
        t0 = time.perf_counter()
        port_csd = torch.from_numpy(seen["csd"]).to("cuda", torch.complex128)
        mine = granger_csd_f64(data, n_chan)
        scale = mine[1:].abs().max().item()
        csd_err = (port_csd[1:] - mine[1:]).abs().max().item() / scale
        dc = max(port_csd[0].abs().max().item(), mine[0].abs().max().item()) / scale
        G_or, conv, err, steps, eps = granger_oracle(port_csd, 5e-6)
        g_err = float(np.abs(G[0] - G_or.cpu().numpy()).max())
        G_tight, conv_t, err_t, steps_t, _ = granger_oracle(port_csd, 1e-9)
        g_tight = float(np.abs(G[0] - G_tight.cpu().numpy()).max())
        G_mine = granger_oracle(mine, 5e-6)[0].cpu().numpy()
        g_mine = np.abs(G[0] - G_mine)
        print("granger {} ch: CSD vs independent float64 CSD: rel err {:.3e} off DC, DC bins "
              "{:.1e} of the maximum (rounding noise); float64 two-sided oracle on the port's "
              "CSD at rtol 5e-6: converged {} in {} steps, err {:.3e}, eps {:g}, G max abs err "
              "{:.3e}; at rtol 1e-9: converged {} in {} steps, err {:.3e}, G differs by {:.3e}; "
              "oracle on the independent CSD: G differs by {:.3e} (DC-adjacent bin {:.3e}, "
              "past 5 Hz {:.3e}); {:.1f} s".format(
                  n_chan, csd_err, dc, conv, steps, err, eps, g_err, conv_t, steps_t, err_t,
                  g_tight, g_mine.max(), g_mine[1].max(), g_mine[6:].max(),
                  time.perf_counter() - t0))
        if not csd_err < GRANGER_CSD_REL_TOL:
            raise AssertionError("granger CSD rel err {:.3e} >= {}".format(
                csd_err, GRANGER_CSD_REL_TOL))
        if not g_err < GRANGER_ABS_TOL:
            raise AssertionError("granger err vs float64 {:.3e} >= {}".format(
                g_err, GRANGER_ABS_TOL))
        summary.update(g_err=g_err, oracle_steps=steps)
        del port_csd, mine
    torch.cuda.empty_cache()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        spt.connectivityanalysis(adata, method="granger")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print("granger {} ch warm wall: median {:.4f} s of 3 ({}), {:.1f} trials/s".format(
        n_chan, wall, ", ".join("{:.4f}".format(w) for w in walls), N_TRIALS / wall))

    ms, steps, csd = granger_stages(adata, n_chan)
    route = "Cholesky bisection" if n_chan >= pc._FAST_REG_MIN_CHAN else "eigvalsh"
    print("granger {} ch stages (ms, synchronized): {}; regularization route {}; Wilson {} "
          "steps, {:.3f} ms a step".format(
              n_chan, ", ".join("{} {:.3f}".format(k, v) for k, v in ms.items()), route, steps,
              ms["Wilson"] / max(steps, 1)))
    routes = {}
    saved = pc._FAST_REG_MIN_CHAN
    try:
        for name, threshold in (("eigvalsh", 10**9), ("Cholesky bisection", 0)):
            pc._FAST_REG_MIN_CHAN = threshold
            eps = float(pc.csd_reg_params(csd, 1e4, 1e-1)[1])
            routes[name] = (wall_ms(lambda: pc.csd_reg_params(csd, 1e4, 1e-1)), eps)
    finally:
        pc._FAST_REG_MIN_CHAN = saved
    psi = pc.regularize_csd(csd, cond_max=1e4, eps_max=1e-1)[0]
    inv_ms = wall_ms(lambda: pc._inv_nan(psi), reps=10)
    print("granger {} ch: regularization parameters by route (median of 3): {}; inv_ex of "
          "({}, {}, {}) complex128 {:.3f} ms, {:.1f}% of a Wilson step".format(
              n_chan, "; ".join("{} {:.3f} ms (eps {:g})".format(k, v[0], v[1])
                                for k, v in routes.items()),
              *psi.shape, inv_ms, 100 * inv_ms / (ms["Wilson"] / max(steps, 1))))
    summary.update(wall=wall, stages=ms, steps=steps, routes=routes, inv_ms=inv_ms)
    del csd, psi
    torch.cuda.empty_cache()
    return summary


def north_star_data(n_chan=N_CHANNELS):
    """Phase 6's data: float32 normal noise from seed 0, 1000 trials x 1000
    samples at 1 kHz; and its trialdefinition."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N_TRIALS * N_SAMPLES, n_chan)).astype("f4")
    trl = np.zeros((N_TRIALS, 3))
    trl[:, 0] = np.arange(N_TRIALS) * N_SAMPLES
    trl[:, 1] = trl[:, 0] + N_SAMPLES
    return data, trl


class HostPeak:
    """The process's peak resident set size over a block, in GB, and what
    was resident when it began (`start_gb`): sampled every 20 ms from
    /proc/self/statm by a thread; where that file cannot be read,
    getrusage's peak since the process started (`since_start`)."""

    def __enter__(self):
        import threading

        self.gb, self.start_gb, self.since_start = 0.0, None, False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        page = os.sysconf("SC_PAGE_SIZE")
        while True:
            try:
                with open("/proc/self/statm") as f:
                    gb = int(f.read().split()[1]) * page / 1e9
                self.gb = max(self.gb, gb)
                if self.start_gb is None:
                    self.start_gb = gb
            except (OSError, ValueError, IndexError):
                self.since_start = True
                return
            if self._stop.wait(0.02):
                return

    def __exit__(self, *exc):
        import resource

        self._stop.set()
        self._thread.join()
        if self.since_start:
            self.gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
        return False


def zero_launches():
    from syncopy_tpu_torch.ops import csd_kernels as ck
    from syncopy_tpu_torch.ops import ppc_kernels as pk

    ck.csd_accumulate_tiled.launches = 0
    ck.csd_accumulate.launches = 0
    pk.ppc_accumulate_tiled.launches = 0


def read_launches(name):
    """The three kernels' launches since zero_launches(): none may have
    run on the paths of phases 9 to 14."""
    from syncopy_tpu_torch.ops import csd_kernels as ck
    from syncopy_tpu_torch.ops import ppc_kernels as pk

    launches = {"csd_accumulate_tiled": ck.csd_accumulate_tiled.launches,
                "csd_accumulate": ck.csd_accumulate.launches,
                "ppc_accumulate_tiled": pk.ppc_accumulate_tiled.launches}
    print("{}: kernel launches {}".format(name, launches))
    if any(launches.values()):
        raise AssertionError("{} launched kernels {}".format(name, launches))


def measured_call(name, fn):
    """One checked call of `fn` with the launch counters at 0, peak device
    memory and peak host RSS reset before it; returns its result and
    (wall s, peak device GB, peak host GB)."""
    import torch

    import gc

    gc.collect()  # what earlier phases left in reference cycles
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with HostPeak() as host:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    read_launches(name)
    dev_gb = torch.cuda.max_memory_allocated() / 1e9
    print("{}: first call {:.3f} s; peak device memory {:.3f} GB; peak host RSS {:.3f} GB{}".format(
        name, wall, dev_gb, host.gb, " (since the process started)" if host.since_start
        else " ({:.3f} GB resident before the call)".format(host.start_gb)))
    return res, (wall, dev_gb, host.gb)


def warm_wall(name, fn, reps=1):
    """Host-clock seconds of `reps` more calls of `fn`, synchronized."""
    import torch

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print("{} warm wall: median {:.4f} s of {} ({})".format(
        name, wall, reps, ", ".join("{:.4f}".format(w) for w in walls)))
    return wall


def coh_jackknife_f64(data, taper, taper_opt, n_trials, group=50):
    """The coherence jackknife of the same math in float64 on the card, in
    trial groups: the trial x taper CSD sum S; then each trial's
    leave-one-out coherence of (S - csd_k) / (n - 1), summed into their
    mean; then their centred second moment. Returns (direct coherence,
    jack_var, jack_bias) as float64 numpy (F, C, C)."""
    import torch

    from syncopy_tpu_torch.ops.windows import make_tapers

    x_all = torch.from_numpy(data).to("cuda").reshape(n_trials, N_SAMPLES, -1)
    tapers = torch.from_numpy(
        make_tapers(taper, taper_opt, N_SAMPLES, N_SAMPLES, FS)).to("cuda", torch.float64)

    def csds(b0):
        x = x_all[b0 : b0 + group].double()
        x = x - x.mean(dim=1, keepdim=True)
        spec = torch.fft.rfft(tapers[None, :, :, None] * x[:, None], n=N_SAMPLES, dim=2)
        rows = spec.transpose(1, 2)  # (b, F, K, C)
        return torch.matmul(rows.transpose(2, 3), rows.conj()) / tapers.shape[0]

    def coherence(c):
        root = torch.sqrt(torch.diagonal(c, dim1=-2, dim2=-1).real)
        return c.abs() / (root[..., :, None] * root[..., None, :])

    starts = range(0, n_trials, group)
    S = sum(csds(b0).sum(dim=0) for b0 in starts)
    n = n_trials
    mean = sum(coherence((S - csds(b0)) / (n - 1)).sum(dim=0) for b0 in starts) / n
    m2 = sum(((coherence((S - csds(b0)) / (n - 1)) - mean) ** 2).sum(dim=0) for b0 in starts)
    direct = coherence(S)
    return (direct.cpu().numpy(), ((n - 1) * m2).cpu().numpy(),
            ((n - 1) * (mean - direct)).cpu().numpy())


def coh_jackknife_phase(spt, taper, taper_opt, n_trials=JACK_COH_TRIALS):
    """Phase 9: coherence with jackknife error bars at the north-star
    shape, against float64 on the card; then a warm call."""
    import torch

    data, trl = north_star_data()
    data, trl = data[: n_trials * N_SAMPLES], trl[:n_trials]
    adata = spt.from_arrays(data, trl, FS)
    out, (first, dev_gb, host_gb) = measured_call("coh jackknife", lambda: spt.connectivityanalysis(
        adata, method="coh", tapsmofrq=2, jackknife=True))
    got = np.asarray(out.data)
    var = np.asarray(out._get_extra_dataset("jack_var"))
    bias = np.asarray(out._get_extra_dataset("jack_bias"))
    shape = (1, N_SAMPLES // 2 + 1, N_CHANNELS, N_CHANNELS)
    for name, arr in (("coherence", got), ("jack_var", var), ("jack_bias", bias)):
        if arr.shape != shape or arr.dtype != np.float32 or not np.isfinite(arr).all():
            raise AssertionError("coh jackknife {}: shape {} dtype {} or not finite".format(
                name, arr.shape, arr.dtype))
    del out
    t0 = time.perf_counter()
    direct, var64, bias64 = coh_jackknife_f64(data, taper, taper_opt, n_trials)
    torch.cuda.empty_cache()
    coh_err = float(np.abs(got[0] - direct).max())
    var_err = float(np.abs(var[0] - var64).max() / np.abs(var64).max())
    bias_err = float(np.abs(bias[0] - bias64).max())
    print("coh jackknife, {} trials: against float64 ({:.1f} s): coherence max abs err {:.3e}; "
          "jack_var max err {:.3e} of its maximum {:.4e}; jack_bias max abs err {:.3e} (max "
          "|bias| {:.4e})".format(n_trials, time.perf_counter() - t0, coh_err, var_err,
                                  float(np.abs(var64).max()), bias_err,
                                  float(np.abs(bias64).max())))
    if not coh_err < COH_ABS_TOL:
        raise AssertionError("coh jackknife coherence err {:.3e} >= {}".format(coh_err, COH_ABS_TOL))
    if not var_err < JACK_VAR_REL_TOL:
        raise AssertionError("jack_var err {:.3e} >= {}".format(var_err, JACK_VAR_REL_TOL))
    if not bias_err < JACK_BIAS_ABS_TOL:
        raise AssertionError("jack_bias err {:.3e} >= {}".format(bias_err, JACK_BIAS_ABS_TOL))
    wall = warm_wall("coh jackknife", lambda: spt.connectivityanalysis(
        adata, method="coh", tapsmofrq=2, jackknife=True))
    torch.cuda.empty_cache()
    return {"trials": n_trials, "first": first, "wall": wall, "peak_device_gb": dev_gb,
            "peak_host_gb": host_gb, "coh_err": coh_err, "var_err": var_err, "bias_err": bias_err}


def granger_jackknife_phase(spt):
    """Phase 10: Granger with jackknife error bars on phase 8's AR(2)
    network at the JAX package's granger_jackknife16_device shape."""
    import torch

    from syncopy_tpu_torch.connectivity import connectivity_analysis as pca
    from syncopy_tpu_torch.ops import connectivity as pc
    from syncopy_tpu_torch.statistics import jackknifing as jk

    n_trials, n_chan = JACK_GRANGER_TRIALS, JACK_GRANGER_CHANNELS
    data = ar2_network(n_chan, n_trials=n_trials)
    trl = np.zeros((n_trials, 3))
    trl[:, 0] = np.arange(n_trials) * N_SAMPLES
    trl[:, 1] = trl[:, 0] + N_SAMPLES
    adata = spt.from_arrays(data, trl, FS)

    # the replicate CSDs and the replicate Granger spectra the call forms
    seen, originals = {}, (jk.trial_avg_replicates, jk.bias_var, pca._attach_jackknife)

    def replicates(ensemble):
        seen["replicates"] = originals[0](ensemble)
        return seen["replicates"]

    def bias_var(direct, jack_rep):
        seen["jack_rep"] = jack_rep
        return originals[1](direct, jack_rep)

    def stage(*args):
        t0 = time.perf_counter()
        originals[2](*args)
        torch.cuda.synchronize()
        seen["stage_s"] = time.perf_counter() - t0

    jk.trial_avg_replicates, jk.bias_var, pca._attach_jackknife = replicates, bias_var, stage
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out, (first, dev_gb, host_gb) = measured_call("granger jackknife", lambda: (
                spt.connectivityanalysis(adata, method="granger", jackknife=True)))
    finally:
        jk.trial_avg_replicates, jk.bias_var, pca._attach_jackknife = originals
    host_route = [str(w.message) for w in caught if "host float64" in str(w.message)
                  or "did NOT converge" in str(w.message) or "singular" in str(w.message)]
    if host_route or "host float64" in out.log or "host float64" in seen["jack_rep"].log:
        raise AssertionError("granger jackknife took the host route: {}".format(host_route))
    rep_info, info = dict(seen["jack_rep"].info), dict(out.info)
    G, G_rep = np.asarray(out.data)[0], np.asarray(seen["jack_rep"].data)
    var = np.asarray(out._get_extra_dataset("jack_var"))[0]
    bias = np.asarray(out._get_extra_dataset("jack_bias"))[0]
    print("granger jackknife, {} trials x {} ch: direct {}; replicates {}; {:.1f} replicates/s in "
          "the replicate stage ({:.3f} s: Granger of the replicates, bias and variance)".format(
              n_trials, n_chan, info, rep_info, n_trials / seen["stage_s"], seen["stage_s"]))
    if G_rep.shape != (n_trials, N_SAMPLES // 2 + 1, n_chan, n_chan) or not np.isfinite(G_rep).all():
        raise AssertionError("granger replicates shape {} or not finite".format(G_rep.shape))
    if not (info["converged"] is True and rep_info["converged"] is True
            and rep_info["max rel. err"] < 5e-6 and info["max rel. err"] < 5e-6):
        raise AssertionError("granger jackknife did not converge: {} {}".format(info, rep_info))

    # four replicates against the two-sided float64 factorization of the
    # same regularized replicate CSD: the regularization of the replicates'
    # mean, shared, and the Cholesky top-up, as the port applies them
    reps = torch.from_numpy(np.asarray(seen["replicates"].data)).to("cuda", torch.complex128)
    shift, eps, _ = pc.csd_reg_params(reps.mean(dim=0), cond_max=1e4, eps_max=1e-1)
    regs = pc.psd_topup(pc.apply_csd_reg(reps, shift, eps, eps_max=1e-1))
    # the replicates that the routine's one-sided iteration leaves
    # unconverged, which it factorizes again two-sided: held too
    retried = (~pc.wilson_sf(regs, nIter=100, rtol=5e-6)[2]).nonzero().ravel().tolist()
    print("granger jackknife: replicates the one-sided iteration leaves unconverged (retried "
          "two-sided on the device): {}".format(retried))
    g_err = 0.0
    for k in sorted({0, 67, 133, n_trials - 1, *retried}):
        G_or, conv, err, steps, _ = granger_oracle(regs[k], 5e-6, regularize=False)
        g_err = max(g_err, float(np.abs(G_rep[k] - G_or.cpu().numpy()).max()))
        print("granger replicate {}: float64 oracle converged {} in {} steps, err {:.3e}".format(
            k, conv, steps, err))
    del reps, regs
    torch.cuda.empty_cache()
    rep64 = G_rep.astype(np.float64)
    mean = rep64.mean(axis=0)
    var64 = (n_trials - 1) * ((rep64 - mean) ** 2).sum(axis=0)
    bias64 = (n_trials - 1) * (mean - G.astype(np.float64))
    var_err = float(np.abs(var - var64).max() / np.abs(var64).max())
    bias_err = float(np.abs(bias - bias64).max())
    print("granger jackknife: held replicates max abs err vs float64 {:.3e}; jack_var max err "
          "{:.3e} of its maximum {:.4e}; jack_bias max abs err {:.3e} (max |bias| {:.4e})".format(
              g_err, var_err, float(np.abs(var64).max()), bias_err, float(np.abs(bias64).max())))
    if not g_err < GRANGER_ABS_TOL:
        raise AssertionError("granger replicate err {:.3e} >= {}".format(g_err, GRANGER_ABS_TOL))
    if not var_err < JACK_VAR_REL_TOL:
        raise AssertionError("granger jack_var err {:.3e} >= {}".format(var_err, JACK_VAR_REL_TOL))
    if not bias_err < JACK_BIAS_ABS_TOL:
        raise AssertionError("granger jack_bias err {:.3e} >= {}".format(
            bias_err, JACK_BIAS_ABS_TOL))
    wall = warm_wall("granger jackknife", lambda: spt.connectivityanalysis(
        adata, method="granger", jackknife=True), reps=3)
    print("granger jackknife: {:.1f} replicates/s over the whole warm call".format(n_trials / wall))
    return {"first": first, "wall": wall, "peak_device_gb": dev_gb, "peak_host_gb": host_gb,
            "stage_s": seen["stage_s"], "g_err": g_err, "var_err": var_err,
            "bias_err": bias_err}


def corr_f64(data, n_chan, group=100):
    """The trial-averaged cross-correlation in float64 on the card:
    demeaned trials, the trial sum of their cross spectra at the padded
    length 2^ceil(log2(2T - 1)), one inverse FFT, lags 0 .. T/2 with the
    reference's upper-triangle offset at even T, divided by the overlap,
    normalized by the 0-lag auto-covariances. Returns (nLags, C, C)."""
    import torch

    x_all = torch.from_numpy(data).to("cuda").reshape(N_TRIALS, N_SAMPLES, n_chan)
    L = 1 << int(2 * N_SAMPLES - 1).bit_length()
    S = torch.zeros((L // 2 + 1, n_chan, n_chan), dtype=torch.complex128, device="cuda")
    for b0 in range(0, N_TRIALS, group):
        x = x_all[b0 : b0 + group].double()
        X = torch.fft.rfft(x - x.mean(dim=1, keepdim=True), n=L, dim=1)  # (b, Lf, C)
        S += torch.matmul(X.permute(1, 2, 0), X.conj().permute(1, 0, 2))
    R = torch.fft.irfft(S, n=L, dim=0)
    n_lags = N_SAMPLES // 2 if N_SAMPLES % 2 == 0 else N_SAMPLES // 2 + 1
    delta = 1 - N_SAMPLES % 2
    lower = torch.tril(torch.ones((n_chan, n_chan), dtype=torch.bool, device="cuda"))
    cc = torch.where(lower, R[:n_lags], R[delta : n_lags + delta])
    cc = cc / torch.arange(N_SAMPLES, N_SAMPLES - n_lags, -1, device="cuda")[:, None, None]
    root = torch.sqrt(torch.diagonal(cc[0]))
    return (cc / (root[:, None] * root[None, :])).cpu().numpy()


def corr_phase(spt):
    """Phase 11: cross-correlation at 64 channels against float64 on the
    card, then at 128 channels, timed."""
    import torch

    summary = {}
    for n_chan in (N_CHANNELS, 2 * N_CHANNELS):
        data, trl = north_star_data(n_chan)
        adata = spt.from_arrays(data, trl, FS)
        name = "corr {} ch".format(n_chan)
        out, (first, dev_gb, host_gb) = measured_call(name, lambda: spt.connectivityanalysis(
            adata, method="corr"))
        got = np.asarray(out.data)
        if got.shape != (N_SAMPLES // 2, 1, n_chan, n_chan) or got.dtype != np.float32 \
                or not np.isfinite(got).all():
            raise AssertionError("{} shape {} dtype {} or not finite".format(
                name, got.shape, got.dtype))
        entry = {"first": first, "peak_device_gb": dev_gb, "peak_host_gb": host_gb}
        if n_chan == N_CHANNELS:
            err = float(np.abs(got[:, 0] - corr_f64(data, n_chan)).max())
            print("{}: max abs err vs float64 FFT cross-correlation {:.3e}".format(name, err))
            if not err < CORR_ABS_TOL:
                raise AssertionError("{} err {:.3e} >= {}".format(name, err, CORR_ABS_TOL))
            entry["err"] = err
        entry["wall"] = warm_wall(name, lambda: spt.connectivityanalysis(adata, method="corr"),
                                  reps=5)
        print("{}: {:.1f} trials/s".format(name, N_TRIALS / entry["wall"]))
        summary[n_chan] = entry
        del data, adata, out
        torch.cuda.empty_cache()
    return summary


def captured_call(name, fn):
    """:func:`measured_call` of `fn`, and the compute routine its frontend
    ran (the first one initialized), for the stage split."""
    from syncopy_tpu_torch.engine.routine import ComputationalRoutine

    routines, initialize = [], ComputationalRoutine.initialize

    def keep(self, *args, **kwargs):
        routines.append(self)
        return initialize(self, *args, **kwargs)

    ComputationalRoutine.initialize = keep
    try:
        res, stats = measured_call(name, fn)
    finally:
        ComputationalRoutine.initialize = initialize
    return res, stats, routines[0]


def engine_stages(cr, adata):
    """The engine's steps for the routine `cr` of a finished call replayed
    chunk by chunk, with a synchronize after each: the host gather, pad and
    upload (with the auxiliary inputs), the compute (the routine's
    process_batch, and the trial sum where trials are averaged), and the
    readback to the host. Returns (ms by stage, bytes read back)."""
    import torch

    ms, nbytes, acc = {}, 0, None

    def timed(key, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms[key] = ms.get(key, 0.0) + 1e3 * (time.perf_counter() - t0)
        return res

    itemsize = np.dtype(adata.data.dtype).itemsize
    for shp, positions in cr.buckets.items():
        aux_all = tuple(np.asarray(a) for a in cr.per_trial_inputs(adata, positions))
        aux_bytes = sum(int(np.prod(a.shape[1:])) * a.itemsize for a in aux_all)
        chunk = cr._chunk_size(shp, len(positions), itemsize, aux_bytes)
        for c0 in range(0, len(positions), chunk):
            pos = positions[c0 : c0 + chunk]

            def upload():
                batch = cr._gather_batch(adata, pos)
                pad = np.zeros((chunk - len(pos),) + batch.shape[1:], batch.dtype)
                dev = torch.from_numpy(np.ascontiguousarray(
                    np.concatenate([batch, pad], axis=0))).to("cuda")
                return dev[: len(pos)], [cr._upload_aux(a, c0, len(pos), len(pos))
                                         for a in aux_all]

            dev, aux = timed("gather, pad and upload", upload)
            res = timed("compute", lambda: cr.process_batch(dev, *aux, **cr.cfg))
            if cr.keeptrials:
                nbytes += res.numel() * res.element_size()
                timed("readback", lambda: res.cpu())
            else:
                part = timed("compute", lambda: res.sum(dim=0))
                acc = part if acc is None else acc + part
            del dev, res
    if acc is not None:
        nbytes += acc.numel() * acc.element_size()
        timed("readback", lambda: (acc / cr.numTrials).cpu())
    return ms, nbytes


def spectral_case(name, adata, n_trials, call, check, reps=3):
    """One freqanalysis configuration on the card: a first call with the
    launch counters at 0 and the peak memory read, `check(out)` (which
    returns the error against the float64 oracle and raises past its
    bar), the warm wall over `reps` calls and the stage split."""
    import torch

    out, (first, dev_gb, host_gb), cr = captured_call(name, call)
    err = check(out)
    del out
    wall = warm_wall(name, call, reps)
    print("{}: {:.1f} trials/s".format(name, n_trials / wall))
    ms, nbytes = engine_stages(cr, adata)
    print("{} stages (ms, synchronized): {}; {:.3f} GB read back in {:.3f} ms ({:.2f} GB/s)".format(
        name, ", ".join("{} {:.3f}".format(k, v) for k, v in ms.items()), nbytes / 1e9,
        ms["readback"], nbytes / 1e6 / ms["readback"]))
    torch.cuda.empty_cache()
    return {"first": first, "wall": wall, "trials_per_s": n_trials / wall, "err": err,
            "peak_device_gb": dev_gb, "peak_host_gb": host_gb, "stages": ms,
            "readback_gb": nbytes / 1e9}


def held(name, err, tol=SPEC_REL_TOL):
    """Print a relative error against float64 and raise past `tol`."""
    print("{}: max err vs float64 {:.3e} of the oracle's maximum".format(name, err))
    if not err < tol:
        raise AssertionError("{} err {:.3e} >= {}".format(name, err, tol))
    return err


def chunked_rel_err(pairs):
    """max|got - want| / max|want| over (got, want) chunk pairs, float64."""
    err = scale = 0.0
    for got, want in pairs:
        err = max(err, float((got.to(want.dtype) - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
    return err / scale


def mtmfft_f64(x, tapers):
    """Float64 demean, taper bank and rfft of a (B, T, C) batch on the
    card: (B, K, F, C) complex128."""
    import torch

    x = x.double()
    x = x - x.mean(dim=1, keepdim=True)
    return torch.fft.rfft(tapers[None, :, :, None] * x[:, None], dim=2)


def mtmfft_phase(spt, data, trl, taper, taper_opt, coh_direct):
    """Phase 12: mtmfft at the north-star shape (BASELINE config #1), each
    output held to a float64 rfft on the card; the fourier spectra through
    connectivityanalysis against phase 6's coherence; FOOOF on the trial
    average."""
    import torch

    from syncopy_tpu_torch.ops.windows import make_tapers

    adata = spt.from_arrays(data, trl, FS)
    x_all = torch.from_numpy(data).to("cuda").reshape(N_TRIALS, N_SAMPLES, N_CHANNELS)
    tapers = torch.from_numpy(
        make_tapers(taper, taper_opt, N_SAMPLES, N_SAMPLES, FS)).to("cuda", torch.float64)
    group = 100

    def spectra(b0):
        return mtmfft_f64(x_all[b0 : b0 + group], tapers)

    def check_pow(out):
        got = torch.from_numpy(np.asarray(out.data)).to("cuda")  # (trials, 1, F, C)
        return held("mtmfft pow", chunked_rel_err(
            (got[b0 : b0 + group, 0], (spectra(b0).abs() ** 2).mean(dim=1))
            for b0 in range(0, N_TRIALS, group)))

    def check_avg(out):
        want = sum((spectra(b0).abs() ** 2).mean(dim=1).sum(dim=0)
                   for b0 in range(0, N_TRIALS, group)) / N_TRIALS
        got = torch.from_numpy(np.asarray(out.data)[0, 0]).to("cuda")
        return held("mtmfft pow, trial average", chunked_rel_err([(got, want)]))

    kept = {}

    def check_fourier(out):
        kept["spec"] = out
        got = np.asarray(out.data)
        return held("mtmfft fourier", chunked_rel_err(
            (torch.from_numpy(got[b0 : b0 + group]).to("cuda"), spectra(b0))
            for b0 in range(0, N_TRIALS, group)))

    kw = dict(method="mtmfft", tapsmofrq=2)
    summary = {
        "pow": spectral_case("mtmfft pow", adata, N_TRIALS, lambda: spt.freqanalysis(
            adata, output="pow", **kw), check_pow),
        "pow_avg": spectral_case("mtmfft pow, keeptrials=False", adata, N_TRIALS,
                                 lambda: spt.freqanalysis(adata, keeptrials=False, **kw),
                                 check_avg),
        "fourier": spectral_case("mtmfft fourier", adata, N_TRIALS, lambda: spt.freqanalysis(
            adata, output="fourier", keeptapers=True, **kw), check_fourier, reps=2),
    }
    spec = kept.pop("spec")
    coh, _ = measured_call("coh of the port's fourier spectra", lambda: (
        spt.connectivityanalysis(spec, method="coh")))
    chain_err = float(np.abs(np.asarray(coh.data)[0] - coh_direct).max())
    print("coh of the port's fourier spectra against phase 6's coherence of the same data: max "
          "abs err {:.3e}".format(chain_err))
    if not chain_err < COH_ABS_TOL:
        raise AssertionError("chained coherence err {:.3e} >= {}".format(chain_err, COH_ABS_TOL))
    summary["chain_err"] = chain_err
    del spec, coh, x_all
    torch.cuda.empty_cache()

    fooof, (wall, _, _) = measured_call("mtmfft fooof", lambda: spt.freqanalysis(
        adata, output="fooof", keeptrials=False, foilim=[1, 100], **kw))
    peaks = fooof.info["fooof_n_peaks"]
    print("mtmfft fooof on the trial average (host fit, {} channels x {} bins): {:.3f} s; info "
          "keys {}; peaks per channel {}-{}".format(
              N_CHANNELS, len(fooof.freq), wall, sorted(fooof.info), min(peaks), max(peaks)))
    if not np.isfinite(np.asarray(fooof.data)).all() or len(peaks) != N_CHANNELS:
        raise AssertionError("fooof result not finite or not one fit per channel")
    summary["fooof_wall"] = wall
    return summary


def stft_pow_f64(x, starts, nperseg, taper):
    """Float64 STFT power of a (B, T, C) batch on the card: window k holds
    trial samples [starts[k], starts[k] + nperseg), zero past both edges,
    demeaned, tapered, rfft; (B, nWindows, F, C)."""
    import torch

    xp = torch.nn.functional.pad(x.double().transpose(1, 2), (nperseg, nperseg))
    idx = torch.as_tensor(starts, device=x.device)[:, None] + nperseg + torch.arange(
        nperseg, device=x.device)
    frames = xp[:, :, idx]  # (B, C, W, nperseg)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    return (torch.fft.rfft(frames * taper, dim=-1).abs() ** 2).permute(0, 2, 3, 1)


def stft_phase(spt, data, trl):
    """Phase 13: mtmconvol on 500 trials at 16 explicit windows and welch
    on 1000 trials (BASELINE config #2; the JAX package's
    mtmconvol_device and welch_device rows), each held to a float64 STFT
    on the card."""
    import torch

    from syncopy_tpu_torch.ops.windows import make_tapers

    summary, group = {}, 100
    for name, n_trials, kw in (
            ("mtmconvol", STFT_TRIALS, dict(method="mtmconvol", t_ftimwin=0.25,
                                            toi=np.arange(0.125, 0.876, 0.05))),
            ("welch", N_TRIALS, dict(method="welch", t_ftimwin=0.256, toi=0.5))):
        adata = spt.from_arrays(data[: n_trials * N_SAMPLES], trl[:n_trials], FS)
        nperseg = int(kw["t_ftimwin"] * FS)
        if name == "mtmconvol":
            centres = np.round(kw["toi"] * FS).astype(int)
        else:
            hop = nperseg - min(nperseg - 1, int(kw["toi"] * nperseg))
            centres = np.arange(0, N_SAMPLES, hop)
        starts = centres - nperseg // 2
        x_all = torch.from_numpy(data[: n_trials * N_SAMPLES]).to("cuda").reshape(
            n_trials, N_SAMPLES, N_CHANNELS)
        taper = torch.from_numpy(make_tapers("hann", None, nperseg, nperseg, FS)[0]).to(
            "cuda", torch.float64)

        def check(out, name=name, n_trials=n_trials):
            got = torch.from_numpy(np.asarray(out.data)).to("cuda")
            got = got[:, 0].reshape((n_trials, -1) + got.shape[2:])  # (trials, W, F, C)
            pairs = []
            for b0 in range(0, n_trials, group):
                want = stft_pow_f64(x_all[b0 : b0 + group], starts, nperseg, taper)
                if name == "welch":
                    want = want.mean(dim=1, keepdim=True)
                pairs.append((got[b0 : b0 + group], want))
            return held(name, chunked_rel_err(pairs))

        summary[name] = spectral_case(name, adata, n_trials, lambda: spt.freqanalysis(
            adata, **kw), check)
        del x_all
        torch.cuda.empty_cache()
    return summary


def wavelet_f64(x, kernels):
    """Float64 'same'-mode linear convolution of a (B, T, C) batch with
    each sampled kernel, at the exact length T + K - 1 (no bucketing, no
    power-of-two padding): (len(kernels), B, T, C) complex128."""
    import torch

    x = x.double()
    x = x - x.mean(dim=1, keepdim=True)
    T, out = x.shape[1], []
    for kern in kernels:
        K = kern.size
        n = T + K - 1
        k = torch.from_numpy(kern).to(x.device)
        y = torch.fft.ifft(torch.fft.fft(x, n=n, dim=1) * torch.fft.fft(k, n=n)[None, :, None],
                           dim=1)
        out.append(y[:, (K - 1) // 2 : (K - 1) // 2 + T])
    return torch.stack(out)


def sampled(time_fn, support):
    """A wavelet sampled at dt on its support of `support` samples,
    centred (the transform's definition, reference transform.py:88-108)."""
    t = np.arange((-support + 1) / 2.0, (support + 1) / 2.0) / FS
    return time_fn(t)


def morlet_kernels(foi, w0=6.0):
    """Morlet(w0) kernels of the scales of `foi`, cwt normalization."""
    dt, kernels = 1 / FS, []
    for f in foi:
        s = (1.0 / f) * (np.sqrt(w0 * w0 + 2) + w0) / (4 * np.pi)

        def morlet(t, s=s):
            x = t / s
            return (dt ** 0.5 / (s * 8 * np.pi)) * (np.exp(1j * w0 * x) - np.exp(-0.5 * w0 ** 2)) \
                * np.exp(-0.5 * x ** 2) * np.pi ** (-0.25)

        kernels.append(sampled(morlet, 10 * s / dt))
    return kernels


def superlet_kernels(f, cycles):
    """MorletSL kernel (5 standard deviations, `cycles` cycles) of the
    scale of `f`, the superlet normalization."""
    dt, s, k_sd = 1 / FS, 1 / (2 * np.pi * f), 5

    def morlet_sl(t):
        ts = t / s
        b_c = k_sd / (s * cycles * (2 * np.pi) ** 1.5)
        return (dt ** 0.5 / (4 * np.pi)) * b_c * np.exp(1j * ts) \
            * np.exp(-0.5 * (k_sd * ts / (2 * np.pi * cycles)) ** 2)

    return sampled(morlet_sl, 10 * s * cycles / dt)


def wavelet_phase(spt, data, trl):
    """Phase 14: Morlet(6) power at every sample on 512 trials and the
    multiplicative superlet on 64 (BASELINE config #2; the JAX package's
    wavelet_tfr_device and superlet_device rows), each held on its first
    16 trials to float64 linear convolutions on the card (the superlet's
    geometric mean over orders in float64)."""
    import torch

    summary, n_check = {}, TF_ORACLE_TRIALS
    x = torch.from_numpy(data[: n_check * N_SAMPLES]).to("cuda").reshape(
        n_check, N_SAMPLES, N_CHANNELS)

    def head(out):
        """The first trials' power, (trials, S, T, C) on the card."""
        got = np.asarray(out.data)[: n_check * N_SAMPLES, 0]
        return torch.from_numpy(got).to("cuda").reshape(
            n_check, N_SAMPLES, -1, N_CHANNELS).permute(0, 2, 1, 3)

    foi = np.linspace(10, 150, 30)
    adata = spt.from_arrays(data[: WAVELET_TRIALS * N_SAMPLES], trl[:WAVELET_TRIALS], FS)
    want = wavelet_f64(x, morlet_kernels(foi)).abs().permute(1, 0, 2, 3) ** 2
    summary["wavelet"] = spectral_case(
        "wavelet", adata, WAVELET_TRIALS, lambda: spt.freqanalysis(
            adata, method="wavelet", foi=foi, toi="all", output="pow"),
        lambda out: held("wavelet", chunked_rel_err([(head(out), want)])), reps=1)
    del want, adata
    torch.cuda.empty_cache()

    foi = np.linspace(10, 100, 15)
    orders = range(1, 6)
    adata = spt.from_arrays(data[: SUPERLET_TRIALS * N_SAMPLES], trl[:SUPERLET_TRIALS], FS)
    logs = sum(torch.log(wavelet_f64(x, [superlet_kernels(f, 3 * o) for f in foi]).abs())
               for o in orders) / len(orders)
    want = torch.exp(2 * logs).permute(1, 0, 2, 3)  # the geometric mean, squared
    summary["superlet"] = spectral_case(
        "superlet", adata, SUPERLET_TRIALS, lambda: spt.freqanalysis(
            adata, method="superlet", foi=foi, order_max=5, c_1=3, adaptive=False,
            output="pow"),
        lambda out: held("superlet", chunked_rel_err([(head(out), want)])), reps=2)
    del want, logs, x, adata
    torch.cuda.empty_cache()
    return summary


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save-csd", metavar="DIR",
                        help="write the 64-channel Granger CSD and result into DIR")
    parser.add_argument("--jackknife-trials", type=int, default=JACK_COH_TRIALS, metavar="N",
                        help="trials of the coherence jackknife (phase 9), at most {}".format(
                            N_TRIALS))
    args = parser.parse_args()

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

    # the same call on data in tesla (MEG): S_ii * S_jj leaves float32
    tiny = data * np.float32(1e-13)
    got = np.asarray(spt.connectivityanalysis(
        spt.from_arrays(tiny, trl, FS), method="coh", tapsmofrq=2).data)
    if not np.isfinite(got).all():
        raise AssertionError("coherence at data scale 1e-13 not finite")
    tiny_err = float(np.abs(got[0] - coherence_f64(tiny, taper, taper_opt)).max())
    print("coh main path at data scale 1e-13: max abs err vs float64 {:.3e}".format(tiny_err))
    if not tiny_err < COH_ABS_TOL:
        raise AssertionError("coherence err at data scale 1e-13 {:.3e} >= {}".format(
            tiny_err, COH_ABS_TOL))
    del tiny
    torch.cuda.empty_cache()

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
    del tiny, data, adata
    torch.cuda.empty_cache()

    # -- 8. granger main path --------------------------------------------- #
    for n_chan, oracle in ((N_CHANNELS, True), (2 * N_CHANNELS, False)):
        granger_phase(spt, n_chan, oracle, args.save_csd if n_chan == N_CHANNELS else None)

    # -- 9. coh jackknife --------------------------------------------------- #
    coh_jackknife_phase(spt, taper, taper_opt, min(args.jackknife_trials, N_TRIALS))

    # -- 10. granger jackknife ---------------------------------------------- #
    granger_jackknife_phase(spt)

    # -- 11. corr ------------------------------------------------------------ #
    corr_phase(spt)

    # -- 12 to 14. freqanalysis ---------------------------------------------- #
    t0 = time.perf_counter()
    data, trl = north_star_data()
    mtmfft_phase(spt, data, trl, taper, taper_opt, np.asarray(coh.data)[0])
    stft_phase(spt, data, trl)
    wavelet_phase(spt, data, trl)
    del data
    print("phases 12 to 14: {:.1f} s".format(time.perf_counter() - t0))

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
