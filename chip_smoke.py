#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Run the PyTorch port (syncopy_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA card must be present; prints its name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit`` reports them;
2. build: compiles the three CUDA libraries from csrc/ (four kernels) in
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
15. preprocessing on phase 6's data. a: the Butterworth cascade kernel
   (sosfiltfilt and sosfilt) against float64 scipy (1e-6 of its maximum)
   and its plain version (2 float32 ulps of its maximum) at every design
   (lp/hp/bp/bs, orders 1 to 8) and edge shape (T = 2, 5, 28, 1000 by C =
   1, 33, 64, 128, a NaN trial); two launches bitwise equal; kernel, plain
   version, bound, pipe share, registers, spills and warps per SM at
   (1000, 1000, 64), and one long recording (1, 250000, 64) with its time
   a step. b: preprocessing(but,
   bp 30-100 Hz, order 4), one kernel launch a chunk, within 1e-6 of
   float64 scipy sosfiltfilt on 64 trials. c: BASELINE config #5's chain,
   resampledata to 250 Hz (1e-5 of a float64 polyphase resample of the
   same data) and its coherence (the CSD kernel; within 1e-5 of the
   float64 coherence of the float64 chain), and downsample with an
   anti-alias FIR. d: the FIR band-pass 8-12 Hz (order 400) with its
   Hilbert envelope against float64 numpy and scipy.signal.hilbert, and
   the minimum-phase FIR on 16 trials. e: timelockanalysis with the
   covariance of the band-passed data against float64.
16. synthetic data through a .spy container into coherence, at 1000
   trials x 64 channels x 1000 samples. a: ar2_network_device draws
   phase 8's AR(2) network on the card (torch.Generator, seed 7), held to
   a float64 recursion of its own noise (1e-5 of the maximum), two draws
   bitwise equal, the power of the undriven channels, averaged over
   trials and channels, peaking within 2 bins of the AR(2) peak (200 Hz);
   b: save and load of the AnalogData container
   in a temporary directory, bitwise, with the checksum; c: arithmetic
   (a * 1e-6 + a, a - a, a / 2.0), concat of the channel halves, the trial
   halves joined, redefinetrial into 2000 trials of 500 samples, bitwise
   against numpy; d: coh of the loaded container, one CSD kernel launch,
   bitwise equal to the in-memory call, within 1e-5 of float64, 1 -> 0
   above 0.5 and an uncoupled pair below 0.1 at the peak, and the result's
   container round trip, bitwise; e: NWB export and import of 100 trials
   (within one float32 ulp) and a PNG of the coherence under Agg. b and e
   need h5py and e matplotlib: where the machine lacks them, those steps
   print that they were not run, and c and d take the in-memory object.
17. the engine extras on phase 6's data, both routes of each in this run;
   prints the resident budget, the trial store's and the host budget, and
   whether phase 9's CSD stack goes resident. a: BASELINE config #5's
   chain (band-pass 30-100 Hz order 4, resampledata to 250 Hz, coherence
   with tapsmofrq=2) with its intermediates resident: both stay
   unmaterialized, the Butterworth and CSD kernels launch once a chunk,
   the engine counts one upload of the input and only the coherence read
   back, the coherence within 1e-5 of phase 15c's float64 chain and
   bitwise equal to the chain with residency off (the resident budget at
   0) where the consumers ran the host route's chunks, else within 1e-6;
   the chunk plans, the warm walls of both routes (median of 3) and the
   cost of reading the two intermediates back afterwards. b: the device
   trial store: timelockanalysis with covariance of the band-passed data
   (phase 15e's call) and phase 6's coherence, cold (store emptied) and
   cached, walls and bytes uploaded (0 when cached), results bitwise
   equal. c: fetch_trial_view of a resident Morlet TFR (phase 14's call)
   at max_time 1024 and 128 against the host box average of the
   read-back trial (1e-5 of its maximum), its time and bytes against the
   whole readback's. d: the HDF5 spill of a result over a lowered host
   budget, where h5py is installed (else "not run").
18. the mesh (parallel/mesh.py), four positions on cuda:0. a: coh and ppc
   on phase 6's data on a 4 x 1 trial mesh and a 2 x 2 trial x channel
   mesh: one kernel launch per trial shard and chunk (the last shard's
   rows partly padding), the same bytes across the host link as the
   unsharded call, within 1e-6 of phases 6 and 7 and within 1e-5 of
   their float64 results; b: phase 15b's band-pass on the 4 x 1 mesh, one
   Butterworth launch per shard and chunk, within 1e-6 of the unsharded
   result; c: config #5's chain resident on the 4 x 1 mesh, one upload of
   the input and only the coherence back, within 1e-5 of phase 15c's
   float64 chain and 1e-6 of phase 17a's, and its warm wall; d: the
   sharded routines on one (250000, 64) recording against the port's unsharded functions on the
   card (1e-5 of the maximum): apply_fir_time_sharded (order-400 FIR),
   mtmconvol_time_sharded (64-sample Hann windows, power),
   cwt_time_sharded (30 Morlet frequencies, 3.84 GB out), and
   granger_sharded (wilson_sf_sharded inside) on phase 8's 64-channel CSD
   (1e-6 absolute); each prints the unsharded and the sharded wall side
   by side, the cost of the split on one card; e: where more than one
   card is visible, each kernel launched on every card against its plain
   version, and coh, ppc and the band-pass on a trial mesh over the cards
   against the unsharded calls with both walls; else "not run: one card".
19. multi-host (parallel/mesh.py::init_distributed,
   parallel/multihost_worker.py): two processes of the worker, started
   once the kernels are built, join a torch.distributed cluster over gloo,
   both on cuda:0 (NCCL refuses two ranks on one card), and each makes
   phase 6's data itself. coh, ppc and phase 15b's band-pass
   (keeptrials) on a 2 x 1 mesh over the two ranks: each rank uploads and
   launches only its own trial shard (exactly one CSD, one PPC and one
   Butterworth launch per rank), receives the other's partial or rows by
   broadcast and holds the whole result, bitwise equal to rank 0's and to
   a one-process 2 x 1 mesh's, within 1e-6 of its own parallel=False call
   (the band-pass bitwise) and within 1e-5 of float64. Then the five
   sharded routines on the same mesh at phase 18d's shapes:
   apply_fir_time_sharded, mtmconvol_time_sharded and cwt_time_sharded on
   the (250000, 64) recording (halos by point-to-point sends, each rank
   transforming its half, then every rank gathering the whole result),
   wilson_sf_sharded and granger_sharded on phase 8's 64-channel CSD
   (handed to the ranks in an .npz; layout swaps and each block's error
   by point-to-point sends), each bitwise equal to rank 0's and to a
   one-process 2 x 1 mesh's and within phase 18d's bars of the unsharded
   function (1e-5 of the maximum; Wilson 1e-8; Granger 1e-6 absolute).
   Each rank prints the bytes it sent and received through the collectives, for
   the sharded routines in the routine and in the gather beside the count
   predicted from the shapes and Wilson's steps (they must be equal; the
   halos are also held to this script's own count), and the mesh wall
   beside rank 0's unsharded (parallel=False) and one-process mesh walls
   (3 calls each, in turns). No launch of the port's kernels comes from
   the sharded routines (cuFFT, cuBLAS and cuSOLVER calls). A rank that
   fails or outlives its timeout fails the phase. 19e: where more than one
   card is visible, one rank per card over NCCL; else "not run: one
   card".
Phases 9 to 16 each print their warm wall, peak device memory and peak
host RSS, and the launch counters, which stay at 0 on phases 9 to 14:
these paths run no CUDA kernel of the port. Phases 12 to 15 also print
trials/s, the bytes read back with their copy time, and a stage split
(gather, pad and upload; compute; readback) replayed with a synchronize
after each step.

Results that stay on the card (engine/resident.py) are read back inside
every timed call of phases 6 to 16, which also empty the trial store
before each call and at each phase boundary: their walls time host data
in and host data out, as they did before the engine kept data on the
card; the resident-only wall, before the readback, is printed beside
them.

Each main path runs with the launch counters set to 0 just before it and
read just after. The line before the last is a JSON object with each
kernel's launches (csd_accumulate is on no path of the port: the JAX
package calls it only from its Pallas probe), error, times and bound (the
least time the card could take: operations over the FP32 peak, FP64 for
the Butterworth cascade, against bytes over the HBM rate, from this run's
shapes); the Granger path launches none of them. The launches count
phase 6's, 7's, 15's, 16's, 17a's, 18's and 19's main paths (phase 19's
in its ranks' processes). The last line is
``{"ok": true, "device": {...}}``. TF32 stays off throughout, asserted.

    python3 chip_smoke.py --save-csd DIR

also writes the 64-channel Granger CSD and the port's result there
(``granger_csd64.npz``), for scripts/granger_compare_jax.py;
``--jackknife-trials N`` sets phase 9's trial count; ``--cards-only`` runs
phases 1, 2, 18e and 19e only (on a host with several cards).
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

    zero_launches()
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
    launches = tuple(read_launches("granger {} ch".format(n_chan)).values())
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

    summary = {"info": info, "peak_gb": peak_gb, "csd": seen["csd"]}
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
    from syncopy_tpu_torch.ops import iir_kernels as ik
    from syncopy_tpu_torch.ops import ppc_kernels as pk

    ck.csd_accumulate_tiled.launches = 0
    ck.csd_accumulate.launches = 0
    pk.ppc_accumulate_tiled.launches = 0
    ik.sosfilt_batch.launches = 0


def read_launches(name, expect=None):
    """The four kernels' launches since zero_launches(): each must equal
    its count in `expect` and the others 0 (none may have run on the paths
    of phases 9 to 14). Returns them."""
    from syncopy_tpu_torch.ops import csd_kernels as ck
    from syncopy_tpu_torch.ops import iir_kernels as ik
    from syncopy_tpu_torch.ops import ppc_kernels as pk

    launches = {"csd_accumulate_tiled": ck.csd_accumulate_tiled.launches,
                "csd_accumulate": ck.csd_accumulate.launches,
                "ppc_accumulate_tiled": pk.ppc_accumulate_tiled.launches,
                "sosfiltfilt": ik.sosfilt_batch.launches}
    print("{}: kernel launches {}".format(name, launches))
    want = dict.fromkeys(launches, 0)
    want.update(expect or {})
    if launches != want:
        raise AssertionError("{} launched kernels {}, expected {}".format(name, launches, want))
    return launches


def settle(res):
    """Read back every device-resident payload among `res` (a data object
    or a tuple of them), as the engine without residency returns it; the
    number of payloads read back."""
    from syncopy_tpu_torch.engine.resident import DeferredArray

    n = 0
    for obj in res if isinstance(res, tuple) else (res,):
        if isinstance(getattr(obj, "_data", None), DeferredArray):
            obj._data._ensure()
            n += 1
    return n


def clear_store():
    """Empty the device trial store (reading any live resident result
    back) and the allocator's cache: the next call uploads its input as
    the engine without the store did."""
    import torch

    from syncopy_tpu_torch.engine.routine import clear_device_cache

    clear_device_cache()
    torch.cuda.empty_cache()


def measured_call(name, fn, expect=None):
    """One checked call of `fn` with the trial store empty, the launch
    counters at 0, peak device memory and peak host RSS reset before it;
    the launches must be those of `expect` (see read_launches). A
    device-resident result is read back inside the timed call; the wall
    before that readback is printed beside it. Returns its result and
    (wall s, peak device GB, peak host GB)."""
    import torch

    import gc

    gc.collect()  # what earlier phases left in reference cycles
    clear_store()
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with HostPeak() as host:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        resident_wall = time.perf_counter() - t0
        n_resident = settle(res)
        wall = time.perf_counter() - t0
    read_launches(name, expect)
    dev_gb = torch.cuda.max_memory_allocated() / 1e9
    print("{}: first call {:.3f} s{}; peak device memory {:.3f} GB; peak host RSS {:.3f} GB{}".format(
        name, wall, " (resident-only {:.3f} s, then read back)".format(resident_wall)
        if n_resident else "", dev_gb, host.gb, " (since the process started)"
        if host.since_start else " ({:.3f} GB resident before the call)".format(host.start_gb)))
    return res, (wall, dev_gb, host.gb)


def warm_wall(name, fn, reps=1):
    """Host-clock seconds of `reps` more calls of `fn`, synchronized, each
    after emptying the trial store and including the readback of a
    device-resident result; the resident-only walls, to the end of the
    call before that readback, are printed beside them."""
    import torch

    walls, resident_walls = [], []
    for _ in range(reps):
        clear_store()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        resident_walls.append(time.perf_counter() - t0)
        n_resident = settle(res)
        walls.append(time.perf_counter() - t0)
        del res
    wall = statistics.median(walls)
    print("{} warm wall: median {:.4f} s of {} ({}){}".format(
        name, wall, reps, ", ".join("{:.4f}".format(w) for w in walls),
        "; resident-only wall, before the readback: median {:.4f} s ({})".format(
            statistics.median(resident_walls), ", ".join(
                "{:.4f}".format(w) for w in resident_walls)) if n_resident else ""))
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

    def replicates(ensemble, **kwargs):
        seen["replicates"] = originals[0](ensemble, **kwargs)
        return seen["replicates"]

    def bias_var(direct, jack_rep, **kwargs):
        seen["jack_rep"] = jack_rep
        return originals[1](direct, jack_rep, **kwargs)

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


def captured_call(name, fn, expect=None):
    """:func:`measured_call` of `fn`, and the compute routine its frontend
    ran (the first one initialized), for the stage split."""
    from syncopy_tpu_torch.engine.routine import ComputationalRoutine

    routines, initialize = [], ComputationalRoutine.initialize

    def keep(self, *args, **kwargs):
        routines.append(self)
        return initialize(self, *args, **kwargs)

    ComputationalRoutine.initialize = keep
    try:
        res, stats = measured_call(name, fn, expect)
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

    from syncopy_tpu_torch.engine.resident import DeferredArray

    if isinstance(adata._data, DeferredArray):
        # the replay takes the host route: the input read back, and the
        # vectorized gather plan the engine builds for it
        adata._data._ensure()
        cr._fast_plan = cr._plan_fast_gather(adata)
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
            if isinstance(res, tuple):
                res = res[0]  # the per-trial info rides along
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


def spectral_case(name, adata, n_trials, call, check, reps=3, expect=None):
    """One freqanalysis (or preprocessing) configuration on the card: a
    first call with the launch counters at 0 (or at `expect`, see
    read_launches) and the peak memory read, `check(out)` (which returns
    the error against the float64 oracle and raises past its bar), the warm
    wall over `reps` calls and the stage split of its first routine."""
    import torch

    out, (first, dev_gb, host_gb), cr = captured_call(name, call, expect)
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
            "readback_gb": nbytes / 1e9, "routine": cr}


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


#: phase 15's bars, relative to the oracle's maximum: the IIR kernel and
#: the IIR main path against float64 scipy (float64 inside: one float32
#: rounding on the way in, one on the way out); the resampling, the FIR and
#: Hilbert route and timelockanalysis against float64 (float32 FFTs and
#: sums); the chained coherence (absolute) is COH_ABS_TOL
IIR_REL_TOL = 1e-6
#: the IIR kernel against its plain version, relative to the plain
#: version's maximum: 2 float32 ulps (the same float64 order of operations,
#: fused into FMAs in the kernel; each side rounded once to float32)
IIR_PLAIN_TOL = 2.0 ** -22
PREPROC_REL_TOL = 1e-5
#: trials held to float64 scipy and numpy on the IIR and FIR main paths
PREPROC_ORACLE_TRIALS = 64
#: the H100 SXM's published FP64 peak outside the tensor cores
PEAK_FP64_FLOPS = 34e12
#: phase 15's long recording: one trial of 250 s at 1 kHz, 64 channels
LONG_TRIAL_SAMPLES = 250_000


def iir_bound(N, T, C, n_sections, pad):
    """(bound_ms, bound_by, pipe_ms) of one sosfiltfilt launch: its 9 FP64
    operations per (extended sample, section, pass) over the FP64 peak
    against the float32 input read once and the output written once over
    the HBM rate; pipe_ms adds the kernel's float64 scratch of the
    extended trials, written once and read once."""
    E = T + 2 * pad
    flops = 9.0 * N * C * E * n_sections * 2
    nbytes = 2.0 * N * T * C * 4
    t_ops, t_bytes = flops / PEAK_FP64_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    pipe = (nbytes + 2.0 * N * E * C * 8) / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations", pipe) if t_ops >= t_bytes else (t_bytes, "bytes", pipe)


def sosfilt_scipy(x, sos, twopass):
    """float64 scipy sosfiltfilt (the port's padlen) or sosfilt along
    axis 1 of a numpy batch."""
    from scipy import signal

    from syncopy_tpu_torch.ops.iir_kernels import sosfilt_padlen

    xd = np.asarray(x, dtype=np.float64)
    if twopass:
        y = signal.sosfiltfilt(sos, xd, axis=1, padlen=sosfilt_padlen(sos, x.shape[1]))
    else:
        y = signal.sosfilt(sos, xd, axis=1)
    return np.ascontiguousarray(y)


def nan_rel_err(got, want):
    """max|got - want| / max|want| over the finite entries of `want`; the
    NaN entries must match."""
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("NaN where the oracle has none, or none where it has NaN")
    ok = ~np.isnan(want)
    if not ok.any():
        return 0.0
    return float(np.abs(got[ok] - want[ok]).max() / np.abs(want[ok]).max())


def check_iir(ik, x, sos, twopass, name, plain=True):
    """One sosfiltfilt (or sosfilt) case of a (N, T, C) float32 numpy batch:
    the kernel against float64 scipy and, if `plain`, against its plain
    version on the card (the same float64 arithmetic). Returns the error
    against scipy or raises."""
    import torch

    dev = torch.from_numpy(x).to("cuda")
    got = ik.sosfilt_batch(dev, sos, twopass).cpu().numpy()
    err = nan_rel_err(got, sosfilt_scipy(x, sos, twopass))
    line = "sosfilt{} {}: rel err vs float64 scipy {:.3e}".format(
        "filt" if twopass else "", name, err)
    if plain:
        plain_err = nan_rel_err(got, ik.sosfilt_batch_plain(dev, sos, twopass).cpu().numpy())
        line += ", vs the plain version {:.3e}".format(plain_err)
        if not plain_err <= IIR_PLAIN_TOL:
            raise AssertionError("{}: plain err {:.3e} > {:.3e}".format(
                name, plain_err, IIR_PLAIN_TOL))
    print(line)
    if not err < IIR_REL_TOL:
        raise AssertionError("{}: err {:.3e} >= {}".format(name, err, IIR_REL_TOL))
    return err


def iir_kernel_checks(ik, fb, data):
    """Phase 15a: the kernel at every Butterworth design (lp/hp/bp/bs,
    orders 1 to 8, both directions) and at the edge shapes (T = 2, 5, 28,
    1000 by C = 1, 33, 64, 128, a NaN trial), against float64 scipy and the
    plain version; then at the main-path shape: bitwise determinism, the
    times and the bound; then one long recording."""
    import torch

    rng = np.random.default_rng(15)
    for ftype, freq in (("lp", 40.0), ("hp", 20.0), ("bp", [30.0, 100.0]), ("bs", [45.0, 55.0])):
        for order in range(1, 9):
            sos = fb.butter_sos(order, freq, ftype, FS)
            x = rng.normal(size=(4, N_SAMPLES, 33)).astype("f4")
            for twopass in (True, False):
                check_iir(ik, x, sos, twopass, "{} order {} (4, 1000, 33)".format(ftype, order),
                          plain=order in (1, 8))
    sos = fb.butter_sos(4, [30.0, 100.0], "bp", FS)
    for T in (2, 5, 28, N_SAMPLES):
        for C in (1, 33, 64, 128):
            x = rng.normal(size=(3, T, C)).astype("f4")
            x[1, T // 2, C // 2] = np.nan
            for twopass in (True, False):
                check_iir(ik, x, sos, twopass, "bp order 4 ({}, {}, {}), NaN trial 1".format(
                    3, T, C), plain=T < N_SAMPLES or C == 64)

    x = torch.from_numpy(data).to("cuda").reshape(N_TRIALS, N_SAMPLES, N_CHANNELS)
    got = ik.sosfilt_batch(x, sos)
    plain = ik.sosfilt_batch_plain(x, sos)
    torch.cuda.synchronize()
    plain_diff = float((got - plain).abs().max())
    plain_max = float(plain.abs().max())
    n = PREPROC_ORACLE_TRIALS
    want = sosfilt_scipy(data[: n * N_SAMPLES].reshape(n, N_SAMPLES, N_CHANNELS), sos, True)
    head = got[:n].cpu().numpy()
    err = float(np.abs(head - want).max())
    rel = err / float(np.abs(want).max())
    print("sosfiltfilt bp order 4 at ({}, {}, {}): max abs err vs float64 scipy {:.3e} on {} "
          "trials ({:.3e} of the maximum); kernel - plain version max |diff| {:.3e} ({:.3e} of "
          "the plain version's maximum, bar {:.3e})".format(
              N_TRIALS, N_SAMPLES, N_CHANNELS, err, n, rel, plain_diff, plain_diff / plain_max,
              IIR_PLAIN_TOL))
    if not rel < IIR_REL_TOL or not plain_diff <= IIR_PLAIN_TOL * plain_max:
        raise AssertionError("sosfiltfilt at the main-path shape off float64")
    del plain, got
    check_deterministic("sosfiltfilt at ({}, {}, {})".format(N_TRIALS, N_SAMPLES, N_CHANNELS),
                        lambda: ik.sosfilt_batch(x, sos))
    kernel_ms = cuda_ms(lambda: ik.sosfilt_batch(x, sos))
    plain_ms = cuda_ms(lambda: ik.sosfilt_batch_plain(x, sos), reps=3, warmup=1)
    pad = ik.sosfilt_padlen(sos, N_SAMPLES)
    bound_ms, bound_by, pipe_ms = iir_bound(N_TRIALS, N_SAMPLES, N_CHANNELS, sos.shape[0], pad)
    threads, blocks = ik.kernel_occupancy(sos.shape[0])
    registers, local_bytes = ik.kernel_attributes(sos.shape[0])
    props = torch.cuda.get_device_properties(0)
    resident = N_TRIALS * N_CHANNELS / 32 / props.multi_processor_count
    print("sosfiltfilt kernel at ({}, {}, {}), S = {}, padlen {}: {:.4f} ms (median of 20), plain "
          "version {:.4f} ms (median of 3), CUDA events; bound {:.4f} ms ({}), {:.1f}% of it; "
          "with the float64 scratch written and read {:.4f} ms, {:.1f}% of it; {} registers a "
          "thread, {} bytes of local memory (spills); {} threads a block, {} blocks ({} warps) "
          "resident per SM allowed, {:.1f} warps per SM launched; no library call computes an "
          "IIR recurrence".format(
              N_TRIALS, N_SAMPLES, N_CHANNELS, sos.shape[0], pad, kernel_ms, plain_ms, bound_ms,
              bound_by, 100 * bound_ms / kernel_ms, pipe_ms, 100 * pipe_ms / kernel_ms,
              registers, local_bytes, threads, blocks, threads * blocks // 32, resident))
    if local_bytes != 0 or blocks * threads < resident * 32:
        raise AssertionError("the S = {} twopass instance spills or is granted fewer warps per "
                             "SM than it launches".format(sos.shape[0]))
    del x
    torch.cuda.empty_cache()

    y = rng.normal(size=(1, LONG_TRIAL_SAMPLES, N_CHANNELS)).astype("f4")
    check_iir(ik, y, sos, True, "one long trial (1, {}, {})".format(
        LONG_TRIAL_SAMPLES, N_CHANNELS), plain=False)
    long_dev = torch.from_numpy(y).to("cuda")
    long_ms = cuda_ms(lambda: ik.sosfilt_batch(long_dev, sos), reps=3, warmup=1)
    long_bound = iir_bound(1, LONG_TRIAL_SAMPLES, N_CHANNELS, sos.shape[0], pad)
    long_steps = 2 * (LONG_TRIAL_SAMPLES + 2 * pad)
    print("sosfiltfilt kernel on one long trial (1, {}, {}): {:.4f} ms (median of 3, CUDA "
          "events), {:.2f} ns a step; bound {:.4f} ms ({}): {} threads, one serial chain of {} "
          "steps each".format(
              LONG_TRIAL_SAMPLES, N_CHANNELS, long_ms, 1e6 * long_ms / long_steps, long_bound[0],
              long_bound[1], N_CHANNELS, long_steps))
    del long_dev
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pipe_ms": pipe_ms, "long_ms": long_ms,
            "warps_per_sm": resident}


def engine_chunks(cr):
    """The compute chunks a finished call's routine ran."""
    count = 0
    for shp, positions in cr.buckets.items():
        chunk = cr._chunk_size(shp, len(positions), 4)
        count += -(-len(positions) // chunk)
    return count


def resample_f64(x, up, down, kernel):
    """Float64 polyphase resampling on the card of a (N, T, C) batch:
    zero-stuff by `up`, the exact linear convolution with ``kernel * up``
    cropped 'same' from (K - 1) // 2, every `down`-th sample,
    ceil(T up / down) samples."""
    import torch

    N, T, C = x.shape
    stuffed = torch.zeros((N, T * up, C), dtype=torch.float64, device=x.device)
    stuffed[:, ::up] = x.double()
    k = torch.from_numpy(np.asarray(kernel, dtype=np.float64) * up).to(x.device)
    K, n = k.numel(), T * up + k.numel() - 1
    y = torch.fft.irfft(torch.fft.rfft(stuffed, n=n, dim=1) * torch.fft.rfft(k, n=n)[:, None],
                        n=n, dim=1)
    start = (K - 1) // 2
    return y[:, start : start + T * up : down][:, : int(np.ceil(T * up / down))]


def coherence_batch_f64(x, tapers):
    """Float64 coherence on the card of a (N, T, C) batch: demean, taper,
    rfft, trial x taper CSD sum, normalization; and the auto power."""
    import torch

    x = x.double()
    x = x - x.mean(dim=1, keepdim=True)
    spec = torch.fft.rfft(tapers[None, :, :, None] * x[:, None], dim=2)
    rows = spec.reshape(-1, spec.shape[2], spec.shape[3]).permute(1, 0, 2)
    csd = torch.matmul(rows.transpose(1, 2), rows.conj())
    diag = torch.diagonal(csd, dim1=-2, dim2=-1).real
    coh = csd.abs() / torch.sqrt(diag[:, :, None] * diag[:, None, :])
    return coh.cpu().numpy(), diag.cpu().numpy()


def fir_twopass_f64(x, kernel):
    """Float64 numpy twopass 'same'-mode FIR of a (N, T, C) batch: the
    exact linear convolution cropped from (K - 1) // 2, then the same on
    the time-reversed result, reversed back."""
    from scipy import signal

    K, T = len(kernel), x.shape[1]
    k = np.asarray(kernel, dtype=np.float64)[None, :, None]

    def same(v):
        return signal.fftconvolve(v, k, axes=1)[:, (K - 1) // 2 : (K - 1) // 2 + T]

    return same(same(x.astype(np.float64))[:, ::-1])[:, ::-1]


def preproc_phase(spt, data, trl, kernel_ms):
    """Phase 15: preprocessing on the north-star data. b, the IIR main path
    (Butterworth band-pass, the CUDA kernel once a chunk) against float64
    scipy; c, BASELINE config #5's chain (resample to 250 Hz, coherence)
    against a float64 chain, and downsample with an anti-alias FIR; d, the
    FIR band-pass with its Hilbert envelope (the JAX package's
    preproc_pipeline_device filter) against float64 numpy and scipy, and
    the minimum-phase FIR; e, timelockanalysis of the band-passed data
    against float64. Returns the summary, with the IIR path's launches."""
    import torch
    from scipy import signal

    from syncopy_tpu_torch.engine.routine import chunk_trials
    from syncopy_tpu_torch.ops import filtering as fb
    from syncopy_tpu_torch.ops.windows import make_tapers
    from syncopy_tpu_torch.shared.input_processors import process_taper

    t_phase = time.perf_counter()
    adata = spt.from_arrays(data, trl, FS)
    summary, n = {}, PREPROC_ORACLE_TRIALS
    raw = data.reshape(N_TRIALS, N_SAMPLES, N_CHANNELS)
    sos = fb.butter_sos(4, [30.0, 100.0], "bp", FS)

    # -- b. the IIR main path
    kept = {}

    def check_iir_path(out):
        kept["bp"] = out
        got = np.asarray(out.data).reshape(N_TRIALS, N_SAMPLES, N_CHANNELS)
        if not np.isfinite(got).all() or out.info["nan_trials"] != []:
            raise AssertionError("band-passed data not finite, or NaN trials flagged")
        return held("preprocessing but bp (first {} trials)".format(n), nan_rel_err(
            got[:n], sosfilt_scipy(raw[:n], sos, True)), IIR_REL_TOL)

    bp_call = lambda: spt.preprocessing(  # noqa: E731
        adata, filter_class="but", filter_type="bp", freq=[30, 100], order=4)
    n_chunks = -(-N_TRIALS // chunk_trials_for_bp())
    summary["but"] = spectral_case("preprocessing but bp", adata, N_TRIALS, bp_call,
                                   check_iir_path, expect={"sosfiltfilt": n_chunks})
    if engine_chunks(summary["but"].pop("routine")) != n_chunks:
        raise AssertionError("the IIR path ran another chunk count than {}".format(n_chunks))
    summary["launches"] = n_chunks
    print("preprocessing but bp: {} kernel launch(es) for {} chunk(s); kernel {:.4f} ms of the "
          "compute stage's {:.3f} ms".format(n_chunks, n_chunks, kernel_ms,
                                            summary["but"]["stages"]["compute"]))
    bp = kept.pop("bp")

    # -- c. config #5's chain: resample to 250 Hz, coherence
    up, down = 1, 4
    rs_kernel = fb._resample_kernel(up, down, N_SAMPLES, None, None, FS)

    def check_resample(out):
        kept["rs"] = out
        got = torch.from_numpy(np.asarray(out.data)).to("cuda").reshape(N_TRIALS, -1, N_CHANNELS)
        x = torch.from_numpy(np.asarray(bp.data)).to("cuda").reshape(
            N_TRIALS, N_SAMPLES, N_CHANNELS)
        return held("resampledata 250 Hz", chunked_rel_err(
            (got[b0 : b0 + 100], resample_f64(x[b0 : b0 + 100], up, down, rs_kernel))
            for b0 in range(0, N_TRIALS, 100)))

    summary["resample"] = spectral_case("resampledata resample 250 Hz", bp, N_TRIALS, lambda: (
        spt.resampledata(bp, resamplefs=250, method="resample")), check_resample)
    summary["resample"].pop("routine")
    rs = kept.pop("rs")
    n_rs = N_SAMPLES * up // down
    coh_chunks = -(-N_TRIALS // chunk_trials(n_rs * N_CHANNELS * 4 * 2, N_TRIALS))
    coh, (coh_first, _, _) = measured_call("coh of the resampled data", lambda: (
        spt.connectivityanalysis(rs, method="coh", tapsmofrq=2)),
        expect={"csd_accumulate_tiled": coh_chunks})
    t0 = time.perf_counter()
    bp64 = torch.from_numpy(sosfilt_scipy(raw, sos, True)).to("cuda")
    rs64 = torch.cat([resample_f64(bp64[b0 : b0 + 100], up, down, rs_kernel)
                      for b0 in range(0, N_TRIALS, 100)])
    del bp64
    taper, taper_opt = process_taper(
        "hann", None, 2, None, keeptapers=False, foimax=125.0, samplerate=250.0, nSamples=n_rs,
        output="pow")
    tapers = torch.from_numpy(make_tapers(taper, taper_opt, n_rs, n_rs, 250.0)).to(
        "cuda", torch.float64)
    coh64, power = coherence_batch_f64(rs64, tapers)
    del rs64
    got = np.asarray(coh.data)[0]
    if got.shape != coh64.shape or not np.isfinite(got).all():
        raise AssertionError("chained coherence shape {} or not finite".format(got.shape))
    chain_err = float(np.abs(got - coh64).max())
    rel_power = power / power.max(axis=0)
    print("coh of band-pass -> resample (float64 chain in {:.1f} s): shape {}; max abs err vs "
          "the float64 chain {:.3e} over all {} bins (the chain's power is {:.2e} to 1 of each "
          "channel's maximum)".format(
              time.perf_counter() - t0, got.shape, chain_err, got.shape[0],
              float(rel_power.min())))
    if not chain_err < COH_ABS_TOL:
        raise AssertionError("chained coherence err {:.3e} >= {}".format(chain_err, COH_ABS_TOL))
    coh_wall = warm_wall("coh of the resampled data", lambda: spt.connectivityanalysis(
        rs, method="coh", tapsmofrq=2), reps=3)
    summary["chain"] = {"err": chain_err, "coh_first": coh_first, "coh_wall": coh_wall,
                        "csd_launches": coh_chunks, "coh64": coh64}
    del coh, rs

    def check_downsample(out):
        got = np.asarray(out.data)
        if got.shape != (N_TRIALS * n_rs, N_CHANNELS) or not np.isfinite(got).all():
            raise AssertionError("downsample shape {} or not finite".format(got.shape))
        return 0.0

    summary["downsample"] = spectral_case(
        "resampledata downsample 250 Hz, lpfreq 100", bp, N_TRIALS, lambda: spt.resampledata(
            bp, resamplefs=250, method="downsample", lpfreq=100), check_downsample)
    summary["downsample"].pop("routine")

    # -- d. FIR band-pass and Hilbert envelope
    fir = fb.design_wsinc("hamming", 400, np.asarray([8.0, 12.0]) / FS, "bp")

    def check_fir(out):
        got = np.asarray(out.data).reshape(N_TRIALS, N_SAMPLES, N_CHANNELS)
        want = np.abs(signal.hilbert(fir_twopass_f64(raw[:n], fir), axis=1))
        return held("firws bp + hilbert abs (first {} trials)".format(n),
                    nan_rel_err(got[:n], want))

    summary["fir"] = spectral_case("preprocessing firws bp 8-12 Hz + hilbert abs", adata, N_TRIALS,
                                   lambda: spt.preprocessing(
                                       adata, filter_class="firws", filter_type="bp",
                                       freq=[8, 12], order=400, hilbert="abs"), check_fir)
    summary["fir"].pop("routine")
    few = 16
    mini = spt.from_arrays(data[: few * N_SAMPLES], trl[:few], FS)
    out, _ = measured_call("preprocessing firws bp onepass-minphase, {} trials".format(few), lambda: (
        spt.preprocessing(mini, filter_class="firws", filter_type="bp", freq=[8, 12], order=400,
                          direction="onepass-minphase")))
    k_min = fb.minphaserceps(fir)
    want = signal.fftconvolve(raw[:few].astype(np.float64), k_min[None, :, None], axes=1)[
        :, (len(k_min) - 1) // 2 : (len(k_min) - 1) // 2 + N_SAMPLES]
    summary["minphase_err"] = held("firws onepass-minphase", nan_rel_err(
        np.asarray(out.data).reshape(few, N_SAMPLES, N_CHANNELS), want))
    del out, mini

    # -- e. timelockanalysis of the band-passed data
    def check_timelock(out):
        x = torch.from_numpy(np.asarray(bp.data)).to("cuda", torch.float64).reshape(
            N_TRIALS, N_SAMPLES, N_CHANNELS)
        avg = x.mean(dim=0)
        var = ((x - avg) ** 2).sum(dim=0) / (N_TRIALS - 1)
        xc = x - x.mean(dim=1, keepdim=True)
        cov = torch.einsum("ntc,ntd->cd", xc, xc) / (N_SAMPLES - 1) / N_TRIALS
        errs = [chunked_rel_err([(torch.from_numpy(np.asarray(got)).to("cuda"), want)])
                for got, want in ((out.avg, avg), (out.var, var), (out.cov, cov))]
        print("timelockanalysis: avg, var, cov max err vs float64 {:.3e}, {:.3e}, {:.3e} of "
              "their maxima".format(*errs))
        return held("timelockanalysis avg/var/cov", max(errs))

    summary["timelock"] = spectral_case("timelockanalysis covariance", bp, N_TRIALS, lambda: (
        spt.timelockanalysis(bp, covariance=True)), check_timelock)
    summary["timelock"].pop("routine")
    del bp
    torch.cuda.empty_cache()
    print("phase 15 calls and oracles: {:.1f} s".format(time.perf_counter() - t_phase))
    return summary


#: phase 16: the generator against float64 on its own noise (relative to
#: the maximum), the AR(2) peak's bins, and the coherence bars at the peak
#: (the 1 -> 0 drive and an uncoupled pair), set from the float64 oracle's
#: values on this data: 0.7971 and 0.0273 (NVIDIA H100 80GB HBM3)
SYNTH_SEED, SYNTH_REL_TOL, SYNTH_PEAK_BINS = 7, 1e-5, 2
SYNTH_COH_DRIVEN_MIN, SYNTH_COH_UNCOUPLED_MAX = 0.5, 0.1
#: trials written to NWB in phase 16e
NWB_TRIALS = 100


def bitwise(name, got, want):
    """Raise unless `got` and `want` hold the same bits, dtype and shape."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape or got.tobytes() != want.tobytes():
        raise AssertionError("{}: not bitwise equal ({} {} against {} {})".format(
            name, got.dtype, got.shape, want.dtype, want.shape))
    print("{}: bitwise equal ({} {})".format(name, got.dtype, got.shape))


def host_wall(name, fn, nbytes=None):
    """One host call of `fn`, its wall and (for `nbytes`) GB/s; host work."""
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    rate = "" if nbytes is None else ", {:.3f} GB/s".format(nbytes / 1e9 / wall)
    print("{}: {:.4f} s (host){}".format(name, wall, rate))
    return res, wall


def ar2_f64(noise, m1, alpha2):
    """The AR(2) recursion of `noise` (N, T, C) in float64 on the card."""
    import torch

    x = noise.double()
    out = torch.empty_like(x)
    out[:, :2] = x[:, :2]
    m1t = m1.double().T
    for t in range(2, x.shape[1]):
        out[:, t] = out[:, t - 1] @ m1t + alpha2 * out[:, t - 2] + x[:, t]
    return out


def synth_phase(spt, taper, taper_opt):
    """Phase 16: synthetic data through a .spy container into coherence, at
    1000 trials x 64 channels x 1000 samples. a, ar2_network_device on the
    card (phase 8's network), its recursion against float64 on the same
    noise, two draws bitwise equal, the AR(2) peak of the undriven
    channels' mean power; b, save and load of the AnalogData container, bitwise, with
    the checksum; c, arithmetic, concat (channels; trials through the
    object-list constructor) and redefinetrial on the loaded object against
    numpy, bitwise; d, coh of the loaded container (one CSD kernel launch)
    bitwise equal to the in-memory call and within 1e-5 of float64, the
    drive at the peak, and the CrossSpectralData container round trip; e,
    NWB export and import of 100 trials and a PNG of the coherence. b and
    e need h5py, e matplotlib: where the machine lacks them, they are
    reported as not run and c and d take the in-memory object. Returns the
    summary, with the kernel's launches."""
    import importlib.util
    import shutil
    import tempfile

    import torch

    from syncopy_tpu_torch.synthdata.analog import _ar2_scan

    t_phase = time.perf_counter()
    summary = {}
    have_h5py = importlib.util.find_spec("h5py") is not None
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    print("phase 16: h5py {}, matplotlib {} on this machine".format(
        "present" if have_h5py else "NOT INSTALLED", "present" if have_mpl else "NOT INSTALLED"))

    # -- a. the generator
    adj = np.zeros((N_CHANNELS, N_CHANNELS), np.float32)
    adj[1, 0] = AR2_COUPLING

    def draw():
        return spt.synthdata.ar2_network_device(N_TRIALS, AdjMat=adj, nSamples=N_SAMPLES,
                                                alphas=AR2_ALPHAS, seed=SYNTH_SEED)

    x, _ = measured_call("ar2_network_device ({}, {}, {})".format(
        N_TRIALS, N_SAMPLES, N_CHANNELS), draw)
    gen_ms = cuda_ms(draw, reps=3, warmup=1)
    out_bytes = x.numel() * x.element_size()
    print("ar2_network_device: {:.3f} ms (median of 3, CUDA events), {:.3f} GB written, "
          "{:.2f} GB/s".format(gen_ms, out_bytes / 1e9, out_bytes / 1e6 / gen_ms))
    if not torch.equal(x, draw()):
        raise AssertionError("two draws with the same seed differ")
    print("ar2_network_device: two draws with seed {} bitwise equal".format(SYNTH_SEED))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SYNTH_SEED)
    noise = torch.randn(tuple(x.shape), generator=gen, dtype=torch.float32, device="cuda")
    m1 = torch.from_numpy(np.diag(np.full(N_CHANNELS, AR2_ALPHAS[0], np.float32)) + adj.T).cuda()
    if not torch.equal(_ar2_scan(noise, m1, AR2_ALPHAS[1]), x):
        raise AssertionError("the generator is not _ar2_scan of its own noise")
    want = ar2_f64(noise, m1, AR2_ALPHAS[1])
    summary["scan_err"] = held("_ar2_scan (generator) on its own noise", chunked_rel_err(
        [(x, want)]), SYNTH_REL_TOL)
    del noise, want
    peak = spt.synthdata.ar2_peak_freq(*AR2_ALPHAS, FS)
    # channel 0 is driven; channels 1-63 are the same undriven process, so
    # their periodograms average with the trials' (a single channel's peak
    # bin wanders by a few 1 Hz bins across the broad AR(2) peak)
    power = (torch.fft.rfft(x, dim=1).abs() ** 2).mean(dim=0)[:, 1:]  # (F, C - 1)
    hz = power.argmax(dim=0).cpu().numpy() * FS / N_SAMPLES
    top = int(power.mean(dim=1).argmax())
    off = abs(top - round(peak * N_SAMPLES / FS))
    print("AR(2) peak {:.2f} Hz: the power of channels 1-{}, averaged over trials and channels, "
          "peaks at {:.0f} Hz, {} bins off (each channel alone: {:.0f}-{:.0f} Hz)".format(
              peak, N_CHANNELS - 1, top * FS / N_SAMPLES, off, hz.min(), hz.max()))
    if off > SYNTH_PEAK_BINS:
        raise AssertionError("AR(2) peak more than {} bins off".format(SYNTH_PEAK_BINS))
    data, _ = host_wall("readback of the generated data", lambda: x.reshape(-1, N_CHANNELS).cpu()
                        .numpy(), out_bytes)
    del x, power
    torch.cuda.empty_cache()
    trl = np.column_stack([np.arange(N_TRIALS) * N_SAMPLES, np.arange(1, N_TRIALS + 1)
                           * N_SAMPLES, np.zeros(N_TRIALS)])
    mem = spt.from_arrays(data, trl, FS)
    labels = np.asarray(mem.channel)

    # -- b. the container round trip
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    loaded = mem
    try:
        if have_h5py:
            container = os.path.join(tmp, "synth.spy")
            host_wall("save AnalogData container", lambda: spt.save(
                spt.from_arrays(data, trl, FS), container=container), data.nbytes)
            loaded, _ = host_wall("load (open)", lambda: spt.load(container))
            back, summary["load_s"] = host_wall("load: read the payload", lambda: np.asarray(
                loaded.data), data.nbytes)
            bitwise("loaded payload", back, data)
            del back
            bitwise("loaded trialdefinition", loaded.trialdefinition, mem.trialdefinition)
            if list(loaded.channel) != list(labels) or loaded.samplerate != FS:
                raise AssertionError("loaded labels or samplerate differ")
            host_wall("load(checksum=True)", lambda: spt.load(container, checksum=True), data.nbytes)
        else:
            print("16b container round trip: not run: h5py is not installed on this machine")

        # -- c. the methods, on the loaded object
        bitwise("a * 1e-6 + a", (loaded * 1e-6 + loaded).data, data * 1e-6 + data)
        bitwise("a - a", (loaded - loaded).data, data - data)
        bitwise("a / 2.0", (loaded / 2.0).data, data / 2.0)
        half = N_CHANNELS // 2
        joined = spt.concat(loaded.selectdata(channel=list(range(half))),
                            loaded.selectdata(channel=list(range(half, N_CHANNELS))), dim="channel")
        bitwise("concat of the channel halves", joined.data, data)
        joined = spt.AnalogData([mem.selectdata(trials=list(range(N_TRIALS // 2))),
                                 mem.selectdata(trials=list(range(N_TRIALS // 2, N_TRIALS)))])
        bitwise("the trial halves joined", joined.data, data)
        bitwise("their trialdefinition", joined.trialdefinition, mem.trialdefinition)
        del joined
        short = N_SAMPLES // 2
        trl2 = np.column_stack([np.arange(2 * N_TRIALS) * short, np.arange(1, 2 * N_TRIALS + 1)
                                * short, np.zeros(2 * N_TRIALS)])
        redef = spt.redefinetrial(loaded, trl=trl2)
        bitwise("redefinetrial into {} x {}: trialdefinition".format(2 * N_TRIALS, short),
                redef.trialdefinition, trl2)
        for k in (0, 1, N_TRIALS - 1, 2 * N_TRIALS - 2, 2 * N_TRIALS - 1):
            bitwise("redefinetrial trial {}".format(k), redef.trials[k],
                    data[k * short:(k + 1) * short])
        del redef

        # -- d. coherence from the container
        coh, stats, cr = captured_call("coh of the {} object".format(
            "loaded" if have_h5py else "in-memory"), lambda: spt.connectivityanalysis(
                loaded, method="coh", tapsmofrq=2), expect={"csd_accumulate_tiled": 1})
        summary["launches"] = 1
        summary["first"] = stats[0]
        summary["wall"] = warm_wall("coh of the {} object".format(
            "loaded" if have_h5py else "in-memory"), lambda: spt.connectivityanalysis(
                loaded, method="coh", tapsmofrq=2), reps=3)
        sources = [("from memory (phase 6's path)", mem)]
        if loaded is not mem:
            sources.insert(0, ("from the container", loaded))
        for name, obj in sources:
            ms, _ = engine_stages(cr, obj)
            summary["stages " + name] = ms
            print("coh stages {} (ms, synchronized): {}".format(
                name, ", ".join("{} {:.3f}".format(k, v) for k, v in ms.items())))
        bitwise("coh of the {} object against a call on the in-memory one".format(
            "loaded" if have_h5py else "in-memory"), coh.data, spt.connectivityanalysis(
                mem, method="coh", tapsmofrq=2).data)
        got = np.asarray(coh.data)[0]
        oracle = coherence_f64(data, taper, taper_opt)
        summary["coh_err"] = float(np.abs(got - oracle).max())
        print("coh of the synthetic data: max abs err vs float64 {:.3e}".format(summary["coh_err"]))
        if not summary["coh_err"] < COH_ABS_TOL:
            raise AssertionError("coh err {:.3e} >= {}".format(summary["coh_err"], COH_ABS_TOL))
        f = int(np.argmin(np.abs(np.asarray(coh.freq) - peak)))
        driven, uncoupled = got[f, 1, 0], got[f, 2, 3]
        print("coh at {:.0f} Hz: 1 -> 0 {:.4f} (float64 {:.4f}, bar > {}), uncoupled 2 - 3 {:.4f} "
              "(float64 {:.4f}, bar < {})".format(np.asarray(coh.freq)[f], driven, oracle[f, 1, 0],
                                                  SYNTH_COH_DRIVEN_MIN, uncoupled, oracle[f, 2, 3],
                                                  SYNTH_COH_UNCOUPLED_MAX))
        if not (driven > SYNTH_COH_DRIVEN_MIN and uncoupled < SYNTH_COH_UNCOUPLED_MAX):
            raise AssertionError("coh at the AR(2) peak outside its bars")
        del oracle
        if have_h5py:
            result = os.path.join(tmp, "coh.spy")
            saved = coh.copy()
            host_wall("save CrossSpectralData container", lambda: spt.save(saved, container=result))
            back = spt.load(result, checksum=True)
            bitwise("loaded coherence", back.data, coh.data)
            bitwise("its freq", back.freq, coh.freq)
            del back, saved

        # -- e. NWB and plot (host work)
        if have_h5py:
            few = mem.selectdata(trials=list(range(NWB_TRIALS)))
            nwb = os.path.join(tmp, "first{}.nwb".format(NWB_TRIALS))
            host_wall("save_nwb of {} trials".format(NWB_TRIALS), lambda: few.save_nwb(nwb),
                      few.data.nbytes)
            back, _ = host_wall("load_nwb", lambda: spt.load_nwb(nwb))
            got, want = np.asarray(back.data), np.asarray(few.data)
            err = float(np.abs(got - want).max() / np.abs(want).max())
            print("NWB round trip: {} {}, max err {:.3e} of the maximum (bar: one float32 ulp, "
                  "{:.3e})".format(got.dtype, got.shape, err, np.finfo(np.float32).eps))
            if got.shape != want.shape or not err <= np.finfo(np.float32).eps:
                raise AssertionError("NWB round trip outside float32 rounding")
            bitwise("NWB trialdefinition", back.trialdefinition, few.trialdefinition)
            del back, few
        else:
            print("16e NWB export: not run: h5py is not installed on this machine")
        if have_mpl:
            import matplotlib

            matplotlib.use("Agg")
            png = os.path.join(tmp, "coh.png")

            def plot():
                fig, _ = spt.singlepanelplot(coh, channel_i=1, channel_j=0)
                fig.savefig(png)
                return os.path.getsize(png)

            size, _ = host_wall("singlepanelplot of the coherence to PNG", plot)
            print("coherence PNG: {} bytes".format(size))
        else:
            print("16e plot: not run: matplotlib is not installed on this machine")
        del coh, cr, loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 16 calls and oracles: {:.1f} s".format(time.perf_counter() - t_phase))
    return summary


#: phase 17's bars: a chain whose consumer splits the producer's records
#: against the host route's chain (the fused trial sum runs in another
#: order; absolute, on the coherence), and the plot view against the host
#: box average of the read-back trial (relative to the view's maximum)
SPLIT_ABS_TOL = 1e-6
VIEW_REL_TOL = 1e-5
#: phase 17a/b: timed calls of each route
EXTRAS_REPS = 3


def plan_text(cr):
    """One routine's chunk plan: per bucket, where its chunks came from,
    the chunk size and the valid rows of each chunk."""
    return "; ".join("{} {}: chunk {}, rows {}".format(
        cr.__class__.__name__, p["source"], p["chunk"], p["rows"]) for p in cr.chunk_plan)


def transfer_text(counts):
    return ("host-to-device {h2d} B (auxiliary inputs {h2d_aux} B), device-to-host {d2h} B "
            "(per-trial info {d2h_aux} B)".format(**counts))


def extras_phase(spt, data, trl, coh64):
    """Phase 17: the engine extras on the north-star data, each route
    measured in this run. a: BASELINE config #5's chain (band-pass,
    resample to 250 Hz, coherence) with its intermediates resident against
    the same chain with residency off; b: the trial store (timelockanalysis
    with covariance and phase 6's coherence, cold and cached); c: the plot
    view of a resident Morlet TFR; d: the HDF5 spill where h5py is
    installed. Returns the kernel launches of a's resident chain."""
    import gc

    import torch

    from syncopy_tpu_torch.engine import resident, routine
    from syncopy_tpu_torch.engine.resident import DeferredArray
    from syncopy_tpu_torch.engine.routine import ComputationalRoutine

    t_phase = time.perf_counter()
    stack_gb = JACK_COH_TRIALS * 501 * N_CHANNELS * N_CHANNELS * 8 / 1e9
    print("phase 17: resident budget {} B ({:.3f} GiB), trial store {} B ({:.3f} GiB), host "
          "budget {} B ({:.3f} GiB); phase 9's single-trial CSD stack ({} trials, {:.3f} GB) "
          "{} resident".format(
              resident.RESIDENT_BUDGET, resident.RESIDENT_BUDGET / 2**30,
              routine.DEVICE_CACHE_BYTES, routine.DEVICE_CACHE_BYTES / 2**30,
              routine.DEFAULT_HOST_BUDGET, routine.DEFAULT_HOST_BUDGET / 2**30,
              JACK_COH_TRIALS, stack_gb,
              "goes" if stack_gb * 1e9 <= resident.RESIDENT_BUDGET else "does not go"))
    adata = spt.from_arrays(data, trl, FS)
    input_bytes = data.nbytes

    # -- a. the chain, resident and with residency off
    def chain():
        bp = spt.preprocessing(adata, filter_class="but", filter_type="bp", freq=[30, 100],
                               order=4)
        rs = spt.resampledata(bp, resamplefs=250)
        return bp, rs, spt.connectivityanalysis(rs, method="coh", tapsmofrq=2)

    def checked_chain(route):
        """One call of the chain with the store empty and the counters at
        0: its outputs, routines (band-pass, resample, cross spectra),
        launches and transfers."""
        routines, initialize = [], ComputationalRoutine.initialize

        def keep(self, *args, **kwargs):
            routines.append(self)
            return initialize(self, *args, **kwargs)

        gc.collect()
        clear_store()
        zero_launches()
        routine.reset_transfer_counts()
        ComputationalRoutine.initialize = keep
        try:
            out = chain()
            torch.cuda.synchronize()
        finally:
            ComputationalRoutine.initialize = initialize
        counts = routine.transfer_counts()
        bp_cr, rs_cr, coh_cr = routines
        expect = {"sosfiltfilt": len(bp_cr.chunk_plan[0]["rows"]),
                  "csd_accumulate_tiled": len(coh_cr.chunk_plan[0]["rows"])}
        launches = read_launches("17a chain, " + route, expect)
        print("17a chain, {}: {}".format(route, transfer_text(counts)))
        for cr in routines:
            print("17a chain, {}: {}".format(route, plan_text(cr)))
        return out, routines, launches, counts

    (bp, rs, coh), crs, launches, counts = checked_chain("resident")
    for name, obj in (("band-passed", bp), ("resampled", rs)):
        if not isinstance(obj._data, DeferredArray) or obj._device_resident.materialized:
            raise AssertionError("17a: the {} data was read back".format(name))
    if [cr.chunk_plan[0]["source"] for cr in crs] != ["upload", "resident", "resident"]:
        raise AssertionError("17a: the chain did not consume its resident records")
    bp_chunks = crs[0].chunk_plan[0]
    one_upload = len(bp_chunks["rows"]) * bp_chunks["chunk"] * N_SAMPLES * N_CHANNELS * 4
    if counts["h2d"] != one_upload or counts["h2d_aux"] or counts["d2h"] != coh.data.nbytes:
        raise AssertionError("17a: transfers {}; expected one upload of {} B and {} B of "
                             "coherence back".format(counts, one_upload, coh.data.nbytes))
    print("17a: one upload of the {} B input ({} B with the chunk's padding rows), {} B of "
          "coherence back; intermediates still on the card".format(
              input_bytes, one_upload, coh.data.nbytes))
    got = np.asarray(coh.data)[0]
    err = float(np.abs(got - coh64).max())
    print("17a: resident chain's coherence against the float64 chain: max abs err "
          "{:.3e}".format(err))
    if not err < COH_ABS_TOL:
        raise AssertionError("17a: coherence err {:.3e} >= {}".format(err, COH_ABS_TOL))
    t0 = time.perf_counter()
    bp_host = np.asarray(bp.data)
    bp_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    rs_host = np.asarray(rs.data)
    rs_ms = 1e3 * (time.perf_counter() - t0)
    print("17a: reading the intermediates back afterwards: band-passed {} B in {:.3f} ms "
          "({:.3f} GB/s), resampled {} B in {:.3f} ms ({:.3f} GB/s)".format(
              bp_host.nbytes, bp_ms, bp_host.nbytes / 1e6 / bp_ms, rs_host.nbytes, rs_ms,
              rs_host.nbytes / 1e6 / rs_ms))
    del bp, rs, coh

    saved_budget = resident.RESIDENT_BUDGET
    resident.RESIDENT_BUDGET = 0
    try:
        (bp_off, rs_off, coh_off), crs_off, _, counts_off = checked_chain("residency off")
    finally:
        resident.RESIDENT_BUDGET = saved_budget
    # the consumers ran the host route's chunks: bitwise; else they split
    # the producers' records and sum in another order
    unsplit = all([(p["chunk"], p["rows"]) for p in a.chunk_plan]
                  == [(p["chunk"], p["rows"]) for p in b.chunk_plan]
                  for a, b in zip(crs[1:], crs_off[1:]))
    same = [np.array_equal(a, b) for a, b in (
        (bp_host, np.asarray(bp_off.data)), (rs_host, np.asarray(rs_off.data)),
        (got, np.asarray(coh_off.data)[0]))]
    diff = float(np.abs(got - np.asarray(coh_off.data)[0]).max())
    print("17a: against the residency-off chain: band-passed, resampled, coherence bitwise "
          "equal {}; coherence max abs diff {:.3e}; the consumers {} the producers' "
          "records".format(same, diff, "took unsplit" if unsplit else "split"))
    if unsplit and not all(same):
        raise AssertionError("17a: the resident chain is not bitwise equal to the host route")
    if not unsplit and not (same[0] and diff <= SPLIT_ABS_TOL):
        raise AssertionError("17a: split chain differs by {:.3e} > {}".format(
            diff, SPLIT_ABS_TOL))
    del bp_off, rs_off, coh_off, rs_host

    walls = {"resident": [], "residency off": []}
    for _ in range(EXTRAS_REPS):
        for route in walls:
            gc.collect()
            clear_store()
            resident.RESIDENT_BUDGET = saved_budget if route == "resident" else 0
            try:
                t0 = time.perf_counter()
                out = chain()
                torch.cuda.synchronize()
                walls[route].append(time.perf_counter() - t0)
            finally:
                resident.RESIDENT_BUDGET = saved_budget
            del out
    summary = {"iir_launches": launches["sosfiltfilt"],
               "csd_launches": launches["csd_accumulate_tiled"], "chain_err": err, "coh": got}
    for route, ws in walls.items():
        summary[route] = statistics.median(ws)
        print("17a chain warm wall, {}: median {:.4f} s of {} ({})".format(
            route, statistics.median(ws), len(ws), ", ".join("{:.4f}".format(w) for w in ws)))
    clear_store()

    # -- b. the trial store
    bp_host = spt.from_arrays(bp_host, trl, FS)
    for name, call in (
            ("timelockanalysis covariance (phase 15e's call)",
             lambda: spt.timelockanalysis(bp_host, covariance=True)),
            ("coh (phase 6's call)",
             lambda: spt.connectivityanalysis(adata, method="coh", tapsmofrq=2))):
        clear_store()
        results = {}
        for kind in ("cold", "cached"):
            ws, uploads = [], []
            for _ in range(EXTRAS_REPS):
                if kind == "cold":
                    clear_store()
                routine.reset_transfer_counts()
                t0 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                ws.append(time.perf_counter() - t0)
                counts = routine.transfer_counts()
                uploads.append(counts["h2d"])
                results.setdefault(kind, out)
            print("17b {} {}: median {:.4f} s of {} ({}); payload uploaded {} B a call, "
                  "auxiliary inputs {} B".format(
                      name, kind, statistics.median(ws), len(ws),
                      ", ".join("{:.4f}".format(w) for w in ws), uploads, counts["h2d_aux"]))
            summary["{} {}".format(name.split()[0], kind)] = statistics.median(ws)
            if kind == "cached" and any(uploads):
                raise AssertionError("17b: the cached {} uploaded {} B".format(name, uploads))
        a, b = results["cold"], results["cached"]
        pairs = ([(a.avg, b.avg), (a.var, b.var), (a.cov, b.cov)] if hasattr(a, "avg")
                 else [(a.data, b.data)])
        if not all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in pairs):
            raise AssertionError("17b: the cached {} differs from the cold one".format(name))
        del results, a, b, out
    del bp_host
    clear_store()

    # -- c. the plot view of a resident Morlet TFR (phase 14's call)
    wdata = spt.from_arrays(data[: WAVELET_TRIALS * N_SAMPLES], trl[:WAVELET_TRIALS], FS)
    tf_walls = []
    for _ in range(EXTRAS_REPS):
        tf = None
        clear_store()
        t0 = time.perf_counter()
        tf = spt.freqanalysis(wdata, method="wavelet", foi=np.linspace(10, 150, 30),
                              toi="all", output="pow")
        torch.cuda.synchronize()
        tf_walls.append(time.perf_counter() - t0)
    tf_wall = statistics.median(tf_walls)
    res = tf._device_resident
    if res is None or res.materialized:
        raise AssertionError("17c: the TFR did not stay on the card")
    views, view_ms = [], []
    for pos, max_time in ((0, 1024), (WAVELET_TRIALS - 1, 1024), (7, 128)):
        routine.reset_transfer_counts()
        t0 = time.perf_counter()
        view, factor = res.fetch_trial_view(pos, max_time=max_time)
        ms = 1e3 * (time.perf_counter() - t0)
        nbytes = routine.transfer_counts()["d2h"]
        views.append((pos, factor, view))
        view_ms.append(ms)
        print("17c view of trial {} at max_time {}: factor {}, shape {}, {} B back in {:.3f} "
              "ms".format(pos, max_time, factor, view.shape, nbytes, ms))
    routine.reset_transfer_counts()
    t0 = time.perf_counter()
    full = np.asarray(tf.data)
    full_ms = 1e3 * (time.perf_counter() - t0)
    print("17c: the TFR call resident-only median {:.4f} s of {} ({}); reading all of it back "
          "{} B in {:.3f} ms ({:.3f} GB/s)".format(
              tf_wall, len(tf_walls), ", ".join("{:.4f}".format(w) for w in tf_walls),
              routine.transfer_counts()["d2h"], full_ms, full.nbytes / 1e6 / full_ms))
    for pos, factor, view in views:
        trial = full[pos * N_SAMPLES : (pos + 1) * N_SAMPLES]
        t_out = N_SAMPLES // factor
        want = trial[: t_out * factor].reshape((t_out, factor) + trial.shape[1:]).mean(axis=1)
        verr = float(np.abs(view - want).max() / np.abs(want).max())
        print("17c view of trial {} against the host box average of the read-back trial: max "
              "err {:.3e} of its maximum".format(pos, verr))
        if not verr < VIEW_REL_TOL:
            raise AssertionError("17c: view err {:.3e} >= {}".format(verr, VIEW_REL_TOL))
    summary["view_ms"], summary["full_readback_ms"] = view_ms[0], full_ms
    del tf, res, full, wdata
    clear_store()

    # -- d. the HDF5 spill
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is None:
        print("17d: the HDF5 spill: not run on this machine (no h5py); "
              "tests/test_torch_streaming.py holds it on the CPU")
    else:
        few = 64
        mini = spt.from_arrays(data[: few * N_SAMPLES], trl[:few], FS)
        ref = np.asarray(spt.preprocessing(mini, filter_class="but", filter_type="bp",
                                           freq=[30, 100], order=4).data)
        saved_host = routine.DEFAULT_HOST_BUDGET
        routine.DEFAULT_HOST_BUDGET = ref.nbytes // 2
        try:
            out = spt.preprocessing(mini, filter_class="but", filter_type="bp",
                                    freq=[30, 100], order=4)
            t0 = time.perf_counter()
            spilled = out.data[()]
            spill_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            routine.DEFAULT_HOST_BUDGET = saved_host
        if not isinstance(out.data, h5py.Dataset) or not np.array_equal(spilled, ref):
            raise AssertionError("17d: the spill did not land in HDF5, or differs")
        print("17d: a {} B band-passed result over a host budget of half its size, read back "
              "into an HDF5 dataset: bitwise; reading the dataset {:.3f} ms".format(
                  ref.nbytes, spill_ms))
        del out, mini
    print("phase 17 calls and oracles: {:.1f} s".format(time.perf_counter() - t_phase))
    return summary


#: phase 18's bars: each sharded result against the unsharded one on the
#: card (absolute for coherence and PPC, relative to the unsharded
#: maximum for the band-pass, the FIR, the STFT and the CWT, absolute for
#: Granger); against float64 the bars of phases 6, 7 and 15c
MESH_ABS_TOL = 1e-6
MESH_REL_TOL = 1e-6
HALO_REL_TOL = 1e-5
MESH_GRANGER_ABS_TOL = 1e-6
#: phase 18's CWT: 30 Morlet(6) frequencies from 10 to 150 Hz on the long
#: recording (30 x 250000 x 64 complex64, 3.84 GB out); its STFT windows
MESH_CWT_FREQS, MESH_STFT_NPERSEG = np.linspace(10.0, 150.0, 30), 64


def routines_of(fn):
    """`fn()` and the compute routines its frontends initialized, in
    order."""
    from syncopy_tpu_torch.engine.routine import ComputationalRoutine

    routines, initialize = [], ComputationalRoutine.initialize

    def keep(self, *args, **kwargs):
        routines.append(self)
        return initialize(self, *args, **kwargs)

    ComputationalRoutine.initialize = keep
    try:
        return fn(), routines
    finally:
        ComputationalRoutine.initialize = initialize


def shard_launches(cr, fused):
    """The launches a routine's chunk plan calls for: every trial shard of
    every chunk for a fused trial sum (an all-padding one with n_valid =
    0), every shard that holds rows otherwise."""
    return sum(sum(1 for nv in rows if fused or nv > 0)
               for p in cr.chunk_plan for rows in p["shard_rows"])


def timed_pair(name, solo, sharded):
    """One more synchronized call of each of the two routes, unsharded
    first; prints both walls. Returns them."""
    import torch

    walls = []
    for fn in (solo, sharded):
        clear_store()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        settle(res)
        walls.append(time.perf_counter() - t0)
        del res
    print("18 {}: wall unsharded {:.4f} s, sharded {:.4f} s ({:+.1f}%)".format(
        name, walls[0], walls[1], 100 * (walls[1] / walls[0] - 1)))
    return walls


def mesh_phase(spt, refs, chain_coh64, chain_coh, granger_csd):
    """Phase 18: the mesh on one card. a: coh and ppc on the north-star
    data on a 4-position trial mesh over cuda:0 and a 2 x 2 trial x
    channel mesh: one kernel launch per trial shard and chunk, each
    shard's valid rows, the bytes across the host link, within 1e-6 of
    phases 6/7 and 1e-5 of their float64 results, walls of both routes;
    b: the band-pass of phase 15b on the 4-position mesh, one Butterworth
    launch per shard and chunk, within 1e-6 of the unsharded result; c:
    config #5's chain resident on the mesh (one upload, only the
    coherence back), within 1e-5 of phase 15c's float64 chain and 1e-6 of
    phase 17a's resident chain; d: the five sharded routines on phase 15a's
    (250000, 64) recording against the port's unsharded functions; e: coh
    over the real cards where more than one is visible. `refs` maps
    "coh" and "ppc" to phase 6's and 7's results and their float64
    computations. Returns the launches of its main paths."""
    import torch

    from syncopy_tpu_torch.engine import routine
    from syncopy_tpu_torch.engine.resident import DeferredArray
    from syncopy_tpu_torch.ops import connectivity as pc
    from syncopy_tpu_torch.ops import filtering as fb
    from syncopy_tpu_torch.ops import stft as ps
    from syncopy_tpu_torch.ops import wavelet as pw
    from syncopy_tpu_torch.ops.windows import make_tapers

    t_phase = time.perf_counter()
    data, trl = north_star_data()
    adata = spt.from_arrays(data, trl, FS)
    meshes = {"4 x 1 on cuda:0": spt.make_mesh(n_trial=4, devices=["cuda:0"] * 4),
              "2 x 2 on cuda:0": spt.make_mesh(n_trial=2, n_channel=2, devices=["cuda:0"] * 4)}
    launches = {"csd_accumulate_tiled": 0, "ppc_accumulate_tiled": 0, "sosfiltfilt": 0}

    # -- a. coh and ppc on the two meshes
    for method, kernel, tol64 in (("coh", "csd_accumulate_tiled", COH_ABS_TOL),
                                  ("ppc", "ppc_accumulate_tiled", PPC_ABS_TOL)):
        ref, ref64 = refs[method]
        for mesh_name, mesh in meshes.items():
            clear_store()
            zero_launches()
            routine.reset_transfer_counts()
            with spt.use_mesh(mesh):
                out, crs = routines_of(lambda: spt.connectivityanalysis(
                    adata, method=method, tapsmofrq=2))
                torch.cuda.synchronize()
            counts = routine.transfer_counts()
            cr = crs[0]
            expect = shard_launches(cr, fused=True)
            got_launches = read_launches("18a {} on {}".format(method, mesh_name),
                                         {kernel: expect})
            launches[kernel] += got_launches[kernel]
            n_shard = mesh.shape["trial"]
            if expect != len(cr.chunk_plan[0]["rows"]) * n_shard:
                raise AssertionError("18a: {} launches for {} chunks of {} shards".format(
                    expect, len(cr.chunk_plan[0]["rows"]), n_shard))
            got = np.asarray(out.data)[0]
            diff = float(np.abs(got - ref).max())
            err = float(np.abs(got - ref64).max())
            upload = sum(p["chunk"] * len(p["rows"]) for p in cr.chunk_plan) * \
                N_SAMPLES * N_CHANNELS * 4
            print("18a {} on {}: {} launches ({} chunk(s) x {} trial shards), valid rows a "
                  "shard {}; {}; max abs diff to the unsharded result {:.3e}, err vs float64 "
                  "{:.3e}".format(method, mesh_name, expect, len(cr.chunk_plan[0]["rows"]),
                                  n_shard, cr.chunk_plan[0]["shard_rows"],
                                  transfer_text(counts), diff, err))
            if counts["h2d"] != upload:
                raise AssertionError("18a: uploaded {} B, expected {} B".format(
                    counts["h2d"], upload))
            if not (np.isfinite(got).all() and diff <= MESH_ABS_TOL and err < tol64):
                raise AssertionError("18a: {} on {} off by {:.3e} (unsharded) / {:.3e} "
                                     "(float64)".format(method, mesh_name, diff, err))
            del out
        with spt.use_mesh(meshes["4 x 1 on cuda:0"]):
            sharded = lambda: spt.connectivityanalysis(adata, method=method, tapsmofrq=2)  # noqa
            timed_pair("{} (4 x 1 mesh)".format(method), lambda: spt.connectivityanalysis(
                adata, method=method, tapsmofrq=2, parallel=False), sharded)

    # -- b. the band-pass on the 4-position mesh
    mesh4 = meshes["4 x 1 on cuda:0"]
    bp_call = lambda: spt.preprocessing(  # noqa: E731
        adata, filter_class="but", filter_type="bp", freq=[30, 100], order=4)
    clear_store()
    solo = np.asarray(bp_call().data)
    clear_store()
    zero_launches()
    with spt.use_mesh(mesh4):
        out, crs = routines_of(bp_call)
        torch.cuda.synchronize()
    expect = shard_launches(crs[0], fused=False)
    launches["sosfiltfilt"] += read_launches("18b band-pass on the 4 x 1 mesh",
                                             {"sosfiltfilt": expect})["sosfiltfilt"]
    got = np.asarray(out.data)
    diff = float(np.abs(got - solo).max() / np.abs(solo).max())
    print("18b band-pass on the 4 x 1 mesh: {} launches for {} chunk(s) (rows a shard {}); "
          "max diff to the unsharded result {:.3e} of its maximum".format(
              expect, len(crs[0].chunk_plan[0]["rows"]), crs[0].chunk_plan[0]["shard_rows"],
              diff))
    if not diff <= MESH_REL_TOL:
        raise AssertionError("18b: band-pass off by {:.3e}".format(diff))
    del out, solo, got
    with spt.use_mesh(mesh4):
        timed_pair("band-pass (4 x 1 mesh)", lambda: spt.preprocessing(
            adata, filter_class="but", filter_type="bp", freq=[30, 100], order=4,
            parallel=False), bp_call)

    # -- c. config #5's chain, resident on the mesh
    def chain():
        bp = spt.preprocessing(adata, filter_class="but", filter_type="bp", freq=[30, 100],
                               order=4)
        rs = spt.resampledata(bp, resamplefs=250)
        return bp, rs, spt.connectivityanalysis(rs, method="coh", tapsmofrq=2)

    clear_store()
    zero_launches()
    routine.reset_transfer_counts()
    with spt.use_mesh(mesh4):
        (bp, rs, coh), crs = routines_of(chain)
        torch.cuda.synchronize()
    counts = routine.transfer_counts()
    expect = {"sosfiltfilt": shard_launches(crs[0], fused=False),
              "csd_accumulate_tiled": shard_launches(crs[2], fused=True)}
    got_launches = read_launches("18c chain on the 4 x 1 mesh", expect)
    launches["sosfiltfilt"] += got_launches["sosfiltfilt"]
    launches["csd_accumulate_tiled"] += got_launches["csd_accumulate_tiled"]
    for name, obj in (("band-passed", bp), ("resampled", rs)):
        if not isinstance(obj._data, DeferredArray) or obj._device_resident.materialized:
            raise AssertionError("18c: the {} data was read back".format(name))
        shards = {len(r.shards) for r in obj._device_resident.records}
        print("18c: {} records hold {} tensor(s) each".format(name, sorted(shards)))
    if [cr.chunk_plan[0]["source"] for cr in crs] != ["upload", "resident", "resident"]:
        raise AssertionError("18c: the chain did not consume its resident records")
    one_upload = sum(p["chunk"] * len(p["rows"]) for p in crs[0].chunk_plan) * \
        N_SAMPLES * N_CHANNELS * 4
    got = np.asarray(coh.data)[0]
    if counts["h2d"] != one_upload or counts["h2d_aux"] or counts["d2h"] != coh.data.nbytes:
        raise AssertionError("18c: transfers {}; expected one upload of {} B".format(
            counts, one_upload))
    err = float(np.abs(got - chain_coh64).max())
    diff = float(np.abs(got - chain_coh).max())
    print("18c chain on the 4 x 1 mesh: {}; coherence err vs the float64 chain {:.3e}, max abs "
          "diff to phase 17a's resident chain {:.3e}".format(transfer_text(counts), err, diff))
    for cr in crs:
        print("18c: {}".format(plan_text(cr)))
    if not (err < COH_ABS_TOL and diff <= MESH_ABS_TOL):
        raise AssertionError("18c: chain off by {:.3e} / {:.3e}".format(err, diff))
    del bp, rs, coh
    walls = []
    for _ in range(EXTRAS_REPS):
        clear_store()
        t0 = time.perf_counter()
        with spt.use_mesh(mesh4):
            out = chain()
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del out
    print("18c chain warm wall on the 4 x 1 mesh, resident: median {:.4f} s of {} ({})".format(
        statistics.median(walls), len(walls), ", ".join("{:.4f}".format(w) for w in walls)))

    # -- d. the five sharded routines on one long recording
    clear_store()
    y = np.random.default_rng(1).normal(size=(LONG_TRIAL_SAMPLES, N_CHANNELS)).astype("f4")
    y_dev = torch.from_numpy(y).to("cuda")
    dt = 1.0 / FS

    def rel(sharded, whole):
        got = sharded.gather("cuda")
        return ((got - whole).abs().max() / whole.abs().max()).item()

    fir = fb.design_wsinc("hamming", 400, np.array([8.0, 12.0]) / FS, "bp")
    tapers = make_tapers("hann", None, MESH_STFT_NPERSEG, MESH_STFT_NPERSEG, FS)
    scales = pw.Morlet(6).scale_from_period(1.0 / MESH_CWT_FREQS)
    cases = [
        ("apply_fir_time_sharded (order 400 band-pass)",
         lambda: fb.apply_fir(y_dev[None], fir)[0],
         lambda: fb.apply_fir_time_sharded(y_dev, fir, mesh4)),
        ("mtmconvol_time_sharded (hann, {} samples, power)".format(MESH_STFT_NPERSEG),
         lambda: ps.mtmconvol(y_dev[None], torch.from_numpy(tapers), MESH_STFT_NPERSEG, hop=1,
                              n_time=LONG_TRIAL_SAMPLES, output="pow", keeptapers=False)[0],
         lambda: ps.mtmconvol_time_sharded(y_dev, tapers, MESH_STFT_NPERSEG, mesh4,
                                           output="pow", keeptapers=False)),
        ("cwt_time_sharded (Morlet(6), 30 frequencies)",
         lambda: pw.cwt(y_dev, pw.Morlet(6), scales, dt),
         lambda: pw.cwt_time_sharded(y_dev, pw.Morlet(6), scales, dt, mesh4)),
    ]
    long_errs = {}
    for name, solo_fn, sharded_fn in cases:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        whole = solo_fn()
        sharded = sharded_fn()
        torch.cuda.synchronize()
        err = rel(sharded, whole)
        long_errs[name] = err
        print("18d {}: {} blocks of {}, max diff to the unsharded function {:.3e} of its "
              "maximum; peak device memory {:.3f} GB".format(
                  name, len(sharded), tuple(sharded[0].shape), err,
                  torch.cuda.max_memory_allocated() / 1e9))
        if not err < HALO_REL_TOL:
            raise AssertionError("18d: {} off by {:.3e}".format(name, err))
        del whole, sharded
        torch.cuda.empty_cache()
        timed_pair(name, solo_fn, sharded_fn)
        torch.cuda.empty_cache()
    del y_dev

    csd = torch.from_numpy(granger_csd).to("cuda", torch.complex128)

    def granger_solo():
        reg = pc.regularize_csd(csd, cond_max=1e4, eps_max=1e-1)[0]
        H, Sigma, conv, err, _ = pc.wilson_sf(reg, nIter=100, rtol=5e-6)
        return pc.granger(reg, H, Sigma), bool(conv), float(err)

    G0, conv0, err0 = granger_solo()
    G1, info = pc.granger_sharded(csd, mesh=mesh4)
    g_diff = (G1 - G0).abs().max().item()
    print("18d granger_sharded (phase 8's 64-channel CSD, wilson_sf_sharded inside): info {}; "
          "unsharded converged {} err {:.3e}; max abs diff to the unsharded route "
          "{:.3e}".format(info, conv0, err0, g_diff))
    if not (info["converged"] and conv0 and g_diff < MESH_GRANGER_ABS_TOL):
        raise AssertionError("18d: granger_sharded off by {:.3e}".format(g_diff))
    timed_pair("granger_sharded (64 channels)", lambda: granger_solo()[0],
               lambda: pc.granger_sharded(csd, mesh=mesh4)[0])
    del csd, G0, G1

    # -- e. the real cards
    if torch.cuda.device_count() > 1:
        for kernel, count in cards_phase(spt, adata, refs["coh"][0]).items():
            launches[kernel] += count
    else:
        print("18e coh over the real cards: not run: one card")
    del data, adata
    clear_store()
    print("phase 18 calls and oracles: {:.1f} s".format(time.perf_counter() - t_phase))
    return launches


def cards_phase(spt, adata, coh_ref):
    """Phase 18e: the mesh over the real cards. Each kernel launched on
    every card from a thread whose current device is cuda:0, against its
    plain version there (its library, loaded once per process, launches on
    the tensor's device and that device's current stream); then coh, ppc
    and phase 15b's band-pass on a trial mesh over all cards: one kernel
    launch per trial shard (that holds rows, for the band-pass) and chunk,
    within 1e-6 of the unsharded result (coh also of phase 6's), both
    walls (median of 3). Returns the launches of its frontend calls."""
    import torch

    from syncopy_tpu_torch.engine.routine import ComputationalRoutine
    from syncopy_tpu_torch.ops import csd_kernels as ck
    from syncopy_tpu_torch.ops import filtering as fb
    from syncopy_tpu_torch.ops import iir_kernels as ik
    from syncopy_tpu_torch.ops import ppc_kernels as pk

    n_cards = torch.cuda.device_count()
    g = torch.Generator().manual_seed(0)
    spec = torch.randn(600, 101, N_CHANNELS, dtype=torch.complex64, generator=g)
    spec4 = torch.randn(300, 3, 101, N_CHANNELS, dtype=torch.complex64, generator=g)
    x = torch.randn(40, N_SAMPLES, N_CHANNELS, generator=g)
    sos = fb.butter_sos(4, [30.0, 100.0], "bp", FS)
    for k in range(n_cards):
        dev = torch.device("cuda", k)
        with torch.cuda.device(0):
            got = [ck.csd_accumulate_tiled(spec.to(dev), 555),
                   pk.ppc_accumulate_tiled(spec4.to(dev), 277),
                   ik.sosfilt_batch(x.to(dev), sos)]
        want = [ck.csd_accumulate_tiled_plain(spec.to(dev), 555),
                pk.ppc_accumulate_tiled_plain(spec4.to(dev), 277),
                ik.sosfilt_batch_plain(x.to(dev), sos, True)]
        errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]
        print("18e cuda:{}: csd, ppc and sosfiltfilt kernels against their plain versions "
              "{}".format(k, ", ".join("{:.3e}".format(e) for e in errs)))
        if any(a.device != dev for a in got) or not max(errs) < KERNEL_REL_TOL:
            raise AssertionError("18e cuda:{}: a kernel ran elsewhere or disagrees".format(k))
    mesh = spt.make_mesh()
    launches = {"csd_accumulate_tiled": 0, "ppc_accumulate_tiled": 0, "sosfiltfilt": 0}
    for name, kernel, fused, call in (
            ("coh", "csd_accumulate_tiled", True, lambda **kw: spt.connectivityanalysis(
                adata, method="coh", tapsmofrq=2, **kw)),
            ("ppc", "ppc_accumulate_tiled", True, lambda **kw: spt.connectivityanalysis(
                adata, method="ppc", tapsmofrq=2, **kw)),
            ("band-pass", "sosfiltfilt", False, lambda **kw: spt.preprocessing(
                adata, filter_class="but", filter_type="bp", freq=[30, 100], order=4, **kw))):
        clear_store()
        solo = np.asarray(call(parallel=False).data)
        clear_store()
        zero_launches()
        with spt.use_mesh(mesh):
            out, crs = routines_of(call)
            torch.cuda.synchronize()
        expect = shard_launches(crs[0], fused)
        launches[kernel] += read_launches("18e {} over {} cards".format(name, n_cards),
                                          {kernel: expect})[kernel]
        got = np.asarray(out.data)
        diff = float(np.abs(got - solo).max())
        if name == "band-pass":
            diff /= float(np.abs(solo).max())
        print("18e {} over the {} cards: {} launches (rows a shard {}), max diff to the "
              "unsharded result {:.3e}{}".format(
                  name, n_cards, expect, crs[0].chunk_plan[0]["shard_rows"], diff,
                  ", to phase 6's {:.3e}".format(float(np.abs(got[0] - coh_ref).max()))
                  if name == "coh" else ""))
        if not diff <= MESH_ABS_TOL:
            raise AssertionError("18e: {} over the cards off by {:.3e}".format(name, diff))
        del out, solo, got
        walls = {"unsharded": [], "over the cards": []}
        for _ in range(3):
            for route in walls:
                clear_store()
                t0 = time.perf_counter()
                with spt.use_mesh(mesh if route == "over the cards" else None):
                    res = call()
                    torch.cuda.synchronize()
                    settle(res)
                walls[route].append(time.perf_counter() - t0)
                del res
        print("18e {} wall: {}".format(name, "; ".join(
            "{} median {:.4f} s ({})".format(k, statistics.median(v), ", ".join(
                "{:.4f}".format(w) for w in v)) for k, v in walls.items())))
    return launches


#: phase 19: seconds a rank waits for its peers, and that the whole run
#: of the ranks may take
MULTIHOST_RANK_TIMEOUT, MULTIHOST_RUN_TIMEOUT = 300, 600
#: phase 19's frontends and the kernel each launches, once per rank
MULTIHOST_KERNELS = {"coh": "csd_accumulate_tiled", "ppc": "ppc_accumulate_tiled",
                     "bandpass": "sosfiltfilt"}


def multihost_phase(label, n_ranks, backend, csd):
    """Phase 19 (19e): `n_ranks` processes of the port's multihost worker
    at full size, rank r on cuda:(r % cards), joined over `backend`; each
    rank runs coh, ppc and the band-pass, then the five sharded routines
    (Wilson and Granger on the complex128 CSD `csd`) on a mesh over the
    ranks and checks itself (see the worker). Here: every rank exited 0
    within the run's timeout, launched its frontend's kernel exactly once
    and no other, is within 1e-6 of its own unsharded call (the band-pass
    bitwise); each sharded routine's bytes equal the worker's count and,
    for the halos, this script's; prints each rank's lines and a summary.
    Returns the launches summed over the ranks, by kernel."""
    import socket
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_csd_") as tmp:
        csd_path = os.path.join(tmp, "granger_csd.npz")
        np.savez(csd_path, csd=csd)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "syncopy_tpu_torch.parallel.multihost_worker", str(r),
             str(n_ranks), str(port), "--device", "cuda", "--backend", backend, "--size", "full",
             "--reps", "3", "--timeout", str(MULTIHOST_RANK_TIMEOUT), "--csd", csd_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=root)
            for r in range(n_ranks)]
        outs = []
        try:
            for p in procs:
                left = t0 + MULTIHOST_RUN_TIMEOUT - time.perf_counter()
                out, _ = p.communicate(timeout=max(1.0, left))
                outs.append(out.decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    wall = time.perf_counter() - t0
    records = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("rank ") or line.startswith("MULTIHOST OK"):
                print("{} {}".format(label, line))
        if p.returncode != 0 or "MULTIHOST OK rank {}/{}".format(r, n_ranks) not in out:
            raise AssertionError("{}: rank {} exited {}:\n{}".format(
                label, r, p.returncode, out[-4000:]))
        records += [json.loads(line[len("MULTIHOST "):]) for line in out.splitlines()
                    if line.startswith("MULTIHOST {")]
    launches = dict.fromkeys(MULTIHOST_KERNELS.values(), 0)
    for name, kernel in MULTIHOST_KERNELS.items():
        recs = sorted((rec for rec in records if rec.get("frontend") == name),
                      key=lambda rec: rec["rank"])
        if len(recs) != n_ranks:
            raise AssertionError("{} {}: {} ranks reported".format(label, name, len(recs)))
        for rec in recs:
            want = dict.fromkeys(rec["launches"], 0)
            want[kernel] = 1
            exact = name == "bandpass"
            if rec["launches"] != want or not (
                    rec["max_diff"] == 0 if exact else rec["max_diff"] <= MESH_ABS_TOL):
                raise AssertionError("{} {} rank {}: launches {}, diff {}".format(
                    label, name, rec["rank"], rec["launches"], rec["max_diff"]))
            launches[kernel] += rec["launches"][kernel]
        solo, twin = (statistics.median(recs[0]["walls_s"][k])
                      for k in ("parallel=False", "one-process mesh"))
        print("{} {} over {} ranks ({}): launches per rank {}; max diff to the unsharded call "
              "{}; to float64 {}; bytes sent / received per rank {}; wall median over {} "
              "ranks {} s against rank 0 alone unsharded {:.4f} s and on a one-process mesh "
              "{:.4f} s".format(
                  label, name, n_ranks, backend, [rec["launches"][kernel] for rec in recs],
                  ", ".join("{:.3e}".format(rec["max_diff"]) for rec in recs),
                  ", ".join("{:.3e}".format(rec["err_f64"]) for rec in recs),
                  ", ".join("{} / {}".format(rec["sent"], rec["received"]) for rec in recs),
                  n_ranks, ", ".join("{:.4f}".format(statistics.median(rec["walls_s"]["mesh"]))
                                     for rec in recs), solo, twin))
    for name, halo in multihost_halos().items():
        recs = sorted((rec for rec in records if rec.get("routine") == name),
                      key=lambda rec: rec["rank"])
        if len(recs) != n_ranks:
            raise AssertionError("{} {}: {} ranks reported".format(label, name, len(recs)))
        for rec in recs:
            r = rec["rank"]
            if halo is not None:
                left, right, row_bytes = halo
                # rank r's block end is rank r + 1's left halo, its start
                # rank r - 1's right halo
                own = ((left if r < n_ranks - 1 else 0) + (right if r > 0 else 0),
                       (right if r < n_ranks - 1 else 0) + (left if r > 0 else 0))
                if tuple(rec["bytes"][:2]) != tuple(n * row_bytes for n in own):
                    raise AssertionError("{} {} rank {}: halo bytes {}, this script counts "
                                         "{}".format(label, name, r, rec["bytes"][:2],
                                                     [n * row_bytes for n in own]))
            if rec["bytes"] != rec["predicted"] or not rec["max_diff"] <= rec["tol"]:
                raise AssertionError("{} {} rank {}: bytes {}, predicted {}, diff {}".format(
                    label, name, r, rec["bytes"], rec["predicted"], rec["max_diff"]))
        solo, twin = (statistics.median(recs[0]["walls_s"][k])
                      for k in ("unsharded", "one-process mesh"))
        print("{} {} over {} ranks ({}): max diff to the unsharded function {} (bar {}){}; "
              "bytes sent / received per rank in the routine {}, in the gather {} (each equal "
              "to its predicted count); wall median over {} ranks {} s against rank 0 alone "
              "unsharded {:.4f} s and on a one-process mesh {:.4f} s".format(
                  label, name, n_ranks, backend,
                  ", ".join("{:.3e}".format(rec["max_diff"]) for rec in recs), recs[0]["tol"],
                  "" if recs[0]["steps"] is None else "; {} steps".format(
                      [rec["steps"] for rec in recs]),
                  ", ".join("{} / {}".format(*rec["bytes"][:2]) for rec in recs),
                  ", ".join("{} / {}".format(*rec["bytes"][2:]) for rec in recs),
                  n_ranks, ", ".join("{:.4f}".format(statistics.median(rec["walls_s"]["mesh"]))
                                     for rec in recs), solo, twin))
    print("{}: {} ranks over {}, {:.1f} s with their start".format(label, n_ranks, backend, wall))
    return launches


def multihost_halos():
    """Phase 19's sharded routines, each with its halo (left samples,
    right samples, bytes a sample row) at phase 18d's shapes, or None."""
    from syncopy_tpu_torch.ops import filtering as fb
    from syncopy_tpu_torch.ops import wavelet as pw

    row = N_CHANNELS * 4
    fir = (len(fb.design_wsinc("hamming", 400, np.array([8.0, 12.0]) / FS, "bp")) - 1) // 2
    cwt = int(np.ceil(5.0 * pw.Morlet(6).scale_from_period(1.0 / MESH_CWT_FREQS).max()
                      / (1.0 / FS))) + 1
    half = MESH_STFT_NPERSEG // 2
    return {"apply_fir_time_sharded": (fir, fir, row),
            "mtmconvol_time_sharded": (half, MESH_STFT_NPERSEG - half, row),
            "cwt_time_sharded": (cwt, cwt, row),
            "wilson_sf_sharded": None, "granger_sharded": None}


def chunk_trials_for_bp():
    """Trials per chunk of the band-pass routine at the north-star shape."""
    from syncopy_tpu_torch.engine.routine import chunk_trials
    from syncopy_tpu_torch.preproc.compRoutines import ButFiltering

    cr = ButFiltering(samplerate=FS, filter_type="bp", freq=[30, 100], order=4)
    shp = (N_SAMPLES, N_CHANNELS)
    per_trial = max(2 * 2 * N_SAMPLES * N_CHANNELS * 4, cr.device_bytes_per_trial(shp, shp, None))
    return chunk_trials(per_trial, N_TRIALS)


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save-csd", metavar="DIR",
                        help="write the 64-channel Granger CSD and result into DIR")
    parser.add_argument("--jackknife-trials", type=int, default=JACK_COH_TRIALS, metavar="N",
                        help="trials of the coherence jackknife (phase 9), at most {}".format(
                            N_TRIALS))
    parser.add_argument("--cards-only", action="store_true",
                        help="run phases 1, 2, 18e and 19e (the mesh and one rank per "
                        "card over the real cards) only")
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
    from syncopy_tpu_torch.ops import filtering as fb
    from syncopy_tpu_torch.ops import iir_kernels as ik
    from syncopy_tpu_torch.ops import ppc_kernels as pk
    from syncopy_tpu_torch.shared.input_processors import process_taper

    # -- 2. build: one nvcc per library, all started together ------------- #
    def timed_build(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = {name: pool.submit(timed_build, load) for name, load in [
            ("csd_accumulate (tiled + untiled)", ck.load_csd_kernel),
            ("ppc_accumulate", pk.load_ppc_kernel),
            ("sosfilt", ik.load_sosfilt_kernel)]}
        builds = {name: fut.result() for name, fut in builds.items()}
    for name, seconds in builds.items():
        print("build {}: {:.2f} s (nvcc, then load)".format(name, seconds))
    print("build, all three libraries: {:.2f} s".format(time.perf_counter() - t0))
    for planar, name in [(False, "csd_accumulate_tiled"), (True, "csd_accumulate")]:
        threads, blocks = ck.kernel_occupancy(planar)
        print("{}: {} threads a block, {} blocks ({} warps) resident per SM".format(
            name, threads, blocks, threads * blocks // 32))
    if args.cards_only:
        if torch.cuda.device_count() < 2:
            print("chip_smoke --cards-only: one card visible", file=sys.stderr)
            return 1
        data, trl = north_star_data()
        adata = spt.from_arrays(data, trl, FS)
        coh_ref = np.asarray(spt.connectivityanalysis(adata, method="coh", tapsmofrq=2).data)[0]
        cards_phase(spt, adata, coh_ref)
        del data, adata
        clear_store()
        # phase 8's 64-channel network, its CSD in float64 rounded to complex64
        csd = granger_csd_f64(ar2_network(N_CHANNELS), N_CHANNELS).cpu().numpy()
        multihost_phase("19e", torch.cuda.device_count(), "nccl", csd)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
        return 0
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

    clear_store()
    zero_launches()
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
    coh64 = coherence_f64(data, taper, taper_opt)
    coh_err = float(np.abs(got[0] - coh64).max())
    print("main path: {} kernel launches for {} chunk(s); taper {} {}; coherence max abs "
          "err vs float64 {:.3e}".format(launches, n_chunks, taper, taper_opt, coh_err))
    if not coh_err < COH_ABS_TOL:
        raise AssertionError("coherence err {:.3e} >= {}".format(coh_err, COH_ABS_TOL))
    torch.cuda.empty_cache()

    walls = []
    for _ in range(5):
        clear_store()  # every timed call uploads its input
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
    clear_store()
    zero_launches()
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
    ppc64 = ppc_f64(data, taper, taper_opt)
    ppc_abs_err = float(np.abs(got[0] - ppc64).max())
    print("ppc main path: {} kernel launches for {} chunk(s); diagonal - 1 {:.3e}; ppc max "
          "abs err vs float64 {:.3e}".format(ppc_launches, n_chunks, diag_err, ppc_abs_err))
    if not diag_err < 1e-5:
        raise AssertionError("ppc diagonal err {:.3e} >= 1e-5".format(diag_err))
    if not ppc_abs_err < PPC_ABS_TOL:
        raise AssertionError("ppc err {:.3e} >= {}".format(ppc_abs_err, PPC_ABS_TOL))
    torch.cuda.empty_cache()

    walls = []
    for _ in range(5):
        clear_store()  # every timed call uploads its input
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
    granger = {}
    for n_chan, oracle in ((N_CHANNELS, True), (2 * N_CHANNELS, False)):
        clear_store()
        granger[n_chan] = granger_phase(spt, n_chan, oracle,
                                        args.save_csd if n_chan == N_CHANNELS else None)

    # -- 9. coh jackknife --------------------------------------------------- #
    clear_store()
    coh_jackknife_phase(spt, taper, taper_opt, min(args.jackknife_trials, N_TRIALS))

    # -- 10. granger jackknife ---------------------------------------------- #
    clear_store()
    granger_jackknife_phase(spt)

    # -- 11. corr ------------------------------------------------------------ #
    clear_store()
    corr_phase(spt)

    # -- 12 to 14. freqanalysis ---------------------------------------------- #
    t0 = time.perf_counter()
    data, trl = north_star_data()
    clear_store()
    mtmfft_phase(spt, data, trl, taper, taper_opt, np.asarray(coh.data)[0])
    clear_store()
    stft_phase(spt, data, trl)
    clear_store()
    wavelet_phase(spt, data, trl)
    print("phases 12 to 14: {:.1f} s".format(time.perf_counter() - t0))

    # -- 15. preprocessing ---------------------------------------------------- #
    t0 = time.perf_counter()
    clear_store()
    iir = iir_kernel_checks(ik, fb, data)
    preproc = preproc_phase(spt, data, trl, iir["ms"])
    print("phase 15: {:.1f} s".format(time.perf_counter() - t0))

    # -- 16. synthetic data through a .spy container into coherence ------ #
    t0 = time.perf_counter()
    clear_store()
    synth = synth_phase(spt, taper, taper_opt)
    print("phase 16: {:.1f} s".format(time.perf_counter() - t0))

    # -- 17. the engine extras: resident chain, trial store, plot view --- #
    t0 = time.perf_counter()
    clear_store()
    extras = extras_phase(spt, data, trl, preproc["chain"]["coh64"])
    del data
    clear_store()
    print("phase 17: {:.1f} s".format(time.perf_counter() - t0))

    # -- 18. the mesh: four positions on the card, and the real cards ------ #
    t0 = time.perf_counter()
    mesh = mesh_phase(spt, {"coh": (np.asarray(coh.data)[0], coh64),
                            "ppc": (np.asarray(ppc.data)[0], ppc64)},
                      preproc["chain"]["coh64"], extras["coh"], granger[N_CHANNELS]["csd"])
    print("phase 18: {:.1f} s".format(time.perf_counter() - t0))

    # -- 19. multi-host: two ranks on the card, and one rank per card ------ #
    t0 = time.perf_counter()
    clear_store()
    csd = granger[N_CHANNELS]["csd"].astype(np.complex128)
    multihost = multihost_phase("19", 2, "gloo", csd)
    if torch.cuda.device_count() > 1:
        for kernel, count in multihost_phase("19e", torch.cuda.device_count(), "nccl",
                                             csd).items():
            multihost[kernel] += count
    else:
        print("19e one rank per card over nccl: not run: one card")
    print("phase 19: {:.1f} s".format(time.perf_counter() - t0))

    print(json.dumps({"kernels": [{
        "name": "csd_accumulate_tiled",
        "route": "cuda",
        "source": "syncopy_tpu_torch/csrc/csd_accumulate.cu",
        "replaces": "syncopy_tpu/ops/pallas_kernels.py:140",
        "launches": launches + synth["launches"] + extras["csd_launches"]
        + mesh["csd_accumulate_tiled"] + multihost["csd_accumulate_tiled"],
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
        "launches": ppc_launches + mesh["ppc_accumulate_tiled"]
        + multihost["ppc_accumulate_tiled"],
        "max_abs_err": ppc_err,
        "ms": ppc_ms,
        "plain_ms": ppc_plain_ms,
        "bound_ms": ppc_bound_ms,
        "bound_by": ppc_bound_by,
        "library_ms": None,
    }, {
        "name": "sosfiltfilt",
        "route": "cuda",
        "source": "syncopy_tpu_torch/csrc/sosfilt.cu",
        "replaces": "syncopy_tpu/ops/filtering.py:181 (_biquad, lax.associative_scan; no "
                    "pallas_call)",
        "launches": preproc["launches"] + extras["iir_launches"] + mesh["sosfiltfilt"]
        + multihost["sosfiltfilt"],
        "max_abs_err": iir["max_abs_err"],
        "ms": iir["ms"],
        "plain_ms": iir["plain_ms"],
        "bound_ms": iir["bound_ms"],
        "bound_by": iir["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
