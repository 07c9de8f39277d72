# -*- coding: utf-8 -*-
#
# Pairwise phase consistency resultant: the hand-written CUDA kernel
# (csrc/ppc_accumulate.cu), its loader, its plain PyTorch version and the
# wrapper that picks between them by the tensor's device.
#
# Replaces the TPU kernel syncopy_tpu/ops/pallas_kernels.py::
# ppc_accumulate_tiled (body _ppc_tiled_kernel). Per trial, the
# taper-summed CSD collapses to its unit phasor in registers and adds into
# the resultant U, so the (N, F, C, C) per-trial CSD stack never exists in
# device memory. The kernel (see the source's header): one 128-thread
# block per (frequency, 32x32 tile pair), two slices each taking half the
# trials, a 3-deep cp.async ring of stages that hold whole trials for
# K = 1..8 (any other K runs the same kernel with K read at run time), and
# a unit phasor exact at every float32 magnitude: the Gram is scaled by an
# exact power of two before one rsqrt, so neither underflow nor overflow
# drops a nonzero term (the JAX body's squares do below |csd| ~ 3.7e-23 and
# above ~1.8e19). The plain version takes the phasor in float64, which
# holds every float32 square. Bounded on the H100 by the issue of the
# Gram's FMAs together with their shared-memory loads, then the phasor's
# instructions, not by HBM (PERF.md section 6).

import ctypes

import torch

from ._nvcc import load_library

__all__ = ["ppc_accumulate_tiled", "ppc_accumulate_tiled_plain", "load_ppc_kernel",
           "kernel_occupancy"]

#: per-trial (b, F, C, C) complex128 stack of the plain version, in bytes
PLAIN_STACK_BYTES = 1 << 30


def load_ppc_kernel():
    """
    Build (once per source hash) and load the shared library of
    ``csrc/ppc_accumulate.cu``, with its launcher typed. Raises
    RuntimeError when nvcc is missing or the compile fails.
    """
    lib = load_library("ppc_accumulate")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ppc_accumulate_tiled_launch.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.ppc_accumulate_tiled_launch.restype = ctypes.c_int
    lib.ppc_accumulate_occupancy.argtypes = [i64, ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_int)]
    lib.ppc_accumulate_occupancy.restype = ctypes.c_int
    return lib


def kernel_occupancy(K):
    """
    ``(threads per block, resident blocks per SM)`` that the CUDA runtime
    grants the kernel instance that runs `K` tapers on the current card.
    """
    lib = load_ppc_kernel()
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.ppc_accumulate_occupancy(int(K), ctypes.byref(threads), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError("ppc_accumulate occupancy query failed: cudaError {}".format(rc))
    return threads.value, blocks.value


def ppc_accumulate_tiled_plain(spec, n_valid):
    """
    Plain PyTorch version of :func:`ppc_accumulate_tiled`: a where-mask
    (NaN-safe, unlike a multiply) on the trials at or past `n_valid`, then
    the per-trial taper-summed Gram in complex64, its unit phasor in
    complex128 (every float32 square, denormal or near the top of the
    range, is a normal float64, so no nonzero term underflows to 0 or
    overflows to NaN) and the sum over trials in complex128, returned as
    complex64; in trial groups small enough that the (b, F, C, C)
    per-trial stack stays under PLAIN_STACK_BYTES.
    """
    N, K, F, C = spec.shape
    valid = torch.arange(N, device=spec.device) < n_valid
    spec = torch.where(valid[:, None, None, None], spec,
                       torch.zeros((), dtype=spec.dtype, device=spec.device))
    group = max(1, PLAIN_STACK_BYTES // max(F * C * C * 16, 1))
    U = torch.zeros((F, C, C), dtype=torch.complex128, device=spec.device)
    for b0 in range(0, N, group):
        s = spec[b0 : b0 + group]
        # cs[b, f, i, j] = sum_k s[b, k, f, i] conj(s[b, k, f, j])
        cs = torch.matmul(s.permute(0, 2, 3, 1), s.conj().permute(0, 2, 1, 3))
        cs = cs.to(torch.complex128)
        mag = cs.abs()
        unit = torch.where(mag > 0, cs / torch.where(mag > 0, mag, 1.0),
                           torch.zeros((), dtype=cs.dtype, device=cs.device))
        U = U + unit.sum(dim=0)
    return U.to(spec.dtype)


def ppc_accumulate_tiled(spec, n_valid):
    """
    PPC resultant from an (N, K, F, C) complex64 spectrum of N trials and
    K tapers: ``U[f, i, j] = sum_{n < n_valid} csd_n / |csd_n|`` with
    ``csd_n = sum_k spec[n, k, f, i] * conj(spec[n, k, f, j])``; bins of
    zero magnitude add 0, and every nonzero bin adds a unit phasor at any
    float32 magnitude. PPC itself is ``(|U|^2 - n) / (n (n - 1))``.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    hand-written kernel on the current stream, or raises: it never falls
    back. `n_valid` is a host int with ``0 <= n_valid <= N``.

    Returns (F, C, C) complex64 on the input's device.
    """
    if spec.ndim != 4:
        raise ValueError("spec must be (N, K, F, C), got shape {}".format(tuple(spec.shape)))
    N, K, F, C = spec.shape
    n_valid = int(n_valid)
    if not 0 <= n_valid <= N:
        raise ValueError("n_valid must lie in [0, {}], got {}".format(N, n_valid))
    if spec.device.type == "cpu":
        return ppc_accumulate_tiled_plain(spec, n_valid)
    if spec.device.type != "cuda":
        raise ValueError("ppc_accumulate_tiled runs on cpu or cuda, not {}".format(spec.device))
    if spec.dtype != torch.complex64:
        raise TypeError("spec must be complex64, got {}".format(spec.dtype))
    if not spec.is_contiguous():
        raise ValueError("spec must be contiguous")
    lib = load_ppc_kernel()
    out = torch.empty((F, C, C), dtype=torch.complex64, device=spec.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ppc_accumulate_tiled_launch(
            spec.data_ptr(), out.data_ptr(), N, K, F, C, n_valid, stream
        )
    if rc != 0:
        raise RuntimeError("ppc_accumulate_tiled kernel launch failed: cudaError {}".format(rc))
    ppc_accumulate_tiled.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to start a count)
ppc_accumulate_tiled.launches = 0
