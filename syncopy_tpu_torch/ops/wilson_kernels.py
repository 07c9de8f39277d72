# -*- coding: utf-8 -*-
#
# The solve in Wilson's step, g = psi^-1 U: the hand-written CUDA kernel
# (csrc/wilson_solve.cu), its loader, its plain PyTorch version and the
# route between them.
#
# Replaces no TPU kernel: the JAX package leaves the inverse to XLA
# (syncopy_tpu/ops/connectivity.py, wilson_sf). The plain version is the
# port's earlier step, an inverse by torch.linalg.inv_ex (NaN where it
# fails) times U; on the card that inverse is a batched LU whose host work
# between its launches left the card idle for most of a step. The kernel
# solves psi X = U for every bin in one launch, complex128, LU with
# partial pivoting, FP64 arithmetic; see the source's header. Bounded on
# the H100 by its FP64 operations (PERF.md section 6).

import ctypes

import torch

from ._nvcc import load_library

__all__ = ["wilson_solve", "wilson_solve_plain", "solve_route", "load_wilson_kernel", "MAX_N"]

#: channels the kernel takes (csrc/wilson_solve.cu MAX_N)
MAX_N = 256


def solve_route(device, dtype, n):
    """``"kernel"`` where :func:`wilson_solve` takes a (..., n, n) solve
    of `dtype` on `device` (CUDA, complex128, ``n <= MAX_N``), else
    ``"library"`` (:func:`wilson_solve_plain`)."""
    device = torch.device(device)
    if device.type == "cuda" and dtype == torch.complex128 and 1 <= n <= MAX_N:
        return "kernel"
    return "library"


def load_wilson_kernel():
    """
    Build (once per source hash) and load the shared library of
    ``csrc/wilson_solve.cu``, with its launcher typed. Raises RuntimeError
    when nvcc is missing or the compile fails.
    """
    lib = load_library("wilson_solve")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.wilson_solve_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ptr]
    lib.wilson_solve_launch.restype = ctypes.c_int
    return lib


def _nan_where_failed(x, info):
    """`x` where the batched LAPACK-style `info` is 0, NaN elsewhere: a
    failed Cholesky or inverse yields NaN, as in the JAX package, instead
    of an exception (and of the host sync that checking it would cost)."""
    return torch.where((info == 0)[..., None, None], x, x.new_full((), float("nan")))


def _inv_nan(a):
    X, info = torch.linalg.inv_ex(a)
    return _nan_where_failed(X, info)


def wilson_solve_plain(psi, U):
    """
    Plain PyTorch version of :func:`wilson_solve`: ``inv_ex(psi) @ U``, the
    inverse NaN in every bin where ``inv_ex`` reports a failure.
    """
    return _inv_nan(psi) @ U


def wilson_solve(psi, U):
    """
    ``X = psi^-1 U`` for (..., N, N) complex128 `psi` and `U` of one shape
    on one CUDA card: the hand-written kernel on the current stream (LU
    with partial pivoting, FP64), NaN in every bin of the batch whose pivot
    is exactly zero. Raises on what the kernel does not take: another
    device or dtype, N over ``MAX_N``, shapes that differ, a tensor that is
    not contiguous. It never falls back; :func:`solve_route` says which
    inputs the kernel takes.

    Returns X, (..., N, N) complex128 on the input's device.
    """
    if psi.ndim < 2 or psi.shape[-1] != psi.shape[-2] or psi.shape != U.shape:
        raise ValueError("psi and U must be (..., N, N) of one shape, got {} and {}".format(
            tuple(psi.shape), tuple(U.shape)))
    if psi.device.type != "cuda" or U.device != psi.device:
        raise ValueError("wilson_solve runs on one CUDA device, got {} and {}".format(
            psi.device, U.device))
    if psi.dtype != torch.complex128 or U.dtype != torch.complex128:
        raise TypeError("psi and U must be complex128, got {} and {}".format(psi.dtype, U.dtype))
    N = psi.shape[-1]
    if not 1 <= N <= MAX_N:
        raise ValueError("wilson_solve takes 1 to {} channels, got {}".format(MAX_N, N))
    if not (psi.is_contiguous() and U.is_contiguous()):
        raise ValueError("psi and U must be contiguous")
    bins = psi.numel() // (N * N)
    X = torch.empty_like(psi)
    if bins == 0:
        return X
    scratch = torch.empty((bins, N, 2 * N), dtype=psi.dtype, device=psi.device)
    lib = load_wilson_kernel()
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wilson_solve_launch(psi.data_ptr(), U.data_ptr(), X.data_ptr(),
                                     scratch.data_ptr(), bins, N, stream)
    if rc != 0:
        raise RuntimeError("wilson_solve kernel launch failed: cudaError {}".format(rc))
    wilson_solve.launches += 1
    return X


#: kernel launches since the last reset (set to 0 to start a count)
wilson_solve.launches = 0
