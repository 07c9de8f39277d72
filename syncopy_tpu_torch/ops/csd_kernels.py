# -*- coding: utf-8 -*-
#
# Cross-spectral density accumulation: the hand-written CUDA kernels
# (csrc/csd_accumulate.cu), their loader, their plain PyTorch versions and
# the wrappers that pick between them by the tensor's device.
#
# Replace the TPU kernels syncopy_tpu/ops/pallas_kernels.py::
# csd_accumulate_tiled (body _csd_tiled_kernel) and csd_accumulate (body
# _csd_kernel, the untiled per-frequency Gram; in the JAX package only the
# pallas_supported() probe calls it). One templated kernel body serves
# both: each layout's row loader owns the asynchronous copy of its rows into
# shared memory and the read of a staged element; the result writer owns
# the store.
#
# The body (see the source's header): one 128-thread block per (frequency,
# 32x32 tile with i <= j), two 64-thread slices splitting the rows; a ring
# of three 32-row stages filled by cp.async (16-byte chunks where aligned,
# zero-fill for rows at or past n_valid and channels at or past C, so NaN
# padding is never read); diagonal tiles stage once and skip the quarter
# below the diagonal; each slice keeps the (hi, lo) of the outputs it owns
# in registers and the slices swap group partials through shared memory;
# four blocks (16 warps) per SM. The numerics are the tiled TPU kernel's:
# 256-row float32 groups combined by TwoSum, no TF32, no tensor cores, one
# writer per element and no atomics (bitwise deterministic). Bounded on the H100 by the FP32 pipes: the upper
# triangle is 8*F*n*C(C+1)/2 = 25.0 GFLOP at the bench shape (n = 3000,
# F = 501, C = 64), 0.373 ms at 67 TFLOP/s, against 0.79 GB of input and
# output, 0.235 ms at 3.35 TB/s (estimates from shapes, not measurements).

import ctypes

import torch

from ._nvcc import load_library
from .connectivity import gram_sum_twosum

__all__ = ["csd_accumulate", "csd_accumulate_plain", "csd_accumulate_tiled",
           "csd_accumulate_tiled_plain", "load_csd_kernel", "kernel_occupancy"]

#: rows per float32 group before the TwoSum (the TPU kernel's row_block)
ROW_BLOCK = 256


def load_csd_kernel():
    """
    Build (once per source hash) and load the shared library of
    ``csrc/csd_accumulate.cu``, with both launchers typed. Raises
    RuntimeError when nvcc is missing or the compile fails.
    """
    lib = load_library("csd_accumulate")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.csd_accumulate_tiled_launch.argtypes = [ptr, ptr, i64, i64, i64, i64, ptr]
    lib.csd_accumulate_tiled_launch.restype = ctypes.c_int
    lib.csd_accumulate_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.csd_accumulate_launch.restype = ctypes.c_int
    lib.csd_accumulate_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)]
    lib.csd_accumulate_occupancy.restype = ctypes.c_int
    return lib


def kernel_occupancy(planar=False):
    """
    ``(threads per block, resident blocks per SM)`` that the CUDA runtime
    grants the interleaved (tiled) or the planar (untiled) instance of the
    kernel on the current card.
    """
    lib = load_csd_kernel()
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.csd_accumulate_occupancy(int(planar), ctypes.byref(threads), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError("csd_accumulate occupancy query failed: cudaError {}".format(rc))
    return threads.value, blocks.value


def csd_accumulate_tiled_plain(spec, n_valid):
    """
    Plain PyTorch version of :func:`csd_accumulate_tiled`: a where-mask
    (NaN-safe, unlike a multiply) on the rows at or past `n_valid`, then
    256-row complex64 matmul partials combined by TwoSum.
    """
    N = spec.shape[0]
    valid = torch.arange(N, device=spec.device) < n_valid
    masked = torch.where(valid[:, None, None], spec, torch.zeros((), dtype=spec.dtype, device=spec.device))
    return gram_sum_twosum(masked, ROW_BLOCK)


def csd_accumulate_tiled(spec, n_valid):
    """
    Accumulated cross-spectra from an (N, F, C) complex64 spectrum:
    ``cs[f, i, j] = sum_{n < n_valid} spec[n, f, i] * conj(spec[n, f, j])``.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    hand-written kernel on the current stream, or raises: it never falls
    back. `n_valid` is a host int with ``0 <= n_valid <= N``.

    Returns (F, C, C) complex64 on the input's device.
    """
    if spec.ndim != 3:
        raise ValueError("spec must be (N, F, C), got shape {}".format(tuple(spec.shape)))
    N, F, C = spec.shape
    n_valid = int(n_valid)
    if not 0 <= n_valid <= N:
        raise ValueError("n_valid must lie in [0, {}], got {}".format(N, n_valid))
    if spec.device.type == "cpu":
        return csd_accumulate_tiled_plain(spec, n_valid)
    if spec.device.type != "cuda":
        raise ValueError("csd_accumulate_tiled runs on cpu or cuda, not {}".format(spec.device))
    if spec.dtype != torch.complex64:
        raise TypeError("spec must be complex64, got {}".format(spec.dtype))
    if not spec.is_contiguous():
        raise ValueError("spec must be contiguous")
    lib = load_csd_kernel()
    out = torch.empty((F, C, C), dtype=torch.complex64, device=spec.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.csd_accumulate_tiled_launch(
            spec.data_ptr(), out.data_ptr(), N, F, C, n_valid, stream
        )
    if rc != 0:
        raise RuntimeError("csd_accumulate_tiled kernel launch failed: cudaError {}".format(rc))
    csd_accumulate_tiled.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to start a count)
csd_accumulate_tiled.launches = 0


def csd_accumulate_plain(spec_re, spec_im):
    """
    Plain PyTorch version of :func:`csd_accumulate`: the four real float32
    matmuls of the TPU kernel, ``Re = Ar^T Ar + Ai^T Ai``,
    ``Im = Ai^T Ar - Ar^T Ai`` per frequency.
    """
    ar, ai = spec_re.to(torch.float32), spec_im.to(torch.float32)
    art, ait = ar.transpose(1, 2), ai.transpose(1, 2)
    return torch.matmul(art, ar) + torch.matmul(ait, ai), torch.matmul(ait, ar) - torch.matmul(art, ai)


def csd_accumulate(spec_re, spec_im):
    """
    Accumulated cross-spectra from (F, N, C) float32 real and imaginary
    planes: ``cs[f, i, j] = sum_n spec[f, n, i] * conj(spec[f, n, j])``
    over all N rows.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    hand-written kernel (the tiled kernel's body reading the two planes in
    place) on the current stream, or raises: it never falls back.

    Returns (cs_re, cs_im), each (F, C, C) float32 on the input's device.
    """
    if spec_re.ndim != 3 or spec_re.shape != spec_im.shape:
        raise ValueError("spec_re and spec_im must be (F, N, C) of one shape, got {} and {}".format(
            tuple(spec_re.shape), tuple(spec_im.shape)))
    if spec_re.device != spec_im.device:
        raise ValueError("spec_re and spec_im lie on {} and {}".format(spec_re.device, spec_im.device))
    F, N, C = spec_re.shape
    if spec_re.device.type == "cpu":
        return csd_accumulate_plain(spec_re, spec_im)
    if spec_re.device.type != "cuda":
        raise ValueError("csd_accumulate runs on cpu or cuda, not {}".format(spec_re.device))
    if spec_re.dtype != torch.float32 or spec_im.dtype != torch.float32:
        raise TypeError("spec planes must be float32, got {} and {}".format(spec_re.dtype, spec_im.dtype))
    if not (spec_re.is_contiguous() and spec_im.is_contiguous()):
        raise ValueError("spec planes must be contiguous")
    lib = load_csd_kernel()
    out_re = torch.empty((F, C, C), dtype=torch.float32, device=spec_re.device)
    out_im = torch.empty_like(out_re)
    if out_re.numel() == 0:
        return out_re, out_im
    with torch.cuda.device(spec_re.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.csd_accumulate_launch(
            spec_re.data_ptr(), spec_im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
            F, N, C, stream,
        )
    if rc != 0:
        raise RuntimeError("csd_accumulate kernel launch failed: cudaError {}".format(rc))
    csd_accumulate.launches += 1
    return out_re, out_im


#: kernel launches since the last reset (set to 0 to start a count)
csd_accumulate.launches = 0
