# -*- coding: utf-8 -*-
#
# Butterworth biquad cascade: the hand-written CUDA kernel
# (csrc/sosfilt.cu), its loader, its plain PyTorch version and the wrapper
# that picks between them by the tensor's device.
#
# Replaces syncopy_tpu/ops/filtering.py::_biquad, sosfilt and sosfiltfilt
# (:181-258), whose recurrence runs as a lax.associative_scan over 2x2
# affine state maps (plain XLA; PyTorch has no associative scan and no call
# that computes an IIR recurrence). The kernel runs one thread per (trial,
# channel) sequence through all sections in float64 registers, the sections
# pipelined across samples, the whole sosfiltfilt (odd extension, forward
# cascade into a float64 scratch, backward cascade, crop) in one launch;
# see the source's header. Bounded on the H100 by its bytes (PERF.md
# section 6). The plain version evaluates the same float64 expressions in
# the same order, one tensor operation at a time, a Python loop over time
# for the two feedback taps only; the kernel fuses products and sums into
# FMAs, so the two agree within 2 float32 ulps of the maximum.

import ctypes

import numpy as np
import torch

from ._nvcc import load_library

__all__ = ["sosfilt_batch", "sosfilt_batch_plain", "sosfilt_float64_plain", "sosfilt_padlen",
           "load_sosfilt_kernel", "kernel_occupancy", "kernel_attributes", "MAX_SECTIONS"]

#: sections the kernel takes (csrc/sosfilt.cu MAX_SECTIONS)
MAX_SECTIONS = 64


def load_sosfilt_kernel():
    """
    Build (once per source hash) and load the shared library of
    ``csrc/sosfilt.cu``, with its launcher typed. Raises RuntimeError when
    nvcc is missing or the compile fails.
    """
    lib = load_library("sosfilt")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sosfilt_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, ctypes.c_int, ptr]
    lib.sosfilt_launch.restype = ctypes.c_int
    lib.sosfilt_occupancy.argtypes = [i64, ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
    lib.sosfilt_occupancy.restype = ctypes.c_int
    lib.sosfilt_attributes.argtypes = [i64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int)]
    lib.sosfilt_attributes.restype = ctypes.c_int
    return lib


def kernel_occupancy(n_sections):
    """
    ``(threads per block, resident blocks per SM)`` that the CUDA runtime
    grants the twopass instance of `n_sections` sections on the current card.
    """
    lib = load_sosfilt_kernel()
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.sosfilt_occupancy(int(n_sections), ctypes.byref(threads), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError("sosfilt occupancy query failed: cudaError {}".format(rc))
    return threads.value, blocks.value


def kernel_attributes(n_sections, twopass=True):
    """
    ``(registers a thread, local memory bytes a thread)`` of the kernel
    instance that runs `n_sections` sections; the local bytes of a
    compile-time instance (1 to 8 sections) are its spills.
    """
    lib = load_sosfilt_kernel()
    registers, local_bytes = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.sosfilt_attributes(int(n_sections), int(bool(twopass)), ctypes.byref(registers),
                                ctypes.byref(local_bytes))
    if rc != 0:
        raise RuntimeError("sosfilt attributes query failed: cudaError {}".format(rc))
    return registers.value, local_bytes.value


def sosfilt_padlen(sos, n_samples):
    """scipy's sosfiltfilt edge: ``3 * ntaps``, ntaps corrected for
    first-order sections, at most ``n_samples - 1``."""
    sos = np.atleast_2d(sos)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min(int((sos[:, 2] == 0).sum()), int((sos[:, 5] == 0).sum()))
    return min(3 * ntaps, int(n_samples) - 1)


def _cascade_plain(w, sos, x0):
    """The sections of `sos` in turn over the (N, E, C) float64 `w` along
    dim 1, the histories primed with the constant `x0` (N, C): section s
    sees ``w[-1] = w[-2] = x0_s`` and ``y[-1] = y[-2] = x0_{s+1} =
    x0_s (b0 + b1 + b2) / (1 + a1 + a2)``. Each output is formed in the
    kernel's order, the newest feedback term last: ``p = ((b1 w[n-1] + b2
    w[n-2]) - a2 y[n-2]) - a1 y[n-1]``, then ``y[n] = b0 w[n] + p``."""
    E = w.shape[1]
    h = x0
    for b0, b1, b2, _, a1, a2 in np.asarray(sos, dtype=np.float64).tolist():
        bsum, asum = (b0 + b1) + b2, (1.0 + a1) + a2
        # a divisor on the device: CUDA divides by a Python scalar as a
        # product with its reciprocal, which is not the kernel's division
        y_ss = h * bsum / torch.full((), asum, dtype=h.dtype, device=h.device)
        wm1 = torch.cat([h[:, None], w[:, :-1]], dim=1)
        wm2 = torch.cat([h[:, None], h[:, None], w[:, :-2]], dim=1)[:, :E]
        q = b1 * wm1 + b2 * wm2
        bw = b0 * w
        y = torch.empty_like(q)
        y1 = y2 = y_ss
        for n in range(E):
            yn = bw[:, n] + ((q[:, n] - a2 * y2) - a1 * y1)
            y[:, n] = yn
            y2, y1 = y1, yn
        w, h = y, y_ss
    return w


def sosfilt_batch_plain(x, sos, twopass=True):
    """
    Plain PyTorch version of :func:`sosfilt_batch`: the kernel's float64
    arithmetic step by step, each product and sum rounded on its own
    (:func:`sosfilt_float64_plain`), rounded once to float32 at the end.
    """
    return sosfilt_float64_plain(x, sos, twopass).to(torch.float32)


def sosfilt_float64_plain(x, sos, twopass=True):
    """
    The float64 result of :func:`sosfilt_batch_plain` before its final
    rounding, from a (N, T, C) batch of any float dtype: the kernel's
    arithmetic step by step (each product and sum rounded on its own, where
    the kernel fuses them into FMAs), batched over trials and channels (the
    FIR part of each section vectorised, a loop over time for the two
    feedback taps).
    """
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    xd = x.to(torch.float64)
    T = x.shape[1]
    if not twopass:
        return _cascade_plain(xd, sos, xd[:, 0] * 0.0)
    p = sosfilt_padlen(sos, T)
    first, last = xd[:, :1], xd[:, -1:]
    left = 2.0 * first - xd[:, 1 : p + 1].flip(1)
    right = 2.0 * last - xd[:, T - 1 - p : T - 1].flip(1)
    ext = torch.cat([left, xd, right], dim=1)
    fwd = _cascade_plain(ext, sos, ext[:, 0])
    rev = fwd.flip(1)
    bwd = _cascade_plain(rev, sos, rev[:, 0]).flip(1)
    return bwd[:, p : p + T]


def sosfilt_batch(x, sos, twopass=True):
    """
    Butterworth cascade of the second-order sections `sos` ((S, 6), scipy's
    layout) along the time axis of a (N, T, C) float32 batch:
    ``twopass=True`` is scipy's ``sosfiltfilt`` (odd extension of
    :func:`sosfilt_padlen` samples, steady-state priming, forward then
    backward), ``twopass=False`` is ``sosfilt`` with zero priming (``x[0] *
    0``, so a NaN first sample stays NaN). float64 inside.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    hand-written kernel on the current stream, or raises: it never falls
    back.

    Returns (N, T, C) float32 on the input's device.
    """
    if x.ndim != 3:
        raise ValueError("x must be (N, T, C), got shape {}".format(tuple(x.shape)))
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6 or sos.shape[0] < 1:
        raise ValueError("sos must be (S, 6) with S >= 1, got shape {}".format(sos.shape))
    if x.device.type == "cpu":
        return sosfilt_batch_plain(x, sos, twopass)
    if x.device.type != "cuda":
        raise ValueError("sosfilt_batch runs on cpu or cuda, not {}".format(x.device))
    if x.dtype != torch.float32:
        raise TypeError("x must be float32, got {}".format(x.dtype))
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if sos.shape[0] > MAX_SECTIONS:
        raise ValueError("the kernel takes at most {} sections, got {}".format(
            MAX_SECTIONS, sos.shape[0]))
    N, T, C = x.shape
    lib = load_sosfilt_kernel()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    pad = sosfilt_padlen(sos, T) if twopass else 0
    coef = torch.from_numpy(np.ascontiguousarray(sos)).to(x.device)
    scratch = (torch.empty((N, T + 2 * pad, C), dtype=torch.float64, device=x.device)
               if twopass else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sosfilt_launch(
            x.data_ptr(), coef.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), N, T, C, sos.shape[0], pad, int(bool(twopass)), stream)
    if rc != 0:
        raise RuntimeError("sosfilt kernel launch failed: cudaError {}".format(rc))
    sosfilt_batch.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to start a count)
sosfilt_batch.launches = 0
