# -*- coding: utf-8 -*-
#
# Filtering ops on torch tensors: windowed-sinc FIR design and its FFT
# application, the Butterworth cascade, the Hilbert transform and
# resampling, batched over a leading trial axis: data (N, T, C).
#
# Port of syncopy_tpu/ops/filtering.py. The host-side designs
# (windowed_sinc, invert_sinc, design_wsinc, minphaserceps, butter_sos,
# _resample_kernel) are copied and give the JAX package's arrays bit for
# bit. apply_fir, hilbert and resample_poly are the JAX package's FFT
# routes with torch.fft (cuFFT on the card), in float32. sosfilt and
# sosfiltfilt call the hand-written CUDA kernel (ops/iir_kernels.py,
# csrc/sosfilt.cu) in place of the associative scan, in float64 always.
# Not ported: the dense-GEMM FIR and Hilbert operators and their knob
# (_prefer_filter_gemm, _fir_conv_matrix, _hilbert_matrix,
# filter_gemm_fingerprint, SPY_TPU_FILTER_GEMM) and MXU rewrites.
# apply_fir_time_sharded splits one recording's time axis over a mesh
# axis, with the filter halo exchanged between neighbouring positions.

import functools

import numpy as np
import torch
from scipy.signal import butter as _sp_butter
from scipy.signal import windows as sp_windows

from .iir_kernels import sosfilt_batch

__all__ = [
    "design_wsinc",
    "minphaserceps",
    "apply_fir",
    "fir_fft_length",
    "butter_sos",
    "sosfilt",
    "sosfiltfilt",
    "hilbert",
    "downsample",
    "resample_poly",
    "apply_fir_time_sharded",
]


# ------------------------------------------------------------------------ #
# FIR windowed sinc (host-side design; reference firws.py:46-165)
# ------------------------------------------------------------------------ #


def windowed_sinc(window, order, f_c):
    omega_c = 2 * np.pi * f_c
    win = getattr(sp_windows, window)(order + 1)
    m_half = np.arange(1, order / 2 + 1)
    kernel = np.sin(omega_c * m_half) / m_half
    kernel = np.hstack([kernel[::-1], omega_c, kernel]) * win
    return kernel / kernel.sum()


def invert_sinc(kernel):
    kernel = -kernel
    kernel[len(kernel) // 2] += 1
    return kernel


def design_wsinc(window, order, f_c, filter_type="lp"):
    """Windowed-sinc FIR design for lp/hp/bp/bs filters
    (reference firws.py:46-107); `f_c` in sampling units (max 0.5)."""
    if order % 2 != 0:
        order += 1
    if filter_type == "lp":
        return windowed_sinc(window, order, f_c)
    if filter_type == "hp":
        return invert_sinc(windowed_sinc(window, order, f_c))
    if filter_type == "bp":
        f_hp, f_lp = f_c
    else:  # bs
        f_lp, f_hp = f_c
    lp_kernel = windowed_sinc(window, order, f_lp)
    hp_kernel = invert_sinc(windowed_sinc(window, order, f_hp))
    kernel = lp_kernel + hp_kernel
    if filter_type == "bp":
        kernel[len(kernel) // 2] -= 1
    return kernel


@functools.lru_cache(maxsize=16)
def _minphaserceps_cached(kernel_bytes):
    fkernel = np.frombuffer(kernel_bytes, dtype=np.float64)
    nSamples = len(fkernel)
    nFFT = int(2 ** np.ceil(np.log2(nSamples * 1e3)))
    clipThresh = 1e-8
    specC = np.abs(np.fft.fft(fkernel, nFFT))
    specC[specC < clipThresh] = clipThresh
    specR = np.real(np.fft.ifft(np.log(specC)))
    ires = np.hstack([specR[1 : nFFT // 2], 0]) + np.conj(specR[nFFT // 2 : nFFT + 1][::-1])
    specR = np.hstack([specR[0], ires, np.zeros(nFFT // 2 - 2)])
    MinPhase = np.real(np.fft.ifft(np.exp(np.fft.fft(specR))))
    out = MinPhase[:nSamples]
    out.setflags(write=False)
    return out


def minphaserceps(fkernel):
    """Minimum-phase (causal) transform of an FIR kernel via the real
    cepstrum (reference firws.py:168-205). Its FFT has ~1000 times the
    kernel's length (2^20 points at order 1000), so results are cached per
    kernel."""
    kernel = np.ascontiguousarray(fkernel, dtype=np.float64)
    return _minphaserceps_cached(kernel.tobytes()).copy()


def fir_fft_length(n_samples, n_taps):
    """The FFT length of :func:`apply_fir`: the power of two above
    ``n_samples + n_taps - 1``."""
    return 1 << int(n_samples + n_taps - 1).bit_length()


def apply_fir(data, fkernel):
    """
    'same'-mode FIR convolution of a (N, T, C) batch with a 1d kernel along
    the time axis: one batched float32 rfft/irfft pair of length
    :func:`fir_fft_length`, cropped from ``(K - 1) // 2`` (reference
    firws.py:13-42).
    """
    T = data.shape[1]
    K = len(fkernel)
    L = fir_fft_length(T, K)
    X = torch.fft.rfft(data.to(torch.float32), n=L, dim=1)
    kern = torch.from_numpy(np.asarray(fkernel, dtype=np.float32)).to(data.device)
    Kf = torch.fft.rfft(kern, n=L)
    y = torch.fft.irfft(X * Kf[:, None], n=L, dim=1)
    start = (K - 1) // 2
    return y[:, start : start + T]


def apply_fir_time_sharded(x, fkernel, mesh, axis_name="trial"):
    """
    FIR filtering of one recording whose TIME axis is split over the
    positions of `mesh` along `axis_name` (syncopy_tpu/ops/filtering.py::
    apply_fir_time_sharded: the context-parallel analog for recordings too
    long for one device): each position receives a filter halo of ``(K -
    1) // 2`` samples from each neighbour (zeros at the recording's
    edges), convolves its extended block with :func:`apply_fir` on its
    own device and crops it; the full signal is never gathered. On a mesh
    that spans processes every rank calls this with the same arguments,
    uploads and filters only its own positions' blocks, and halos between
    ranks travel as point-to-point messages.

    Parameters
    ----------
    x : (nSamples, nChannels) array or tensor, nSamples divisible by the
        axis size; each block must hold at least the halo
    fkernel : odd-length 1d FIR kernel
    mesh : :class:`~syncopy_tpu_torch.parallel.mesh.Mesh`

    Returns
    -------
    y : :class:`~syncopy_tpu_torch.parallel.mesh.ShardedTensor`, float32
        (nSamples / n, nChannels) blocks along dim 0, one per position
        (None for another rank's)
    """
    from ..parallel.mesh import (ShardedTensor, axis_devices, axis_ranks, check_mesh,
                                 device_context, halo_exchange, split_along)

    K = len(fkernel)
    if K % 2 == 0:
        raise ValueError("apply_fir_time_sharded requires an odd-length kernel")
    devices, ranks = axis_devices(check_mesh(mesh), axis_name), axis_ranks(mesh, axis_name)
    T = x.shape[0]
    if T % len(devices):
        raise ValueError("nSamples must be divisible by the mesh axis size")
    halo = (K - 1) // 2
    if halo > T // len(devices):
        raise ValueError(
            "filter halo ({} samples) exceeds the local shard ({})".format(halo, T // len(devices)))
    blocks = split_along(torch.as_tensor(x).to(torch.float32), devices, ranks=ranks)
    out = []
    for ext, d in zip(halo_exchange(blocks, halo, halo, ranks), devices):
        if ext is None:
            out.append(None)
            continue
        with device_context(d):
            out.append(apply_fir(ext[None], fkernel)[0, halo : halo + T // len(devices)])
    return ShardedTensor(out, dim=0, shape=tuple(x.shape), ranks=ranks)


# ------------------------------------------------------------------------ #
# Butterworth IIR: the hand-written kernel
# ------------------------------------------------------------------------ #


def butter_sos(order, freq, filter_type, samplerate):
    """Second-order-sections Butterworth design (host-side scipy;
    reference compRoutines.py:264-265)."""
    return _sp_butter(order, freq, filter_type, fs=samplerate, output="sos").astype(np.float64)


def sosfilt(sos, x):
    """Cascade of biquad sections along the time axis of a (N, T, C) batch,
    zero-primed (scipy.signal.sosfilt); float64 inside, float32 out."""
    return sosfilt_batch(x.to(torch.float32).contiguous(), sos, twopass=False)


def sosfiltfilt(sos, x):
    """
    Zero-phase forward-backward filtering with odd extension and
    steady-state initial conditions (scipy.signal.sosfiltfilt semantics;
    reference compRoutines.py:268-270 uses it for `direction='twopass'`)
    along the time axis of a (N, T, C) batch; float64 inside, float32 out.
    """
    return sosfilt_batch(x.to(torch.float32).contiguous(), sos, twopass=True)


# ------------------------------------------------------------------------ #
# Hilbert transform (reference compRoutines.py:365-443, scipy.signal.hilbert)
# ------------------------------------------------------------------------ #


def hilbert(x):
    """Analytic signal along the time axis of a (N, T, C) batch
    (scipy.signal.hilbert semantics): float32 fft, the one-sided mask,
    ifft to complex64."""
    T = x.shape[1]
    X = torch.fft.fft(x.to(torch.float32), dim=1)
    h = np.zeros(T)
    if T % 2 == 0:
        h[0] = h[T // 2] = 1
        h[1 : T // 2] = 2
    else:
        h[0] = 1
        h[1 : (T + 1) // 2] = 2
    mask = torch.from_numpy(h.astype(np.float32)).to(x.device)
    return torch.fft.ifft(X * mask[:, None], dim=1).to(torch.complex64)


# ------------------------------------------------------------------------ #
# Resampling (reference resampling.py:15-140)
# ------------------------------------------------------------------------ #


def downsample(x, skipped):
    """Integer-factor downsampling along the time axis (reference
    resampling.py:90-120)."""
    return x[:, ::skipped]


@functools.lru_cache(maxsize=32)
def _resample_kernel(up, down, T, lpfreq, order, orig_fs):
    """Anti-alias FIR for polyphase resampling (reference resampling.py:60-85)."""
    fs_ratio = (up / down)
    if lpfreq is None:
        f_c = 0.5 * fs_ratio
    else:
        f_c = lpfreq / orig_fs
    if order is None:
        order = min(T * up, 10000)
    return design_wsinc("hamming", order=int(order), f_c=f_c / up)


def resample_poly(x, up, down, fkernel):
    """
    Polyphase resampling of a (N, T, C) batch: zero-stuff by `up`, FIR
    low-pass (gain `up`), take every `down`-th sample, centered like
    scipy.resample_poly; ``ceil(T * up / down)`` samples out.
    """
    N, T, C = x.shape
    out_len = int(np.ceil(T * up / down))
    upsampled = torch.zeros((N, T * up, C), dtype=torch.float32, device=x.device)
    upsampled[:, ::up] = x.to(torch.float32)
    filtered = apply_fir(upsampled, np.asarray(fkernel) * up)
    return filtered[:, ::down][:, :out_len]
