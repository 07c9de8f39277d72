# -*- coding: utf-8 -*-
#
# Spectral ops on torch tensors: detrending, the (multi-)tapered FFT of a
# batch of trials, and the conversion of complex Fourier coefficients to
# the requested output.
#
# Port of syncopy_tpu/ops/spectral.py. Batched over a leading trial axis
# where the JAX functions take one trial (the JAX engine vmaps them). The
# JAX package's matmul DFT (ops/fft.py), a rewrite for the TPU's MXU, is
# not ported: the transform is one `torch.fft.rfft` (cuFFT on the card).

import torch

__all__ = ["detrend", "taper_segments", "mtmfft", "mtmfft_exact", "spectral_convert"]


def detrend(x, polyremoval, dim=-2):
    """
    De-mean (`polyremoval=0`) or linearly detrend (`polyremoval=1`) along
    `dim`. `polyremoval=None` is the identity.
    """
    if polyremoval is None:
        return x
    if polyremoval == 0:
        return x - x.mean(dim=dim, keepdim=True)
    if polyremoval == 1:
        n = x.shape[dim]
        t = torch.arange(n, dtype=x.dtype, device=x.device) - (n - 1) / 2.0
        shape = [1] * x.ndim
        shape[dim] = n
        t = t.reshape(shape)
        xm = x - x.mean(dim=dim, keepdim=True)
        slope = (t * xm).sum(dim=dim, keepdim=True) / (t * t).sum()
        return xm - t * slope
    raise ValueError("polyremoval must be None, 0 or 1")


def taper_segments(data, tapers, polyremoval=None, demean_taper=False, dtype=None):
    """
    The ``(B, K, T, C)`` tapered segments of a ``(B, T, C)`` trial batch,
    in `dtype` (default: the batch's): the per-trial detrend of
    `polyremoval`, the ``(K, T)`` taper bank, and with `demean_taper` the
    mean of each tapered segment subtracted (Granger pipelines; reference
    mtmfft.py:110-113).
    """
    x = detrend(data if dtype is None else data.to(dtype), polyremoval, dim=1)
    tapers = tapers.to(x.device, x.dtype)
    segments = tapers[None, :, :, None] * x[:, None, :, :]
    if demean_taper:
        segments = segments - segments.mean(dim=2, keepdim=True)
    return segments


def mtmfft(data, tapers, nfft, demean_taper=False):
    """
    Tapered Fourier transform of a batch of (detrended) trials.

    Parameters
    ----------
    data : (B, nSamples, nChannels) real tensor
    tapers : (nTaper, nSamples) tensor, the fully normalized taper bank
        (:func:`~syncopy_tpu_torch.ops.windows.make_tapers`)
    nfft : int, FFT length (>= nSamples; rfft zero-pads)
    demean_taper : bool, subtract the mean of each tapered segment

    Returns
    -------
    ftr : (B, nTaper, nfft//2+1, nChannels) complex, in the precision of
        `data`
    """
    return torch.fft.rfft(taper_segments(data, tapers, None, demean_taper), n=nfft, dim=2)


def mtmfft_exact(data, tapers, nfft, polyremoval=None, demean_taper=False):
    """
    :func:`mtmfft` in float64, detrend included, rounded to complex64 at
    the end: the same float64 route as the factorization-grade Granger CSD
    (``connectivity/ST_compRoutines.py::CrossSpectra`` with `exact_fft`),
    so ``freqanalysis(..., output='fourier', exact_fft=True)`` spectra
    carry only complex64's final rounding. The JAX package's compensated
    double-float32 DFT behind the same switch is limited to 1024 samples;
    this route has no limit on the length.
    """
    segments = taper_segments(data, tapers, polyremoval, demean_taper, torch.float64)
    return torch.fft.rfft(segments, n=nfft, dim=2).to(torch.complex64)


def spectral_convert(ftr, output):
    """Map complex Fourier coefficients to the requested output
    (reference const_def.py:12-37): single precision, or double for
    complex128 input."""
    double = ftr.dtype == torch.complex128
    real, cplx = (torch.float64, torch.complex128) if double else (torch.float32, torch.complex64)
    if output in ("fourier", "complex"):
        return ftr.to(cplx)
    if output == "pow":
        return (ftr * ftr.conj()).real.to(real)
    if output == "abs":
        return ftr.abs().to(real)
    if output == "real":
        return ftr.real.to(real)
    if output == "imag":
        return ftr.imag.to(real)
    if output == "angle":
        return ftr.angle().to(real)
    if output == "absreal":
        return ftr.real.abs().to(real)
    if output == "absimag":
        return ftr.imag.abs().to(real)
    raise ValueError("unknown output '{}'".format(output))
