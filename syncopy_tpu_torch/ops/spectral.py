# -*- coding: utf-8 -*-
#
# Spectral helpers on torch tensors: detrending and the conversion of
# complex Fourier coefficients to the requested output.
#
# Port of syncopy_tpu/ops/spectral.py (detrend, spectral_convert). The
# tapered FFT itself is one `torch.fft.rfft` call in the compute routines.

import torch

__all__ = ["detrend", "spectral_convert"]


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
