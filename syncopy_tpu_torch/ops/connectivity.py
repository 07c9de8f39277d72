# -*- coding: utf-8 -*-
#
# Connectivity ops on torch tensors: the dyadic product of precomputed
# spectra, coherence normalization and the compensated cross-spectral
# density sum.
#
# Port of a subset of syncopy_tpu/ops/connectivity.py
# (spectral_dyadic_product, normalize_csd, csd_sum_compensated). The rest
# of that module (Wilson, Granger, cross-covariance) lands with its slice
# (ROADMAP Queue 1).

import torch

from .spectral import spectral_convert

__all__ = ["spectral_dyadic_product", "normalize_csd", "csd_sum_compensated",
           "gram_sum_twosum"]


def spectral_dyadic_product(spec, send_idx=None, rec_idx=None):
    """
    Cross spectra from complex (time-)frequency spectra: outer product over
    the channel axis, tapers averaged (reference ST_compRoutines.py:29-120).

    Parameters
    ----------
    spec : (nTime, nTaper, nFreq, nChannel) complex tensor
    send_idx, rec_idx : optional channel index arrays restricting the
        product to (senders x receivers) combinations

    Returns
    -------
    CS : (nTime, nFreq, nSend, nRec) complex64
    """
    if send_idx is not None:
        a = spec.index_select(3, torch.as_tensor(send_idx, device=spec.device))
        b = spec.index_select(3, torch.as_tensor(rec_idx, device=spec.device))
    else:
        a = b = spec
    CS = torch.einsum("tkfi,tkfj->tfij", a, b.conj()) / spec.shape[1]
    return CS.to(torch.complex64)


def normalize_csd(csd_av, output="abs"):
    """Coherency from a trial-averaged CSD: ``C_ij = S_ij/sqrt(S_ii S_jj)``
    (reference csd.py:118-175)."""
    diag = torch.diagonal(csd_av, dim1=-2, dim2=-1)
    Ciijj = torch.sqrt((diag[..., :, None] * diag[..., None, :]).real)
    return spectral_convert(csd_av / Ciijj, output)


def _two_sum(a, b):
    """Error-free float add (Knuth): returns (s, e) with s + e == a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def gram_sum_twosum(rows, row_block):
    """
    ``cs[f, i, j] = sum_n rows[n, f, i] * conj(rows[n, f, j])`` over all
    rows of an (N, F, C) complex64 tensor, as the TPU kernels accumulate
    it: each group of `row_block` rows is one complex64 matmul per
    frequency, and the group partials combine by TwoSum into (hi, lo)
    float32 pairs, so the cross-group sum adds no rounding of its own.

    Returns (F, C, C) complex64.
    """
    N, F, C = rows.shape
    hi_r = torch.zeros((F, C, C), dtype=torch.float32, device=rows.device)
    lo_r, hi_i, lo_i = (torch.zeros_like(hi_r) for _ in range(3))
    for g0 in range(0, N, row_block):
        grp = rows[g0 : g0 + row_block].permute(1, 0, 2)  # (F, R, C)
        part = torch.matmul(grp.transpose(1, 2), grp.conj())  # (F, C, C)
        hi_r, e = _two_sum(hi_r, part.real)
        lo_r = lo_r + e
        hi_i, e = _two_sum(hi_i, part.imag)
        lo_i = lo_i + e
    return torch.complex(hi_r + lo_r, hi_i + lo_i)


def csd_sum_compensated(spec, sub=16):
    """
    Trial/taper-summed cross-spectral density ``sum_bk s_bki conj(s_bkj)``
    with compensated (double-float32) accumulation: `sub`-row partials
    (serial error <= sub*eps) combined by TwoSum. A plain serial float32
    sum over 1000 trials leaves ~3e-5 relative noise in the CSD, enough
    that no exact Wilson factorization of it exists (see the JAX
    package's docstring of the same function).

    Parameters
    ----------
    spec : (B, K, F, C) complex64 — per-trial tapered spectra (zero rows
        for padded trials contribute nothing)

    Returns
    -------
    (F, C, C) complex64 trial+taper SUM (not averaged)
    """
    B, K, F, C = spec.shape
    return gram_sum_twosum(spec.reshape(B * K, F, C), sub)
