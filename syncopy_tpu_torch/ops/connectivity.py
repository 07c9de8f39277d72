# -*- coding: utf-8 -*-
#
# Connectivity ops on torch tensors: coherence normalization and the
# compensated cross-spectral density sum.
#
# Port of the main-path subset of syncopy_tpu/ops/connectivity.py
# (normalize_csd, csd_sum_compensated). The rest of that module (Wilson,
# Granger, cross-covariance, PPC) lands with its slice (ROADMAP Queue 1).

import torch

from .spectral import spectral_convert

__all__ = ["normalize_csd", "csd_sum_compensated", "gram_sum_twosum"]


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
