# -*- coding: utf-8 -*-
#
# Connectivity ops on torch tensors: the dyadic product of precomputed
# spectra, coherence and cross-correlation normalization, the
# cross-covariance at non-negative lags, the compensated cross-spectral
# density sum, and Granger causality (CSD regularization, Wilson's
# spectral matrix factorization, the Granger-Geweke formula) with its host
# float64 oracle.
#
# Port of syncopy_tpu/ops/connectivity.py (spectral_dyadic_product,
# normalize_csd, normalize_ccov, _ccov_lags_fft, _ccov_lag_geometry,
# _ccov_assemble, cross_covariance_trial, ccov_batch_sum,
# csd_sum_compensated, csd_lam_extents, csd_reg_params, apply_csd_reg,
# psd_topup, regularize_csd, wilson_sf, granger and the numpy
# wilson_sf_host, regularize_csd_host, granger_host; wilson_sf_twosided is
# the host iteration on the device). Wilson runs the JAX
# package's complex128 route: the card computes float64 natively, so the
# float32 machinery the TPU needed (double-float32 DFT and Gram,
# compensated-residual Newton refinement, g-forcing of excluded bins, the
# GEMM form of the plus operator) is not ported. The cross-covariance
# takes the FFT route on every device; the lag-batched GEMM form
# (_ccov_lags_gemm) was shaped for the TPU's matrix unit and waits for a
# measurement on the card. wilson_sf_sharded and granger_sharded split
# Wilson's per-frequency work over the positions of a mesh axis and its
# lag-domain FFTs over channel rows, swapping the two layouts between
# positions (the all-to-all that GSPMD inserts in the JAX package), by
# copies in one process and by point-to-point messages across processes.

import numpy as np
import torch

from .spectral import detrend, spectral_convert

__all__ = ["spectral_dyadic_product", "normalize_csd", "normalize_ccov",
           "cross_covariance_trial", "cross_covariance_batch", "ccov_batch_sum",
           "csd_sum_compensated",
           "gram_sum_twosum", "csd_lam_extents", "csd_reg_params", "apply_csd_reg",
           "psd_topup", "regularize_csd", "wilson_sf", "wilson_sf_twosided", "granger",
           "wilson_sf_sharded", "granger_sharded",
           "wilson_sf_host",
           "regularize_csd_host", "granger_host"]


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
    (reference csd.py:118-175). The denominator is formed as
    ``sqrt(S_ii) * sqrt(S_jj)``: the product ``S_ii * S_jj`` leaves
    float32's range for data of amplitude below ~3e-10 (MEG in tesla),
    where the JAX package's coherence turns to 0/0."""
    root = torch.sqrt(torch.diagonal(csd_av, dim1=-2, dim2=-1).real)
    Ciijj = root[..., :, None] * root[..., None, :]
    return spectral_convert(csd_av / Ciijj, output)


def normalize_ccov(ccov_av):
    """Cross-correlation from a trial-averaged cross-covariance ``(nLags,
    1, N, N)``: divided by the 0-lag auto-covariances (reference
    AV_compRoutines.py:165-218). The denominator is formed as
    ``sqrt(R_ii) * sqrt(R_jj)``, so data in tesla (auto-covariance ~1e-26)
    keeps its range; the JAX package forms the product."""
    root = torch.sqrt(torch.diagonal(ccov_av[0, 0], dim1=-2, dim2=-1))
    return (ccov_av[:, 0] / (root[:, None] * root[None, :]))[:, None].to(torch.float32)


def _ccov_lags_fft(x, n_lags, delta):
    """Lags ``0 .. n_lags + delta - 1`` of ``R[..., l, i, j] = sum_m
    x_i[m] x_j[m-l]`` for ``(..., T, C)`` real `x`, by a zero-padded FFT
    correlation over all C^2 channel pairs (length ``2^ceil(log2(2T-1))``,
    2048 at T = 1000)."""
    T = x.shape[-2]
    L = 1 << int(2 * T - 1).bit_length()
    X = torch.fft.rfft(x, n=L, dim=-2)  # (..., Lf, C)
    R = torch.fft.irfft(X[..., :, None] * X[..., None, :].conj(), n=L, dim=-3)
    return R[..., : n_lags + delta, :, :]


def _ccov_lag_geometry(T):
    """The lag count and the upper triangle's offset for trial length T.

    The reference fills the upper triangle by reversing the 'same'-mode
    slice (ST_compRoutines.py:603-607), which lands on R_ij(l+1) for even
    trial lengths and on R_ij(l) for odd ones; reproduced exactly."""
    n_lags = T // 2 if T % 2 == 0 else T // 2 + 1
    delta = 1 if T % 2 == 0 else 0
    return n_lags, delta


def _ccov_assemble(R, T):
    """``(..., nLags, C, C)`` overlap-normalized cross-covariance from raw
    lags ``R[..., l, i, j] = sum_m x_i[m] x_j[m-l]`` (at least n_lags +
    delta of them)."""
    n_lags, delta = _ccov_lag_geometry(T)
    lower = R[..., :n_lags, :, :]  # R_ij(l), used for i >= j
    upper = R[..., delta : n_lags + delta, :, :]  # R_ij(l + delta) for i < j
    n_chan = R.shape[-1]
    low_mask = torch.ones((n_chan, n_chan), dtype=torch.bool, device=R.device).tril()
    CC = torch.where(low_mask, lower, upper)
    overlap = torch.arange(T, T - n_lags, -1, device=R.device).to(torch.float32)
    return CC / overlap[:, None, None]


def cross_covariance_batch(batch, polyremoval=0, norm=False):
    """
    Single-trial cross-covariance at non-negative lags of a ``(B, T, C)``
    batch (reference ST_compRoutines.py:465-610 runs a per-pair
    fftconvolve host loop): one batched FFT correlation.

    Returns ``(B, nLags, 1, C, C)`` float32 with ``CC[b, l, 0, i, j] =
    sum_m x_i[m] x_j[m-l] / (T - l)``; with `norm`, divided by the two
    channels' standard deviations (ddof 0).
    """
    x = detrend(batch.to(torch.float32), polyremoval, dim=1)
    T = x.shape[1]
    n_lags, delta = _ccov_lag_geometry(T)
    CC = _ccov_assemble(_ccov_lags_fft(x, n_lags, delta), T)
    if norm:
        stds = x.std(dim=1, unbiased=False)  # (B, C)
        CC = CC / (stds[:, None, :, None] * stds[:, None, None, :])
    return CC[:, :, None].to(torch.float32)


def cross_covariance_trial(trial, polyremoval=0, norm=False):
    """:func:`cross_covariance_batch` of one ``(T, C)`` trial: ``(nLags, 1,
    C, C)`` float32."""
    return cross_covariance_batch(trial[None], polyremoval, norm)[0]


def ccov_batch_sum(batch, n_valid, polyremoval=0):
    """
    Masked trial sum of the cross-covariance at non-negative lags, the
    ``keeptrials=False`` route: the per-trial cross-covariance is linear
    in the per-trial cross spectrum, so the trial sum accumulates in the
    frequency domain as one per-frequency trial Gram, followed by one
    inverse FFT for the whole batch (the per-trial lag tensors never
    exist).

    Returns ``(nLags, 1, C, C)`` float32, the sum of
    :func:`cross_covariance_trial` over the first `n_valid` rows of the
    ``(B, T, C)`` batch to FFT rounding.
    """
    B, T, _ = batch.shape
    x = detrend(batch.to(torch.float32), polyremoval, dim=1)
    # where-mask, not multiply: padding rows may hold NaN
    valid = torch.arange(B, device=x.device) < n_valid
    x = torch.where(valid[:, None, None], x, 0.0)
    L = 1 << int(2 * T - 1).bit_length()
    X = torch.fft.rfft(x, n=L, dim=1)  # (B, Lf, C)
    S = torch.einsum("bfi,bfj->fij", X, X.conj())
    R = torch.fft.irfft(S, n=L, dim=0)
    return _ccov_assemble(R, T)[:, None].to(torch.float32)


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


# ------------------------------------------------------------------------ #
# Granger causality: regularization, Wilson factorization, Granger formula
# (reference wilson_sf.py:16-262, granger.py:10-80). Every torch function
# takes leading batch dims: (..., F, N, N) CSDs, one factorization each.
# ------------------------------------------------------------------------ #

#: channel count from which csd_reg_params takes the Cholesky-bisection
#: extents (csd_lam_extents) instead of a batched eigvalsh; the JAX
#: package's threshold, set from TPU timings
_FAST_REG_MIN_CHAN = 96


def _real_dtype(cdtype):
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def _nan_where_failed(x, info):
    """`x` where the batched LAPACK-style `info` is 0, NaN elsewhere: a
    failed Cholesky or inverse yields NaN, as in the JAX package, instead
    of an exception (and of the host sync that checking it would cost)."""
    return torch.where((info == 0)[..., None, None], x, x.new_full((), float("nan")))


def _cholesky_nan(a):
    L, info = torch.linalg.cholesky_ex(a)
    return _nan_where_failed(L, info)


def _inv_nan(a):
    X, info = torch.linalg.inv_ex(a)
    return _nan_where_failed(X, info)


def csd_lam_extents(CSDh, bisect_rounds=30):
    """
    Per-frequency extreme eigenvalues of Hermitian ``(..., F, N, N)``
    matrices by Cholesky bisection, both ends at once: ``lam_min(A) > t``
    iff ``A - t I`` has a Cholesky factor, and ``lam_max(A) < t`` iff
    ``t I - A`` has one, so each round is one batched Cholesky of the
    ``(..., 2F, N, N)`` probes, starting from Gershgorin brackets
    (reference: syncopy_tpu ops/connectivity.py::csd_lam_extents).

    Returns ``(lo, hi, lam_max)``, each ``(..., F)``, with
    ``lo <= lam_min <= hi``.
    """
    F = CSDh.shape[-3]
    eye = torch.eye(CSDh.shape[-1], dtype=CSDh.dtype, device=CSDh.device)
    diag = torch.diagonal(CSDh, dim1=-2, dim2=-1).real
    radius = CSDh.abs().sum(dim=-1) - diag.abs()
    lo = (diag - radius).amin(dim=-1)  # Gershgorin: <= lam_min
    hi = diag.amin(dim=-1)  # min diagonal: >= lam_min
    lo_mx = diag.amax(dim=-1)  # max diagonal: <= lam_max
    hi_mx = (diag + radius).amax(dim=-1)  # Gershgorin: >= lam_max
    for _ in range(bisect_rounds):
        mid = 0.5 * (lo + hi)
        mid_mx = 0.5 * (lo_mx + hi_mx)
        probe = torch.cat([CSDh - mid[..., None, None] * eye,
                           mid_mx[..., None, None] * eye - CSDh], dim=-3)
        pd = torch.linalg.cholesky_ex(probe)[1] == 0
        pd_mn, pd_mx = pd[..., :F], pd[..., F:]
        lo, hi = torch.where(pd_mn, mid, lo), torch.where(pd_mn, hi, mid)
        lo_mx, hi_mx = torch.where(pd_mx, lo_mx, mid_mx), torch.where(pd_mx, mid_mx, hi_mx)
    return lo, hi, 0.5 * (lo_mx + hi_mx)


def csd_reg_params(CSD, cond_max=1e3, eps_max=1e-3, nSteps=15):
    """
    Regularization parameters of :func:`regularize_csd` for ``(..., F, N,
    N)`` CSDs: the per-frequency PSD-repair shift and the smallest loading
    ``eps`` (log-spaced up to `eps_max`) that brings every frequency's
    condition number below `cond_max`, both from the eigenvalue extremes
    (a batched eigvalsh below ``_FAST_REG_MIN_CHAN`` channels, Cholesky
    bisection from there; reference: syncopy_tpu
    ops/connectivity.py::csd_reg_params). The reductions run over F and N
    only: each batch element gets its own parameters.

    Returns ``(psd_shift (..., F), eps (...) [-1 marks failure],
    ini_cond (...))``.
    """
    rdtype = _real_dtype(CSD.dtype)
    epsilons = torch.cat([
        torch.zeros(1, dtype=rdtype),
        torch.from_numpy(np.logspace(-10, np.log10(eps_max), nSteps)).to(rdtype),
    ]).to(CSD.device)
    CSDh = (CSD + CSD.mH) / 2
    zero = torch.zeros((), dtype=rdtype, device=CSD.device)
    if CSD.shape[-1] >= _FAST_REG_MIN_CHAN:
        lam_lo, lam_hi, lam_max_f = csd_lam_extents(CSDh)
        lam_mid = 0.5 * (lam_lo + lam_hi)
        bin_scale = torch.maximum(lam_mid.abs(), lam_max_f)  # max |lam|
        raw_min = torch.clamp(lam_mid.abs(), min=torch.finfo(rdtype).tiny)
        ini_cond_raw = (bin_scale / raw_min).amax(dim=-1)
        lam_floor = 1e-6 * bin_scale
        # PSD repair from the bracket's lower edge: never under-lifts
        psd_shift = torch.where(lam_lo < lam_floor, torch.clamp(lam_floor - lam_lo, min=0), zero)
        smin = (lam_mid + psd_shift).abs()
        smax = lam_max_f + psd_shift
        conds = ((smax[..., None, :] + epsilons[:, None])
                 / (smin[..., None, :] + epsilons[:, None])).amax(dim=-1)  # (..., E+1)
    else:
        lam = torch.linalg.eigvalsh(CSDh)  # (..., F, N)
        # the initial condition number is that of the matrix as received
        raw_abs = lam.abs()
        ini_cond_raw = (raw_abs.amax(dim=-1) / raw_abs.amin(dim=-1)).amax(dim=-1)
        lam_min = lam.amin(dim=-1)
        # PSD repair: lift a frequency whose smallest eigenvalue lies below
        # 1e-6 of its largest to that floor; healthy bins are untouched
        lam_floor = 1e-6 * raw_abs.amax(dim=-1)
        psd_shift = torch.where(lam_min < lam_floor, torch.clamp(lam_floor - lam_min, min=0), zero)
        shifted = (lam[..., None, :, :] + psd_shift[..., None, :, None]
                   + epsilons[:, None, None]).abs()  # (..., E+1, F, N)
        conds = (shifted.amax(dim=-1) / shifted.amin(dim=-1)).amax(dim=-1)
    ok = conds < cond_max
    any_ok = ok.any(dim=-1)
    first_ok = torch.argmax(ok.to(torch.int8), dim=-1)  # smallest epsilon that works
    eps = torch.where(any_ok, epsilons[first_ok], torch.full((), -1.0, dtype=rdtype,
                                                             device=CSD.device))
    return psd_shift, eps, ini_cond_raw


def apply_csd_reg(CSD, psd_shift, eps, eps_max=1e-3):
    """Apply precomputed regularization: the per-frequency PSD-repair
    shift plus the loading ``eps`` (``eps = -1`` applies `eps_max`, the
    largest candidate)."""
    eye = torch.eye(CSD.shape[-1], dtype=CSD.dtype, device=CSD.device)
    eps_eff = torch.where(eps < 0, torch.full_like(eps, eps_max), eps)
    return CSD + (psd_shift[..., None, None] + eps_eff[..., None, None, None]) * eye


def psd_topup(CSDreg, rel_lift=3e-6, max_rounds=3):
    """Lift each frequency bin that has no Cholesky factor by `rel_lift`
    of its mean diagonal power, doubling up to `max_rounds` times: the
    safety net for regularization parameters shared between matrices."""
    diag = torch.diagonal(CSDreg, dim1=-2, dim2=-1).abs().mean(dim=-1)
    eye = torch.eye(CSDreg.shape[-1], dtype=CSDreg.dtype, device=CSDreg.device)
    lift = rel_lift * diag
    for _ in range(max_rounds):
        bad = (torch.linalg.cholesky_ex(CSDreg)[1] != 0)[..., None, None]
        CSDreg = torch.where(bad, CSDreg + lift[..., None, None] * eye, CSDreg)
        lift = 2 * lift
    return CSDreg


def regularize_csd(CSD, cond_max=1e3, eps_max=1e-3, nSteps=15):
    """
    Condition-number loading of ``(..., F, N, N)`` CSDs: add the smallest
    ``eps I`` that brings the worst per-frequency condition number below
    `cond_max` (reference wilson_sf.py:197-262), after lifting
    near-singular bins (:func:`csd_reg_params`).

    Returns ``(CSDreg, eps, initial_cond_num)``; ``eps = -1`` marks failure.
    """
    psd_shift, eps, ini_cond = csd_reg_params(CSD, cond_max, eps_max, nSteps)
    return apply_csd_reg(CSD, psd_shift, eps, eps_max=eps_max), eps, ini_cond


def _plus_operator_onesided(g, M):
    """The []+ operator on the non-negative half ``(B, F, N, N)`` of a
    conjugate-symmetric spectrum of two-sided length ``M = 2F - 2``: the
    causal part of its real lag sequence (half weight at lags 0 and M/2)
    back in frequency, and half the lag-0 term (reference
    wilson_sf.py:150-180)."""
    beta = torch.fft.irfft(g, n=M, dim=1)
    beta[:, 0] *= 0.5
    g0 = beta[:, 0].to(g.dtype)
    beta[:, M // 2] *= 0.5
    beta[:, M // 2 + 1 :] = 0
    return torch.fft.rfft(beta, dim=1), g0


def wilson_sf(CSD, nIter=100, rtol=1e-6):
    """
    Wilson's spectral matrix factorization ``CSD = psi psi^H`` of
    one-sided ``(..., F, N, N)`` CSDs (reference wilson_sf.py:16-128; the
    JAX package's complex128 route of ``_wilson_sf_impl``): Hermitized
    input scaled to unit mean auto-power, the zero-lag Cholesky start, one
    exact inverse per step (``inv_ex``), the plus operator by FFTs along
    frequency, and three exit tests per batch element (error below
    `rtol`, a plateau once the error is below 1e-2, a blow-up 100x above
    the best error after 5 steps). Bins with under 1e-9 of the largest
    mean auto-power are left out of the error.

    A batch runs as one Python loop with one host sync a step; each
    element is frozen where it would have stopped alone.

    Returns ``(Hfunc (..., F, N, N), Sigma (..., N, N), converged (...),
    err (...), n_iter (...))``; the step count is the port's addition.
    """
    lead = CSD.shape[:-3]
    F, N = CSD.shape[-3], CSD.shape[-1]
    CSD = CSD.reshape((-1, F, N, N))
    cdtype, rdtype = CSD.dtype, _real_dtype(CSD.dtype)
    eye = torch.eye(N, dtype=cdtype, device=CSD.device)

    CSD = (CSD + CSD.mH) / 2
    scale = torch.diagonal(CSD, dim1=-2, dim2=-1).abs().mean(dim=(-2, -1))  # (B,)
    CSD = CSD / scale[:, None, None, None]
    absCSD = CSD.abs()
    M = 2 * F - 2
    diag_power = torch.diagonal(CSD, dim1=-2, dim2=-1).abs().mean(dim=-1)  # (B, F)
    valid_bin = (diag_power > 1e-9 * diag_power.amax(dim=-1, keepdim=True))[..., None, None]

    # start: Cholesky factor of the zero-lag covariance (the sum over the
    # two-sided circle), the same at every frequency
    gamma0 = CSD.sum(dim=1) + CSD[:, 1 : F - 1].conj().sum(dim=1)
    gamma0 = ((gamma0 + gamma0.mH) / 2).real
    psi0 = _cholesky_nan(gamma0).mT.to(cdtype)  # (B, N, N)
    psi = psi0[:, None].expand(-1, F, -1, -1).clone()
    U = _cholesky_nan(CSD)

    B = CSD.shape[0]
    inf = torch.full((B,), float("inf"), dtype=rdtype, device=CSD.device)
    err, prev_err, best_err = inf, inf, inf
    it = torch.zeros(B, dtype=torch.int64, device=CSD.device)

    def running(err, prev_err, best_err, it):
        plateau = (err < 1e-2) & (prev_err - err < 1e-4 * err)
        blown = (err > 100 * best_err) & (it > 5)
        return (err >= rtol) & (it < nIter) & ~(plateau | blown)

    active = running(err, prev_err, best_err, it)
    while bool(active.any()):
        g = _inv_nan(psi) @ U
        gI = g @ g.mH + eye
        gplus, gplus_0 = _plus_operator_onesided(gI, M)
        S = torch.triu(gplus_0)
        S = S - S.mH
        psi_new = psi @ (gplus + S[:, None])
        psi0_new = psi0 @ (gplus_0 + S)
        rel = (CSD - psi_new @ psi_new.mH).abs() / absCSD
        new_err = torch.where(valid_bin, rel, 0.0).amax(dim=(1, 2, 3))
        step = active[:, None, None]
        psi = torch.where(step[..., None], psi_new, psi)
        psi0 = torch.where(step, psi0_new, psi0)
        prev_err = torch.where(active, err, prev_err)
        err = torch.where(active, new_err, err)
        best_err = torch.where(active, torch.minimum(best_err, new_err), best_err)
        it = it + active
        active = running(err, prev_err, best_err, it)

    Sigma = (psi0 @ psi0.mT) * scale[:, None, None]
    Hfunc = psi @ _inv_nan(psi0)[:, None]
    return (Hfunc.reshape(lead + (F, N, N)), Sigma.reshape(lead + (N, N)),
            (err < rtol).reshape(lead), err.reshape(lead), it.reshape(lead))


def wilson_sf_sharded(CSD, mesh=None, axis_name=None, nIter=100, rtol=1e-6):
    """
    :func:`wilson_sf` of one one-sided ``(F, N, N)`` CSD split over the
    positions of a mesh axis (syncopy_tpu/ops/connectivity.py::
    wilson_sf_sharded, for channel counts whose workspace exceeds one
    device): the per-frequency inverse, Cholesky and matrix products run
    on blocks of ``ceil(F / n)`` frequencies (the last ones shorter, as
    GSPMD pads an uneven axis), the plus operator's FFTs along frequency
    on blocks of channel rows; each step swaps the two layouts
    (:func:`~syncopy_tpu_torch.parallel.mesh.exchange`). The setup
    (Hermitizing, scaling, the zero-lag Cholesky start), the zero-lag
    update and the final inverse run on the axis's first position. The
    same iteration and exits as :func:`wilson_sf`, in the CSD's own
    precision.

    On a mesh that spans processes every rank of the mesh calls this with
    the same CSD. The rank of the axis's first position runs the setup and
    sends each position's frequency block to its owner; a rank computes
    only its own positions' blocks; the layout swaps, the zero-lag rows to
    the first position and its correction back are point-to-point
    messages, and every rank receives each block's error and takes their
    maximum (exact, so every rank takes the same number of steps). Every
    rank, one that owns no position of the axis too, returns the whole
    result on its ``mesh.home_device()``, bit for bit equal across ranks
    and to a one-process mesh of the same shape.

    Parameters
    ----------
    CSD : (F, N, N) complex tensor or array
    mesh : :class:`~syncopy_tpu_torch.parallel.mesh.Mesh`, default: the
        active mesh (none raises ValueError)
    axis_name : str, default: the mesh's first axis

    Returns
    -------
    ``(Hfunc (F, N, N), Sigma (N, N), converged, err, n_iter)`` on the
    mesh's home device, as :func:`wilson_sf` returns them.
    """
    from ..parallel.mesh import (Move, active_mesh, axis_devices, axis_ranks, check_mesh,
                                 device_context, exchange, process_rank, replicate, split_sizes)

    if mesh is None:
        mesh = active_mesh()
        if mesh is None:
            raise ValueError("no mesh given and no active mesh: use spt.use_mesh")
    if axis_name is None:
        axis_name = mesh.axis_names[0]
    devices = axis_devices(check_mesh(mesh), axis_name)
    ranks, me = axis_ranks(mesh, axis_name), process_rank()
    home, home_rank, out_dev = devices[0], ranks[0], mesh.home_device()
    CSD = torch.as_tensor(CSD)
    F, N = CSD.shape[0], CSD.shape[-1]
    cdtype, rdtype = CSD.dtype, _real_dtype(CSD.dtype)
    M = 2 * F - 2

    valid_bin = psi0 = scale = None
    if me != home_rank:
        CSD = None  # the first position's rank sends each block
    else:
        with device_context(home):
            CSD = CSD.to(home)
            CSD = (CSD + CSD.mH) / 2
            scale = torch.diagonal(CSD, dim1=-2, dim2=-1).abs().mean()
            CSD = CSD / scale
            diag_power = torch.diagonal(CSD, dim1=-2, dim2=-1).abs().mean(dim=-1)  # (F,)
            valid_bin = diag_power > 1e-9 * diag_power.amax()
            gamma0 = CSD.sum(dim=0) + CSD[1 : F - 1].conj().sum(dim=0)
            gamma0 = ((gamma0 + gamma0.mH) / 2).real
            psi0 = _cholesky_nan(gamma0).mT.to(cdtype)  # (N, N)

    # the frequency layout: (F_p, N, N) blocks on positions `freq`; the row
    # layout: (F, R_q, N) blocks on positions `rows`
    f_sizes, r_sizes = split_sizes(F, len(devices)), split_sizes(N, len(devices))
    f_bounds, r_bounds = np.cumsum([0] + f_sizes), np.cumsum([0] + r_sizes)
    freq = [p for p in range(len(devices)) if f_sizes[p]]
    rows = [q for q in range(len(devices)) if r_sizes[q]]
    mine = [p for p in freq if ranks[p] == me]

    def from_home(tensor):
        """An (N, N) `tensor` of the first position sent to every
        frequency block's."""
        return [Move(tensor, home_rank, ranks[p], devices[p], (N, N), cdtype) for p in freq]

    def cut(t, p):
        return None if t is None else t.narrow(0, int(f_bounds[p]), f_sizes[p])

    def everywhere(items, dtype):
        """`items` of ``(tensor, owner rank, shape)`` on every rank of the
        mesh, on its ``out_dev``."""
        return replicate(items, mesh.processes, out_dev, dtype)

    setup = exchange(
        [Move(cut(CSD, p), home_rank, ranks[p], devices[p], (f_sizes[p], N, N), cdtype)
         for p in freq]
        + [Move(cut(valid_bin, p), home_rank, ranks[p], devices[p], (f_sizes[p],), torch.bool)
           for p in freq]
        + from_home(psi0))
    blocks, eyes, U, absCSD, psi = {}, {}, {}, {}, {}
    for k, p in enumerate(freq):
        if p in mine:
            c, v, start = setup[k], setup[len(freq) + k], setup[2 * len(freq) + k]
            with device_context(devices[p]):
                blocks[p] = (c, v)
                eyes[p] = torch.eye(N, dtype=cdtype, device=devices[p])
                U[p] = _cholesky_nan(c)
                absCSD[p] = c.abs()
                psi[p] = start.expand(c.shape[0], -1, -1).clone()

    inf = torch.full((), float("inf"), dtype=rdtype, device=out_dev)
    err, prev_err, best_err = inf, inf, inf
    it = torch.zeros((), dtype=torch.int64, device=out_dev)

    def running(err, prev_err, best_err, it):
        plateau = (err < 1e-2) & (prev_err - err < 1e-4 * err)
        blown = (err > 100 * best_err) & (it > 5)
        return (err >= rtol) & (it < nIter) & ~(plateau | blown)

    while bool(running(err, prev_err, best_err, it)):
        gI = {}
        for p in mine:
            with device_context(devices[p]):
                g = _inv_nan(psi[p]) @ U[p]
                gI[p] = g @ g.mH + eyes[p]
        # frequency -> row layout, the plus operator along frequency
        pieces = iter(exchange([
            Move(gI[p][:, r_bounds[q] : r_bounds[q + 1]] if p in gI else None, ranks[p],
                 ranks[q], devices[q], (f_sizes[p], r_sizes[q], N), cdtype)
            for q in rows for p in freq]))
        gplus_r, g0_r = {}, {}
        for q in rows:
            parts = [next(pieces) for _ in freq]
            if ranks[q] == me:
                with device_context(devices[q]):
                    gp, g0 = _plus_operator_onesided(torch.cat(parts, dim=0)[None], M)
                    gplus_r[q], g0_r[q] = gp[0], g0[0]
        g0_rows = exchange([Move(g0_r.get(q), ranks[q], home_rank, home, (r_sizes[q], N), cdtype)
                            for q in rows])
        S = None
        if me == home_rank:
            with device_context(home):
                g0 = torch.cat(g0_rows, dim=0)  # (N, N)
                S = torch.triu(g0)
                S = S - S.mH
                psi0 = psi0 @ (g0 + S)
        S_at = exchange(from_home(S))
        # row -> frequency layout, the step and its error per block
        pieces = iter(exchange([
            Move(cut(gplus_r.get(q), p), ranks[q], ranks[p], devices[p],
                 (f_sizes[p], r_sizes[q], N), cdtype)
            for p in freq for q in rows]))
        errs = {}
        for k, p in enumerate(freq):
            parts = [next(pieces) for _ in rows]
            if p in mine:
                c, v = blocks[p]
                with device_context(devices[p]):
                    psi[p] = psi[p] @ (torch.cat(parts, dim=1) + S_at[k])
                    rel = (c - psi[p] @ psi[p].mH).abs() / absCSD[p]
                    errs[p] = torch.where(v[:, None, None], rel, 0.0).amax()
        new_err = torch.stack(everywhere([(errs.get(p), ranks[p], ()) for p in freq],
                                         rdtype)).amax()
        prev_err, err = err, new_err
        best_err = torch.minimum(best_err, new_err)
        it = it + 1

    Sigma = inv0 = None
    if me == home_rank:
        with device_context(home):
            Sigma = (psi0 @ psi0.mT) * scale
            inv0 = _inv_nan(psi0)
    inv_at = exchange(from_home(inv0))
    Hfunc = {}
    for k, p in enumerate(freq):
        if p in mine:
            with device_context(devices[p]):
                Hfunc[p] = psi[p] @ inv_at[k]
    Hfunc = torch.cat(everywhere([(Hfunc.get(p), ranks[p], (f_sizes[p], N, N)) for p in freq],
                                 cdtype), dim=0)
    Sigma = everywhere([(Sigma, home_rank, (N, N))], cdtype)[0]
    return Hfunc, Sigma, err < rtol, err, it


def granger_sharded(CSD, mesh=None, axis_name=None, rtol=5e-6, nIter=100, cond_max=1e4):
    """
    Granger-Geweke causality from one trial-averaged ``(F, N, N)`` CSD too
    wide for one device (syncopy_tpu/ops/connectivity.py::
    granger_sharded): :func:`regularize_csd` on the mesh axis's first
    position, :func:`wilson_sf_sharded`, then :func:`granger` there, in
    complex128 (the port's Granger precision). On a mesh that spans
    processes every rank of the mesh calls this with the same CSD, and the
    rank of the axis's first position sends G and the regularization's
    factor and condition number to the others, so that every rank returns
    the same bits.

    Returns ``(G (F, N, N) float64, info)`` on the mesh's home device,
    `info` holding the frontend's ``out.info`` diagnostics.
    """
    from ..parallel.mesh import (active_mesh, axis_devices, axis_ranks, check_mesh,
                                 device_context, process_rank, replicate)

    if mesh is None:
        mesh = active_mesh()
        if mesh is None:
            raise ValueError("no mesh given and no active mesh: use spt.use_mesh")
    axis_name = axis_name or mesh.axis_names[0]
    home = axis_devices(check_mesh(mesh), axis_name)[0]
    home_rank = axis_ranks(mesh, axis_name)[0]
    CSD = torch.as_tensor(CSD)
    G = reg = None
    if process_rank() == home_rank:
        with device_context(home):
            CSD = CSD.to(home, torch.complex128)
            CSD, factor, ini_cn = regularize_csd(CSD, cond_max=cond_max, eps_max=1e-1)
            reg = torch.stack([torch.as_tensor(v, dtype=torch.float64, device=home)
                               for v in (factor, ini_cn)])
    H, Sigma, conv, err, _ = wilson_sf_sharded(CSD.to(torch.complex128), mesh=mesh,
                                               axis_name=axis_name, nIter=nIter, rtol=rtol)
    if process_rank() == home_rank:
        with device_context(home):
            G = granger(CSD, H, Sigma)
    F, N = CSD.shape[0], CSD.shape[-1]
    G, reg = replicate([(G, home_rank, (F, N, N)), (reg, home_rank, (2,))], mesh.processes,
                       mesh.home_device(), torch.float64)
    info = {
        "converged": bool(conv),
        "max rel. err": float(err),
        "reg. factor": float(reg[0]),
        "initial cond. num": float(reg[1]),
    }
    return G, info


def wilson_sf_twosided(CSD, nIter=100, rtol=1e-6):
    """
    :func:`wilson_sf_host`'s iteration on the device, batched over the
    leading dims of one-sided ``(..., F, N, N)`` CSDs: the two-sided
    spectrum of all 2F - 2 bins, complex FFTs, the tolerance and plateau
    exits (no blow-up exit), each element frozen where it stops alone.
    The same iteration as :func:`wilson_sf` with other rounding; where a
    demeaned DC bin's rounding noise makes the one-sided form diverge it
    can still converge, so GrangerCausality retries jackknife replicates
    with it before any host fallback.

    Returns ``(Hfunc (..., F, N, N), Sigma (..., N, N), converged (...),
    err (...), n_iter (...))``, as :func:`wilson_sf`.
    """
    lead = CSD.shape[:-3]
    F, N = CSD.shape[-3], CSD.shape[-1]
    CSD = CSD.reshape((-1, F, N, N))
    rdtype = _real_dtype(CSD.dtype)
    eye = torch.eye(N, dtype=CSD.dtype, device=CSD.device)

    CSD = (CSD + CSD.mH) / 2
    scale = torch.diagonal(CSD, dim1=-2, dim2=-1).abs().mean(dim=(-2, -1))  # (B,)
    full = torch.cat([CSD, CSD[:, 1 : F - 1].flip(1).conj()], dim=1) / scale[:, None, None, None]
    M = full.shape[1]
    absfull = full.abs()
    diag_power = torch.diagonal(full, dim1=-2, dim2=-1).abs().mean(dim=-1)  # (B, M)
    valid_bin = (diag_power > 1e-9 * diag_power.amax(dim=-1, keepdim=True))[..., None, None]

    gamma0 = torch.fft.fft(full, dim=1)[:, 0]
    gamma0 = ((gamma0 + gamma0.mH) / 2).real
    psi0 = _cholesky_nan(gamma0).mT.to(CSD.dtype)  # (B, N, N)
    psi = psi0[:, None].expand(-1, M, -1, -1).clone()
    U = _cholesky_nan(full)

    B = full.shape[0]
    inf = torch.full((B,), float("inf"), dtype=rdtype, device=CSD.device)
    err, prev_err = inf, inf
    it = torch.zeros(B, dtype=torch.int64, device=CSD.device)
    active = torch.ones(B, dtype=torch.bool, device=CSD.device)
    while bool(active.any()):
        g = _inv_nan(psi) @ U
        g = g @ g.mH + eye
        beta = torch.fft.ifft(g, dim=1).real.to(CSD.dtype)
        beta[:, 0] *= 0.5
        g0 = beta[:, 0].clone()
        beta[:, M // 2] *= 0.5
        beta[:, M // 2 + 1 :] = 0
        S = torch.triu(g0)
        S = S - S.mH
        psi_new = psi @ (torch.fft.fft(beta, dim=1) + S[:, None])
        psi0_new = psi0 @ (g0 + S)
        rel = (full - psi_new @ psi_new.mH).abs() / absfull
        new_err = torch.where(valid_bin, rel, 0.0).amax(dim=(1, 2, 3))
        step = active[:, None, None]
        psi = torch.where(step[..., None], psi_new, psi)
        psi0 = torch.where(step, psi0_new, psi0)
        prev_err = torch.where(active, err, prev_err)
        err = torch.where(active, new_err, err)
        it = it + active
        plateau = (err < 1e-2) & (prev_err - err < 1e-4 * err)
        active = active & (err >= rtol) & (it < nIter) & ~plateau & ~torch.isnan(err)

    Sigma = (psi0 @ psi0.mT) * scale[:, None, None]
    Hfunc = (psi @ _inv_nan(psi0)[:, None])[:, :F]
    return (Hfunc.reshape(lead + (F, N, N)), Sigma.reshape(lead + (N, N)),
            (err < rtol).reshape(lead), err.reshape(lead), it.reshape(lead))


def granger(CSD, Hfunc, Sigma):
    """
    Pairwise Granger-Geweke causality, Eq. 8 of Dhamala et al. 2008
    (reference granger.py:10-80), for ``(..., F, N, N)`` CSDs:
    ``G[..., f, i, j]`` is the causality i -> j. Bins with under 1e-9 of
    the largest mean auto-power are returned as 0.
    """
    auto_spectra = torch.diagonal(CSD, dim1=-2, dim2=-1).abs()  # (..., F, N)
    Smat = auto_spectra[..., None, :]  # [f, i, j] = S_jj(f)
    Hmat = Hfunc.mT.abs() ** 2
    auto_cov = torch.diagonal(Sigma, dim1=-2, dim2=-1).abs()  # (..., N)
    # [i, j] = Sigma_ii - Sigma_ji^2 / Sigma_jj
    denom = auto_cov[..., :, None] - Sigma.mT.abs() ** 2 / auto_cov[..., None, :]
    G = torch.log(Smat / (Smat - denom[..., None, :, :] * Hmat))
    dpow = auto_spectra.mean(dim=-1)
    valid = dpow > 1e-9 * dpow.amax(dim=-1, keepdim=True)
    return torch.where(valid[..., None, None], G, 0.0)


# ------------------------------------------------------------------------ #
# host float64 oracle (numpy; copied from syncopy_tpu ops/connectivity.py)
# ------------------------------------------------------------------------ #


def wilson_sf_host(CSD, nIter=100, rtol=1e-6):
    """
    Host float64 Wilson factorization in numpy, two-sided: the same
    algorithm as :func:`wilson_sf`, used where the device route is gated
    off or did not converge.
    """
    CSD = np.asarray(CSD, dtype=np.complex128)
    CSD = (CSD + np.conj(np.swapaxes(CSD, 1, 2))) / 2
    nFreq, N = CSD.shape[0], CSD.shape[1]
    Ident = np.eye(N)

    scale = np.mean(np.abs(np.einsum("fii->fi", CSD)))
    CSD = CSD / scale
    CSDfull = np.concatenate([CSD, np.conj(CSD[nFreq - 2 : 0 : -1])], axis=0)

    diag_power = np.mean(np.abs(np.einsum("fii->fi", CSDfull)), axis=1)
    valid_bin = (diag_power > 1e-9 * diag_power.max())[:, None, None]

    gamma0 = np.fft.fft(CSDfull, axis=0)[0]
    gamma0 = np.real((gamma0 + np.conj(gamma0.T)) / 2)
    psi0 = np.linalg.cholesky(gamma0).T
    psi = np.tile(psi0, (CSDfull.shape[0], 1, 1)).astype(np.complex128)
    psi0 = psi0.astype(np.complex128)

    U = np.linalg.cholesky(CSDfull)
    err = np.inf
    converged = False
    n_lag = CSDfull.shape[0] // 2
    prev_err = np.inf
    for _ in range(nIter):
        g = np.linalg.inv(psi) @ U
        g = g @ np.conj(np.swapaxes(g, 1, 2)) + Ident
        beta = np.real(np.fft.ifft(g, axis=0)).astype(np.complex128)
        beta[0] *= 0.5
        g0 = beta[0].copy()
        beta[n_lag] *= 0.5
        beta[n_lag + 1 :] = 0
        gplus = np.fft.fft(beta, axis=0)
        S = np.triu(g0)
        S = S - np.conj(S.T)
        psi = psi @ (gplus + S)
        psi0 = psi0 @ (g0 + S)
        CSDfac = psi @ np.conj(np.swapaxes(psi, 1, 2))
        rel = np.abs(CSDfull - CSDfac) / np.abs(CSDfull)
        err = float(np.max(np.where(valid_bin, rel, 0.0)))
        if err < rtol:
            converged = True
            break
        if err < 1e-2 and prev_err - err < 1e-4 * err:
            # fixed point above tolerance: no further progress possible
            break
        prev_err = err

    Sigma = (psi0 @ psi0.T) * scale
    Hfunc = psi @ np.linalg.inv(psi0)
    return Hfunc[:nFreq], Sigma, converged, err


def regularize_csd_host(CSD, cond_max=1e3, eps_max=1e-3, nSteps=15):
    """Host float64 counterpart of :func:`regularize_csd` (PSD repair,
    then the smallest loading by SVD condition numbers)."""
    CSD = np.asarray(CSD, dtype=np.complex128)
    I = np.eye(CSD.shape[1])
    CSDh = (CSD + np.conj(np.swapaxes(CSD, 1, 2))) / 2
    lam = np.linalg.eigvalsh(CSDh)
    lam_min = lam.min(axis=1)
    lam_floor = 1e-6 * np.abs(lam).max(axis=1)
    psd_shift = np.where(lam_min < lam_floor, lam_floor - lam_min, 0.0)
    CSD = CSD + psd_shift[:, None, None] * I
    ini = float(np.linalg.cond(CSD).max())
    if ini < cond_max:
        return CSD, 0.0, ini
    for eps in np.logspace(-10, np.log10(eps_max), nSteps):
        CSDreg = CSD + eps * I
        if float(np.linalg.cond(CSDreg).max()) < cond_max:
            return CSDreg, float(eps), ini
    return CSDreg, -1.0, ini


def granger_host(CSD, Hfunc, Sigma):
    """Host float64 counterpart of :func:`granger` (same Eq. 8, same
    zeroing of near-zero-power bins)."""
    CSD, Hfunc, Sigma = (np.asarray(a) for a in (CSD, Hfunc, Sigma))
    nChannels = CSD.shape[1]
    auto_spectra = np.abs(np.einsum("fii->fi", CSD))
    Smat = auto_spectra[:, None, :] * np.ones((nChannels, 1))
    Hmat = np.abs(np.swapaxes(Hfunc, 1, 2)) ** 2
    SigmaJI = np.abs(Sigma.T)
    auto_cov = np.abs(np.diag(Sigma))
    SigmaII = auto_cov[None, :] * np.ones((nChannels, 1))
    denom = SigmaII.T - SigmaJI**2 / SigmaII
    denom = Smat - denom * Hmat
    dpow = auto_spectra.mean(axis=1)
    valid = dpow > 1e-9 * dpow.max()
    # mask excluded bins before the log, so that only bins with power can
    # raise the divide/log warnings
    ratio = np.where(valid[:, None, None], Smat / np.where(
        valid[:, None, None], denom, 1.0), 1.0)
    return np.log(ratio)
