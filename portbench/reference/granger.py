"""Granger causality of one dataset, apart from the port: the trial-averaged
CSD in float64, the regularization, Wilson's two-sided factorization in
complex128 and the Granger-Geweke formula (Dhamala et al. 2008, Eq. 8), on
the card, the CSD in blocks of trials so that it fits.

Adapted from ``chip_smoke.py::granger_csd_f64`` (:530) and
``granger_oracle`` (:552). Departures, each below the complex64 rounding
of the CSD that both sides share:

- the taper is the port's Hann window written out here
  (``tapers.bank``: scipy's ``hann`` with syncopy's normalization) in
  float64, where the port rounds its taper bank to float32;
- the condition numbers of the loading are those of the Hermitian part,
  from its eigenvalues (max |lambda| / min |lambda|, which an SVD gives for
  a Hermitian matrix), where chip_smoke's oracle takes an SVD per
  candidate.

The control is the same with the factorization in complex64, the precision
below the configuration's complex128. TF32 is off for every product here.
"""

import contextlib

import numpy as np
import torch

from . import tapers as tp
from .coh import compare

#: trials a block of the CSD
BLOCK = 100


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the block's products; the settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def csd(payload, cfg, args, device):
    """(F, C, C) complex128 trial-averaged CSD: each trial demeaned, the
    Hann taper, the tapered trial demeaned (Granger's demeaned taper),
    rfft, the float64 sum of the outer products over trials over their
    number; rounded to complex64 as the port rounds its own, then taken
    back to complex128."""
    T, C, n = cfg["samples"], cfg["channels"], cfg["trials"]
    w = torch.from_numpy(tp.bank(args, T, cfg["samplerate"])[0].astype(np.float32)).to(device, torch.float64)
    acc = torch.zeros((T // 2 + 1, C, C), dtype=torch.complex128, device=device)
    for b0 in range(0, n, BLOCK):
        b1 = min(b0 + BLOCK, n)
        x = torch.from_numpy(payload[b0 * T : b1 * T]).to(device).reshape(b1 - b0, T, C)
        x = w[None, :, None] * (x.double() - x.double().mean(dim=1, keepdim=True))
        rows = torch.fft.rfft(x - x.mean(dim=1, keepdim=True), dim=1).permute(1, 0, 2)
        acc += torch.matmul(rows.transpose(1, 2), rows.conj())  # (F, C, C)
    return (acc / n).to(torch.complex64).to(torch.complex128)


def regularize(csd, wil):
    """The PSD repair (a bin whose smallest eigenvalue lies below 1e-6 of
    its largest |eigenvalue| lifted to that floor) and the smallest loading
    ``eps I`` of the grid [0, logspace(-10, log10(eps_max), 15)] that brings
    every bin's condition number below ``cond_max`` (none: ``eps_max``)."""
    eye = torch.eye(csd.shape[-1], dtype=csd.dtype, device=csd.device)
    lam = torch.linalg.eigvalsh((csd + csd.mH) / 2)  # (F, N)
    floor = 1e-6 * lam.abs().amax(dim=1)
    lam_min = lam.amin(dim=1)
    shift = torch.where(lam_min < floor, floor - lam_min, 0.0)
    lam = lam + shift[:, None]

    def cond(e):
        a = (lam + e).abs()
        return (a.amax(dim=1) / a.amin(dim=1)).amax().item()

    eps = 0.0 if cond(0.0) < wil["cond_max"] else next(
        (float(e) for e in np.logspace(-10, np.log10(wil["eps_max"]), 15)
         if cond(float(e)) < wil["cond_max"]), -1.0)
    return csd + (shift + (wil["eps_max"] if eps < 0 else eps))[:, None, None] * eye


def wilson(csd, wil, dtype=torch.complex128):
    """Wilson's factorization on the two-sided spectrum of all 2F - 2 bins
    in `dtype`: the zero-lag Cholesky start, an inverse a step, FFTs over
    the bins, exits at ``rtol``, at a plateau once the error is under 1e-2,
    or after ``nIter`` steps. Returns (H (F, N, N), Sigma (N, N)) in
    complex128."""
    F, N = csd.shape[0], csd.shape[-1]
    C = ((csd + csd.mH) / 2).to(dtype)
    scale = torch.diagonal(C, dim1=1, dim2=2).abs().mean()
    C = C / scale
    full = torch.cat([C, C[1 : F - 1].flip(0).conj()])  # (M, N, N)
    eye = torch.eye(N, dtype=dtype, device=csd.device)
    power = torch.diagonal(full, dim1=1, dim2=2).abs().mean(dim=1)
    valid = (power > 1e-9 * power.max())[:, None, None]
    gamma0 = torch.fft.fft(full, dim=0)[0]
    psi0 = torch.linalg.cholesky(((gamma0 + gamma0.mH) / 2).real).mT.to(dtype)
    psi = psi0.expand(full.shape[0], N, N).clone()
    U = torch.linalg.cholesky(full)
    n_lag = full.shape[0] // 2
    prev_err = float("inf")
    for _ in range(wil["nIter"]):
        g = torch.linalg.inv(psi) @ U
        g = g @ g.mH + eye
        beta = torch.fft.ifft(g, dim=0).real.to(dtype)
        beta[0] *= 0.5
        g0 = beta[0].clone()
        beta[n_lag] *= 0.5
        beta[n_lag + 1 :] = 0
        S = torch.triu(g0)
        S = S - S.mH
        psi = psi @ (torch.fft.fft(beta, dim=0) + S)
        psi0 = psi0 @ (g0 + S)
        rel = (full - psi @ psi.mH).abs() / full.abs()
        err = torch.where(valid, rel, 0.0).max().item()
        if err < wil["rtol"] or (err < 1e-2 and prev_err - err < 1e-4 * err):
            break
        prev_err = err
    Sigma = (psi0 @ psi0.mT) * scale
    H = (psi @ torch.linalg.inv(psi0))[:F]
    return H.to(torch.complex128), Sigma.to(torch.complex128)


def formula(csd, H, Sigma):
    """Eq. 8: ``G[f, i, j]``, the causality i -> j, 0 in bins with under
    1e-9 of the largest mean auto-power."""
    auto = torch.diagonal(csd, dim1=1, dim2=2).abs()  # (F, N)
    cov = torch.diagonal(Sigma).abs()
    denom = cov[:, None] - Sigma.mT.abs() ** 2 / cov[None, :]
    dpow = auto.mean(dim=1)
    keep = (dpow > 1e-9 * dpow.max())[:, None, None]
    Smat = auto[:, None, :]
    ratio = torch.where(keep, Smat / torch.where(keep, Smat - denom * H.mT.abs() ** 2, 1.0), 1.0)
    return torch.log(ratio)


def compute(payload, cfg, args, device, dtype=torch.complex128):
    with no_tf32():
        reg = regularize(csd(payload, cfg, args, device), cfg["wilson"])
        H, Sigma = wilson(reg, cfg["wilson"], dtype)
        return formula(reg, H, Sigma).cpu().numpy()


def expected(payload, cfg, args, device):
    return compute(payload, cfg, args, device)


def check(got, want, cfg):
    return {"granger_max_abs_err": compare(got, want)}


def look(got, want, cfg):
    """Where the largest difference lies: its bin, and the largest
    difference past the two bins next to DC."""
    d = np.abs(np.asarray(got, np.float64).reshape(want.shape) - want)
    if not np.isfinite(d).all():
        return {}
    return {"bin": int(np.unravel_index(np.argmax(d), d.shape)[0]),
            "past_bin_2": float(d[3:].max()) if d.shape[0] > 3 else 0.0}


def control(payload, cfg, args, device):
    return compute(payload, cfg, args, device, dtype=torch.complex64)


def work(cfg, args, trials):
    """Wilson's factorization: F bins of N x N matrices (its steps are the
    trace's)."""
    return {"wilson": {"F": cfg["samples"] // 2 + 1, "N": cfg["channels"]}}
