"""Pairwise phase consistency of one dataset in float64: demean, the DPSS
bank, rfft, each trial's Gram over tapers, its unit phasor, the sum U over
trials, (|U|^2 - n) / (n (n - 1)). Adapted from ``chip_smoke.py::ppc_f64``
(:471), in blocks of trials.

Two numbers are compared. ``ppc_max_abs_err``: the largest absolute
difference over the bins whose spectra are complex. ``ppc_real_bins_excess``:
at DC, and at Nyquist for an even number of samples, the spectra of real
data are real, so each trial's cross-spectrum is a real number whose sign
is its phasor. Where it lies within float32 rounding of zero, rounding
decides that sign, and with it one unit term of U: PPC moves by up to
4 |U| / (n (n - 1)) (~1e-4 at 1000 trials) in a sound float32 program. So
there the reference gives, per pair, the interval of PPC over every sign of
the trials whose cross-spectrum lies within ``AMBIGUOUS`` of the pair's
scale (sqrt of the two channels' mean power over bins and tapers) of zero,
and the number is how far the program's PPC lies outside it. Every other
trial's sign is fixed, so a term lost, doubled or flipped beyond rounding
shows.

The control computes the same in float32 with each trial's Gram from
TF32-rounded spectra."""

import numpy as np
import torch

from . import coh
from . import tapers as tp

#: trials a block (a block's Gram is (b, F, C, C) complex128)
BLOCK = 25
#: a real-bin cross-spectrum within this share of its pair's scale of zero
#: may take either sign: 1e-5 is ~80 float32 units of rounding
AMBIGUOUS = 1e-5


def real_bins(cfg):
    """The bins whose spectra are real: DC, and Nyquist for an even number
    of samples."""
    F = cfg["samples"] // 2 + 1
    return [0, F - 1] if cfg["samples"] % 2 == 0 else [0]


def complex_bins(cfg):
    F = cfg["samples"] // 2 + 1
    return slice(1, F - 1 if cfg["samples"] % 2 == 0 else F)


def accumulate(payload, cfg, args, device, control=False):
    """U (F, C, C), and for the real bins the sum of the fixed signs and the
    count of the ambiguous ones (each (R, C, C))."""
    dtype = torch.float32 if control else torch.float64
    real = real_bins(cfg)
    U = fixed = loose = None
    for b0 in range(0, cfg["trials"], BLOCK):
        b1 = min(b0 + BLOCK, cfg["trials"])
        spec = coh.spectra(payload, cfg, args, device, dtype, b0, b1)  # (b, K, F, C)
        a = spec.permute(0, 2, 3, 1)  # (b, F, C, K)
        b = spec.conj().permute(0, 2, 1, 3)  # (b, F, K, C)
        cs = tp.cmatmul_tf32(a, b) if control else torch.matmul(a, b)
        mag = cs.abs()
        part = torch.where(mag > 0, cs / torch.where(mag > 0, mag, 1.0), 0).sum(dim=0)
        U = part if U is None else U + part
        if not control:
            power = (spec.abs() ** 2).sum(dim=1).mean(dim=1)  # (b, C)
            scale = torch.sqrt(power[:, :, None] * power[:, None, :])  # (b, C, C)
            x = cs[:, real].real  # (b, R, C, C)
            amb = x.abs() < AMBIGUOUS * scale[:, None]
            f_part = torch.where(amb, 0.0, torch.sign(x)).sum(dim=0)
            l_part = amb.sum(dim=0).to(torch.float64)
            fixed = f_part if fixed is None else fixed + f_part
            loose = l_part if loose is None else loose + l_part
    return U, fixed, loose


def ppc_of(U, n):
    return ((U.abs() ** 2 - n) / (n * (n - 1))).double().cpu().numpy()


def expected(payload, cfg, args, device):
    """``{"ppc": (F, C, C), "real_lo", "real_hi": (R, C, C)}``."""
    n = cfg["trials"]
    U, fixed, loose = accumulate(payload, cfg, args, device)
    s_max = fixed.abs() + loose
    s_min = torch.clamp(fixed.abs() - loose, min=0.0)
    lo = ((s_min ** 2 - n) / (n * (n - 1))).cpu().numpy()
    hi = ((s_max ** 2 - n) / (n * (n - 1))).cpu().numpy()
    return {"ppc": ppc_of(U, n), "real_lo": lo, "real_hi": hi}


def check(got, want, cfg):
    ref = want["ppc"]
    got = np.asarray(got, np.float64).reshape(ref.shape)
    inner = complex_bins(cfg)
    real = got[real_bins(cfg)]
    excess = np.maximum(np.maximum(want["real_lo"] - real, real - want["real_hi"]), 0.0)
    return {"ppc_max_abs_err": coh.compare(got[inner], ref[inner]),
            "ppc_real_bins_excess": float(excess.max()) if np.isfinite(real).all()
            else float("inf")}


def control(payload, cfg, args, device):
    U, _, _ = accumulate(payload, cfg, args, device, control=True)
    return ppc_of(U, cfg["trials"])


def work(cfg, args, trials):
    """The PPC sum: F bins, `trials` trials of K tapers, C channels."""
    k = tp.n_tapers(args["tapsmofrq"], cfg["samples"], cfg["samplerate"])
    return {"ppc": {"F": cfg["samples"] // 2 + 1, "n": trials, "K": k, "C": cfg["channels"]}}


def look(got, want, cfg):
    """Readings beside the compared numbers: the largest plain difference in
    the real bins, the most ambiguous trials a pair had there, and where the
    largest difference over all bins lies."""
    ref = want["ppc"]
    got = np.asarray(got, np.float64).reshape(ref.shape)
    d = np.abs(got - ref)
    f, i, j = np.unravel_index(int(d.argmax()), d.shape)
    width = want["real_hi"] - want["real_lo"]
    return {"ppc_real_bins_err": float(d[real_bins(cfg)].max()),
            "real_interval_max": float(width.max()), "largest_at": [int(f), int(i), int(j)]}
