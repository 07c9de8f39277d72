"""Coherence of one dataset in float64: demean each trial, the DPSS bank
(reference/tapers.py), rfft, the trial x taper CSD sum, |S_ij| /
sqrt(S_ii S_jj). Adapted from ``chip_smoke.py::coherence_f64`` (:495), in
blocks of trials so that it fits beside nothing else on the card.

The control computes the same in float32 with the CSD's products from
TF32-rounded spectra: the precision below the program's float32 with TF32
off."""

import numpy as np
import torch

from . import tapers as tp

#: trials a block
BLOCK = 100


def spectra(payload, cfg, args, device, dtype, b0, b1):
    """(b, K, F, C) spectra of trials b0..b1 in `dtype` (float64 or
    float32) on `device`."""
    T, C = cfg["samples"], cfg["channels"]
    x = torch.from_numpy(payload[b0 * T : b1 * T]).to(device).reshape(b1 - b0, T, C).to(dtype)
    x = x - x.mean(dim=1, keepdim=True)
    w = torch.from_numpy(tp.bank(args, T, cfg["samplerate"])).to(device, dtype)
    return torch.fft.rfft(w[None, :, :, None] * x[:, None], dim=2)


def csd_sum(payload, cfg, args, device, control=False):
    """(F, C, C) trial x taper sum of the cross-spectra."""
    dtype = torch.float32 if control else torch.float64
    acc = None
    for b0 in range(0, cfg["trials"], BLOCK):
        b1 = min(b0 + BLOCK, cfg["trials"])
        spec = spectra(payload, cfg, args, device, dtype, b0, b1)
        rows = spec.reshape(-1, spec.shape[2], spec.shape[3]).permute(1, 0, 2)  # (F, bK, C)
        if control:
            part = tp.cmatmul_tf32(rows.transpose(1, 2), rows.conj())
        else:
            part = torch.matmul(rows.transpose(1, 2), rows.conj())
        acc = part if acc is None else acc + part
    return acc


def compute(payload, cfg, args, device, control=False):
    csd = csd_sum(payload, cfg, args, device, control)
    diag = torch.diagonal(csd, dim1=-2, dim2=-1).real
    coh = csd.abs() / torch.sqrt(diag[:, :, None] * diag[:, None, :])
    return coh.double().cpu().numpy()


def expected(payload, cfg, args, device):
    return compute(payload, cfg, args, device)


def check(got, want, cfg):
    return {"coh_max_abs_err": compare(got, want)}


def control(payload, cfg, args, device):
    return compute(payload, cfg, args, device, control=True)


def work(cfg, args, trials):
    """The CSD sum: F bins over trials x tapers rows of C channels."""
    k = tp.n_tapers(args["tapsmofrq"], cfg["samples"], cfg["samplerate"])
    return {"csd": {"F": cfg["samples"] // 2 + 1, "rows": trials * k, "C": cfg["channels"]}}


def compare(got, want):
    """Largest absolute difference (coherence and PPC lie in [-1, 1]); a NaN
    or an infinity on either side reads as infinite."""
    d = np.abs(np.asarray(got, np.float64).reshape(want.shape) - want)
    return float("inf") if not np.isfinite(d).all() else float(d.max())
