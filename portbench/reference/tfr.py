"""The trial-averaged Morlet power of one dataset (a time-frequency
representation), apart from the port: syncopy's ``freqanalysis(method=
"wavelet", wavelet="Morlet", output="pow", keeptrials=False)`` in float64
on the card, in blocks of trials so that it fits.

syncopy's transform (``syncopy/specest/wavelet.py``, which runs the
vendored ``wavelets/transform.py::cwt_time``), as done here:

- each trial demeaned, per channel (the frontend's default
  ``polyremoval=0``);
- per frequency of interest f the Morlet scale from its Fourier period,
  s = (w0 + sqrt(2 + w0^2)) / (4 pi f), w0 the ``width``;
- per scale the wavelet sampled at t = arange((-M + 1) / 2, (M + 1) / 2) dt,
  M = 10 s / dt (K = ceil(M) samples), times dt^0.5 / (8 pi s), the
  normalization under which a harmonic's |W| lies near its amplitude. It
  is syncopy's: ``tests/test_reference_parity.py::TestWaveletParity::
  test_cwt_morlet_match`` holds the JAX package's cwt, which uses it, to
  syncopy's own ``transform.cwt`` within 5e-6. The upstream wavelets
  library that syncopy vendored multiplies by sqrt(dt / s) instead, 8 pi
  sqrt(s) apart per scale (64 pi^2 s in power);
- a linear 'same'-mode convolution with each channel: the full
  convolution, computed by FFT in float64 at the least power of two at or
  above T + K - 1 (so nothing wraps around), cropped to the T samples that
  start at (K - 1) // 2, as ``scipy.signal.fftconvolve(mode="same")`` does;
- |W|^2, then the mean over trials.

Nothing here comes from the port: no bank, bucket or transform length of
its own.

Departures from syncopy: everything is float64, where syncopy computes in
the input's precision through scipy; the convolution runs as torch FFTs on
the card, where syncopy calls ``scipy.signal.fftconvolve`` on the host:
the same sums.

The control computes the same mathematics one precision below the
program's float32: the transformed signal (complex64) and the wavelet's
spectrum (float64) are rounded to float16, real and imaginary parts, before
their product; the product, its inverse transform, the power and the trial
sum are float32. The program rounds to float32 at each of those steps, so
a limit between the two readings passes float32 rounding and refuses a
transform that has lost half its precision, in the signal, the bank or
the product, anywhere in the bank.

``check`` reads ``tfr_max_rel_err``: over every (frequency, channel), the
largest |got - want| over the time axis divided by the largest ``want`` of
that (frequency, channel). Power spans orders of magnitude across the
frequencies (the bank's normalization) and falls off at the trial's edges
(the zero padding of 'same'), so an error is scaled by the power of its own
row and not by the largest power of the result.
"""

import math

import numpy as np
import torch

#: trials a block
BLOCK = 64


def scales(args):
    """The Morlet scales of the call's ``foi``, in its order."""
    w0 = float(args.get("width", 6))
    foi = np.asarray(args["foi"], dtype=np.float64)
    return (w0 + math.sqrt(2.0 + w0 * w0)) / (4.0 * math.pi * foi)


def wavelet(s, dt, w0):
    """The sampled, normalized Morlet of scale `s` at spacing `dt`
    (complex128 numpy, K samples)."""
    M = 10.0 * s / dt
    t = np.arange((-M + 1) / 2.0, (M + 1) / 2.0) * dt
    x = t / s
    psi = (np.exp(1j * w0 * x) - np.exp(-0.5 * w0 * w0)) * np.exp(-0.5 * x * x) * np.pi**-0.25
    return dt**0.5 / (8.0 * np.pi * s) * psi


def supports(cfg, args):
    """K, the number of samples of each scale's wavelet."""
    dt = 1.0 / cfg["samplerate"]
    w0 = float(args.get("width", 6))
    return [int(wavelet(s, dt, w0).size) for s in scales(args)]


def _pow2(n):
    return 1 << (int(n) - 1).bit_length()


def _half(z):
    """`z` with its real and imaginary parts rounded to float16, as
    complex64."""
    return torch.complex(z.real.to(torch.float16).float(), z.imag.to(torch.float16).float())


def power_blocks(payload, cfg, args, device, control=False):
    """Yield, per block of trials, their (b, T, S, C) power: float64, or
    float32 with the control's rounding."""
    T, C, n = cfg["samples"], cfg["channels"], cfg["trials"]
    dt = 1.0 / cfg["samplerate"]
    w0 = float(args.get("width", 6))
    real = torch.float32 if control else torch.float64
    bank = []  # (L, K, the wavelet's spectrum at L) per scale
    for s in scales(args):
        h = wavelet(s, dt, w0)
        L = _pow2(T + h.size - 1)
        H = torch.fft.fft(torch.from_numpy(h).to(device), n=L)
        bank.append((L, h.size, _half(H) if control else H))
    for b0 in range(0, n, BLOCK):
        b1 = min(b0 + BLOCK, n)
        x = torch.from_numpy(payload[b0 * T : b1 * T]).to(device).reshape(b1 - b0, T, C)
        x = x.to(real)
        x = (x - x.mean(dim=1, keepdim=True)).transpose(1, 2)  # (b, C, T)
        spectra = {}
        out = torch.empty((b1 - b0, T, len(bank), C), dtype=real, device=device)
        for i, (L, K, H) in enumerate(bank):
            if L not in spectra:
                X = torch.fft.fft(x, n=L, dim=-1)
                spectra[L] = _half(X) if control else X
            w = torch.fft.ifft(spectra[L] * H, dim=-1)[..., (K - 1) // 2 : (K - 1) // 2 + T]
            out[:, :, i, :] = (w.real * w.real + w.imag * w.imag).transpose(1, 2)
        yield out


def compute(payload, cfg, args, device, control=False):
    """(T, S, C) trial-averaged power, as float64 numpy."""
    acc = None
    for p in power_blocks(payload, cfg, args, device, control):
        part = p.sum(dim=0)
        acc = part if acc is None else acc + part
    return (acc / cfg["trials"]).double().cpu().numpy()


def expected(payload, cfg, args, device):
    return compute(payload, cfg, args, device)


def check(got, want, cfg):
    return {"tfr_max_rel_err": compare(got, want)}


def control(payload, cfg, args, device):
    return compute(payload, cfg, args, device, control=True)


def look(got, want, cfg):
    """Where the largest relative error lies: its frequency's index and
    the time index of its largest difference."""
    err = _row_errors(got, want)
    s, c = np.unravel_index(int(np.argmax(err)), err.shape)
    g = np.asarray(got, np.float64).reshape(want.shape)
    t = int(np.argmax(np.abs(g[:, s, c] - want[:, s, c])))
    return {"worst_freq_index": int(s), "worst_time_index": t,
            "median_row_rel_err": float(np.median(err))}


def work(cfg, args, trials):
    """The transform of `trials` trials: T samples, C channels and each
    scale's wavelet length K, which ``cwt_bound`` prices."""
    return {"cwt": {"trials": int(trials), "T": cfg["samples"], "C": cfg["channels"],
                    "K": supports(cfg, args)}}


def _row_errors(got, want):
    """(S, C): the largest |got - want| over time over the largest want
    of the row; a NaN or an infinity reads as infinite."""
    g = np.asarray(got, np.float64).reshape(want.shape)
    d = np.abs(g - want).max(axis=0)
    scale = np.abs(want).max(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        err = d / scale
    err[~np.isfinite(err)] = np.inf
    if not np.isfinite(g).all():
        err[:] = np.inf
    return err


def compare(got, want):
    """The largest relative error of any (frequency, channel) row."""
    return float(_row_errors(got, want).max())
