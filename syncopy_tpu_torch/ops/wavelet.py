# -*- coding: utf-8 -*-
#
# Continuous wavelet transform and superlet transform on torch tensors.
#
# Port of syncopy_tpu/ops/wavelet.py, the FFT route. The scale banks are
# sampled and Fourier-transformed on the host with numpy, as in the JAX
# package (the wavelet families, the optimal scales, the length buckets
# and the host banks are copied from it); the device path is one batched
# FFT of the trials, a broadcast multiply with the bank, one batched
# inverse FFT and a crop (cuFFT on the card). Frames keep their samples on
# the last axis so every transform runs over contiguous rows. Batched over
# any leading axes (trials).
#
# The superlet's geometric mean over orders is a weighted log
# accumulation. Where the JAX package runs lax.map over scales, the port
# loops over blocks of scales sized by a byte budget
# (_SCALE_BLOCK_BYTES), so one block of (orders, scales, L) transforms is
# live at a time.
#
# Not ported: the direct-GEMM banks and their *_gemm_consts hooks
# (syncopy_tpu/ops/wavelet.py:318-454; the FFT bank moves less than the
# GEMM computes on the H100), _gemm_fingerprint (the JAX compile cache),
# and the SPY_TPU_* knobs. cwt_time_sharded splits one recording's time
# axis over a mesh axis, with the wavelet halo copied between
# neighbouring positions.

import functools
import math

import numpy as np
import torch
from scipy.special import gamma as _gamma
from scipy.special import hermitenorm as _hermitenorm

from ..shared.profiling import span
from .windows import nextpow2

__all__ = [
    "Morlet",
    "Paul",
    "DOG",
    "Ricker",
    "MorletSL",
    "get_optimal_wavelet_scales",
    "cwt",
    "cwt_counts",
    "cwt_time_sharded",
    "reset_cwt_counts",
    "superlet",
    "superlet_weights",
    "WaveletAnalysis",
    "WaveletTransform",
]

#: device bytes of one block of superlet transforms, (..., orders,
#: scales, L) complex and its temporaries; blocks hold at least one scale
_SCALE_BLOCK_BYTES = 1 << 30

#: cwt() since the last reset_cwt_counts(): its calls, the inverse
#: transforms it ran (leading rows x channels x scales) by the length of
#: their bucket, and the scale banks it copied to the device, with their
#: bytes
_CWT = {"calls": 0, "transforms": {}, "bank_uploads": 0, "bank_bytes": 0}


def cwt_counts():
    """The calls of :func:`cwt`, its inverse transforms by bucket length
    (``{L: count}``) and its bank uploads and their bytes, since the last
    :func:`reset_cwt_counts`."""
    return dict(_CWT, transforms=dict(_CWT["transforms"]))


def reset_cwt_counts():
    _CWT.update(calls=0, transforms={}, bank_uploads=0, bank_bytes=0)


class Morlet:
    """Complex Morlet wavelet (reference wavelets/wavelets.py:13-138)."""

    def __init__(self, w0=6):
        self.w0 = w0
        if w0 == 6:
            self.C_d = 0.776  # Torrence & Compo 1998 Table 2

    def time(self, t, s=1.0, complete=True):
        w = self.w0
        x = t / s
        output = np.exp(1j * w * x)
        if complete:
            output = output - np.exp(-0.5 * w**2)
        return output * np.exp(-0.5 * x**2) * np.pi ** (-0.25)

    def fourier_period(self, s):
        return 4 * np.pi * s / (self.w0 + (2 + self.w0**2) ** 0.5)

    def scale_from_period(self, period):
        coeff = np.sqrt(self.w0 * self.w0 + 2)
        return period * (coeff + self.w0) / (4.0 * np.pi)

    def frequency(self, w, s=1.0):
        """Fourier transform of the Morlet wavelet at angular frequency
        ``w`` (Torrence & Compo Table 1; reference wavelets.py:104-126).
        Analytic: zero for non-positive frequencies."""
        x = np.asarray(w, dtype=float) * s
        support = (np.asarray(w) > 0).astype(float)
        return np.pi ** (-0.25) * support * np.exp(-0.5 * (x - self.w0) ** 2)

    def coi(self, s):
        """e-folding time of the wavelet-power autocorrelation
        (reference wavelets.py:128-138)."""
        return 2**0.5 * s


class Paul:
    """Complex Paul wavelet (reference wavelets/wavelets.py:140-237)."""

    def __init__(self, m=4):
        self.m = m

    def time(self, t, s=1.0):
        m = self.m
        x = t / s
        const = (2**m * 1j**m * math.factorial(m)) / (np.pi * math.factorial(2 * m)) ** 0.5
        return const * (1 - 1j * x) ** -(m + 1)

    def fourier_period(self, s):
        return 4 * np.pi * s / (2 * self.m + 1)

    def scale_from_period(self, period):
        return period * (2 * self.m + 1) / (4 * np.pi)

    def frequency(self, w, s=1.0):
        """Fourier transform of the Paul wavelet (Torrence & Compo
        Table 1; reference wavelets.py:204-226): analytic, one-sided."""
        m = self.m
        x = np.asarray(w, dtype=float) * s
        support = 0.5 * (np.sign(x) + 1)
        const = 2**m / (m * math.factorial(2 * m - 1)) ** 0.5
        return const * support * x**m * np.exp(-x)

    def coi(self, s):
        return s / 2**0.5


class DOG:
    """Derivative-of-Gaussian wavelet (reference wavelets/wavelets.py:239-361)."""

    def __init__(self, m=2):
        self.m = m
        if m == 2:
            self.C_d = 3.541  # Torrence & Compo 1998 Table 2
        elif m == 6:
            self.C_d = 1.966

    def time(self, t, s=1.0):
        x = t / s
        m = self.m
        He_n = _hermitenorm(m)
        const = (-1) ** (m + 1) / _gamma(m + 0.5) ** 0.5
        return const * He_n(x) * np.exp(-(x**2) / 2)

    def fourier_period(self, s):
        return 2 * np.pi * s / (self.m + 0.5) ** 0.5

    def scale_from_period(self, period):
        return period * np.sqrt(self.m + 0.5) / (2 * np.pi)

    def frequency(self, w, s=1.0):
        """Fourier transform of the m-th derivative-of-Gaussian wavelet
        (Torrence & Compo Table 1; reference wavelets.py:326-350)."""
        m = self.m
        x = np.asarray(w, dtype=float) * s
        const = -(1j**m) / _gamma(m + 0.5) ** 0.5
        return const * x**m * np.exp(-0.5 * x**2)

    def coi(self, s):
        return 2**0.5 * s


class Ricker(DOG):
    """Mexican-hat wavelet = DOG of order 2 (reference wavelets.py:363-376)."""

    def __init__(self):
        super().__init__(m=2)


class MorletSL:
    """Morlet in the superlet formulation of Moca et al. 2021
    (reference superlet.py:255-300): admissibility via cycle count `c_i`
    inside a Gaussian of `k_sd` standard deviations."""

    def __init__(self, c_i=3, k_sd=5):
        self.c_i = c_i
        self.k_sd = k_sd

    def time(self, t, s=1.0):
        ts = t / s
        B_c = self.k_sd / (s * self.c_i * (2 * np.pi) ** 1.5)
        out = B_c * np.exp(1j * ts)
        return out * np.exp(-0.5 * (self.k_sd * ts / (2 * np.pi * self.c_i)) ** 2)

    @staticmethod
    def fourier_period(scale):
        return 2 * np.pi * scale

    @staticmethod
    def scale_from_period(period):
        return period / (2 * np.pi)


def get_optimal_wavelet_scales(scale_from_period, nSamples, dt, dj=0.25, s0=None):
    """Torrence & Compo 1998 dyadic scale set, low frequencies first
    (reference wavelet.py:52-107)."""
    if s0 is None:
        s0 = scale_from_period(2 * dt)
    J = int((1 / dj) * np.log2(nSamples * dt / s0))
    scales = s0 * 2 ** (dj * np.arange(0, J + 1))
    return scales[::-1]


def _scale_buckets(Ls, max_buckets=4):
    """Group scale indices by padded transform length: ``[(L, [i, ...])]``
    sorted by L, each index list in original scale order. The lowest
    frequencies dictate a support (and hence FFT length) the high
    frequencies don't need — running one bank per length bucket cuts the
    convolution traffic by the length ratio.

    At most `max_buckets` distinct lengths: smaller buckets are greedily
    merged into the next longer one, choosing the merge that adds the
    least wasted work ``count * (L_next - L)`` (a longer padding is always
    correct — linear convolution is invariant to extra zeros)."""
    buckets = {}
    for i, L in enumerate(Ls):
        buckets.setdefault(int(L), []).append(i)
    items = sorted(buckets.items())
    while len(items) > max_buckets:
        costs = [
            (items[k + 1][0] - items[k][0]) * len(items[k][1])
            for k in range(len(items) - 1)
        ]
        k = int(np.argmin(costs))
        merged = sorted(items[k][1] + items[k + 1][1])
        items[k + 1] = (items[k + 1][0], merged)
        del items[k]
    return items


@functools.lru_cache(maxsize=64)
def _wavelet_kernel_fft(wavelet_key, scales_key, dt, L):
    """
    Host-side kernel bank: sample every scale's wavelet on its reference
    support, normalize like cwt_time (reference transform.py:88-108),
    embed into the FFT length `L` (at least the signal plus the largest
    support) with the 'same'-convolution center rolled to index 0, and
    FFT it. Returns kernel_fft[(S, L)] complex64 np.
    """
    scales = np.asarray(scales_key)
    wav = _wavelet_from_key(wavelet_key)
    bank = np.zeros((len(scales), L), dtype=np.complex64)
    for i, s in enumerate(scales):
        bank[i] = _embedded_kernel(wav, s, 10 * s / dt, dt, None, L)
    return np.fft.fft(bank, axis=1).astype(np.complex64)


def _sampled_kernel(wav, s, M, dt, norm):
    """Sample one scale's wavelet on its 'same'-convolution support
    (cwt_time normalization when norm is None, reference
    transform.py:88-108; cwtSL's fixed norm otherwise)."""
    t = np.arange((-M + 1) / 2.0, (M + 1) / 2.0) * dt
    if norm is not None:
        kern = norm * wav.time(t, s)
    else:
        kern = (dt**0.5 / (s * 8 * np.pi)) * wav.time(t, s)
    return kern.astype(np.complex64)


def _embedded_kernel(wav, s, M, dt, norm, L):
    """Sample one scale's wavelet on its 'same'-convolution support and
    embed it into an L-point buffer with the center rolled to index 0."""
    kern = _sampled_kernel(wav, s, M, dt, norm)
    K = kern.size
    buf = np.zeros(L, dtype=np.complex64)
    buf[:K] = kern
    return np.roll(buf, -((K - 1) // 2))


@functools.lru_cache(maxsize=32)
def _superlet_bank_fft(scales_key, dt, cycles_key, L):
    """
    Combined multi-order MorletSL bank at ONE common FFT length `L` (at
    least the signal plus the longest order's support; linear convolution
    is invariant to extra padding, so every order's transform is
    unchanged), cwtSL's normalization (reference superlet.py:321-365).
    Returns bank_fft[(nOrders, nScales, L)] complex64 np.
    """
    scales = np.asarray(scales_key)
    norm = dt**0.5 / (4 * np.pi)
    bank = np.zeros((len(cycles_key), len(scales), L), dtype=np.complex64)
    for o, cycles in enumerate(cycles_key):
        wav = MorletSL(cycles)
        supports = 10 * scales * wav.c_i / dt
        for i, (s, M) in enumerate(zip(scales, supports)):
            bank[o, i] = _embedded_kernel(wav, s, M, dt, norm, L)
    return np.fft.fft(bank, axis=2).astype(np.complex64)


def _wavelet_key(wavelet):
    """(family name, parameter): the hashable key of a wavelet instance."""
    name = type(wavelet).__name__
    return name, getattr(wavelet, "w0", None) if name == "Morlet" else getattr(wavelet, "m", None)


def _wavelet_from_key(key):
    name, param = key
    return {"Morlet": Morlet, "Paul": Paul, "DOG": DOG, "Ricker": lambda m: Ricker()}[name](param)


def _signal_fft(data, L):
    """The length-L FFT of a (..., nSamples, nChannels) real batch,
    samples last: (..., nChannels, L) complex64."""
    return torch.fft.fft(data.to(torch.float32).transpose(-1, -2), n=L, dim=-1)


def cwt(data, wavelet, scales, dt, power_only=False):
    """
    Batched continuous wavelet transform, inside the span
    ``spt.specest.cwt`` and counted by :func:`cwt_counts`.

    Parameters
    ----------
    data : (..., nSamples, nChannels) real tensor
    wavelet : Morlet/Paul/DOG/Ricker instance
    scales : 1D numpy array of scales
    dt : float sample spacing
    power_only : return float32 ``|W|^2`` instead of the complex
        transform: each length bucket's transform becomes power on the
        device before the next one runs

    Returns
    -------
    spec : (..., nScales, nSamples, nChannels) complex64, or float32 power
    """
    nSamples = data.shape[-2]
    scales_t = tuple(np.asarray(scales).tolist())
    key = _wavelet_key(wavelet)
    # per-scale padded length (signal plus the scale's support): one bank
    # per length bucket keeps the long transforms for the low frequencies
    # only
    Ls = [nextpow2(nSamples + int(np.ceil(10 * s / dt)) + 1) for s in scales_t]
    lead, C = data.shape[:-2], data.shape[-1]
    rows = int(np.prod(lead)) * C
    _CWT["calls"] += 1
    out = None
    with span("spt.specest.cwt"):
        for L_b, idx in _scale_buckets(Ls):
            kfft = _wavelet_kernel_fft(key, tuple(scales_t[i] for i in idx), float(dt), L_b)
            bank = torch.from_numpy(kfft).to(data.device)  # (S_b, L)
            _CWT["bank_uploads"] += 1
            _CWT["bank_bytes"] += kfft.nbytes
            _CWT["transforms"][L_b] = _CWT["transforms"].get(L_b, 0) + rows * len(idx)
            y = torch.fft.ifft(_signal_fft(data, L_b)[..., None, :] * bank,
                               dim=-1)[..., :nSamples]
            if power_only:
                y = y.real * y.real + y.imag * y.imag
            if out is None:
                out = torch.empty(lead + (C, len(scales_t), nSamples), dtype=y.dtype,
                                  device=data.device)
            out[..., torch.as_tensor(idx, device=data.device), :] = y  # (..., C, S, T)
        return out.movedim(-3, -1)


def cwt_time_sharded(data, wavelet, scales, dt, mesh, axis_name="trial"):
    """
    Continuous wavelet transform of one recording whose TIME axis is split
    over the positions of `mesh` along `axis_name`
    (syncopy_tpu/ops/wavelet.py::cwt_time_sharded, the context-parallel
    analog for recordings whose FFT bank would not fit one device): each
    position receives a halo of ``ceil(5 max(scales) / dt) + 1`` samples,
    the wavelets' half support, from each neighbour (zeros at the
    recording's edges), runs :func:`cwt` on its extended block and crops
    it; its transform stays on its device. Equal to :func:`cwt` on the
    whole recording up to FFT rounding. On a mesh that spans processes
    every rank calls this with the same arguments and transforms only its
    own positions' blocks.

    Parameters
    ----------
    data : (nSamples, nChannels) array or tensor, nSamples divisible by
        the axis size
    wavelet, scales, dt : as in :func:`cwt`
    mesh : :class:`~syncopy_tpu_torch.parallel.mesh.Mesh`

    Returns
    -------
    spec : :class:`~syncopy_tpu_torch.parallel.mesh.ShardedTensor` of
        (nScales, nSamples / n, nChannels) complex64 blocks along dim 1
        (None for another rank's)
    """
    from ..parallel.mesh import (ShardedTensor, axis_devices, axis_ranks, check_mesh,
                                 device_context, halo_exchange, split_along)

    devices, ranks = axis_devices(check_mesh(mesh), axis_name), axis_ranks(mesh, axis_name)
    T, C = data.shape
    if T % len(devices):
        raise ValueError("nSamples must be divisible by the mesh axis size")
    T_local = T // len(devices)
    halo = int(np.ceil(5.0 * float(np.max(np.asarray(scales))) / dt)) + 1
    if halo > T_local:
        raise ValueError(
            "wavelet halo ({} samples) exceeds the local shard ({}); use "
            "fewer devices or smaller scales".format(halo, T_local))
    blocks = split_along(torch.as_tensor(data).to(torch.float32), devices, ranks=ranks)
    out = []
    for ext, d in zip(halo_exchange(blocks, halo, halo, ranks), devices):
        if ext is None:
            out.append(None)
            continue
        with device_context(d):
            out.append(cwt(ext, wavelet, scales, dt)[:, halo : halo + T_local])
    return ShardedTensor(out, dim=1, shape=(len(np.atleast_1d(scales)), T, C), ranks=ranks)


def superlet_weights(scales, order_max, order_min=1, adaptive=False):
    """
    Geometric-mean exponent matrix w[(order, scale)] for the superlet
    transform: SLT = prod_o |spec_o|^(w[o, s]) (complex powers).

    Multiplicative SLT (reference superlet.py:108-125): uniform
    ``1/order_num``. Fractional adaptive SLT (reference superlet.py:128-196):
    scale-dependent orders with fractional last contribution.
    """
    scales = np.asarray(scales)
    if not adaptive:
        order_num = order_max + 1 - order_min
        cycles_list = list(range(order_min, order_max + 1))
        w = np.full((len(cycles_list), scales.size), 1.0 / order_num)
        return w, cycles_list

    fois = 1 / (2 * np.pi * scales)
    f_min, f_max = fois[0], fois[-1]
    orders = order_min + (order_max - order_min) * (fois - f_min) / (f_max - f_min)
    orders_int = np.int32(np.floor(orders))
    exponents = 1 / (orders - order_min + 1)
    alphas = orders % orders_int

    # only the unique integer floors are materialized as wavelets; the
    # fractional contribution of a scale comes from the NEXT unique order
    # present (reference superlet.py:146-196 walks `order_jumps`)
    uniq = [int(o) for o in np.unique(orders_int)]
    w = np.zeros((len(uniq), scales.size))
    for k, o in enumerate(uniq):
        w[k] = np.where(o <= orders_int, exponents, 0.0)
        if k > 0:
            prev_band = orders_int == uniq[k - 1]
            w[k] += np.where(prev_band, alphas * exponents, 0.0)
    return w, uniq


def superlet(data, scales, order_max, order_min=1, c_1=3, adaptive=False, dt=1.0,
             magnitude_only=False):
    """
    Batched superlet transform (reference superlet.py:15-108).

    `data` is (..., nSamples, nChannels) real. Returns (..., nScales,
    nSamples, nChannels) complex64, the geometric mean of MorletSL wavelet
    transforms across orders, or with ``magnitude_only=True`` the float32
    MAGNITUDE of that geometric mean: ``exp(sum_o w log|spec_o|)``, real
    log and exp in float32 (the ``output='pow'/'abs'`` route).
    """
    w, cycle_orders = superlet_weights(scales, order_max, order_min, adaptive)
    nSamples = data.shape[-2]
    lead, C = data.shape[:-2], data.shape[-1]
    scales_t = tuple(np.asarray(scales).tolist())
    # keep c_1 as a float: fractional base cycle counts are valid MorletSL
    # bandwidths (the frontend coerces to int, the ops API need not)
    cycles_t = tuple(float(c_1) * int(o) for o in cycle_orders)
    W = torch.tensor(w.T, dtype=torch.float32, device=data.device)  # (S, O)
    n_orders = W.shape[1]
    n_lead = int(np.prod(lead))

    out = torch.empty(lead + (C, len(scales_t), nSamples),
                      dtype=torch.float32 if magnitude_only else torch.complex64,
                      device=data.device)
    # per-scale padded length (signal plus the longest order's support):
    # low frequencies need supports the high frequencies don't
    max_c = max(cycles_t)
    Ls = [nextpow2(nSamples + int(np.ceil(10 * s * max_c / dt)) + 1) for s in scales_t]
    for L_b, idx in _scale_buckets(Ls):
        kfft = _superlet_bank_fft(tuple(scales_t[i] for i in idx), float(dt), cycles_t, L_b)
        bank = torch.from_numpy(kfft).to(data.device)  # (O, S_b, L)
        X = _signal_fft(data, L_b)[..., None, None, :]  # (..., C, 1, 1, L)
        # scales a block: the (..., C, O, block, L) product, its inverse
        # transform and their real temporaries within _SCALE_BLOCK_BYTES
        per_scale = max(n_lead * C * n_orders * L_b * 8 * 3, 1)
        block = max(1, _SCALE_BLOCK_BYTES // per_scale)
        for b0 in range(0, len(idx), block):
            sel = idx[b0 : b0 + block]
            spec = torch.fft.ifft(X * bank[:, b0 : b0 + len(sel)], dim=-1)[..., :nSamples]
            wl = W[sel].T[:, :, None]  # (O, block, 1)
            if magnitude_only:
                # floor keeps log finite; exp of the w-weighted sum of
                # log(1e-30) underflows to the 0 the complex route gives
                logm = torch.where(wl > 0, torch.log(spec.abs().clamp_min(1e-30)), 0.0)
                res = torch.exp((wl * logm).sum(dim=-3))
            else:
                # complex log-power accumulation over orders; w=0 adds 0
                logspec = torch.where(wl > 0, torch.log(spec), 0.0)
                res = torch.exp((wl * logspec).sum(dim=-3))
            out[..., torch.as_tensor(sel, device=data.device), :] = res
    return out.movedim(-3, -1)


class WaveletAnalysis:
    """
    Object-oriented CWT convenience wrapper (parity with the reference's
    vendored lib, transform.py:208-600): transform, power, reconstruction,
    cone of influence and global spectrum of a 1-d (or multi-channel)
    signal. The transform runs on the port's device
    (:func:`~syncopy_tpu_torch.set_device`); everything else is numpy.
    """

    def __init__(self, data, time=None, dt=1.0, dj=0.125, wavelet=None,
                 unbias=False, mask_coi=False, frequency=False, axis=0):
        self.data = np.atleast_2d(np.asarray(data, dtype=np.float32).T).T
        if self.data.shape[0] == 1 and axis == 0:
            self.data = self.data.T
        self.anomaly = self.data - self.data.mean(axis=0, keepdims=True)
        self.n_samples = self.data.shape[0]
        self.dt = float(dt)
        self.dj = float(dj)
        self.wavelet = wavelet or Morlet(6)
        self.unbias = unbias
        self.mask_coi = mask_coi
        self.time = time if time is not None else np.arange(self.n_samples) * self.dt
        self._transform = None

    @property
    def scales(self):
        if not hasattr(self, "_scales"):
            self._scales = get_optimal_wavelet_scales(
                self.wavelet.scale_from_period, self.n_samples, self.dt, self.dj
            )[::-1]
        return self._scales

    @scales.setter
    def scales(self, value):
        self._scales = np.asarray(value)
        self._transform = None

    @property
    def fourier_periods(self):
        return self.wavelet.fourier_period(self.scales)

    @property
    def fourier_frequencies(self):
        return 1.0 / self.fourier_periods

    @property
    def wavelet_transform(self):
        """(nScales, nSamples, nChannels) complex CWT."""
        if self._transform is None:
            from ..engine.routine import default_device

            x = torch.from_numpy(np.ascontiguousarray(self.anomaly)).to(default_device())
            self._transform = cwt(x, self.wavelet, self.scales, self.dt).cpu().numpy()
        return self._transform

    @property
    def wavelet_power(self):
        power = np.abs(self.wavelet_transform) ** 2
        if self.unbias:
            power = power / self.scales[:, None, None]
        if self.mask_coi:
            power = np.where(self.inside_coi[:, :, None], power, np.nan)
        return power

    @property
    def coi(self):
        """Cone-of-influence e-folding time per time point."""
        t = self.time
        left = t - t[0]
        right = t[-1] - t
        return np.minimum(left, right)

    @property
    def inside_coi(self):
        """(nScales, nSamples) mask: True where edge effects are negligible
        (e-folding times per wavelet family, reference wavelets.py coi)."""
        if isinstance(self.wavelet, Paul):
            efold = self.scales / np.sqrt(2)
        else:  # Morlet / DOG / Ricker
            efold = np.sqrt(2) * self.scales
        return efold[:, None] < self.coi[None, :]

    @property
    def global_wavelet_spectrum(self):
        mean_power = np.nanmean(self.wavelet_power, axis=(1, 2))
        var = self.anomaly.var()
        return mean_power / var if var > 0 else mean_power

    @property
    def N(self):
        return self.n_samples

    @property
    def w_k(self):
        """Angular frequencies of the Fourier indices (T&C eq. 5)."""
        return 2 * np.pi * np.fft.fftfreq(self.n_samples, self.dt)

    @property
    def fourier_period(self):
        return self.wavelet.fourier_period

    @property
    def scale_from_period(self):
        return self.wavelet.scale_from_period

    def find_s0(self):
        """Smallest resolvable scale: fourier_period(s0) = 2 dt
        (reference transform.py:309-319)."""
        from scipy.optimize import fsolve

        return float(fsolve(lambda s: self.wavelet.fourier_period(s) - 2 * self.dt, 1.0)[0])

    @property
    def s0(self):
        if not hasattr(self, "_s0"):
            self._s0 = self.find_s0()
        return self._s0

    @s0.setter
    def s0(self, value):
        self._s0 = float(value)

    def compute_optimal_scales(self):
        """Fractional powers of two s_j = s0 * 2^(j dj) up to N dt
        (T&C eq. 9-10; reference transform.py:332-366)."""
        J = int(np.floor((1.0 / self.dj) * np.log2(self.n_samples * self.dt / self.s0)))
        return self.s0 * 2.0 ** (self.dj * np.arange(J + 1))

    @property
    def wavelet_transform_delta(self):
        """Transform of a delta function, summed over Fourier indices —
        used to derive C_delta empirically (T&C section 3.i)."""
        WK, S = np.meshgrid(self.w_k, self.scales)
        norm = (2 * np.pi * S / self.dt) ** 0.5
        return (1.0 / self.n_samples) * np.sum(norm * self.wavelet.frequency(WK, S), axis=1)

    def compute_Cdelta(self):
        """Empirical C_delta from the delta-function transform."""
        Y_00 = self.wavelet.time(0.0)
        real_sum = np.sum(self.wavelet_transform_delta.real / self.scales**0.5)
        return float(np.real(real_sum * (self.dj * self.dt**0.5 / Y_00)))

    @property
    def C_d(self):
        """Reconstruction constant: tabulated on the wavelet when known
        (T&C Table 2), else derived via :meth:`compute_Cdelta`."""
        return getattr(self.wavelet, "C_d", None) or self.compute_Cdelta()

    @property
    def wavelet_variance(self):
        """Parseval analog: total variance from the scale-normalized power
        (T&C eq. 14)."""
        A = self.dj * self.dt / (self.C_d * self.n_samples)
        return A * np.sum(np.abs(self.wavelet_transform) ** 2 / self.scales[:, None, None])

    def coi_mean(self, axis=1):
        """Time-mean of the wavelet power restricted to the cone of
        influence (reference transform.py:460-474)."""
        power = np.where(self.inside_coi[:, :, None], self.wavelet_power, np.nan)
        return np.nanmean(power, axis=axis)

    def reconstruction(self):
        """Inverse transform (Torrence & Compo Eq. 11, C_delta for Morlet)."""
        C_d = 0.776
        Y_00 = np.pi ** (-0.25)
        W = self.wavelet_transform
        real_sum = np.sum(W.real / np.sqrt(self.scales)[:, None, None], axis=0)
        x_n = real_sum * (self.dj * np.sqrt(self.dt) / (C_d * Y_00))
        # rescale to account for the time-domain sampling of the kernels
        num = x_n.std(axis=0)
        den = self.anomaly.std(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.where(num > 0, den / num, 1.0)
        return x_n * ratio + self.data.mean(axis=0, keepdims=True)


# Reference exports both names for the same class (wavelets/transform.py:11,614).
WaveletTransform = WaveletAnalysis
