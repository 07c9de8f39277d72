# -*- coding: utf-8 -*-
#
# Single-trial connectivity compute routines.
#
# Port of syncopy_tpu/connectivity/ST_compRoutines.py: _CrossRoutine,
# CrossSpectra, PPCSpectra, SpectralDyadicProduct and CrossCovariance.

import numpy as np
import torch

from ..engine.routine import ComputationalRoutine, take_labels
from ..ops.connectivity import (
    _ccov_lag_geometry,
    ccov_batch_sum,
    cross_covariance_batch,
    csd_sum_compensated,
    spectral_dyadic_product,
)
from ..ops.csd_kernels import csd_accumulate_tiled
from ..ops.ppc_kernels import ppc_accumulate_tiled
from ..ops.spectral import taper_segments
from ..ops.windows import make_tapers

__all__ = ["CrossSpectra", "PPCSpectra", "SpectralDyadicProduct", "CrossCovariance"]


class _CrossRoutine(ComputationalRoutine):
    """Shared metadata propagation for CrossSpectralData outputs."""

    dimord = ["time", "freq", "channel_i", "channel_j"]

    def process_metadata(self, data, out):
        out.trialdefinition = self.default_trialdefinition(data, out)
        out.samplerate = data.samplerate
        sel = self.selector
        chan = take_labels(data.channel, getattr(sel, "channel", None))
        out.channel_i = chan
        out.channel_j = chan
        if self.cfg.get("foi") is not None:
            out.freq = self.cfg["foi"]


class CrossSpectra(_CrossRoutine):
    """
    Single-trial (multi-)tapered cross spectra of AnalogData
    (reference ST_compRoutines.py:270-463): implicit mtmfft + channel
    outer product, tapers averaged. Output per trial ``(1, nFreq, N, N)``.

    ``exact_fft=True`` gives the factorization-grade CSD that Granger
    needs: detrend, taper, rfft and the trial x taper Gram in float64 (a
    complex128 matmul), rounded to complex64 at the end. The JAX package's
    double-float32 DFT behind the same switch handles trials of up to 1024
    samples; this route has no such limit.
    """

    valid_kws = ["taper", "taper_opt", "tapsmofrq", "nTaper", "pad", "foi", "foilim",
                 "polyremoval", "demean_taper", "output"]

    def __init__(self, samplerate=1.0, nSamples=None, taper="hann", taper_opt=None,
                 demean_taper=False, polyremoval=0, freq_idx=None, foi=None,
                 exact_fft=False):
        super().__init__(
            samplerate=samplerate, nSamples=nSamples, taper=taper, taper_opt=taper_opt,
            demean_taper=demean_taper, polyremoval=polyremoval,
            freq_idx=None if freq_idx is None else np.asarray(freq_idx, dtype=int),
            foi=foi, exact_fft=bool(exact_fft),
        )

    def output_trial_shape(self, trial_shape):
        T, C = trial_shape
        nfft = self.cfg["nSamples"] or T
        freq_idx = self.cfg["freq_idx"]
        n_freq = nfft // 2 + 1 if freq_idx is None else len(freq_idx)
        return (1, n_freq, C, C), np.dtype(np.complex64)

    @staticmethod
    def _tapered_batch(batch, cfg, dtype=torch.float32):
        """(B, K, T, C) detrended+tapered trial batch in `dtype` and the
        taper count."""
        nfft = cfg["nSamples"] or batch.shape[1]
        tapers = torch.from_numpy(
            make_tapers(cfg["taper"], cfg["taper_opt"], batch.shape[1], nfft, cfg["samplerate"]))
        tapered = taper_segments(batch, tapers, cfg["polyremoval"], cfg["demean_taper"], dtype)
        return tapered, tapers.shape[0], nfft

    @staticmethod
    def _batch_spectra(tapered, nfft, cfg):
        """(B, K, F, C) one-sided spectra of a tapered batch."""
        spec = torch.fft.rfft(tapered, n=nfft, dim=2)
        if cfg["freq_idx"] is not None:
            idx = torch.as_tensor(cfg["freq_idx"], device=spec.device)
            spec = spec.index_select(2, idx)
        return spec

    @classmethod
    def _exact_csd_sum(cls, batch, n_valid, cfg):
        """(F, C, C) complex128 trial x taper CSD sum over the first
        `n_valid` trials of `batch`, all in float64."""
        tapered, K, nfft = cls._tapered_batch(batch, cfg, torch.float64)
        # where-mask (not multiply): padding rows may hold NaN
        valid = torch.arange(tapered.shape[0], device=tapered.device) < n_valid
        tapered = torch.where(valid[:, None, None, None], tapered, 0.0)
        spec = cls._batch_spectra(tapered, nfft, cfg)  # (B, K, F, C)
        B, _, F, C = spec.shape
        rows = spec.permute(2, 0, 1, 3).reshape(F, B * K, C)
        return torch.matmul(rows.transpose(1, 2), rows.conj()) / K

    def process_single_trial(self, trial, **cfg):
        return self.process_batch(trial[None], **cfg)[0]

    def process_batch(self, batch, **cfg):
        """Single-trial cross spectra of a batch, ``(B, 1, F, C, C)``
        complex64: one batched rfft and one batched ``bkfi,bkfj->bfij``
        product a chunk (the (K, C) Gram of :meth:`_exact_csd_sum` per
        trial and frequency), in float64 with `exact_fft`, where the base
        class would call :meth:`process_single_trial` once a trial."""
        dtype = torch.float64 if cfg.get("exact_fft") else torch.float32
        tapered, K, nfft = self._tapered_batch(batch, cfg, dtype)
        rows = self._batch_spectra(tapered, nfft, cfg).transpose(1, 2)  # (B, F, K, C)
        CS = torch.matmul(rows.transpose(2, 3), rows.conj()) / K
        return CS[:, None].to(torch.complex64)

    def process_batch_sum(self, batch, n_valid, **cfg):
        """
        Trial-summed cross spectra over the first `n_valid` trials of a
        padded batch: the whole trial x taper stack collapses in one
        tiled CSD accumulation (CUDA kernel on the card) instead of
        materializing per-trial (nFreq, N, N) matrices. With `exact_fft`
        the sum is the float64 Gram of :meth:`_exact_csd_sum` instead.
        """
        if cfg.get("exact_fft"):
            return self._exact_csd_sum(batch, n_valid, cfg)[None].to(torch.complex64)
        tapered, K, nfft = self._tapered_batch(batch, cfg)
        spec = self._batch_spectra(tapered, nfft, cfg)
        B, _, F, C = spec.shape
        slab = spec.reshape(B * K, F, C).contiguous()
        cs_sum = csd_accumulate_tiled(slab, n_valid * K) / K
        return cs_sum[None]


class PPCSpectra(CrossSpectra):
    """
    Fused single-pass pairwise phase consistency from AnalogData: the
    single-trial cross spectra and the unit-phasor resultant reduction
    (Vinck 2010 Eq. 14; reference connectivity_analysis.py:624-667) in one
    engine pass, so the per-trial CSD stack never exists.
    ``process_batch_sum`` returns the resultant SUM of unit CSDs; the
    frontend's post computes ``(|U|^2 - n) / (n (n - 1))``.

    The JAX routine's ``device_bytes_per_trial`` has no counterpart: the
    port's engine sizes chunks from the input bytes alone
    (engine/routine.py::_chunk_size), and the CUDA kernel keeps the
    per-trial CSDs in registers.
    """

    def process_batch(self, batch, **cfg):
        cs = super().process_batch(batch, **cfg)
        # exact-zero bins are 0/0, as in the JAX package: they cannot occur
        # in tapered spectra of real data off the padding, which the batch
        # path masks by n_valid
        return cs / cs.abs()

    def process_batch_sum(self, batch, n_valid, **cfg):
        tapered, _, nfft = self._tapered_batch(batch, cfg)
        # rfft along a middle axis leaves a (B, K, C, F)-strided result;
        # the kernel reads (B, K, F, C) in place
        spec = self._batch_spectra(tapered, nfft, cfg).contiguous()
        return ppc_accumulate_tiled(spec, n_valid)[None]


class SpectralDyadicProduct(_CrossRoutine):
    """
    Single-trial cross spectra from complex SpectralData: channel outer
    product, tapers averaged (reference ST_compRoutines.py:29-152).
    Optional (senders x receivers) restriction via `send_idx`/`rec_idx`.
    """

    valid_kws = ["send_idx", "rec_idx", "output"]

    def __init__(self, send_idx=None, rec_idx=None):
        super().__init__(
            send_idx=None if send_idx is None else np.asarray(send_idx, dtype=int),
            rec_idx=None if rec_idx is None else np.asarray(rec_idx, dtype=int),
            foi=None,
        )

    def output_trial_shape(self, trial_shape):
        T, _, F, C = trial_shape
        n_send = C if self.cfg["send_idx"] is None else len(self.cfg["send_idx"])
        n_rec = C if self.cfg["rec_idx"] is None else len(self.cfg["rec_idx"])
        return (T, F, n_send, n_rec), np.dtype(np.complex64)

    def process_single_trial(self, trial, **cfg):
        return spectral_dyadic_product(trial, cfg["send_idx"], cfg["rec_idx"])

    def process_batch_sum(self, batch, n_valid, **cfg):
        """Masked trial sum with compensated accumulation, as in the JAX
        package: the averaged CSD feeds Wilson downstream (Granger on
        SpectralData input), where plain serial float32 accumulation noise
        destroys factorizability (see ops/connectivity.csd_sum_compensated).
        `batch` is (B, nTime, K, F, C) complex."""
        B, T, K, F, C = batch.shape
        valid = torch.arange(B, device=batch.device) < n_valid
        x = torch.where(valid[:, None, None, None, None], batch,
                        torch.zeros((), dtype=batch.dtype, device=batch.device))
        if cfg["send_idx"] is not None:
            a = x.index_select(4, torch.as_tensor(cfg["send_idx"], device=batch.device))
            b = x.index_select(4, torch.as_tensor(cfg["rec_idx"], device=batch.device))
            cs = torch.einsum("btkfi,btkfj->tfij", a, b.conj()) / K
            return cs.to(torch.complex64)
        per_time = torch.stack([csd_sum_compensated(x[:, t]) for t in range(T)], dim=0)
        return (per_time / K).to(torch.complex64)

    def process_metadata(self, data, out):
        out.trialdefinition = self.default_trialdefinition(data, out)
        out.samplerate = data.samplerate
        sel = self.selector
        chan = take_labels(data.channel, getattr(sel, "channel", None))
        if self.cfg["send_idx"] is not None:
            out.channel_i = np.asarray(data.channel)[self.cfg["send_idx"]]
            out.channel_j = np.asarray(data.channel)[self.cfg["rec_idx"]]
        else:
            out.channel_i = chan
            out.channel_j = chan
        out.freq = take_labels(np.asarray(data.freq), getattr(sel, "freq", None))


class CrossCovariance(_CrossRoutine):
    """
    Single-trial cross-covariance at non-negative lags of AnalogData
    (reference ST_compRoutines.py:465-640). Output per trial ``(nLags, 1,
    N, N)`` float32; the lags ride on the time axis, offset 0 at lag 0.
    """

    valid_kws = ["norm", "polyremoval"]

    def __init__(self, samplerate=1.0, polyremoval=0, norm=False):
        super().__init__(samplerate=samplerate, polyremoval=polyremoval, norm=norm, foi=None)

    def output_trial_shape(self, trial_shape):
        T, C = trial_shape
        return (_ccov_lag_geometry(T)[0], 1, C, C), np.dtype(np.float32)

    def process_single_trial(self, trial, **cfg):
        return self.process_batch(trial[None], **cfg)[0]

    def process_batch(self, batch, **cfg):
        return cross_covariance_batch(batch, polyremoval=cfg["polyremoval"], norm=cfg["norm"])

    def process_batch_sum(self, batch, n_valid, **cfg):
        """The masked trial sum: the frequency-domain Gram and one inverse
        FFT (:func:`ccov_batch_sum`). `norm` divides each trial by its own
        standard deviations, which does not commute with the sum: then the
        per-trial outputs are summed (the frontend never averages normed
        trials: ``norm=bool(keeptrials)``)."""
        if cfg["norm"]:
            per_trial = self.process_batch(batch, **cfg)
            valid = torch.arange(batch.shape[0], device=batch.device) < n_valid
            return torch.where(valid[:, None, None, None, None], per_trial, 0.0).sum(dim=0)
        return ccov_batch_sum(batch, n_valid, polyremoval=cfg["polyremoval"])

    def process_metadata(self, data, out):
        out.trialdefinition = self.default_trialdefinition(data, out)
        out.samplerate = data.samplerate
        chan = take_labels(data.channel, getattr(self.selector, "channel", None))
        out.channel_i = chan
        out.channel_j = chan
