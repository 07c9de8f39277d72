# -*- coding: utf-8 -*-
#
# Single-trial connectivity compute routines (main-path subset).
#
# Port of syncopy_tpu/connectivity/ST_compRoutines.py: _CrossRoutine and
# CrossSpectra. PPCSpectra, SpectralDyadicProduct and CrossCovariance land
# with ROADMAP Queue 1 item 8.

import numpy as np
import torch

from ..engine.routine import ComputationalRoutine
from ..shared.errors import not_ported
from ..ops.csd_kernels import csd_accumulate_tiled
from ..ops.spectral import detrend
from ..ops.windows import make_tapers

__all__ = ["CrossSpectra"]


def _take_labels(labels, indexer):
    labels = np.asarray(labels)
    if indexer is None:
        return labels
    if isinstance(indexer, slice):
        return labels[indexer]
    return labels[np.asarray(indexer, dtype=int)]


class _CrossRoutine(ComputationalRoutine):
    """Shared metadata propagation for CrossSpectralData outputs."""

    dimord = ["time", "freq", "channel_i", "channel_j"]

    def _cross_trialdefinition(self, n_times):
        if not self.keeptrials:
            n_times = n_times[:1]
        bounds = np.concatenate([[0], np.cumsum(n_times)])
        trl = np.zeros((len(n_times), 3))
        trl[:, 0] = bounds[:-1]
        trl[:, 1] = bounds[1:]
        return trl

    def process_metadata(self, data, out):
        sdim = 0
        n_times = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
        out.trialdefinition = self._cross_trialdefinition(n_times)
        out.samplerate = data.samplerate
        sel = self.selector
        chan = _take_labels(data.channel, getattr(sel, "channel", None))
        out.channel_i = chan
        out.channel_j = chan
        if self.cfg.get("foi") is not None:
            out.freq = self.cfg["foi"]


class CrossSpectra(_CrossRoutine):
    """
    Single-trial (multi-)tapered cross spectra of AnalogData
    (reference ST_compRoutines.py:270-463): implicit mtmfft + channel
    outer product, tapers averaged. Output per trial ``(1, nFreq, N, N)``.
    """

    valid_kws = ["taper", "taper_opt", "tapsmofrq", "nTaper", "pad", "foi", "foilim",
                 "polyremoval", "demean_taper", "output"]

    def __init__(self, samplerate=1.0, nSamples=None, taper="hann", taper_opt=None,
                 demean_taper=False, polyremoval=0, freq_idx=None, foi=None,
                 exact_fft=False):
        # exact_fft: the factorization-grade CSD Granger needs; it lands
        # with the Granger slice (ROADMAP Queue 1 item 7)
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
    def _tapered_batch(batch, cfg):
        """(B, K, T, C) detrended+tapered trial batch and the taper count."""
        nfft = cfg["nSamples"] or batch.shape[1]
        x = detrend(batch.to(torch.float32), cfg["polyremoval"], dim=1)
        tapers = torch.from_numpy(
            make_tapers(cfg["taper"], cfg["taper_opt"], batch.shape[1], nfft, cfg["samplerate"])
        ).to(x.device)
        tapered = tapers[None, :, :, None] * x[:, None, :, :]  # (B, K, T, C)
        if cfg["demean_taper"]:
            tapered = tapered - tapered.mean(dim=2, keepdim=True)
        return tapered, tapers.shape[0], nfft

    @staticmethod
    def _batch_spectra(tapered, nfft, cfg):
        """(B, K, F, C) one-sided spectra of a tapered batch."""
        spec = torch.fft.rfft(tapered, n=nfft, dim=2)
        if cfg["freq_idx"] is not None:
            idx = torch.as_tensor(cfg["freq_idx"], device=spec.device)
            spec = spec.index_select(2, idx)
        return spec

    def process_single_trial(self, trial, **cfg):
        if cfg.get("exact_fft"):
            raise not_ported("exact_fft (the compensated DFT for Granger)", "ROADMAP Queue 1 item 7")
        tapered, K, nfft = self._tapered_batch(trial[None], cfg)
        spec = self._batch_spectra(tapered, nfft, cfg)[0]  # (K, F, C)
        CS = torch.einsum("kfi,kfj->fij", spec, spec.conj()) / K
        return CS[None].to(torch.complex64)

    def process_batch_sum(self, batch, n_valid, **cfg):
        """
        Trial-summed cross spectra over the first `n_valid` trials of a
        padded batch: the whole trial x taper stack collapses in one
        tiled CSD accumulation (CUDA kernel on the card) instead of
        materializing per-trial (nFreq, N, N) matrices.
        """
        if cfg.get("exact_fft"):
            raise not_ported("exact_fft (the compensated DFT for Granger)", "ROADMAP Queue 1 item 7")
        tapered, K, nfft = self._tapered_batch(batch, cfg)
        spec = self._batch_spectra(tapered, nfft, cfg)
        B, _, F, C = spec.shape
        slab = spec.reshape(B * K, F, C).contiguous()
        cs_sum = csd_accumulate_tiled(slab, n_valid * K) / K
        return cs_sum[None]
