# -*- coding: utf-8 -*-
#
# Averaged-input connectivity compute routines.
#
# Port of syncopy_tpu/connectivity/AV_compRoutines.py: PPCReduction. The
# other routines (NormalizeCrossSpectra, NormalizeCrossCov,
# GrangerCausality) land with their slices (ROADMAP Queue 1 items 7-8).

import numpy as np
import torch

from ..engine.routine import ComputationalRoutine

__all__ = ["PPCReduction"]


class PPCReduction(ComputationalRoutine):
    """
    Pairwise phase consistency via the streamed resultant-vector identity
    (Vinck 2010, Eq. 14):

        PPC = (|sum_j u_j|^2 - n) / (n (n - 1)),   u_j = z_j / |z_j|

    The per-trial unit cross-spectra are summed chunk-wise on the device
    through the engine's ``keeptrials=False`` path (replaces reference
    connectivity_analysis.py:624-667); the final normalization runs as the
    fused post (:meth:`make_post`).
    """

    valid_kws = []

    def output_trial_shape(self, trial_shape):
        return tuple(trial_shape), np.dtype(np.complex64)

    def process_single_trial(self, trial, **cfg):
        return trial / trial.abs()

    def process_batch_sum(self, batch, n_valid, **cfg):
        u = batch / batch.abs()
        # where-mask: padding rows are 0/0 = NaN phase units
        valid = torch.arange(u.shape[0], device=u.device) < n_valid
        u = torch.where(valid.reshape((-1,) + (1,) * (u.ndim - 1)), u,
                        torch.zeros((), dtype=u.dtype, device=u.device))
        return u.sum(dim=0)

    @staticmethod
    def make_post(n_trials):
        """Fused finalization: the engine hands the resultant / n."""

        def post(mean_u):
            resultant = n_trials * mean_u
            power = (resultant * resultant.conj()).real
            return ((power - n_trials) / (n_trials * (n_trials - 1))).to(torch.float32)

        return post

    def process_metadata(self, data, out):
        out.trialdefinition = np.array([[0, self.outputShape[0], 0]])
        out.samplerate = data.samplerate
        out.channel_i = np.asarray(data.channel_i)
        out.channel_j = np.asarray(data.channel_j)
        out.freq = np.asarray(data.freq)
