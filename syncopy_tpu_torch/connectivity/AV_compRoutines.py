# -*- coding: utf-8 -*-
#
# Averaged-input connectivity compute routines.
#
# Port of syncopy_tpu/connectivity/AV_compRoutines.py: PPCReduction and
# GrangerCausality. NormalizeCrossSpectra has no counterpart (coherence
# runs fused onto the trial sum); NormalizeCrossCov lands with
# ROADMAP Queue 1 item 8.

import numpy as np
import torch

from ..engine.routine import ComputationalRoutine
from ..ops.connectivity import granger, regularize_csd, wilson_sf
from ..shared.errors import SPYValueError, not_ported
from .ST_compRoutines import _take_labels

__all__ = ["PPCReduction", "GrangerCausality"]


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


class GrangerCausality(ComputationalRoutine):
    """
    Pairwise Granger-Geweke causality from a trial-averaged CSD:
    condition-number regularization, Wilson factorization and the Granger
    formula in complex128 on the device (reference
    AV_compRoutines.py:292-484). Convergence diagnostics reach
    ``out.info`` through the engine's aux-info channel.
    """

    valid_kws = ["rtol", "nIter", "cond_max"]

    metadata_keys = ("converged", "max rel. err", "reg. factor", "initial cond. num")

    # one diagnostic per factorized input row
    aux_per_trial = frozenset(metadata_keys)

    def __init__(self, rtol=5e-6, nIter=100, cond_max=1e4):
        super().__init__(rtol=float(rtol), nIter=int(nIter), cond_max=float(cond_max))

    def output_trial_shape(self, trial_shape):
        return tuple(trial_shape), np.dtype(np.float32)

    def pre_check(self):
        """Assert the input is a trial average (reference
        AV_compRoutines.py:141-153)."""
        if self.buckets is None:
            raise SPYValueError(
                legal="Initialize the computational Routine first!",
                varname=self.__class__.__name__,
                actual="ComputationalRoutine not initialized!",
            )
        if self.numTrials != 1:
            raise SPYValueError(
                legal="1 trial: normalizations can only be done on averaged quantities!",
                varname="data",
                actual="DataSet contains {} trials".format(self.numTrials),
            )

    def process_batch(self, batch, **cfg):
        if batch.shape[0] > 1:
            # jackknife replicates, with regularization shared from their mean
            raise not_ported("GrangerCausality over jackknife replicates",
                             "ROADMAP Queue 1 item 8 (jackknife)")
        return super().process_batch(batch, **cfg)

    def process_single_trial(self, trial, **cfg):
        """One averaged CSD ``(nTime, F, N, N)``: every window (one unless
        the input is time-resolved) is factorized on its own, batched;
        the run converged only if every window did, and the diagnostics
        are the windows' maxima."""
        CSDreg, factor, ini_cn = regularize_csd(
            trial.to(torch.complex128), cond_max=cfg["cond_max"], eps_max=1e-1)
        H, Sigma, conv, err, _ = wilson_sf(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
        info = {
            "converged": conv.all(),
            "max rel. err": err.amax(),
            "reg. factor": factor.amax(),
            "initial cond. num": ini_cn.amax(),
        }
        return granger(CSDreg, H, Sigma).to(torch.float32), info

    def process_metadata(self, data, out):
        out.trialdefinition = np.array(self.selector.trialdefinition)
        out.samplerate = data.samplerate
        sel = self.selector
        out.channel_i = _take_labels(data.channel_i, getattr(sel, "channel_i", None))
        out.channel_j = _take_labels(data.channel_j, getattr(sel, "channel_j", None))
        out.freq = _take_labels(data.freq, getattr(sel, "freq", None))
        for key, value in self.aux_info.items():
            val = np.asarray(value).ravel()
            if key == "converged":
                out.info[key] = bool(val.all()) if val.size else False
            elif key == "max rel. err":
                out.info[key] = float(val.max()) if val.size else float("nan")
            else:
                out.info[key] = float(val[0] if val.size else val)
