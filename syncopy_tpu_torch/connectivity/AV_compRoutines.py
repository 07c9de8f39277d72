# -*- coding: utf-8 -*-
#
# Averaged-input connectivity compute routines.
#
# Port of syncopy_tpu/connectivity/AV_compRoutines.py: PPCReduction,
# NormalizeCrossSpectra, NormalizeCrossCov and GrangerCausality (one
# averaged CSD, the windows of time-resolved input, or jackknife
# replicates sharing the regularization of their mean). Where trials are
# averaged in one pass, coherence and cross-correlation run fused onto the
# trial sum instead (connectivity_analysis.py); the routines here take
# the jackknife replicates and direct estimates.

import numpy as np
import torch

from ..engine.routine import ComputationalRoutine, take_labels
from ..ops.connectivity import (
    apply_csd_reg,
    csd_reg_params,
    granger,
    normalize_ccov,
    normalize_csd,
    psd_topup,
    regularize_csd,
    wilson_sf,
    wilson_sf_twosided,
)
from ..shared.errors import SPYValueError
from ..shared.profiling import span

__all__ = ["PPCReduction", "NormalizeCrossSpectra", "NormalizeCrossCov", "GrangerCausality"]

#: device bytes for the Wilson workspace of one group of jackknife
#: replicates: GrangerCausality factorizes replicates in groups of this
#: many bytes, counting _WILSON_TENSORS complex128 (F, N, N) tensors each
_REPLICATE_BYTES = 4 * 1024**3
_WILSON_TENSORS = 16


def _factorize(CSDreg, cfg):
    """Wilson's factorization of the regularized ``(..., F, N, N)`` CSDs on
    the device: the one-sided iteration (:func:`wilson_sf`), then the
    two-sided one of the host path (:func:`wilson_sf_twosided`) for each
    CSD the first leaves unconverged, in its place. The demeaned DC bin's
    rounding noise can make one form diverge where the other converges (1
    of 200 jackknife replicates of the 16-channel AR(2) network in
    chip_smoke's phase 10; some 1000-trial, 128-channel AR(2) datasets).
    Returns ``(Hfunc, Sigma, converged, err)``."""
    H, Sigma, conv, err, _ = wilson_sf(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
    retry = ~conv
    if bool(retry.any()):
        H2, Sigma2, c2, e2, _ = wilson_sf_twosided(CSDreg[retry], nIter=cfg["nIter"],
                                                   rtol=cfg["rtol"])
        H[retry], Sigma[retry], conv[retry], err[retry] = H2, Sigma2, c2, e2
    return H, Sigma, conv, err


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


class _AVRoutine(ComputationalRoutine):
    """Shared pre-check and metadata of the averaged-input routines."""

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

    def process_metadata(self, data, out):
        out.trialdefinition = np.array(self.selector.trialdefinition)
        out.samplerate = data.samplerate
        sel = self.selector
        out.channel_i = take_labels(data.channel_i, getattr(sel, "channel_i", None))
        out.channel_j = take_labels(data.channel_j, getattr(sel, "channel_j", None))
        out.freq = take_labels(data.freq, getattr(sel, "freq", None))


class NormalizeCrossSpectra(_AVRoutine):
    """Coherence from trial-averaged CSDs (reference
    AV_compRoutines.py:35-163): the jackknife route's direct estimate and
    replicates, batched over a chunk. With `double` the normalization runs
    in float64 and returns float64 (complex128): the jackknife bias
    ``(N - 1) (mean(rep) - direct)`` multiplies the replicates' rounding
    by N - 1, which float32 coherence puts at ~1e-4 for N = 1000."""

    valid_kws = ["output"]

    def __init__(self, output="abs", double=False):
        super().__init__(output=output, double=bool(double))

    def output_trial_shape(self, trial_shape):
        complex_out = self.cfg["output"] in ("complex", "fourier")
        if self.cfg["double"]:
            return tuple(trial_shape), np.dtype(np.complex128 if complex_out else np.float64)
        return tuple(trial_shape), np.dtype(np.complex64 if complex_out else np.float32)

    def process_single_trial(self, trial, **cfg):
        return self.process_batch(trial[None], **cfg)[0]

    def process_batch(self, batch, **cfg):
        if cfg["double"]:
            batch = batch.to(torch.complex128)
        return normalize_csd(batch, cfg["output"])


class NormalizeCrossCov(_AVRoutine):
    """Cross-correlation from a trial-averaged cross-covariance
    (reference AV_compRoutines.py:165-290). The frontend fuses the same
    normalization onto the trial sum instead (``_corr_post``)."""

    valid_kws = []

    def output_trial_shape(self, trial_shape):
        return tuple(trial_shape), np.dtype(np.float32)

    def process_single_trial(self, trial, **cfg):
        return normalize_ccov(trial)


class GrangerCausality(_AVRoutine):
    """
    Pairwise Granger-Geweke causality from trial-averaged CSDs:
    condition-number regularization, Wilson factorization and the Granger
    formula in complex128 on the device (reference
    AV_compRoutines.py:292-484). Convergence diagnostics reach
    ``out.info`` through the engine's aux-info channel. On a mesh the
    stage runs whole on its first position: jackknife replicates share one
    regularization, taken over all of them in one chunk.
    """

    trial_split = False

    valid_kws = ["rtol", "nIter", "cond_max"]

    metadata_keys = ("converged", "max rel. err", "reg. factor", "initial cond. num")

    # one diagnostic per factorized input row (trial average or jackknife
    # replicate)
    aux_per_trial = frozenset(metadata_keys)

    def __init__(self, rtol=5e-6, nIter=100, cond_max=1e4):
        super().__init__(rtol=float(rtol), nIter=int(nIter), cond_max=float(cond_max))

    def output_trial_shape(self, trial_shape):
        return tuple(trial_shape), np.dtype(np.float32)

    def _chunk_size(self, shp, n_positions, itemsize, aux_bytes=0):
        """Every row in one engine chunk: :meth:`process_batch` shares the
        regularization of the mean over the rows it is handed, so this
        makes that the mean over all jackknife replicates. The input stays
        complex64 on the device (R x F x N x N x 8 bytes: 16.4 GB at 1000
        x 501 x 64 x 64); the Wilson workspace is bounded by
        ``_REPLICATE_BYTES``."""
        return max(1, n_positions)

    def process_batch(self, batch, **cfg):
        """``(R, nTime, F, N, N)`` averaged CSDs to Granger spectra and
        per-row diagnostics. One row, or time-resolved rows: each window
        regularized on its own (:meth:`process_single_trial`). Several
        single-window rows are jackknife replicates (reference
        AV_compRoutines.py:185-226): one :func:`csd_reg_params` of their
        mean, taken over the rows handed in (all replicates, see
        :meth:`_chunk_size`), is shared by every replicate, then
        :func:`psd_topup` lifts any bin of a replicate the shared shift
        leaves without a Cholesky factor. Identical loading makes the
        jackknife spread measure trial influence, not regularization-grid
        flips; the mean is the trial average itself. The replicates are
        factorized in groups under ``_REPLICATE_BYTES``, each group one
        batched Wilson in which a replicate is frozen where it stops
        alone; each factorization starts cold (a warm start from another
        replicate's factor freezes a phase error no error test sees). A
        replicate the one-sided iteration leaves unconverged is factorized
        again on the device by the two-sided one (:func:`_factorize`)."""
        if batch.shape[0] == 1 or batch.shape[1] != 1:
            return super().process_batch(batch, **cfg)
        rows = batch[:, 0]  # (R, F, N, N), complex64 until its group runs
        R, F, N = rows.shape[0], rows.shape[1], rows.shape[-1]
        group = max(1, _REPLICATE_BYTES // (_WILSON_TENSORS * F * N * N * 16))
        with span("spt.granger.regularize"):
            mean_csd = sum(rows[g0 : g0 + group].to(torch.complex128).sum(dim=0)
                           for g0 in range(0, R, group)) / R
            psd_shift, eps, ini_cn = csd_reg_params(mean_csd, cond_max=cfg["cond_max"],
                                                    eps_max=1e-1)
        G, conv, err = [], [], []
        for g0 in range(0, R, group):
            with span("spt.granger.regularize"):
                CSDreg = psd_topup(apply_csd_reg(rows[g0 : g0 + group].to(torch.complex128),
                                                 psd_shift, eps, eps_max=1e-1))
            H, Sigma, c, e = _factorize(CSDreg, cfg)
            G.append(granger(CSDreg, H, Sigma).to(torch.float32))
            conv.append(c)
            err.append(e)
        info = {
            "converged": torch.cat(conv),
            "max rel. err": torch.cat(err),
            "reg. factor": eps.expand(R),
            "initial cond. num": ini_cn.expand(R),
        }
        return torch.cat(G)[:, None], info

    def process_single_trial(self, trial, **cfg):
        """One averaged CSD ``(nTime, F, N, N)``: every window (one unless
        the input is time-resolved) is factorized on its own, batched, a
        window the one-sided iteration leaves unconverged again by the
        two-sided one (:func:`_factorize`); the run converged only if
        every window did, and the diagnostics are the windows' maxima."""
        CSDreg, factor, ini_cn = regularize_csd(
            trial.to(torch.complex128), cond_max=cfg["cond_max"], eps_max=1e-1)
        H, Sigma, conv, err = _factorize(CSDreg, cfg)
        info = {
            "converged": conv.all(),
            "max rel. err": err.amax(),
            "reg. factor": factor.amax(),
            "initial cond. num": ini_cn.amax(),
        }
        return granger(CSDreg, H, Sigma).to(torch.float32), info

    def process_metadata(self, data, out):
        super().process_metadata(data, out)
        for key, value in self.aux_info.items():
            val = np.asarray(value).ravel()
            if key == "converged":
                # several rows (replicates): converged only if all did
                out.info[key] = bool(val.all()) if val.size else False
            elif key == "max rel. err":
                out.info[key] = float(val.max()) if val.size else float("nan")
            else:
                out.info[key] = float(val[0] if val.size else val)
