# -*- coding: utf-8 -*-
#
# Statistics compute routines: trial reductions, leave-one-out averages
# and summary statistics along one dimension.
#
# Port of syncopy_tpu/statistics/compRoutines.py (TrialReduce, LOOAverage,
# NumpyStatDim, Covariance, EngineScratch, _propagate_dim_props).

import numpy as np
import torch

from ..engine.routine import ComputationalRoutine

__all__ = ["NumpyStatDim", "Covariance", "TrialReduce", "LOOAverage", "EngineScratch"]


class EngineScratch:
    """Duck-typed output target for engine-internal passes whose result is
    not a valid data-class payload (e.g. a (nTrials, C, C) covariance
    stack): plain attributes, no shape validation, no persistence."""

    def __init__(self):
        self._log = ""
        self.data = None
        self.log = ""
        self._device_resident = None


def _real_dtype(dtype):
    return {np.dtype(np.complex64): np.dtype(np.float32),
            np.dtype(np.complex128): np.dtype(np.float64)}.get(np.dtype(dtype), np.dtype(dtype))


def _double_dtype(dtype):
    return np.dtype(np.complex128 if np.dtype(dtype).kind == "c" else np.float64)


def _float_dtype(dtype):
    """The dtype a mean of `dtype` values has: floats and complex stay,
    integers and booleans become float32."""
    dtype = np.dtype(dtype)
    return dtype if dtype.kind in "fc" else np.dtype(np.float32)


class TrialReduce(ComputationalRoutine):
    """
    Streamed reduction over the trial axis: the engine's chunked
    ``keeptrials=False`` accumulation (host memory bounded by one chunk).
    The engine divides the accumulated sum by the trial count.

    Modes:

    - ``sum``: the masked trial sum, hence the trial mean;
    - ``unit_sum``: the sum of unit phasors ``x/|x|``, the resultant of
      ITC-style statistics;
    - ``centered_sq``: the sum of ``|x - m|**2`` with the precomputed trial
      mean `m` fed as an auxiliary input, the exact two-pass variance.

    With `double` the reduction runs, and returns, in float64.
    """

    valid_kws = ["mode"]

    def __init__(self, mode="sum", center=None, double=False):
        super().__init__(mode=str(mode), double=bool(double))
        self._center = None if center is None else np.asarray(center)

    def output_trial_shape(self, trial_shape):
        dtype = _float_dtype(self.in_dtype)
        if self.cfg["double"]:
            dtype = _double_dtype(dtype)
        if self.cfg["mode"] == "centered_sq":
            dtype = _real_dtype(dtype)
        elif self.cfg["mode"] == "unit_sum" and dtype.kind != "c":
            dtype = np.dtype(np.complex64)
        return tuple(trial_shape), dtype

    def per_trial_inputs(self, data, trial_positions):
        if self.cfg["mode"] != "centered_sq":
            return ()
        # the engine slices per-chunk rows out of this zero-copy view
        return (np.broadcast_to(self._center, (len(trial_positions),) + self._center.shape),)

    @staticmethod
    def _reduce(x, *aux, mode, double):
        if double:
            x = x.to(torch.complex128 if x.is_complex() else torch.float64)
        elif not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        if mode == "unit_sum":
            return x / x.abs()
        if mode == "centered_sq":
            d = x - aux[0]
            return (d * d.conj()).real if d.is_complex() else d * d
        return x

    def process_single_trial(self, trial, *aux, **cfg):
        return self._reduce(trial, *aux, mode=cfg["mode"], double=cfg["double"])

    def process_batch_sum(self, batch, n_valid, *aux, **cfg):
        x = self._reduce(batch, *aux, mode=cfg["mode"], double=cfg["double"])
        # where-mask, not multiply: padding rows can be 0/0 phase units
        valid = torch.arange(x.shape[0], device=x.device) < n_valid
        x = torch.where(valid.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        return x.sum(dim=0)

    def process_metadata(self, data, out):
        # a single "trial": the first selected trial's definition row
        out._trialdefinition = np.array(self.selector.trialdefinition[0, :][None, :])
        if getattr(data, "samplerate", None) is not None:
            out.samplerate = data.samplerate


class LOOAverage(ComputationalRoutine):
    """
    Leave-one-out trial averages for jackknifing (reference
    jackknifing.py:14-108): per trial ``avg + (avg - x_i)/(N - 1)``, with
    the precomputed trial average `avg` streamed in as an auxiliary input.
    Runs ``keeptrials=True`` through the engine.

    The form matters: ``(N*avg - x_i)/(N - 1)`` is the same number, but
    ``N*avg - x_i`` cancels at N times the result's magnitude and loses
    about log2(N) bits, enough at N = 1000 to leave a wide-channel
    replicate CSD without a Wilson factorization. Here the subtraction
    happens at the operands' own scale.
    """

    valid_kws = ["n_trials"]

    def __init__(self, n_trials, avg):
        super().__init__(n_trials=int(n_trials))
        self._avg = np.asarray(avg)

    def output_trial_shape(self, trial_shape):
        return tuple(trial_shape), self.in_dtype

    def per_trial_inputs(self, data, trial_positions):
        return (np.broadcast_to(self._avg, (len(trial_positions),) + self._avg.shape),)

    def process_single_trial(self, trial, avg, **cfg):
        return self.process_batch(trial[None], avg[None], **cfg)[0]

    def process_batch(self, batch, avg, **cfg):
        return (avg + (avg - batch) / (cfg["n_trials"] - 1)).to(batch.dtype)

    def process_metadata(self, data, out):
        out.trialdefinition = self.default_trialdefinition(data, out)
        if getattr(data, "samplerate", None) is not None:
            out.samplerate = data.samplerate


def _nanmean(x, dim):
    """numpy's nanmean along `dim`, for real and complex `x`."""
    keep = ~torch.isnan(x)
    total = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return total.sum(dim=dim, keepdim=True) / keep.sum(dim=dim, keepdim=True)


def _nanvar(x, dim):
    """numpy's nanvar (ddof 0) along `dim`, complex values by modulus."""
    d = x - _nanmean(x, dim)
    return _nanmean((d * d.conj()).real if d.is_complex() else d * d, dim)


def _nanmedian(x, dim):
    """numpy's nanmedian along `dim`: the mean of the two middle values
    for an even count (torch.nanmedian takes the lower one)."""
    return torch.nanquantile(x, 0.5, dim=dim, keepdim=True)


class NumpyStatDim(ComputationalRoutine):
    """
    Summary statistic along one dimord axis of each trial, reduced to a
    singleton (reference statistics/compRoutines.py:22-137). NaNs are
    ignored, as numpy's nan-functions do.
    """

    valid_kws = ["operation", "axis", "dim"]

    methods = {
        "mean": _nanmean,
        "std": lambda x, dim: torch.sqrt(_nanvar(x, dim)),
        "var": _nanvar,
        "median": _nanmedian,
    }

    def __init__(self, operation="mean", axis=0):
        super().__init__(operation=operation, axis=int(axis))

    def output_trial_shape(self, trial_shape):
        shape = list(trial_shape)
        shape[self.cfg["axis"]] = 1
        dtype = _float_dtype(self.in_dtype)
        if self.cfg["operation"] in ("std", "var"):
            dtype = _real_dtype(dtype)
        return tuple(shape), dtype

    def process_single_trial(self, trial, **cfg):
        return self.process_batch(trial[None], **cfg)[0]

    def process_batch(self, batch, **cfg):
        if not (batch.is_floating_point() or batch.is_complex()):
            batch = batch.to(torch.float32)
        return self.methods[cfg["operation"]](batch, cfg["axis"] + 1)

    def process_metadata(self, in_data, out_data):
        dim = in_data.dimord[self.cfg["axis"]]
        out_data.samplerate = in_data.samplerate
        sel = self.selector

        if dim == "time" and not self.keeptrials:
            trldef = np.array([[0, 1, 0]])
        elif dim != "time" and not self.keeptrials:
            trldef = sel.trialdefinition[0, :][None, :]
        elif dim == "time" and self.keeptrials:
            n_trials = len(sel.trial_ids)
            stacking = np.arange(n_trials)[:, None]
            trldef = np.hstack((stacking, stacking + 1, np.zeros((n_trials, 1))))
        else:
            trldef = sel.trialdefinition
        out_data.trialdefinition = trldef

        _propagate_dim_props(in_data, out_data, sel, reduced_dim=dim,
                             label=self.cfg["operation"])


class Covariance(ComputationalRoutine):
    """
    Per-trial channel covariance of time-locked data
    (reference statistics/compRoutines.py:139-233): the demeaned float32
    ``x.T @ x / (T - ddof)`` of each trial, batched (one matmul a chunk,
    TF32 off). Output per trial: ``(1, nChannel, nChannel)`` stacked along
    the first axis. On a mesh's channel axis the demeaning
    (:meth:`channel_stage`) runs on the channel positions.
    """

    channel_split = "cross"

    valid_kws = ["ddof", "demean"]

    def __init__(self, ddof=1, demean=True):
        super().__init__(ddof=int(ddof), demean=bool(demean))

    def output_trial_shape(self, trial_shape):
        C = trial_shape[1]
        return (1, C, C), np.dtype(np.float32)

    def process_single_trial(self, trial, **cfg):
        return self.process_batch(trial[None], **cfg)[0]

    def channel_stage(self, batch, **cfg):
        x = batch.to(torch.float32)
        if cfg["demean"]:
            x = x - x.mean(dim=1, keepdim=True)
        return x

    def process_batch_staged(self, x, **cfg):
        n = x.shape[1] - cfg["ddof"]
        return (torch.matmul(x.transpose(1, 2), x) / n)[:, None]

    def process_batch(self, batch, **cfg):
        return self.process_batch_staged(self.channel_stage(batch, **cfg), **cfg)

    def process_metadata(self, data, out):
        pass  # the caller attaches the result as an extra dataset


def _propagate_dim_props(in_data, out_data, sel, reduced_dim, label):
    """Propagate channel/freq/taper labels honoring selections; the reduced
    dimension collapses to a single `label` entry (freq becomes None)."""

    def _take(labels, indexer):
        labels = np.asarray(labels)
        if indexer is None:
            return labels
        if isinstance(indexer, slice):
            return labels[indexer]
        return labels[np.asarray(indexer, dtype=int)]

    for prop in ("channel", "channel_i", "channel_j", "taper"):
        if prop in in_data.dimord and hasattr(out_data.__class__, prop):
            if prop == reduced_dim:
                setattr(out_data, prop, [label])
            else:
                try:
                    setattr(out_data, prop, _take(getattr(in_data, prop), getattr(sel, prop, None)))
                except Exception:
                    pass
    if "freq" in in_data.dimord and hasattr(out_data.__class__, "freq"):
        if reduced_dim == "freq":
            out_data.freq = None
        else:
            out_data.freq = _take(in_data.freq, getattr(sel, "freq", None))
