# -*- coding: utf-8 -*-
#
# Preprocessing compute routines.
#
# Port of syncopy_tpu/preproc/compRoutines.py (parity target: reference
# syncopy/preproc/compRoutines.py:26-883). Each routine states its output
# shape (`output_trial_shape`, which the JAX engine traces) and computes a
# whole chunk in `process_batch`, where the JAX engine vmaps a per-trial
# function. Routines whose workspace exceeds their input and output declare
# it (`device_bytes_per_trial`): the IIR kernel's float64 scratch, the FIR's
# FFT planes, the zero-stuffed resampling signal. Not ported:
# `extra_cache_key` (the JAX compile cache and the filter-GEMM knob).

import numpy as np
import torch

from ..engine.routine import ComputationalRoutine
from ..ops.filtering import (
    _resample_kernel,
    apply_fir,
    butter_sos,
    design_wsinc,
    downsample,
    fir_fft_length,
    hilbert,
    minphaserceps,
    resample_poly,
    sosfilt,
    sosfiltfilt,
)
from ..ops.iir_kernels import sosfilt_padlen
from ..ops.spectral import detrend, spectral_convert

__all__ = [
    "SincFiltering",
    "ButFiltering",
    "Rectify",
    "Hilbert",
    "Downsample",
    "Resample",
    "Detrending",
    "Standardize",
]

_F32 = np.dtype(np.float32)


class _PreprocRoutine(ComputationalRoutine):
    """Shared metadata: same-shape AnalogData output, properties carried.

    Filtering/detrending routines report a per-trial ``has_nan`` flag
    through the engine's aux side-channel (reference compRoutines.py:256,
    718 collects the same metadata per worker); the frontend exposes it as
    ``out.info['nan_trials']``. Channels are independent: a mesh's channel
    axis splits them, and the flags of the channel pieces combine by
    "any"."""

    aux_per_trial = frozenset({"has_nan"})
    channel_split = "separable"

    def output_trial_shape(self, trial_shape):
        return tuple(trial_shape), _F32

    @staticmethod
    def _nan_info(batch):
        return {"has_nan": torch.isnan(batch).flatten(1).any(dim=1)}

    def process_metadata(self, data, out):
        sel = self.selector
        if self.keeptrials:
            out.trialdefinition = np.array(sel.trialdefinition)
        else:
            out.trialdefinition = np.array(sel.trialdefinition[:1])
        out.samplerate = data.samplerate
        self.propagate_properties(data, out)


class SincFiltering(_PreprocRoutine):
    """FIR windowed-sinc filtering (reference compRoutines.py:26-172;
    kernel firws.py). Direction 'twopass' runs forward+reverse passes for
    zero phase; 'onepass-minphase' uses the causal minimum-phase kernel."""

    valid_kws = ["filter_class", "filter_type", "freq", "order", "direction",
                 "window", "polyremoval"]

    def __init__(self, samplerate=1.0, filter_type="lp", freq=None, order=1000,
                 direction="twopass", window="hamming", polyremoval=None):
        f_c = np.asarray(freq, dtype=float) / samplerate
        if f_c.size == 1:
            f_c = float(f_c)
        kernel = design_wsinc(window, int(order), f_c, filter_type)
        if direction == "onepass-minphase":
            kernel = minphaserceps(kernel)
        super().__init__(
            samplerate=samplerate, kernel=kernel, direction=direction,
            polyremoval=polyremoval,
        )

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """The rfft planes, their product with the kernel's spectrum and
        the irfft at the FFT length, and the reversed copies of twopass."""
        T, C = shp
        L = fir_fft_length(T, len(self.cfg["kernel"]))
        return (2 * (L // 2 + 1) * C * 8 + L * C * 4) + 6 * T * C * 4

    def process_batch(self, batch, **cfg):
        x = detrend(batch.to(torch.float32), cfg["polyremoval"], dim=1)
        kernel = cfg["kernel"]
        y = apply_fir(x, kernel)
        if cfg["direction"] == "twopass":
            y = apply_fir(y.flip(1), kernel).flip(1)
        return y, self._nan_info(batch)


class ButFiltering(_PreprocRoutine):
    """Butterworth IIR filtering (reference compRoutines.py:174-300); the
    biquad cascade runs in float64 in the hand-written CUDA kernel
    (ops/iir_kernels.py), output float32."""

    valid_kws = ["filter_class", "filter_type", "freq", "order", "direction",
                 "polyremoval"]

    def __init__(self, samplerate=1.0, filter_type="lp", freq=None, order=4,
                 direction="twopass", polyremoval=None):
        sos = butter_sos(int(order), freq, filter_type, samplerate)
        super().__init__(
            samplerate=samplerate, sos=sos, direction=direction, polyremoval=polyremoval
        )

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """The kernel's float64 scratch of the extended trial (twopass),
        the float32 detrended copy, the output and the NaN flags."""
        T, C = shp
        pad = sosfilt_padlen(self.cfg["sos"], T) if self.cfg["direction"] == "twopass" else 0
        return (T + 2 * pad) * C * 8 + 4 * T * C * 4

    def process_batch(self, batch, **cfg):
        x = detrend(batch.to(torch.float32), cfg["polyremoval"], dim=1)
        if cfg["direction"] == "twopass":
            y = sosfiltfilt(cfg["sos"], x)
        else:
            y = sosfilt(cfg["sos"], x)
        return y, self._nan_info(batch)


class Rectify(_PreprocRoutine):
    """Full-wave rectification (reference compRoutines.py:302-362)."""

    valid_kws = ["rectify"]

    def __init__(self):
        super().__init__()

    def process_batch(self, batch, **cfg):
        return batch.to(torch.float32).abs()


class Hilbert(_PreprocRoutine):
    """Hilbert transform / analytic signal (reference compRoutines.py:364-443)."""

    valid_kws = ["hilbert"]

    def __init__(self, output="abs"):
        super().__init__(output=output)

    def output_trial_shape(self, trial_shape):
        dtype = np.complex64 if self.cfg["output"] == "complex" else np.float32
        return tuple(trial_shape), np.dtype(dtype)

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """The complex64 spectrum, its masked copy and the inverse."""
        T, C = shp
        return 3 * T * C * 8 + T * C * (4 + np.dtype(out_dt).itemsize)

    def process_batch(self, batch, **cfg):
        return spectral_convert(hilbert(batch), cfg["output"])


class _ResamplingRoutine(_PreprocRoutine):
    """Shared trialdefinition rescaling for down/resampling
    (reference compRoutines.py:858-881)."""

    def process_metadata(self, data, out):
        sel = self.selector
        factor = self.cfg["new_samplerate"] / self.cfg["samplerate"]
        n_out = [oshp[0] for oshp in self._per_trial_out_shapes_ordered]
        if not self.keeptrials:
            n_out = n_out[:1]
        bounds = np.concatenate([[0], np.cumsum(n_out)])
        old_trl = sel.trialdefinition
        trl = np.zeros((len(n_out), old_trl.shape[1]))
        trl[:, 0] = bounds[:-1]
        trl[:, 1] = bounds[1:]
        trl[:, 2] = old_trl[: len(n_out), 2] * factor
        if old_trl.shape[1] > 3:
            trl[:, 3:] = old_trl[: len(n_out), 3:]
        out.trialdefinition = trl
        self.propagate_properties(data, out)
        out.samplerate = self.cfg["new_samplerate"]


class Downsample(_ResamplingRoutine):
    """Integer-factor downsampling (reference compRoutines.py:446-538)."""

    valid_kws = ["resamplefs", "method"]

    def __init__(self, samplerate=1.0, new_samplerate=1.0):
        super().__init__(samplerate=samplerate, new_samplerate=new_samplerate)

    def _skipped(self):
        return int(self.cfg["samplerate"] // self.cfg["new_samplerate"])

    def output_trial_shape(self, trial_shape):
        T, C = trial_shape
        return (-(-T // self._skipped()), C), self.in_dtype

    def process_batch(self, batch, **cfg):
        return downsample(batch, self._skipped())


class Resample(_ResamplingRoutine):
    """Polyphase rational resampling with windowed-sinc anti-aliasing
    (reference compRoutines.py:541-655, kernel resampling.py:15-87)."""

    valid_kws = ["resamplefs", "method", "lpfreq", "order"]

    def __init__(self, samplerate=1.0, new_samplerate=1.0, lpfreq=None, order=None):
        from .resampledata import _get_updn

        up, down = _get_updn(samplerate, new_samplerate)
        super().__init__(
            samplerate=samplerate, new_samplerate=new_samplerate,
            up=up, down=down, lpfreq=lpfreq, order=order,
        )

    def _kernel(self, T):
        cfg = self.cfg
        return _resample_kernel(cfg["up"], cfg["down"], T, cfg["lpfreq"], cfg["order"],
                                cfg["samplerate"])

    def output_trial_shape(self, trial_shape):
        T, C = trial_shape
        return (int(np.ceil(T * self.cfg["up"] / self.cfg["down"])), C), _F32

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """The zero-stuffed signal, its rfft planes and their product with
        the kernel's spectrum, and the irfft at the FFT length."""
        T, C = shp
        n_up = T * self.cfg["up"]
        L = fir_fft_length(n_up, len(self._kernel(T)))
        return n_up * C * 4 + 2 * (L // 2 + 1) * C * 8 + L * C * 4

    def process_batch(self, batch, **cfg):
        kernel = self._kernel(batch.shape[1])
        return resample_poly(batch, cfg["up"], cfg["down"], kernel)


class Detrending(_PreprocRoutine):
    """De-meaning / linear detrending (reference compRoutines.py:657-762)."""

    valid_kws = ["polyremoval"]

    def __init__(self, polyremoval=0):
        super().__init__(polyremoval=polyremoval)

    def process_batch(self, batch, **cfg):
        y = detrend(batch.to(torch.float32), cfg["polyremoval"], dim=1)
        return y, self._nan_info(batch)


class Standardize(_PreprocRoutine):
    """Per-channel z-scoring after optional detrending
    (reference compRoutines.py:764-856)."""

    valid_kws = ["polyremoval", "zscore"]

    def __init__(self, polyremoval=None):
        super().__init__(polyremoval=polyremoval)

    def process_batch(self, batch, **cfg):
        x = detrend(batch.to(torch.float32), cfg["polyremoval"], dim=1)
        mean = x.mean(dim=1, keepdim=True)
        std = x.std(dim=1, keepdim=True, correction=0)
        return (x - mean) / std, self._nan_info(batch)
