# -*- coding: utf-8 -*-
#
# Spectral-estimation compute routines: the glue binding the ops to the
# engine.
#
# Port of syncopy_tpu/specest/compRoutines.py. Each routine states its
# output shape (`output_trial_shape`, which the JAX engine traces) and
# computes a whole chunk at once in `process_batch` (one batched FFT a
# chunk, where the JAX engine vmaps a per-trial function). The routines
# with an FFT bank declare its device workspace
# (`device_bytes_per_trial`), so the engine sizes their chunks by it.
# Not ported: the GEMM banks' `device_constants` and `extra_cache_key`
# (the JAX compile cache).

import numpy as np
import torch

from ..engine.routine import ComputationalRoutine
from ..ops.spectral import detrend, mtmfft, mtmfft_exact, spectral_convert
from ..ops.stft import mtmconvol
from ..ops.wavelet import cwt, superlet, superlet_weights
from ..ops.windows import make_tapers, nextpow2

__all__ = ["MultiTaperFFT", "MultiTaperFFTConvol", "WaveletTransform", "SuperletTransform"]


def _out_dtype(output):
    return np.dtype(np.complex64 if output in ("fourier", "complex") else np.float32)


class MultiTaperFFT(ComputationalRoutine):
    """
    (Multi-)tapered Fourier transform of AnalogData trials
    (reference compRoutines.py:59-236, kernel mtmfft.py:16-129).

    Output per trial: ``(1, nTaper|1, nFreq, nChannel)``; tapers are
    averaged unless ``keeptapers=True``. With `exact_fft` the spectra take
    the float64 route of :func:`~syncopy_tpu_torch.ops.spectral.mtmfft_exact`.
    """

    valid_kws = [
        "taper",
        "taper_opt",
        "tapsmofrq",
        "nTaper",
        "keeptapers",
        "demean_taper",
        "pad",
        "foi",
        "foilim",
        "output",
        "polyremoval",
        "ft_compat",
        "exact_fft",
    ]

    def __init__(self, samplerate=1.0, nfft=None, taper="hann", taper_opt=None,
                 demean_taper=False, output="pow", keeptapers=False,
                 polyremoval=0, freq_idx=None, ft_compat=False, exact_fft=False):
        super().__init__(
            samplerate=samplerate, nfft=nfft, taper=taper, taper_opt=taper_opt,
            demean_taper=demean_taper, output=output, keeptapers=keeptapers,
            polyremoval=polyremoval,
            freq_idx=None if freq_idx is None else np.asarray(freq_idx, dtype=int),
            ft_compat=ft_compat, exact_fft=bool(exact_fft),
        )

    def _tapers(self, n_samples, cfg):
        nfft = cfg["nfft"] or n_samples
        return make_tapers(cfg["taper"], cfg["taper_opt"], n_samples, nfft, cfg["samplerate"],
                           cfg["ft_compat"])

    def output_trial_shape(self, trial_shape):
        T, C = trial_shape
        nfft = self.cfg["nfft"] or T
        freq_idx = self.cfg["freq_idx"]
        n_freq = nfft // 2 + 1 if freq_idx is None else len(freq_idx)
        n_taper = self._tapers(T, self.cfg).shape[0] if self.cfg["keeptapers"] else 1
        return (1, n_taper, n_freq, C), _out_dtype(self.cfg["output"])

    def process_batch(self, batch, **cfg):
        """``(B, 1, nTaper|1, nFreq, nChannel)``: one rfft for the chunk."""
        nfft = cfg["nfft"] or batch.shape[1]
        tapers = torch.from_numpy(self._tapers(batch.shape[1], cfg)).to(batch.device)
        if cfg["exact_fft"]:
            ftr = mtmfft_exact(batch, tapers, nfft, cfg["polyremoval"], cfg["demean_taper"])
        else:
            x = detrend(batch.to(torch.float32), cfg["polyremoval"], dim=1)
            ftr = mtmfft(x, tapers, nfft, demean_taper=cfg["demean_taper"])
        if cfg["freq_idx"] is not None:
            ftr = ftr.index_select(2, torch.as_tensor(cfg["freq_idx"], device=ftr.device))
        spec = spectral_convert(ftr, cfg["output"])
        if not cfg["keeptapers"]:
            spec = spec.mean(dim=1, keepdim=True)
        return spec[:, None]

    def process_metadata(self, data, out):
        out.trialdefinition = self._spectral_trialdefinition(data)
        self.propagate_properties(data, out)
        freqs = np.fft.rfftfreq(self.cfg["nfft"], 1.0 / self.cfg["samplerate"])
        if self.cfg["freq_idx"] is not None:
            freqs = freqs[self.cfg["freq_idx"]]
        out.freq = freqs
        n_taper = out.data.shape[out.dimord.index("taper")]
        out.taper = [self.cfg["taper"] or "boxcar"] * n_taper

    def _spectral_trialdefinition(self, data):
        """One spectral sample per trial; offsets carried from the input
        (reference compRoutines.py:215-235)."""
        trl_sel = self.selector.trialdefinition
        n_out = trl_sel.shape[0] if self.keeptrials else 1
        trl = np.zeros((n_out, trl_sel.shape[1]))
        trl[:, 0] = np.arange(n_out)
        trl[:, 1] = np.arange(n_out) + 1
        trl[:, 2] = trl_sel[:n_out, 2]
        if trl_sel.shape[1] > 3:
            trl[:, 3:] = trl_sel[:n_out, 3:]
        return trl


class _TimeFreqRoutine(ComputationalRoutine):
    """
    Shared scaffolding for time-resolved spectral CRs: window-center
    geometry from `toi` and the time-frequency trialdefinition
    (reference compRoutines.py:813-905, `_make_trialdef`).

    `toi` semantics (reference freqanalysis.py:674-790): `'all'` centers a
    window on every sample, a float in [0, 1] sets the window overlap, an
    array gives explicit window-center times in seconds.
    """

    def per_trial_inputs(self, data, trial_positions):
        toi = self.cfg["toi"]
        if not isinstance(toi, np.ndarray):
            return ()
        trl = self.selector.trialdefinition
        t_start = trl[np.asarray(trial_positions), 2] / data.samplerate
        centers = np.round((toi[None, :] - t_start[:, None]) * data.samplerate)
        return (centers.astype(np.int32),)

    def _n_time(self, n_samples):
        """Output time points of a trial of `n_samples` samples."""
        toi = self.cfg["toi"]
        if isinstance(toi, np.ndarray):
            return toi.size
        return -(-n_samples // self._hop())

    def _hop(self):
        """Window hop of an overlap-fraction `toi`, else 1."""
        nperseg = self.cfg.get("nperseg")
        toi = self.cfg["toi"]
        if nperseg is None or not isinstance(toi, float):
            return 1
        noverlap = min(nperseg - 1, int(toi * nperseg))
        return nperseg - noverlap

    def _tf_trialdefinition(self, data, n_times):
        """Output trialdefinition + samplerate for time-resolved spectra."""
        sel_trl = self.selector.trialdefinition
        toi = self.cfg["toi"]
        samplerate = data.samplerate
        n_trials = len(n_times)
        trl = np.zeros((n_trials, sel_trl.shape[1]))
        bounds = np.cumsum([0] + list(n_times))
        trl[:, 0] = bounds[:-1]
        trl[:, 1] = bounds[1:]
        if sel_trl.shape[1] > 3:
            trl[:, 3:] = sel_trl[:n_trials, 3:]

        # per-trial onsets in output sampling units; for a trial average the
        # onsets of the (equal-length) input trials are averaged
        if isinstance(toi, np.ndarray):
            steps = np.diff(toi)
            if steps.size and np.allclose(steps, steps[0]):
                new_rate = 1.0 / steps[0]
            else:
                # unevenly spaced toi: a nominal 1 Hz bookkeeping rate; the
                # requested points become the output's irregular time axis
                # in process_metadata
                new_rate = 1.0
            offsets = np.full(sel_trl.shape[0], toi[0] * new_rate)
        elif isinstance(toi, str):  # 'all'
            new_rate = samplerate
            offsets = sel_trl[:, 2].astype(float)
        else:  # percentage
            hop = self._hop()
            new_rate = samplerate / hop
            offsets = sel_trl[:, 2] / hop

        if self.cfg.get("time_average"):
            offsets = np.zeros_like(offsets)  # matches spy.mean(dim='time')
        if self.keeptrials:
            trl[:, 2] = offsets[:n_trials]
        else:
            trl[:, 2] = offsets.mean()
        return trl, new_rate

    def process_metadata(self, data, out):
        n_times = [oshp[0] for oshp in self._per_trial_out_shapes_ordered]
        if not self.keeptrials:
            n_times = n_times[:1]
        trl, new_rate = self._tf_trialdefinition(data, n_times)
        out.trialdefinition = trl
        self.propagate_properties(data, out)
        # after propagate_properties: the time-frequency output has its own
        # sampling rate (window hop / toi spacing), not the input's
        out.samplerate = new_rate
        out.freq = self.cfg["foi"]
        self._set_taper_labels(out)
        toi = self.cfg["toi"]
        if isinstance(toi, np.ndarray) and not self.cfg.get("time_average"):
            steps = np.diff(toi)
            if steps.size and not np.allclose(steps, steps[0]):
                # uneven toi: out.time returns the request verbatim
                out.irregular_time = toi

    def _set_taper_labels(self, out):
        n_taper = out.data.shape[out.dimord.index("taper")]
        taper = self.cfg.get("taper")
        if taper is None:
            out.taper = ["None"] * n_taper
        elif taper == "dpss":
            out.taper = ["dpss" + str(i) for i in range(n_taper)]
        else:
            out.taper = [taper] * n_taper


class MultiTaperFFTConvol(_TimeFreqRoutine):
    """
    Sliding-window (multi-)tapered STFT (reference compRoutines.py:244-478,
    kernels mtmconvol.py:17-152 / stft.py:16-200).

    Output per trial: ``(nTime, nTaper|1, nFreq, nChannel)``; with
    `time_average` (welch) the mean over windows, ``(1, ...)``, formed on
    the device.

    As in the JAX package: explicit-`toi` windows are exactly `nperseg`
    samples, and window framing always zero-extends at trial edges.
    """

    valid_kws = [
        "taper",
        "taper_opt",
        "tapsmofrq",
        "nTaper",
        "keeptapers",
        "pad",
        "foi",
        "foilim",
        "toi",
        "t_ftimwin",
        "output",
        "polyremoval",
        "time_average",
    ]

    def __init__(self, samplerate=1.0, nperseg=256, toi="all", taper="hann",
                 taper_opt=None, output="pow", keeptapers=False, polyremoval=0,
                 freq_idx=None, foi=None, time_average=False):
        super().__init__(
            samplerate=samplerate, nperseg=int(nperseg), toi=toi, taper=taper,
            taper_opt=taper_opt, output=output, keeptapers=keeptapers,
            polyremoval=polyremoval,
            freq_idx=None if freq_idx is None else np.asarray(freq_idx, dtype=int),
            foi=foi, time_average=bool(time_average),
        )

    def _tapers(self):
        cfg = self.cfg
        taper_opt = dict(cfg["taper_opt"] or {})
        if cfg["taper"] == "dpss":
            # odd slepians must not sum to zero (reference mtmconvol.py:105-111)
            taper_opt["sym"] = False
        return make_tapers(cfg["taper"], taper_opt, cfg["nperseg"], cfg["nperseg"],
                           cfg["samplerate"])

    def output_trial_shape(self, trial_shape):
        T, C = trial_shape
        n_time = 1 if self.cfg["time_average"] else self._n_time(T)
        n_taper = self._tapers().shape[0] if self.cfg["keeptapers"] else 1
        freq_idx = self.cfg["freq_idx"]
        n_freq = self.cfg["nperseg"] // 2 + 1 if freq_idx is None else len(freq_idx)
        return (n_time, n_taper, n_freq, C), _out_dtype(self.cfg["output"])

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """STFT workspace: the (nTime, nTaper, nperseg, nChannels) tapered
        frames and their rfft (reference compRoutines.py:275-290)."""
        T, C = shp
        return self._n_time(T) * self._tapers().shape[0] * self.cfg["nperseg"] * C * 4 * 4

    def process_batch(self, batch, *aux, **cfg):
        tapers = torch.from_numpy(self._tapers()).to(batch.device)
        centers = aux[0] if aux else None
        spec = mtmconvol(
            batch, tapers, cfg["nperseg"], centers=centers, hop=self._hop(),
            n_time=self._n_time(batch.shape[1]), polyremoval=cfg["polyremoval"],
            output=cfg["output"], keeptapers=cfg["keeptapers"], freq_idx=cfg["freq_idx"],
        )
        if cfg["time_average"]:
            # Welch: the mean over windows on the device; the spectrogram
            # never leaves it (reference welch = mtmconvol +
            # spy.mean(dim='time'), freqanalysis.py:1054-1056)
            spec = spec.mean(dim=1, keepdim=True)
        return spec


def _take_time(spec, idx):
    """``jnp.take(spec, idx, axis=1)`` per trial, as the JAX package
    gathers explicit toi: (B, T, ...) and (B, nToi) indices; negative
    indices count from the end, indices past the trial give NaN."""
    T = spec.shape[1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + T, idx)
    valid = (idx >= 0) & (idx < T)
    rows = torch.arange(spec.shape[0], device=spec.device)[:, None]
    taken = spec[rows, idx.clamp(0, T - 1)]
    nan = torch.full((), float("nan"), dtype=spec.dtype, device=spec.device)
    return torch.where(valid.reshape(valid.shape + (1,) * (spec.ndim - 2)), taken, nan)


class WaveletTransform(_TimeFreqRoutine):
    """
    Continuous wavelet transform (reference compRoutines.py:482-650,
    kernel wavelet.py:15-49 + wavelets/transform.py:88-108).

    Output per trial: ``(nTime, 1, nScales, nChannel)``. With
    ``output="pow"`` each length bucket's transform becomes power on the
    device, so no complex buffer of the whole bank is kept or read back.

    As in the JAX package: explicit-`toi` spectra are computed on the full
    trial and gathered at the requested centers.
    """

    valid_kws = ["wavelet", "width", "order", "foi", "foilim", "toi", "output", "polyremoval"]

    def __init__(self, samplerate=1.0, scales=None, wavelet=None, toi="all",
                 output="pow", polyremoval=0, foi=None):
        super().__init__(
            samplerate=samplerate, scales=np.asarray(scales), wavelet=wavelet,
            toi=toi, output=output, polyremoval=polyremoval, foi=foi, taper=None,
        )

    def output_trial_shape(self, trial_shape):
        T, C = trial_shape
        return (self._n_time(T), 1, len(self.cfg["scales"]), C), _out_dtype(self.cfg["output"])

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """CWT workspace: (nScales, fft_len, nChannels) complex buffers
        (the broadcast product, its inverse transform, the crop and its
        conversion; reference compRoutines.py:344-357)."""
        T, C = shp
        scales = np.asarray(self.cfg["scales"])
        max_support = int(np.ceil(10 * scales.max() / (1.0 / self.cfg["samplerate"]))) + 1
        return len(scales) * nextpow2(T + max_support) * C * 8 * 4

    def process_batch(self, batch, *aux, **cfg):
        x = detrend(batch.to(torch.float32), cfg["polyremoval"], dim=1)
        pow_only = cfg["output"] == "pow"
        spec = cwt(x, cfg["wavelet"], cfg["scales"], 1.0 / cfg["samplerate"],
                   power_only=pow_only)
        spec = spec.transpose(1, 2)  # (B, T, S, C)
        if aux:
            spec = _take_time(spec, aux[0])
        spec = spec[:, :, None]
        return spec if pow_only else spectral_convert(spec, cfg["output"])


class SuperletTransform(_TimeFreqRoutine):
    """
    Superlet transform (reference compRoutines.py:654-810, kernel
    superlet.py:15-401).

    Output per trial: ``(nTime, 1, nScales, nChannel)``. ``pow`` and
    ``abs`` take the magnitude-only route of
    :func:`~syncopy_tpu_torch.ops.wavelet.superlet`.
    """

    valid_kws = ["order_max", "order_min", "c_1", "adaptive", "foi", "foilim", "toi", "output",
                 "polyremoval"]

    def __init__(self, samplerate=1.0, scales=None, order_max=2, order_min=1,
                 c_1=3, adaptive=False, toi="all", output="pow", polyremoval=0, foi=None):
        super().__init__(
            samplerate=samplerate, scales=np.asarray(scales), order_max=int(order_max),
            order_min=int(order_min), c_1=int(c_1), adaptive=bool(adaptive),
            toi=toi, output=output, polyremoval=polyremoval, foi=foi, taper=None,
        )

    def output_trial_shape(self, trial_shape):
        T, C = trial_shape
        return (self._n_time(T), 1, len(self.cfg["scales"]), C), _out_dtype(self.cfg["output"])

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """Superlet workspace: one scale's (nOrders, L, nChannels) complex
        block and its temporaries, the data spectrum and the (nScales, T,
        C) result (reference compRoutines.py:406-427); the op loops over
        blocks of scales, so one block is live at a time."""
        T, C = shp
        cfg = self.cfg
        scales = np.asarray(cfg["scales"])
        w, _ = superlet_weights(scales, cfg["order_max"], cfg["order_min"], cfg["adaptive"])
        max_support = int(np.ceil(10 * scales.max() * cfg["c_1"] * cfg["order_max"]
                                  / (1.0 / cfg["samplerate"]))) + 1
        L = nextpow2(T + max_support)
        return (w.shape[0] * L * C * 3 + L * C + len(scales) * T * C) * 8

    def process_batch(self, batch, *aux, **cfg):
        x = detrend(batch.to(torch.float32), cfg["polyremoval"], dim=1)
        mag_only = cfg["output"] in ("pow", "abs")
        spec = superlet(x, cfg["scales"], cfg["order_max"], cfg["order_min"], cfg["c_1"],
                        cfg["adaptive"], dt=1.0 / cfg["samplerate"], magnitude_only=mag_only)
        spec = spec.transpose(1, 2)  # (B, T, S, C)
        if aux:
            spec = _take_time(spec, aux[0])
        spec = spec[:, :, None]
        if mag_only:
            return spec * spec if cfg["output"] == "pow" else spec
        return spectral_convert(spec, cfg["output"])
