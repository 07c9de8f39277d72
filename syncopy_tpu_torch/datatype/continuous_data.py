# -*- coding: utf-8 -*-
#
# Uniformly-sampled data classes: ContinuousData ABC, AnalogData,
# SpectralData, CrossSpectralData, TimeLockData.
#
# Parity target: reference syncopy/datatype/continuous_data.py:38-916.

import numpy as np

from ..shared.errors import SPYValueError
from .base_data import BaseData
from .util import TimeIndexer

__all__ = ["ContinuousData", "AnalogData", "SpectralData", "CrossSpectralData", "TimeLockData"]


class ContinuousData(BaseData):
    """
    ABC for uniformly sampled multichannel data
    (reference continuous_data.py:38).
    """

    _stackingDimLabel = "time"

    def __init__(self, data=None, filename=None, channel=None, samplerate=None,
                 trialdefinition=None, dimord=None):
        self._channel = None
        self._samplerate = None
        super().__init__(filename=filename, dimord=dimord)
        if samplerate is not None:
            self.samplerate = samplerate
        if isinstance(data, str) and filename is None:
            self.data = data
        elif data is not None:
            self.data = data
        if trialdefinition is not None:
            self.trialdefinition = trialdefinition
        elif self.data is not None and self._trialdefinition is None:
            # default: one all-encompassing trial (reference continuous_data.py:378-381)
            nsamp = self.data.shape[self._stackingDim]
            self.trialdefinition = np.array([[0, nsamp, 0]])
        if channel is not None:
            self.channel = channel

    # ------------------------------------------------------------------ #

    @property
    def channel(self):
        """array(str): channel labels"""
        if self._channel is None and self.data is not None:
            nchan = self.data.shape[self.dimord.index("channel")]
            return np.array(["channel" + str(i + 1).zfill(len(str(nchan))) for i in range(nchan)])
        return self._channel

    @channel.setter
    def channel(self, chan):
        if chan is None:
            self._channel = None
            return
        if self.data is None:
            raise SPYValueError(legal="non-empty data", varname="channel", actual="empty object")
        nchan = self.data.shape[self.dimord.index("channel")]
        chan = np.array([str(c) for c in chan])
        if chan.size != nchan:
            raise SPYValueError(
                legal="{} channel labels".format(nchan), varname="channel", actual=str(chan.size)
            )
        self._channel = chan

    @property
    def samplerate(self):
        """float: sampling rate in Hz"""
        return self._samplerate

    @samplerate.setter
    def samplerate(self, sr):
        if sr is None:
            self._samplerate = None
            return
        from ..shared.parsers import scalar_parser

        scalar_parser(sr, varname="samplerate", lims=[np.finfo(float).eps, np.inf])
        self._samplerate = float(sr)

    @property
    def irregular_time(self):
        """Explicit time points (seconds, trigger-relative) for outputs
        whose time axis is NOT uniformly sampled — e.g. ``mtmconvol`` /
        ``wavelet`` spectra at unevenly spaced ``toi`` (the reference
        falls back to a misrepresenting 1 Hz axis there, reference
        specest/compRoutines.py:864-874; this rebuild keeps the exact
        request). ``None`` for regular axes. Stored as an attached
        dataset, so it survives ``spy.save``/``spy.load`` and participates
        in ``__eq__``. Such outputs are time-locked by construction: one
        array serves every trial."""
        val = self._extra_datasets.get("irregular_time")
        return None if val is None else np.asarray(val)

    @irregular_time.setter
    def irregular_time(self, arr):
        if arr is None:
            self._register_dataset("irregular_time", None)
            return
        arr = np.asarray(arr, dtype=float).ravel()
        if self.sampleinfo is not None:
            lens = np.unique(self.sampleinfo[:, 1] - self.sampleinfo[:, 0])
            if lens.size != 1 or int(lens[0]) != arr.size:
                raise SPYValueError(
                    legal="one time point per sample of equal-length trials "
                    "({} samples)".format(lens.tolist()),
                    varname="irregular_time", actual="{} points".format(arr.size),
                )
        self._register_dataset("irregular_time", arr)

    @property
    def time(self):
        """Per-trial time axes in seconds"""
        if self.sampleinfo is None:
            return None
        irr = self.irregular_time
        if irr is None and self.samplerate is None:
            return None
        return TimeIndexer(
            self.trialdefinition, self.samplerate,
            list(range(self.sampleinfo.shape[0])), points=irr,
        )

    @property
    def is_time_locked(self):
        """True if all trials have equal length and offset (reference :80)."""
        trl = self.trialdefinition
        if trl is None:
            return False
        lens = trl[:, 1] - trl[:, 0]
        return bool(np.all(lens == lens[0]) and np.all(trl[:, 2] == trl[0, 2]))

    # ------------------------------------------------------------------ #

    def _get_trial(self, trialno):
        start, stop = self.sampleinfo[trialno]
        idx = [slice(None)] * len(self.dimord)
        idx[self._stackingDim] = slice(int(start), int(stop))
        return self.data[tuple(idx)]

    def _trial_shape(self, trialno):
        start, stop = self.sampleinfo[trialno]
        shp = list(self.data.shape)
        shp[self._stackingDim] = int(stop - start)
        return tuple(shp)


class AnalogData(ContinuousData):
    """
    Multi-channel raw time series, dimord ``["time", "channel"]``.

    Parameters
    ----------
    data : 2d array, h5py dataset, or None
        Samples x channels payload (trials stacked along time).
    filename : str or None
        Backing HDF5 file (None = session temp storage).
    trialdefinition : [nTrials x 3+] array or None
        ``[start, stop, offset(, trialinfo...)]`` rows in samples.
    samplerate : float
        Sampling rate in Hz.
    channel : list of str or None
        Channel labels.
    dimord : list of str
        Dimension order (default ``["time", "channel"]``).

    Reference: continuous_data.py:391-405.
    """

    _defaultDimord = ["time", "channel"]

    def __init__(self, data=None, filename=None, trialdefinition=None,
                 samplerate=None, channel=None, dimord=None):
        super().__init__(
            data=data, filename=filename, channel=channel, samplerate=samplerate,
            trialdefinition=trialdefinition, dimord=dimord,
        )

    def save_nwb(self, outpath, nwbfile=None, with_trialdefinition=True, is_raw=True):
        """Write this object as an NWB 2.x file at `outpath`.

        ``is_raw=False`` places the series in an LFP processing module
        (derived data). `nwbfile` exists for reference signature parity
        only: the dependency-free writer always produces a fresh file and
        raises on a non-None value (pass each object its own `outpath`
        instead of appending to a pynwb ``NWBFile``)."""
        from ..io.nwb import _analog_to_nwb

        return _analog_to_nwb(self, outpath, nwbfile=nwbfile,
                              with_trialdefinition=with_trialdefinition, is_raw=is_raw)


class SpectralData(ContinuousData):
    """
    (Time-)frequency data, dimord ``["time", "taper", "freq", "channel"]``.

    Parameters
    ----------
    data : 4d array, h5py dataset, or None
        Payload (trials stacked along the time axis).
    filename, trialdefinition, samplerate, channel, dimord
        As in :class:`~syncopy_tpu.AnalogData`.
    taper : list of str or None
        Taper labels.
    freq : 1d array or None
        Frequency axis in Hz.

    Reference: continuous_data.py:533-551.
    """

    _defaultDimord = ["time", "taper", "freq", "channel"]

    def __init__(self, data=None, filename=None, trialdefinition=None, samplerate=None,
                 channel=None, taper=None, freq=None, dimord=None):
        self._freq = None
        self._taper = None
        super().__init__(
            data=data, filename=filename, channel=channel, samplerate=samplerate,
            trialdefinition=trialdefinition, dimord=dimord,
        )
        if freq is not None:
            self.freq = freq
        if taper is not None:
            self.taper = taper

    @property
    def freq(self):
        """array(float): frequency axis in Hz"""
        if self._freq is None and self.data is not None:
            return np.arange(self.data.shape[self.dimord.index("freq")])
        return self._freq

    @freq.setter
    def freq(self, freq):
        if freq is None:
            self._freq = None
            return
        if self.data is None:
            raise SPYValueError(legal="non-empty data", varname="freq", actual="empty object")
        freq = np.asarray(freq, dtype=float)
        nfreq = self.data.shape[self.dimord.index("freq")]
        if freq.size != nfreq:
            raise SPYValueError(legal="{} frequencies".format(nfreq), varname="freq", actual=str(freq.size))
        self._freq = freq

    @property
    def taper(self):
        """array(str): taper labels"""
        if self._taper is None and self.data is not None:
            ntaper = self.data.shape[self.dimord.index("taper")]
            return np.array(["taper" + str(i + 1) for i in range(ntaper)])
        return self._taper

    @taper.setter
    def taper(self, tap):
        if tap is None:
            self._taper = None
            return
        if self.data is None:
            raise SPYValueError(legal="non-empty data", varname="taper", actual="empty object")
        tap = np.array([str(t) for t in tap])
        ntaper = self.data.shape[self.dimord.index("taper")]
        if tap.size != ntaper:
            raise SPYValueError(legal="{} taper labels".format(ntaper), varname="taper", actual=str(tap.size))
        self._taper = tap


class CrossSpectralData(ContinuousData):
    """
    Channel-pair spectral data, dimord
    ``["time", "freq", "channel_i", "channel_j"]``.

    Parameters
    ----------
    data : 4d array, h5py dataset, or None
        Pairwise connectivity payload.
    filename, trialdefinition, samplerate, dimord
        As in :class:`~syncopy_tpu.AnalogData`.
    channel_i, channel_j : list of str or None
        Row/column channel labels of the pair matrix.
    freq : 1d array or None
        Frequency axis in Hz.

    Reference: continuous_data.py:700-723.
    """

    _defaultDimord = ["time", "freq", "channel_i", "channel_j"]

    def __init__(self, data=None, filename=None, trialdefinition=None, samplerate=None,
                 channel_i=None, channel_j=None, freq=None, dimord=None):
        self._freq = None
        self._channel_i = None
        self._channel_j = None
        super().__init__(
            data=data, filename=filename, channel=None, samplerate=samplerate,
            trialdefinition=trialdefinition, dimord=dimord,
        )
        if freq is not None:
            self.freq = freq
        if channel_i is not None:
            self.channel_i = channel_i
        if channel_j is not None:
            self.channel_j = channel_j

    # channel labels live on the pair axes
    @property
    def channel(self):
        raise AttributeError("CrossSpectralData has no attribute 'channel', use 'channel_i'/'channel_j'")

    @channel.setter
    def channel(self, chan):
        if chan is not None:
            raise AttributeError("CrossSpectralData has no attribute 'channel', use 'channel_i'/'channel_j'")

    def _pair_labels(self, which):
        n = self.data.shape[self.dimord.index(which)]
        return np.array(["channel" + str(i + 1).zfill(len(str(n))) for i in range(n)])

    @property
    def channel_i(self):
        if self._channel_i is None and self.data is not None:
            return self._pair_labels("channel_i")
        return self._channel_i

    @channel_i.setter
    def channel_i(self, chan):
        if chan is None:
            self._channel_i = None
            return
        chan = np.array([str(c) for c in chan])
        n = self.data.shape[self.dimord.index("channel_i")]
        if chan.size != n:
            raise SPYValueError(legal="{} labels".format(n), varname="channel_i", actual=str(chan.size))
        self._channel_i = chan

    @property
    def channel_j(self):
        if self._channel_j is None and self.data is not None:
            return self._pair_labels("channel_j")
        return self._channel_j

    @channel_j.setter
    def channel_j(self, chan):
        if chan is None:
            self._channel_j = None
            return
        chan = np.array([str(c) for c in chan])
        n = self.data.shape[self.dimord.index("channel_j")]
        if chan.size != n:
            raise SPYValueError(legal="{} labels".format(n), varname="channel_j", actual=str(chan.size))
        self._channel_j = chan

    @property
    def freq(self):
        if self._freq is None and self.data is not None:
            return np.arange(self.data.shape[self.dimord.index("freq")])
        return self._freq

    @freq.setter
    def freq(self, freq):
        if freq is None:
            self._freq = None
            return
        freq = np.asarray(freq, dtype=float)
        nfreq = self.data.shape[self.dimord.index("freq")]
        if freq.size != nfreq:
            raise SPYValueError(legal="{} frequencies".format(nfreq), varname="freq", actual=str(freq.size))
        self._freq = freq


class TimeLockData(ContinuousData):
    """
    Trial-averaged, time-locked data with extra datasets ``avg``, ``var``,
    ``cov``.

    Parameters
    ----------
    data : 2d array, h5py dataset, or None
        Time-locked single trials (equal length, equal offset).
    filename, trialdefinition, samplerate, channel, dimord
        As in :class:`~syncopy_tpu.AnalogData`.

    Reference: continuous_data.py:845-916.
    """

    _defaultDimord = ["time", "channel"]
    _hdfFileDatasetProperties = ("data", "avg", "var", "cov")

    def __init__(self, data=None, filename=None, trialdefinition=None, samplerate=None,
                 channel=None, dimord=None):
        super().__init__(
            data=data, filename=filename, channel=channel, samplerate=samplerate,
            trialdefinition=trialdefinition, dimord=dimord,
        )
        for name in ("avg", "var", "cov"):
            self._register_dataset(name)

    @property
    def avg(self):
        return self._get_extra_dataset("avg")

    @property
    def var(self):
        return self._get_extra_dataset("var")

    @property
    def cov(self):
        return self._get_extra_dataset("cov")

    def save_nwb(self, outpath, with_trialdefinition=True, is_raw=True):
        from ..io.nwb import _timelock_to_nwb

        return _timelock_to_nwb(self, outpath,
                                with_trialdefinition=with_trialdefinition,
                                is_raw=is_raw)
