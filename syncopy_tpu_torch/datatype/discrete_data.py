# -*- coding: utf-8 -*-
#
# Event-like data classes: DiscreteData ABC, SpikeData, EventData.
#
# Parity target: reference syncopy/datatype/discrete_data.py:31-829.
# Payload is a 2-D integer array [nEvents x nCols]; trials are defined by
# ranges of the `sample` column (rows with start <= sample < stop belong to
# the trial).

import numpy as np

from ..shared.errors import SPYTypeError, SPYValueError
from .base_data import BaseData

__all__ = ["DiscreteData", "SpikeData", "EventData"]


class DiscreteData(BaseData):
    """ABC for discrete (event-like) data (reference discrete_data.py:31)."""

    _stackingDimLabel = "sample"
    _customizableDimord = True

    def __init__(self, data=None, filename=None, trialdefinition=None,
                 samplerate=None, dimord=None):
        self._samplerate = None
        super().__init__(filename=filename, dimord=dimord)
        if samplerate is not None:
            self.samplerate = samplerate
        if data is not None:
            self.data = data
        if trialdefinition is not None:
            self.trialdefinition = trialdefinition
        elif self.data is not None and self._trialdefinition is None:
            smp = self.data[:, self.dimord.index("sample")]
            stop = (int(smp.max()) + 1) if smp.size else 0
            self.trialdefinition = np.array([[0, stop, 0]])

    def _unique_col(self, dim):
        """Sorted unique ids present in column `dim`, cached per payload
        mutation (the reference caches these too, discrete_data.py:374-392
        — an uncached np.unique would re-read the whole HDF5 payload on
        every property access)."""
        token = getattr(self, "_cache_token", None)
        cache = getattr(self, "_uniq_cache", None)
        if cache is None:
            cache = self._uniq_cache = {}
        key = (dim, token)
        if key not in cache:
            # evict only STALE-token entries — other columns cached for the
            # current payload must survive (alternating channel_idx/unit_idx
            # access would otherwise defeat the cache entirely)
            for k in [k for k in cache if k[1] != token]:
                del cache[k]
            cache[key] = np.unique(np.asarray(self.data[:, self.dimord.index(dim)]))
        return cache[key]

    @property
    def samplerate(self):
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
    def sample(self):
        """All sample indices"""
        if self.data is None:
            return None
        return np.asarray(self.data[:, self.dimord.index("sample")])

    def _set_dataset_property_with_ndarray(self, inData, propertyName, ndim=None):
        if propertyName == "data":
            inData = np.asarray(inData)
            if inData.ndim != 2:
                # reference rejects flat arrays outright
                # (test_discretedata.py:128-130)
                raise SPYValueError(legal="2-dimensional [nEvents x nCols] array",
                                    varname="data", actual="{}-dim".format(inData.ndim))
            if inData.shape[0] == 0:
                raise SPYValueError(legal="non empty data", varname="data",
                                    actual="0 events")
            if not np.issubdtype(inData.dtype, np.integer):
                # sample/channel/unit/eventid columns are indices; NaN or
                # float payloads are input errors (reference
                # discrete_data.py data parsing, test :71-77)
                if not (np.issubdtype(inData.dtype, np.floating)
                        and np.all(np.isfinite(inData))
                        and np.array_equal(inData, np.round(inData))):
                    raise SPYTypeError(inData, varname="data",
                                       expected="integer like array")
                inData = inData.astype(np.int64)
        super()._set_dataset_property_with_ndarray(inData, propertyName, ndim=2 if propertyName == "data" else ndim)

    def _set_dataset_property_with_list(self, inData, propertyName, ndim=None):
        # list of per-trial event arrays: rows are concatenated; trials from
        # per-trial sample ranges cannot be inferred -> stack and default trial
        arrs = [np.atleast_2d(np.asarray(a)) for a in inData]
        stacked = np.concatenate(arrs, axis=0)
        self._set_dataset_property_with_ndarray(stacked, propertyName)

    @property
    def trialid(self):
        """Per-event trial membership (or -1)"""
        if self.data is None or self.sampleinfo is None:
            return None
        smp = self.sample
        tid = np.full(smp.shape, -1, dtype=np.int64)
        for i, (start, stop) in enumerate(self.sampleinfo):
            mask = (smp >= start) & (smp < stop)
            tid[mask] = i
        return tid

    @property
    def trialtime(self):
        """Per-event time (s) relative to trial onset"""
        if self.samplerate is None or self.sampleinfo is None:
            return None
        smp = self.sample
        tid = self.trialid
        out = np.full(smp.shape, np.nan)
        for i, (start, stop) in enumerate(self.sampleinfo):
            mask = tid == i
            out[mask] = (smp[mask] - start + self._t0[i]) / self.samplerate
        return out

    def _get_trial(self, trialno):
        start, stop = self.sampleinfo[trialno]
        smp = self.sample
        mask = (smp >= start) & (smp < stop)
        return self.data[mask, :]

    @property
    def time(self):
        """Per-trial event times (list-style access via trialtime)"""
        if self.samplerate is None or self.sampleinfo is None:
            return None
        out = []
        smp = self.sample
        for i, (start, stop) in enumerate(self.sampleinfo):
            mask = (smp >= start) & (smp < stop)
            out.append((smp[mask] - start + self._t0[i]) / self.samplerate)
        return out


class SpikeData(DiscreteData):
    """
    Spike data ``[sample, channel, unit]`` with optional ``waveform``
    dataset.

    Parameters
    ----------
    data : [nSpikes x 3] int array, h5py dataset, or None
        One row per spike: sample index, channel index, unit index.
    filename, trialdefinition, samplerate, dimord
        As in :class:`~syncopy_tpu.AnalogData`.
    channel : list of str or None
        Channel labels indexed by the channel column.
    unit : list of str or None
        Unit labels indexed by the unit column.

    Reference: discrete_data.py:339-716.
    """

    _defaultDimord = ["sample", "channel", "unit"]
    _hdfFileDatasetProperties = ("data", "waveform")

    def __init__(self, data=None, filename=None, trialdefinition=None, samplerate=None,
                 channel=None, unit=None, waveform=None, dimord=None):
        self._channel = None
        self._unit = None
        super().__init__(data=data, filename=filename, trialdefinition=trialdefinition,
                         samplerate=samplerate, dimord=dimord)
        self._register_dataset("waveform")
        if channel is not None:
            self.channel = channel
        if unit is not None:
            self.unit = unit
        if waveform is not None:
            self.waveform = waveform

    # -- channel ------------------------------------------------------- #

    @property
    def channel_idx(self):
        """Sorted unique channel indices occurring in the data"""
        if self.data is None:
            return None
        return self._unique_col("channel")

    @property
    def channel(self):
        if self.data is None:
            return self._channel
        if self._channel is None:
            # default labels span 0..max present channel index
            nchan = int(self.channel_idx.max()) + 1 if self.channel_idx.size else 0
            return np.array(["channel" + str(i + 1).zfill(len(str(nchan))) for i in range(nchan)])
        return self._channel

    @channel.setter
    def channel(self, chan):
        if chan is None:
            self._channel = None
            return
        if self.data is None:
            raise SPYValueError(
                legal="data first — cannot assign `channel` without data",
                varname="channel",
            )
        chan = np.array([str(c) for c in chan])
        # labels are DENSE over 0..max id (deviation from the reference,
        # which labels only the unique ids present); a label list sized to
        # the unique ids is expanded onto the dense grid
        n_dense = int(self.channel_idx.max()) + 1 if self.channel_idx.size else 0
        uniq = self.channel_idx
        if chan.size == n_dense:
            self._channel = chan
        elif chan.size == uniq.size:
            # build as a python list: numpy fixed-width strings would
            # truncate labels longer than the default names
            dense = ["channel" + str(i + 1) for i in range(n_dense)]
            for pos, lab in zip(uniq.astype(int), chan):
                dense[pos] = str(lab)
            self._channel = np.array(dense)
        else:
            raise SPYValueError(
                legal="exactly {} (dense) or {} (per present id) channel "
                      "labels".format(n_dense, uniq.size),
                varname="channel", actual=str(chan.size),
            )

    # -- unit ---------------------------------------------------------- #

    @property
    def unit_idx(self):
        if self.data is None:
            return None
        return self._unique_col("unit")

    @property
    def unit(self):
        if self.data is None:
            return self._unit
        if self._unit is None:
            nunit = int(self.unit_idx.max()) + 1 if self.unit_idx.size else 0
            return np.array(["unit" + str(i + 1).zfill(len(str(nunit))) for i in range(nunit)])
        return self._unit

    @unit.setter
    def unit(self, unit):
        if unit is None:
            self._unit = None
            return
        if self.data is None:
            raise SPYValueError(
                legal="data first — cannot assign `unit` without data",
                varname="unit",
            )
        unit = np.array([str(u) for u in unit])
        n_dense = int(self.unit_idx.max()) + 1 if self.unit_idx.size else 0
        uniq = self.unit_idx
        if unit.size == n_dense:
            self._unit = unit
        elif unit.size == uniq.size:
            dense = ["unit" + str(i + 1) for i in range(n_dense)]
            for pos, lab in zip(uniq.astype(int), unit):
                dense[pos] = str(lab)
            self._unit = np.array(dense)
        else:
            raise SPYValueError(
                legal="exactly {} (dense) or {} (per present id) unit "
                      "labels".format(n_dense, uniq.size),
                varname="unit", actual=str(unit.size),
            )

    # -- waveform ------------------------------------------------------ #

    @property
    def waveform(self):
        return self._get_extra_dataset("waveform")

    @waveform.setter
    def waveform(self, wf):
        if wf is None:
            self._extra_datasets["waveform"] = None
            return
        wf = np.asarray(wf)
        if self.data is not None and wf.shape[0] != self.data.shape[0]:
            raise SPYValueError(
                legal="waveform with {} rows (one per spike)".format(self.data.shape[0]),
                varname="waveform", actual=str(wf.shape),
            )
        self._extra_datasets["waveform"] = wf

    def save_nwb(self, outpath, with_trialdefinition=True, unit_info=None):
        from ..io.nwb import _spike_to_nwb

        return _spike_to_nwb(self, outpath,
                             with_trialdefinition=with_trialdefinition,
                             unit_info=unit_info)


class EventData(DiscreteData):
    """
    Trigger events ``[sample, eventid]``; supports custom dimords with extra
    columns.

    Parameters
    ----------
    data : [nEvents x 2+] int array, h5py dataset, or None
        One row per event: sample index, event code(, extra columns per
        custom `dimord`).
    filename, trialdefinition, samplerate
        As in :class:`~syncopy_tpu.AnalogData`.
    dimord : list of str
        Customizable; first column must remain "sample".

    Reference: discrete_data.py:718-829.
    """

    _defaultDimord = ["sample", "eventid"]
    _customizableDimord = True

    def __init__(self, data=None, filename=None, trialdefinition=None, samplerate=None,
                 dimord=None):
        super().__init__(data=data, filename=filename, trialdefinition=trialdefinition,
                         samplerate=samplerate, dimord=dimord)

    def _set_dimord(self, dimord):
        # EventData admits extra columns, e.g. ["sample", "eventid", "duration"]
        if dimord is None:
            self._dimord = list(self._defaultDimord)
        else:
            dimord = list(dimord)
            if "sample" not in dimord:
                raise SPYValueError(legal="dimord containing 'sample'", varname="dimord", actual=str(dimord))
            self._dimord = dimord

    @property
    def eventid(self):
        """Unique event id codes"""
        if self.data is None:
            return None
        return self._unique_col("eventid")
