# -*- coding: utf-8 -*-
#
# Selector: translate a user selection dict into per-dimension indexers.
#
# Parity target: reference syncopy/datatype/selector.py:15-996. Supported
# keys: trials, channel, channel_i, channel_j, latency, frequency, taper,
# unit, eventid. Indexers collapse to slices when contiguous+ordered and
# fall back to fancy index lists otherwise (the engine applies them as host
# gather plans when staging trial batches for the device).

import numbers

import numpy as np

from ..shared.errors import SPYError, SPYTypeError, SPYValueError
from ..shared.tools import best_match

__all__ = ["Selector"]

_ALL_KEYS = (
    "trials",
    "channel",
    "channel_i",
    "channel_j",
    "latency",
    "frequency",
    "taper",
    "unit",
    "eventid",
)


def _as_slice_if_possible(idx_list, total_len):
    """Collapse a sorted, step-regular index list into a slice."""
    idx = np.asarray(idx_list)
    if idx.size == 0:
        return []
    if idx.size == 1:
        i = int(idx[0])
        return slice(i, i + 1, 1)
    steps = np.diff(idx)
    if np.all(steps == steps[0]) and steps[0] > 0:
        return slice(int(idx[0]), int(idx[-1]) + 1, int(steps[0]))
    return [int(i) for i in idx]


def _label_or_index_selection(values, labels, varname):
    """
    Resolve a channel/taper-style selection (labels, indices, slice, range,
    "all") against a label array -> list of integer indices (ordered as
    given, duplicates preserved like the reference's fancy indexing).
    """
    n = len(labels)
    if values is None or (isinstance(values, str) and values == "all"):
        return list(range(n))
    if isinstance(values, slice):
        return list(range(n))[values]
    if isinstance(values, range):
        values = list(values)
    if isinstance(values, (str, numbers.Number)):
        values = [values]
    if not isinstance(values, (list, tuple, np.ndarray)):
        raise SPYTypeError(values, varname=varname, expected="list/array of labels or indices")
    label_list = [str(l) for l in labels]
    out = []
    for v in values:
        if isinstance(v, str) or isinstance(v, np.str_):
            if str(v) not in label_list:
                raise SPYValueError(legal="existing label", varname=varname, actual=str(v))
            out.append(label_list.index(str(v)))
        elif np.issubdtype(type(v), np.number):
            if isinstance(v, (bool, np.bool_)):
                raise SPYTypeError(v, varname=varname, expected="label or integer index")
            iv = int(v)
            if iv != v:
                raise SPYValueError(legal="integer index", varname=varname, actual=str(v))
            if iv < -n or iv >= n:
                raise SPYValueError(
                    legal="existing names or indices (index in [-{}, {}))".format(n, n),
                    varname=varname, actual=str(iv),
                )
            out.append(iv % n)
        else:
            raise SPYTypeError(v, varname=varname, expected="label or integer index")
    return out


def _trial_tvec(data, tid, n_samp):
    """Time values (s) of trial `tid`'s first `n_samp` rows: the EXACT
    irregular points when present (uneven-toi outputs), else the uniform
    reconstruction from offset + samplerate."""
    irr = getattr(data, "irregular_time", None)
    if irr is not None:
        return np.asarray(irr, dtype=float)[:n_samp]
    return (np.arange(n_samp) + data._t0[tid]) / data.samplerate


def _require_latency_coverage(data, trial_ids, lat):
    """The latency window must be fully CONTAINED in at least one selected
    trial's time range — partial overlap everywhere is an error (reference
    test_selectdata.py:146-149 and the spike case :522-549)."""
    if not trial_ids or lat is None or (isinstance(lat, str) and lat == "all"):
        return
    lat_arr = np.atleast_1d(np.asarray(lat, dtype=float))
    for tid in trial_ids:
        n_samp = int(data.sampleinfo[tid, 1] - data.sampleinfo[tid, 0])
        if n_samp < 1:
            continue
        tvec = _trial_tvec(data, tid, n_samp)
        if tvec.min() <= lat_arr[0] and lat_arr[1] <= tvec.max():
            return
    raise SPYValueError(
        legal="at least one trial covering the latency window",
        varname="latency", actual=str(lat),
    )


def _whole_trials(trl_old, trial_ids):
    """The rows ``[0, length, offset, extra...]`` of the selected whole
    trials, before re-stacking: what the per-trial rows of
    :meth:`Selector._compute_trialdefinition` stack to with every time
    indexer ``slice(None)``, in one fancy index (their dtype taken from
    the first row built the per-trial way)."""
    sub = trl_old[np.asarray(trial_ids, dtype=np.intp)]
    lens = (sub[:, 1] - sub[:, 0]).astype(np.int64)
    first = np.concatenate([[0, int(lens[0]), sub[0, 2] + 0], sub[0, 3:]])
    trl = np.empty(sub.shape, dtype=first.dtype)
    trl[:, 0] = 0
    trl[:, 1] = lens
    trl[:, 2:] = sub[:, 2:]
    return trl


class Selector:
    """
    In-place selection descriptor attached to a data object.

    After construction, per-dimension indexers are available as properties
    (`channel`, `freq`, `taper`, ...; `time` and `unit`/`eventid` are
    per-trial lists). ``selector.trial_ids`` lists the selected trials.
    ``time_trivial`` says that every time indexer is ``slice(None)``
    (continuous data, no latency window): the engine then plans from
    arrays instead of per trial.
    """

    def __init__(self, data, select):
        if select is None:
            select = {}
        if isinstance(select, str):
            if select != "all":
                raise SPYValueError(legal="'all' or dict", varname="select", actual=select)
            select = {}
        if not isinstance(select, dict):
            raise SPYTypeError(select, varname="select", expected="dict, 'all' or None")
        for key in select:
            if key not in _ALL_KEYS:
                raise SPYValueError(
                    legal="keys in {}".format(_ALL_KEYS), varname="select", actual=key
                )
        self.select = dict(select)
        self._data_class = data.__class__.__name__
        self._dimord = data.dimord

        self._select_trials(data)
        self._select_channels(data)
        self._select_taper(data)
        self._select_frequency(data)
        self._select_latency(data)
        self._select_discrete(data)
        self._compute_trialdefinition(data)
        self._samplerate = getattr(data, "samplerate", None)
        self.create_get_trial(data)

    # ------------------------------------------------------------------ #

    def _select_trials(self, data):
        n_tot = data.sampleinfo.shape[0] if data.sampleinfo is not None else 0
        trials = self.select.get("trials")
        if trials is None or (isinstance(trials, str) and trials == "all"):
            self.trial_ids = list(range(n_tot))
            return
        if np.issubdtype(type(trials), np.number):
            trials = [trials]
        trials = list(np.asarray(trials).ravel())
        ids = []
        for t in trials:
            it = int(t)
            if it != t or it < 0 or it >= n_tot:
                # reference rejects negative/out-of-range indices outright
                # ("all array elements to be bound", test_selectdata.py:151)
                raise SPYValueError(
                    legal="all array elements to be bound: trial indices in "
                          "[0, {})".format(n_tot),
                    varname="trials", actual=str(t),
                )
            ids.append(it)
        self.trial_ids = ids

    def _select_channels(self, data):
        self.channel = None
        self.channel_i = None
        self.channel_j = None
        dimord = data.dimord
        if "channel" in dimord and hasattr(data, "channel"):
            labels = data.channel if data.channel is not None else []
            idx = _label_or_index_selection(self.select.get("channel"), labels, "channel")
            self.channel = _as_slice_if_possible(idx, len(labels))
        elif self.select.get("channel") is not None and "channel" not in dimord:
            raise SPYValueError(
                legal="no 'channel' selection for {}".format(self._data_class),
                varname="select",
            )
        for key in ("channel_i", "channel_j"):
            if key in dimord:
                labels = getattr(data, key)
                idx = _label_or_index_selection(self.select.get(key), labels, key)
                setattr(self, key, _as_slice_if_possible(idx, len(labels)))
            elif self.select.get(key) is not None:
                raise SPYValueError(
                    legal="no '{}' selection for {}".format(key, self._data_class),
                    varname="select",
                )

    def _select_taper(self, data):
        self.taper = None
        if "taper" in data.dimord:
            labels = data.taper
            idx = _label_or_index_selection(self.select.get("taper"), labels, "taper")
            self.taper = _as_slice_if_possible(idx, len(labels))
        elif self.select.get("taper") is not None:
            raise SPYValueError(
                legal="no 'taper' selection for {}".format(self._data_class), varname="select"
            )

    def _select_frequency(self, data):
        self.freq = None
        if "freq" in data.dimord:
            freqs = data.freq
            sel = self.select.get("frequency")
            if sel is None or (isinstance(sel, str) and sel == "all"):
                self.freq = slice(None)
                return
            sel = np.atleast_1d(np.asarray(sel, dtype=float))
            if sel.size == 2:
                _, idx = best_match(freqs, sel, span=True)
            else:
                _, idx = best_match(freqs, sel, squash_duplicates=True)
            self.freq = _as_slice_if_possible(idx, len(freqs))
        elif self.select.get("frequency") is not None:
            raise SPYValueError(
                legal="no 'frequency' selection for {}".format(self._data_class), varname="select"
            )

    def _select_latency(self, data):
        """Per-trial time-axis indexers from a [lo, hi] latency window."""
        self.time = None
        self.time_trivial = False
        self.latency = self.select.get("latency")
        if "time" not in data.dimord:
            if self.latency is not None and "sample" not in data.dimord:
                raise SPYValueError(
                    legal="no 'latency' selection for {}".format(self._data_class), varname="select"
                )
            return
        self.time = []
        lat = self.latency
        if isinstance(lat, str) and lat != "all":
            # 'maxperiod'/'minperiod'/'prestim'/'poststim' shorthands
            # (reference latency.py:17-96 via selectdata)
            from ..shared.latency import get_analysis_window

            lat = list(get_analysis_window(data, lat))
        if lat is None or (isinstance(lat, str) and lat == "all"):
            # no window: every trial whole, which the engine plans from
            # arrays instead of per trial
            self.time = [slice(None)] * len(self.trial_ids)
            self.time_trivial = True
            return
        for tid in self.trial_ids:
            n_samp = int(data.sampleinfo[tid, 1] - data.sampleinfo[tid, 0])
            lat_arr = np.atleast_1d(np.asarray(lat, dtype=float))
            if lat_arr.size != 2 or lat_arr[0] > lat_arr[1]:
                raise SPYValueError(
                    legal="'all' or [begin, end] in seconds", varname="latency", actual=str(lat)
                )
            tvec = _trial_tvec(data, tid, n_samp)
            idx = np.where((tvec >= lat_arr[0]) & (tvec <= lat_arr[1]))[0]
            self.time.append(_as_slice_if_possible(idx, n_samp))
        _require_latency_coverage(data, self.trial_ids, lat)

    def _select_discrete(self, data):
        """unit/eventid selections and per-trial row indexers for discrete data."""
        self.unit = None
        self.eventid = None
        dimord = data.dimord
        if "unit" in dimord:
            labels = data.unit
            if self.select.get("unit") is not None:
                idx = _label_or_index_selection(self.select.get("unit"), labels, "unit")
                self.unit = idx
        elif self.select.get("unit") is not None:
            raise SPYValueError(legal="no 'unit' selection for {}".format(self._data_class), varname="select")
        if "eventid" in dimord:
            if self.select.get("eventid") is not None:
                # reference semantics (test_selectdata.py:607-650): entries
                # INDEX the sorted unique event ids, they are not the raw
                # id values themselves
                ev = np.atleast_1d(np.asarray(self.select["eventid"]))
                if not np.issubdtype(ev.dtype, np.number):
                    raise SPYValueError(
                        legal="expected dtype = numeric event-id indices",
                        varname="eventid", actual=str(self.select["eventid"]),
                    )
                uniq = np.unique(np.asarray(data.data[:, dimord.index("eventid")]))
                idx = []
                for e in ev:
                    ie = int(e)
                    if ie != e or ie < 0 or ie >= uniq.size:
                        raise SPYValueError(
                            legal="existing names or indices of unique event ids "
                                  "[0, {})".format(uniq.size),
                            varname="eventid", actual=str(e),
                        )
                    idx.append(ie)
                self.eventid = [uniq[i] for i in idx]
        elif self.select.get("eventid") is not None:
            raise SPYValueError(legal="no 'eventid' selection for {}".format(self._data_class), varname="select")

        # discrete data: build per-trial row indexers
        if "sample" in dimord:
            self.time = []
            smp_col = dimord.index("sample")
            for tid in self.trial_ids:
                rows = data._get_trial(tid)
                mask = np.ones(rows.shape[0], dtype=bool)
                if self.unit is not None and "unit" in dimord:
                    ucol = rows[:, dimord.index("unit")]
                    mask &= np.isin(ucol, np.asarray(self.unit))
                if self.eventid is not None and "eventid" in dimord:
                    ecol = rows[:, dimord.index("eventid")]
                    mask &= np.isin(ecol, np.asarray(self.eventid))
                if self.channel is not None and "channel" in dimord and not (
                    isinstance(self.channel, slice) and self.channel == slice(None)
                ):
                    ccol = rows[:, dimord.index("channel")]
                    ch_idx = (
                        np.arange(*self.channel.indices(int(ccol.max()) + 1 if ccol.size else 0))
                        if isinstance(self.channel, slice)
                        else np.asarray(self.channel)
                    )
                    mask &= np.isin(ccol, ch_idx)
                if self.latency is not None and not (isinstance(self.latency, str) and self.latency == "all"):
                    lat_arr = np.atleast_1d(np.asarray(self.latency, dtype=float))
                    start = data.sampleinfo[tid, 0]
                    tvec = (rows[:, smp_col] - start + data._t0[tid]) / data.samplerate
                    mask &= (tvec >= lat_arr[0]) & (tvec <= lat_arr[1])
                idx = np.where(mask)[0]
                self.time.append(_as_slice_if_possible(idx, rows.shape[0]))
            _require_latency_coverage(data, self.trial_ids, self.latency)

    # ------------------------------------------------------------------ #

    def _compute_trialdefinition(self, data):
        """Selected trialdefinition (shifted for latency windows)."""
        trl_old = data.trialdefinition
        is_continuous = "time" in data.dimord
        if self.time_trivial and self.trial_ids:
            trl = _whole_trials(trl_old, self.trial_ids)
        else:
            rows = []
            for k, tid in enumerate(self.trial_ids):
                start, stop, offset = trl_old[tid, 0], trl_old[tid, 1], trl_old[tid, 2]
                extra = trl_old[tid, 3:]
                if is_continuous and self.time is not None:
                    tsel = self.time[k]
                    n_samp = int(stop - start)
                    if isinstance(tsel, slice):
                        t_start, t_stop, t_step = tsel.indices(n_samp)
                        n_new = max(0, (t_stop - t_start + (t_step - 1)) // t_step)
                        new_offset = offset + t_start
                    else:
                        n_new = len(tsel)
                        new_offset = offset + (tsel[0] if n_new else 0)
                    rows.append(np.concatenate([[0, n_new, new_offset], extra]))
                elif not is_continuous and self.time is not None:
                    # discrete: keep sample bounds, rows are filtered
                    rows.append(np.concatenate([[start, stop, offset], extra]))
                else:
                    rows.append(np.concatenate([[start, stop, offset], extra]))
            trl = np.vstack(rows) if rows else None
        if trl is None:
            self.trialdefinition = np.zeros((0, 3))
            return
        if is_continuous:
            # re-stack cumulative sample counts
            lens = trl[:, 1] - trl[:, 0]
            bounds = np.cumsum(np.concatenate([[0], lens]))
            trl[:, 0] = bounds[:-1]
            trl[:, 1] = bounds[1:]
        self.trialdefinition = trl

    # ------------------------------------------------------------------ #

    def trial_indexer(self, data, trialno_pos):
        """
        Full per-dimension indexer tuple for the `trialno_pos`-th *selected*
        trial: apply to the raw trial array ``data._get_trial(trial_ids[k])``.
        """
        dimord = data.dimord
        if "sample" in dimord:
            tsel = self.time[trialno_pos] if self.time is not None else slice(None)
            return (tsel, slice(None))
        idx = []
        for dim in dimord:
            if dim == "time":
                idx.append(self.time[trialno_pos] if self.time is not None else slice(None))
            elif dim == "channel":
                idx.append(self.channel if self.channel is not None else slice(None))
            elif dim == "channel_i":
                idx.append(self.channel_i if self.channel_i is not None else slice(None))
            elif dim == "channel_j":
                idx.append(self.channel_j if self.channel_j is not None else slice(None))
            elif dim == "freq":
                idx.append(self.freq if self.freq is not None else slice(None))
            elif dim == "taper":
                idx.append(self.taper if self.taper is not None else slice(None))
            else:
                idx.append(slice(None))
        return tuple(idx)

    def select_trial_array(self, data, trialno_pos):
        """Materialize the selected trial as a numpy array (host gather)."""
        raw = np.asarray(data._get_trial(self.trial_ids[trialno_pos]))
        idx = self.trial_indexer(data, trialno_pos)
        # apply one axis at a time to support multiple fancy-index dims
        out = raw
        for ax, ind in enumerate(idx):
            if isinstance(ind, slice):
                if ind == slice(None):
                    continue
                sl = [slice(None)] * out.ndim
                sl[ax] = ind
                out = out[tuple(sl)]
            else:
                out = np.take(out, ind, axis=ax)
        return out

    # ------------------------------------------------------------------ #
    # selected-view conveniences (reference selector.py:253-313,457-485)
    # ------------------------------------------------------------------ #

    def create_get_trial(self, data):
        """Install ``self._get_trial``: absolute-trial-id access to the
        SELECTED view of a trial (reference selector.py:273-313). Enables
        ``selector.trials`` to satisfy the same indexing protocol as
        ``data.trials``."""

        def _get_trial(trl_id):
            if trl_id not in self.trial_ids:
                raise SPYValueError(
                    legal="a trial part of the selection",
                    varname="Selector.trials",
                    actual=str(trl_id),
                )
            return self.select_trial_array(data, self.trial_ids.index(trl_id))

        self._get_trial = _get_trial
        return _get_trial

    @property
    def trials(self):
        """Iterable over the SELECTED view of the selected trials, indexed
        by ABSOLUTE trial id (reference selector.py:253-271):
        ``selection.trials[11]`` is the selected slice of original trial 11,
        valid only if trial 11 is part of the selection."""
        from .util import TrialIndexer

        if self.sampleinfo is None:
            return None
        return TrialIndexer(self, self.trial_ids)

    @property
    def sampleinfo(self):
        """nTrials x 2 array of selected [start, end] sample indices
        (reference selector.py:457-463)."""
        if self.trialdefinition is None:
            return None
        return self.trialdefinition[:, :2]

    @sampleinfo.setter
    def sampleinfo(self, sinfo):
        raise SPYError("Cannot set sampleinfo. Use `Selector.trialdefinition` instead.")

    @property
    def trialintervals(self):
        """nTrials x 2 array of selected [start, end] times in seconds
        (reference selector.py:469-481)."""
        if self.trialdefinition is None or self._samplerate is None:
            return None
        si = self.sampleinfo.astype(float)
        start_end = si - si[:, :1]
        start_end[:, 1] -= 1  # last time POINT, not exclusive bound
        return (start_end + self.trialdefinition[:, 2:3]) / float(self._samplerate)

    def __repr__(self):
        return self.__str__()

    def __str__(self):
        parts = ["syncopy_tpu Selector: {} trials".format(len(self.trial_ids))]
        for key in ("channel", "channel_i", "channel_j", "freq", "taper", "unit", "eventid"):
            val = getattr(self, key, None)
            if val is not None and not (isinstance(val, slice) and val == slice(None)):
                parts.append("{}: {}".format(key, val))
        if self.latency is not None:
            parts.append("latency: {}".format(self.latency))
        return ", ".join(parts)
