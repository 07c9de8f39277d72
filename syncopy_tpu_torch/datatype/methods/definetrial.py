# -*- coding: utf-8 -*-
#
# definetrial: (re)define trials of a data object.
#
# Parity target: reference syncopy/datatype/methods/definetrial.py:18-392.
# Supports: explicit trl arrays, "all-in-one" default, and trigger-based
# definitions from an EventData object (pre/post/trigger or start/stop codes).

import numpy as np

from ...shared.errors import SPYError, SPYValueError

__all__ = ["definetrial"]


def definetrial(obj, trialdefinition=None, pre=None, post=None, start=None,
                trigger=None, stop=None, clip_edges=False):
    """
    Encapsulate the payload of `obj` into trials.

    ``trialdefinition`` may be an ``[nTrials x 3+]`` array ``[start, stop,
    offset(, trialinfo...)]``, another syncopy_tpu object whose
    trialdefinition should be copied, an ``EventData`` object combined with
    `pre`/`post`/`trigger` (or `start`/`stop`) event codes, or `None` for one
    all-encompassing trial.

    Parameters
    ----------
    obj : Syncopy data object
        Object whose trials to (re)define (modified in place).
    trialdefinition : array, Syncopy object, EventData, or None
        See above.
    pre, post : float
        Seconds before/after each `trigger` event (EventData mode).
    start, trigger, stop : int
        Event codes delimiting each trial (EventData mode).
    clip_edges : bool
        Clip trial windows protruding beyond the recording instead of
        raising.
    """
    from ..base_data import BaseData
    from ..discrete_data import EventData

    if obj.data is None:
        raise SPYError("Cannot define trials on empty object")

    if trialdefinition is None and start is None and trigger is None:
        nsamp = _payload_samples(obj)
        trl = np.array([[0, nsamp, 0]], dtype=float)
        _attach(obj, trl)
        return

    if trialdefinition is None and (trigger is not None or start is not None):
        # event codes from the object ITSELF (reference: evt.definetrial(
        # pre=..., trigger=...), test_discretedata.py:377-382)
        if not isinstance(obj, EventData):
            raise SPYValueError(
                legal="an EventData source (pass `trialdefinition=`) for "
                      "code-based trial definition", varname="trialdefinition",
            )
        trl = _trials_from_events(obj, obj, pre=pre, post=post, start=start,
                                  trigger=trigger, stop=stop, clip_edges=clip_edges)
        _attach(obj, trl)
        return

    if isinstance(trialdefinition, EventData) or (isinstance(trialdefinition, BaseData) and (pre is not None or trigger is not None or start is not None)):
        evt = trialdefinition
        trl = _trials_from_events(evt, obj, pre=pre, post=post, start=start,
                                  trigger=trigger, stop=stop, clip_edges=clip_edges)
        _attach(obj, trl)
        return

    if isinstance(trialdefinition, BaseData):
        src = trialdefinition.trialdefinition
        if src is None:
            raise SPYValueError(legal="object with defined trials", varname="trialdefinition")
        _attach(obj, np.array(src, dtype=float))
        return

    trl = np.atleast_2d(np.asarray(trialdefinition, dtype=float))
    if trl.shape[1] < 3:
        # the reference rejects <3 columns outright (definetrial.py:351-356)
        # — a missing offset column is a user error, not an implied zero
        raise SPYValueError(
            legal="array of shape (no. of trials, 3+): [start, stop, offset]",
            varname="trialdefinition",
            actual="shape = {}".format(trl.shape),
        )
    if np.any(trl[:, 1] < trl[:, 0]):
        raise SPYValueError(legal="stop >= start for all trials", varname="trialdefinition")
    if np.any(trl[:, 0] < 0):
        raise SPYValueError(
            legal="non-negative trial starts", varname="trialdefinition",
            actual=str(trl[:, 0].min()),
        )
    if "sample" not in obj.dimord:
        # continuous data: trials must lie inside the payload; discrete data
        # may define trials beyond the last recorded event
        nsamp = _payload_samples(obj)
        if np.any(trl[:, 1] > nsamp):
            raise SPYValueError(
                legal="sample bounds within [0, {}]".format(nsamp),
                varname="trialdefinition",
                actual="[{}, {}]".format(trl[:, 0].min(), trl[:, 1].max()),
            )
    _attach(obj, trl)


def _payload_samples(obj):
    sdim = obj._stackingDim
    if "sample" in obj.dimord:
        smp = np.asarray(obj.data[:, obj.dimord.index("sample")])
        return int(smp.max()) + 1 if smp.size else 0
    return obj.data.shape[sdim]


def _attach(obj, trl):
    obj._bump_cache_token()
    obj._trialdefinition = np.array(trl, dtype=float)
    obj._selection = None
    obj.log = "set trialdefinition ({} trials)".format(trl.shape[0])


def _trials_from_events(evt, target, pre=None, post=None, start=None,
                        trigger=None, stop=None, clip_edges=False):
    """Build a trl array from EventData trigger codes (reference :200+).

    Event samples live on the EVENT object's clock; the returned bounds are
    in TARGET samples (the two samplerates may differ — reference
    tests/test_discretedata.py:366-430). `start`/`stop` may be scalars (all
    matching pairs) or equal-length sequences consumed in order."""
    if evt.samplerate is None or target.samplerate is None:
        raise SPYError("Both objects need a samplerate for event-based trial definition")
    data = np.asarray(evt.data)
    scol = evt.dimord.index("sample")
    ecol = evt.dimord.index("eventid")
    samples = data[:, scol].astype(np.int64)
    codes = data[:, ecol]
    nsamp_target = _payload_samples(target)
    rows = []

    def to_target(evt_samples):
        """Event-clock samples -> target-clock samples."""
        if evt is target or evt.samplerate == target.samplerate:
            return np.asarray(evt_samples, dtype=np.int64)
        sec = np.asarray(evt_samples, dtype=float) / evt.samplerate
        return np.round(sec * target.samplerate).astype(np.int64)

    if trigger is not None:
        if pre is None or post is None:
            raise SPYValueError(legal="both `pre` and `post` with `trigger`", varname="pre/post")
        pre_smp = int(round(pre * target.samplerate))
        for smp in samples[codes == trigger]:
            # round the final bound SECONDS onto the target clock (reference
            # formula: sinfo = round((t_evt/sr_e -/+ pre/post) * sr_target))
            t_sec = float(smp) / evt.samplerate
            t_start = int(round((t_sec - pre) * target.samplerate))
            t_stop = int(round((t_sec + post) * target.samplerate))
            offset = -pre_smp
            if t_start < 0 or t_stop > nsamp_target:
                if not clip_edges:
                    continue
                if t_start < 0:
                    # dropping |t_start| leading samples moves the first
                    # sample CLOSER to the trigger: offset -50 with t_start
                    # -40 becomes -10 (first kept sample is 10 samples
                    # before t0), not -90
                    offset -= t_start
                    t_start = 0
                t_stop = min(t_stop, nsamp_target)
            rows.append([t_start, t_stop, offset])
    elif start is not None and stop is not None:
        if np.ndim(start) > 0 or np.ndim(stop) > 0:
            # sequences: consume codes strictly in order — find the k-th
            # start code, then the k-th stop code AFTER it, advance
            # (reference definetrial.py start/stop array semantics)
            starts = np.atleast_1d(np.asarray(start))
            stops = np.atleast_1d(np.asarray(stop))
            if starts.size != stops.size:
                raise SPYValueError(
                    legal="equally long `start` and `stop` code sequences",
                    varname="start/stop",
                )
            pos = 0
            for s_code, e_code in zip(starts, stops):
                s_hits = np.where(codes[pos:] == s_code)[0]
                if s_hits.size == 0:
                    break
                s_idx = pos + s_hits[0]
                e_hits = np.where(codes[s_idx + 1 :] == e_code)[0]
                if e_hits.size == 0:
                    break
                e_idx = s_idx + 1 + e_hits[0]
                s_t, e_t = to_target([samples[s_idx], samples[e_idx]])
                if s_t < 0 or e_t > nsamp_target:
                    if not clip_edges:
                        pos = e_idx + 1
                        continue
                    s_t = max(s_t, 0)
                    e_t = min(e_t, nsamp_target)
                if s_t < e_t:
                    rows.append([s_t, e_t, 0])
                pos = e_idx + 1
        else:
            start_samples = to_target(samples[codes == start])
            stop_samples = to_target(samples[codes == stop])
            for s0 in start_samples:
                later = stop_samples[stop_samples > s0]
                if later.size == 0:
                    if clip_edges:
                        rows.append([s0, nsamp_target, 0])
                    continue
                rows.append([s0, int(later[0]), 0])
    else:
        raise SPYValueError(legal="`trigger` (+pre/post) or `start`+`stop` codes", varname="definetrial")

    if not rows:
        raise SPYValueError(legal="at least one matching trial", varname="trialdefinition",
                            actual="no events matched")
    return np.array(rows, dtype=float)
