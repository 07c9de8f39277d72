# -*- coding: utf-8 -*-
#
# redefinetrial: re-segment/re-align the trials of a data object.
#
# Parity target: reference syncopy/datatype/methods/redefinetrial.py:22-266.
# Supported: trials subset, minlength filtering, offset shifts, toilim
# windows, begsample/endsample trimming, and explicit trl arrays.

import numpy as np

from ...shared.errors import SPYError, SPYTypeError, SPYValueError
from ...shared.kwarg_decorators import unwrap_cfg

__all__ = ["redefinetrial"]


@unwrap_cfg
def redefinetrial(
    data_obj,
    trials=None,
    minlength=None,
    offset=None,
    toilim=None,
    begsample=None,
    endsample=None,
    trl=None,
):
    """
    Return a new object with re-segmented/re-aligned trials.

    Parameters mirror FieldTrip's ft_redefinetrial (reference
    methods/redefinetrial.py:22): `trials` subselects, `minlength` (seconds
    or 'maxperlen') drops short trials, `offset` shifts t=0, `toilim`
    ``[begin, end]`` restricts to a time window, `begsample`/`endsample`
    trim relative to trial starts, `trl` replaces the trialdefinition.
    """
    data = data_obj
    if data.data is None:
        raise SPYError("Cannot redefine trials of empty object")

    # window/segment specifications are mutually exclusive, and none of
    # them combines with `trl` or with `minlength` (reference
    # redefinetrial.py rejects these as "Incompatible input arguments")
    exclusive = [toilim is not None, (begsample is not None or endsample is not None), trl is not None]
    if sum(exclusive) > 1:
        raise SPYError(
            "Incompatible input arguments: only one of `toilim`, "
            "`begsample`/`endsample`, `trl` may be used"
        )
    if trl is not None and (trials is not None or minlength is not None or offset is not None):
        raise SPYError(
            "Incompatible input arguments: `trl` cannot be combined with "
            "other parameters"
        )
    if minlength is not None and (toilim is not None or begsample is not None
                                  or endsample is not None):
        raise SPYError(
            "Incompatible input arguments: `minlength` cannot be combined "
            "with `toilim` or `begsample`/`endsample`"
        )

    old = data.trialdefinition
    if old is None:
        raise SPYError("Object has no trialdefinition")

    if trl is not None:
        trl = np.atleast_2d(np.asarray(trl, dtype=float))
        out = data.copy()
        out.trialdefinition = trl
        out.log = "redefinetrial: replaced trialdefinition ({} trials)".format(trl.shape[0])
        return out

    keep = np.arange(old.shape[0])
    if trials is not None:
        trials = np.atleast_1d(np.asarray(trials, dtype=int))
        if np.any(trials < 0) or np.any(trials >= old.shape[0]):
            raise SPYValueError(
                legal="trial indices in [0, {})".format(old.shape[0]),
                varname="trials",
                actual=str(trials),
            )
        keep = trials

    new_trl = old[keep].copy()

    if minlength is not None:
        if data.samplerate is None:
            raise SPYError("minlength requires a samplerate")
        lens = (new_trl[:, 1] - new_trl[:, 0]) / data.samplerate
        if isinstance(minlength, str):
            if minlength != "maxperlen":
                raise SPYValueError(legal="'maxperlen' or scalar seconds", varname="minlength", actual=minlength)
            sel = lens == lens.max()
        else:
            if not isinstance(minlength, (int, float, np.number)):
                raise SPYTypeError(minlength, varname="minlength",
                                   expected="scalar or 'maxperlen'")
            if float(minlength) <= 0:
                raise SPYValueError(
                    legal="expected value to be greater than 0",
                    varname="minlength", actual=str(minlength),
                )
            sel = lens >= float(minlength)
        new_trl = new_trl[sel]
        keep = keep[sel]
    if new_trl.shape[0] == 0:
        # all trials filtered away: return an EMPTY object (reference
        # semantics, test_redefinetrial.py:91-128) instead of raising
        out = data.__class__(dimord=data.dimord)
        if getattr(data, "samplerate", None) is not None:
            out.samplerate = data.samplerate
        out.log = "redefinetrial -> no remaining trials (empty object)"
        return out

    if offset is not None:
        if isinstance(offset, str):
            raise SPYTypeError(offset, varname="offset",
                               expected="scalar, array of offsets")
        if isinstance(offset, (int, float, np.number)):
            new_trl[:, 2] = new_trl[:, 2] + float(offset)
        else:
            offset = np.asarray(offset, dtype=float).ravel()
            if offset.size != new_trl.shape[0]:
                raise SPYValueError(
                    legal="{} offsets".format(new_trl.shape[0]), varname="offset", actual=str(offset.size)
                )
            new_trl[:, 2] = new_trl[:, 2] + offset

    if toilim is not None:
        if data.samplerate is None:
            raise SPYError("toilim requires a samplerate")
        toilim = np.asarray(toilim, dtype=float).ravel()
        if toilim.size != 2 or toilim[0] > toilim[1]:
            raise SPYValueError(legal="[begin, end] in seconds", varname="toilim", actual=str(toilim))
        rows = []
        for r in new_trl:
            start, stop, off = int(r[0]), int(r[1]), int(r[2])
            n = stop - start
            tvec = (np.arange(n) + off) / data.samplerate
            inside = np.where((tvec >= toilim[0]) & (tvec <= toilim[1]))[0]
            if inside.size == 0:
                continue
            r = r.copy()
            r[0] = start + inside[0]
            r[1] = start + inside[-1] + 1
            r[2] = off + inside[0]
            rows.append(r)
        if not rows:
            raise SPYValueError(legal="trials overlapping toilim", varname="toilim", actual=str(toilim))
        new_trl = np.vstack(rows)

    if begsample is not None or endsample is not None:
        begsample = 0 if begsample is None else begsample
        beg = np.atleast_1d(np.asarray(begsample, dtype=float)).ravel()
        if beg.size == 1:
            beg = np.full(new_trl.shape[0], beg[0])
        if endsample is None:
            end = new_trl[:, 1] - new_trl[:, 0]
        else:
            end = np.atleast_1d(np.asarray(endsample, dtype=float)).ravel()
            if end.size == 1:
                end = np.full(new_trl.shape[0], end[0])
        if beg.size != new_trl.shape[0] or end.size != new_trl.shape[0]:
            raise SPYValueError(
                legal="scalar or {}-element begsample/endsample".format(new_trl.shape[0]),
                varname="begsample/endsample",
            )
        starts = new_trl[:, 0] + beg
        stops = new_trl[:, 0] + end
        if np.any(starts < new_trl[:, 0]) or np.any(stops > new_trl[:, 1]) or np.any(stops < starts):
            raise SPYValueError(
                legal="begsample/endsample within trial bounds", varname="begsample/endsample"
            )
        new_trl[:, 2] = new_trl[:, 2] + beg
        new_trl[:, 0] = starts
        new_trl[:, 1] = stops

    out = data.copy()
    out.trialdefinition = new_trl
    out.log = "redefinetrial -> {} trials".format(new_trl.shape[0])
    return out
