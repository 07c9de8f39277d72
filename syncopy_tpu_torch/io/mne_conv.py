# -*- coding: utf-8 -*-
#
# MNE-Python interop converters.
#
# Parity target: reference syncopy/io/mne_conv.py:20-186. Semantics match
# the reference: raw converters carry the trial offset through
# ``first_samp``; the epoch converters accept/return *time-locked*
# AnalogData (any AnalogData whose trials share length and offset) in
# addition to TimeLockData.
#
# One deliberate delta, documented here because it changes signs: the
# reference maps the syncopy trial offset to MNE as ``tmin = -offset/fs``
# (mne_conv.py:135-138) and back as ``offset = -tmin*fs`` (:175) — a
# self-consistent round-trip, but with MNE's epoch time axis MIRRORED
# against syncopy's own ``time`` property (t0 = +offset/fs,
# continuous_data time semantics). We use ``tmin = +offset/fs`` both
# ways, so the MNE epoch times EQUAL the syncopy trial times and the
# round-trip is still exact.

import numpy as np

from ..shared.errors import SPYError, SPYTypeError, SPYValueError

__all__ = [
    "raw_adata_to_mne_raw",
    "raw_mne_to_adata",
    "tldata_to_mne_epochs",
    "mne_epochs_to_tldata",
]


def _require_mne():
    try:
        import mne

        return mne
    except ImportError:
        raise SPYError(
            "MNE conversion requires the optional dependency 'mne'; install it "
            "to use the converters."
        )


def raw_adata_to_mne_raw(adata):
    """
    Convert raw (single-trial) AnalogData to an ``mne.io.RawArray``.

    The trial offset is carried through MNE's ``first_samp``. Multi-trial
    data is rejected — concatenating trials along time would silently
    misrepresent the recording (reference mne_conv.py:40-47); use
    :func:`tldata_to_mne_epochs` for epoched data.
    """
    mne = _require_mne()
    from ..datatype.continuous_data import AnalogData

    if not isinstance(adata, AnalogData):
        raise SPYTypeError(adata, varname="adata", expected="AnalogData")
    if len(adata.trials) > 1:
        raise SPYValueError(
            legal="AnalogData with no trial definition, or a single trial "
            "spanning the full data",
            varname="adata",
            actual=f"AnalogData with {len(adata.trials)} trials",
        )
    info = mne.create_info(
        ch_names=[str(c) for c in adata.channel],
        sfreq=float(adata.samplerate),
        ch_types="misc",
    )
    offset = int(adata.trialdefinition[0, 2])
    # mne: [channel x time]
    return mne.io.RawArray(np.asarray(adata.data[()]).T, info, first_samp=offset)


def raw_mne_to_adata(ar):
    """``mne.io.RawArray`` -> AnalogData (one trial; ``first_samp`` becomes
    the trial offset, reference mne_conv.py:79-90)."""
    mne = _require_mne()
    from ..datatype.continuous_data import AnalogData

    if not isinstance(ar, mne.io.RawArray):
        raise SPYTypeError(ar, varname="ar", expected="mne.io.RawArray")
    data = ar.get_data().T.astype(np.float32)
    adata = AnalogData(data=data, samplerate=float(ar.info["sfreq"]))
    adata.channel = [str(c) for c in ar.ch_names]
    n_samples = data.shape[0]
    adata.trialdefinition = np.array(
        [[0, n_samples, int(getattr(ar, "first_samp", 0))]]
    )
    return adata


def tldata_to_mne_epochs(tldata):
    """
    TimeLockData — or time-locked AnalogData (``is_time_locked``) — to
    ``mne.EpochsArray`` (reference mne_conv.py:95-139).
    """
    mne = _require_mne()
    from ..datatype.continuous_data import AnalogData, TimeLockData

    if isinstance(tldata, TimeLockData):
        pass
    elif isinstance(tldata, AnalogData):
        if not tldata.is_time_locked:
            raise SPYValueError(
                legal="TimeLockData, or AnalogData with is_time_locked == True",
                varname="tldata",
                actual="AnalogData with is_time_locked == False",
            )
    else:
        raise SPYTypeError(
            tldata, varname="tldata", expected="TimeLockData or AnalogData"
        )
    info = mne.create_info(
        ch_names=[str(c) for c in tldata.channel],
        sfreq=float(tldata.samplerate),
        ch_types="misc",
    )
    trials = np.stack([np.asarray(t).T for t in tldata.trials])  # [trial x chan x time]
    tmin = float(tldata.trialdefinition[0, 2]) / tldata.samplerate
    return mne.EpochsArray(trials, info, tmin=tmin)


def mne_epochs_to_tldata(ep):
    """``mne.EpochsArray`` -> time-locked AnalogData (trials concatenated
    along the time axis, offset from ``ep.tmin``; the reference likewise
    returns AnalogData, not TimeLockData — mne_conv.py:142-186)."""
    mne = _require_mne()
    from ..datatype.continuous_data import AnalogData

    if not isinstance(ep, mne.EpochsArray):
        raise SPYTypeError(ep, varname="ep", expected="mne.EpochsArray")
    data = ep.get_data()  # [trial x chan x time]
    sr = float(ep.info["sfreq"])
    n_trials, n_chan, n_time = data.shape
    stacked = np.concatenate([d.T for d in data], axis=0).astype(np.float32)
    out = AnalogData(data=stacked, samplerate=sr)
    out.channel = [str(c) for c in ep.ch_names]
    offset = int(round(ep.tmin * sr))
    trl = np.zeros((n_trials, 3))
    trl[:, 0] = np.arange(n_trials) * n_time
    trl[:, 1] = trl[:, 0] + n_time
    trl[:, 2] = offset
    out.trialdefinition = trl
    return out
