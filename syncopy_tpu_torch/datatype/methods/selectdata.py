# -*- coding: utf-8 -*-
#
# selectdata: create a new object from a selection, or attach an in-place
# selection.
#
# Parity target: reference syncopy/datatype/methods/selectdata.py:28-461.
# The reference's deep-copy path runs the `DataSelection` CR trial-by-trial
# through Dask; here the selection is a host gather plan applied per trial
# (the arrays are small metadata-relative; heavy selections happen inside
# compute pipelines where the Selector's plans are folded into device
# batching instead). On a mesh (`parallel`) the copy of continuous data
# is an engine pass instead, sharded over the mesh's trial axis, whose
# result stays device-resident for the next analysis on that mesh.

import numpy as np

from ...shared.errors import SPYError, SPYValueError
from ...shared.kwarg_decorators import unwrap_cfg
from ...shared.tools import get_frontend_cfg, get_defaults

__all__ = ["selectdata"]


@unwrap_cfg
def selectdata(
    data,
    trials=None,
    channel=None,
    channel_i=None,
    channel_j=None,
    latency=None,
    frequency=None,
    taper=None,
    unit=None,
    eventid=None,
    inplace=False,
    clear=False,
    parallel=None,
    **kwargs,
):
    """
    Create a new data object from a subset of `data`, or attach the
    selection in-place (``inplace=True``) for subsequent analysis calls.

    Parameters
    ----------
    data : Syncopy data object
        Object to select from.
    trials : int, list, slice, or None
        Trial subset.
    channel : labels, indices, slice, or None
        Channel subset (by name or index); `channel_i`/`channel_j` address
        the two channel axes of :class:`~syncopy_tpu.CrossSpectralData`.
    latency : [t0, t1] or None
        Time window in seconds (per trial).
    frequency : [f0, f1], values, or None
        Frequency subset for spectral objects.
    taper : labels/indices or None
        Taper subset for spectral objects.
    unit, eventid
        Discrete-data selectors (SpikeData units, EventData event codes).
    inplace : bool
        Attach the selection to `data` for subsequent analysis calls
        instead of materializing a new object.
    clear : bool
        Remove an in-place selection.
    parallel : bool or None
        Shard the materializing copy over the mesh that
        :func:`~syncopy_tpu_torch.parallel.mesh.resolve_parallel` gives
        (None: the active mesh); without one the copy is a host gather.

    Returns
    -------
    A new data object (or None for ``inplace=True``).

    Reference: methods/selectdata.py:28.
    """
    if data.data is None:
        raise SPYError("Cannot select from empty object")

    if clear:
        if inplace:
            data.selection = None
            return
        raise SPYValueError(legal="clear=True requires inplace=True", varname="clear")

    select = {
        k: v
        for k, v in {
            "trials": trials,
            "channel": channel,
            "channel_i": channel_i,
            "channel_j": channel_j,
            "latency": latency,
            "frequency": frequency,
            "taper": taper,
            "unit": unit,
            "eventid": eventid,
        }.items()
        if v is not None
    }

    if inplace:
        data.selection = select
        return

    prior = data._selection
    data.selection = select
    sel = data.selection
    try:
        out = _apply_selection(data, sel, parallel)
    finally:
        data._selection = prior

    new_cfg = get_frontend_cfg(get_defaults(selectdata), locals(), kwargs)
    out.cfg.update({"selectdata": new_cfg})
    out.log = "selected data with settings {}".format(select)
    return out


def _apply_selection(data, sel, parallel=False):
    """Materialize the selection into a fresh object of the same class:
    through the engine on the mesh `parallel` resolves to (continuous
    data only), else a host gather."""
    from ...parallel.mesh import resolve_parallel
    from ...statistics.timelockanalysis import _TimeLockCopy

    cls = data.__class__
    out = cls.__new__(cls)
    cls.__init__(out)
    out._dimord = data.dimord

    if len(sel.trial_ids) == 0:
        raise SPYValueError(legal="non-empty selection", varname="select")
    mesh = None if "sample" in data.dimord else resolve_parallel(parallel)
    if mesh is not None:
        cr = _TimeLockCopy()  # the chunked identity pass, bit-exact
        cr.initialize(data, data._stackingDim, keeptrials=True)
        cr.compute(data, out, parallel=parallel)
    else:
        # discrete data: rows are filtered; the trialdefinition keeps the
        # sample bounds either way
        arrs = [sel.select_trial_array(data, k) for k in range(len(sel.trial_ids))]
        out.data = np.concatenate(arrs, axis=0 if "sample" in data.dimord else data._stackingDim)
    out._trialdefinition = np.array(sel.trialdefinition)

    # dimensional properties, selection applied
    if getattr(data, "samplerate", None) is not None:
        out.samplerate = data.samplerate

    def _take(labels, indexer):
        labels = np.asarray(labels)
        if indexer is None:
            return labels
        if isinstance(indexer, slice):
            return labels[indexer]
        return labels[np.asarray(indexer, dtype=int)]

    if "channel" in data.dimord and hasattr(out, "channel"):
        try:
            out.channel = _take(data.channel, sel.channel)
        except SPYValueError:
            pass
    if "sample" in data.dimord and hasattr(data, "channel") and data.channel is not None:
        # discrete data: channel labels are not an axis; keep all
        out._channel = np.asarray(data.channel)
    for key in ("channel_i", "channel_j"):
        if key in data.dimord:
            setattr(out, key, _take(getattr(data, key), getattr(sel, key)))
    if "freq" in data.dimord:
        out.freq = _take(data.freq, sel.freq)
    if "taper" in data.dimord:
        out.taper = _take(data.taper, sel.taper)
    if hasattr(data, "_unit") and getattr(data, "_unit", None) is not None:
        out._unit = np.asarray(data._unit)

    # irregular (unevenly spaced) time axes: carry the exact points through,
    # subset by the (time-locked) per-trial latency indexer
    irr = getattr(data, "irregular_time", None)
    if irr is not None and "time" in data.dimord:
        tsel = sel.time[0] if getattr(sel, "time", None) else slice(None)
        out.irregular_time = np.asarray(irr)[tsel]

    out._cfg = data.cfg.copy()
    out._log = str(data._log)
    return out
