# -*- coding: utf-8 -*-
#
# Arithmetic on syncopy_tpu objects: +, -, *, /, ** with scalars, arrays and
# other objects, applied trial-by-trial while honoring in-place selections.
#
# Parity target: reference syncopy/datatype/methods/arithmetic.py:21-517.
# The reference routes every operation through the `SpyArithmetic` CR with
# Dask locks against chained-operation races; here operations are applied as
# vectorized numpy ops on the host payload of the (selected) trial stack — a
# single fused elementwise pass, no locks needed. The port keeps them on the
# host, as the JAX package does: a device pass would add an upload and a
# readback per operator.
#
# Fast path: when no selection is active and the trialdefinition exactly
# tiles the payload along the stacking dim (the overwhelmingly common case),
# the operation runs as ONE whole-array ufunc call — a single output
# allocation, no per-trial temporaries, no concatenate copy. Trials with
# gaps/overlaps, active selections, and discrete (event-table) data take the
# general per-trial path below.

import numbers

import numpy as np

from ...shared.errors import SPYError, SPYTypeError, SPYValueError

__all__ = ["_process_operator"]

_OPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "**": lambda a, b: a**b,
}


def _process_operator(obj, operand, operator, reverse=False):
    """Dispatch an arithmetic operator on syncopy_tpu object `obj`."""
    from ..base_data import BaseData

    if operator not in _OPS:
        raise SPYValueError(legal=str(list(_OPS)), varname="operator", actual=operator)
    if obj.data is None:
        raise SPYError("Cannot perform arithmetic on empty object")

    op = _OPS[operator]
    if reverse:
        inner = op
        op = lambda a, b: inner(b, a)  # noqa: E731

    if (isinstance(operand, (numbers.Number, np.number))
            and operator == "/" and not reverse and operand == 0):
        raise SPYValueError(legal="non-zero scalar", varname="operand", actual="0")

    # gather (selected) per-trial arrays of obj
    sel = obj.selection
    if sel is None:
        fast = _fused_whole_array(obj, operand, op, operator, reverse)
        if fast is not None:
            out = _finalize_output(obj, fast, np.array(obj.trialdefinition))
            out.log = "arithmetic: {} {} {}".format(
                obj.__class__.__name__, operator, type(operand).__name__
            )
            return out
    if sel is not None:
        trials_a = [sel.select_trial_array(obj, k) for k in range(len(sel.trial_ids))]
        trialdef = np.array(sel.trialdefinition)
    else:
        trials_a = [np.asarray(t) for t in obj.trials]
        trialdef = np.array(obj.trialdefinition)
        if "sample" not in obj.dimord:
            # the output stacks trials gap-free: rebase sample bounds to
            # cumulative counts (identical to the original when trials tile)
            lens = trialdef[:, 1] - trialdef[:, 0]
            bounds = np.cumsum(np.concatenate([[0], lens]))
            trialdef[:, 0] = bounds[:-1]
            trialdef[:, 1] = bounds[1:]

    if isinstance(operand, BaseData):
        operand_trials = _parse_object_operand(obj, operand, trials_a)
        res = [op(a, b) for a, b in zip(trials_a, operand_trials)]
    elif isinstance(operand, (numbers.Number, np.number)):
        res = [op(a, operand) for a in trials_a]
    elif isinstance(operand, (np.ndarray, list)):
        operand = np.asarray(operand)
        for a in trials_a:
            try:
                np.broadcast_shapes(a.shape, operand.shape)
            except ValueError:
                raise SPYValueError(
                    legal="array broadcastable to trial shape {}".format(a.shape),
                    varname="operand",
                    actual=str(operand.shape),
                )
        res = [op(a, operand) for a in trials_a]
    else:
        raise SPYTypeError(
            operand, varname="operand", expected="scalar, array or syncopy_tpu object"
        )

    out = _assemble_output(obj, res, trialdef)
    out.log = "arithmetic: {} {} {}".format(
        obj.__class__.__name__, operator, type(operand).__name__
    )
    return out


def _tiles_payload(obj):
    """True when the (unselected) trials exactly tile the payload along the
    stacking dim, in order — a whole-array op is then per-trial exact."""
    if "sample" in obj.dimord:  # discrete: trials select rows by sample value
        return False
    trl = obj._trialdefinition
    if trl is None:
        return False
    si = trl[:, :2].astype(np.int64)
    n = obj.data.shape[obj._stackingDim]
    return (
        si.size > 0
        and si[0, 0] == 0
        and si[-1, 1] == n
        and bool(np.all(si[1:, 0] == si[:-1, 1]))
        and bool(np.all(si[:, 1] >= si[:, 0]))
    )


def _fused_whole_array(obj, operand, op, operator, reverse):
    """Whole-array single-allocation op, or None to take the general path.

    Only returns a result when it is exactly equivalent to the per-trial
    path; all error cases return None so the general path raises the same
    exceptions it always did.
    """
    from ..base_data import BaseData

    if not _tiles_payload(obj):
        return None

    if isinstance(operand, (numbers.Number, np.number)):
        return op(np.asarray(obj.data), operand)

    if isinstance(operand, BaseData):
        if (
            operand.__class__ != obj.__class__
            or operand.data is None
            or operand.dimord != obj.dimord
            or operand.selection is not None
            or not _tiles_payload(operand)
            or obj.data.shape != operand.data.shape
        ):
            return None
        si_a, si_b = obj.sampleinfo, operand.sampleinfo
        if si_a.shape != si_b.shape or not np.array_equal(
            np.diff(si_a, axis=1), np.diff(si_b, axis=1)
        ):
            return None
        return op(np.asarray(obj.data), np.asarray(operand.data))

    if isinstance(operand, (np.ndarray, list)):
        arr = np.asarray(operand)
        if obj._stackingDim != 0:
            return None
        lens = np.diff(obj.sampleinfo, axis=1).ravel()
        if lens.size == 0 or not np.all(lens == lens[0]):
            return None
        trial_shape = (int(lens[0]),) + tuple(obj.data.shape[1:])
        try:
            if np.broadcast_shapes(trial_shape, arr.shape) != trial_shape:
                return None
        except ValueError:
            return None  # general path raises the broadcast error
        full = np.asarray(obj.data)
        res = op(full.reshape((lens.size,) + trial_shape), arr)
        return res.reshape((-1,) + trial_shape[1:])

    return None


def _parse_object_operand(obj, operand, trials_a):
    """Validate an object operand and return its (selected) trial arrays
    (reference arithmetic.py:66-300)."""
    if operand.__class__ != obj.__class__:
        raise SPYTypeError(
            operand, varname="operand", expected=obj.__class__.__name__
        )
    if operand.data is None:
        raise SPYError("Cannot perform arithmetic with empty object")
    if operand.dimord != obj.dimord:
        raise SPYValueError(
            legal="matching dimord", varname="operand", actual=str(operand.dimord)
        )
    sel_b = operand.selection
    if sel_b is not None:
        trials_b = [sel_b.select_trial_array(operand, k) for k in range(len(sel_b.trial_ids))]
    else:
        trials_b = [np.asarray(t) for t in operand.trials]
    if len(trials_b) != len(trials_a):
        raise SPYValueError(
            legal="matching (selected) trial counts",
            varname="operand",
            actual="{} vs {} trials".format(len(trials_b), len(trials_a)),
        )
    for a, b in zip(trials_a, trials_b):
        if a.shape != b.shape:
            raise SPYValueError(
                legal="matching trial shapes",
                varname="operand",
                actual="{} vs {}".format(a.shape, b.shape),
            )
    return trials_b


def _assemble_output(obj, res, trialdef):
    """Stack per-trial results into a fresh object of obj's class."""
    sdim = obj._stackingDim if "sample" not in obj.dimord else 0
    data = np.concatenate([np.asarray(r) for r in res], axis=sdim)
    return _finalize_output(obj, data, trialdef)


def _finalize_output(obj, data, trialdef):
    """Wrap a ready result array into a fresh object of obj's class."""
    cls = obj.__class__
    out = cls.__new__(cls)
    cls.__init__(out)
    out._dimord = obj.dimord
    out.data = data
    out._trialdefinition = trialdef

    sel = obj.selection

    def _take(labels, indexer):
        labels = np.asarray(labels)
        if indexer is None:
            return labels
        if isinstance(indexer, slice):
            return labels[indexer]
        return labels[np.asarray(indexer, dtype=int)]

    if getattr(obj, "samplerate", None) is not None:
        out.samplerate = obj.samplerate
    if "channel" in obj.dimord and hasattr(out, "channel"):
        ch = obj.channel
        if ch is not None:
            out.channel = _take(ch, getattr(sel, "channel", None) if sel else None)
    for key in ("channel_i", "channel_j"):
        if key in obj.dimord:
            setattr(out, key, _take(getattr(obj, key), getattr(sel, key, None) if sel else None))
    if "freq" in obj.dimord:
        out.freq = _take(obj.freq, getattr(sel, "freq", None) if sel else None)
    if "taper" in obj.dimord:
        out.taper = _take(obj.taper, getattr(sel, "taper", None) if sel else None)
    out._cfg = obj.cfg.copy()
    out._log = str(obj._log)
    return out
