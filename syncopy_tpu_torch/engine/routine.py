# -*- coding: utf-8 -*-
#
# ComputationalRoutine: the compute engine.
#
# Port of syncopy_tpu/engine/routine.py. What carries over:
#   - initialize: selection, trials bucketed by exact post-selection shape
#     (ragged trials), output shapes from an explicit per-routine rule
#     (`output_trial_shape`) instead of an abstract trace;
#   - compute/_run: fixed power-of-two chunks sized from a byte budget,
#     padded chunks masked by `n_valid`, chunk sums accumulated on the
#     device, the fused post transform applied to sum / numTrials;
#   - host gather (_plan_fast_gather/_gather_batch), one upload per chunk,
#     process_metadata and write_log;
#   - the aux-info channel: a routine's per-trial step may return
#     (result, info), and the info is collected per trial into
#     `aux_info` (reference :379-391, :817-861, :1009-1011);
#   - auxiliary per-trial inputs (`per_trial_inputs`, reference :439,
#     :921-999): each chunk uploads its rows with the batch;
#   - device-resident outputs (engine/resident.py): kept trials stay on
#     the device behind a DeferredArray, and the next routine consumes
#     their chunks from there (reference :865-915, :1051-1085);
#   - the device trial store: uploaded chunks in an LRU by bytes, reused
#     by later analyses of the same (selected) payload (reference
#     :121-171, :1084-1144);
#   - the HDF5 spill of a result over the host budget (reference
#     :213-244);
#   - the out-of-memory half of the dispatch recovery: evict the store
#     and the residents, then retry once (reference :84-118);
#   - the mesh (reference :752-768, :875-1000): each chunk's rows split
#     into one contiguous block per trial shard, each with its own
#     `n_valid`, computed on its position's device; trial sums combined on
#     the mesh's first position in shard order (JAX's psum); a routine that
#     declares `channel_split` splits its channels over the channel axis;
#   - a mesh that spans processes (parallel/mesh.py::init_distributed):
#     each rank gathers, uploads and computes only the trial shards it
#     owns, and each shard's partial or rows reach every rank by a
#     broadcast from its owner (mesh.share_from), in the plan's order on
#     every rank; the partials are summed in shard order as in one
#     process, so every rank holds the same bits.
# Left out, as workarounds for the TPU runtime: the (re, im) complex
# encoding, the readback relayout, the transient-error retries and the
# compile back-off, f16 transfer/readback and the device constant cache
# (the remote compile's payload limit).

import hashlib
import sys
import warnings

import numpy as np
import torch

from ..parallel.mesh import (Mesh, device_context, gather_shards, pad_to_multiple,
                             process_rank, resolve_parallel, share_from)
from ..shared.errors import SPYError, SPYValueError
from ..shared.log import get_logger
from ..shared.profiling import span
from . import resident as _resident
from .resident import DeferredArray, DeviceResident, Record, _admit

__all__ = [
    "ComputationalRoutine",
    "chunk_trials",
    "clear_device_cache",
    "default_device",
    "log_format_counts",
    "plan_counts",
    "set_device",
    "transfer_counts",
]

#: device-memory budget per compute chunk (bytes)
DEFAULT_CHUNK_BUDGET = 2 * 1024**3

#: hard cap on trials per compute chunk
MAX_CHUNK_TRIALS = 1024

#: host-memory budget of one result (bytes): a larger one is written to a
#: disk-backed HDF5 dataset
DEFAULT_HOST_BUDGET = 16 * 1024**3

#: device bytes of the trial store (uploaded chunks kept for the next
#: analysis of the same payload); 0 turns the store off
DEVICE_CACHE_BYTES = 4 * 1024**3
_DEVICE_CACHE = {}  # key -> (list of device chunks, bytes)
_DEVICE_CACHE_ORDER = []  # keys, least recently used first
_DEVICE_CACHE_SIZE = [0]

#: the trial-store bypass is logged once per process
_FINGERPRINT_BYPASS_LOGGED = False

#: bytes the engine moved across the host link since the last
#: reset_transfer_counts(): "h2d" payload uploads, "h2d_aux" auxiliary
#: per-trial inputs, "d2h" results read back (materializations and plot
#: views included), "d2h_aux" the per-trial info read back
_TRANSFERS = {"h2d": 0, "h2d_aux": 0, "d2h": 0, "d2h_aux": 0}


def _count_transfer(kind, nbytes):
    _TRANSFERS[kind] += int(nbytes)


def transfer_counts():
    """The bytes the engine moved across the host link, by kind, since the
    last :func:`reset_transfer_counts`."""
    return dict(_TRANSFERS)


def reset_transfer_counts():
    for k in _TRANSFERS:
        _TRANSFERS[k] = 0


#: plans made by ComputationalRoutine.initialize since the last
#: reset_plan_counts(): "vectorized" from the trial lengths (whole trials of
#: continuous data), "per_trial" one trial's indexers at a time (a latency
#: window, discrete data)
_PLANS = {"vectorized": 0, "per_trial": 0}


def plan_counts():
    """The engine's plans by kind, since the last :func:`reset_plan_counts`."""
    return dict(_PLANS)


def reset_plan_counts():
    for k in _PLANS:
        _PLANS[k] = 0


#: the text of array values that write_log printed, keyed by dtype, shape,
#: content and numpy's print options, so that an equal array under equal
#: options is printed once per process (numpy's array printer takes
#: milliseconds for a frequency axis of a few hundred bins, every call). At
#: most _LOG_TEXT_ENTRIES entries, each of at most _LOG_TEXT_SIZE elements
#: (object arrays, whose bytes are pointers, are never stored); the oldest
#: entry goes first.
_LOG_TEXT = {}
_LOG_TEXT_ENTRIES = 32
_LOG_TEXT_SIZE = 4096

#: write_log's values since the last reset_log_format_counts(): "cached"
#: array text taken from _LOG_TEXT, "formatted" array text printed and
#: stored, "direct" any other value printed by str()
_LOG_FORMATS = {"cached": 0, "formatted": 0, "direct": 0}


def log_format_counts():
    """write_log's values by how their text was made, since the last
    :func:`reset_log_format_counts`."""
    return dict(_LOG_FORMATS)


def reset_log_format_counts():
    for k in _LOG_FORMATS:
        _LOG_FORMATS[k] = 0


def _log_text(v):
    """``str(v)``, printed once per distinct content for a plain numeric
    ndarray that numpy prints in full (at most `threshold` elements, no
    custom formatter); every other value is printed by ``str()``."""
    opts = np.get_printoptions()
    if (type(v) is not np.ndarray or v.dtype.kind not in "biufc" or opts["formatter"] is not None
            or v.size > min(opts["threshold"], _LOG_TEXT_SIZE)):
        _LOG_FORMATS["direct"] += 1
        return str(v)
    key = (v.dtype.str, v.shape, v.tobytes(), tuple(opts.items()))
    text = _LOG_TEXT.get(key)
    if text is not None:
        _LOG_FORMATS["cached"] += 1
        return text
    _LOG_FORMATS["formatted"] += 1
    text = str(v)
    if len(_LOG_TEXT) >= _LOG_TEXT_ENTRIES:
        _LOG_TEXT.pop(next(iter(_LOG_TEXT)), None)
    _LOG_TEXT[key] = text
    return text


def _device_cache_put(key, chunks, nbytes):
    if DEVICE_CACHE_BYTES <= 0 or nbytes > DEVICE_CACHE_BYTES:
        return
    while _DEVICE_CACHE_ORDER and _DEVICE_CACHE_SIZE[0] + nbytes > DEVICE_CACHE_BYTES:
        old = _DEVICE_CACHE_ORDER.pop(0)
        _, old_bytes = _DEVICE_CACHE.pop(old)
        _DEVICE_CACHE_SIZE[0] -= old_bytes
    _DEVICE_CACHE[key] = (chunks, nbytes)
    _DEVICE_CACHE_ORDER.append(key)
    _DEVICE_CACHE_SIZE[0] += nbytes


def _device_cache_get(key):
    entry = _DEVICE_CACHE.get(key)
    if entry is None:
        return None
    _DEVICE_CACHE_ORDER.remove(key)
    _DEVICE_CACHE_ORDER.append(key)
    return entry[0]


def clear_device_cache():
    """Empty the device trial store and read every device-resident result
    back to the host (resident payloads are materialized first, never
    lost)."""
    _resident.materialize_all()
    _DEVICE_CACHE.clear()
    _DEVICE_CACHE_ORDER.clear()
    _DEVICE_CACHE_SIZE[0] = 0


def _dispatch_with_recovery(thunk, what="device dispatch"):
    """Run `thunk`; on a device out-of-memory error, empty the trial store,
    read the resident results back, release the allocator's cached blocks
    and run it once more on the same device. Every other error, and a
    second out-of-memory error, propagates."""
    try:
        return thunk()
    except torch.OutOfMemoryError:
        get_logger().warning(
            "%s: device out of memory; emptying the trial store and reading the "
            "resident results back, then retrying once", what)
    clear_device_cache()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return thunk()


def _allocate_host_output(shape, dtype, owner):
    """Host target of a stacked result: RAM, or a disk-backed HDF5 dataset
    when it exceeds DEFAULT_HOST_BUDGET (used by the eager readback and
    the deferred one; reference preallocate_output,
    computational_routine.py:750-804). Over budget without h5py it
    raises: the result never quietly falls back to RAM."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes <= DEFAULT_HOST_BUDGET:
        return np.empty(shape, dtype=dtype)
    try:
        import h5py
    except ImportError:
        raise SPYError(
            "a result of {} bytes exceeds the host budget of {} bytes "
            "(engine.routine.DEFAULT_HOST_BUDGET); spilling it to a disk-backed "
            "HDF5 dataset needs the h5py package, which is not "
            "installed".format(nbytes, DEFAULT_HOST_BUDGET)) from None
    if owner is None or not hasattr(owner, "filename"):
        raise SPYError(
            "a result of {} bytes exceeds the host budget of {} bytes and its "
            "target cannot hold an HDF5 file".format(nbytes, DEFAULT_HOST_BUDGET))
    import os

    from ..datatype.util import gen_session_filename

    fname = owner.filename
    # never truncate a file that already holds data (a reused output
    # object, or a payload another dataset handle still points into):
    # spill to a fresh session file and re-point the object
    holds_data = (
        owner._hdfFile is not None
        or isinstance(getattr(owner, "_data", None), h5py.Dataset)
        or (os.path.exists(fname) and os.path.getsize(fname) > 0)
    )
    if holds_data:
        fname = gen_session_filename(os.path.splitext(fname)[1] or ".dat")
        owner._filename = fname
    f = h5py.File(fname, "w")
    dset = f.create_dataset("data", shape=shape, dtype=dtype)
    owner._hdfFile = f
    owner._is_temp_file = True
    return dset


def _nbytes(tensor):
    """Bytes of a tensor; 0 for None (another process's shard)."""
    return 0 if tensor is None else tensor.numel() * tensor.element_size()


def _torch_dtype(dtype):
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _shard_rows(n_valid, rows, n_shard):
    """The valid rows of each of `n_shard` blocks of `rows` rows in a
    chunk of `n_valid` real trials, clipped to ``[0, rows]``."""
    return [min(max(n_valid - i * rows, 0), rows) for i in range(n_shard)]


def _readback_rows(host_out, res, chunk_pos, offsets, sdim):
    """Copy one chunk's device results `res` into `host_out`: one copy
    into the rows of consecutive trials stacked on axis 0 of an
    in-memory output, else per trial (an HDF5 dataset takes the per-trial
    write)."""
    first, last = chunk_pos[0], chunk_pos[-1]
    if (sdim == 0 and last - first == len(chunk_pos) - 1
            and isinstance(host_out, np.ndarray)):
        dst = host_out[offsets[first] : offsets[last + 1]]
        torch.from_numpy(dst).copy_(res.reshape(dst.shape))
        _count_transfer("d2h", dst.nbytes)
        return
    arr = res.cpu().numpy()
    _count_transfer("d2h", arr.nbytes)
    for i, pos in enumerate(chunk_pos):
        sl = [slice(None)] * (arr.ndim - 1)
        sl[sdim] = slice(int(offsets[pos]), int(offsets[pos + 1]))
        host_out[tuple(sl)] = arr[i]


def _materialize_resident(resident):
    """Readback of a :class:`DeviceResident`: the stacked host output from
    its records, one copy a record where its trials are consecutive on
    stacking dim 0."""
    host_out = _allocate_host_output(resident.shape, resident.dtype, resident._owner())
    for rec in resident.records:
        for shard, positions in _resident.shard_positions(rec):
            _readback_rows(host_out, shard, list(positions), resident.offsets,
                           resident.stackingdim)
    return host_out


#: the device every engine entry point computes on (see set_device)
_device = torch.device("cuda", 0)


def set_device(device):
    """
    Set the device the port computes on: ``"cuda:0"`` (the default) or
    another CUDA device, or ``"cpu"``, where every kernel takes its plain
    PyTorch version. Returns the previous setting.
    """
    global _device
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError("the port runs on cpu or cuda, not {}".format(device))
    previous, _device = _device, device
    return previous


def default_device():
    """
    The device of the setting (:func:`set_device`). A CUDA setting with no
    card present raises RuntimeError: the port never falls back to the CPU
    unless asked.
    """
    if _device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for the port's default device {}; call "
            "syncopy_tpu_torch.set_device(\"cpu\") to compute on the CPU".format(_device))
    return _device


def chunk_trials(per_trial_bytes, n_trials, budget=None):
    """Trials per chunk: the byte budget over the per-trial bytes, capped
    at MAX_CHUNK_TRIALS, rounded down to a power of two and no larger than
    the next power of two above `n_trials`. The size is fixed for a whole
    bucket; the last chunk is zero-padded and masked by n_valid. It
    depends on nothing else (no free-memory reading), so every rank of a
    cluster plans the same chunks and issues the same collectives."""
    budget = DEFAULT_CHUNK_BUDGET if budget is None else budget
    chunk = max(1, int(budget // max(per_trial_bytes, 1)))
    chunk = min(chunk, MAX_CHUNK_TRIALS)
    chunk = 1 << (chunk.bit_length() - 1)
    return min(chunk, 1 << (max(n_trials, 1) - 1).bit_length())


def take_labels(labels, indexer):
    """The labels a selector's indexer (None, a slice or indices) keeps."""
    labels = np.asarray(labels)
    if indexer is None:
        return labels
    if isinstance(indexer, slice):
        return labels[indexer]
    return labels[np.asarray(indexer, dtype=int)]


class ComputationalRoutine:
    """
    Base class of all compute routines.

    Subclasses implement:

    ``output_trial_shape(trial_shape)``
        ``(shape, numpy dtype)`` of one trial's output for an input trial
        of `trial_shape` and dtype ``self.in_dtype`` (the rule the JAX
        engine derives by tracing).

    ``process_single_trial(trial, **cfg)``
        One (selected) trial tensor to one output tensor.

    ``process_metadata(data, out)``
        Attach dimensional properties and the output trialdefinition.

    Optionally ``process_batch_sum(batch, n_valid, *aux, **cfg)``: the sum
    over the first `n_valid` trials of a padded batch, the engine's fused
    path for ``keeptrials=False``.

    Optionally ``device_bytes_per_trial(trial_shape, out_shape, out_dtype)``:
    the device workspace one trial needs beyond its input and output (an
    FFT bank's intermediates, say); chunks are sized by the larger of the
    two (reference :929-942).

    Optionally ``per_trial_inputs(data, trial_positions)``: a tuple of
    numpy arrays with leading axis ``len(trial_positions)``, one row per
    trial. Each chunk uploads its rows with the batch (a broadcast view,
    leading stride 0, uploads one row and expands it on the device), and
    ``process_single_trial``, ``process_batch`` and ``process_batch_sum``
    take them after the trial, batch or `n_valid`, in the order returned.
    A padded batch's padding rows get zeros.

    ``process_single_trial`` may also return ``(result, info)``, an info
    dict of diagnostics. Its keys in :attr:`aux_per_trial` hold one value
    per trial and are collected by selected-trial position; other keys
    are per chunk. After ``compute`` they are in ``self.aux_info``.

    On a mesh with more than one channel position, :attr:`channel_split`
    says how the routine's input channels split (only where they divide
    evenly; None keeps them whole):

    ``"separable"``
        The per-trial work is independent per channel: each channel
        position computes its slice of the batch, and the results are
        concatenated on the trial shard's first position along the last
        axis, where such a routine's output keeps its channels. Info
        dicts of boolean flags combine by "any".

    ``"cross"``
        ``channel_stage(batch, **cfg)`` is the per-channel stage (channels
        on its last axis); it runs on the channel positions, its pieces
        are gathered on the trial shard's first position and
        ``process_batch_staged(stage, *aux, **cfg)`` or
        ``process_batch_sum_staged(stage, n_valid, *aux, **cfg)`` finish
        there, as ``process_batch`` and ``process_batch_sum`` do on the
        whole batch.

    :meth:`channel_split_allowed` may keep a run's channels whole.
    """

    outputShape = None
    dtype = None

    #: aux-info keys with one value per trial (see the class docstring)
    aux_per_trial = frozenset()

    #: False keeps a chunk whole on the mesh's first position: for a
    #: routine whose rows depend on each other within a chunk
    trial_split = True

    #: how a mesh's channel axis splits the routine (see the class docstring)
    channel_split = None

    def __init__(self, **cfg):
        self.cfg = dict(cfg)
        self.keeptrials = True
        self.aux_info = {}
        self.buckets = None
        self.out_per_trial_shapes = None
        self.selector = None
        self._chunk_budget = DEFAULT_CHUNK_BUDGET
        self.device = default_device()

    # ------------------------------------------------------------------ #
    # subclass interface
    # ------------------------------------------------------------------ #

    def output_trial_shape(self, trial_shape):
        raise NotImplementedError

    def process_single_trial(self, trial, *aux, **cfg):
        raise NotImplementedError

    def per_trial_inputs(self, data, trial_positions):
        return ()

    def device_bytes_per_trial(self, trial_shape, out_shape, out_dtype):
        return 0

    def process_batch(self, batch, *aux, **cfg):
        """The per-trial results of `batch` stacked, and, where the trial
        step returns ``(result, info)``, the info values stacked per key."""
        results = [self.process_single_trial(t, *(a[i] for a in aux), **cfg)
                   for i, t in enumerate(batch)]
        if not isinstance(results[0], tuple):
            return torch.stack(results, dim=0)
        info = {k: torch.stack([torch.as_tensor(r[1][k]) for r in results], dim=0)
                for k in results[0][1]}
        return torch.stack([r[0] for r in results], dim=0), info

    def channel_split_allowed(self):
        """False keeps this run's channels whole on a mesh with channel
        positions (see :attr:`channel_split`)."""
        return True

    def process_metadata(self, data, out):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # initialize: shape planning (reference computational_routine.py:240-511)
    # ------------------------------------------------------------------ #

    def initialize(self, data, out_stackingdim, keeptrials=True):
        with span("spt.engine.initialize"):
            from ..datatype.selector import Selector

            self.keeptrials = bool(keeptrials)
            self.out_stackingdim = int(out_stackingdim)

            self.selector = data.selection if data.selection is not None else Selector(data, None)
            n_sel = len(self.selector.trial_ids)
            if n_sel == 0:
                raise SPYValueError(legal="at least one selected trial", varname="trials",
                                    actual="0")

            sel = self.selector
            buckets = {}
            if sel.time_trivial:
                # whole trials differ only in the stacking-dim extent: bucket
                # the lengths in sampleinfo instead of indexing per trial
                _PLANS["vectorized"] += 1
                lens = np.diff(data.sampleinfo[np.asarray(sel.trial_ids, dtype=np.intp)],
                               axis=1)[:, 0]
                uniq, first, inverse = np.unique(lens, return_index=True, return_inverse=True)
                # each length's positions, ascending
                groups = np.split(np.argsort(inverse, kind="stable"),
                                  np.cumsum(np.bincount(inverse))[:-1])
                taxis = data.dimord.index("time")
                shape = list(self._selected_trial_shape(data, 0))
                for u in np.argsort(first):  # lengths in order of first appearance
                    shape[taxis] = int(uniq[u])
                    buckets[tuple(shape)] = groups[u].tolist()
            else:
                _PLANS["per_trial"] += 1
                for pos in range(n_sel):
                    buckets.setdefault(self._selected_trial_shape(data, pos), []).append(pos)
            # one chunk plan per bucket of identical shape
            self.buckets = buckets
            # the input dtype, for output rules that depend on it
            self.in_dtype = np.dtype(data.data.dtype)
            self.out_per_trial_shapes = {shp: self.output_trial_shape(shp) for shp in buckets}
            bucket_out = [oshp for oshp, _ in self.out_per_trial_shapes.values()]
            out_dtype = next(iter(self.out_per_trial_shapes.values()))[1]

            self._fast_plan = self._plan_fast_gather(data)

            if not self.keeptrials and len(set(bucket_out)) > 1:
                raise SPYValueError(
                    legal="identical trial shapes for trial averaging",
                    varname="keeptrials",
                    actual="shapes {}".format(sorted(set(bucket_out))),
                )

            sdim = self.out_stackingdim
            ref_other = [s for i, s in enumerate(bucket_out[0]) if i != sdim]
            for oshp in bucket_out[1:]:
                other = [s for i, s in enumerate(oshp) if i != sdim]
                if other != ref_other:
                    raise SPYValueError(
                        legal="matching non-stacking output dims across trials",
                        varname="output shape",
                        actual=str(sorted(set(bucket_out))),
                    )
            if self.keeptrials:
                total_stack = sum(oshp[sdim] * len(positions)
                                  for oshp, positions in zip(bucket_out, buckets.values()))
            else:
                total_stack = bucket_out[0][sdim]
            out_total = list(bucket_out[0])
            out_total[sdim] = total_stack
            self.outputShape = tuple(out_total)
            self.dtype = out_dtype
            bucket_of = np.empty(n_sel, dtype=np.intp)
            for b, positions in enumerate(buckets.values()):
                bucket_of[positions] = b
            self._per_trial_out_shapes_ordered = [bucket_out[b] for b in bucket_of.tolist()]
            self.numTrials = n_sel

    def _plan_fast_gather(self, data):
        """
        Vectorized host-gather plan: when the (selected) trials are whole
        time-slices of an in-memory array (or HDF5 dataset), one indexer
        serves them all and a whole chunk is assembled with ONE fancy
        gather. None for a time selection: each trial has its own.
        """
        from ..datatype.base_data import HDF5_DATASET

        sel = self.selector
        if not sel.time_trivial:
            return None
        is_hdf5 = isinstance(data.data, HDF5_DATASET)
        if not (isinstance(data.data, np.ndarray) or is_hdf5):
            return None
        if data._stackingDim != 0:
            return None
        si = data.sampleinfo[np.asarray(sel.trial_ids, dtype=np.intp)]
        return {"starts": si[:, 0], "lens": si[:, 1] - si[:, 0],
                "others": sel.trial_indexer(data, 0)[1:], "hdf5": is_hdf5}

    def _gather_batch(self, data, chunk_pos):
        """Assemble the (nTrials, ...) host batch for `chunk_pos`."""
        plan = getattr(self, "_fast_plan", None)
        if plan is not None:
            pos = np.asarray(chunk_pos)
            L = int(plan["lens"][pos[0]])
            starts = plan["starts"][pos]
            if np.all(np.diff(starts) == L):
                # trials back to back: one contiguous slice, a view of an
                # in-memory payload (no host copy; routines never write into
                # their batch) and one read through h5py
                arr = data.data[int(starts[0]) : int(starts[-1]) + L]
                batch = np.asarray(arr).reshape((len(pos), L) + data.data.shape[1:])
            elif plan["hdf5"]:
                # per-row fancy reads are slow through h5py
                batch = np.stack([data.data[int(s) : int(s) + L] for s in starts], axis=0)
            else:
                idx = starts[:, None] + np.arange(L)
                batch = data.data[idx]
            # original data axis k lands on batch axis k+1 (trial axis first)
            for ax, ind in enumerate(plan["others"], start=2):
                if isinstance(ind, slice):
                    full = ind == slice(None) or ind.indices(batch.shape[ax]) == (0, batch.shape[ax], 1)
                    if not full:
                        sl = (slice(None),) * ax + (ind,)
                        batch = batch[sl]
                else:
                    batch = np.take(batch, ind, axis=ax)
            return batch
        return np.stack(
            [self.selector.select_trial_array(data, p) for p in chunk_pos], axis=0
        )

    def _selected_trial_shape(self, data, pos):
        """Shape of the pos-th selected trial after applying the selection."""
        sel = self.selector
        tid = sel.trial_ids[pos]
        if "sample" in data.dimord:
            arr = sel.select_trial_array(data, pos)
            return tuple(arr.shape)
        raw_shape = list(data._trial_shape(tid))
        idx = sel.trial_indexer(data, pos)
        shp = []
        for ax, ind in enumerate(idx):
            n = raw_shape[ax]
            if isinstance(ind, slice):
                shp.append(len(range(*ind.indices(n))))
            else:
                shp.append(len(ind))
        return tuple(shp)

    # ------------------------------------------------------------------ #
    # compute (reference computational_routine.py:513-1035)
    # ------------------------------------------------------------------ #

    def compute(self, data, out, log_dict=None, post_device_fn=None, device_resident=True,
                parallel=None):
        """
        Run the routine on ``self.device``, or over the mesh that
        `parallel` resolves to (:func:`~syncopy_tpu_torch.parallel.mesh.
        resolve_parallel`: None takes the active mesh): each chunk's rows
        split into one block per trial shard, computed on that shard's
        device, and trial sums combined on the mesh's first position.
        `post_device_fn` is an optional device-side transform applied to
        the trial average when ``keeptrials=False`` (e.g. the coherence
        normalization); it may change the output's dtype.

        With `device_resident` (the default) a ``keeptrials=True`` result
        that fits ``resident.RESIDENT_BUDGET`` stays on the device(s) with
        a deferred readback (engine/resident.py); False reads it back.

        On a mesh that spans processes (:func:`~syncopy_tpu_torch.parallel.
        mesh.init_distributed`) every rank must make the same call on the
        same data: each computes the trial shards it owns and receives the
        others' results, and ends holding the whole result, equal on every
        rank. Such a run reads its result back within the call
        (`device_resident` does not apply): a deferred readback that one
        rank triggered alone would wait for the other ranks' rows forever.
        A routine with ``trial_split = False`` runs on the rank that owns
        the mesh's first position.
        """
        if self.buckets is None:
            raise SPYError("call initialize() before compute()")
        self.mesh = resolve_parallel(parallel)
        if self.mesh is not None and self.trial_split:
            grid, ranks = self.mesh.devices, self.mesh.ranks
        else:
            grid = np.empty((1, 1), dtype=object)
            grid[0, 0] = self.device if self.mesh is None else self.mesh.device
            ranks = np.full((1, 1), process_rank() if self.mesh is None else self.mesh.ranks[0, 0])
        #: the (trial shard, channel position) grid of devices of this run,
        #: and each position's owner rank
        self._grid, self._grid_ranks = grid, ranks
        #: shard results travel between processes (share_from); where this
        #: process adds the trial partials and receives the others' rows
        self._shared = self.mesh is not None and self.mesh.crosses_processes
        self._home = self.mesh.home_device() if self._shared else grid[0, 0]
        self._post_fn = post_device_fn
        self.aux_info = {}
        self._aux_per_trial = {}
        self._aux_chunked = {}
        self._resident_mode = self._decide_resident(device_resident)
        self._run(data, out)
        with span("spt.engine.finalize"):
            self._finalize_aux()
            self.write_log(data, out, log_dict)
            self.process_metadata(data, out)
            # seal after process_metadata: the trialdefinition assignment bumps
            # the owner's cache token, and consumers match the sealed value
            if getattr(out, "_device_resident", None) is not None:
                out._device_resident.seal()

    def _decide_resident(self, device_resident):
        """Should this run keep its per-trial results on the device? Only a
        kept result within the resident budget, once older residents have
        made room."""
        if not (device_resident and self.keeptrials) or self._shared:
            return False
        est = int(np.prod(self.outputShape)) * np.dtype(self.dtype).itemsize
        return est <= _resident.RESIDENT_BUDGET and _admit(est)

    def _accumulate_aux(self, aux_info, chunk_pos):
        """Collect one chunk's info dict, read back to the host: keys in
        :attr:`aux_per_trial` by selected-trial position (their leading
        axis is the chunk's valid trials), the others per chunk."""
        for k, v in aux_info.items():
            arr = torch.as_tensor(v).cpu().numpy()
            _count_transfer("d2h_aux", arr.nbytes)
            if k in self.aux_per_trial:
                if arr.ndim < 1 or arr.shape[0] != len(chunk_pos):
                    raise SPYError(
                        "{}: aux key '{}' is declared per-trial but its leading axis is {} "
                        "({} trials in the chunk)".format(
                            self.__class__.__name__, k, arr.shape[:1] or "scalar",
                            len(chunk_pos)))
                per_trial = self._aux_per_trial.setdefault(k, {})
                for i, pos in enumerate(chunk_pos):
                    per_trial[pos] = arr[i]
            else:
                self._aux_chunked.setdefault(k, []).append(arr)

    def _finalize_aux(self):
        """``self.aux_info``: per-trial values stacked in selected-trial
        order, per-chunk values along a leading chunk axis (unwrapped for
        a single chunk)."""
        aux = {k: np.stack([rows[p] for p in sorted(rows)], axis=0)
               for k, rows in self._aux_per_trial.items()}
        for k, chunks in self._aux_chunked.items():
            aux.setdefault(k, chunks[0] if len(chunks) == 1 else np.stack(chunks, axis=0))
        self.aux_info = aux

    def _chunk_size(self, shp, n_positions, itemsize, aux_bytes=0):
        """Trials per chunk for input trials of shape `shp`, from the
        per-trial input, auxiliary input and output bytes, or the
        routine's device workspace where that is larger (see
        :func:`chunk_trials`)."""
        in_bytes = int(np.prod(shp)) * itemsize + aux_bytes
        out_shp, out_dt = self.out_per_trial_shapes[shp]
        out_bytes = int(np.prod(out_shp)) * np.dtype(out_dt).itemsize
        if not self.keeptrials and hasattr(self, "process_batch_sum"):
            out_bytes = 0  # fused reduction: per-trial outputs never exist
        per_trial = max((in_bytes + out_bytes) * 2,
                        int(self.device_bytes_per_trial(shp, out_shp, np.dtype(out_dt))))
        return chunk_trials(per_trial, n_positions, self._chunk_budget)

    def _upload_aux(self, arr, c0, n_valid, n_rows, device=None):
        """Rows ``c0 .. c0 + n_valid`` of one auxiliary input on `device`
        (default ``self.device``), zero-padded to `n_rows`. A broadcast
        view (leading stride 0) uploads one row, expanded on the device."""
        device = self.device if device is None else device
        if n_valid == 0:
            return torch.zeros((n_rows,) + arr.shape[1:], dtype=_torch_dtype(arr.dtype),
                               device=device)
        if arr.shape[0] and arr.strides[0] == 0:
            row = torch.from_numpy(np.array(arr[c0 : c0 + 1])).to(device)
            rows = row.expand((n_valid,) + row.shape[1:])
        else:
            row = torch.from_numpy(np.array(arr[c0 : c0 + n_valid]))
            rows = row.to(device)
        _count_transfer("h2d_aux", row.numel() * row.element_size())
        if n_rows > n_valid:
            pad = torch.zeros((n_rows - n_valid,) + rows.shape[1:], dtype=rows.dtype,
                              device=rows.device)
            rows = torch.cat([rows, pad], dim=0)
        return rows

    def _selection_fingerprint(self, data):
        """Hashable description of the selection's gather plan, for the
        trial-store key. None (the store is bypassed for this run) when
        the selection cannot be fingerprinted; the bypass is logged once
        per process."""
        sel = self.selector
        plan = getattr(self, "_fast_plan", None)
        try:
            with np.printoptions(threshold=sys.maxsize):
                if plan is not None:
                    # the plan's trials share one indexer; a digest, not
                    # hash(), so that every process derives the same key
                    digest = hashlib.blake2b(digest_size=16)
                    for part in (sel.trial_ids, plan["starts"], plan["lens"]):
                        digest.update(np.ascontiguousarray(part, dtype=np.int64).tobytes())
                    digest.update(repr(sel.trial_indexer(data, 0)).encode())
                    return digest.hexdigest()
                parts = [tuple(sel.trial_ids)]
                for k in range(len(sel.trial_ids)):
                    parts.append(repr(sel.trial_indexer(data, k)))
            return hash(tuple(parts))
        except Exception as exc:
            global _FINGERPRINT_BYPASS_LOGGED
            if not _FINGERPRINT_BYPASS_LOGGED:
                _FINGERPRINT_BYPASS_LOGGED = True
                get_logger().warning(
                    "%s: the selection cannot be fingerprinted (%s); the device trial "
                    "store is bypassed for this run (repeated analyses upload their "
                    "inputs again)", self.__class__.__name__, repr(exc)[:120])
            return None

    def _plan_resident_consume(self, data):
        """``{bucket shape: [Record, ...]}`` when `data`'s payload is a
        sealed device-resident result on this run's device type, no
        selection is active and the records cover every bucket in order;
        None otherwise (the host path). A producer chunk that is not a
        multiple of this run's trial shards also takes the host path (the
        JAX engine's rule, reference :887), and so does a run whose mesh
        spans processes."""
        res = getattr(data, "_device_resident", None)
        if (res is None or not res.consumable_by(data) or data.selection is not None
                or self._shared):
            return None
        n_shard = self._grid.shape[0]
        by_shape = {}
        for rec in res.records:
            if any(t.device.type != self.device.type for t in rec.shards):
                return None
            if rec.chunk % n_shard:
                return None
            by_shape.setdefault(rec.trial_shape, []).append(rec)
        plan = {}
        for shp, positions in self.buckets.items():
            recs = by_shape.get(shp)
            if recs is None or [p for r in recs for p in r.positions] != list(positions):
                return None
            plan[shp] = recs
        return plan

    def _resident_chunks(self, records, chunk, pad):
        """Chunks over the producer's resident records: a record larger
        than `chunk` is split on the device, and each chunk's rows go to
        this run's trial shards in blocks of ``chunk / n_shard`` rows,
        copied device to device where a block lies elsewhere (a block that
        is one whole record shard on its device is taken as it is); with
        `pad` each block is zero-padded to its full rows (the fused trial
        sum's fixed chunk). Yields ``(list of device blocks, positions)``."""
        n_shard = self._grid.shape[0]
        rows = chunk // n_shard
        for rec in records:
            for s0 in range(0, len(rec.positions), chunk):
                n = min(chunk, len(rec.positions) - s0)
                blocks = []
                with span("spt.engine.resident"):
                    for i, nv in enumerate(_shard_rows(n, rows, n_shard)):
                        device = self._grid[i, 0]
                        a = s0 + i * rows
                        block = _resident.take_rows(rec, a, a + nv, device)
                        if pad and nv < rows:
                            zeros = torch.zeros((rows - nv,) + tuple(block.shape[1:]),
                                                dtype=block.dtype, device=device)
                            block = torch.cat([block, zeros], dim=0)
                        blocks.append(block)
                yield blocks, list(rec.positions[s0 : s0 + n])

    def _upload_block(self, data, block_pos, rows, shp, in_dtype, device):
        """The trials at `block_pos` gathered, zero-padded to `rows` rows
        and uploaded to `device`."""
        with span("spt.engine.gather"):
            if block_pos:
                block = self._gather_batch(data, block_pos)
                if len(block_pos) < rows:
                    pad = np.zeros((rows - len(block_pos),) + block.shape[1:], block.dtype)
                    block = np.concatenate([block, pad], axis=0)
            else:
                block = np.zeros((rows,) + tuple(shp), in_dtype)  # an all-padding shard
            block = np.ascontiguousarray(block)
        with warnings.catch_warnings(), span("spt.engine.upload"):
            # a view of a read-back resident payload is read-only; the
            # tensor is only read
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            tensor = torch.from_numpy(block).to(device)
        _count_transfer("h2d", block.nbytes)
        return tensor

    def _host_chunks(self, data, positions, shp, chunk, plan):
        """Chunks over the host payload: each chunk's rows in one block per
        trial shard, each gathered, padded to the shard's rows and
        uploaded to its shard's device (a shard of another process: None,
        never gathered), with the uploads kept in the device trial store
        for later analyses of the same (selected) payload on the same
        mesh; `plan` (the bucket's chunk-plan entry) records which of the
        two it was. Yields ``(list of device blocks, positions)``."""
        in_dtype = np.dtype(data.data.dtype)
        grid = self._grid
        n_shard = grid.shape[0]
        rows = chunk // n_shard
        owned = self._grid_ranks[:, 0] == process_rank()
        with span("spt.engine.store_key"):
            cache_key = (
                getattr(data, "_cache_token", None),
                self._selection_fingerprint(data),
                shp,
                chunk,
                Mesh(grid, ranks=self._grid_ranks).key,
                str(in_dtype),
                tuple(positions),
            )
            cacheable = cache_key[0] is not None and cache_key[1] is not None
            cached = _device_cache_get(cache_key) if cacheable else None
        built = [] if (cached is None and cacheable and DEVICE_CACHE_BYTES > 0) else None
        plan["source"] = "trial store" if cached is not None else "upload"
        for k, c0 in enumerate(range(0, len(positions), chunk)):
            chunk_pos = positions[c0 : c0 + chunk]
            if cached is not None:
                yield cached[k], chunk_pos
                continue
            blocks = [self._upload_block(data, chunk_pos[i * rows : i * rows + nv], rows, shp,
                                         in_dtype, grid[i, 0]) if owned[i] else None
                      for i, nv in enumerate(_shard_rows(len(chunk_pos), rows, n_shard))]
            if built is not None:
                built.append(blocks)
                if sum(_nbytes(t) for bl in built for t in bl) > DEVICE_CACHE_BYTES:
                    built = None  # the store cannot hold the bucket: keep no chunk
            yield blocks, chunk_pos
        if built:
            _device_cache_put(cache_key, built, sum(_nbytes(t) for bl in built for t in bl))

    def _merge_channel_info(self, infos, device):
        """One info dict from the channel pieces' info dicts: boolean flags
        combine by "any"; other values cannot be combined and raise."""
        merged = {}
        for k in infos[0]:
            vals = [torch.as_tensor(info[k]).to(device) for info in infos]
            if vals[0].dtype != torch.bool:
                raise SPYError(
                    "{}: info key '{}' of a channel-split routine is not a flag".format(
                        self.__class__.__name__, k))
            merged[k] = torch.stack(vals, dim=0).any(dim=0)
        return merged

    def _shard_call(self, i, block, n_valid, aux, fused, chan_axis):
        """One trial shard's result on its first position: the fused sum of
        ``process_batch_sum`` over `block`'s first `n_valid` rows, or
        ``process_batch`` of `block`, with the channels split over the
        shard's channel positions where the routine declares it
        (:attr:`channel_split`) and they divide evenly."""
        devices = list(self._grid[i])
        home = devices[0]
        split = len(devices) > 1 and chan_axis is not None and \
            block.shape[chan_axis] % len(devices) == 0 and self.channel_split_allowed()
        cfg = self.cfg
        if split and self.channel_split == "cross":
            stages = []
            for piece, device in zip(block.chunk(len(devices), dim=chan_axis), devices):
                with device_context(device):
                    stages.append(self.channel_stage(piece.to(device).contiguous(), **cfg))
            stage = gather_shards(stages, home, dim=-1)
            with device_context(home):
                if fused:
                    return self.process_batch_sum_staged(stage, n_valid, *aux, **cfg)
                return self.process_batch_staged(stage, *aux, **cfg)
        if not (split and self.channel_split == "separable"):
            with device_context(home):
                if fused:
                    return self.process_batch_sum(block, n_valid, *aux, **cfg)
                return self.process_batch(block, *aux, **cfg)
        results = []
        for piece, device in zip(block.chunk(len(devices), dim=chan_axis), devices):
            piece = piece.to(device).contiguous()
            piece_aux = [a.to(device) for a in aux]
            with device_context(device):
                if fused:
                    results.append(self.process_batch_sum(piece, n_valid, *piece_aux, **cfg))
                else:
                    results.append(self.process_batch(piece, *piece_aux, **cfg))
        with device_context(home):
            if isinstance(results[0], tuple):
                res = gather_shards([r[0] for r in results], home, dim=-1)
                return res, self._merge_channel_info([r[1] for r in results], home)
            return gather_shards(results, home, dim=-1)

    def _shard_result(self, i, block, nv, aux_all, a0, rows, fused, chan_axis):
        """Trial shard `i`'s result on its device: the fused partial sum of
        its block, else its `nv` valid rows computed (``(rows, info)``
        where the routine returns info) and, without keeptrials, summed.
        The auxiliary inputs' rows start at `a0`."""
        device = self._grid[i, 0]
        n_aux = rows if fused else nv
        with span("spt.engine.dispatch"):
            res = _dispatch_with_recovery(
                lambda: self._shard_call(
                    i, block if fused else block[:nv], nv,
                    [self._upload_aux(a, a0, nv, n_aux, device) for a in aux_all], fused,
                    chan_axis),
                what="{} chunk dispatch".format(self.__class__.__name__))
            if fused or self.keeptrials:
                return res
            if isinstance(res, tuple):
                return res[0].sum(dim=0), res[1]
            return res.sum(dim=0)

    def _run(self, data, out):
        sdim = self.out_stackingdim
        fused_sum = not self.keeptrials and hasattr(self, "process_batch_sum")
        resident_out = bool(getattr(self, "_resident_mode", False))
        stack_lens = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
        offsets = np.concatenate([[0], np.cumsum(stack_lens)]).astype(int)
        host_out = None
        if self.keeptrials and not resident_out:
            with span("spt.engine.readback"):
                host_out = _allocate_host_output(self.outputShape, self.dtype, out)

        consume_plan = self._plan_resident_consume(data)
        if consume_plan is None:
            if isinstance(getattr(data, "_data", None), DeferredArray):
                # resident but not consumable here (a selection, a mutation,
                # a shape, device type or shard-count mismatch): read it back
                # once
                data._data._ensure()
            if getattr(self, "_fast_plan", None) is None:
                # the plan of initialize() saw a DeferredArray, or this
                # run's admission read the input back since: plan the host
                # path's vectorized gather on the payload now in place
                self._fast_plan = self._plan_fast_gather(data)

        grid = self._grid
        n_shard = grid.shape[0]
        owned = self._grid_ranks[:, 0] == process_rank()
        # the batch axis of the input's channels, for a channel split
        chan_axis = data.dimord.index("channel") + 1 if "channel" in data.dimord else None
        out_dtype = _torch_dtype(self.dtype) if self.keeptrials else None
        #: per bucket: its trial shape, chunk size, where its chunks came
        #: from ("resident", "upload" or "trial store"), their valid rows
        #: and each chunk's valid rows per trial shard
        self.chunk_plan = []
        records = []
        acc = None  # on-device sum over trials for keeptrials=False
        itemsize = np.dtype(data.data.dtype).itemsize
        for shp, positions in self.buckets.items():
            aux_all = tuple(np.asarray(a) for a in self.per_trial_inputs(data, positions))
            aux_bytes = sum(int(np.prod(a.shape[1:])) * a.itemsize for a in aux_all)
            chunk = self._chunk_size(shp, len(positions), itemsize, aux_bytes)
            # a whole number of rows for every trial shard (reference :943-950)
            chunk = pad_to_multiple(max(chunk, n_shard), n_shard)
            rows = chunk // n_shard
            plan = {"shape": shp, "chunk": chunk, "source": "resident", "rows": [],
                    "shard_rows": []}
            self.chunk_plan.append(plan)
            if consume_plan is not None:
                source = self._resident_chunks(consume_plan[shp], chunk, pad=fused_sum)
            else:
                source = self._host_chunks(data, positions, shp, chunk, plan)
            pos_index = {p: i for i, p in enumerate(positions)}
            out_shp = self.out_per_trial_shapes[shp][0]
            for blocks, chunk_pos in source:
                n_valid = len(chunk_pos)
                c0 = pos_index[chunk_pos[0]]
                shard_valid = _shard_rows(n_valid, rows, n_shard)
                plan["rows"].append(n_valid)
                plan["shard_rows"].append(shard_valid)
                part, shards = None, []
                for i, (block, nv) in enumerate(zip(blocks, shard_valid)):
                    # every shard of a fused sum launches, an all-padding
                    # one with n_valid = 0; otherwise those that hold rows
                    if not (fused_sum or nv):
                        continue
                    res = aux_info = None
                    if owned[i]:
                        res = self._shard_result(i, block, nv, aux_all, c0 + i * rows, rows,
                                                 fused_sum, chan_axis)
                        if isinstance(res, tuple):
                            res, aux_info = res
                    if self._shared:
                        # the owner's result on every rank: the partial where
                        # the shards are summed, the rows on the host
                        res, aux_info = share_from(
                            res, int(self._grid_ranks[i, 0]),
                            self._home if not self.keeptrials else "cpu",
                            info=None if aux_info is None else {
                                k: torch.as_tensor(v).cpu().numpy() for k, v in aux_info.items()})
                    shard_pos = chunk_pos[i * rows : i * rows + nv]
                    if aux_info is not None:
                        self._accumulate_aux(aux_info, shard_pos)
                    if not self.keeptrials:
                        part = res if part is None else part + res.to(part.device)
                    elif resident_out:
                        # the host route rounds to the output dtype on the
                        # way back and hands the next routine a contiguous
                        # batch; the record does the same, so a consumer
                        # computes the same values on either route (and a
                        # view pins no larger buffer)
                        shards.append(
                            res.to(out_dtype).reshape((nv,) + tuple(out_shp)).contiguous())
                    else:
                        with span("spt.engine.readback"):
                            _readback_rows(host_out, res, shard_pos, offsets, sdim)
                if part is not None:
                    # the trial shards' partials, summed in shard order on
                    # the mesh's first position, or on each rank's home
                    # position where the mesh spans processes (JAX's psum)
                    acc = part if acc is None else acc + part
                if shards:
                    records.append(Record(tuple(chunk_pos), tuple(shards), tuple(out_shp), chunk))

        if not self.keeptrials:
            avg = acc / self.numTrials
            if self._post_fn is not None:
                with device_context(avg.device), span("spt.engine.post"):
                    avg = self._post_fn(avg)
            self.outputShape = tuple(avg.shape)
            self.dtype = np.dtype(str(avg.dtype).replace("torch.", ""))
            with span("spt.engine.readback"):
                host_out = _allocate_host_output(self.outputShape, self.dtype, out)
                if isinstance(host_out, np.ndarray):
                    torch.from_numpy(host_out).copy_(avg)
                else:
                    host_out[...] = avg.cpu().numpy()
            _count_transfer("d2h", avg.numel() * avg.element_size())
        elif resident_out:
            res = DeviceResident(records, self.outputShape, self.dtype, offsets, sdim,
                                 _materialize_resident, out)
            out._bump_cache_token()
            out._device_resident = res
            out._data = DeferredArray(res)
            return
        out.data = host_out

    def default_trialdefinition(self, data, out):
        """The output trialdefinition: one row per selected trial (one for
        a trial average) over the stacked output rows, offsets 0
        (reference :1285)."""
        stack_lens = [oshp[self.out_stackingdim] for oshp in self._per_trial_out_shapes_ordered]
        if not self.keeptrials:
            stack_lens = stack_lens[:1]
        bounds = np.concatenate([[0], np.cumsum(stack_lens)])
        trl = np.zeros((len(stack_lens), 3))
        trl[:, 0] = bounds[:-1]
        trl[:, 1] = bounds[1:]
        return trl

    def propagate_properties(self, data, out):
        """Carry the sampling rate and the (selected) channel labels over
        to the output (reference :1300)."""
        if hasattr(out, "samplerate") and getattr(data, "samplerate", None) is not None:
            out.samplerate = data.samplerate
        if "channel" in out.dimord and "channel" in data.dimord and data.channel is not None:
            chan = take_labels(data.channel, getattr(self.selector, "channel", None))
            if out.data is not None and out.data.shape[out.dimord.index("channel")] == chan.size:
                out.channel = chan

    # ------------------------------------------------------------------ #
    # provenance
    # ------------------------------------------------------------------ #

    def write_log(self, data, out, log_dict=None):
        """Attach a human-readable processing record (reference :1037)."""
        out._log = str(data._log)
        logOpts = ""
        if log_dict:
            maxlen = max(len(str(k)) for k in log_dict)
            for k, v in log_dict.items():
                logOpts += "\n\t{0:<{w}} : {1}".format(str(k), _log_text(v), w=maxlen)
        out.log = "computed {name} with settings{opts}".format(
            name=self.__class__.__name__, opts=logOpts or " (defaults)"
        )
