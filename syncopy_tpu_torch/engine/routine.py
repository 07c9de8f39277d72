# -*- coding: utf-8 -*-
#
# ComputationalRoutine: the compute engine (main-path subset).
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
#     :921-999): each chunk uploads its rows with the batch.
# Left out, as workarounds for the TPU runtime: the (re, im) complex
# encoding, the readback relayout, dispatch retries and compile back-off,
# f16 transfer/readback, the device trial store, device-resident outputs
# and the mesh. Results are read back once, in full.

import numpy as np
import torch

from ..shared.errors import SPYError, SPYValueError

__all__ = ["ComputationalRoutine", "chunk_trials", "default_device", "set_device"]

#: device-memory budget per compute chunk (bytes)
DEFAULT_CHUNK_BUDGET = 2 * 1024**3

#: hard cap on trials per compute chunk
MAX_CHUNK_TRIALS = 1024


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
    bucket; the last chunk is zero-padded and masked by n_valid."""
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
    """

    outputShape = None
    dtype = None

    #: aux-info keys with one value per trial (see the class docstring)
    aux_per_trial = frozenset()

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

    def process_metadata(self, data, out):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # initialize: shape planning (reference computational_routine.py:240-511)
    # ------------------------------------------------------------------ #

    def initialize(self, data, out_stackingdim, keeptrials=True):
        from ..datatype.selector import Selector

        self.keeptrials = bool(keeptrials)
        self.out_stackingdim = int(out_stackingdim)

        self.selector = data.selection if data.selection is not None else Selector(data, None)
        n_sel = len(self.selector.trial_ids)
        if n_sel == 0:
            raise SPYValueError(legal="at least one selected trial", varname="trials", actual="0")

        sel = self.selector
        tsel = getattr(sel, "time", None)
        trivial_time = tsel is None or all(t == slice(None) for t in tsel)
        if "sample" not in data.dimord and trivial_time:
            # without a time selection trials differ only in the stacking-dim
            # extent: vectorize over sampleinfo instead of indexing per trial
            si = data.sampleinfo
            lens = (si[:, 1] - si[:, 0]).astype(np.int64)
            taxis = data.dimord.index("time")
            base = list(self._selected_trial_shape(data, 0))
            shapes = []
            for tid in sel.trial_ids:
                s = base.copy()
                s[taxis] = int(lens[tid])
                shapes.append(tuple(s))
        else:
            shapes = [self._selected_trial_shape(data, k) for k in range(n_sel)]

        # bucket positions by identical shape: one chunk plan per bucket
        buckets = {}
        for pos, shp in enumerate(shapes):
            buckets.setdefault(shp, []).append(pos)
        self.buckets = buckets
        # the input dtype, for output rules that depend on it
        self.in_dtype = np.dtype(data.data.dtype)
        self.out_per_trial_shapes = {shp: self.output_trial_shape(shp) for shp in buckets}
        out_dtype = next(iter(self.out_per_trial_shapes.values()))[1]

        self._fast_plan = self._plan_fast_gather(data)

        out_shapes = [self.out_per_trial_shapes[shp][0] for shp in shapes]
        if not self.keeptrials and len(set(out_shapes)) > 1:
            raise SPYValueError(
                legal="identical trial shapes for trial averaging",
                varname="keeptrials",
                actual="shapes {}".format(sorted(set(out_shapes))),
            )

        sdim = self.out_stackingdim
        ref_other = [s for i, s in enumerate(out_shapes[0]) if i != sdim]
        for oshp in out_shapes[1:]:
            other = [s for i, s in enumerate(oshp) if i != sdim]
            if other != ref_other:
                raise SPYValueError(
                    legal="matching non-stacking output dims across trials",
                    varname="output shape",
                    actual=str(sorted(set(out_shapes))),
                )
        if self.keeptrials:
            total_stack = sum(oshp[sdim] for oshp in out_shapes)
        else:
            total_stack = out_shapes[0][sdim]
        out_total = list(out_shapes[0])
        out_total[sdim] = total_stack
        self.outputShape = tuple(out_total)
        self.dtype = out_dtype
        self._per_trial_out_shapes_ordered = out_shapes
        self.numTrials = n_sel

    def _plan_fast_gather(self, data):
        """
        Vectorized host-gather plan: when the (selected) trials are plain
        time-slices of an in-memory array with identical per-dimension
        indexers, a whole chunk is assembled with ONE fancy gather.
        """
        from ..datatype.base_data import HDF5_DATASET

        sel = self.selector
        if "sample" in data.dimord:
            return None
        is_hdf5 = isinstance(data.data, HDF5_DATASET)
        if not (isinstance(data.data, np.ndarray) or is_hdf5):
            return None
        if data._stackingDim != 0:
            return None
        others_ref = None
        starts, lens = [], []
        for k, tid in enumerate(sel.trial_ids):
            ind = sel.trial_indexer(data, k)
            tind = ind[0]
            if not (isinstance(tind, slice) and tind == slice(None)):
                return None
            others = tuple(
                (o.start, o.stop, o.step) if isinstance(o, slice) else tuple(o) for o in ind[1:]
            )
            if others_ref is None:
                others_ref = others
                others_raw = ind[1:]
            elif others != others_ref:
                return None
            start, stop = data.sampleinfo[tid]
            starts.append(int(start))
            lens.append(int(stop - start))
        return {
            "starts": np.asarray(starts),
            "lens": np.asarray(lens),
            "others": others_raw,
            "hdf5": is_hdf5,
        }

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

    def compute(self, data, out, log_dict=None, post_device_fn=None):
        """
        Run the routine on ``self.device`` (one device: the JAX engine's
        mesh has no counterpart here). `post_device_fn` is an optional
        device-side transform applied to the trial average when
        ``keeptrials=False`` (e.g. the coherence normalization); it may
        change the output's dtype.
        """
        if self.buckets is None:
            raise SPYError("call initialize() before compute()")
        self._post_fn = post_device_fn
        self.aux_info = {}
        self._aux_per_trial = {}
        self._aux_chunked = {}
        self._run(data, out)
        self._finalize_aux()
        self.write_log(data, out, log_dict)
        self.process_metadata(data, out)

    def _accumulate_aux(self, aux_info, chunk_pos):
        """Collect one chunk's info dict, read back to the host: keys in
        :attr:`aux_per_trial` by selected-trial position (their leading
        axis is the chunk's valid trials), the others per chunk."""
        for k, v in aux_info.items():
            arr = torch.as_tensor(v).cpu().numpy()
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

    def _upload_aux(self, arr, c0, n_valid, n_rows):
        """Rows ``c0 .. c0 + n_valid`` of one auxiliary input on the device,
        zero-padded to `n_rows`. A broadcast view (leading stride 0) uploads
        one row, expanded on the device."""
        if arr.shape[0] and arr.strides[0] == 0:
            row = torch.from_numpy(np.array(arr[c0 : c0 + 1])).to(self.device)
            rows = row.expand((n_valid,) + row.shape[1:])
        else:
            rows = torch.from_numpy(np.array(arr[c0 : c0 + n_valid])).to(self.device)
        if n_rows > n_valid:
            pad = torch.zeros((n_rows - n_valid,) + rows.shape[1:], dtype=rows.dtype,
                              device=rows.device)
            rows = torch.cat([rows, pad], dim=0)
        return rows

    def _run(self, data, out):
        sdim = self.out_stackingdim
        fused_sum = not self.keeptrials and hasattr(self, "process_batch_sum")
        host_out = None
        if self.keeptrials:
            host_out = np.empty(self.outputShape, dtype=self.dtype)
            stack_lens = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
            offsets = np.concatenate([[0], np.cumsum(stack_lens)]).astype(int)

        acc = None  # on-device sum over trials for keeptrials=False
        itemsize = np.dtype(data.data.dtype).itemsize
        for shp, positions in self.buckets.items():
            aux_all = tuple(np.asarray(a) for a in self.per_trial_inputs(data, positions))
            aux_bytes = sum(int(np.prod(a.shape[1:])) * a.itemsize for a in aux_all)
            chunk = self._chunk_size(shp, len(positions), itemsize, aux_bytes)
            for c0 in range(0, len(positions), chunk):
                chunk_pos = positions[c0 : c0 + chunk]
                n_valid = len(chunk_pos)
                batch = self._gather_batch(data, chunk_pos)
                if n_valid < chunk:
                    pad = np.zeros((chunk - n_valid,) + batch.shape[1:], batch.dtype)
                    batch = np.concatenate([batch, pad], axis=0)
                dev_batch = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)

                if fused_sum:
                    aux = [self._upload_aux(a, c0, n_valid, chunk) for a in aux_all]
                    res = self.process_batch_sum(dev_batch, n_valid, *aux, **self.cfg)
                    acc = res if acc is None else acc + res
                    continue
                aux = [self._upload_aux(a, c0, n_valid, n_valid) for a in aux_all]
                res = self.process_batch(dev_batch[:n_valid], *aux, **self.cfg)
                if isinstance(res, tuple):
                    res, aux_info = res
                    self._accumulate_aux(aux_info, chunk_pos)
                if not self.keeptrials:
                    res = res.sum(dim=0)
                    acc = res if acc is None else acc + res
                    continue
                first, last = chunk_pos[0], chunk_pos[-1]
                if sdim == 0 and last - first == n_valid - 1:
                    # consecutive trials stacked along axis 0: one copy from
                    # the device into their rows of the output
                    dst = host_out[offsets[first] : offsets[last + 1]]
                    torch.from_numpy(dst).copy_(res.reshape(dst.shape))
                    continue
                arr = res.cpu().numpy()
                for i, pos in enumerate(chunk_pos):
                    sl = [slice(None)] * (arr.ndim - 1)
                    sl[sdim] = slice(offsets[pos], offsets[pos + 1])
                    host_out[tuple(sl)] = arr[i]

        if not self.keeptrials:
            avg = acc / self.numTrials
            if self._post_fn is not None:
                avg = self._post_fn(avg)
            host_out = avg.cpu().numpy()
            self.outputShape = host_out.shape
            self.dtype = host_out.dtype
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
                logOpts += "\n\t{0:<{w}} : {1}".format(str(k), str(v), w=maxlen)
        out.log = "computed {name} with settings{opts}".format(
            name=self.__class__.__name__, opts=logOpts or " (defaults)"
        )
