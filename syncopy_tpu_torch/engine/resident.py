# -*- coding: utf-8 -*-
#
# Device-resident compute results: per-trial outputs stay on the device and
# the device-to-host readback waits until the payload is touched.
#
# Port of syncopy_tpu/engine/resident.py. A chained pipeline
# (preprocessing -> resampledata -> connectivityanalysis) consumes the
# producer's device chunks directly, so the host link carries the input
# once and the final, usually trial-averaged, result once.
#
# ``DeviceResident``
#     Owns the per-chunk device tensors (``records``) and what rebuilds the
#     host array from them (offsets, stacking dim, dtype). Sealed with the
#     owner's cache token: a later mutation of the owner stops direct
#     consumption, while materialization stays exact (the records are
#     never written to). The read-back array is read-only while the
#     records exist, so an in-place write raises instead of leaving them
#     stale; a payload that cannot be made read-only (an HDF5 dataset)
#     releases them.
#
# ``DeferredArray``
#     The owner's ``_data`` until the first element access: ``shape``,
#     ``dtype`` and the other metadata read without a transfer; ``[...]``,
#     ``np.asarray`` and ``astype`` read the payload back and swap the real
#     array in.
#
# Device-memory accounting: a process-wide registry bounds the device
# bytes that all residents hold, read back or not (RESIDENT_BUDGET). Over
# budget, read-back residents drop their tensors first (they stay
# consumable downstream until then); then the oldest pending resident is
# read back and its tensors dropped.
#
# Differences from the JAX package: a record is the chunk's valid rows in
# the result's own dtype (complex stays complex), with no (N, 128) readback
# layout and no (re, im) encoding. A record made on a mesh holds one tensor
# per trial shard, on that shard's device (the JAX package's one sharded
# array); the budget counts every shard, an eviction frees them all and the
# readback writes them in trial order.

import weakref
from collections import namedtuple

import numpy as np
import torch

__all__ = ["DeviceResident", "DeferredArray", "Record", "materialize_all", "RESIDENT_BUDGET",
           "shard_positions", "take_rows"]

#: device bytes that resident results may hold, read back or not; 0 turns
#: device-resident outputs off
RESIDENT_BUDGET = 6 * 1024**3

#: one compute chunk kept on the device(s):
#:   positions    tuple of the selected-trial positions of its rows
#:   shards       tuple of tensors ``(n_i, *trial_shape)``, one per trial
#:                shard that holds rows, in shard order (the chunk's
#:                positions in order, split); one tensor without a mesh
#:   trial_shape  per-trial output shape
#:   chunk        the producer's padded chunk size (a multiple of its
#:                trial shards)
Record = namedtuple("Record", ["positions", "shards", "trial_shape", "chunk"])


def shard_positions(rec):
    """``[(shard tensor, its positions), ...]`` of a record, in order."""
    out, start = [], 0
    for shard in rec.shards:
        out.append((shard, rec.positions[start : start + shard.shape[0]]))
        start += shard.shape[0]
    return out


def take_rows(rec, a, b, device):
    """Rows ``a .. b`` of a record (its shards' rows in order) as one
    tensor on `device`: a slice where they lie in one shard on `device`
    (no copy), else the slices copied there and concatenated."""
    pieces, start = [], 0
    for shard in rec.shards:
        n = shard.shape[0]
        lo, hi = max(a, start), min(b, start + n)
        if lo < hi:
            pieces.append(shard[lo - start : hi - start])
        start += n
    if not pieces:  # no rows
        shard = rec.shards[0]
        return torch.empty((0,) + tuple(shard.shape[1:]), dtype=shard.dtype, device=device)
    from ..parallel.mesh import gather_shards

    return gather_shards(pieces, device)

_REGISTRY = []  # weak references to DeviceResident, in creation order


def _registry_account():
    """(device bytes held, live references); prunes dead references in
    place."""
    alive = []
    pinned = 0
    for ref in _REGISTRY:
        res = ref()
        if res is None or res.records is None:
            continue
        alive.append(ref)
        pinned += res.nbytes_device
    _REGISTRY[:] = alive
    return pinned, alive


def _admit(new_bytes):
    """Make room for `new_bytes` of device memory: drop the tensors of
    read-back residents first, then read back and drop the oldest pending
    ones. True when the bytes fit the budget."""
    budget = RESIDENT_BUDGET
    pinned, alive = _registry_account()
    if pinned + new_bytes <= budget:
        return True
    for ref in alive:
        res = ref()
        if res is not None and res.materialized and res.records is not None:
            res.drop_device()
    for ref in alive:
        pinned, _ = _registry_account()
        if pinned + new_bytes <= budget:
            return True
        res = ref()
        if res is not None and not res.materialized and res.records is not None:
            res.materialize()
            res.drop_device()
    pinned, _ = _registry_account()
    return pinned + new_bytes <= budget


def materialize_all():
    """Read back every pending resident and drop all device tensors."""
    for ref in list(_REGISTRY):
        res = ref()
        if res is not None and res.records is not None:
            res.materialize()
            res.drop_device()
    _REGISTRY[:] = []


class DeviceResident:
    """Per-trial compute results on the device; see the module header."""

    def __init__(self, records, shape, dtype, offsets, stackingdim, materialize_fn, owner):
        self.records = list(records)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.offsets = np.asarray(offsets)
        self.stackingdim = int(stackingdim)
        self._materialize_fn = materialize_fn
        self._owner = weakref.ref(owner)
        self._real = None
        self._materializing = False
        #: the owner's cache token at seal time; consumption needs a match
        self.sealed_token = None
        self.nbytes_device = sum(t.numel() * t.element_size()
                                 for r in self.records for t in r.shards)
        _REGISTRY.append(weakref.ref(self))

    @property
    def materialized(self):
        return self._real is not None

    def seal(self):
        owner = self._owner()
        if owner is not None:
            self.sealed_token = owner._cache_token

    def consumable_by(self, data):
        """True when `data`'s payload is exactly these records (their
        DeferredArray, or the read-only array read back from them) and
        `data` was not mutated since they were sealed."""
        payload = getattr(data, "_data", None)
        return (
            self.records is not None
            and self.sealed_token is not None
            and getattr(data, "_cache_token", None) == self.sealed_token
            and ((self._real is not None and payload is self._real)
                 or (isinstance(payload, DeferredArray) and payload._resident is self))
        )

    def materialize(self):
        """Read the records back into the host array (idempotent) and swap
        it in for the owner's DeferredArray. The array is read-only while
        the records exist; an HDF5 dataset (a spilled result) cannot be, so
        it releases them. The in-flight guard stops a second entry when an
        out-of-memory eviction runs during this very readback."""
        if self._real is None and not self._materializing:
            self._materializing = True
            try:
                self._real = self._materialize_fn(self)
            finally:
                self._materializing = False
            if isinstance(self._real, np.ndarray):
                self._real.flags.writeable = False
            else:
                self.records = None
            owner = self._owner()
            if owner is not None and isinstance(owner._data, DeferredArray):
                owner._data = self._real
        return self._real

    def drop_device(self):
        """Release the device tensors, after reading them back if that has
        not happened yet: residency never loses data."""
        if self._materializing:
            return  # an in-flight readback owns the records
        if self._real is None and self.records is not None:
            self.materialize()
        self.release()

    def release(self):
        """Forget the device tensors without reading them back (the owner's
        payload was replaced); the read-back array becomes writable."""
        self.records = None
        if isinstance(self._real, np.ndarray):
            self._real.flags.writeable = True

    def fetch_trial_view(self, pos, max_time=1024, magnitude=True):
        """
        Plot-resolution readback of one trial: slice the trial out of its
        record, take the magnitude of complex values and box-average the
        leading (time) axis down to ``<= max_time`` rows, all on the
        device, then copy only that view to the host.

        Returns ``(array, factor)``, `factor` being the decimation stride
        (time axis ``t' = (t * factor + (factor - 1) / 2) / samplerate``).
        Once the device tensors are gone, or the payload has been read
        back, the view is cut from the host array.
        """
        n_rows = int(self.offsets[pos + 1] - self.offsets[pos])
        factor = max(1, int(np.ceil(n_rows / max_time)))
        t_out = n_rows // factor

        if self._real is not None or self.records is None:
            arr = self.materialize()
            sl = [slice(None)] * arr.ndim
            sl[self.stackingdim] = slice(int(self.offsets[pos]), int(self.offsets[pos + 1]))
            t = np.asarray(arr[tuple(sl)])
            if magnitude and np.iscomplexobj(t):
                t = np.abs(t)
            if factor > 1:
                t = t[: t_out * factor].reshape((t_out, factor) + t.shape[1:]).mean(axis=1)
            return t, factor

        from .routine import _count_transfer

        t = next(shard[list(positions).index(pos)]
                 for r in self.records for shard, positions in shard_positions(r)
                 if pos in positions)
        if magnitude and t.is_complex():
            t = t.abs()
        if factor > 1:
            t = t[: t_out * factor].reshape((t_out, factor) + tuple(t.shape[1:])).mean(dim=1)
        view = t.cpu().numpy()
        _count_transfer("d2h", view.nbytes)
        return view, factor


class DeferredArray:
    """Stand-in for the payload: shape and dtype without a transfer, the
    readback on the first element access."""

    def __init__(self, resident):
        self._resident = resident

    @property
    def shape(self):
        return self._resident.shape

    @property
    def dtype(self):
        return self._resident.dtype

    @property
    def ndim(self):
        return len(self._resident.shape)

    @property
    def size(self):
        return int(np.prod(self._resident.shape))

    @property
    def nbytes(self):
        return self.size * self._resident.dtype.itemsize

    @property
    def itemsize(self):
        return self._resident.dtype.itemsize

    def __len__(self):
        return self._resident.shape[0]

    def _ensure(self):
        return self._resident.materialize()

    def __getitem__(self, idx):
        return self._ensure()[idx]

    def __array__(self, dtype=None, copy=None):
        real = np.asarray(self._ensure())
        return real.astype(dtype) if dtype is not None else real

    def astype(self, dtype, **kwargs):
        return np.asarray(self._ensure()).astype(dtype, **kwargs)

    def __repr__(self):
        state = "materialized" if self._resident.materialized else "device-resident"
        return "<DeferredArray {} {} ({})>".format(
            self._resident.shape, self._resident.dtype, state)
