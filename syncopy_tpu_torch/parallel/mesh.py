# -*- coding: utf-8 -*-
#
# Device-mesh management, the API of syncopy_tpu/parallel/mesh.py:46-236 on
# CUDA devices (the reference's Dask client detection and spawning,
# reference syncopy/shared/kwarg_decorators.py:415-584).
#
# A mesh is a ("trial", "channel") grid of torch devices, and a device may
# fill more than one position: four positions on cuda:0 run the whole
# sharded code on one card, as the JAX package's tests run theirs on
# virtual host devices. The engine splits each chunk's rows over the trial
# axis, and a routine that declares it splits its channels over the channel
# axis (engine/routine.py); the sharded routines (wilson_sf_sharded,
# granger_sharded, mtmconvol_time_sharded, cwt_time_sharded,
# apply_fir_time_sharded) split one axis over the positions of a mesh axis.
# Positions on one device run one after another on that device's current
# stream; a copy between devices is a blocking `Tensor.to`, which orders
# itself after the source stream's work. Multi-host (jax.distributed) is
# not ported (MULTI_HOST_ITEM).

import contextlib
import math
from collections import namedtuple

import numpy as np
import torch

from ..shared.errors import SPYParallelError, SPYValueError, SPYWarning, not_ported
from ..shared.log import get_logger

__all__ = [
    "Mesh",
    "make_mesh",
    "use_mesh",
    "active_mesh",
    "set_active_mesh",
    "resolve_parallel",
    "check_mesh",
    "trial_sharding",
    "replicated_sharding",
    "pad_to_multiple",
    "shard_batch",
    "gather_shards",
    "axis_devices",
    "device_context",
    "ShardedTensor",
    "split_along",
    "halo_exchange",
    "init_distributed",
    "cluster_cleanup",
    "esi_cluster_setup",
]

TRIAL_AXIS = "trial"
CHANNEL_AXIS = "channel"

#: where the multi-host runtime is queued
MULTI_HOST_ITEM = "ROADMAP Queue 1 item 18 (multi-host)"

_ACTIVE_MESH = None


class Mesh:
    """
    Devices on the named axes ``("trial", "channel")``: `devices` is a 2-D
    object array of :class:`torch.device`, in which a device may repeat.
    ``shape`` maps each axis name to its length, as
    ``jax.sharding.Mesh.shape`` does. Two meshes are equal when they hold
    the same devices at the same positions.
    """

    def __init__(self, devices, axis_names=(TRIAL_AXIS, CHANNEL_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self):
        """The mesh's first position: where trial-shard partials are summed
        and small serial stages run."""
        return self.devices.flat[0]

    @property
    def key(self):
        """Hashable description: the shape and every position's device."""
        return (tuple(self.devices.shape), tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.key == other.key

    def __hash__(self):
        return hash(self.key)

    def __repr__(self):
        return "Mesh({}, axis_names={}, devices=[{}])".format(
            ", ".join("{}={}".format(k, v) for k, v in self.shape.items()), self.axis_names,
            ", ".join(str(d) for d in self.devices.flat))


def _canonical(device):
    """`device` with the index a bare ``"cuda"`` stands for."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        return torch.device("cuda", index)
    return device


def _visible_devices():
    """The devices a mesh spans by default: the CUDA cards, or the CPU
    where the port was set to compute there."""
    from ..engine.routine import default_device

    device = default_device()
    if device.type == "cpu":
        return [device]
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def init_distributed(**kwargs):
    """
    Start a multi-host runtime. The port runs on one host: without a
    cluster to join this is a no-op, as the JAX package's is when it
    finds none; a request for more than one process raises.
    """
    n_proc = kwargs.get("num_processes")
    if kwargs.get("coordinator_address") is not None or (n_proc is not None and n_proc > 1):
        raise not_ported("a multi-host runtime", MULTI_HOST_ITEM)
    get_logger().info("init_distributed: single-host mode (%s)", kwargs or "no arguments")


def make_mesh(n_trial=None, n_channel=1, devices=None):
    """
    Build a :class:`Mesh` with named axes ``("trial", "channel")``.

    Parameters
    ----------
    n_trial : int or None
        Positions along the trial axis. Default: all devices divided by
        `n_channel`.
    n_channel : int
        Positions along the channel axis.
    devices : list of torch.device (or str) or None
        The positions in row-major order; a device may repeat:
        ``make_mesh(n_trial=4, devices=["cuda:0"] * 4)`` runs four trial
        shards on one card, and ``devices=["cpu"] * 8`` with
        ``n_trial=4, n_channel=2`` is the counterpart of the JAX tests'
        eight virtual host devices. Default: the visible CUDA cards (the
        CPU after ``set_device("cpu")``).

    Every position must be of the port's device type (:func:`set_device`)
    when the mesh is used; :func:`check_mesh` says so.
    """
    devices = _visible_devices() if devices is None else [torch.device(d) for d in devices]
    for d in devices:
        if d.type not in ("cpu", "cuda"):
            raise SPYValueError(legal="cpu or cuda devices", varname="devices", actual=str(d))
    n_dev = len(devices)
    if n_trial is None:
        n_trial = n_dev // n_channel
    if n_trial < 1 or n_channel < 1 or n_trial * n_channel > n_dev:
        raise SPYParallelError(
            "mesh of {}x{} devices requested but only {} available".format(n_trial, n_channel, n_dev)
        )
    dev_arr = np.empty((n_trial, n_channel), dtype=object)
    for k, d in enumerate(devices[: n_trial * n_channel]):
        dev_arr[k // n_channel, k % n_channel] = _canonical(d)
    return Mesh(dev_arr)


def check_mesh(mesh):
    """
    Raise SPYValueError unless every position of `mesh` is of the port's
    device type (:func:`~syncopy_tpu_torch.set_device`) and every CUDA
    position names a card that exists: a mesh never moves work to the CPU
    when a card was asked for, nor the other way round.
    """
    from ..engine.routine import default_device

    port = default_device()
    for d in mesh.devices.flat:
        if d.type != port.type:
            raise SPYValueError(
                legal="a mesh on the port's device type ({})".format(port.type),
                varname="mesh", actual=str(d))
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise SPYValueError(
                legal="a CUDA index below the {} visible cards".format(torch.cuda.device_count()),
                varname="mesh", actual=str(d))
    return mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """
    Install `mesh` as the process-global active mesh for the block:
    frontend calls with ``parallel=None`` pick it up.
    """
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def set_active_mesh(mesh):
    """Imperatively install (or clear, with None) the global active mesh."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    """Return the installed :class:`Mesh` (or None)."""
    return _ACTIVE_MESH


def cluster_cleanup(client=None):
    """Clear the active mesh (API parity with reference cluster_cleanup)."""
    set_active_mesh(None)


def esi_cluster_setup(n_workers=None, **kwargs):
    """
    Stand-in for the reference's ACME SLURM helper: builds a trial mesh
    over `n_workers` visible devices (all if None), installs it as the
    active mesh and returns it. Extra ACME keywords are accepted and
    ignored.
    """
    devices = _visible_devices()
    if n_workers is not None:
        if n_workers > len(devices):
            raise SPYParallelError(
                "{} workers requested but only {} devices available".format(
                    n_workers, len(devices))
            )
        devices = devices[:n_workers]
    mesh = make_mesh(devices=devices)
    set_active_mesh(mesh)
    return mesh


def resolve_parallel(parallel=None):
    """
    Map the user-facing ``parallel`` keyword to a mesh (or None, one
    device), as the JAX package does:

    - ``None``: the active mesh if one is installed, else None;
    - ``True``: the active mesh if installed, else a mesh over all visible
      devices (a warning and None where only one is visible);
    - ``False``: None.

    The mesh is checked with :func:`check_mesh`.
    """
    if parallel is False:
        return None
    mesh = _ACTIVE_MESH
    if mesh is None and parallel:
        if len(_visible_devices()) == 1:
            SPYWarning(
                "`parallel=True` but only ONE device is visible: running on one "
                "device (the analog of the reference's 'no parallel computing "
                "client found')"
            )
            return None
        mesh = make_mesh()
    if mesh is not None:
        check_mesh(mesh)
    return mesh


#: how :func:`shard_batch` lays a batch out: axis 0 over the trial axis,
#: `channel_axis` (or None) over the channel axis
TrialSharding = namedtuple("TrialSharding", ["mesh", "ndim", "channel_axis"])


def trial_sharding(mesh, ndim, channel_axis_pos=None):
    """The layout that shards axis 0 (the stacked trial axis) over the
    mesh's trial axis and, where the mesh has more than one channel
    position, axis `channel_axis_pos` over its channel axis."""
    if channel_axis_pos is not None and mesh.shape[CHANNEL_AXIS] == 1:
        channel_axis_pos = None
    return TrialSharding(mesh, int(ndim), channel_axis_pos)


def device_context(device):
    """The context that makes `device` current for kernel launches and
    allocations: ``torch.cuda.device`` on a card, none on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicated_sharding(mesh):
    """The layout of a tensor held whole at every position."""
    return TrialSharding(mesh, None, None)


def pad_to_multiple(n, m):
    """Smallest multiple of `m` >= `n`."""
    return int(math.ceil(n / m) * m) if m > 1 else int(n)


def axis_devices(mesh, axis_name=TRIAL_AXIS):
    """The positions along `axis_name`: the first column of the mesh for
    the trial axis, its first row for the channel axis (the other axis
    holds replicas, as a shard_map over one axis replicates the other)."""
    if axis_name == TRIAL_AXIS:
        return list(mesh.devices[:, 0])
    if axis_name == CHANNEL_AXIS:
        return list(mesh.devices[0, :])
    raise SPYValueError(legal="'trial' or 'channel'", varname="axis_name", actual=str(axis_name))


def shard_batch(host_batch, mesh, channel_axis_pos=None):
    """
    Transfer a host batch (numpy, leading axis = trials) to the device(s).

    Without a mesh the batch goes whole to the port's device. With one,
    the batch axis is zero-padded to a multiple of the trial-axis size
    (the caller masks the padding trials by the valid count) and split
    into contiguous row blocks, block ``i`` on trial shard ``i``; where
    the mesh has channel positions and `channel_axis_pos` divides evenly
    by them, each block is split along that axis too, piece ``j`` on
    position ``(i, j)``.

    Returns ``(shards, n)``: a tensor without a mesh, else a list over
    the trial shards of lists over the channel pieces; `n` is the count
    of real trials.
    """
    n = host_batch.shape[0]
    if mesh is None:
        from ..engine.routine import default_device

        return torch.from_numpy(np.ascontiguousarray(host_batch)).to(default_device()), n
    n_shard = mesh.shape[TRIAL_AXIS]
    n_pad = pad_to_multiple(n, n_shard)
    if n_pad != n:
        pad_width = [(0, n_pad - n)] + [(0, 0)] * (host_batch.ndim - 1)
        host_batch = np.pad(host_batch, pad_width)
    layout = trial_sharding(mesh, host_batch.ndim, channel_axis_pos)
    n_chan = mesh.shape[CHANNEL_AXIS] if layout.channel_axis is not None else 1
    if n_chan > 1 and host_batch.shape[layout.channel_axis] % n_chan:
        n_chan = 1  # only an even channel split
    rows = n_pad // n_shard
    shards = []
    for i in range(n_shard):
        block = host_batch[i * rows : (i + 1) * rows]
        pieces = np.split(block, n_chan, axis=layout.channel_axis) if n_chan > 1 else [block]
        shards.append([torch.from_numpy(np.ascontiguousarray(p)).to(mesh.devices[i, j])
                       for j, p in enumerate(pieces)])
    return shards, n


def gather_shards(shards, device, dim=0):
    """Concatenate `shards` (tensors on any devices) along `dim` on
    `device`; a blocking copy per shard on another device."""
    device = torch.device(device)
    parts = [s if s.device == device else s.to(device) for s in shards]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class ShardedTensor(list):
    """One array held as tensors, one per mesh position along an axis,
    split along dimension `dim` (a sharded routine's output, which is
    never gathered unless asked: :meth:`gather`)."""

    def __init__(self, tensors, dim):
        super().__init__(tensors)
        self.dim = int(dim)

    @property
    def shape(self):
        shape = list(self[0].shape)
        shape[self.dim] = sum(t.shape[self.dim] for t in self)
        return tuple(shape)

    def gather(self, device="cpu"):
        """The whole array, concatenated on `device`."""
        return gather_shards(list(self), device, dim=self.dim)


def split_along(x, devices, dim=0):
    """`x` (a numpy array or tensor) split along `dim` into
    ``len(devices)`` contiguous blocks of ``ceil(n / len(devices))``, the
    last ones shorter or empty, as GSPMD pads an uneven axis; block ``i``
    on ``devices[i]``."""
    x = torch.as_tensor(x)
    n = x.shape[dim]
    step = -(-n // len(devices))
    return [x.narrow(dim, min(i * step, n), max(0, min(step, n - i * step))).to(d)
            for i, d in enumerate(devices)]


def halo_exchange(blocks, left, right):
    """
    Each block of a signal split along axis 0 (one per position, in
    order) extended by `left` samples from its left neighbour's end and
    `right` samples from its right neighbour's start, zeros at the outer
    edges: the ring exchange of the JAX package's ``lax.ppermute`` pair,
    as copies between positions. Each neighbour must hold at least the
    samples it sends. Returns the extended blocks, each on its own
    block's device.
    """
    out = []
    for i, xs in enumerate(blocks):
        zeros_l = xs.new_zeros((left,) + tuple(xs.shape[1:]))
        zeros_r = xs.new_zeros((right,) + tuple(xs.shape[1:]))
        lh = blocks[i - 1][blocks[i - 1].shape[0] - left :].to(xs.device) if i > 0 else zeros_l
        rh = blocks[i + 1][:right].to(xs.device) if i + 1 < len(blocks) else zeros_r
        out.append(torch.cat([lh, xs, rh], dim=0))
    return out
