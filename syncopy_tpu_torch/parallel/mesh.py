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
# itself after the source stream's work.
#
# Several processes (the JAX package's jax.distributed runtime) join one
# torch.distributed cluster through init_distributed; each position of a
# mesh then has an owner rank (`Mesh.ranks`), and the default mesh spans
# every rank's devices in rank order. Every rank calls the same analysis
# on the same data; a rank computes only the trial shards it owns, and
# each shard's result reaches the other ranks by a broadcast from its
# owner (share_from), so every rank ends the call holding the whole,
# identical result. The sharded routines move their blocks between
# positions through exchange: a copy between two positions of one rank,
# point-to-point sends between ranks (halos, Wilson's layout swaps); a
# ShardedTensor holds this rank's blocks, and its gather hands every rank
# the whole array.

import contextlib
import datetime
import math
from collections import namedtuple

import numpy as np
import torch

from ..shared.errors import SPYParallelError, SPYValueError, SPYWarning
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
    "axis_ranks",
    "device_context",
    "ShardedTensor",
    "split_along",
    "halo_exchange",
    "Move",
    "exchange",
    "replicate",
    "init_distributed",
    "process_rank",
    "process_count",
    "share_from",
    "collective_counts",
    "reset_collective_counts",
    "cluster_cleanup",
    "esi_cluster_setup",
]

TRIAL_AXIS = "trial"
CHANNEL_AXIS = "channel"

#: seconds a rank waits for its peers, to join and in each collective,
#: before it raises
DEFAULT_TIMEOUT = 300.0

_ACTIVE_MESH = None

#: the joined cluster (init_distributed): every rank's positions in rank
#: order as (device, rank) pairs, and the device collectives move tensors
#: through; None on a single host
_CLUSTER = None

#: tensor bytes moved between ranks by share_from and exchange since
#: reset_collective_counts(): "sent" counts a broadcast once for each
#: receiving rank
_COLLECTIVE_BYTES = {"sent": 0, "received": 0}


class Mesh:
    """
    Devices on the named axes ``("trial", "channel")``: `devices` is a 2-D
    object array of :class:`torch.device`, in which a device may repeat,
    and `ranks` an integer array of the same shape naming the process
    that owns each position (default: this process everywhere); a
    device names a card of its owner's host. ``shape`` maps each axis
    name to its length, as ``jax.sharding.Mesh.shape`` does. Two meshes
    are equal when they hold the same devices of the same ranks at the
    same positions.
    """

    def __init__(self, devices, axis_names=(TRIAL_AXIS, CHANNEL_AXIS), ranks=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if ranks is None:
            ranks = np.full(devices.shape, process_rank(), dtype=np.int64)
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(devices.shape)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self):
        """The mesh's first position: where trial-shard partials are summed
        and small serial stages run."""
        return self.devices.flat[0]

    @property
    def crosses_processes(self):
        """True when a position belongs to another process than this one:
        shard results then travel between ranks (:func:`share_from`)."""
        return bool((self.ranks != process_rank()).any())

    @property
    def processes(self):
        """The ranks that own positions of the mesh, in order: those that
        call a sharded routine on it and receive its result."""
        return sorted(set(int(r) for r in self.ranks.flat))

    def home_device(self):
        """Where this process combines the shards' results: its first
        position in the mesh (the mesh's first position in one process),
        else the port's device."""
        own = [d for d, r in zip(self.devices.flat, self.ranks.flat) if r == process_rank()]
        if own:
            return own[0]
        from ..engine.routine import default_device

        return default_device()

    @property
    def key(self):
        """Hashable description: the shape and every position's device and
        owner rank."""
        return (tuple(self.devices.shape), tuple(str(d) for d in self.devices.flat),
                tuple(int(r) for r in self.ranks.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.key == other.key

    def __hash__(self):
        return hash(self.key)

    def __repr__(self):
        return "Mesh({}, axis_names={}, devices=[{}], ranks=[{}])".format(
            ", ".join("{}={}".format(k, v) for k, v in self.shape.items()), self.axis_names,
            ", ".join(str(d) for d in self.devices.flat),
            ", ".join(str(r) for r in self.ranks.flat))


def _canonical(device):
    """`device` with the index a bare ``"cuda"`` stands for."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        return torch.device("cuda", index)
    return device


def _cluster():
    """The joined cluster's record, or None on a single host (also once
    the process group has been destroyed)."""
    global _CLUSTER
    if _CLUSTER is not None and not torch.distributed.is_initialized():
        _CLUSTER = None
    return _CLUSTER


def process_rank():
    """This process's rank in the joined cluster; 0 on a single host."""
    return torch.distributed.get_rank() if _cluster() is not None else 0


def process_count():
    """The processes of the joined cluster; 1 on a single host."""
    return torch.distributed.get_world_size() if _cluster() is not None else 1


def _visible_positions():
    """The positions a mesh spans by default, as (device, owner rank)
    pairs: every rank's devices in rank order in a joined cluster (as
    ``jax.devices()`` orders them by process), else this host's CUDA
    cards, or the CPU where the port was set to compute there."""
    cluster = _cluster()
    if cluster is not None:
        return list(cluster["positions"])
    from ..engine.routine import default_device

    device = default_device()
    if device.type == "cpu":
        return [(device, 0)]
    return [(torch.device("cuda", k), 0) for k in range(torch.cuda.device_count())]


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None, local_devices=None, timeout=DEFAULT_TIMEOUT):
    """
    Join a multi-process cluster on ``torch.distributed`` (the counterpart
    of the JAX package's ``jax.distributed.initialize``). Without
    `coordinator_address` and with at most one process this is the
    single-host no-op. Asked for a cluster it joins or raises
    SPYParallelError; it never goes on as a single host.

    Parameters
    ----------
    coordinator_address : str
        ``"host:port"`` of rank 0, which serves the rendezvous
        (``init_method="tcp://host:port"``).
    num_processes : int
        The cluster's processes (``world_size``).
    process_id : int
        This process's rank (``rank``).
    backend : {"nccl", "gloo"} or None
        Default: ``"nccl"`` where the port computes on CUDA
        (:func:`~syncopy_tpu_torch.set_device`), ``"gloo"`` on the CPU.
        NCCL refuses two ranks on one card: such ranks name ``"gloo"``,
        whose collectives go through a CPU staging copy.
    local_devices : list of torch.device (or str) or None
        This rank's mesh positions, in order. Default: ``cuda:(rank %
        device_count)`` where the port computes on CUDA, else the CPU.
    timeout : float
        Seconds to wait for the peers, to join and in every collective,
        before raising: a rank whose peer died fails instead of waiting.

    After joining, :func:`make_mesh` and :func:`esi_cluster_setup` default
    to every rank's positions in rank order.
    """
    global _CLUSTER
    n_proc = 1 if num_processes is None else int(num_processes)
    if coordinator_address is None and n_proc <= 1:
        get_logger().info("init_distributed: single-host mode")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise SPYValueError(
            legal="coordinator_address, num_processes and process_id for a cluster",
            varname="init_distributed",
            actual="coordinator_address={!r}, num_processes={!r}, process_id={!r}".format(
                coordinator_address, num_processes, process_id))
    if not torch.distributed.is_available():
        raise SPYParallelError("init_distributed: this PyTorch has no torch.distributed")
    if torch.distributed.is_initialized():
        raise SPYParallelError("init_distributed: this process has joined a cluster already")
    from ..engine.routine import default_device

    port = default_device()
    rank = int(process_id)
    if backend is None:
        backend = "nccl" if port.type == "cuda" else "gloo"
    if local_devices is None:
        local_devices = [port if port.type == "cpu"
                         else torch.device("cuda", rank % torch.cuda.device_count())]
    local = [_canonical(d) for d in local_devices]
    for d in local:
        if d.type != port.type:
            raise SPYValueError(legal="local devices of the port's device type ({})".format(
                port.type), varname="local_devices", actual=str(d))
    if backend == "nccl":
        if port.type != "cuda":
            raise SPYValueError(legal="'gloo' on the CPU", varname="backend", actual=backend)
        torch.cuda.set_device(local[0])
    try:
        torch.distributed.init_process_group(
            backend=backend, init_method="tcp://{}".format(coordinator_address),
            world_size=n_proc, rank=rank, timeout=datetime.timedelta(seconds=timeout))
    except (RuntimeError, ValueError) as exc:
        raise SPYParallelError(
            "rank {} of {} could not join the cluster at {} over {} within {} s: {}".format(
                rank, n_proc, coordinator_address, backend, timeout, exc)) from exc
    gathered = [None] * n_proc
    torch.distributed.all_gather_object(gathered, [str(d) for d in local])
    _CLUSTER = {
        "positions": [(torch.device(d), r) for r, devs in enumerate(gathered) for d in devs],
        "transport": local[0] if backend == "nccl" else torch.device("cpu"),
    }
    get_logger().info("init_distributed: rank %d of %d over %s, positions %s", rank, n_proc,
                      backend, gathered)


def share_from(tensor, src, device, info=None):
    """
    Rank `src`'s `tensor`, and its picklable `info`, on every rank of the
    joined cluster: `src` passes them, every other rank passes None and
    receives them; every rank must call this in the same order. The
    bytes travel bit for bit (``-0.0`` and NaN payloads included) in one
    ``broadcast``, after one of the shape, dtype and `info`. The transport
    is this rank's card under NCCL, a CPU staging tensor under gloo,
    filled and emptied by explicit copies. Returns ``(tensor on `device`,
    info)``; `src` gets its own tensor back, copied only where it lies
    elsewhere.
    """
    dist = torch.distributed
    transport = _cluster()["transport"]
    rank, world = dist.get_rank(), dist.get_world_size()
    meta = [(tuple(tensor.shape), tensor.dtype, info) if rank == src else None]
    dist.broadcast_object_list(meta, src=src, device=transport)
    shape, dtype, info = meta[0]
    if rank == src:
        buf = tensor.detach().contiguous().reshape(-1).view(torch.uint8).to(transport)
        _COLLECTIVE_BYTES["sent"] += buf.numel() * (world - 1)
    else:
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        buf = torch.empty(nbytes, dtype=torch.uint8, device=transport)
        _COLLECTIVE_BYTES["received"] += nbytes
    if buf.numel():
        dist.broadcast(buf, src=src)
    device = torch.device(device)
    if rank == src and buf.device != device:
        return tensor.to(device), info
    return buf.view(dtype).reshape(shape).to(device), info


def collective_counts():
    """The tensor bytes this rank sent to and received from other ranks
    (:func:`share_from`, :func:`exchange`) since
    the last :func:`reset_collective_counts`."""
    return dict(_COLLECTIVE_BYTES)


def reset_collective_counts():
    for k in _COLLECTIVE_BYTES:
        _COLLECTIVE_BYTES[k] = 0


def make_mesh(n_trial=None, n_channel=1, devices=None, ranks=None):
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
        CPU after ``set_device("cpu")``); in a joined cluster
        (:func:`init_distributed`) every rank's positions in rank order.
    ranks : list of int or None
        The owner rank of each of `devices`. Default: this process for
        every given device.

    Every position must be of the port's device type (:func:`set_device`)
    when the mesh is used; :func:`check_mesh` says so.
    """
    if devices is None:
        if ranks is not None:
            raise SPYValueError(legal="ranks only with devices", varname="ranks",
                                actual=str(ranks))
        devices, ranks = zip(*_visible_positions())
    devices = [torch.device(d) for d in devices]
    ranks = [process_rank()] * len(devices) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != len(devices):
        raise SPYValueError(legal="one rank per device", varname="ranks",
                            actual="{} ranks for {} devices".format(len(ranks), len(devices)))
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
    return Mesh(dev_arr, ranks=np.reshape(ranks[: n_trial * n_channel], (n_trial, n_channel)))


def check_mesh(mesh):
    """
    Raise SPYValueError unless every position of `mesh` that this process
    owns is of the port's device type (:func:`~syncopy_tpu_torch.set_device`)
    and every such CUDA position names a card of this host: a mesh never
    moves work to the CPU when a card was asked for, nor the other way
    round. Raise SPYParallelError where a trial shard's channel positions
    belong to more than one process (the channel split is a copy within
    one process) or a position's owner is not a rank of the cluster.
    """
    from ..engine.routine import default_device

    for i, row in enumerate(mesh.ranks):
        if len(set(row.tolist())) > 1:
            raise SPYParallelError(
                "trial shard {} of the mesh has channel positions on ranks {}: a trial "
                "shard's channel positions must belong to one process".format(i, row.tolist()))
    rank, world = process_rank(), process_count()
    if mesh.ranks.min() < 0 or mesh.ranks.max() >= world:
        raise SPYParallelError("the mesh has positions of ranks {} but the cluster has {} "
                               "process(es)".format(sorted(set(mesh.ranks.flat)), world))
    port = default_device()
    for d, r in zip(mesh.devices.flat, mesh.ranks.flat):
        if r != rank:
            continue
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
    over `n_workers` visible positions (all if None; every rank's in a
    joined cluster), installs it as the active mesh and returns it. Extra
    ACME keywords are accepted and ignored.
    """
    positions = _visible_positions()
    if n_workers is not None:
        if n_workers > len(positions):
            raise SPYParallelError(
                "{} workers requested but only {} devices available".format(
                    n_workers, len(positions))
            )
        positions = positions[:n_workers]
    devices, ranks = zip(*positions)
    mesh = make_mesh(devices=devices, ranks=ranks)
    set_active_mesh(mesh)
    return mesh


def resolve_parallel(parallel=None):
    """
    Map the user-facing ``parallel`` keyword to a mesh (or None, one
    device), as the JAX package does:

    - ``None``: the active mesh if one is installed, else None;
    - ``True``: the active mesh if installed, else a mesh over all visible
      positions, every rank's in a joined cluster (a warning and None
      where only one is visible);
    - ``False``: None.

    The mesh is checked with :func:`check_mesh`.
    """
    if parallel is False:
        return None
    mesh = _ACTIVE_MESH
    if mesh is None and parallel:
        if len(_visible_positions()) == 1:
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


def axis_ranks(mesh, axis_name=TRIAL_AXIS):
    """The owner rank of each position of :func:`axis_devices` (all
    :func:`process_rank` where this process owns the whole mesh)."""
    if axis_name == TRIAL_AXIS:
        return [int(r) for r in mesh.ranks[:, 0]]
    if axis_name == CHANNEL_AXIS:
        return [int(r) for r in mesh.ranks[0, :]]
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
    split along dimension `dim` into :func:`split_sizes` blocks of the
    whole array's `shape` (a sharded routine's output, which is never
    gathered unless asked: :meth:`gather`). `ranks` names each block's
    owner (:func:`axis_ranks`); a block of another rank is None here."""

    def __init__(self, tensors, dim, shape, ranks):
        super().__init__(tensors)
        self.dim = int(dim)
        self.ranks = list(ranks)
        self._shape = tuple(shape)

    @property
    def shape(self):
        return self._shape

    def gather(self, device="cpu"):
        """The whole array, concatenated on `device`, on every rank that
        owns a block (:func:`replicate`): a copy of each block where all
        are this rank's, else a collective that each owner calls, and every
        one of them gets the same bits."""
        sizes = split_sizes(self._shape[self.dim], len(self))
        dtype = next(t.dtype for t in self if t is not None)
        items = [(t, r, self._shape[: self.dim] + (n,) + self._shape[self.dim + 1 :])
                 for t, r, n in zip(self, self.ranks, sizes)]
        return torch.cat(replicate(items, sorted(set(self.ranks)), device, dtype), dim=self.dim)


def split_sizes(n, k):
    """The lengths of :func:`split_along`'s `k` blocks of `n`:
    ``ceil(n / k)`` each, the last ones shorter or empty."""
    step = -(-n // k)
    return [max(0, min(step, n - i * step)) for i in range(k)]


def split_along(x, devices, dim=0, ranks=None):
    """`x` (a numpy array or tensor) split along `dim` into
    ``len(devices)`` contiguous blocks of :func:`split_sizes`, as GSPMD
    pads an uneven axis; block ``i`` on ``devices[i]``. Only the blocks of
    positions this rank owns (`ranks`, :func:`axis_ranks`; default: all)
    are made, the others' are None."""
    x = torch.as_tensor(x)
    me = process_rank()
    ranks = [me] * len(devices) if ranks is None else ranks
    out, start = [], 0
    for d, r, size in zip(devices, ranks, split_sizes(x.shape[dim], len(devices))):
        out.append(x.narrow(dim, start, size).to(d) if r == me else None)
        start += size
    return out


def halo_exchange(blocks, left, right, ranks=None):
    """
    Each block of a signal split along axis 0 (one per position, in
    order) extended by `left` samples from its left neighbour's end and
    `right` samples from its right neighbour's start, zeros at the outer
    edges: the ring exchange of the JAX package's ``lax.ppermute`` pair.
    `ranks` names each block's owner (:func:`axis_ranks`; default: this
    rank owns all); this rank's blocks are tensors, the others' None. A
    halo between two positions of this rank is a copy, one from or to
    another rank a point-to-point message (:func:`exchange`); every rank
    calls this with the same `ranks`. Each neighbour must hold at least
    the samples it sends, and the blocks of a signal are equally long.
    Returns the extended blocks, each on its own block's device (None for
    another rank's).
    """
    me = process_rank()
    ranks = [me] * len(blocks) if ranks is None else list(ranks)
    own = [b for b in blocks if b is not None]
    rest, dtype = (tuple(own[0].shape[1:]), own[0].dtype) if own else ((), None)
    pairs = [(i, j, n) for i in range(len(blocks)) for j, n in ((i - 1, left), (i + 1, right))
             if 0 <= j < len(blocks) and n]
    moves = []
    for i, j, n in pairs:
        src = blocks[j]
        halo = None if src is None else src[src.shape[0] - n :] if j < i else src[:n]
        moves.append(Move(halo, ranks[j], ranks[i], None if blocks[i] is None else blocks[i].device,
                          (n,) + rest, dtype))
    halos = dict(zip(((i, j) for i, j, _ in pairs), exchange(moves)))
    out = []
    for i, xs in enumerate(blocks):
        if xs is None:
            out.append(None)
            continue
        lh = halos.get((i, i - 1), xs.new_zeros((left,) + rest))
        rh = halos.get((i, i + 1), xs.new_zeros((right,) + rest))
        out.append(torch.cat([lh, xs, rh], dim=0))
    return out


#: one tensor moved between mesh positions by :func:`exchange`: the
#: tensor on its source rank (None elsewhere), the source and destination
#: ranks, the destination device, and the shape and dtype, which the
#: destination rank must know
Move = namedtuple("Move", ["tensor", "src", "dst", "device", "shape", "dtype"])


def _nbytes(shape, dtype):
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def exchange(moves):
    """
    Carry out `moves` (:class:`Move`), which every rank lists alike and in
    the same order, and return, in that order, each moved tensor on its
    destination device where this rank is the destination, else None;
    every returned tensor is contiguous, so that what follows computes
    alike on either route. A move within this rank is a ``Tensor.to``.
    Between ranks the bytes travel bit for bit, every tensor viewed as
    ``uint8``, all the tensors of one pair of ranks packed into one
    buffer, staged on this rank's card under NCCL and on the CPU under
    gloo, in one paired send and receive for each peer, all posted
    together (``batch_isend_irecv``), so that a layout swap among all the
    ranks cannot deadlock. Where no move crosses ranks no collective runs.
    """
    me = process_rank()
    out = [m.tensor.to(m.device).contiguous() if m.src == m.dst == me else None for m in moves]
    if all(m.src == m.dst for m in moves):
        return out
    dist = torch.distributed
    transport = _cluster()["transport"]
    world = process_count()
    sends = [[] for _ in range(world)]  # byte views of the tensors to each rank
    recvs = [[] for _ in range(world)]  # (move index, bytes) from each rank
    for k, m in enumerate(moves):
        if m.src == m.dst:
            continue
        if m.src == me:
            sends[m.dst].append(m.tensor.detach().contiguous().reshape(-1).view(torch.uint8)
                                .to(transport))
        elif m.dst == me:
            recvs[m.src].append((k, _nbytes(m.shape, m.dtype)))
    send_sizes = [sum(v.numel() for v in views) for views in sends]
    recv_sizes = [sum(n for _, n in items) for items in recvs]
    _COLLECTIVE_BYTES["sent"] += sum(send_sizes)
    _COLLECTIVE_BYTES["received"] += sum(recv_sizes)
    bufs = [torch.empty(n, dtype=torch.uint8, device=transport) for n in recv_sizes]
    ops = [dist.P2POp(dist.isend, torch.cat(views), r)
           for r, views in enumerate(sends) if send_sizes[r]]
    ops += [dist.P2POp(dist.irecv, bufs[r], r) for r in range(world) if recv_sizes[r]]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for r, items in enumerate(recvs):
        offset = 0
        for k, n in items:
            m = moves[k]
            piece = bufs[r][offset : offset + n]
            device = torch.device(m.device)
            # a tensor of its own, so that the dtype view starts aligned
            piece = piece.to(device) if piece.device != device else piece.clone()
            out[k] = piece.view(m.dtype).reshape(m.shape)
            offset += n
    return out


def replicate(items, ranks, device, dtype):
    """
    Each of `items`, ``(tensor on its owner or None, owner rank, shape)``
    of `dtype`, on every rank of `ranks`: returns on such a rank the
    items' tensors on `device`, in order, each its owner's bits
    (:func:`exchange`, a copy where the owner is this rank). Every rank of
    `ranks` calls this with the same items' owners and shapes.
    """
    me = process_rank()
    moves = [Move(t, src, r, device, tuple(shape), dtype) for t, src, shape in items
             for r in ranks]
    return [t for t, m in zip(exchange(moves), moves) if m.dst == me]
