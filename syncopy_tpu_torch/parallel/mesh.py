# -*- coding: utf-8 -*-
#
# Device-mesh management, the API of syncopy_tpu/parallel/mesh.py:46-190 on
# CUDA devices (the reference's Dask client detection and spawning,
# reference syncopy/shared/kwarg_decorators.py:415-584).
#
# The port runs on one device. A mesh is a small record of devices on the
# axes ("trial", "channel"); a mesh of one device computes exactly what
# ``parallel=None`` does, on the port's device (set_device). A mesh over
# more than one device raises `not_ported`; the sharded routines that would
# use it (wilson_sf_sharded, granger_sharded, mtmconvol_time_sharded,
# cwt_time_sharded, apply_fir_time_sharded) are not ported (MULTI_CARD_ITEM).

import contextlib

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
    "init_distributed",
    "cluster_cleanup",
    "esi_cluster_setup",
]

TRIAL_AXIS = "trial"
CHANNEL_AXIS = "channel"

#: where the multi-card layer is queued
MULTI_CARD_ITEM = "ROADMAP Queue 1 item 17 (multi-card sharding)"

_ACTIVE_MESH = None


class Mesh:
    """
    Devices on the named axes ``("trial", "channel")``: `devices` is a 2-D
    object array of :class:`torch.device`. ``shape`` maps each axis name to
    its length, as ``jax.sharding.Mesh.shape`` does.
    """

    def __init__(self, devices, axis_names=(TRIAL_AXIS, CHANNEL_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self):
        """The one device of the mesh."""
        return self.devices.flat[0]

    def __repr__(self):
        return "Mesh({}, axis_names={})".format(
            ", ".join("{}={}".format(k, v) for k, v in self.shape.items()), self.axis_names)


def _canonical(device):
    """`device` with the index a bare ``"cuda"`` stands for."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _visible_devices():
    """The devices a mesh may span: the CUDA cards, or the CPU where the
    port was set to compute there."""
    from ..engine.routine import default_device

    device = default_device()
    if device.type == "cpu":
        return [device]
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def init_distributed(**kwargs):
    """
    Start a multi-host runtime. The port runs on one host, so this is a
    no-op, as the JAX package's is when it finds no cluster.
    """
    get_logger().info("init_distributed: single-host mode (%s)", kwargs or "no arguments")


def make_mesh(n_trial=None, n_channel=1, devices=None):
    """
    Build a :class:`Mesh` with named axes ``("trial", "channel")``.

    Parameters
    ----------
    n_trial : int or None
        Devices along the trial axis. Default: all devices divided by
        `n_channel`.
    n_channel : int
        Devices along the channel axis.
    devices : list of torch.device or None
        Default: the visible CUDA cards (the CPU after ``set_device("cpu")``).

    A mesh over more than one device raises NotImplementedError: the
    multi-card layer is not ported.
    """
    devices = _visible_devices() if devices is None else [torch.device(d) for d in devices]
    n_dev = len(devices)
    if n_trial is None:
        n_trial = n_dev // n_channel
    if n_trial * n_channel > n_dev:
        raise SPYParallelError(
            "mesh of {}x{} devices requested but only {} available".format(n_trial, n_channel, n_dev)
        )
    if n_trial * n_channel != 1:
        raise not_ported("a mesh over {} devices".format(n_trial * n_channel), MULTI_CARD_ITEM)
    dev_arr = np.empty((1, 1), dtype=object)
    dev_arr[0, 0] = devices[0]
    return Mesh(dev_arr)


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
    Stand-in for the reference's ACME SLURM helper: builds a mesh over
    `n_workers` visible devices (all if None), installs it as the active
    mesh and returns it. Extra ACME keywords are accepted and ignored.
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

    A mesh must hold the port's device (set_device): the engine computes
    there.
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
        from ..engine.routine import default_device

        if _canonical(mesh.device) != _canonical(default_device()):
            raise SPYValueError(
                legal="a mesh on the port's device {}".format(default_device()),
                varname="mesh", actual=str(mesh.device))
    return mesh
