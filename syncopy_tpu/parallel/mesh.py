# -*- coding: utf-8 -*-
#
# Device-mesh management: the device-native replacement for the reference's Dask
# client detection/spawning (reference syncopy/shared/kwarg_decorators.py:415-584
# and shared/dask_helpers.py).
#
# Design: a single-controller JAX runtime. Analyses are trial-parallel — the
# batch ("trial") axis of every compute chunk is sharded across the first mesh
# axis; an optional second axis shards channels.  Instead of auto-detecting a
# Dask client, we keep a process-global *active mesh*; ``parallel=True``
# builds a mesh over all visible devices, ``parallel=False`` forces single
# device, ``parallel=None`` uses the active mesh if one was installed via
# :func:`use_mesh` (the analog of "a client is already running").

import contextlib
import math

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..shared.errors import SPYParallelError
from ..shared.log import get_logger

__all__ = [
    "make_mesh",
    "use_mesh",
    "active_mesh",
    "resolve_parallel",
    "trial_sharding",
    "replicated_sharding",
    "pad_to_multiple",
    "shard_batch",
    "init_distributed",
    "cluster_cleanup",
    "esi_cluster_setup",
]

TRIAL_AXIS = "trial"
CHANNEL_AXIS = "channel"

_ACTIVE_MESH = None


def init_distributed(**kwargs):
    """
    Initialize the multi-host JAX runtime (``jax.distributed.initialize``).
    No-op when running single-host. Replaces the reference's SLURM/ACME
    cluster setup (`esi_cluster_setup`).
    """
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as exc:
        get_logger().info("init_distributed: single-host mode (%s)", exc)


def make_mesh(n_trial=None, n_channel=1, devices=None):
    """
    Build a ``Mesh`` with named axes ``("trial", "channel")``.

    Parameters
    ----------
    n_trial : int or None
        Number of devices along the trial (data-parallel) axis. Default: all
        devices divided by `n_channel`.
    n_channel : int
        Devices along the channel-sharding axis.
    """
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_trial is None:
        n_trial = n_dev // n_channel
    if n_trial * n_channel > n_dev:
        raise SPYParallelError(
            "mesh of {}x{} devices requested but only {} available".format(n_trial, n_channel, n_dev)
        )
    dev_arr = np.array(devices[: n_trial * n_channel]).reshape(n_trial, n_channel)
    return Mesh(dev_arr, (TRIAL_AXIS, CHANNEL_AXIS))


@contextlib.contextmanager
def use_mesh(mesh):
    """
    Install `mesh` as the process-global active mesh (the analog of having a
    Dask client running: subsequent frontend calls with ``parallel=None``
    will pick it up).
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
    """Return the globally installed :class:`jax.sharding.Mesh` (or None).

    Set with :func:`~syncopy_tpu.use_mesh` / ``set_active_mesh``; frontends
    with ``parallel=None`` auto-detect it.
    """
    return _ACTIVE_MESH


def cluster_cleanup(client=None):
    """Clear the active mesh (API parity with reference cluster_cleanup)."""
    set_active_mesh(None)


def esi_cluster_setup(n_workers=None, **kwargs):
    """
    API-familiar stand-in for the reference's ACME SLURM helper
    (reference __init__.py:72-79): on accelerators there is no external scheduler —
    "starting a cluster" means installing a device mesh. Builds a
    ``("trial", "channel")`` mesh over `n_workers` devices (all devices if
    None), installs it as the active mesh for subsequent frontend calls,
    and returns it. Tear down with :func:`cluster_cleanup`.
    Extra ACME kwargs (partition, mem_per_worker, ...) are accepted and
    ignored for drop-in compatibility.
    """
    devices = jax.devices()
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
    Map the user-facing ``parallel`` kwarg to a mesh (or None = single device).

    - ``None``: active mesh if installed, else single-device.
    - ``True``: active mesh if installed, else a fresh mesh over all devices.
    - ``False``: single-device.
    """
    if parallel is False:
        return None
    if _ACTIVE_MESH is not None:
        return _ACTIVE_MESH
    if parallel:
        n_dev = len(jax.devices())
        if n_dev == 1:
            from ..shared.errors import SPYWarning

            SPYWarning(
                "`parallel=True` but only ONE device is visible — no mesh to "
                "build, running single-device (the analog of the reference's "
                "'no parallel computing client found')"
            )
            return None
        return make_mesh()
    return None


def trial_sharding(mesh, ndim, channel_axis_pos=None):
    """
    NamedSharding that shards axis 0 (the stacked trial/batch axis) over the
    mesh's trial axis, and optionally one more array axis over the channel
    mesh axis.
    """
    spec = [None] * ndim
    spec[0] = TRIAL_AXIS
    if channel_axis_pos is not None and mesh.shape[CHANNEL_AXIS] > 1:
        spec[channel_axis_pos] = CHANNEL_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh):
    return NamedSharding(mesh, P())


def pad_to_multiple(n, m):
    """Smallest multiple of `m` >= `n`."""
    return int(math.ceil(n / m) * m) if m > 1 else int(n)


def shard_batch(host_batch, mesh, channel_axis_pos=None):
    """
    Transfer a host batch (numpy, leading axis = trials) to device(s).

    When a mesh is given, the batch axis is padded up to a multiple of the
    trial-axis size (padding trials are zero and must be masked/cropped by
    the caller) and the array is placed with a trial-sharded NamedSharding.

    Returns ``(device_array, n_valid)``.
    """
    n = host_batch.shape[0]
    if mesh is None:
        return jax.device_put(host_batch), n
    n_shard = mesh.shape[TRIAL_AXIS]
    n_pad = pad_to_multiple(n, n_shard)
    if n_pad != n:
        pad_width = [(0, n_pad - n)] + [(0, 0)] * (host_batch.ndim - 1)
        host_batch = np.pad(host_batch, pad_width)
    # only shard the channel axis when it divides evenly
    if channel_axis_pos is not None:
        n_chan_shard = mesh.shape[CHANNEL_AXIS]
        if host_batch.shape[channel_axis_pos] % n_chan_shard != 0:
            channel_axis_pos = None
    sharding = trial_sharding(mesh, host_batch.ndim, channel_axis_pos)
    return jax.device_put(host_batch, sharding), n
