# -*- coding: utf-8 -*-
#
# Multi-host dryrun worker: one of N processes in a `jax.distributed`
# CPU cluster (the device-native replacement for the reference's SLURM/ACME
# worker processes, syncopy/shared/kwarg_decorators.py:415-584).
#
#   python scripts/multihost_worker.py <process_id> <num_processes> <port>
#
# Each process contributes 4 virtual CPU devices; the script initializes
# the distributed runtime through syncopy_tpu.init_distributed, builds the
# package's ("trial", "channel") mesh over the GLOBAL device set, and runs
# one trial-sharded coherence pipeline step with a cross-process psum —
# verifying the result against a local numpy oracle on every process.

import os
import sys

proc_id, n_procs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=4 "
    + os.environ.get("XLA_FLAGS", "")
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import syncopy_tpu as spy  # noqa: E402

# must run BEFORE any backend query: the coordinator (process 0) serves
# the cluster barrier that every jax.devices() call synchronizes on
spy.init_distributed(
    coordinator_address="localhost:{}".format(port),
    num_processes=n_procs,
    process_id=proc_id,
)

n_global = len(jax.devices())
n_local = len(jax.local_devices())
assert n_global == 4 * n_procs, (n_global, n_procs)
assert n_local == 4, n_local
assert jax.process_index() == proc_id

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402

from syncopy_tpu.ops.connectivity import normalize_csd  # noqa: E402

# global mesh over every device of every process
mesh = spy.make_mesh()
assert mesh.devices.size == n_global

T, C, B_LOC = 128, 4, 3  # per-shard trial count


def _local_trials(seed):
    rng = np.random.default_rng(int(seed))
    return rng.normal(size=(B_LOC, T, C)).astype(np.float32)


def _csd_of(x):
    spec = jnp.fft.rfft(x - x.mean(axis=1, keepdims=True), axis=1)
    return jnp.einsum("bfi,bfj->fij", spec, jnp.conj(spec))


def per_shard(xs):
    # xs: (1, B_LOC, T, C) — this shard's trials
    cs = _csd_of(xs[0])
    total = jax.lax.psum(cs, spy.parallel.mesh.TRIAL_AXIS)
    n = jax.lax.psum(jnp.asarray(B_LOC, jnp.float32), spy.parallel.mesh.TRIAL_AXIS)
    return normalize_csd(total / n, "abs")


n_shards = mesh.shape[spy.parallel.mesh.TRIAL_AXIS]
host_all = np.stack([_local_trials(s) for s in range(n_shards)])  # (S, B, T, C)

# build the GLOBAL sharded input: each process materializes only the
# shards that live on its addressable devices
sharding = NamedSharding(mesh, P(spy.parallel.mesh.TRIAL_AXIS))
garr = jax.make_array_from_callback(
    host_all.shape, sharding, lambda idx: host_all[idx]
)

step = jax.jit(
    shard_map(
        per_shard, mesh=mesh,
        in_specs=P(spy.parallel.mesh.TRIAL_AXIS),
        out_specs=P(),
    )
)
res = step(garr)

# replicated output: every process holds the full result locally
local = np.asarray(res.addressable_shards[0].data)

# numpy oracle of the identical math over ALL shards
x_all = host_all.reshape(-1, T, C).astype(np.float64)
spec = np.fft.rfft(x_all - x_all.mean(axis=1, keepdims=True), axis=1)
cs = np.einsum("bfi,bfj->fij", spec, np.conj(spec)) / x_all.shape[0]
diag = np.abs(np.einsum("fii->fi", cs))
with np.errstate(invalid="ignore"):
    want = np.abs(cs) / np.sqrt(diag[:, :, None] * diag[:, None, :])

# the demeaned DC bin is 0/0 in any implementation — compare the rest
err = np.abs(local - want)[1:].max()
assert err < 1e-5, err
print("MULTIHOST OK process {}/{} global_devices={} err={:.2e}".format(
    proc_id, n_procs, n_global, err), flush=True)
