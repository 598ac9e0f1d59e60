# -*- coding: utf-8 -*-
#
# ComputationalRoutine: the compute engine.
#
# Parity target: reference syncopy/shared/computational_routine.py:51-1231.
# Device-native redesign:
#
#   reference                            this engine
#   ----------------------------------   -------------------------------------
#   noCompute dry-run on FauxTrials      jax.eval_shape on ShapeDtypeStructs
#   Dask client.map over trials          vmap over a padded trial batch,
#                                        sharded over the mesh "trial" axis
#   per-worker HDF5 writes + VDS         chunked host<->HBM streaming with
#                                        async dispatch (double buffering)
#   keeptrials=False += accumulation     on-device sum (psum across shards)
#   memory admission checks              static chunk sizing from HBM budget
#   parallel_debug single-thread         jax.disable_jit()
#
# Trials are bucketed by exact post-selection shape: each bucket compiles
# once (static shapes for XLA) and streams through the device(s) in chunks.

import os
import time as _time

import numpy as np

import jax
import jax.numpy as jnp

from ..parallel.device_io import decode_host, decode_in_jit, encode_host, encode_in_jit
from ..parallel.mesh import (
    CHANNEL_AXIS,
    TRIAL_AXIS,
    pad_to_multiple,
    resolve_parallel,
    shard_batch,
    trial_sharding,
)
from ..shared.errors import SPYError, SPYValueError
from ..shared.log import get_logger
from .resident import DeferredArray, DeviceResident, Record, _admit, resident_budget_bytes

__all__ = ["ComputationalRoutine"]

#: default HBM budget per compute chunk (bytes); overridable via env
DEFAULT_CHUNK_BUDGET = int(os.environ.get("SPY_TPU_CHUNK_BYTES", 2 * 1024**3))

#: hard cap on trials per compute chunk (bounds compile time / HBM spikes)
MAX_CHUNK_TRIALS = int(os.environ.get("SPY_TPU_MAX_CHUNK", 1024))

#: print per-phase engine timings (host gather / transfer / dispatch / fetch)
PROFILE = bool(int(os.environ.get("SPY_TPU_PROFILE", "0")))

#: optional reduced-precision host->device ingest ("float16" halves PCIe
#: bytes; kernels upcast to float32 on device). Raw electrophysiology
#: is <=16-bit ADC data, so float16 ingest loses nothing for typical inputs.
TRANSFER_DTYPE = os.environ.get("SPY_TPU_TRANSFER_DTYPE", "")


def _readback_dtype():
    """Optional reduced-precision device->host readback for per-trial REAL
    outputs (power spectra, TFRs): ``SPY_TPU_READBACK_DTYPE=float16`` halves
    the bytes on the readback-bound paths (~1e-3 relative quantization).
    Complex/fourier outputs are never downcast (phase would degrade)."""
    return os.environ.get("SPY_TPU_READBACK_DTYPE", "")

#: host-RAM threshold above which outputs are written to disk-backed HDF5
DEFAULT_HOST_BUDGET = int(os.environ.get("SPY_TPU_HOST_BYTES", 16 * 1024**3))

def _dispatch_with_recovery(thunk, rebuild=None, what="device dispatch"):
    """
    Run `thunk`; on device OOM (RESOURCE_EXHAUSTED) evict the device
    trial store and resident results (residents are materialized first —
    no data loss) and retry ONCE (SURVEY §5 aux subsystem; the reference
    delegates recovery to Dask worker restarts). Every other error is
    raised as it is. `rebuild` (optional) reconstructs the thunk's device
    inputs from host state for the retry.
    """
    try:
        return thunk()
    except Exception as exc:  # jax runtime errors subclass differently per version
        if "RESOURCE_EXHAUSTED" not in str(exc):
            raise
        get_logger().warning("%s: device OOM — evicting device caches and retrying", what)
        clear_device_cache()
    if rebuild is not None:
        thunk = rebuild()
    return thunk()


#: one-shot flag so the trial-store-bypass warning fires once per process
_FINGERPRINT_BYPASS_LOGGED = False

#: process-global compiled-function cache: identical (CR class, cfg,
#: shapes, mesh) reuse the XLA executable across frontend calls — without
#: this every frontend invocation would re-trace and re-compile
_GLOBAL_JIT_CACHE = {}

#: Device-resident trial store: encoded device chunks keyed by
#: (dataset identity+mutation counter, selection, chunking, mesh). Repeated
#: analyses on the same (selected) data skip the host->device upload — the
#: device analog of the reference's OS page cache over HDF5 re-reads.
#: Bounded LRU by bytes; disable with SPY_TPU_DEVICE_CACHE_BYTES=0.
DEVICE_CACHE_BYTES = int(os.environ.get("SPY_TPU_DEVICE_CACHE_BYTES", 4 * 1024**3))
_DEVICE_CACHE = {}  # key -> list of device chunks
_DEVICE_CACHE_ORDER = []  # LRU order of keys
_DEVICE_CACHE_SIZE = [0]


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
    if key in _DEVICE_CACHE_ORDER:
        _DEVICE_CACHE_ORDER.remove(key)
        _DEVICE_CACHE_ORDER.append(key)
    return entry[0]


def clear_device_cache():
    """Drop all HBM-cached trial batches and flush device-resident results
    to host (resident payloads are materialized first — never lost)."""
    from .resident import materialize_all

    materialize_all()
    _DEVICE_CACHE.clear()
    _DEVICE_CACHE_ORDER.clear()
    _DEVICE_CACHE_SIZE[0] = 0
    _DEVICE_CONST_CACHE.clear()


#: HBM-resident per-CR constants (e.g. wavelet convolution banks): large
#: numpy arrays a traced program needs, passed as RUNTIME arguments so
#: they are uploaded once per (CR, cfg, trial shape) instead of embedded
#: as executable literals — embedded 100 MB+ constants blow the remote
#: compile payload limit (HTTP 413) and re-ship per chunk-size bucket.
_DEVICE_CONST_CACHE = {}

#: memoized (out_shape, dtype) of the per-trial abstract evaluation —
#: keyed by CR class + cfg fingerprint + input/aux shapes (initialize)
_EVAL_SHAPE_CACHE = {}


def _device_consts_get(cr, shp, consts_np, mesh):
    """Device (replicated-on-mesh) versions of a CR's declared constants,
    cached process-globally; constants must be REAL-dtype numpy arrays
    (complex cannot cross the host->device boundary on this runtime)."""
    if not consts_np:
        return ()
    key = (
        cr.__class__.__qualname__,
        _cfg_fingerprint(cr.cfg),
        shp,
        None if mesh is None else tuple(mesh.shape.items()),
        cr.extra_cache_key(),
    )
    hit = _DEVICE_CONST_CACHE.get(key)
    if hit is not None:
        return hit
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        sharding = NamedSharding(mesh, PartitionSpec())
        dev = tuple(jax.device_put(np.asarray(a), sharding) for a in consts_np)
    else:
        dev = tuple(jax.device_put(np.asarray(a)) for a in consts_np)
    _DEVICE_CONST_CACHE[key] = dev
    return dev


def _allocate_host_output(shape, dtype, owner):
    """Host target for a stacked result: RAM, or a disk-backed HDF5 dataset
    when over ``SPY_TPU_HOST_BYTES`` (shared by the eager preallocation and
    the deferred resident readback — reference preallocate_output,
    computational_routine.py:750-804)."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes > DEFAULT_HOST_BUDGET and owner is not None:
        import h5py

        from ..datatype.util import gen_session_filename

        fname = owner.filename
        # never truncate a file that already holds data (a reused output
        # object, or a payload another dataset handle still points into):
        # spill to a fresh session temp file and re-point the object
        holds_data = (
            owner._hdfFile is not None
            or isinstance(getattr(owner, "_data", None), h5py.Dataset)
            or (os.path.exists(fname) and os.path.getsize(fname) > 0)
        )
        if holds_data:
            # the current payload (and any open handle on it) stays intact
            # until the new result replaces it after the compute succeeds
            ext = os.path.splitext(fname)[1] or ".dat"
            fname = gen_session_filename(ext)
            owner._filename = fname
        f = h5py.File(fname, "w")
        dset = f.create_dataset("data", shape=shape, dtype=dtype)
        owner._hdfFile = f
        owner._is_temp_file = True
        return dset
    return np.empty(shape, dtype=dtype)


def _materialize_resident(resident):
    """Readback closure for :class:`DeviceResident`: reconstruct the stacked
    host output from the per-chunk device buffers (the deferred counterpart
    of the eager ``_write_chunk`` path)."""
    host_out = _allocate_host_output(resident.shape, resident.dtype, resident._owner())
    sdim = resident.stackingdim
    offsets = resident.offsets
    for rec in resident.records:
        fetched = _dispatch_with_recovery(
            lambda rec=rec: _fetch_readback(_flatten_dev(rec.dev), rec.enc_shape),
            what="deferred result readback",
        )
        arr = decode_host(fetched, resident.was_complex, axis=1)[: len(rec.positions)]
        for i, pos in enumerate(rec.positions):
            row0, row1 = offsets[pos], offsets[pos + 1]
            sl = [slice(None)] * (arr.ndim - 1)
            sl[sdim] = slice(row0, row1)
            host_out[tuple(sl)] = arr[i]
    return host_out


def _resident_input(rec, mesh, chan_axis):
    """Turn a resident record's (N, 128) readback-layout buffer back into
    the engine's encoded input batch layout, entirely on device (a reshape
    program, no host transfer), re-sharded for the consumer's mesh."""
    key = ("resident_unflat", rec.enc_shape, str(rec.dev.dtype))
    if key not in _GLOBAL_JIT_CACHE:
        n = int(np.prod(rec.enc_shape))
        enc_shape = rec.enc_shape

        def unflat(x):
            if x.dtype == jnp.float16:
                x = x.astype(jnp.float32)
            return x.reshape(-1)[:n].reshape(enc_shape)

        _GLOBAL_JIT_CACHE[key] = jax.jit(unflat)
    arr = _GLOBAL_JIT_CACHE[key](rec.dev)
    if mesh is not None:
        chan_ok = (
            chan_axis is not None
            and arr.shape[chan_axis] % mesh.shape[CHANNEL_AXIS] == 0
        )
        sharding = trial_sharding(mesh, arr.ndim, chan_axis if chan_ok else None)
        arr = jax.device_put(arr, sharding)
    return arr


def _flatten_for_readback(x):
    """Inside jit: relayout to (N, 128) readback planes, so every host
    fetch moves arrays with a 128-wide trailing dim."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % 128
    if pad:
        flat = jnp.pad(flat, (0, pad))
    return flat.reshape(-1, 128)


def _flatten_dev(res):
    """Relayout a natural-layout encoded chunk to (N, 128) readback planes
    ON DEVICE, immediately before a host fetch. Chunks are kept in their
    natural layout in device memory (an in-program relayout would cost a
    second write of every chunk); the relayout is paid for with this one
    extra dispatch only when a chunk actually crosses to the host."""
    key = ("flatten_dev", tuple(res.shape), str(res.dtype))
    if key not in _GLOBAL_JIT_CACHE:
        _GLOBAL_JIT_CACHE[key] = jax.jit(_flatten_for_readback)
    return _GLOBAL_JIT_CACHE[key](res)


def _fetch_readback(dev2d, enc_shape):
    """Host side: undo :func:`_flatten_for_readback`."""
    flat = np.asarray(jax.device_get(dev2d)).reshape(-1)
    n = int(np.prod(enc_shape))
    return flat[:n].reshape(enc_shape)


def _cfg_fingerprint(obj):
    """Hashable deep fingerprint of a CR cfg dict (arrays by content)."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _cfg_fingerprint(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_cfg_fingerprint(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return (obj.shape, str(obj.dtype), hash(obj.tobytes()))
    if isinstance(obj, (str, int, float, bool, complex, type(None))):
        return obj
    # wavelet instances etc.: identity by class + public attrs
    attrs = tuple(
        sorted((k, v) for k, v in vars(obj).items() if isinstance(v, (str, int, float, bool)))
    )
    return (obj.__class__.__name__, attrs)


class ComputationalRoutine:
    """
    Base class of all compute routines.

    Subclasses implement:

    ``process_single_trial(trial, **cfg)``
        Pure, jit-safe function mapping one (selected) trial array to one
        output array. The engine vmaps it over trial batches. ``cfg`` is the
        dict passed to ``__init__``.

    ``process_metadata(data, out)``
        Attach dimensional properties (channel, freq, ...) and the output
        trialdefinition to `out` after the numeric pass.

    Optionally:

    ``process_batch(batch, **cfg)``
        Override for kernels that are natively batched (bypasses vmap).

    ``per_trial_inputs(data, trial_positions)``
        Return a tuple of numpy arrays with leading axis ``len(trial_
        positions)`` that are vmapped alongside the trial batch (for
        per-trial auxiliary inputs).
    """

    # computed by initialize()
    outputShape = None
    dtype = None

    #: declarative aux-info semantics: a frozenset of aux keys that are
    #: per-trial (leading axis = chunk batch; padding rows dropped, values
    #: keyed by selected-trial position). Keys NOT in the set are per-chunk.
    #: None (default) falls back to the leading-axis heuristic with the
    #: ``chunk_`` key-prefix escape — subclasses emitting aux info should
    #: declare this explicitly (a fused reduction whose aux leading dim
    #: coincidentally equals the chunk size would otherwise misclassify).
    aux_per_trial = None

    #: batch multi-trial chunks via ``lax.map`` (serial scan, body traced
    #: unbatched) instead of ``jax.vmap``. Set True on routines containing a
    #: ``lax.while_loop`` that the batching rewrite must never touch
    #: (Wilson factorization: a vmapped copy of that loop once
    #: miscompiled and diverged).
    sequential_batch = False

    def __init__(self, **cfg):
        self.cfg = dict(cfg)
        self.keeptrials = True
        self.aux_info = {}
        self.buckets = None
        self.out_per_trial_shapes = None
        self.selector = None
        self._chunk_budget = DEFAULT_CHUNK_BUDGET
        self.log_dict = None

    # ------------------------------------------------------------------ #
    # subclass interface
    # ------------------------------------------------------------------ #

    def process_single_trial(self, trial, *aux, **cfg):
        raise NotImplementedError

    def process_batch(self, batch, *aux, **cfg):
        if batch.shape[0] == 1:
            # batch-of-one bypass: semantically identical to the vmap below
            # (leading axis re-attached to every output leaf), but it keeps
            # single-trial control flow UNBATCHED. jax.vmap over a
            # `lax.while_loop` compiles the loop's batched rewrite, which
            # once miscompiled for wide-channel Wilson factorization (at
            # 128 ch the vmapped batch-of-one program diverged while the
            # identical math without vmap converged; whether the GPU
            # needs this bypass is not yet measured).
            # Trial-average AV routines always arrive here with one row,
            # and the per-trial byte budget (device_bytes_per_trial) forces
            # 1-row chunks for wide factorizations, so the hazardous shapes
            # all take this path.
            res = self.process_single_trial(
                batch[0], *(a[0] for a in aux), **cfg
            )
            return jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], res)
        if self.sequential_batch:
            # lax.map = scan over the leading axis: the trial body is traced
            # ONCE, UNBATCHED, and executed serially — no batched
            # while_loop rewrite (see the batch-of-one bypass above).
            # Routines whose per-trial work is itself a large
            # batched linalg program (GrangerCausality: the factorization is
            # batched over frequency) lose nothing to the serialization —
            # the chip is saturated per replicate already.
            return jax.lax.map(
                lambda xs: self.process_single_trial(xs[0], *xs[1:], **cfg),
                (batch,) + tuple(aux),
            )
        return jax.vmap(lambda x, *a: self.process_single_trial(x, *a, **cfg))(batch, *aux)

    def per_trial_inputs(self, data, trial_positions):
        return ()

    def process_metadata(self, data, out):
        raise NotImplementedError

    def extra_cache_key(self):
        """Hashable state the traced program depends on beyond cfg/shapes
        (e.g. env knobs read at trace time). Part of the executable cache
        key — override when process_single_trial's tracing reads such
        state, or a mid-process knob flip silently reuses the stale
        executable."""
        return None

    #: traced device constants, bound by the engine for the duration of a
    #: trace (see :meth:`device_constants`); None outside the engine
    _live_consts = None
    #: the mesh the batch is sharded over (None on one device), bound by
    #: the engine for the duration of a trace like ``_live_consts``
    _live_mesh = None

    def device_constants(self, shp):
        """Large REAL-dtype numpy constants the traced program needs for
        input trial shape `shp` (e.g. a wavelet convolution bank). The
        engine uploads them ONCE per (CR class, cfg, shp) via device_put
        and passes them as runtime arguments; during tracing they are
        visible to process_single_trial as ``self._live_consts`` (a tuple
        of tracers, broadcast across the trial vmap). Embedding them as
        closure literals instead would bake them into every executable
        and duplicate them per chunk-size bucket."""
        return ()

    # ------------------------------------------------------------------ #
    # initialize: shape planning (reference computational_routine.py:240-511)
    # ------------------------------------------------------------------ #

    def initialize(self, data, out_stackingdim, chan_per_worker=None, keeptrials=True):
        from ..datatype.selector import Selector

        self.keeptrials = bool(keeptrials)
        self.out_stackingdim = int(out_stackingdim)
        if chan_per_worker is not None:
            get_logger().info(
                "chan_per_worker is advisory in this engine (channel axis "
                "sharding is controlled by the mesh); ignoring block size %s",
                chan_per_worker,
            )

        self.selector = data.selection if data.selection is not None else Selector(data, None)
        n_sel = len(self.selector.trial_ids)
        if n_sel == 0:
            raise SPYValueError(legal="at least one selected trial", varname="trials", actual="0")

        # per-(selected-)trial input shapes after applying the selection
        sel = self.selector
        tsel = getattr(sel, "time", None)
        # a Selector built with no explicit time/latency constraint still
        # materializes per-trial slice(None) entries — treat that as "no
        # time selection" or the vectorized fast path below never fires
        trivial_time = tsel is None or all(t == slice(None) for t in tsel)
        if "sample" not in data.dimord and trivial_time:
            # fast path: without a time selection, trials differ only in the
            # stacking-dim extent — vectorize over sampleinfo instead of
            # indexing per trial (hot for 1000s of trials)
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
        in_dtype = np.dtype(data.data.dtype)

        # bucket positions by identical shape (static shapes for XLA)
        buckets = {}
        for pos, shp in enumerate(shapes):
            buckets.setdefault(shp, []).append(pos)
        self.buckets = buckets

        # output shape per bucket via abstract evaluation; the trace is
        # pure in (class, cfg, shapes), so memoize it process-globally —
        # re-tracing costs ~10 ms per warm frontend call for nothing
        self.out_per_trial_shapes = {}
        out_dtype = None
        for shp, positions in buckets.items():
            aux = self.per_trial_inputs(data, positions[:1])
            aux_structs = tuple(jax.ShapeDtypeStruct(a.shape[1:], a.dtype) for a in aux)
            key = (
                self.__class__.__qualname__, "eval_shape",
                _cfg_fingerprint(self.cfg), shp, str(in_dtype),
                tuple((s.shape, str(s.dtype)) for s in aux_structs),
                self.extra_cache_key(),
            )
            hit = _EVAL_SHAPE_CACHE.get(key)
            if hit is None:
                spec = jax.ShapeDtypeStruct(shp, in_dtype)
                res = jax.eval_shape(
                    lambda x, *a: self.process_single_trial(x, *a, **self.cfg),
                    spec, *aux_structs,
                )
                if isinstance(res, tuple):  # (output, aux-info dict)
                    res = res[0]
                hit = (tuple(res.shape), np.dtype(res.dtype))
                _EVAL_SHAPE_CACHE[key] = hit
            self.out_per_trial_shapes[shp] = hit
            out_dtype = hit[1]

        self._fast_plan = self._plan_fast_gather(data)

        out_shapes = [self.out_per_trial_shapes[shp][0] for shp in shapes]
        if not self.keeptrials:
            if len(set(out_shapes)) > 1:
                raise SPYValueError(
                    legal="identical trial shapes for trial averaging",
                    varname="keeptrials",
                    actual="shapes {}".format(sorted(set(out_shapes))),
                )

        # total output shape: stack per-trial outputs along out_stackingdim
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
        # pristine copies: compute() may overlay a fused post-transform shape,
        # and must be re-runnable (idempotent) on the same initialized CR
        self._base_outputShape = tuple(out_total)
        self._base_dtype = out_dtype
        self._per_trial_out_shapes_ordered = out_shapes
        self.numTrials = n_sel

    def _selection_fingerprint(self, data):
        """Hashable description of the active selection's gather plan (for
        the HBM trial-store cache key). Returns None — disabling the trial
        store for this run — when the selection cannot be fingerprinted;
        that is correctness-safe but a silent perf cliff, so it is logged
        (once per process) to keep the bypass visible."""
        sel = self.selector
        try:
            parts = [tuple(sel.trial_ids)]
            for k in range(len(sel.trial_ids)):
                parts.append(repr(sel.trial_indexer(data, k)))
            return hash(tuple(parts))
        except Exception as exc:
            global _FINGERPRINT_BYPASS_LOGGED
            if not _FINGERPRINT_BYPASS_LOGGED:
                _FINGERPRINT_BYPASS_LOGGED = True
                get_logger().warning(
                    "%s: selection cannot be fingerprinted (%s) — the HBM "
                    "trial store is bypassed for this run (repeated analyses "
                    "will re-upload their inputs)",
                    self.__class__.__name__, repr(exc)[:120],
                )
            return None

    def _plan_fast_gather(self, data):
        """
        Precompute a vectorized host-gather plan: when the (selected) trials
        are plain time-slices of an in-memory array with identical
        per-dimension indexers, a whole chunk is assembled with ONE fancy
        gather instead of per-trial copies (the host-side analog of the
        reference's per-worker HDF5 reads).
        """
        from ..shared.tools import is_h5_dataset

        sel = self.selector
        if "sample" in data.dimord:
            return None
        is_hdf5 = is_h5_dataset(data.data)
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
            if plan["hdf5"]:
                # HDF5: one contiguous slice per chunk when possible
                # (per-row fancy reads are slow through h5py)
                if starts.size > 1 and np.all(np.diff(starts) == L):
                    arr = data.data[int(starts[0]) : int(starts[-1]) + L]
                    batch = np.asarray(arr).reshape((len(pos), L) + data.data.shape[1:])
                else:
                    batch = np.stack([data.data[int(s) : int(s) + L] for s in starts], axis=0)
            else:
                idx = starts[:, None] + np.arange(L)
                batch = data.data[idx]
            # original data axis k lands on batch axis k+1 (trial axis first);
            # plan["others"] starts at original axis 1 -> batch axis 2
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

    def compute(self, data, out, parallel=None, parallel_store=None, method=None,
                mem_thresh=None, log_dict=None, parallel_debug=False,
                post_device_fn=None, post_key=None,
                post_pack=None, post_unpack=None, post_pack_complex=False,
                device_resident=None):
        """
        Run the routine. `post_device_fn` (with a hashable `post_key` for
        executable caching) is an optional device-side transform fused onto
        the trial-averaged result when ``keeptrials=False`` — it replaces a
        separate averaged-input pass (no intermediate host round-trip).
        `post_pack` (device, jit-safe) / `post_unpack` (host) optionally
        compress the fused result for the device->host readback (e.g.
        triangular packing of symmetric connectivity matrices — halves the
        readback bytes losslessly); `post_pack` must return a REAL array.
        Set `post_pack_complex=True` when that real array ENCODES complex
        content (e.g. Hermitian-packed CSDs) so reduced-precision readback
        (``SPY_TPU_READBACK_DTYPE``) never downcasts it.

        `device_resident` controls whether per-trial results stay in HBM
        with a deferred host readback (see ``engine/resident.py``): True /
        False force it, None (default) enables it for ``keeptrials=True``
        runs within the ``SPY_TPU_RESIDENT_BYTES`` budget (opt out globally
        with ``SPY_TPU_DEVICE_RESIDENT=0``).
        """
        if self.buckets is None:
            raise SPYError("call initialize() before compute()")
        self.log_dict = log_dict
        self._post_fn = post_device_fn
        self._post_pack = post_pack
        self._post_unpack = post_unpack
        self._post_pack_complex = bool(post_pack_complex)
        self._post_key = post_key
        # restart from the pristine initialize() shape every call so a second
        # compute() on the same CR never double-applies the post transform
        self.outputShape = self._base_outputShape
        self.dtype = self._base_dtype
        self.aux_info = {}
        self._aux_per_trial = {}
        self._aux_chunked = {}
        if post_device_fn is not None and not self.keeptrials:
            spec = jax.ShapeDtypeStruct(self.outputShape, self.dtype)
            res = jax.eval_shape(post_device_fn, spec)
            self.outputShape = tuple(res.shape)
            self.dtype = np.dtype(res.dtype)

        mesh = resolve_parallel(parallel)
        self._resident_mode = self._decide_resident(device_resident, parallel_debug)
        if parallel_debug:
            with jax.disable_jit():
                self._run(data, out, mesh=None)
        else:
            self._run(data, out, mesh=mesh)

        self._finalize_aux()
        # provenance
        self.write_log(data, out, log_dict)
        self.process_metadata(data, out)
        # seal AFTER process_metadata: the trialdefinition assignment bumps
        # the owner's cache token; consumers match against the sealed value
        if getattr(out, "_device_resident", None) is not None:
            out._device_resident.seal()

    def _decide_resident(self, device_resident, parallel_debug):
        """Should this run keep per-trial results in HBM (deferred readback)?"""
        if device_resident is False or parallel_debug or not self.keeptrials:
            return False
        if os.environ.get("SPY_TPU_DEVICE_RESIDENT", "1") == "0" and device_resident is not True:
            return False
        budget = resident_budget_bytes()
        est = int(np.prod(self.outputShape)) * self.dtype.itemsize
        denied = (budget <= 0
                  or (device_resident is None and est > budget)
                  or not _admit(est))
        if denied and device_resident is True:
            get_logger().warning(
                "device_resident=True requested but the HBM budget "
                "(SPY_TPU_RESIDENT_BYTES=%d) cannot hold %d bytes — "
                "falling back to eager host readback", budget, est,
            )
        return not denied

    def _accumulate_aux(self, aux_info, chunk_pos, n_valid, chunk_size):
        """Collect one chunk's aux-info dict. Classification is declarative
        when the CR sets :attr:`aux_per_trial`: keys in the set are
        per-trial (padding rows dropped, values recorded under their
        selected-trial position), all others per-chunk. Without a
        declaration, entries whose leading axis is the chunk batch are
        treated as per-trial, with a ``chunk_`` key-prefix escape forcing
        per-chunk handling."""
        declared = self.aux_per_trial
        for k, v in aux_info.items():
            arr = np.asarray(jax.device_get(v))
            if declared is not None:
                is_per_trial = k in declared
                if is_per_trial and (arr.ndim < 1 or arr.shape[0] != chunk_size):
                    raise SPYError(
                        "{}: aux key '{}' is declared per-trial but its "
                        "leading axis is {} (chunk size {})".format(
                            self.__class__.__name__, k,
                            arr.shape[:1] or "scalar", chunk_size,
                        )
                    )
            else:
                is_per_trial = (arr.ndim >= 1 and arr.shape[0] == chunk_size
                                and not k.startswith("chunk_"))
            if is_per_trial:
                per_trial = self._aux_per_trial.setdefault(k, {})
                for i, pos in enumerate(chunk_pos[: int(n_valid)]):
                    per_trial[pos] = arr[i]
            else:
                self._aux_chunked.setdefault(k, []).append(arr)

    def _finalize_aux(self):
        """Assemble ``self.aux_info``: per-trial entries stack to a leading
        ``numTrials`` axis in selected-trial order; per-chunk entries stack
        along a new leading chunk axis (single-chunk runs stay unwrapped)."""
        aux = {}
        for k, per_trial in self._aux_per_trial.items():
            rows = [per_trial[p] for p in sorted(per_trial)]
            aux[k] = np.stack(rows, axis=0) if rows else np.empty((0,))
        for k, chunks in self._aux_chunked.items():
            if k in aux:  # same label used both ways: per-trial wins
                continue
            aux[k] = chunks[0] if len(chunks) == 1 else np.stack(chunks, axis=0)
        if aux:
            self.aux_info = aux

    # -- execution ------------------------------------------------------ #

    def _plan_resident_consume(self, data, mesh):
        """When `data`'s payload is a sealed device-resident result and no
        selection is active, map every bucket to the producer's HBM chunk
        records — the consumer then skips the host gather + upload entirely.
        Returns ``{bucket_shape: [Record, ...]}`` or None (host path)."""
        res = getattr(data, "_device_resident", None)
        if res is None or not res.consumable_by(data):
            return None
        if data.selection is not None:
            return None
        n_shard = mesh.shape[TRIAL_AXIS] if mesh is not None else 1
        by_shape = {}
        for rec in res.records:
            by_shape.setdefault(rec.trial_shape, []).append(rec)
        plan = {}
        for shp, positions in self.buckets.items():
            recs = by_shape.get(shp)
            if recs is None:
                return None
            covered = [p for r in recs for p in r.positions]
            if covered != list(positions):
                return None
            if any(r.chunk % n_shard for r in recs):
                return None
            plan[shp] = recs
        return plan

    def _run(self, data, out, mesh):
        sdim = self.out_stackingdim
        resident_out = bool(getattr(self, "_resident_mode", False))
        host_out = None if resident_out else self._preallocate_output(out)
        # dtype of the per-trial kernel outputs (differs from self.dtype when
        # a fused post_device_fn changes the final dtype)
        kernel_dtype = next(iter(self.out_per_trial_shapes.values()))[1]
        acc_complex = np.issubdtype(kernel_dtype, np.complexfloating)
        out_complex = acc_complex if getattr(self, "_post_fn", None) is None else (
            np.issubdtype(self.dtype, np.complexfloating)
        )

        # row offsets of each selected trial in the stacked output
        stack_lens = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
        offsets = np.concatenate([[0], np.cumsum(stack_lens)]).astype(int)

        consume_plan = self._plan_resident_consume(data, mesh)
        if consume_plan is None and isinstance(getattr(data, "_data", None), DeferredArray):
            # residency not directly consumable (selection active, shape or
            # mesh mismatch): fall back to the host path — materialize once
            # and restore the vectorized gather plan
            data._data._ensure()
            self._fast_plan = self._plan_fast_gather(data)

        acc = None  # on-device accumulator for keeptrials=False (encoded real)
        resident_records = []
        n_shard = mesh.shape[TRIAL_AXIS] if mesh is not None else 1

        for shp, positions in self.buckets.items():
            aux_all = self.per_trial_inputs(data, positions)
            in_bytes = int(np.prod(shp)) * np.dtype(data.data.dtype).itemsize
            out_shp, out_dt = self.out_per_trial_shapes[shp]
            out_bytes = int(np.prod(out_shp)) * out_dt.itemsize
            if not self.keeptrials and hasattr(self, "process_batch_sum"):
                # fused reduction: per-trial outputs are never materialized
                out_bytes = 0
            per_trial = (in_bytes + out_bytes) * 2
            # CRs with large internal workspaces (e.g. CWT FFT banks)
            # declare them so chunk sizing respects HBM
            budget = self._chunk_budget
            mem_hook = getattr(self, "device_bytes_per_trial", None)
            if mem_hook is not None:
                workspace = int(mem_hook(shp, out_shp, out_dt))
                if self.sequential_batch:
                    # lax.map runs ONE trial body at a time: the declared
                    # workspace is live once per chunk (reused across scan
                    # iterations), not once per row — reserve it off the
                    # budget and size the chunk by the stacked i/o alone
                    budget = max(budget - workspace, per_trial)
                else:
                    per_trial = max(per_trial, workspace)
            chunk = max(n_shard, int(budget // max(per_trial, 1)))
            chunk = min(chunk, MAX_CHUNK_TRIALS)
            # round to a power of two and keep it FIXED regardless of the
            # trial count: partial chunks are zero-padded so every chunk of
            # a bucket hits the same compiled executable
            chunk = 1 << max(chunk.bit_length() - 1, 0)
            chunk = min(chunk, 1 << (max(len(positions), 1) - 1).bit_length())
            chunk = pad_to_multiple(max(chunk, n_shard), n_shard)

            in_complex = np.issubdtype(np.dtype(data.data.dtype), np.complexfloating)
            # complex aux inputs (e.g. a complex trial average) must cross
            # the host->device boundary encoded as real pairs, exactly like
            # the main batch (the engine's one boundary encoding)
            aux_complex = tuple(np.iscomplexobj(np.asarray(a[:1])) for a in aux_all)
            fn = self._get_compiled(shp, mesh, in_complex, aux_complex)
            dev_consts = _device_consts_get(
                self, shp, tuple(self.device_constants(shp)), mesh
            )

            # channel mesh axis: shard the data's channel dimension too (the
            # reference's chan_per_worker analog); batch axis 0 is the trial
            # axis, +1 for the complex pair axis when encoded
            chan_axis = None
            if mesh is not None and "channel" in data.dimord:
                chan_axis = data.dimord.index("channel") + 1 + (1 if in_complex else 0)

            if consume_plan is not None:
                # input already in HBM: consume the producer's chunks, but
                # never exceed THIS routine's chunk budget — a consumer
                # with a large per-trial workspace (e.g. Wilson) must split
                # oversized producer records on device
                source = self._resident_chunks(
                    consume_plan[shp], mesh, chan_axis, max_chunk=chunk
                )
            else:
                source = self._host_chunks(
                    data, positions, shp, chunk, mesh, chan_axis, in_complex
                )

            pos_index = {p: i for i, p in enumerate(positions)}
            pending = None  # (device_result, ...) for readback pipelining
            for dev_batch, chunk_pos, chunkN, n_valid in source:
                rows = [pos_index[p] for p in chunk_pos]
                dev_aux = []
                for a in aux_all:
                    a = np.asarray(a)[rows]
                    if a.shape[0] < chunkN:
                        # pad by repeating the last row: padded trials are
                        # masked out downstream, but gather-index aux inputs
                        # must stay within bounds (zeros would also be valid,
                        # repetition is safe for any aux semantic)
                        reps = np.repeat(a[-1:], chunkN - a.shape[0], axis=0)
                        a = np.concatenate([a, reps], axis=0)
                    a, _ = encode_host(a, axis=1)
                    da, _ = shard_batch(np.asarray(a), mesh)
                    dev_aux.append(da)
                res = _dispatch_with_recovery(
                    lambda: fn(dev_consts, dev_batch,
                               jnp.asarray(n_valid, dtype=jnp.int32), *dev_aux),
                    what="{} chunk dispatch".format(self.__class__.__name__),
                )
                if isinstance(res, tuple):
                    # (output, aux-info dict): aux entries are host-fetched and
                    # accumulated across ALL chunks (reference side-channel
                    # collects per-trial metadata for every chunk,
                    # metadata.py:135-220) — exposed via self.aux_info
                    res, aux_info = res
                    self._accumulate_aux(aux_info, chunk_pos, n_valid, chunkN)

                if self.keeptrials:
                    enc_shape = (chunkN,) + ((2,) if acc_complex else ()) + out_shp
                    if resident_out:
                        resident_records.append(
                            Record(tuple(chunk_pos), res, enc_shape, chunkN, out_shp)
                        )
                    else:
                        # drain previous chunk while this one computes
                        if pending is not None:
                            self._write_chunk(host_out, *pending, offsets, sdim, acc_complex)
                        pending = (res, enc_shape, chunk_pos, n_valid)
                else:
                    # fn already masked + summed over the batch on device
                    acc = res if acc is None else acc + res

            if pending is not None:
                self._write_chunk(host_out, *pending, offsets, sdim, acc_complex)

        if not self.keeptrials:
            _t0 = _time.perf_counter()
            if getattr(self, "_post_fn", None) is not None:
                acc = self._apply_post_fn(acc, acc_complex)
                fetched = _dispatch_with_recovery(
                    lambda: np.asarray(jax.device_get(acc)), what="reduction readback"
                )
                if getattr(self, "_post_unpack", None) is not None:
                    avg = self._post_unpack(fetched)
                else:
                    avg = decode_host(fetched, out_complex, axis=0)
            else:
                fetched = _dispatch_with_recovery(
                    lambda: np.asarray(jax.device_get(acc)), what="reduction readback"
                )
                avg = decode_host(fetched, acc_complex, axis=0) / self.numTrials
            if PROFILE:
                get_logger().warning("final fetch %.3fs", _time.perf_counter() - _t0)
            host_out[...] = avg.astype(self.dtype, copy=False)

        if resident_out:
            resident = DeviceResident(
                resident_records, self.outputShape, self.dtype, acc_complex,
                offsets, sdim, _materialize_resident, out,
            )
            out._bump_cache_token()
            out._device_resident = resident
            out._data = DeferredArray(resident)
            return

        out.data = host_out if isinstance(host_out, np.ndarray) else host_out
        if not isinstance(host_out, np.ndarray):
            # h5py dataset: re-point the object at the file
            out._data = host_out

    def _resident_chunks(self, records, mesh, chan_axis, max_chunk=None):
        """Chunk source over HBM-resident producer records; records larger
        than `max_chunk` are split into fixed-size sub-chunks on device
        (zero-padded tail so every sub-chunk hits the same executable)."""
        for rec in records:
            dev_batch = _resident_input(rec, mesh, chan_axis)
            if max_chunk is None or rec.chunk <= max_chunk:
                yield dev_batch, list(rec.positions), rec.chunk, len(rec.positions)
                continue
            step = int(max_chunk)
            for s0 in range(0, len(rec.positions), step):
                sub_pos = list(rec.positions[s0 : s0 + step])
                sub = dev_batch[s0 : s0 + step]
                if sub.shape[0] < step:
                    pad = [(0, step - sub.shape[0])] + [(0, 0)] * (sub.ndim - 1)
                    sub = jnp.pad(sub, pad)
                yield sub, sub_pos, step, len(sub_pos)

    def _host_chunks(self, data, positions, shp, chunk, mesh, chan_axis, in_complex):
        """Chunk source over the host payload: gather, pad, encode, upload —
        with the HBM trial store reused across calls."""
        cache_key = (
            getattr(data, "_cache_token", None),
            self._selection_fingerprint(data),
            shp,
            chunk,
            # exact-transfer CRs must never share f16-cast cached chunks
            # uploaded by a lossy CR on the same payload (and vice versa)
            None if getattr(self, "exact_transfer", False) else TRANSFER_DTYPE,
            None if mesh is None else tuple(mesh.shape.items()),
            in_complex,
            tuple(positions),
        )
        cacheable = cache_key[0] is not None and cache_key[1] is not None
        cached_chunks = _device_cache_get(cache_key) if cacheable else None
        built_chunks = [] if (cached_chunks is None and cacheable) else None
        chunk_idx = -1

        for c0 in range(0, len(positions), chunk):
            _t0 = _time.perf_counter()
            chunk_pos = positions[c0 : c0 + chunk]
            chunk_idx += 1
            if cached_chunks is not None:
                dev_batch = cached_chunks[chunk_idx]
                n_valid = len(chunk_pos)
                _t1 = _t2 = _time.perf_counter()
            else:
                batch = self._gather_batch(data, chunk_pos)
                if batch.shape[0] < chunk:
                    pad = np.zeros((chunk - batch.shape[0],) + batch.shape[1:], batch.dtype)
                    batch = np.concatenate([batch, pad], axis=0)
                # complex data crosses the device boundary as a real pair
                # (pair axis AFTER the trial axis, keeping the trailing
                # dims wide)
                batch, _ = encode_host(batch, axis=1)
                if (TRANSFER_DTYPE and not in_complex
                        and batch.dtype == np.float32
                        and not getattr(self, "exact_transfer", False)):
                    batch = batch.astype(TRANSFER_DTYPE)
                _t1 = _time.perf_counter()
                dev_batch, _ = shard_batch(batch, mesh, channel_axis_pos=chan_axis)
                # n_valid counts REAL trials: padding rows must be masked —
                # NaN-sensitive reductions (phase unit vectors, centered
                # moments) would otherwise be poisoned on the first,
                # uncached pass (the cached branch already did this)
                n_valid = len(chunk_pos)
                if built_chunks is not None:
                    built_chunks.append(dev_batch)
                _t2 = _time.perf_counter()
            if PROFILE:
                get_logger().warning(
                    "chunk %d: gather %.3fs put %.3fs%s", c0 // chunk, _t1 - _t0,
                    _t2 - _t1, " (cached)" if cached_chunks is not None else "",
                )
            yield dev_batch, chunk_pos, chunk, n_valid

        if built_chunks:
            nbytes = sum(int(np.prod(c.shape)) * c.dtype.itemsize for c in built_chunks)
            _device_cache_put(cache_key, built_chunks, nbytes)

    def _apply_post_fn(self, acc, kernel_complex):
        """Fuse the post transform (incl. the /numTrials normalization)
        into one cached device program."""
        pack = getattr(self, "_post_pack", None)
        rb16 = _readback_dtype() == "float16"
        pack_complex = getattr(self, "_post_pack_complex", False)
        key = (
            self.__class__.__qualname__, "post", self._post_key,
            tuple(acc.shape), str(acc.dtype), kernel_complex, pack is not None,
            rb16, pack_complex,
        )
        if key not in _GLOBAL_JIT_CACHE:
            post = self._post_fn

            def finalize(a, n):
                x = decode_in_jit(a, kernel_complex, axis=0) / n
                y = post(x)
                if pack is not None:
                    # pack returns a REAL array, but it may ENCODE complex
                    # content (Hermitian-packed CSD) — the caller declares
                    # that via post_pack_complex and it is never downcast
                    z, was_c = pack(y), pack_complex
                else:
                    z, was_c = encode_in_jit(y, axis=0)
                # reduced-precision readback for REAL fused reductions only
                # (complex pairs keep f32: phase would degrade)
                if rb16 and not was_c and z.dtype == jnp.float32:
                    z = z.astype(jnp.float16)
                return z

            _GLOBAL_JIT_CACHE[key] = jax.jit(finalize)
        n = jnp.asarray(float(self.numTrials), dtype=jnp.float32)
        return _GLOBAL_JIT_CACHE[key](acc, n)

    def _write_chunk(self, host_out, res, enc_shape, chunk_pos, n_valid, offsets, sdim, out_complex):
        fetched = _dispatch_with_recovery(
            lambda: _fetch_readback(_flatten_dev(res), enc_shape),
            what="result readback",
        )
        arr = decode_host(fetched, out_complex, axis=1)[:n_valid]
        for i, pos in enumerate(chunk_pos):
            row0, row1 = offsets[pos], offsets[pos + 1]
            sl = [slice(None)] * (arr.ndim - 1)
            sl[sdim] = slice(row0, row1)
            host_out[tuple(sl)] = arr[i]

    def _get_compiled(self, shp, mesh, in_complex=False, aux_complex=()):
        key = (
            self.__class__.__qualname__,
            _cfg_fingerprint(self.cfg),
            shp,
            mesh if mesh is None else (tuple(mesh.shape.items()),
                                       tuple(d.id for d in mesh.devices.flat)),
            in_complex,
            aux_complex,
            self.keeptrials,
            _readback_dtype(),
            # CRs whose traced program bakes in state beyond cfg (e.g. env
            # knobs read at trace time) declare it here — otherwise a knob
            # flip mid-process would silently reuse the stale executable
            self.extra_cache_key(),
        )
        if key not in _GLOBAL_JIT_CACHE:
            cfg = self.cfg
            keeptrials = self.keeptrials
            rb16 = _readback_dtype() == "float16"

            has_sum = hasattr(self, "process_batch_sum")

            def batched(consts, batch, n_valid, *aux):
                batch = decode_in_jit(batch, in_complex, axis=1)
                aux = tuple(
                    decode_in_jit(a, f, axis=1) for a, f in zip(aux, aux_complex)
                )
                aux_info = None
                # bind declared device constants for the duration of the
                # trace: process_single_trial reads self._live_consts (the
                # trial vmap broadcasts them — in_axes=None semantics)
                self._live_consts = consts if consts else None
                self._live_mesh = mesh
                try:
                    if not keeptrials and has_sum:
                        # fused masked trial-sum: avoids materializing
                        # per-trial outputs (one big contraction instead)
                        res = self.process_batch_sum(batch, n_valid, *aux, **cfg)
                        if isinstance(res, tuple):
                            res, aux_info = res
                        res, _ = encode_in_jit(res, axis=0)
                        return res if aux_info is None else (res, aux_info)
                    res = self.process_batch(batch, *aux, **cfg)
                finally:
                    self._live_consts = None
                    self._live_mesh = None
                if isinstance(res, tuple):
                    res, aux_info = res
                if not keeptrials:
                    mask_shape = (res.shape[0],) + (1,) * (res.ndim - 1)
                    mask = (jnp.arange(res.shape[0]) < n_valid).reshape(mask_shape)
                    res = jnp.sum(jnp.where(mask, res, jnp.zeros((), res.dtype)), axis=0)
                    res, _ = encode_in_jit(res, axis=0)
                else:
                    res, was_complex = encode_in_jit(res, axis=1)
                    # NOT flattened to readback layout here: the (N, 128)
                    # relayout would cost a second write of the whole
                    # stack, and device-resident results consumed
                    # on-device never need it. The relayout happens
                    # lazily at host-fetch time (_flatten_dev).
                    if rb16 and not was_complex and res.dtype == jnp.float32:
                        res = res.astype(jnp.float16)
                return res if aux_info is None else (res, aux_info)

            _GLOBAL_JIT_CACHE[key] = jax.jit(batched)
        return _GLOBAL_JIT_CACHE[key]

    def _preallocate_output(self, out):
        """Allocate the stacked output: host RAM, or HDF5 when too large
        (reference preallocate_output computational_routine.py:750-804)."""
        return _allocate_host_output(self.outputShape, self.dtype, out)

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

    # ------------------------------------------------------------------ #
    # helpers for process_metadata implementations
    # ------------------------------------------------------------------ #

    def default_trialdefinition(self, data, out):
        """
        Build the output trialdefinition: per selected trial, the stacked
        output rows with offsets carried over where meaningful.
        """
        sdim = self.out_stackingdim
        stack_lens = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
        if not self.keeptrials:
            stack_lens = stack_lens[:1]
        bounds = np.concatenate([[0], np.cumsum(stack_lens)])
        trl = np.zeros((len(stack_lens), 3))
        trl[:, 0] = bounds[:-1]
        trl[:, 1] = bounds[1:]
        return trl

    def propagate_properties(self, data, out):
        """Carry channel labels / samplerate through, honoring selections
        (reference computational_routine.py:1114-1231)."""
        sel = self.selector
        if hasattr(out, "samplerate") and getattr(data, "samplerate", None) is not None:
            out.samplerate = data.samplerate
        if "channel" in out.dimord and "channel" in data.dimord and data.channel is not None:
            chan = np.asarray(data.channel)
            ch_sel = getattr(sel, "channel", None)
            if ch_sel is not None:
                chan = chan[ch_sel] if isinstance(ch_sel, slice) else chan[np.asarray(ch_sel)]
            if out.data is not None and out.data.shape[out.dimord.index("channel")] == chan.size:
                out.channel = chan
