# -*- coding: utf-8 -*-
#
# Device-resident compute results: keep per-trial outputs in device memory
# and defer the device->host readback until the payload is actually touched.
#
# Device-native replacement for the reference's parallel storage / virtual
# dataset layer (reference syncopy/shared/computational_routine.py:776-791):
# where the reference's workers write per-trial HDF5 files that a virtual
# dataset stitches together, here each compute chunk's (encoded) result
# stays on device. A chained pipeline (preprocessing -> freqanalysis ->
# connectivityanalysis) then consumes the producer's device chunks directly —
# the host link is touched exactly once, for the final (usually
# trial-averaged, small) result.
#
# Two cooperating objects:
#
# ``DeviceResident``
#     Owns the per-chunk device buffers (``records``) plus everything needed
#     to reconstruct the host array (offsets, stacking dim, dtype). Sealed
#     with the owning object's cache token so any later mutation of the
#     owner disables direct consumption (materialization stays valid — the
#     payload itself is immutable).
#
# ``DeferredArray``
#     A lazy ndarray stand-in installed as the owner's ``_data``. Exposes
#     ``shape``/``dtype``/``ndim``/... without any transfer, so metadata
#     plumbing (trialdefinition bounds, channel/freq label validation,
#     ``__str__``) runs for free; the first *element* access (``[...]``,
#     ``np.asarray``) triggers the readback and swaps the real array in.
#
# HBM accounting: a process-global registry bounds the bytes pinned by
# unmaterialized residents (``SPY_TPU_RESIDENT_BYTES``). Over budget, the
# least-recently-created resident is materialized to host and its device
# buffers are dropped. Materialized residents keep their device buffers
# (still consumable downstream) but count as freely evictable.

import os
import weakref
from collections import namedtuple

import numpy as np

__all__ = ["DeviceResident", "DeferredArray", "resident_budget_bytes"]

#: HBM budget for pinned (unmaterialized) resident results; 0 disables
#: device-resident outputs entirely
def resident_budget_bytes():
    return int(os.environ.get("SPY_TPU_RESIDENT_BYTES", 6 * 1024**3))


#: one compute chunk kept on device:
#:   positions    tuple of selected-trial positions covered (== valid rows)
#:   dev          device array, (N, 128) readback layout (f32, or f16 opt-in)
#:   enc_shape    logical encoded shape (chunk, [2,] *trial_shape)
#:   chunk        padded leading size (rows beyond len(positions) are garbage)
#:   trial_shape  decoded per-trial output shape
Record = namedtuple("Record", ["positions", "dev", "enc_shape", "chunk", "trial_shape"])

_REGISTRY = []  # [(weakref to DeviceResident)] in creation order


def _registry_account():
    """(pinned_bytes, live list) — prunes dead weakrefs in place."""
    alive = []
    pinned = 0
    for ref in _REGISTRY:
        res = ref()
        if res is None or res.records is None:
            continue
        alive.append(ref)
        if not res.materialized:
            pinned += res.nbytes_device
    _REGISTRY[:] = alive
    return pinned, alive


def _admit(new_bytes):
    """Make room for `new_bytes` of pinned HBM: drop buffers of materialized
    residents first (free), then force-materialize the oldest pinned ones."""
    budget = resident_budget_bytes()
    pinned, alive = _registry_account()
    if pinned + new_bytes <= budget:
        return True
    # pass 1: drop already-materialized residents' device buffers
    for ref in alive:
        res = ref()
        if res is not None and res.materialized and res.records is not None:
            res.drop_device()
    # pass 2: materialize + drop oldest pinned
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
    """Force-readback every pending resident (e.g. before clearing device
    state) and drop all device buffers."""
    for ref in list(_REGISTRY):
        res = ref()
        if res is not None and res.records is not None:
            res.materialize()
            res.drop_device()
    _REGISTRY[:] = []


class DeviceResident:
    """Per-trial compute results living in HBM; see module docstring."""

    def __init__(self, records, shape, dtype, was_complex, offsets, stackingdim,
                 materialize_fn, owner):
        self.records = list(records)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.was_complex = bool(was_complex)
        self.offsets = np.asarray(offsets)
        self.stackingdim = int(stackingdim)
        self._materialize_fn = materialize_fn
        self._owner = weakref.ref(owner)
        self._real = None
        #: owner cache token at seal time; consumption requires a match
        self.sealed_token = None
        self.nbytes_device = sum(
            int(np.prod(r.dev.shape)) * r.dev.dtype.itemsize for r in self.records
        )
        _REGISTRY.append(weakref.ref(self))

    @property
    def materialized(self):
        return self._real is not None

    def seal(self):
        owner = self._owner()
        if owner is not None:
            self.sealed_token = owner._cache_token

    def consumable_by(self, data):
        """True when `data`'s payload is exactly these device records and the
        owner was not mutated since the records were sealed."""
        return (
            self.records is not None
            and self.sealed_token is not None
            and getattr(data, "_cache_token", None) == self.sealed_token
        )

    def materialize(self):
        """Readback into the host array (idempotent); swaps the owner's
        ``_data`` from the DeferredArray proxy to the real payload. The
        in-flight guard prevents re-entry when an OOM-recovery cache sweep
        fires while this very readback is running."""
        if self._real is None and not getattr(self, "_materializing", False):
            self._materializing = True
            try:
                self._real = self._materialize_fn(self)
            finally:
                self._materializing = False
            owner = self._owner()
            if owner is not None and isinstance(owner._data, DeferredArray):
                owner._data = self._real
        return self._real

    def drop_device(self):
        """Release the HBM buffers (materializes first if needed — device
        residency must never lose data)."""
        if getattr(self, "_materializing", False):
            return  # an in-flight readback owns the records; keep them
        if self._real is None and self.records is not None:
            self.materialize()
        self.records = None

    def fetch_trial_view(self, pos, max_time=1024, magnitude=True):
        """
        Plot-resolution readback of ONE trial: slice the trial out of its
        HBM record, box-average the leading (time) axis down to
        ``<= max_time`` rows and reduce complex values to magnitude — all
        ON DEVICE — then read back only the small view. This is the
        first-plot fast path: a full-resolution resident TFR readback moves
        the whole spectrogram, while a <=1024-column image is all a screen
        can show anyway.

        Returns ``(array, factor)`` where `factor` is the decimation
        stride (time axis ``t' = (t*factor + (factor-1)/2) / samplerate``).
        Falls back to host slicing when the device buffers are gone.
        """
        import jax
        import jax.numpy as jnp

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

        rec = next(r for r in self.records if pos in r.positions)
        i = rec.positions.index(pos)

        from .routine import _GLOBAL_JIT_CACHE, _dispatch_with_recovery
        from ..parallel.device_io import decode_in_jit

        was_complex = self.was_complex
        key = ("resident_trial_view", rec.enc_shape, str(rec.dev.dtype),
               was_complex, bool(magnitude), factor, t_out)
        if key not in _GLOBAL_JIT_CACHE:
            n = int(np.prod(rec.enc_shape))
            enc_shape = rec.enc_shape

            def view(dev, idx):
                x = dev.astype(jnp.float32) if dev.dtype == jnp.float16 else dev
                x = x.reshape(-1)[:n].reshape(enc_shape)
                t = jax.lax.dynamic_index_in_dim(x, idx, axis=0, keepdims=False)
                if was_complex:
                    # pair axis 0; complex values cannot cross the device
                    # boundary, so reduce to magnitude on device (plots
                    # show magnitude) or keep the encoded pair
                    if magnitude:
                        t = jnp.abs(decode_in_jit(t, True, axis=0))
                    dec_axis = 0 if magnitude else 1
                else:
                    dec_axis = 0
                if factor > 1:
                    lead = t.shape[:dec_axis]
                    t = jnp.moveaxis(t, dec_axis, 0)[: t_out * factor]
                    t = t.reshape((t_out, factor) + t.shape[1:]).mean(axis=1)
                    t = jnp.moveaxis(t, 0, dec_axis) if lead else t
                return t

            _GLOBAL_JIT_CACHE[key] = jax.jit(view)
        fn = _GLOBAL_JIT_CACHE[key]
        out = _dispatch_with_recovery(
            lambda: np.asarray(jax.device_get(fn(rec.dev, jnp.asarray(i, jnp.int32)))),
            what="plot-view readback",
        )
        if was_complex and not magnitude:
            out = out[0] + 1j * out[1]
        return out, factor


class DeferredArray:
    """Lazy ndarray stand-in: free shape/dtype introspection, readback on
    first element access."""

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
        return self._ensure().astype(dtype, **kwargs)

    def __repr__(self):
        state = "materialized" if self._resident.materialized else "device-resident"
        return "<DeferredArray {} {} ({})>".format(
            self._resident.shape, self._resident.dtype, state
        )
