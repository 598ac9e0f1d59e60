# -*- coding: utf-8 -*-
#
# Host<->device data movement with complex arrays encoded as real pairs at
# program boundaries (runtimes exist where transferring complex64 arrays
# raises UNIMPLEMENTED while complex math *inside* a compiled program works
# fine; whether the GPU still needs the encoding is not yet measured).
#
# Convention: complex arrays cross every jit/transfer boundary encoded as
# real arrays with an extra length-2 axis ([real, imag]). The pair axis is
# placed at the FRONT (axis 0, or axis 1 for leading-batch arrays) — never
# last: a trailing dimension of 2 makes device->host readback of tiled
# layouts slow.

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "encode_host",
    "decode_host",
    "decode_in_jit",
    "encode_in_jit",
    "run_on_device",
]


def encode_host(arr, axis=0):
    """np complex -> (float array with a length-2 [re, im] axis at `axis`,
    True); real arrays pass through as (arr, False)."""
    arr = np.asarray(arr)
    if np.iscomplexobj(arr):
        rdtype = np.float64 if arr.dtype == np.complex128 else np.float32
        return np.stack([arr.real, arr.imag], axis=axis).astype(rdtype), True
    return arr, False


def decode_host(arr, was_complex, axis=0):
    if not was_complex:
        return arr
    cdtype = np.complex128 if arr.dtype == np.float64 else np.complex64
    re = np.take(arr, 0, axis=axis)
    im = np.take(arr, 1, axis=axis)
    out = re.astype(cdtype)
    out.imag = im
    return out


def decode_in_jit(x, was_complex, axis=0):
    """Inside a traced function: encoded pair -> complex."""
    if not was_complex:
        return x
    re = jax.lax.index_in_dim(x, 0, axis=axis, keepdims=False)
    im = jax.lax.index_in_dim(x, 1, axis=axis, keepdims=False)
    return jax.lax.complex(re, im)


def encode_in_jit(x, axis=0):
    """Inside a traced function: complex -> encoded pair; real unchanged.
    Returns (encoded, was_complex)."""
    if jnp.iscomplexobj(x):
        return jnp.stack([jnp.real(x), jnp.imag(x)], axis=axis), True
    return x, False


#: compiled-wrapper cache for run_on_device: avoids re-tracing when the
#: same (keyed) function is called repeatedly with the same shapes
_RUN_CACHE = {}


def run_on_device(fn, *host_arrays, key=None):
    """
    Execute `fn` (a pure jax function) on the default device with numpy
    inputs/outputs, encoding complex arrays as real pairs at both
    boundaries. Pass a hashable `key` when `fn` is a per-call closure so
    the compiled wrapper is reused across calls.
    """
    enc_inputs = []
    in_flags = []
    for arr in host_arrays:
        enc, flag = encode_host(arr, axis=0)
        enc_inputs.append(enc)
        in_flags.append(flag)
    in_flags = tuple(in_flags)
    shapes = tuple((a.shape, str(a.dtype)) for a in enc_inputs)

    cache_key = (key if key is not None else fn, in_flags, shapes)
    try:
        cached = _RUN_CACHE.get(cache_key)
    except TypeError:  # unhashable key -> no caching
        cached = None
        cache_key = None

    if cached is None:

        @jax.jit
        def wrapper(*enc_args):
            args = tuple(decode_in_jit(a, f, axis=0) for a, f in zip(enc_args, in_flags))
            res = fn(*args)
            flat, _ = jax.tree_util.tree_flatten(res)
            return [encode_in_jit(x, axis=0)[0] for x in flat]

        specs = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in enc_inputs]

        def logical(*enc_args):
            args = tuple(decode_in_jit(a, f, axis=0) for a, f in zip(enc_args, in_flags))
            return fn(*args)

        out_shape = jax.eval_shape(logical, *specs)
        flat_spec, treedef = jax.tree_util.tree_flatten(out_shape)
        out_flags = [np.issubdtype(s.dtype, np.complexfloating) for s in flat_spec]
        cached = (wrapper, treedef, out_flags)
        if cache_key is not None:
            _RUN_CACHE[cache_key] = cached

    wrapper, treedef, out_flags = cached
    results = wrapper(*enc_inputs)
    host = [
        decode_host(np.asarray(jax.device_get(r)), f, axis=0)
        for r, f in zip(results, out_flags)
    ]
    return jax.tree_util.tree_unflatten(treedef, host)
