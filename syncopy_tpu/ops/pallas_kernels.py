# -*- coding: utf-8 -*-
#
# Fused pairwise-phase-consistency (PPC) resultant as a Pallas kernel for
# NVIDIA GPUs, compiled through Triton.
#
# The fused PPC pass (connectivity/ST_compRoutines.PPCSpectra) needs, per
# frequency, the resultant of per-trial unit cross-spectra
#
#   U[f, i, j] = sum_{n < n_valid} csd_n[f, i, j] / |csd_n[f, i, j]|,
#   csd_n[f, i, j] = sum_k spec[n, k, f, i] conj(spec[n, k, f, j])
#
# (the 1/K taper mean cancels in the unit normalization). XLA computes it
# by writing the per-trial (B, F, C, C) complex stack to device memory and
# reading it back to normalize and sum: ~2 GB per 125-trial chunk at
# 64 channels x 501 bins. The taper contraction is K = 2-3 deep, far too
# skinny for tensor cores, so that stage is bound by memory traffic alone.
# The kernel keeps the per-trial Gram in registers: each program owns one
# (frequency, channel-tile, channel-tile) output block and loops over the
# trials inside the block, so the stack never exists and no atomics are
# needed.

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["ppc_resultant", "ppc_resultant_triton", "ppc_resultant_sharded",
           "ppc_resultant_xla", "ppc_block_for"]


def ppc_block_for(n_chan):
    """Channel tile edge: a power of two (Triton's block rule), at most 32
    so the four (block, block) float32 accumulators of a program stay in
    registers at 4 warps."""
    return int(min(32, max(16, pl.next_power_of_2(int(n_chan)))))


def _ppc_kernel(nv_ref, re_ref, im_ref, ur_ref, ui_ref, *, n_taper, n_chan,
                block):
    f = pl.program_id(0)
    i0 = pl.program_id(1) * block
    j0 = pl.program_id(2) * block
    mi = i0 + jnp.arange(block) < n_chan
    mj = j0 + jnp.arange(block) < n_chan
    zero = jnp.zeros((block, block), jnp.float32)

    def trial(n, acc):
        ur, ui = acc
        cre, cim = zero, zero
        for k in range(n_taper):
            ar_i = plgpu.load(re_ref.at[n, k, f, pl.ds(i0, block)], mask=mi, other=0.0)
            ai_i = plgpu.load(im_ref.at[n, k, f, pl.ds(i0, block)], mask=mi, other=0.0)
            ar_j = plgpu.load(re_ref.at[n, k, f, pl.ds(j0, block)], mask=mj, other=0.0)
            ai_j = plgpu.load(im_ref.at[n, k, f, pl.ds(j0, block)], mask=mj, other=0.0)
            cre = cre + ar_i[:, None] * ar_j[None, :] + ai_i[:, None] * ai_j[None, :]
            cim = cim + ai_i[:, None] * ar_j[None, :] - ar_i[:, None] * ai_j[None, :]
        mag2 = cre * cre + cim * cim
        # exact-zero Grams (zero bins, masked channel padding) add nothing
        scale = jnp.where(mag2 > 0.0, lax.rsqrt(jnp.maximum(mag2, 1e-37)), 0.0)
        return ur + cre * scale, ui + cim * scale

    # the trial loop stops at n_valid: padding trials past it (which may
    # hold NaN garbage) are never loaded
    ur, ui = lax.fori_loop(0, nv_ref[0], trial, (zero, zero))
    ur_ref[...] = ur
    ui_ref[...] = ui


@functools.partial(jax.jit, static_argnames=("block", "interpret"))
def ppc_resultant_triton(spec_re, spec_im, n_valid, block=None, interpret=False):
    """
    PPC resultant ``U`` (see module header) from per-trial tapered spectra
    given as float32 real and imaginary parts of shape (N, K, F, C).

    Plain float32 resultant accumulation: each term has magnitude <= 1
    and PPC subtracts n at the end, so the absolute error
    ~N*eps*sqrt(N) stays orders below the estimator's 1/sqrt(N) noise.

    Returns U as (F, C, C) complex64; PPC itself is
    ``(|U|^2 - n) / (n * (n - 1))``.
    """
    N, K, F, C = spec_re.shape
    block = block or ppc_block_for(C)
    nb = -(-C // block)
    nv = jnp.minimum(jnp.asarray(n_valid, jnp.int32), N).reshape(1)
    out_spec = pl.BlockSpec((None, block, block), lambda f, i, j: (f, i, j))
    out_sds = jax.ShapeDtypeStruct((F, nb * block, nb * block), jnp.float32)
    ur, ui = pl.pallas_call(
        functools.partial(_ppc_kernel, n_taper=K, n_chan=C, block=block),
        grid=(F, nb, nb),
        out_specs=[out_spec, out_spec],
        out_shape=[out_sds, out_sds],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ppc_resultant",
    )(nv, spec_re.astype(jnp.float32), spec_im.astype(jnp.float32))
    return jax.lax.complex(ur, ui)[:, :C, :C]


def ppc_resultant_xla(spec, n_valid):
    """The same resultant in plain XLA: per-trial Gram stack, unit
    normalization, masked trial sum. Runs on the CPU and is the Triton
    kernel's reference."""
    cs = jnp.einsum("bkfi,bkfj->bfij", spec, jnp.conj(spec),
                    precision=jax.lax.Precision.HIGHEST)
    mag = jnp.abs(cs)
    unit = jnp.where(mag > 0, cs / jnp.where(mag > 0, mag, 1.0), 0.0)
    # where-mask (not multiply): padding trials may hold NaN garbage
    mask = (jnp.arange(unit.shape[0]) < n_valid)[:, None, None, None]
    return jnp.sum(jnp.where(mask, unit, jnp.zeros((), unit.dtype)), axis=0)


def ppc_resultant_sharded(spec, n_valid, mesh, interpret=False):
    """The Triton resultant on a trial-sharded batch: each device runs the
    kernel on its own contiguous block of trials (its share of ``n_valid``)
    and the partial resultants meet in one ``psum``. The partitioner cannot
    split the kernel's custom call itself, so without this wrapper every
    device would gather the whole batch and repeat the reduction."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import TRIAL_AXIS

    def local(re, im, nv):
        n_local = re.shape[0]
        first = lax.axis_index(TRIAL_AXIS) * n_local
        nv_local = jnp.clip(nv - first, 0, n_local)
        U = ppc_resultant_triton(re, im, nv_local, interpret=interpret)
        return lax.psum(U, TRIAL_AXIS)

    # check_vma off: pallas_call's outputs carry no varying-axes type
    fn = shard_map(local, mesh=mesh, in_specs=(P(TRIAL_AXIS), P(TRIAL_AXIS), P()),
                   out_specs=P(), check_vma=False)
    nv = jnp.asarray(n_valid, jnp.int32)
    return fn(jnp.real(spec), jnp.imag(spec), nv)


def ppc_resultant(spec, n_valid, mesh=None):
    """Resultant of a (B, K, F, C) complex spectrum batch on the default
    backend: the Triton kernel on a GPU (one kernel per device when `mesh`
    shards trials over several), plain XLA on the CPU. Any other platform
    raises instead of silently taking a slow path."""
    platform = jax.default_backend()
    if platform == "gpu":
        if mesh is not None and mesh.size > 1:
            return ppc_resultant_sharded(spec, n_valid, mesh)
        return ppc_resultant_triton(jnp.real(spec), jnp.imag(spec), n_valid)
    if platform == "cpu":
        return ppc_resultant_xla(spec, n_valid)
    raise NotImplementedError(
        "no PPC resultant kernel for platform '{}'".format(platform))
