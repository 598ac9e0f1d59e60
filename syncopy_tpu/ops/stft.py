# -*- coding: utf-8 -*-
#
# Sliding-window (multi-)tapered Fourier transform — the mtmconvol/STFT
# kernel.
#
# Parity targets: reference syncopy/specest/stft.py:16-200 and
# specest/mtmconvol.py:17-152. Redesign: the strided-view + per-taper host
# loop becomes a single gather (window framing at arbitrary centers) and
# one batched rfft over (nTime, nTaper, nperseg, nChannel) — arbitrary
# window centers make the reference's equidistant/non-equidistant split
# unnecessary on device.

import jax
import jax.numpy as jnp

from .fft import rfft_auto
from .spectral import detrend, spectral_convert

__all__ = ["mtmconvol", "mtmconvol_time_sharded"]


def mtmconvol(
    data,
    tapers,
    centers,
    nperseg,
    polyremoval=None,
    output="fourier",
    keeptapers=True,
    freq_idx=None,
):
    """
    Tapered STFT of a single trial at arbitrary window centers.

    Parameters
    ----------
    data : (nSamples, nChannels) real array
    tapers : (nTaper, nperseg) float32 — normalized taper bank
        (:func:`~syncopy_tpu.ops.windows.make_tapers` with
        ``signal_length = pad_length = nperseg``)
    centers : (nTime,) int array — window-center sample indices into `data`
        (windows reaching past the edges are zero-extended, the reference's
        ``boundary='zeros'``)
    nperseg : int — window length in samples
    polyremoval : None/0/1 — per-segment detrending (reference stft.py
        ``detrend`` semantics)
    output : str — spectral output conversion
    keeptapers : bool — keep the taper axis or average it out
    freq_idx : optional int array — subselect frequency bins

    Returns
    -------
    spec : (nTime, nTaper|1, nFreq, nChannels)
    """
    halfWin = nperseg // 2
    x = jnp.pad(data.astype(jnp.float32), ((halfWin, nperseg), (0, 0)))
    starts = centers.astype(jnp.int32)  # center c -> padded window [c, c+nperseg)
    idx = starts[:, None] + jnp.arange(nperseg)[None, :]
    frames = x[idx]  # (nTime, nperseg, C) gather
    frames = detrend(frames, polyremoval, axis=1)
    tapered = frames[:, None, :, :] * tapers[None, :, :, None]
    ftr = rfft_auto(tapered, tapered.shape[2], axis=2)
    if freq_idx is not None:
        ftr = jnp.take(ftr, jnp.asarray(freq_idx), axis=2)
    spec = spectral_convert(ftr, output)
    if not keeptapers:
        spec = jnp.mean(spec, axis=1, keepdims=True)
    return spec


def mtmconvol_time_sharded(
    data,
    tapers,
    nperseg,
    mesh,
    axis_name="trial",
    polyremoval=None,
    output="fourier",
    keeptapers=True,
    freq_idx=None,
):
    """
    Tapered STFT (one window per sample, ``toi='all'``) of a signal whose
    TIME axis is sharded across the mesh — the context-parallel analog for
    recordings too long for one device's HBM (SURVEY.md §5 "long-context";
    reference mtmconvol.py:17 computes the same spectrogram on one host).

    Each shard exchanges a window halo with its ring neighbors
    (`lax.ppermute`), frames + rffts its own window centers locally, and the
    output spectrogram stays sharded along its time axis — no full-signal
    gather anywhere. Bit-equal to :func:`mtmconvol` with ``centers =
    arange(nSamples)`` (edges zero-extended).

    Parameters
    ----------
    data : (nSamples, nChannels), nSamples divisible by the mesh axis size;
        the local shard length must be >= `nperseg`
    tapers : (nTaper, nperseg) taper bank
    mesh : jax.sharding.Mesh with `axis_name`

    Returns
    -------
    spec : (nSamples, nTaper|1, nFreq, nChannels), time-sharded
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    T = data.shape[0]
    n_dev = mesh.shape[axis_name]
    if T % n_dev:
        raise ValueError("nSamples must be divisible by the mesh axis size")
    T_local = T // n_dev
    if T_local < nperseg:
        raise ValueError(
            "local shard ({} samples) shorter than nperseg ({})".format(T_local, nperseg)
        )
    halfWin = nperseg // 2
    halo_r = nperseg - halfWin
    taper_bank = jnp.asarray(tapers, dtype=jnp.float32)

    def local(xs):
        idx_dev = jax.lax.axis_index(axis_name)
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        left = jax.lax.ppermute(xs[-halfWin:], axis_name, fwd)
        right = jax.lax.ppermute(xs[:halo_r], axis_name, bwd)
        left = jnp.where(idx_dev == 0, jnp.zeros_like(left), left)
        right = jnp.where(idx_dev == n_dev - 1, jnp.zeros_like(right), right)
        ext = jnp.concatenate([left, xs.astype(jnp.float32), right], axis=0)
        # local center c (= global center idx_dev*T_local + c): window
        # [c, c + nperseg) in ext coordinates — identical framing to
        # mtmconvol's padded gather
        idx = jnp.arange(T_local)[:, None] + jnp.arange(nperseg)[None, :]
        frames = ext[idx]  # (T_local, nperseg, C)
        frames = detrend(frames, polyremoval, axis=1)
        tapered = frames[:, None, :, :] * taper_bank[None, :, :, None]
        ftr = rfft_auto(tapered, tapered.shape[2], axis=2)
        if freq_idx is not None:
            ftr = jnp.take(ftr, jnp.asarray(freq_idx), axis=2)
        spec = spectral_convert(ftr, output)
        if not keeptapers:
            spec = jnp.mean(spec, axis=1, keepdims=True)
        return spec

    fn = shard_map(
        local, mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=P(axis_name, None, None, None),
        check_vma=False,
    )
    x_sharded = jax.device_put(jnp.asarray(data), NamedSharding(mesh, P(axis_name, None)))
    return fn(x_sharded)
