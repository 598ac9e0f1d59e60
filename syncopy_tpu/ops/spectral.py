# -*- coding: utf-8 -*-
#
# Jittable spectral kernels: (multi-)tapered FFT and detrending.
#
# Parity target: reference syncopy/specest/mtmfft.py:16-129 — redesigned for
# the device: the per-taper host loop becomes one broadcasted multiply plus a
# single batched rfft (XLA), and the normalization scalars are folded into
# the taper constants (see ops/windows.py). Batching over trials happens via
# vmap in the engine; the taper axis rides along as a regular array axis so
# the whole (batch, taper, time, channel) block is one fused elementwise op
# + one FFT call on device.

import jax
import jax.numpy as jnp

__all__ = ["mtmfft", "detrend", "spectral_convert"]


def detrend(x, polyremoval, axis=-2):
    """
    De-mean (`polyremoval=0`) or linearly detrend (`polyremoval=1`) along
    `axis`. `polyremoval=None` is the identity.
    """
    if polyremoval is None:
        return x
    if polyremoval == 0:
        return x - jnp.mean(x, axis=axis, keepdims=True)
    if polyremoval == 1:
        n = x.shape[axis]
        t = jnp.arange(n, dtype=x.dtype) - (n - 1) / 2.0
        shape = [1] * x.ndim
        shape[axis] = n
        t = t.reshape(shape)
        xm = x - jnp.mean(x, axis=axis, keepdims=True)
        slope = jnp.sum(t * xm, axis=axis, keepdims=True) / jnp.sum(t * t)
        return xm - t * slope
    raise ValueError("polyremoval must be None, 0 or 1")


def mtmfft(data, tapers, nfft, demean_taper=False, platform_fft=False):
    """
    Tapered Fourier transform of a single trial.

    Parameters
    ----------
    data : (nSamples, nChannels) real array
    tapers : (nTaper, nSamples) float32 — fully normalized taper bank
        (see :func:`~syncopy_tpu.ops.windows.make_tapers`)
    nfft : int — FFT length (>= nSamples; zero-padding happens inside rfft)
    demean_taper : bool — subtract the post-tapering mean (needed for
        Granger; reference mtmfft.py:110-113)
    platform_fft : bool — force ``jnp.fft.rfft`` even where the matmul DFT
        would win on speed. Parity-sensitive complex ('fourier') outputs
        set this: their coefficients feed downstream analyses verbatim, so
        they keep the platform transform's ~2.4e-7 error instead of the
        GEMM DFT's ~1e-6 (see ops/fft.py header).

    Returns
    -------
    ftr : (nTaper, nfft//2+1, nChannels) complex64
    """
    tapered = tapers[:, :, None] * data[None, :, :]
    if demean_taper:
        tapered = tapered - jnp.mean(tapered, axis=1, keepdims=True)
    if platform_fft:
        return jnp.fft.rfft(tapered, n=nfft, axis=1)
    from .fft import rfft_auto

    return rfft_auto(tapered, nfft, axis=1)


def mtmfft_exact(data, tapers, nfft, demean_taper=False):
    """
    :func:`mtmfft` with the compensated double-float32 DFT
    (ops/connectivity.rfft_df32) instead of the hardware FFT: the returned
    complex64 spectrum carries ENTRY-proportional rounding only (~6e-8),
    making downstream trial-averaged CSDs Wilson-factorizable (a float32
    FFT's error structure otherwise floors Granger's
    convergence; see ops/connectivity.rfft_df32). Use for
    ``freqanalysis(..., output='fourier', exact_fft=True)`` feeding
    Granger. Signal lengths up to 1024 samples.
    """
    from .connectivity import rfft_df32

    K, T = tapers.shape[0], data.shape[0]
    C = data.shape[1]
    tapered = tapers[:, :, None] * data.astype(jnp.float32)[None, :, :]
    if demean_taper:
        tapered = tapered - jnp.mean(tapered, axis=1, keepdims=True)
    x2d = jnp.transpose(tapered, (1, 0, 2)).reshape(T, K * C)
    hr, lr, hi, li = rfft_df32(x2d, nfft)
    F = hr.shape[0]
    y = jax.lax.complex(hr + lr, hi + li)
    return jnp.transpose(y.reshape(F, K, C), (1, 0, 2)).astype(jnp.complex64)


def spectral_convert(ftr, output):
    """Map complex Fourier coefficients to the requested output
    (reference const_def.py:12-37)."""
    if output in ("fourier", "complex"):
        return ftr.astype(jnp.complex64)
    if output == "pow":
        return (ftr * jnp.conj(ftr)).real.astype(jnp.float32)
    if output == "abs":
        return jnp.abs(ftr).astype(jnp.float32)
    if output == "real":
        return jnp.real(ftr).astype(jnp.float32)
    if output == "imag":
        return jnp.imag(ftr).astype(jnp.float32)
    if output == "angle":
        return jnp.angle(ftr).astype(jnp.float32)
    if output == "absreal":
        return jnp.abs(jnp.real(ftr)).astype(jnp.float32)
    if output == "absimag":
        return jnp.abs(jnp.imag(ftr)).astype(jnp.float32)
    raise ValueError("unknown output '{}'".format(output))
