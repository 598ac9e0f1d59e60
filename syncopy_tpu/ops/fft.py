# -*- coding: utf-8 -*-
#
# Matmul DFT: a two-stage Cooley-Tukey DFT evaluated as batched matmuls,
# and the FFT entry points that choose between it and the platform FFT.
#
# Splitting N = N1*N2 turns the transform into two skinny GEMMs
# (contraction N1, then N2) plus an elementwise twiddle — N*(N1+N2) MACs
# instead of N log N:
#
#   X[N1*s + r] = sum_q F2[s,q] * ( T[r,q] * sum_p F1[r,p] x[p*N2 + q] )
#
# with F1 = DFT(N1), F2 = DFT(N2), T[r,q] = exp(-2i pi r q / N).
#
# On the NVIDIA H100 cuFFT is faster than this transform at the analysis
# lengths measured (N=1000 mtmfft, coherence and PPC; see _prefer_matmul),
# so the platform FFT is the default everywhere and the matmul DFT runs
# only where SPY_TPU_MATMUL_FFT=1 asks for it.
#
# Accuracy: float32 GEMMs at HIGHEST precision — ~1e-6 relative. The
# factorization-grade Granger CSD keeps the compensated double-float32
# DFT (ops/connectivity.rfft_df32).

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["rfft_via_matmul", "matmul_fft_split", "rfft_auto"]

# module-level constant (one process per setting, like the other SPY_TPU_*
# engine knobs): SPY_TPU_MATMUL_FFT=1 sends every gated call site to the
# matmul DFT
_USE_MATMUL_FFT = os.environ.get("SPY_TPU_MATMUL_FFT", "0") == "1"
# GEMM precision for the DFT stages: "highest" = exact float32; "high"
# trades accuracy for rate. Default stays exact.
_MATMUL_PRECISION = os.environ.get("SPY_TPU_MATMUL_FFT_PRECISION", "highest")


def _prefer_matmul(N):
    """Matmul DFT for a non-power-of-two length N? Only where
    SPY_TPU_MATMUL_FFT=1 asks for it: on an NVIDIA H100 (700 W) cuFFT
    wins end to end at N=1000 — mtmfft PSD 0.107 vs 0.128 s, coherence
    0.035 vs 0.041 s, PPC 0.035 vs 0.050 s at 1000 trials x 64 channels,
    and mtmconvol/welch tie (benchmarks/branch_ab.py) — and the CPU
    never took it. Power-of-two lengths always use the platform FFT."""
    return _USE_MATMUL_FFT and N & (N - 1) != 0


def preferred_fft_len(n):
    """Smallest 'fast' transform length >= `n` for a padded convolution:
    the next power of two (per-scale length buckets, ops/wavelet.py::
    _scale_buckets, keep every scale near its minimal length)."""
    n = int(n)
    return 1 << max((n - 1).bit_length(), 0)


def rfft_auto(x, nfft, axis=-2):
    """``jnp.fft.rfft``, or :func:`rfft_via_matmul` where
    :func:`_prefer_matmul` selects it. The choice happens at trace time."""
    if _prefer_matmul(int(nfft)):
        return rfft_via_matmul(x, nfft, axis=axis)
    return jnp.fft.rfft(x, n=nfft, axis=axis)


def ifft_crop_auto(X, axis, n_out):
    """First `n_out` samples of ``jnp.fft.ifft(X, axis=axis)``: platform
    ifft + slice, or :func:`ifft_via_matmul` where :func:`_prefer_matmul`
    selects it (which never computes the cropped-away samples — wavelet
    banks keep only the first nSamples of an L-point circular
    convolution)."""
    if _prefer_matmul(int(X.shape[axis])):
        return ifft_via_matmul(X, axis=axis, n_out=n_out)
    idx = [slice(None)] * X.ndim
    idx[axis] = slice(0, n_out)
    return jnp.fft.ifft(X, axis=axis)[tuple(idx)]


@functools.lru_cache(maxsize=32)
def _ct_plan_inv(N, n_out):
    split = matmul_fft_split(N)
    if split is None:
        return None
    N1, N2 = split
    # inverse decimation: k = N1*s + r, n = N2*p + q
    #   y[N2 p + q] = (1/N) sum_r W1+[p,r] ( T+[q,r] sum_s W2+[q,s] X[N1 s + r] )
    s = np.arange(N2)
    q = np.arange(N2)
    G2 = np.exp(2j * np.pi * np.outer(q, s) / N2)
    r = np.arange(N1)
    T = np.exp(2j * np.pi * np.outer(q, r) / N)
    p_max = (int(n_out) - 1) // N2
    p = np.arange(p_max + 1)
    G1 = np.exp(2j * np.pi * np.outer(p, r) / N1) / N
    return N1, N2, G2.astype(np.complex64), T.astype(np.complex64), G1.astype(np.complex64)


def ifft_via_matmul(X, axis, n_out=None):
    """
    The first `n_out` samples of the length-N inverse DFT of complex `X`
    along `axis`, as two batched GEMM stages (complex einsums — XLA
    decomposes them into real matmuls). Restricting the output range
    drops the p-blocks past ``n_out`` entirely — wavelet convolutions pad
    to L >> nSamples and discard the tail, so roughly half of stage 2
    never runs. Falls back to platform ifft for unfactorable lengths.
    """
    N = X.shape[axis]
    if n_out is None:
        n_out = N
    plan = _ct_plan_inv(int(N), int(n_out))
    if plan is None:
        idx = [slice(None)] * X.ndim
        idx[axis] = slice(0, n_out)
        return jnp.fft.ifft(X, axis=axis)[tuple(idx)]
    N1, N2, G2, T, G1 = plan

    X = jnp.moveaxis(X, axis, -2).astype(jnp.complex64)
    lead = X.shape[:-2]
    C = X.shape[-1]
    Xsr = X.reshape(lead + (N2, N1, C))  # [s, r] with k = N1*s + r
    g2 = jnp.asarray(G2)
    tw = jnp.asarray(T)[:, :, None]
    g1 = jnp.asarray(G1)
    with jax.default_matmul_precision(_MATMUL_PRECISION):
        Z = jnp.einsum("qs,...src->...qrc", g2, Xsr)
        Z = Z * tw
        Y = jnp.einsum("pr,...qrc->...pqc", g1, Z)  # (..., p, q, c)
    y = Y.reshape(lead + (-1, C))[..., :n_out, :]
    return jnp.moveaxis(y, -2, axis)


def matmul_fft_split(N, max_factor=512):
    """Pick (N1, N2) with ``N1 * N2 == N`` minimizing the GEMM cost
    ``2*N1 + 4*N2`` (stage 1 runs 2 real GEMMs on the real input, stage 2
    runs 4); None when N has no usable split (prime or factors too
    large)."""
    best = None
    for n1 in range(2, min(N, max_factor + 1)):
        if N % n1:
            continue
        n2 = N // n1
        if n2 > max_factor:
            continue
        cost = 2 * n1 + 4 * n2
        if best is None or cost < best[0] or (cost == best[0] and n1 > best[1]):
            best = (cost, n1, n2)
    if best is None:
        return None
    return best[1], best[2]


@functools.lru_cache(maxsize=32)
def _ct_plan(N):
    split = matmul_fft_split(N)
    if split is None:
        return None
    N1, N2 = split
    F = N // 2 + 1
    r = np.arange(N1)
    p = np.arange(N1)
    F1 = np.exp(-2j * np.pi * np.outer(r, p) / N1)
    # one-sided output: k = N1*s + r <= N//2 needs s <= N//2 // N1 only
    s_max = (N // 2) // N1
    s = np.arange(s_max + 1)
    q = np.arange(N2)
    F2 = np.exp(-2j * np.pi * np.outer(s, q) / N2)
    T = np.exp(-2j * np.pi * np.outer(r, q) / N)
    as32 = lambda a: (a.real.astype(np.float32), a.imag.astype(np.float32))
    return N1, N2, F, as32(F1), as32(F2), as32(T)


def rfft_via_matmul(x, nfft, axis=-2):
    """
    One-sided DFT of real input via two batched GEMM stages.

    Parameters
    ----------
    x : real array, transformed along `axis` (zero-padded/truncated to
        `nfft` samples)
    nfft : int transform length
    axis : transform axis

    Returns
    -------
    complex64 spectrum with ``nfft//2 + 1`` bins along `axis` — matches
    ``jnp.fft.rfft(x, n=nfft, axis=axis)`` to float32 GEMM rounding.
    Falls back to ``jnp.fft.rfft`` when `nfft` has no usable
    factorization.
    """
    plan = _ct_plan(int(nfft))
    if plan is None:
        return jnp.fft.rfft(x, n=nfft, axis=axis)
    N1, N2, F, (F1r, F1i), (F2r, F2i), (Tr, Ti) = plan

    x = jnp.moveaxis(x, axis, -2).astype(jnp.float32)
    T = x.shape[-2]
    if T < nfft:
        pad = [(0, 0)] * x.ndim
        pad[-2] = (0, nfft - T)
        x = jnp.pad(x, pad)
    elif T > nfft:
        x = x[..., :nfft, :]
    lead = x.shape[:-2]
    C = x.shape[-1]
    x5 = x.reshape(lead + (N1, N2, C))  # n = p*N2 + q

    f1r, f1i = jnp.asarray(F1r), jnp.asarray(F1i)
    f2r, f2i = jnp.asarray(F2r), jnp.asarray(F2i)
    tr = jnp.asarray(Tr)[:, :, None]
    ti = jnp.asarray(Ti)[:, :, None]
    with jax.default_matmul_precision(_MATMUL_PRECISION):
        Yr = jnp.einsum("rp,...pqc->...rqc", f1r, x5)
        Yi = jnp.einsum("rp,...pqc->...rqc", f1i, x5)
        Zr = Yr * tr - Yi * ti
        Zi = Yr * ti + Yi * tr
        Xr = (jnp.einsum("sq,...rqc->...src", f2r, Zr)
              - jnp.einsum("sq,...rqc->...src", f2i, Zi))
        Xi = (jnp.einsum("sq,...rqc->...src", f2r, Zi)
              + jnp.einsum("sq,...rqc->...src", f2i, Zr))
    X = jax.lax.complex(Xr, Xi).reshape(lead + (-1, C))[..., :F, :]
    return jnp.moveaxis(X, -2, axis)
