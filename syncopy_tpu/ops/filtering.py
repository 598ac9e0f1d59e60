# -*- coding: utf-8 -*-
#
# Filtering kernels: FIR windowed-sinc design/application, Butterworth IIR
# via parallel associative scan, Hilbert transform, resampling.
#
# Parity targets: reference syncopy/preproc/firws.py:13-230,
# compRoutines.py:26-300 (sinc/but filtering), resampling.py:15-140.
# Device redesign:
#   - FIR application is a batched FFT convolution (one rfft/irfft pair for
#     all channels) instead of scipy.convolve;
#   - the sequential IIR biquad cascade becomes a `lax.associative_scan`
#     over 2x2 affine state maps — O(log T) depth instead of a length-T
#     sequential loop, which is the difference between an unusable and a
#     fast IIR filter on a parallel machine;
#   - `sosfiltfilt` edge handling (odd extension + steady-state initial
#     conditions) is reproduced exactly.

import functools

import numpy as np
from scipy.signal import butter as _sp_butter
from scipy.signal import windows as sp_windows

import jax
import jax.numpy as jnp

__all__ = [
    "design_wsinc",
    "minphaserceps",
    "apply_fir",
    "butter_sos",
    "sosfilt",
    "sosfiltfilt",
    "hilbert",
    "downsample",
    "resample_poly",
]


# ------------------------------------------------------------------------ #
# FIR windowed sinc (host-side design; reference firws.py:46-165)
# ------------------------------------------------------------------------ #


def windowed_sinc(window, order, f_c):
    omega_c = 2 * np.pi * f_c
    win = getattr(sp_windows, window)(order + 1)
    m_half = np.arange(1, order / 2 + 1)
    kernel = np.sin(omega_c * m_half) / m_half
    kernel = np.hstack([kernel[::-1], omega_c, kernel]) * win
    return kernel / kernel.sum()


def invert_sinc(kernel):
    kernel = -kernel
    kernel[len(kernel) // 2] += 1
    return kernel


def design_wsinc(window, order, f_c, filter_type="lp"):
    """Windowed-sinc FIR design for lp/hp/bp/bs filters
    (reference firws.py:46-107); `f_c` in sampling units (max 0.5)."""
    if order % 2 != 0:
        order += 1
    if filter_type == "lp":
        return windowed_sinc(window, order, f_c)
    if filter_type == "hp":
        return invert_sinc(windowed_sinc(window, order, f_c))
    if filter_type == "bp":
        f_hp, f_lp = f_c
    else:  # bs
        f_lp, f_hp = f_c
    lp_kernel = windowed_sinc(window, order, f_lp)
    hp_kernel = invert_sinc(windowed_sinc(window, order, f_hp))
    kernel = lp_kernel + hp_kernel
    if filter_type == "bp":
        kernel[len(kernel) // 2] -= 1
    return kernel


def minphaserceps(fkernel):
    """Minimum-phase (causal) transform of an FIR kernel via the real
    cepstrum (reference firws.py:168-205)."""
    nSamples = len(fkernel)
    nFFT = int(2 ** np.ceil(np.log2(nSamples * 1e3)))
    clipThresh = 1e-8
    specC = np.abs(np.fft.fft(fkernel, nFFT))
    specC[specC < clipThresh] = clipThresh
    specR = np.real(np.fft.ifft(np.log(specC)))
    ires = np.hstack([specR[1 : nFFT // 2], 0]) + np.conj(specR[nFFT // 2 : nFFT + 1][::-1])
    specR = np.hstack([specR[0], ires, np.zeros(nFFT // 2 - 2)])
    MinPhase = np.real(np.fft.ifft(np.exp(np.fft.fft(specR))))
    return MinPhase[:nSamples]


# -- direct-GEMM path for short trials (same design as the wavelet
# convolution banks, ops/wavelet.py): one dense (T, T) operator instead
# of platform FFTs. The FIR matrix at T=1000 is 4 MB — small enough to
# embed as an executable literal.

import os as _os


def _prefer_filter_gemm(T):
    """Dense-GEMM forms of `apply_fir`/`hilbert`? Only where
    SPY_TPU_FILTER_GEMM=1 asks for them: on an NVIDIA H100 (700 W) the
    FFT forms are as fast end to end (FIRWS low-pass + Hilbert envelope,
    1000 trials x 64 ch x 1000 samples: 0.213 s FFT vs 0.223 s GEMM,
    benchmarks/branch_ab.py), and the GEMM work grows as T^2."""
    return _os.environ.get("SPY_TPU_FILTER_GEMM", "auto") == "1"


def filter_gemm_fingerprint():
    """Trace-time state for executable cache keys of CRs whose programs
    gate on the filter-GEMM knob."""
    return (_prefer_filter_gemm(0),)


@functools.lru_cache(maxsize=32)
def _fir_conv_matrix(kernel_key, T):
    """Dense 'same'-mode convolution matrix G[t, m] = k[t - m + c]."""
    k = np.asarray(kernel_key, dtype=np.float32)
    c = (k.size - 1) // 2
    idx = np.arange(T)[:, None] - np.arange(T)[None, :] + c
    valid = (idx >= 0) & (idx < k.size)
    return np.where(valid, k[np.clip(idx, 0, k.size - 1)], 0.0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _hilbert_matrix(T):
    """Dense analytic-signal operator H = F^-1 diag(h) F as (re, im)
    float32 — `hilbert` is a fixed linear map, so at short T it is one
    pair of GEMMs instead of a mixed-radix fft+ifft round trip."""
    h = np.zeros(T)
    if T % 2 == 0:
        h[0] = h[T // 2] = 1
        h[1 : T // 2] = 2
    else:
        h[0] = 1
        h[1 : (T + 1) // 2] = 2
    H = np.fft.ifft(np.fft.fft(np.eye(T), axis=0) * h[:, None], axis=0)
    return H.real.astype(np.float32), H.imag.astype(np.float32)


def apply_fir(data, fkernel):
    """'same'-mode FIR convolution of (nSamples, nChannels) data with a 1d
    kernel: one batched FFT, or one dense GEMM where
    :func:`_prefer_filter_gemm` selects it (reference firws.py:13-42)."""
    T = data.shape[0]
    K = len(fkernel)
    if _prefer_filter_gemm(T):
        G = _fir_conv_matrix(tuple(np.asarray(fkernel, dtype=np.float32).tolist()), int(T))
        with jax.default_matmul_precision("highest"):
            return jnp.asarray(G) @ data.astype(jnp.float32)
    L = 1 << int(T + K - 1).bit_length()
    X = jnp.fft.rfft(data.astype(jnp.float32), n=L, axis=0)
    Kf = jnp.fft.rfft(jnp.asarray(fkernel, dtype=jnp.float32), n=L)
    y = jnp.fft.irfft(X * Kf[:, None], n=L, axis=0)
    start = (K - 1) // 2
    return jax.lax.dynamic_slice_in_dim(y, start, T, axis=0)


# ------------------------------------------------------------------------ #
# Butterworth IIR via associative scan
# ------------------------------------------------------------------------ #


def butter_sos(order, freq, filter_type, samplerate):
    """Second-order-sections Butterworth design (host-side scipy;
    reference compRoutines.py:264-265)."""
    return _sp_butter(order, freq, filter_type, fs=samplerate, output="sos").astype(np.float64)


def _biquad(b, a, x, x0):
    """
    One biquad section applied along axis 0 of `x` (T, C) with history
    primed to the constant `x0` (steady-state start, the sosfilt_zi
    semantics). The recurrence  y[n] = u[n] - a1 y[n-1] - a2 y[n-2]
    (u = FIR part) is evaluated with `lax.associative_scan` over affine
    2x2 state maps.
    """
    b0, b1, b2 = b
    _, a1, a2 = a
    T = x.shape[0]
    xm1 = jnp.concatenate([x0[None], x[:-1]], axis=0)
    xm2 = jnp.concatenate([x0[None], x0[None], x[:-2]], axis=0)
    u = b0 * x + b1 * xm1 + b2 * xm2  # (T, C)

    A = jnp.array([[-a1, -a2], [1.0, 0.0]], dtype=x.dtype)
    As = jnp.broadcast_to(A, (T, 2, 2))

    # steady-state initial state for constant input x0
    y_ss = x0 * (b0 + b1 + b2) / (1.0 + a1 + a2)
    s_init = jnp.stack([y_ss, y_ss], axis=0)  # (2, C)

    bs = jnp.concatenate([jnp.expand_dims(u, 1), jnp.zeros_like(jnp.expand_dims(u, 1))], axis=1)  # (T, 2, C)
    bs = bs.at[0].add(jnp.matmul(A, s_init, precision=jax.lax.Precision.HIGHEST))

    def combine(left, right):
        A1, b1v = left
        A2, b2v = right
        # the recurrence is numerically sensitive: pin full float32
        # (a default-precision f32 matmul may run in TF32 on a GPU)
        prec = jax.lax.Precision.HIGHEST
        return (
            jnp.matmul(A2, A1, precision=prec),
            jnp.einsum("...ij,...jc->...ic", A2, b1v, precision=prec) + b2v,
        )

    _, states = jax.lax.associative_scan(combine, (As, bs), axis=0)
    return states[:, 0, :]  # y[n]


def sosfilt(sos, x, x0=None):
    """Cascade of biquad sections (scipy.signal.sosfilt equivalent with
    steady-state priming when `x0` is given, zero priming otherwise)."""
    x = x.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    for sec in np.atleast_2d(sos):
        b, a = sec[:3], sec[3:]
        x0_sec = x[0] * 0 if x0 is None else x0
        x = _biquad(jnp.asarray(b, x.dtype), jnp.asarray(a, x.dtype), x, x0_sec)
        if x0 is not None:
            x0 = x0 * np.sum(sec[:3]) / (1.0 + sec[4] + sec[5])
    return x


def sosfiltfilt(sos, x):
    """
    Zero-phase forward-backward filtering with odd extension and
    steady-state initial conditions (scipy.signal.sosfiltfilt semantics;
    reference compRoutines.py:268-270 uses it for `direction='twopass'`).
    """
    sos = np.atleast_2d(sos)
    n_sections = sos.shape[0]
    ntaps = 2 * n_sections + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    padlen = 3 * ntaps
    T = x.shape[0]
    padlen = min(padlen, T - 1)

    x = x.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    # odd extension
    left = 2 * x[0] - x[padlen:0:-1]
    right = 2 * x[-1] - x[-2 : -padlen - 2 : -1]
    ext = jnp.concatenate([left, x, right], axis=0)

    y = sosfilt(sos, ext, x0=ext[0])
    y = y[::-1]
    y = sosfilt(sos, y, x0=y[0])
    y = y[::-1]
    return y[padlen : padlen + T]


# ------------------------------------------------------------------------ #
# Hilbert transform (reference compRoutines.py:365-443, scipy.signal.hilbert)
# ------------------------------------------------------------------------ #


def hilbert(x):
    """Analytic signal along axis 0 (scipy.signal.hilbert semantics): the
    fft -> one-sided mask -> ifft round trip, or one (re, im) GEMM pair
    against the dense analytic operator where :func:`_prefer_filter_gemm`
    selects it."""
    T = x.shape[0]
    if _prefer_filter_gemm(T):
        Hr, Hi = _hilbert_matrix(int(T))
        xr = x.astype(jnp.float32)
        with jax.default_matmul_precision("highest"):
            yr = jnp.asarray(Hr) @ xr
            yi = jnp.asarray(Hi) @ xr
        return jax.lax.complex(yr, yi)
    X = jnp.fft.fft(x.astype(jnp.float32), axis=0)
    h = np.zeros(T)
    if T % 2 == 0:
        h[0] = h[T // 2] = 1
        h[1 : T // 2] = 2
    else:
        h[0] = 1
        h[1 : (T + 1) // 2] = 2
    return jnp.fft.ifft(X * jnp.asarray(h)[:, None], axis=0).astype(jnp.complex64)


# ------------------------------------------------------------------------ #
# Resampling (reference resampling.py:15-140)
# ------------------------------------------------------------------------ #


def downsample(x, skipped):
    """Integer-factor downsampling (reference resampling.py:90-120)."""
    return x[::skipped]


@functools.lru_cache(maxsize=32)
def _resample_kernel(up, down, T, lpfreq, order, orig_fs):
    """Anti-alias FIR for polyphase resampling (reference resampling.py:60-85)."""
    fs_ratio = (up / down)
    if lpfreq is None:
        f_c = 0.5 * fs_ratio
    else:
        f_c = lpfreq / orig_fs
    if order is None:
        order = min(T * up, 10000)
    return design_wsinc("hamming", order=int(order), f_c=f_c / up)


def apply_fir_time_sharded(x, fkernel, mesh, axis_name="trial"):
    """
    FIR filtering of a signal whose TIME axis is sharded across the mesh —
    the context-parallelism analog for recordings too long for one device
    (SURVEY.md §5 "long-context"): each shard exchanges a filter-halo of
    ``(K-1)//2`` samples with its ring neighbors (`lax.ppermute`),
    convolves locally, and crops — no full-signal gather anywhere.

    Parameters
    ----------
    x : (nSamples, nChannels) array, nSamples divisible by the mesh axis
    fkernel : odd-length 1d FIR kernel
    mesh : jax.sharding.Mesh with `axis_name`
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    K = len(fkernel)
    if K % 2 == 0:
        raise ValueError("apply_fir_time_sharded requires an odd-length kernel")
    halo = (K - 1) // 2
    n_dev = mesh.shape[axis_name]
    kern = jnp.asarray(fkernel, dtype=jnp.float32)

    def local(xs):
        # xs: (T/n, C) local shard
        idx = jax.lax.axis_index(axis_name)
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        # halo from the LEFT neighbor (its last samples travel forward)
        left = jax.lax.ppermute(xs[-halo:], axis_name, fwd)
        # halo from the RIGHT neighbor (its first samples travel backward)
        right = jax.lax.ppermute(xs[:halo], axis_name, bwd)
        zeros = jnp.zeros_like(xs[:halo])
        left = jnp.where(idx == 0, zeros, left)  # zero boundary extension
        right = jnp.where(idx == n_dev - 1, zeros, right)
        ext = jnp.concatenate([left, xs, right], axis=0)
        y = apply_fir(ext, kern)
        return y[halo : halo + xs.shape[0]]

    fn = shard_map(
        local, mesh=mesh, in_specs=P(axis_name, None), out_specs=P(axis_name, None),
        check_vma=False,
    )
    x_sharded = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(axis_name, None)))
    return fn(x_sharded)


def resample_poly(x, up, down, fkernel):
    """
    Polyphase resampling: zero-stuff by `up`, FIR low-pass (gain `up`),
    take every `down`-th sample, centered like scipy.resample_poly.
    """
    T = x.shape[0]
    C = x.shape[1]
    out_len = int(np.ceil(T * up / down))
    upsampled = jnp.zeros((T * up, C), dtype=jnp.float32)
    upsampled = upsampled.at[::up].set(x.astype(jnp.float32))
    filtered = apply_fir(upsampled, np.asarray(fkernel) * up)
    return filtered[::down][:out_len]
