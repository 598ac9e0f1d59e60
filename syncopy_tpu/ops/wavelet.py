# -*- coding: utf-8 -*-
#
# Continuous wavelet transform + superlet transform on the device.
#
# Parity targets: reference syncopy/specest/wavelets/transform.py:88-108
# (cwt_time), wavelets/wavelets.py:13-380 (Morlet/Paul/DOG/Ricker),
# specest/superlet.py:15-401 (MorletSL, cwtSL, multiplicative & fractional
# adaptive SLT), specest/wavelet.py:52-107 (get_optimal_wavelet_scales).
#
# Redesign: the reference convolves per scale with scipy.fftconvolve on the
# host. Here the whole scale bank is sampled once on the host (numpy, at
# trace time), rolled so every scale shares a common 'same'-mode center,
# FFT'd into a (nScales, L) spectrum constant, and the jitted device path is
# a single batched FFT -> broadcast multiply -> batched IFFT -> slice. The
# superlet geometric mean across orders becomes a weighted complex-log
# accumulation over the order axis, evaluated as a lax.map over scales so
# only one (nOrders, L, nChannels) block is ever live per trial — the
# naive all-orders bank materializes (nOrders, nScales, L, nChannels)
# complex intermediates, which caps the engine's trial batch at single
# digits.

import functools
import math
import os

import numpy as np
from scipy.special import gamma as _gamma
from scipy.special import hermitenorm as _hermitenorm

import jax
import jax.numpy as jnp

__all__ = [
    "Morlet",
    "Paul",
    "DOG",
    "Ricker",
    "MorletSL",
    "get_optimal_wavelet_scales",
    "cwt",
    "cwt_time_sharded",
    "superlet",
    "superlet_weights",
    "WaveletAnalysis",
    "WaveletTransform",
]


class Morlet:
    """Complex Morlet wavelet (reference wavelets/wavelets.py:13-138)."""

    def __init__(self, w0=6):
        self.w0 = w0
        if w0 == 6:
            self.C_d = 0.776  # Torrence & Compo 1998 Table 2

    def time(self, t, s=1.0, complete=True):
        w = self.w0
        x = t / s
        output = np.exp(1j * w * x)
        if complete:
            output = output - np.exp(-0.5 * w**2)
        return output * np.exp(-0.5 * x**2) * np.pi ** (-0.25)

    def fourier_period(self, s):
        return 4 * np.pi * s / (self.w0 + (2 + self.w0**2) ** 0.5)

    def scale_from_period(self, period):
        coeff = np.sqrt(self.w0 * self.w0 + 2)
        return period * (coeff + self.w0) / (4.0 * np.pi)

    def frequency(self, w, s=1.0):
        """Fourier transform of the Morlet wavelet at angular frequency
        ``w`` (Torrence & Compo Table 1; reference wavelets.py:104-126).
        Analytic: zero for non-positive frequencies."""
        x = np.asarray(w, dtype=float) * s
        support = (np.asarray(w) > 0).astype(float)
        return np.pi ** (-0.25) * support * np.exp(-0.5 * (x - self.w0) ** 2)

    def coi(self, s):
        """e-folding time of the wavelet-power autocorrelation
        (reference wavelets.py:128-138)."""
        return 2**0.5 * s


class Paul:
    """Complex Paul wavelet (reference wavelets/wavelets.py:140-237)."""

    def __init__(self, m=4):
        self.m = m

    def time(self, t, s=1.0):
        m = self.m
        x = t / s
        const = (2**m * 1j**m * math.factorial(m)) / (np.pi * math.factorial(2 * m)) ** 0.5
        return const * (1 - 1j * x) ** -(m + 1)

    def fourier_period(self, s):
        return 4 * np.pi * s / (2 * self.m + 1)

    def scale_from_period(self, period):
        return period * (2 * self.m + 1) / (4 * np.pi)

    def frequency(self, w, s=1.0):
        """Fourier transform of the Paul wavelet (Torrence & Compo
        Table 1; reference wavelets.py:204-226): analytic, one-sided."""
        m = self.m
        x = np.asarray(w, dtype=float) * s
        support = 0.5 * (np.sign(x) + 1)
        const = 2**m / (m * math.factorial(2 * m - 1)) ** 0.5
        return const * support * x**m * np.exp(-x)

    def coi(self, s):
        return s / 2**0.5


class DOG:
    """Derivative-of-Gaussian wavelet (reference wavelets/wavelets.py:239-361)."""

    def __init__(self, m=2):
        self.m = m
        if m == 2:
            self.C_d = 3.541  # Torrence & Compo 1998 Table 2
        elif m == 6:
            self.C_d = 1.966

    def time(self, t, s=1.0):
        x = t / s
        m = self.m
        He_n = _hermitenorm(m)
        const = (-1) ** (m + 1) / _gamma(m + 0.5) ** 0.5
        return const * He_n(x) * np.exp(-(x**2) / 2)

    def fourier_period(self, s):
        return 2 * np.pi * s / (self.m + 0.5) ** 0.5

    def scale_from_period(self, period):
        return period * np.sqrt(self.m + 0.5) / (2 * np.pi)

    def frequency(self, w, s=1.0):
        """Fourier transform of the m-th derivative-of-Gaussian wavelet
        (Torrence & Compo Table 1; reference wavelets.py:326-350)."""
        m = self.m
        x = np.asarray(w, dtype=float) * s
        const = -(1j**m) / _gamma(m + 0.5) ** 0.5
        return const * x**m * np.exp(-0.5 * x**2)

    def coi(self, s):
        return 2**0.5 * s


class Ricker(DOG):
    """Mexican-hat wavelet = DOG of order 2 (reference wavelets.py:363-376)."""

    def __init__(self):
        super().__init__(m=2)


class MorletSL:
    """Morlet in the superlet formulation of Moca et al. 2021
    (reference superlet.py:255-300): admissibility via cycle count `c_i`
    inside a Gaussian of `k_sd` standard deviations."""

    def __init__(self, c_i=3, k_sd=5):
        self.c_i = c_i
        self.k_sd = k_sd

    def time(self, t, s=1.0):
        ts = t / s
        B_c = self.k_sd / (s * self.c_i * (2 * np.pi) ** 1.5)
        out = B_c * np.exp(1j * ts)
        return out * np.exp(-0.5 * (self.k_sd * ts / (2 * np.pi * self.c_i)) ** 2)

    @staticmethod
    def fourier_period(scale):
        return 2 * np.pi * scale

    @staticmethod
    def scale_from_period(period):
        return period / (2 * np.pi)


def get_optimal_wavelet_scales(scale_from_period, nSamples, dt, dj=0.25, s0=None):
    """Torrence & Compo 1998 dyadic scale set, low frequencies first
    (reference wavelet.py:52-107)."""
    if s0 is None:
        s0 = scale_from_period(2 * dt)
    J = int((1 / dj) * np.log2(nSamples * dt / s0))
    scales = s0 * 2 ** (dj * np.arange(0, J + 1))
    return scales[::-1]


def _next_fast_len(n):
    """Padded-convolution FFT length: the next power of two (see
    ops.fft.preferred_fft_len)."""
    from .fft import preferred_fft_len

    return preferred_fft_len(int(n))


_SCALE_BATCH = max(int(os.environ.get("SPY_TPU_SUPERLET_SCALE_BATCH", "1")), 1)


def _scale_buckets(Ls, max_buckets=4):
    """Group scale indices by padded transform length: ``[(L, [i, ...])]``
    sorted by L, each index list in original scale order. The lowest
    frequencies dictate a support (and hence FFT length) the high
    frequencies don't need — running one bank per length bucket cuts the
    convolution traffic and GEMM work by the length ratio.

    At most `max_buckets` distinct lengths: every bucket is a separate
    sub-program (compile time, dispatch steps), so smaller buckets are
    greedily merged into the next longer one, choosing the merge that
    adds the least wasted work ``count * (L_next - L)`` (a longer padding
    is always correct — linear convolution is invariant to extra zeros)."""
    buckets = {}
    for i, L in enumerate(Ls):
        buckets.setdefault(int(L), []).append(i)
    items = sorted(buckets.items())
    while len(items) > max_buckets:
        costs = [
            (items[k + 1][0] - items[k][0]) * len(items[k][1])
            for k in range(len(items) - 1)
        ]
        k = int(np.argmin(costs))
        merged = sorted(items[k][1] + items[k + 1][1])
        items[k + 1] = (items[k + 1][0], merged)
        del items[k]
    return items


def _reassemble_scales(pieces, index_groups, axis=0):
    """Concatenate per-bucket results and restore original scale order."""
    order = np.concatenate([np.asarray(g) for g in index_groups])
    out = jnp.concatenate(pieces, axis=axis)
    inv = np.argsort(order)
    return jnp.take(out, jnp.asarray(inv), axis=axis)


@functools.lru_cache(maxsize=64)
def _wavelet_kernel_fft(wavelet_key, scales_key, dt, nSamples, superlet_cycles,
                        L_override=None):
    """
    Host-side kernel bank: sample every scale's wavelet on its reference
    support, normalize like cwt_time (reference transform.py:88-108) /
    cwtSL (reference superlet.py:321-365), embed into a common FFT length
    with the 'same'-convolution center rolled to index 0, and rfft-like
    full FFT it. Returns (kernel_fft[(S, L)] complex64 np, L).
    """
    scales = np.asarray(scales_key)
    if superlet_cycles is not None:
        wav = MorletSL(superlet_cycles)
        supports = 10 * scales * wav.c_i / dt
        norm = dt**0.5 / (4 * np.pi)
    else:
        name, param = wavelet_key
        wav = {"Morlet": Morlet, "Paul": Paul, "DOG": DOG, "Ricker": lambda m: Ricker()}[
            name
        ](param)
        supports = 10 * scales / dt
        norm = None  # per-scale, see below

    # common FFT length covering signal + largest kernel
    Ms = [int(np.ceil(M)) + 1 for M in supports]
    L = L_override or _next_fast_len(nSamples + max(Ms))

    bank = np.zeros((len(scales), L), dtype=np.complex64)
    for i, (s, M) in enumerate(zip(scales, supports)):
        bank[i] = _embedded_kernel(wav, s, M, dt, norm, L)
    return np.fft.fft(bank, axis=1).astype(np.complex64), L


def _sampled_kernel(wav, s, M, dt, norm):
    """Sample one scale's wavelet on its 'same'-convolution support
    (cwt_time normalization when norm is None, reference
    transform.py:88-108; cwtSL's fixed norm otherwise)."""
    t = np.arange((-M + 1) / 2.0, (M + 1) / 2.0) * dt
    if norm is not None:
        kern = norm * wav.time(t, s)
    else:
        kern = (dt**0.5 / (s * 8 * np.pi)) * wav.time(t, s)
    return kern.astype(np.complex64)


def _embedded_kernel(wav, s, M, dt, norm, L):
    """Sample one scale's wavelet on its 'same'-convolution support and
    embed it into an L-point buffer with the center rolled to index 0."""
    kern = _sampled_kernel(wav, s, M, dt, norm)
    K = kern.size
    buf = np.zeros(L, dtype=np.complex64)
    buf[:K] = kern
    return np.roll(buf, -((K - 1) // 2))


@functools.lru_cache(maxsize=32)
def _superlet_bank_fft(scales_key, dt, nSamples, cycles_key, L_override=None):
    """
    Combined multi-order MorletSL bank at ONE common FFT length: the
    per-order banks of :func:`_wavelet_kernel_fft` zero-padded to the
    longest order's L (linear convolution is invariant to extra padding,
    so every order's transform is unchanged). Returns
    ``(bank_fft (nOrders, nScales, L) complex64 np, L)``.
    """
    scales = np.asarray(scales_key)
    norm = dt**0.5 / (4 * np.pi)
    max_support = 10 * scales.max() * max(cycles_key) / dt
    L = L_override or _next_fast_len(nSamples + int(np.ceil(max_support)) + 1)
    bank = np.zeros((len(cycles_key), len(scales), L), dtype=np.complex64)
    for o, cycles in enumerate(cycles_key):
        wav = MorletSL(cycles)
        supports = 10 * scales * wav.c_i / dt
        for i, (s, M) in enumerate(zip(scales, supports)):
            bank[o, i] = _embedded_kernel(wav, s, M, dt, norm, L)
    return np.fft.fft(bank, axis=2).astype(np.complex64), L


# --------------------------------------------------------------------- #
# Direct time-domain GEMM convolution: the GEMM path for short trials.
#
# The FFT path runs ~(S+1) platform FFTs of the padded length L per
# trial-channel. For short trials the whole 'same' convolution
# is instead ONE constant matrix G[(s, t), m] = kern_s[t - m + c_s]
# applied as two real (S*T, T) @ (T, C) GEMMs (re/im of the analytic
# kernels; the data is real) — S*T*T MACs instead of (S+1)*L*log L, but
# as dense GEMMs, with no padding to a power of two and no
# per-scale length buckets. Equal to the FFT path's cropped linear
# convolution exactly (the FFT path's L >= T + K rules out wraparound).
# --------------------------------------------------------------------- #

_GEMM_BANK_CAP_BYTES = float(os.environ.get("SPY_TPU_WAVELET_GEMM_CAP", 2**31))


def _gemm_fingerprint():
    """Trace-time state the wavelet/superlet programs bake in — CRs
    return this from extra_cache_key so a mid-process knob flip never
    reuses a stale executable."""
    import jax as _jax

    return (
        os.environ.get("SPY_TPU_WAVELET_GEMM", "auto"),
        os.environ.get("SPY_TPU_WAVELET_GEMM_PRECISION", "highest"),
        _jax.default_backend(),
    )


#: longest trial the CWT sends to the GEMM bank on the GPU (see below)
_GEMM_MAX_SAMPLES = 1024


def _prefer_conv_gemm(nSamples, n_rows, superlet=False):
    """Dense GEMM convolution instead of the padded-FFT bank? Measured on
    an NVIDIA H100 (700 W) at 250 trials x 64 ch, 24 frequencies, in
    alternating pairs in one process (benchmarks/branch_ab.py
    --wavelet-ab; median [min-max] of 30 warm calls each): the Morlet CWT
    at T = 500 takes 0.028 [0.025-0.035] s on the GEMM bank vs 0.057
    [0.049-0.063] s on the FFT bank, at T = 1000 0.087 [0.080-0.119] vs
    0.094 [0.076-0.142] s, at T = 2000 0.233 [0.221-0.286] vs 0.164
    [0.150-0.212] s. The GEMM work grows ~T^2 per trial, the FFT's
    ~L log L, and both linearly in the number of scales, so the crossover
    is a trial length: the GEMM bank takes trials up to 1024 samples. The
    superlet (120 order-scale pairs at T = 1000) runs 0.229 s on the GEMM
    bank vs 0.165 s on the FFT bank and always takes the FFT bank; so does
    the CPU. The bank-byte cap keeps the constant (and its one-time
    upload) bounded. SPY_TPU_WAVELET_GEMM=1/0 forces either path."""
    mode = os.environ.get("SPY_TPU_WAVELET_GEMM", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    if superlet or jax.default_backend() != "gpu":
        return False
    bank_bytes = 8.0 * n_rows * float(nSamples) ** 2
    return nSamples <= _GEMM_MAX_SAMPLES and bank_bytes <= _GEMM_BANK_CAP_BYTES


@functools.lru_cache(maxsize=8)
def _conv_gemm_bank(wavelet_key, scales_key, dt, nSamples, cycles_key=None):
    """
    Host-side direct-convolution bank: float32 (re, im) matrices of shape
    ``(R*T, T)`` with ``G[(r, t), m] = kern_r[t - m + c_r]`` — row block r
    is the 'same'-mode convolution matrix of one scale (or one superlet
    (order, scale) pair when `cycles_key` gives per-row cycle counts).
    Rows whose kernel support exceeds the signal are simply dense.
    """
    T = int(nSamples)
    if cycles_key is not None:
        norm = dt**0.5 / (4 * np.pi)
        specs = [
            (MorletSL(c), s, 10 * s * c / dt, norm)
            for s, c in zip(scales_key, cycles_key)
        ]
    else:
        name, param = wavelet_key
        wav = {"Morlet": Morlet, "Paul": Paul, "DOG": DOG,
               "Ricker": lambda m: Ricker()}[name](param)
        specs = [(wav, s, 10 * s / dt, None) for s in scales_key]

    Gr = np.zeros((len(specs) * T, T), dtype=np.float32)
    Gi = np.zeros((len(specs) * T, T), dtype=np.float32)
    m = np.arange(T)[None, :]
    t = np.arange(T)[:, None]
    for r, (wav, s, M, norm) in enumerate(specs):
        kern = _sampled_kernel(wav, s, M, dt, norm)
        K = kern.size
        idx = t - m + (K - 1) // 2
        valid = (idx >= 0) & (idx < K)
        block = np.where(valid, kern[np.clip(idx, 0, K - 1)], 0)
        Gr[r * T : (r + 1) * T] = block.real
        Gi[r * T : (r + 1) * T] = block.imag
    return Gr, Gi


def _apply_conv_gemm(data, Gr, Gi, n_rows, nSamples, epilogue="complex"):
    """Two real GEMMs -> (n_rows, nSamples, nChannels).

    `epilogue` fuses the consumer into the GEMM output and skips the
    complex64 materialization (measured 3045 -> ~4050 trials/s on the
    bench wavelet power path): "complex" returns the transform,
    "power" returns float32 |.|^2, "logmag" returns float32 log|.|
    (floored at log 1e-30, matching the FFT magnitude path's floor)."""
    prec = os.environ.get("SPY_TPU_WAVELET_GEMM_PRECISION", "highest")
    x = data.astype(jnp.float32)
    with jax.default_matmul_precision(prec):
        yr = jnp.asarray(Gr) @ x
        yi = jnp.asarray(Gi) @ x
    shape = (n_rows, nSamples) + x.shape[1:]
    if epilogue == "power":
        return (yr * yr + yi * yi).reshape(shape)
    if epilogue == "logmag":
        p = jnp.maximum(yr * yr + yi * yi, jnp.float32(1e-60))
        return (0.5 * jnp.log(p)).reshape(shape)
    return jax.lax.complex(yr, yi).reshape(shape)


def cwt_gemm_consts(wavelet, scales, dt, nSamples):
    """Engine device-constant hook for the CWT: ``(Gr, Gi)`` when the
    direct-GEMM path will run at this trial shape, else ``()`` — the bank
    then crosses as a runtime argument (one upload) instead of a literal
    baked into every executable."""
    scales_t = tuple(np.asarray(scales).tolist())
    if not _prefer_conv_gemm(int(nSamples), len(scales_t)):
        return ()
    name = type(wavelet).__name__
    param = getattr(wavelet, "w0", None) if name == "Morlet" else getattr(wavelet, "m", None)
    return _conv_gemm_bank((name, param), scales_t, float(dt), int(nSamples))


def superlet_gemm_consts(scales, order_max, order_min, c_1, adaptive, dt, nSamples):
    """Engine device-constant hook for the superlet: the (order, scale)
    PAIR bank ``(Gr, Gi)`` when the direct-GEMM path will run, else ``()``.
    Pair order matches the trace-time ``np.nonzero(w > 0)`` walk."""
    w, cycle_orders = superlet_weights(scales, order_max, order_min, adaptive)
    o_ids, s_ids = np.nonzero(w > 0)
    if not _prefer_conv_gemm(int(nSamples), len(s_ids), superlet=True):
        return ()
    scales_t = tuple(np.asarray(scales).tolist())
    cycles_t = tuple(float(c_1) * int(o) for o in cycle_orders)
    return _conv_gemm_bank(
        None, tuple(scales_t[j] for j in s_ids), float(dt), int(nSamples),
        cycles_key=tuple(cycles_t[i] for i in o_ids),
    )


def cwt(data, wavelet, scales, dt, bank=None, power_only=False):
    """
    Batched continuous wavelet transform of a single trial.

    Parameters
    ----------
    data : (nSamples, nChannels) real array (jax)
    wavelet : Morlet/Paul/DOG/Ricker instance
    scales : 1D numpy array of scales (static)
    dt : float sample spacing
    bank : optional (Gr, Gi) direct-convolution bank (device arrays or
        tracers, see :func:`cwt_gemm_consts`) — forces the GEMM path with
        the bank as a runtime operand instead of an embedded literal
    power_only : return float32 ``|W|^2`` instead of the complex
        transform — the production ``output='pow'`` fast path (the GEMM
        epilogue then never materializes the complex array)

    Returns
    -------
    spec : (nScales, nSamples, nChannels) complex64, or float32 power
    """
    nSamples = data.shape[0]
    name = type(wavelet).__name__
    param = getattr(wavelet, "w0", None) if name == "Morlet" else getattr(wavelet, "m", None)
    scales_t = tuple(np.asarray(scales).tolist())
    epi = "power" if power_only else "complex"
    if bank is not None:
        return _apply_conv_gemm(data, bank[0], bank[1], len(scales_t),
                                int(nSamples), epilogue=epi)
    if _prefer_conv_gemm(nSamples, len(scales_t)):
        Gr, Gi = _conv_gemm_bank((name, param), scales_t, float(dt), int(nSamples))
        return _apply_conv_gemm(data, Gr, Gi, len(scales_t), int(nSamples),
                                epilogue=epi)
    if power_only:
        spec = cwt(data, wavelet, scales, dt)
        return (spec * jnp.conj(spec)).real.astype(jnp.float32)
    # per-scale padded length (same support rule as _wavelet_kernel_fft):
    # one bank per length bucket keeps the long transforms for the low
    # frequencies only
    Ls = [_next_fast_len(nSamples + int(np.ceil(10 * s / dt)) + 1)
          for s in scales_t]
    pieces, groups = [], []
    for L_b, idx in _scale_buckets(Ls):
        kfft, _ = _wavelet_kernel_fft(
            (name, param), tuple(scales_t[i] for i in idx), float(dt),
            int(nSamples), None, L_override=L_b,
        )
        pieces.append(_apply_bank(data, kfft, L_b, nSamples))
        groups.append(idx)
    if len(pieces) == 1:
        return pieces[0]
    return _reassemble_scales(pieces, groups, axis=0)


def _apply_bank(data, kernel_fft_np, L, nSamples):
    from .fft import ifft_crop_auto

    X = jnp.fft.fft(data.astype(jnp.float32), n=L, axis=0)  # (L, C)
    Y = jnp.asarray(kernel_fft_np)[:, :, None] * X[None, :, :]  # (S, L, C)
    # inverse transform (matmul DFT where selected); only the first
    # nSamples of the L-point circular convolution are ever consumed
    y = ifft_crop_auto(Y, axis=1, n_out=nSamples)
    return y.astype(jnp.complex64)


def cwt_time_sharded(data, wavelet, scales, dt, mesh, axis_name="trial"):
    """
    Continuous wavelet transform of a signal whose TIME axis is sharded
    across the mesh — the context-parallel analog for recordings whose
    per-device FFT bank (nScales x fft_len x nChannels complex) would not
    fit a single device's HBM (SURVEY.md §5 "long-context"; reference
    wavelet.py:15-49 computes on one host).

    Each shard exchanges a wavelet-support halo with its ring neighbors
    (`lax.ppermute`), runs the FFT bank on its extended local
    block, and crops — equal to :func:`cwt` on the full signal wherever
    the halo covers the kernel support (interior everywhere; edges use the
    same zero extension). The result stays sharded along the time axis.

    Parameters
    ----------
    data : (nSamples, nChannels), nSamples divisible by the mesh axis size
    wavelet, scales, dt : as in :func:`cwt`
    mesh : jax.sharding.Mesh with `axis_name`

    Returns
    -------
    spec : (nScales, nSamples, nChannels) complex64, time-sharded (axis 1)
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    T = data.shape[0]
    n_dev = mesh.shape[axis_name]
    if T % n_dev:
        raise ValueError("nSamples must be divisible by the mesh axis size")
    T_local = T // n_dev
    # kernel reaches +-5*scale/dt around each sample (support = 10*scale/dt)
    halo = int(np.ceil(5.0 * float(np.max(np.asarray(scales))) / dt)) + 1
    if halo > T_local:
        raise ValueError(
            "wavelet halo ({} samples) exceeds the local shard ({}); use "
            "fewer devices or smaller scales".format(halo, T_local)
        )

    name = type(wavelet).__name__
    param = getattr(wavelet, "w0", None) if name == "Morlet" else getattr(wavelet, "m", None)
    kfft, L = _wavelet_kernel_fft(
        (name, param), tuple(np.asarray(scales).tolist()), float(dt),
        int(T_local + 2 * halo), None,
    )

    def local(xs):
        idx_dev = jax.lax.axis_index(axis_name)
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        left = jax.lax.ppermute(xs[-halo:], axis_name, fwd)
        right = jax.lax.ppermute(xs[:halo], axis_name, bwd)
        left = jnp.where(idx_dev == 0, jnp.zeros_like(left), left)
        right = jnp.where(idx_dev == n_dev - 1, jnp.zeros_like(right), right)
        ext = jnp.concatenate([left, xs, right], axis=0)
        spec = _apply_bank(ext, kfft, L, T_local + 2 * halo)
        return spec[:, halo : halo + T_local, :]

    fn = shard_map(
        local, mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=P(None, axis_name, None),
        check_vma=False,
    )
    x_sharded = jax.device_put(jnp.asarray(data), NamedSharding(mesh, P(axis_name, None)))
    return fn(x_sharded)


class WaveletAnalysis:
    """
    Object-oriented CWT convenience wrapper (parity with the reference's
    vendored lib, transform.py:208-600): transform, power, reconstruction,
    cone of influence and global spectrum of a 1-d (or multi-channel)
    signal.
    """

    def __init__(self, data, time=None, dt=1.0, dj=0.125, wavelet=None,
                 unbias=False, mask_coi=False, frequency=False, axis=0):
        self.data = np.atleast_2d(np.asarray(data, dtype=np.float32).T).T
        if self.data.shape[0] == 1 and axis == 0:
            self.data = self.data.T
        self.anomaly = self.data - self.data.mean(axis=0, keepdims=True)
        self.n_samples = self.data.shape[0]
        self.dt = float(dt)
        self.dj = float(dj)
        self.wavelet = wavelet or Morlet(6)
        self.unbias = unbias
        self.mask_coi = mask_coi
        self.time = time if time is not None else np.arange(self.n_samples) * self.dt
        self._transform = None

    @property
    def scales(self):
        if not hasattr(self, "_scales"):
            self._scales = get_optimal_wavelet_scales(
                self.wavelet.scale_from_period, self.n_samples, self.dt, self.dj
            )[::-1]
        return self._scales

    @scales.setter
    def scales(self, value):
        self._scales = np.asarray(value)
        self._transform = None

    @property
    def fourier_periods(self):
        return self.wavelet.fourier_period(self.scales)

    @property
    def fourier_frequencies(self):
        return 1.0 / self.fourier_periods

    @property
    def wavelet_transform(self):
        """(nScales, nSamples, nChannels) complex CWT."""
        if self._transform is None:
            self._transform = np.asarray(
                cwt(self.anomaly, self.wavelet, self.scales, self.dt)
            )
        return self._transform

    @property
    def wavelet_power(self):
        power = np.abs(self.wavelet_transform) ** 2
        if self.unbias:
            power = power / self.scales[:, None, None]
        if self.mask_coi:
            power = np.where(self.inside_coi[:, :, None], power, np.nan)
        return power

    @property
    def coi(self):
        """Cone-of-influence e-folding time per time point."""
        t = self.time
        left = t - t[0]
        right = t[-1] - t
        return np.minimum(left, right)

    @property
    def inside_coi(self):
        """(nScales, nSamples) mask: True where edge effects are negligible
        (e-folding times per wavelet family, reference wavelets.py coi)."""
        if isinstance(self.wavelet, Paul):
            efold = self.scales / np.sqrt(2)
        else:  # Morlet / DOG / Ricker
            efold = np.sqrt(2) * self.scales
        return efold[:, None] < self.coi[None, :]

    @property
    def global_wavelet_spectrum(self):
        mean_power = np.nanmean(self.wavelet_power, axis=(1, 2))
        var = self.anomaly.var()
        return mean_power / var if var > 0 else mean_power

    @property
    def N(self):
        return self.n_samples

    @property
    def w_k(self):
        """Angular frequencies of the Fourier indices (T&C eq. 5)."""
        return 2 * np.pi * np.fft.fftfreq(self.n_samples, self.dt)

    @property
    def fourier_period(self):
        return self.wavelet.fourier_period

    @property
    def scale_from_period(self):
        return self.wavelet.scale_from_period

    def find_s0(self):
        """Smallest resolvable scale: fourier_period(s0) = 2 dt
        (reference transform.py:309-319)."""
        from scipy.optimize import fsolve

        return float(fsolve(lambda s: self.wavelet.fourier_period(s) - 2 * self.dt, 1.0)[0])

    @property
    def s0(self):
        if not hasattr(self, "_s0"):
            self._s0 = self.find_s0()
        return self._s0

    @s0.setter
    def s0(self, value):
        self._s0 = float(value)

    def compute_optimal_scales(self):
        """Fractional powers of two s_j = s0 * 2^(j dj) up to N dt
        (T&C eq. 9-10; reference transform.py:332-366)."""
        J = int(np.floor((1.0 / self.dj) * np.log2(self.n_samples * self.dt / self.s0)))
        return self.s0 * 2.0 ** (self.dj * np.arange(J + 1))

    @property
    def wavelet_transform_delta(self):
        """Transform of a delta function, summed over Fourier indices —
        used to derive C_delta empirically (T&C section 3.i)."""
        WK, S = np.meshgrid(self.w_k, self.scales)
        norm = (2 * np.pi * S / self.dt) ** 0.5
        return (1.0 / self.n_samples) * np.sum(norm * self.wavelet.frequency(WK, S), axis=1)

    def compute_Cdelta(self):
        """Empirical C_delta from the delta-function transform."""
        Y_00 = self.wavelet.time(0.0)
        real_sum = np.sum(self.wavelet_transform_delta.real / self.scales**0.5)
        return float(np.real(real_sum * (self.dj * self.dt**0.5 / Y_00)))

    @property
    def C_d(self):
        """Reconstruction constant: tabulated on the wavelet when known
        (T&C Table 2), else derived via :meth:`compute_Cdelta`."""
        return getattr(self.wavelet, "C_d", None) or self.compute_Cdelta()

    @property
    def wavelet_variance(self):
        """Parseval analog: total variance from the scale-normalized power
        (T&C eq. 14)."""
        A = self.dj * self.dt / (self.C_d * self.n_samples)
        return A * np.sum(np.abs(self.wavelet_transform) ** 2 / self.scales[:, None, None])

    def coi_mean(self, axis=1):
        """Time-mean of the wavelet power restricted to the cone of
        influence (reference transform.py:460-474)."""
        power = np.where(self.inside_coi[:, :, None], self.wavelet_power, np.nan)
        return np.nanmean(power, axis=axis)

    def reconstruction(self):
        """Inverse transform (Torrence & Compo Eq. 11, C_delta for Morlet)."""
        C_d = 0.776
        Y_00 = np.pi ** (-0.25)
        W = self.wavelet_transform
        real_sum = np.sum(W.real / np.sqrt(self.scales)[:, None, None], axis=0)
        x_n = real_sum * (self.dj * np.sqrt(self.dt) / (C_d * Y_00))
        # rescale to account for the time-domain sampling of the kernels
        num = x_n.std(axis=0)
        den = self.anomaly.std(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.where(num > 0, den / num, 1.0)
        return x_n * ratio + self.data.mean(axis=0, keepdims=True)


def superlet_weights(scales, order_max, order_min=1, adaptive=False):
    """
    Geometric-mean exponent matrix w[(order, scale)] for the superlet
    transform: SLT = prod_o |spec_o|^(w[o, s]) (complex powers).

    Multiplicative SLT (reference superlet.py:108-125): uniform
    ``1/order_num``. Fractional adaptive SLT (reference superlet.py:128-196):
    scale-dependent orders with fractional last contribution.
    """
    scales = np.asarray(scales)
    if not adaptive:
        order_num = order_max + 1 - order_min
        cycles_list = list(range(order_min, order_max + 1))
        w = np.full((len(cycles_list), scales.size), 1.0 / order_num)
        return w, cycles_list

    fois = 1 / (2 * np.pi * scales)
    f_min, f_max = fois[0], fois[-1]
    orders = order_min + (order_max - order_min) * (fois - f_min) / (f_max - f_min)
    orders_int = np.int32(np.floor(orders))
    exponents = 1 / (orders - order_min + 1)
    alphas = orders % orders_int

    # only the unique integer floors are materialized as wavelets; the
    # fractional contribution of a scale comes from the NEXT unique order
    # present (reference superlet.py:146-196 walks `order_jumps`)
    uniq = [int(o) for o in np.unique(orders_int)]
    w = np.zeros((len(uniq), scales.size))
    for k, o in enumerate(uniq):
        w[k] = np.where(o <= orders_int, exponents, 0.0)
        if k > 0:
            prev_band = orders_int == uniq[k - 1]
            w[k] += np.where(prev_band, alphas * exponents, 0.0)
    return w, uniq


def superlet(data, scales, order_max, order_min=1, c_1=3, adaptive=False,
             dt=1.0, magnitude_only=False, bank=None):
    """
    Superlet transform of one trial (reference superlet.py:15-108).

    Returns (nScales, nSamples, nChannels) complex64 — the geometric mean
    of MorletSL wavelet transforms across orders — or, with
    ``magnitude_only=True``, the float32 MAGNITUDE of that geometric mean.

    The magnitude path is the production TFR fast path: for
    ``output='pow'/'abs'`` only ``|gmean|`` survives, and
    ``|prod_o spec_o^w| = exp(sum_o w log|spec_o|)`` — real log/exp
    instead of complex log (log + atan2) and complex exp (exp +
    sin/cos), and float32 accumulation instead of complex64. Identical
    magnitudes up to float rounding (tested).
    """
    w, cycle_orders = superlet_weights(scales, order_max, order_min, adaptive)
    nSamples = data.shape[0]
    scales_t = tuple(np.asarray(scales).tolist())
    # keep c_1 as a float: fractional base cycle counts are valid MorletSL
    # bandwidths (the frontend coerces to int, the ops API need not)
    cycles_t = tuple(float(c_1) * int(o) for o in cycle_orders)

    # GEMM path: only the (order, scale) pairs with nonzero geometric-mean
    # weight are materialized as convolution rows (the adaptive SLT zeroes
    # roughly half the order x scale grid); the weighted log accumulation
    # across orders becomes a segment_sum over the pair -> scale map.
    o_ids, s_ids = np.nonzero(w > 0)
    if bank is not None or _prefer_conv_gemm(nSamples, len(s_ids), superlet=True):
        if bank is None:
            bank = _conv_gemm_bank(
                None, tuple(scales_t[j] for j in s_ids), float(dt),
                int(nSamples), cycles_key=tuple(cycles_t[i] for i in o_ids),
            )
        P, S = len(s_ids), len(scales_t)
        # weighted pair -> scale accumulation as ONE small GEMM: a
        # scatter-style segment_sum here measured ~2x slower end to end
        # (the (S, P) contraction is a GEMM, the scatter is not)
        W2 = np.zeros((S, P), dtype=np.float32)
        W2[s_ids, np.arange(P)] = w[o_ids, s_ids]
        w2 = jnp.asarray(W2)
        C_shape = data.shape[1:]
        if magnitude_only:
            # fused epilogue: log|spec| straight off the GEMM accumulators
            # (no complex materialization, no sqrt — 0.5 log|.|^2)
            logm = _apply_conv_gemm(data, bank[0], bank[1], P,
                                    int(nSamples), epilogue="logmag")
            acc = jnp.matmul(w2, logm.reshape(P, -1), precision=jax.lax.Precision.HIGHEST)
            acc = acc.reshape((S, nSamples) + C_shape)
            return jnp.exp(acc).astype(jnp.float32)
        spec = _apply_conv_gemm(data, bank[0], bank[1], P, int(nSamples))
        logs = jnp.log(spec).reshape(P, -1)
        acc_re = jnp.matmul(w2, logs.real, precision=jax.lax.Precision.HIGHEST)
        acc_im = jnp.matmul(w2, logs.imag, precision=jax.lax.Precision.HIGHEST)
        acc = jax.lax.complex(acc_re, acc_im).reshape((S, nSamples) + C_shape)
        return jnp.exp(acc).astype(jnp.complex64)

    W = jnp.asarray(w.T, dtype=jnp.float32)  # (S, O)

    def scale_block(X, args):
        from .fft import ifft_crop_auto

        k_s, w_s = args  # (O, L), (O,)
        spec = ifft_crop_auto(k_s[:, :, None] * X[None, :, :], axis=1,
                             n_out=nSamples)  # (O, T, C)
        wl = w_s[:, None, None]
        if magnitude_only:
            a = jnp.abs(spec).astype(jnp.float32)
            # floor keeps log finite; exp of the w-weighted sum of log(1e-30)
            # underflows to the same 0 the complex path produces at |spec|=0
            logm = jnp.where(wl > 0, jnp.log(jnp.maximum(a, 1e-30)), 0.0)
            return jnp.exp(jnp.sum(wl * logm, axis=0)).astype(jnp.float32)
        # complex log-power accumulation over orders; w=0 contributes 0
        logspec = jnp.where(wl > 0, jnp.log(spec), 0.0 + 0.0j)
        gmean = jnp.exp(jnp.sum(wl.astype(jnp.complex64) * logspec, axis=0))
        return gmean.astype(jnp.complex64)  # (T, C)

    # per-scale padded length (same support rule as _superlet_bank_fft):
    # low frequencies need supports the high frequencies don't — one bank
    # per length bucket keeps traffic and GEMM work ∝ each scale's own L
    max_c = max(cycles_t)
    Ls = [_next_fast_len(nSamples + int(np.ceil(10 * s * max_c / dt)) + 1)
          for s in scales_t]
    pieces, groups = [], []
    for L_b, idx in _scale_buckets(Ls):
        bank, _ = _superlet_bank_fft(
            tuple(scales_t[i] for i in idx), float(dt), int(nSamples),
            cycles_t, L_override=L_b,
        )
        X = jnp.fft.fft(data.astype(jnp.float32), n=L_b, axis=0)  # (L_b, C)
        K = jnp.swapaxes(jnp.asarray(bank), 0, 1)  # (S_b, O, L_b)
        W_b = W[np.asarray(idx)]
        # lax.map over scales: one (O, L, C) block live at a time instead
        # of the full (O, S, L, C) bank — under the engine's trial vmap
        # this is what lets the chunk size reach hundreds of trials.
        # SPY_TPU_SUPERLET_SCALE_BATCH vmaps that many scales per step
        # (bigger FFT batches, more workspace).
        pieces.append(jax.lax.map(
            functools.partial(scale_block, X), (K, W_b),
            batch_size=_SCALE_BATCH if _SCALE_BATCH > 1 else None))
        groups.append(idx)
    if len(pieces) == 1:
        return pieces[0]
    return _reassemble_scales(pieces, groups, axis=0)


# Reference exports both names for the same class (wavelets/transform.py:11,614).
WaveletTransform = WaveletAnalysis
