# -*- coding: utf-8 -*-
#
# Connectivity kernels: cross-spectra, coherence normalization,
# cross-covariance, Wilson spectral factorization, Granger causality, PPC.
#
# Parity targets: reference syncopy/connectivity/csd.py:16-175,
# wilson_sf.py:16-262, granger.py:10-80, ST_compRoutines.py:29-640,
# AV_compRoutines.py:35-484. Device redesign notes:
#   - the per-channel-pair host loops (cross-covariance, csd) become
#     batched outer products / FFT convolutions on device;
#   - Wilson's iteration runs as a `lax.while_loop` over batched
#     (nFreq, N, N) cholesky/inverse/fft steps;
#   - the PPC O(nTrials^2) pair loop (reference
#     connectivity_analysis.py:624-667) collapses to the algebraic identity
#     sum_{j<k} cos(th_j - th_k) = (|sum_j u_j|^2 - n) / 2 with
#     u_j = z_j/|z_j| — an O(nTrials) reduction over the trial stack.

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

from .spectral import detrend, mtmfft, spectral_convert
from .windows import make_tapers

__all__ = [
    "cross_spectra_trial",
    "spectral_dyadic_product",
    "normalize_csd",
    "normalize_ccov",
    "cross_covariance_trial",
    "wilson_sf",
    "regularize_csd",
    "granger",
    "ppc_from_spectra",
]


def cross_spectra_trial(trial, samplerate, nfft, taper="hann", taper_opt=None,
                        demean_taper=False, polyremoval=0, freq_idx=None):
    """
    Single-trial (multi-)tapered cross spectra: mtmfft + dyadic product,
    tapers averaged (reference csd.py:16-115, ST_compRoutines.py:270-430).

    Returns ``(1, nFreq, N, N)`` complex64.
    """
    x = detrend(trial.astype(jnp.float32), polyremoval, axis=0)
    tapers = jnp.asarray(
        make_tapers(taper, taper_opt, trial.shape[0], nfft, samplerate)
    )
    specs = mtmfft(x, tapers, nfft, demean_taper=demean_taper)  # (K, F, C)
    if freq_idx is not None:
        specs = jnp.take(specs, jnp.asarray(freq_idx), axis=1)
    # outer product over channels, mean over tapers: (F, C, C)
    CS = jnp.einsum(
        "kfi,kfj->fij", specs, jnp.conj(specs), precision=jax.lax.Precision.HIGHEST
    ) / specs.shape[0]
    return CS[None].astype(jnp.complex64)


def spectral_dyadic_product(spec, send_idx=None, rec_idx=None):
    """
    Cross spectra from complex (time-)frequency spectra: outer product over
    the channel axis, tapers averaged (reference ST_compRoutines.py:29-120).

    Parameters
    ----------
    spec : (nTime, nTaper, nFreq, nChannel) complex array
    send_idx, rec_idx : optional channel index arrays restricting the
        product to (senders x receivers) combinations

    Returns
    -------
    CS : (nTime, nFreq, nSend, nRec) complex64
    """
    if send_idx is not None:
        a = jnp.take(spec, jnp.asarray(send_idx), axis=3)
        b = jnp.take(spec, jnp.asarray(rec_idx), axis=3)
    else:
        a = b = spec
    CS = jnp.einsum(
        "tkfi,tkfj->tfij", a, jnp.conj(b), precision=jax.lax.Precision.HIGHEST
    ) / spec.shape[1]
    return CS.astype(jnp.complex64)


def normalize_csd(csd_av, output="abs"):
    """Coherency from a trial-averaged CSD: ``C_ij = S_ij/sqrt(S_ii S_jj)``
    (reference csd.py:118-175)."""
    diag = jnp.diagonal(csd_av, axis1=-2, axis2=-1)
    Ciijj = jnp.sqrt((diag[..., :, None] * diag[..., None, :]).real)
    return spectral_convert(csd_av / Ciijj, output)


def normalize_ccov(ccov_av):
    """Cross-correlation from trial-averaged cross-covariance: normalize
    by the 0-lag auto-covariances (reference AV_compRoutines.py:165-218)."""
    diag = jnp.diagonal(ccov_av[0, 0], axis1=-2, axis2=-1)
    Ciijj = jnp.sqrt(diag[:, None] * diag[None, :]).T
    return (ccov_av[:, 0] / Ciijj)[:, None].astype(jnp.float32)


def _ccov_lags_fft(x, n_lags, delta):
    """Lags ``0..n_lags`` of ``R[l, i, j] = sum_m x_i[m] x_j[m-l]`` via a
    zero-padded FFT correlation over all C^2 channel pairs."""
    T = x.shape[0]
    L = 1 << int(2 * T - 1).bit_length()
    X = jnp.fft.rfft(x, n=L, axis=0)  # (Lf, C)
    R = jnp.fft.irfft(X[:, :, None] * jnp.conj(X[:, None, :]), n=L, axis=0)
    return R[: n_lags + delta]


def _ccov_lags_gemm(x, n_lags, delta, block=64):
    """Same lags as :func:`_ccov_lags_fft`, evaluated directly as
    lag-batched channel Grams: ``R[l] = x^T @ shift(x, l)``, computing
    only the ~T/2 lags the output keeps (exact-f32 GEMMs). lax.map over
    lag blocks keeps the shifted workspace at ``block * T * C`` floats.
    Not on any production path (see :func:`cross_covariance_trial`);
    queued for deletion."""
    T, C = x.shape
    n_out = n_lags + delta
    n_blocks = -(-n_out // block)
    xp = jnp.pad(x, ((n_out, 0), (0, 0)))

    def one_block(l0):
        sh = jax.vmap(
            lambda l: jax.lax.dynamic_slice(xp, (n_out - l0 - l, 0), (T, C))
        )(jnp.arange(block))  # (block, T, C): sh[b, m] = x[m - (l0+b)]
        with jax.default_matmul_precision("highest"):
            return jnp.einsum("ti,ltj->lij", x, sh)

    R = jax.lax.map(one_block, jnp.arange(n_blocks) * block)
    return R.reshape(n_blocks * block, C, C)[:n_out]


def _ccov_lag_geometry(T):
    """Lag count and the even-length upper-triangle offset.

    The reference fills the upper triangle by reversing the 'same'-mode
    slice (ST_compRoutines.py:603-607), which lands on R_ij(l+1) for
    even trial lengths and R_ij(l) for odd ones — reproduce exactly."""
    n_lags = T // 2 if T % 2 == 0 else T // 2 + 1
    delta = 1 if T % 2 == 0 else 0
    return n_lags, delta


def _ccov_assemble(R, T):
    """(nLags, C, C) overlap-normalized cross-covariance from raw lags
    ``R[l, i, j] = sum_m x_i[m] x_j[m-l]`` (length >= n_lags + delta)."""
    n_lags, delta = _ccov_lag_geometry(T)
    lower = R[:n_lags]  # R_ij(l), used for i >= j
    upper = R[delta : n_lags + delta]  # R_ij(l+delta) fills i < j
    n_chan = R.shape[-1]
    low_mask = jnp.tril(jnp.ones((n_chan, n_chan), dtype=bool))
    CC = jnp.where(low_mask[None], lower, upper)
    overlap = jnp.arange(T, T - n_lags, -1).astype(jnp.float32)
    return CC / overlap[:, None, None]


def cross_covariance_trial(trial, polyremoval=0, norm=False):
    """
    Single-trial cross-covariance at non-negative lags (reference
    ST_compRoutines.py:465-610 runs a per-pair fftconvolve host loop):
    batched FFT correlation on every platform. On an NVIDIA H100 (700 W)
    it takes 0.013 s for 128 trials x 64 ch x 1000 samples, the
    lag-batched Grams of :func:`_ccov_lags_gemm` (identical to float
    rounding, equality-tested) 0.037 s (benchmarks/branch_ab.py).

    Returns ``(nLags, 1, N, N)`` float32 with
    ``CC[l, 0, i, j] = sum_m x_i[m] x_j[m-l] / (T - l)``.
    """
    x = detrend(trial.astype(jnp.float32), polyremoval, axis=0)
    T = x.shape[0]
    n_lags, delta = _ccov_lag_geometry(T)
    R = _ccov_lags_fft(x, n_lags, delta)
    CC = _ccov_assemble(R, T)
    if norm:
        stds = jnp.std(x, axis=0)
        CC = CC / (stds[:, None] * stds[None, :])
    return CC[:, None, :, :].astype(jnp.float32)


def ccov_batch_sum(batch, n_valid, polyremoval=0):
    """
    Masked trial-SUMMED cross-covariance at non-negative lags — the
    keeptrials=False fast path (reference AV_compRoutines.py:165-218
    averages per-trial outputs; here the per-trial lag tensors never
    exist).

    Per-trial cross-covariance is linear in the per-trial cross spectrum,
    so the trial sum accumulates in the FREQUENCY domain as one
    per-frequency trial Gram — ``S[f, i, j] = sum_b X[b, f, i]
    conj(X[b, f, j])`` — followed by a SINGLE inverse FFT for the whole
    batch. That is ~100x fewer FLOPs than summing per-trial lag-GEMMs
    (one (C, T, C) Gram per trial vs one (B, C, C) Gram per frequency),
    and both heavy stages are GEMM/radix-2 FFT work.

    Returns ``(nLags, 1, C, C)`` float32, equal to
    ``sum_b cross_covariance_trial(batch[b])`` over the first ``n_valid``
    rows (FFT-roundtrip rounding only).
    """
    B, T, _ = batch.shape
    x = detrend(batch.astype(jnp.float32), polyremoval, axis=1)
    # where-mask (not multiply): padding rows can be NaN garbage
    mask = (jnp.arange(B) < n_valid)[:, None, None]
    x = jnp.where(mask, x, jnp.zeros((), x.dtype))
    L = 1 << int(2 * T - 1).bit_length()
    X = jnp.fft.rfft(x, n=L, axis=1)  # (B, Lf, C)
    with jax.default_matmul_precision("highest"):
        S = jnp.einsum("bfi,bfj->fij", X, jnp.conj(X))
    R = jnp.fft.irfft(S, n=L, axis=0)
    return _ccov_assemble(R, T)[:, None, :, :].astype(jnp.float32)


# ------------------------------------------------------------------------ #
# Compensated (double-word float32) helpers for the device Wilson path.
#
# The device path runs in float32, but Wilson factorization needs the
# RESIDUAL ``R = CSD - psi @ psi^H`` resolved well below float32 rounding:
# the iteration is Newton's method, so only the residual must be accurate —
# every correction term may be computed in float32 (classical mixed-
# precision iterative refinement). The residual GEMM uses Ozaki-style
# 8-bit mantissa slicing: slice products are integer-valued and accumulate
# EXACTLY in float32 accumulators (2*8 mantissa bits + log2(K)
# carry bits < 24 for K <= 256 channels), and the slice partials combine
# via error-free TwoSum into a double-float32 value (~2^-45 relative).
# ------------------------------------------------------------------------ #


def _two_sum(a, b):
    """Error-free float add (Knuth): returns (s, e) with s + e == a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


@functools.lru_cache(maxsize=8)
def _dft_twiddles_df32(nfft, T):
    """One-sided DFT twiddle matrix in double-float32: W = Whi + Wlo with
    Whi = f32(W64). Host-side, cached per (nfft, signal length)."""
    k = np.arange(nfft // 2 + 1)
    n = np.arange(T)
    W = np.exp(-2j * np.pi * np.outer(k, n) / nfft)
    Whi_re = W.real.astype(np.float32)
    Wlo_re = (W.real - Whi_re.astype(np.float64)).astype(np.float32)
    Whi_im = W.imag.astype(np.float32)
    Wlo_im = (W.imag - Whi_im.astype(np.float64)).astype(np.float32)
    return Whi_re, Wlo_re, Whi_im, Wlo_im


def rfft_df32(x, nfft):
    """
    One-sided DFT of real float32 input to ~double-float32 accuracy, as
    compensated GEMMs.

    Why not jnp.fft.rfft: a float32 FFT is accurate to ~2.4e-7 of the
    spectral maximum, but its error structure is NOT that of a valid
    signal's spectrum — a trial-averaged CSD built from such spectra has
    no exact Wilson factorization, and Granger's elementwise-relative
    factorization error floors ~100x above the spectral error (tiny
    off-diagonal entries amplify absolute inconsistencies). Computing the
    DFT as a compensated matmul against double-float32 twiddles removes
    the floor: slice products accumulate exactly (q=7: contractions up to
    1024 samples), the f64->f32 twiddle residual is applied as a plain
    correction term.

    Parameters
    ----------
    x : (T, M) float32, T <= 1024
    nfft : int >= T (zero-padding is implicit)

    Returns
    -------
    (Yr_hi, Yr_lo, Yi_hi, Yi_lo) : each (nfft//2+1, M) float32 —
        the spectrum as double-float32 real/imag pairs
    """
    T = x.shape[0]
    if T > 1024:
        raise ValueError("rfft_df32 supports signal lengths up to 1024 samples")
    Whi_re, Wlo_re, Whi_im, Wlo_im = _dft_twiddles_df32(int(nfft), int(T))
    xT = jnp.swapaxes(x, 0, 1)  # (M, T) for the NT contraction
    with jax.default_matmul_precision("highest"):
        hr, lr = _gemm_nt_compensated(jnp.asarray(Whi_re), xT, q=7)
        hi, li = _gemm_nt_compensated(jnp.asarray(Whi_im), xT, q=7)
        lr = lr + jnp.asarray(Wlo_re) @ x
        li = li + jnp.asarray(Wlo_im) @ x
    return hr, lr, hi, li


def csd_sum_df32(tapered, nfft, freq_idx=None):
    """
    Trial/taper-summed CSD from tapered time-domain signals with the
    WHOLE spectral pipeline in double-float32: compensated DFT
    (:func:`rfft_df32`) followed by a compensated Gram accumulation. This
    is the factorization-grade CSD path for Granger — the resulting CSD
    matches the float64 computation to ~1e-9 relative, so the Wilson
    error converges to the reference rtol instead of flooring at the
    float32 FFT noise.

    Parameters
    ----------
    tapered : (B, K, T, C) float32 — detrended, tapered trial signals
    nfft : int
    freq_idx : optional frequency subselection (applied to the result)

    Returns
    -------
    (F, C, C) complex64 trial+taper SUM (not averaged)
    """
    B, K, T, C = tapered.shape
    M = B * K * C
    x2d = jnp.transpose(tapered, (2, 0, 1, 3)).reshape(T, M)
    hr, lr, hi, li = rfft_df32(x2d, nfft)
    F = hr.shape[0]
    if freq_idx is not None:
        idx = jnp.asarray(freq_idx)
        hr, lr, hi, li = (jnp.take(a, idx, axis=0) for a in (hr, lr, hi, li))
        F = idx.shape[0]

    def to_bkfc(a):
        return jnp.transpose(a.reshape(F, B, K, C), (1, 2, 0, 3))

    spec_hi = jax.lax.complex(to_bkfc(hr), to_bkfc(hi))
    spec_lo = jax.lax.complex(to_bkfc(lr), to_bkfc(li))
    # Gram of (hi + lo): hi x hi compensated; the hi x lo cross terms are
    # ~1e-7 of the result, plain HIGHEST accumulation suffices; lo x lo
    # is negligible
    cs = csd_sum_compensated(spec_hi)
    with jax.default_matmul_precision("highest"):
        cross = jnp.einsum("bkfi,bkfj->fij", spec_hi, jnp.conj(spec_lo))
        cross = cross + jnp.conj(jnp.swapaxes(cross, 1, 2))
    return (cs + cross).astype(jnp.complex64)


def csd_sum_compensated(spec, sub=16):
    """
    Trial/taper-summed cross-spectral density ``sum_bk s_bki conj(s_bkj)``
    with compensated (double-float32) accumulation.

    Why: a float32 GEMM accumulating a 1000-term contraction serially —
    the resulting CSD deviates from the float64 sum by ~3e-5 relative,
    which is enough that NO exact Wilson spectral factorization of it
    exists (the interpolated density dips negative between frequency grid
    points), so Granger's factorization error floors at the accumulation
    noise in ANY precision (measured: host float64 floors at the same
    3.6e-5 on an f32-accumulated CSD, while the f64-accumulated CSD
    factorizes in f32 to 9e-8). Splitting the sum into `sub`-row partials
    (serial error <= sub*eps) combined with an error-free TwoSum tree
    brings the noise to ~1e-7 — factorizable at the reference rtol.

    Parameters
    ----------
    spec : (B, K, F, C) complex64 — per-trial tapered spectra (zero rows
        for padded trials contribute nothing)

    Returns
    -------
    (F, C, C) complex64 trial+taper SUM (not averaged)
    """
    B, K, F, C = spec.shape
    rows = jnp.transpose(spec, (2, 0, 1, 3)).reshape(F, B * K, C)
    pad = (-rows.shape[1]) % sub
    if pad:
        rows = jnp.pad(rows, ((0, 0), (0, pad), (0, 0)))
    g = rows.shape[1] // sub
    rows = rows.reshape(F, g, sub, C)
    parts = jnp.einsum(
        "fgsi,fgsj->gfij", rows, jnp.conj(rows),
        precision=jax.lax.Precision.HIGHEST,
    )
    pr, pi = jnp.real(parts), jnp.imag(parts)

    def body(i, st):
        hi_r, lo_r, hi_i, lo_i = st
        s, e = _two_sum(hi_r, pr[i])
        hi_r, lo_r = s, lo_r + e
        s, e = _two_sum(hi_i, pi[i])
        hi_i, lo_i = s, lo_i + e
        return hi_r, lo_r, hi_i, lo_i

    z = jnp.zeros((F, C, C), dtype=jnp.float32)
    hi_r, lo_r, hi_i, lo_i = jax.lax.fori_loop(0, g, body, (z, z, z, z))
    return jax.lax.complex(hi_r + lo_r, hi_i + lo_i)


def _split3(x, q=8):
    """Slice a float32 array into 3 scaled q-bit mantissa pieces along the
    last (contraction) axis: ``x = sigma * (s1 + s2 + s3)`` with `sigma` a
    per-row power of two, |s_k| <= 2^(-(k-1)q), and s1, s2 exactly
    representable with q mantissa bits (so their pairwise matmul products
    accumulate exactly in float32)."""
    m = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    # floor must be comfortably NORMAL in f32: XLA flushes subnormals to
    # zero, and exp2(ceil(log2(0))) would poison sigma
    sigma = jnp.exp2(jnp.ceil(jnp.log2(jnp.maximum(m, jnp.float32(1e-30)))))
    t = x / sigma
    p = jnp.float32(2.0**q)
    s1 = jnp.round(t * p) / p
    r = t - s1  # exact: s1 carries t's high bits
    s2 = jnp.round(r * p * p) / (p * p)
    s3 = r - s2  # exact
    return (s1, s2, s3), sigma


def _gemm_nt_compensated(A, B, q=8):
    """``A @ B^T`` (contraction over the last axis of both) to double-
    float32 accuracy: returns (hi, lo). Inputs are real float32 of shape
    ``(..., I, K)`` / ``(..., J, K)``; slice products carry 2q mantissa
    bits, so partial sums of up to ``2**(24-2q)`` terms accumulate exactly
    (q=8 -> K <= 256, q=7 -> K <= 1024)."""
    (a1, a2, a3), sa = _split3(A, q=q)
    (b1, b2, b3), sb = _split3(B, q=q)

    def mm(x, y):
        return jnp.einsum("...ik,...jk->...ij", x, y, precision=jax.lax.Precision.HIGHEST)

    # descending magnitude; the first four accumulate exactly, the s3 terms
    # carry ordinary f32 rounding on already-tiny quantities
    terms = (mm(a1, b1), mm(a1, b2), mm(a2, b1), mm(a2, b2),
             mm(a1, b3), mm(a3, b1), mm(a2, b3), mm(a3, b2), mm(a3, b3))
    hi = terms[0]
    lo = jnp.zeros_like(hi)
    for t in terms[1:]:
        hi, e = _two_sum(hi, t)
        lo = lo + e
    scale = sa * jnp.swapaxes(sb, -1, -2)  # power-of-two scales: exact
    return hi * scale, lo * scale


def _csd_residual_df32(Sr, Si, Pr, Pi):
    """``R = S - P @ P^H`` with the product carried in double-float32 so the
    cancellation is resolved far below float32 rounding. Inputs/outputs are
    the real/imag float32 parts; R itself is small and returned in f32."""
    hr1, lr1 = _gemm_nt_compensated(Pr, Pr)
    hr2, lr2 = _gemm_nt_compensated(Pi, Pi)
    hi1, li1 = _gemm_nt_compensated(Pi, Pr)
    hi2, li2 = _gemm_nt_compensated(Pr, Pi)
    t, e = _two_sum(Sr, -hr1)
    t, e2 = _two_sum(t, -hr2)
    Rr = t + (e + e2 - lr1 - lr2)
    t, e = _two_sum(Si, -hi1)
    t, e2 = _two_sum(t, hi2)
    Ri = t + (e + e2 - li1 + li2)
    return Rr, Ri


class _IdentityShard:
    """No-op layout hooks: single-device Wilson (the default)."""

    def freq(self, x):  # (F, N, N) sharded along the frequency axis
        return x

    def chan(self, x):  # (F, N, N) sharded along the channel-row axis
        return x


_SHARDED_WILSON_CACHE = {}


def wilson_env_fingerprint():
    """The Wilson env knobs read at TRACE time — any executable whose
    program embeds them (engine-compiled Granger, run_on_device closures)
    must include this in its cache key, or flipping a knob mid-process is
    silently ignored."""
    return (
        os.environ.get("SPY_TPU_WILSON_INV", "ns").lower(),
        os.environ.get("SPY_TPU_WILSON_GFORCE", "1"),
        os.environ.get("SPY_TPU_WILSON_PLUS", "auto").lower(),
        os.environ.get("SPY_TPU_FAST_REG", "auto").lower(),
    )


class _MeshShard:
    """GSPMD layout hooks for the mesh-sharded Wilson factorization.

    Per-frequency matrix work (cholesky/inv/GEMM) is embarrassingly
    parallel over frequency -> shard axis 0; the plus operator's lag
    transforms are FFTs ALONG frequency but independent per matrix entry
    -> shard axis 1. Alternating `with_sharding_constraint`s makes XLA
    insert the all-to-all transposes between the two layouts — the
    classic distributed-FFT layout swap, driven by annotation instead of
    hand-written collectives."""

    def __init__(self, mesh, axis_name):
        from jax.sharding import NamedSharding, PartitionSpec

        self._freq = NamedSharding(mesh, PartitionSpec(axis_name, None, None))
        self._chan = NamedSharding(mesh, PartitionSpec(None, axis_name, None))

    def freq(self, x):
        return jax.lax.with_sharding_constraint(x, self._freq)

    def chan(self, x):
        return jax.lax.with_sharding_constraint(x, self._chan)


def _ns_inverse_rounds(psi, X, bar, Ident, mask_res, n_rounds):
    """Adaptive warm-started Newton-Schulz inverse refresh.

    Each round is ``X <- X (2I - P)`` with ``P = psi X``, so the masked
    residual ``max|I - P|`` needed for the acceptance test is a free
    byproduct of the round itself (no extra GEMM, unlike the old
    separate ``_inv_residual`` pass). Rounds run as a fixed unroll with
    monotone-accept freeze semantics: a round is kept only while the
    residual still exceeds `bar` AND strictly improved — NS outside its
    convergence radius (res >= 1) diverges monotonically, and an
    overflow makes the residual NaN, which fails every subsequent
    comparison and freezes the state, so the caller's final acceptance
    test (NaN <= bar is False) deterministically takes the LU branch.
    The static op count keeps the enclosing ``lax.while_loop`` body
    shape-stable; a converged round wastes two (F, N, N) GEMMs, far
    cheaper than the batched LU each extra round avoids.
    """
    P = psi @ X
    res = mask_res(Ident - P)
    for _ in range(n_rounds):
        upd = jnp.logical_and(res > bar, jnp.isfinite(res))
        Xn = X @ (2 * Ident - P)
        Pn = psi @ Xn
        resn = mask_res(Ident - Pn)
        keep = jnp.logical_and(upd, resn < res)
        X = jnp.where(keep, Xn, X)
        P = jnp.where(keep, Pn, P)
        res = jnp.where(keep, resn, res)
    return X, res


def _wilson_refine(CSD, psi, psi0, X_seed, lu_floor_seed, valid_bin, M, rtol,
                   nRefine=10, shard=_IdentityShard()):
    """
    Mixed-precision Newton refinement of a float32 Wilson factorization,
    on the ONE-SIDED frequency half.

    Linearizing the Wilson update around ``g = I + E`` with
    ``E = psi^{-1} R psi^{-H}`` and ``R = CSD - psi psi^H`` gives

        psi  <- psi  + psi  @ (plus(E) + S(E_0/2))
        psi0 <- psi0 + psi0 @ (E_0/2   + S(E_0/2))

    i.e. every correction is linear in the residual. The residual is
    computed in compensated (double-float32) arithmetic and psi/psi0 are
    carried as double-float32 (hi, lo) pairs, so the factorization — and
    the truthfully reported error — reaches the reference rtol even where
    float32 storage of psi alone could not reconstruct small off-diagonal
    CSD entries to relative tolerance. Correction terms themselves only
    need float32: their errors are second-order in the residual.

    One-sided design: every quantity is conjugate-symmetric
    over frequency, so working on the F = M/2 + 1 non-negative bins
    halves the residual GEMMs, the plus transforms, and the df32 updates.
    The two-sided version needed an explicit (TwoSum-exact) conjugate
    symmetrization each step — "asymmetry injected by f32 FFT rounding
    stalls the iteration permanently"; in one-sided storage the ±f
    coupling is STRUCTURAL and the only residual degree of freedom is the
    imaginary part of the DC/Nyquist bins, projected to zero (a real-lag
    factor is real there; the projection is exact). The inverse is seeded
    from phase 1's Newton-Schulz state instead of a fresh batched LU,
    which was the most expensive op of the old two-sided refine stage.
    """
    Sr = jnp.real(CSD)
    Si = jnp.imag(CSD)
    absS = jnp.abs(CSD)
    F = CSD.shape[0]
    # DC and (even M) Nyquist bins of a real-lag factor are real
    real_bin = jnp.arange(F) == 0
    if M % 2 == 0:
        real_bin = jnp.logical_or(real_bin, jnp.arange(F) == F - 1)
    real_bin = real_bin[:, None, None]

    def project(ph, pl):
        """Zero Im at DC/Nyquist (exact — the one-sided equivalent of the
        two-sided conjugate symmetrization)."""
        ph = jnp.where(real_bin, jnp.real(ph).astype(ph.dtype), ph)
        pl = jnp.where(real_bin, jnp.real(pl).astype(pl.dtype), pl)
        return ph, pl

    def residual(ph, pl):
        Rr, Ri = _csd_residual_df32(Sr, Si, jnp.real(ph), jnp.imag(ph))
        R = (Rr + 1j * Ri).astype(CSD.dtype)
        # lo-part cross terms: ~2^-24 of |S|, plain f32 GEMM suffices
        phH = jnp.conj(jnp.swapaxes(ph, 1, 2))
        plH = jnp.conj(jnp.swapaxes(pl, 1, 2))
        R = R - ph @ plH - pl @ phH
        rel = jnp.abs(R) / absS
        err = jnp.max(jnp.where(valid_bin, rel, 0.0))
        # zero the residual at excluded (near-zero-power) bins: psi there is
        # ~sqrt(power) tiny, so psi^{-1} R psi^{-H} would amplify residual
        # noise into O(1) corrections that the plus operator smears across
        # ALL frequencies — silently steering the iteration off the
        # minimum-phase factor while the (masked) error still converges
        R = jnp.where(valid_bin, R, jnp.zeros((), R.dtype))
        return R, err

    def df_add(hi, lo, small):
        """double-float32 += small (TwoSum per real/imag component)."""
        s, e = _two_sum(jnp.real(hi), jnp.real(small))
        si, ei = _two_sum(jnp.imag(hi), jnp.imag(small))
        return s + 1j * si, lo + (e + 1j * ei)

    Ident = jnp.eye(CSD.shape[1], dtype=CSD.dtype)
    force_lu = os.environ.get("SPY_TPU_WILSON_INV", "ns").lower() == "lu"

    def _guard_X(X):
        # the inverse at excluded bins is never used (R is zeroed there),
        # but NS on a near-singular psi can overflow to Inf across steps
        # and Inf * 0 = NaN would poison E — pin those bins to I
        return jnp.where(valid_bin, X, Ident)

    def _mask_max(d):
        return jnp.max(jnp.where(valid_bin, jnp.abs(d), 0.0))

    def _inv_res(ph, X):
        return _mask_max(Ident - ph @ X)

    def _lu_with_floor(ph):
        Xl = _guard_X(jnp.linalg.inv(ph))
        return Xl, _inv_res(ph, Xl)

    def step(state):
        ph, pl, p0h, p0l, X, lu_floor, R, err, prev, it = state
        # warm-started adaptive Newton-Schulz inverse (pure GEMMs, no
        # batched LU): refine corrections are linear in the residual, so
        # ph moves by a near-identity factor per step and 1-2 effective
        # rounds suffice; exact fallback (NaN-safe predicate, floor-aware
        # bar as in phase 1) guards the drift case. Inverse error enters
        # E only at second order.
        if force_lu:
            X, lu_floor = _lu_with_floor(ph)
        else:
            bar = jnp.maximum(jnp.asarray(1e-6, jnp.float32), 4 * lu_floor)
            X, ns_res = _ns_inverse_rounds(
                ph, X, bar, Ident, lambda d: _mask_max(d), n_rounds=4)
            X = _guard_X(X)
            X, lu_floor = jax.lax.cond(
                ns_res <= bar, lambda: (X, lu_floor), lambda: _lu_with_floor(ph)
            )
        p_inv = X
        E = p_inv @ R @ jnp.conj(jnp.swapaxes(p_inv, 1, 2))
        pE, E0h = _plus_operator_onesided(shard.chan(E), M)
        pE = shard.freq(pE)
        S = jnp.triu(E0h)
        S = S - jnp.conj(S.T)
        ph_new, pl_new = df_add(ph, pl, ph @ (pE + S))
        ph_new, pl_new = project(ph_new, pl_new)
        p0h_new, p0l_new = df_add(p0h, p0l, p0h @ (E0h + S))
        R_new, err_new = residual(ph_new, pl_new)
        # safeguard: never accept a step that increases the true residual
        worse = err_new > err
        ph_new = jnp.where(worse, ph, ph_new)
        pl_new = jnp.where(worse, pl, pl_new)
        p0h_new = jnp.where(worse, p0h, p0h_new)
        p0l_new = jnp.where(worse, p0l, p0l_new)
        R_new = jnp.where(worse, R, R_new)
        err_new = jnp.minimum(err_new, err)
        return (ph_new, pl_new, p0h_new, p0l_new, X, lu_floor, R_new,
                err_new, err, it + 1)

    def cond(state):
        err, prev, it = state[7], state[8], state[9]
        progress = err < 0.7 * prev
        return jnp.logical_and(jnp.logical_and(err >= rtol, it < nRefine), progress)

    ph0, pl0 = project(psi, jnp.zeros_like(psi))
    zero0 = jnp.zeros_like(psi0)
    R0, err0 = residual(ph0, pl0)
    # seed the inverse from phase 1's NS state (it inverts the PREVIOUS
    # psi iterate — one polish round in the first step closes the gap);
    # a fresh LU here would serialize and is only needed if the seed
    # fails the acceptance bar, which the guarded cond handles
    X0 = _guard_X(X_seed)
    floor0 = jnp.maximum(lu_floor_seed, jnp.asarray(0.0, jnp.float32))
    init = (ph0, pl0, psi0, zero0, X0, floor0, R0, err0,
            jnp.asarray(jnp.inf, dtype=jnp.float32), jnp.asarray(0))
    ph, pl, p0h, p0l, _, _, _, err, _, _ = jax.lax.while_loop(cond, step, init)
    return ph, pl, p0h, p0l, err


# ------------------------------------------------------------------------ #
# Wilson spectral matrix factorization (reference wilson_sf.py:16-195)
# ------------------------------------------------------------------------ #


def _plus_operator(g):
    """The []+ operator via explicit Fourier transforms
    (reference wilson_sf.py:150-180)."""
    n_lag = g.shape[0] // 2
    beta = jnp.real(jnp.fft.ifft(g, axis=0)).astype(g.dtype)
    beta = beta.at[0].multiply(0.5)
    g0 = beta[0]
    beta = beta.at[n_lag].multiply(0.5)
    beta = beta.at[n_lag + 1 :].set(0.0)
    gp = jnp.fft.fft(beta, axis=0)
    return gp, g0


def _plus_operator_onesided(g, M):
    """[]+ on the ONE-SIDED frequency half of a conjugate-symmetric
    spectrum: every quantity in Wilson's iteration satisfies
    ``X(-f) = conj(X(f))`` entrywise (the two-sided implementation already
    exploits this via ``real(ifft(.))``), so the lag sequence is real and
    the transforms collapse to irfft/rfft over ``M = 2F - 2`` points —
    half the FFT and downstream matrix work per iteration.

    The operator is a fixed R-linear map over (Re g, Im g), so it also
    collapses to four (F, F) x (F, N^2) GEMMs
    (:func:`_plus_operator_onesided_gemm`), which ``SPY_TPU_WILSON_PLUS=
    gemm`` selects. The transforms are the default: on an NVIDIA H100
    (700 W) Granger at 128 channels x 501 bins runs 0.404 s with them vs
    0.486 s with the GEMM form, end to end (benchmarks/branch_ab.py).

    Parameters
    ----------
    g : (F, N, N) complex — non-negative-frequency half
    M : int — full two-sided length (2F - 2)
    """
    if os.environ.get("SPY_TPU_WILSON_PLUS", "auto").lower() == "gemm":
        return _plus_operator_onesided_gemm(g, M)
    rdtype = jnp.float64 if g.dtype == jnp.complex128 else jnp.float32
    beta = jnp.fft.irfft(g, n=M, axis=0).astype(rdtype)
    beta = beta.at[0].multiply(0.5)
    g0 = beta[0].astype(g.dtype)
    beta = beta.at[M // 2].multiply(0.5)
    beta = beta.at[M // 2 + 1 :].set(0.0)
    gp = jnp.fft.rfft(beta, axis=0).astype(g.dtype)
    return gp, g0


@functools.lru_cache(maxsize=8)
def _plus_gemm_consts(F, M, f64=False):
    """Host-precomputed matrices of the one-sided []+ operator as an
    R-linear map: ``gp = (Br + i Bi) @ Re g + (Cr + i Ci) @ Im g`` and
    ``g0 = r0 @ Re g``. Built from the irfft/weight/rfft composition in
    float64, cast to the working precision."""
    n = np.arange(M // 2 + 1)[:, None]  # only lags 0..M/2 survive the window
    k = np.arange(F)[None, :]
    c = np.full(F, 2.0)
    c[0] = 1.0
    c[F - 1] = 1.0 if M % 2 == 0 else 2.0  # Nyquist bin counted once
    ang = 2 * np.pi * n * k / M
    Ar = c * np.cos(ang) / M  # beta from Re g
    Ai = -c * np.sin(ang) / M  # beta from Im g (zero cols at k=0, M/2)
    w = np.ones(M // 2 + 1)
    w[0] = 0.5
    w[M // 2] = 0.5
    Rf = np.exp(-2j * np.pi * np.arange(F)[:, None] * n.T / M)  # (F, M/2+1)
    Bc = Rf @ (w[:, None] * Ar)
    Cc = Rf @ (w[:, None] * Ai)
    r0 = 0.5 * Ar[0]  # beta[0] *= 0.5 precedes the g0 extraction
    dt = np.float64 if f64 else np.float32
    return (Bc.real.astype(dt), Bc.imag.astype(dt),
            Cc.real.astype(dt), Cc.imag.astype(dt), r0.astype(dt))


def _plus_operator_onesided_gemm(g, M):
    """One-sided []+ as four (F, F) x (F, N^2) real GEMMs in place of the
    two platform FFTs. It differs from the FFT form only by accumulation
    order (~1e-6 relative at F=501/f32)."""
    F = g.shape[0]
    f64 = g.dtype == jnp.complex128
    Br, Bi, Cr, Ci, r0 = _plus_gemm_consts(int(F), int(M), f64)
    sh = g.shape
    gr = jnp.real(g).reshape(F, -1)
    gi = jnp.imag(g).reshape(F, -1)
    pr = Br @ gr + Cr @ gi
    pi = Bi @ gr + Ci @ gi
    gp = (pr + 1j * pi).reshape(sh).astype(g.dtype)
    g0 = (r0 @ gr).reshape(sh[1:]).astype(g.dtype)
    return gp, g0


def wilson_sf(CSD, nIter=100, rtol=1e-6):
    """
    Wilson's analytic spectral matrix factorization
    ``CSD = psi @ psi^H`` returning the transfer function and noise
    covariance (reference wilson_sf.py:16-128). The per-frequency matrix
    operations run batched over the (two-sided) frequency axis; the
    iteration is a `lax.while_loop` with relative-error convergence check.

    Parameters
    ----------
    CSD : (nFreq, N, N) complex array (one-sided spectra)

    Returns
    -------
    Hfunc : (nFreq, N, N) transfer functions
    Sigma : (N, N) noise covariance
    converged : bool array (scalar)
    err : final max relative factorization error
    """
    with jax.default_matmul_precision("highest"):
        return _wilson_sf_impl(CSD, nIter, rtol)


def wilson_sf_sharded(CSD, mesh=None, axis_name=None, nIter=100, rtol=1e-6):
    """
    Mesh-sharded Wilson factorization for channel counts whose workspace
    exceeds one chip's HBM.

    At 1024 channels a single (F, N, N) complex64 buffer is ~4.2 GB for a
    1-second/1-kHz CSD and the iteration keeps >=4 such buffers live
    (the reference's wilson_sf.py:16-128 runs on one dask worker and
    hits the same wall in host RAM). Sharding: the
    per-frequency cholesky/inv/GEMM batch is split over the mesh along
    frequency; the plus operator's lag-domain FFTs run split along the
    channel-row axis; `with_sharding_constraint` alternates the two
    layouts and GSPMD inserts the all-to-all transposes. Per-
    device memory falls by ~the mesh size; results match :func:`wilson_sf`
    up to float accumulation order.

    Parameters
    ----------
    CSD : (nFreq, N, N) complex array (one-sided spectra)
    mesh : jax.sharding.Mesh, default: the package's active mesh
    axis_name : str, default: the mesh's first axis

    Returns
    -------
    Same as :func:`wilson_sf`.
    """
    if mesh is None:
        from ..parallel.mesh import active_mesh

        mesh = active_mesh()
        if mesh is None:
            raise ValueError("no mesh given and no active mesh — use spy.use_mesh")
    if axis_name is None:
        axis_name = mesh.axis_names[0]
    CSD = jnp.asarray(CSD)
    # cache the jitted program: a fresh jax.jit(lambda) per call would
    # re-trace and re-lower the full while-loop program every invocation
    # (expensive host-side at 1024 ch even with the persistent compile
    # cache absorbing the compile)
    key = (CSD.shape, str(CSD.dtype), mesh, axis_name, int(nIter),
           float(rtol), wilson_env_fingerprint())
    prog = _SHARDED_WILSON_CACHE.get(key)
    if prog is None:
        shard = _MeshShard(mesh, axis_name)

        def _run(S):
            # constraints live INSIDE jit only: GSPMD pads non-divisible
            # dims transparently there, while explicit placement would
            # reject e.g. F=501 on an 8-way axis
            return _wilson_sf_impl(S, nIter, rtol, shard=shard)

        prog = jax.jit(_run)
        _SHARDED_WILSON_CACHE[key] = prog
    with jax.default_matmul_precision("highest"):
        return prog(CSD)


def granger_sharded(CSD, mesh=None, axis_name=None, rtol=5e-6, nIter=100, cond_max=1e4):
    """
    Granger-Geweke causality from a trial-averaged CSD too wide for one
    chip: condition-number regularization + :func:`wilson_sf_sharded` +
    :func:`granger` (the mesh analog of the GrangerCausality routine,
    reference AV_compRoutines.py:292-484).

    Returns (G, info_dict) where info mirrors the frontend's ``out.info``
    convergence diagnostics.
    """
    CSDreg, factor, ini_cn = regularize_csd(jnp.asarray(CSD), cond_max=cond_max, eps_max=1e-1)
    H, Sigma, conv, err = wilson_sf_sharded(
        CSDreg, mesh=mesh, axis_name=axis_name, nIter=nIter, rtol=rtol
    )
    G = granger(CSDreg, H, Sigma)
    info = {
        "converged": bool(conv),
        "max rel. err": float(err),
        "reg. factor": float(factor),
        "initial cond. num": float(ini_cn),
    }
    return G, info


def _wilson_sf_impl(CSD, nIter, rtol, shard=_IdentityShard()):
    # reduced-precision matmuls (TF32 on a GPU) make the iteration
    # diverge — wilson_sf wraps this in default_matmul_precision("highest")
    cdtype = CSD.dtype
    rdtype = jnp.float64 if cdtype == jnp.complex128 else jnp.float32
    nFreq = CSD.shape[0]
    N = CSD.shape[1]
    Ident = jnp.eye(N, dtype=cdtype)

    # scale to unit mean auto-power: improves float32 conditioning; H is
    # scale-invariant and Sigma is rescaled at the end. Hermitize to remove
    # float rounding asymmetry from the upstream accumulation.
    CSD = shard.freq(CSD)
    CSD = (CSD + jnp.conj(jnp.swapaxes(CSD, 1, 2))) / 2
    scale = jnp.mean(jnp.abs(jnp.diagonal(CSD, axis1=1, axis2=2))).astype(rdtype)
    CSD = CSD / scale

    # attach negative frequencies (init + refine work on the full circle;
    # the ITERATION below runs on the one-sided half — every quantity is
    # conjugate-symmetric over frequency, see _plus_operator_onesided)
    CSDfull = jnp.concatenate([CSD, jnp.conj(CSD[nFreq - 2 : 0 : -1])], axis=0)
    M = CSDfull.shape[0]

    # bins with negligible power (e.g. the demeaned DC bin is pure float
    # noise) cannot be factorized to relative tolerance and are excluded
    # from the convergence metric
    diag_power = jnp.mean(jnp.abs(jnp.diagonal(CSD, axis1=1, axis2=2)), axis=1)
    valid_bin = (diag_power > 1e-9 * jnp.max(diag_power))[:, None, None]

    # g-forcing at excluded bins (float32 device path, default on): a
    # zero-power bin's Wilson update factor has the exact fixed-point value
    # g + I = 2I (psi psi^H = CSD holds trivially as power -> 0), but
    # COMPUTING it means Cholesky-factorizing a near-zero CSD and inverting
    # a near-singular psi — numerical garbage the plus operator's
    # frequency-axis FFT smears into every valid bin. It also pins the NS
    # acceptance residual at ~2^-8 forever, forcing the LU fallback every
    # iteration (traced at 64 AND 128 ch on the demeaned-DC CSD).
    # Substituting the exact limit removes the garbage source and lets NS
    # engage. Measured valid-bin effect (f64 A/B, 64 ch, demeaned DC):
    # <= 8e-3 absolute on the DC-adjacent bin, ~2e-4 in the bulk — 4x below
    # 1000-trial estimator noise, and only on bins whose plain values
    # depend on accumulation-rounding noise anyway. complex128 keeps the
    # plain iteration (reference-oracle parity stays exact).
    g_force = cdtype == jnp.complex64 and os.environ.get(
        "SPY_TPU_WILSON_GFORCE", "1") != "0"

    # initialization: cholesky of the zero-lag covariance (wilson_sf.py:131-148)
    gamma0 = jnp.fft.fft(CSDfull, axis=0)[0]
    gamma0 = jnp.real((gamma0 + jnp.conj(gamma0.T)) / 2).astype(rdtype)
    psi0_init = jnp.linalg.cholesky(gamma0).T.astype(cdtype)
    psi_init = jnp.tile(psi0_init, (nFreq, 1, 1))

    U = jnp.linalg.cholesky(CSD)

    # NS acceptance bar: LU-quality or fall back. The fixed part is near
    # machine precision (f64 has no refine stage and is oracle-compared
    # at ~1e-7); the adaptive part tracks the LU inverse's OWN residual
    # floor (~eps*cond(psi)) measured at each fallback, so ill-conditioned
    # inputs — where no inverse can beat that floor — don't degenerate
    # into paying NS + LU every iteration.
    ns_thresh = 1e-6 if cdtype == jnp.complex64 else 1e-12
    # benchmarking/debug escape: SPY_TPU_WILSON_INV=lu forces the exact-LU
    # inverse every iteration (the pre-Newton-Schulz behavior); default "ns"
    force_lu = os.environ.get("SPY_TPU_WILSON_INV", "ns").lower() == "lu"

    def _mask_max(d):
        # with g-forcing the inverse at excluded bins is never used — keep
        # their (garbage) residuals out of the acceptance metric and the LU
        # floor, or they poison the bar for every valid bin. NaN at a VALID
        # bin still fails the <= bar (NaN-safe).
        res = jnp.abs(d)
        if g_force:
            res = jnp.where(valid_bin, res, 0.0)
        return jnp.max(res).astype(rdtype)

    def _inv_residual(psi, X):
        return _mask_max(Ident - psi @ X)

    def _lu_with_floor(psi):
        Xl = jnp.linalg.inv(psi)
        return Xl, _inv_residual(psi, Xl)

    def step(state):
        psi, psi0, X, lu_floor, err, prev_err, best_err, it = state
        # warm-started Newton-Schulz inverse; exact LU fallback while psi
        # still moves by O(1) factors (early iterations). The acceptance
        # bar is strict — within 4x of the LU residual floor: an inverse
        # residual of even ~1e-3 sustained over the early iterations
        # smears through the plus operator across every frequency and
        # steers the iteration off the minimum-phase factor by ~res/10 —
        # an error the reconstruction metric cannot see and the Newton
        # refinement cannot repair (measured: 4e-3 residuals -> 3e-5
        # Granger bias). With g-forcing the residual is measured over
        # valid bins only (excluded bins' inverses are never used);
        # without it, over ALL bins — their garbage smears too. The
        # predicate is written NaN-safe: an NS overflow (Inf -> NaN
        # residual) must take the LU branch.
        if force_lu:
            X, lu_floor = _lu_with_floor(psi)
        else:
            bar = jnp.maximum(jnp.asarray(ns_thresh, rdtype), 4 * lu_floor)
            X, ns_res = _ns_inverse_rounds(psi, X, bar, Ident, _mask_max,
                                           n_rounds=6)
            X, lu_floor = jax.lax.cond(
                ns_res <= bar,
                lambda: (X, lu_floor),
                lambda: _lu_with_floor(psi),
            )
        g = X @ U
        g = g @ jnp.conj(jnp.swapaxes(g, 1, 2))
        gI = g + Ident
        if g_force:
            gI = jnp.where(valid_bin, gI, 2 * Ident)
        gplus, gplus_0 = _plus_operator_onesided(shard.chan(gI), M)
        gplus = shard.freq(gplus)
        S = jnp.triu(gplus_0)
        S = S - jnp.conj(S.T)
        psi_new = psi @ (gplus + S)
        psi0_new = psi0 @ (gplus_0 + S)
        CSDfac = psi_new @ jnp.conj(jnp.swapaxes(psi_new, 1, 2))
        rel = jnp.abs(CSD - CSDfac) / jnp.abs(CSD)
        new_err = jnp.max(jnp.where(valid_bin, rel, 0.0))
        return (psi_new, psi0_new, X, lu_floor, new_err.astype(rdtype), err,
                jnp.minimum(best_err, new_err.astype(rdtype)), it + 1)

    # in float32 the multiplicative iteration's error measure floors around
    # eps*cond — stop it early and hand over to the compensated-residual
    # Newton refinement, which drives (and truthfully measures) the error
    # down to the float32-representable optimum
    refine = cdtype == jnp.complex64
    rtol_phase1 = jnp.maximum(jnp.asarray(rtol, rdtype), 1e-3) if refine else rtol

    def cond(state):
        err, prev_err, best_err, it = state[4], state[5], state[6], state[7]
        # fixed-point exit: only once the fit is already tight (err < 1e-2)
        # and progress has stopped — Wilson's error is non-monotonic early on
        plateau = jnp.logical_and(err < 1e-2, prev_err - err < 1e-4 * err)
        # blow-up exit: once the error has regressed 100x above the best
        # seen (absolute thresholds are unusable: the initial error is huge
        # — ~1e6 at 128 ch — and decays through 1e4 during LEGITIMATE
        # convergence; the two-orders bar also rides out the early
        # non-monotonic bounces), the iteration never recovers — stop
        # burning O(N^3) GEMMs and let the caller's converged=False
        # handling (frontend host-f64 fallback) take over
        blown = jnp.logical_and(err > 100 * best_err, it > 5)
        keep = jnp.logical_and(err >= rtol_phase1, it < nIter)
        return jnp.logical_and(keep, jnp.logical_not(jnp.logical_or(plateau, blown)))

    # the initial inverse is exact and cheap: psi_init is the zero-lag
    # Cholesky factor tiled over frequency, one (N, N) triangular inverse
    X_init = jnp.tile(jnp.linalg.inv(psi0_init), (nFreq, 1, 1))
    floor_init = jnp.max(jnp.abs(Ident - psi_init @ X_init)).astype(rdtype)
    init = (
        psi_init, psi0_init, X_init, floor_init,
        jnp.asarray(jnp.inf, dtype=rdtype),
        jnp.asarray(jnp.inf, dtype=rdtype),
        jnp.asarray(jnp.inf, dtype=rdtype), jnp.asarray(0),
    )
    psi, psi0, X_fin, floor_fin, err, _, _, _ = jax.lax.while_loop(cond, step, init)

    if refine:
        # one-sided compensated-residual Newton refinement, inverse seeded
        # from phase 1's Newton-Schulz state (no fresh batched LU)
        ph, pl, p0h, p0l, err = _wilson_refine(
            CSD, psi, psi0, X_fin, floor_fin.astype(jnp.float32),
            valid_bin, M, rtol, shard=shard
        )
        psi = ph + pl  # rounds to the best float32 representation
        psi0 = p0h + p0l

    Sigma = (psi0 @ psi0.T) * scale
    Hfunc = psi @ jnp.linalg.inv(psi0)
    return Hfunc, Sigma, err < rtol, err


_FAST_REG_MIN_CHAN = 96


def _fast_reg_enabled(n_chan):
    """Use the extents-only regularization (`csd_lam_extents`) instead of
    the full eigendecomposition? Shape-static, so jit-safe. The batched
    eigvalsh grows steeply with the channel count, while the
    Cholesky-bisection cost grows only with the batched-Cholesky rate;
    the 96-channel cut-over is not yet measured on the GPU.
    SPY_TPU_FAST_REG: "0" never, "1" always, default auto (>= 96
    channels)."""
    mode = os.environ.get("SPY_TPU_FAST_REG", "auto").lower()
    if mode == "0":
        return False
    if mode == "1":
        return True
    return n_chan >= _FAST_REG_MIN_CHAN


def csd_lam_extents(CSDh, bisect_rounds=30):
    """
    Per-frequency EXTREME eigenvalues of a batch of Hermitian matrices
    without an eigendecomposition — the regularization selection
    (:func:`csd_reg_params`) only ever consumes lambda_min / lambda_max,
    and a batched eigvalsh that provides them grows steeply with the
    channel count.

    Vectorized Cholesky bisection, both ends at once: ``lam_min(A) > t``
    iff ``A - t*I`` admits a Cholesky factor (NaN-free on this backend),
    and ``lam_max(A) < t`` iff ``t*I - A`` does — so each round is ONE
    batched (2F, N, N) Cholesky with per-frequency shifts, starting from
    the Gershgorin brackets ``[min_i(a_ii - r_i), min_i a_ii]`` and
    ``[max_i a_ii, max_i(a_ii + r_i)]``. After `bisect_rounds` halvings
    the bracket width is ``2^-30`` of the Gershgorin span — below float32
    resolution of the matrix itself. (A Rayleigh-quotient power iteration
    was measured 2.2 % off lam_max on Wishart-like CSD spectra — the top
    cluster is too flat — so both ends use the certified bisection.)

    Returns ``(lo, hi, lam_max)`` with ``lo <= lam_min <= hi`` per
    frequency — callers that must never under-estimate a repair shift use
    `lo`; condition-number estimates use the midpoints.
    """
    rdtype = jnp.float64 if CSDh.dtype == jnp.complex128 else jnp.float32
    N = CSDh.shape[-1]
    I = jnp.eye(N, dtype=CSDh.dtype)
    diag = jnp.real(jnp.diagonal(CSDh, axis1=-2, axis2=-1)).astype(rdtype)
    radius = jnp.sum(jnp.abs(CSDh), axis=-1).astype(rdtype) - jnp.abs(diag)
    lo = jnp.min(diag - radius, axis=-1)   # (F,) Gershgorin: <= lam_min
    hi = jnp.min(diag, axis=-1)            # (F,) min diagonal: >= lam_min
    lo_mx = jnp.max(diag, axis=-1)         # (F,) max diagonal: <= lam_max
    hi_mx = jnp.max(diag + radius, axis=-1)  # (F,) Gershgorin: >= lam_max

    def bisect(carry, _):
        lo, hi, lo_mx, hi_mx = carry
        mid = 0.5 * (lo + hi)
        mid_mx = 0.5 * (lo_mx + hi_mx)
        probe = jnp.concatenate(
            [CSDh - mid[:, None, None] * I,
             mid_mx[:, None, None] * I - CSDh], axis=0)
        L = jnp.linalg.cholesky(probe)
        pd = jnp.isfinite(jnp.real(L)).all(axis=(-2, -1))
        pd_mn, pd_mx = pd[: CSDh.shape[0]], pd[CSDh.shape[0]:]
        return (jnp.where(pd_mn, mid, lo), jnp.where(pd_mn, hi, mid),
                jnp.where(pd_mx, lo_mx, mid_mx),
                jnp.where(pd_mx, mid_mx, hi_mx)), None

    (lo, hi, lo_mx, hi_mx), _ = jax.lax.scan(
        bisect, (lo, hi, lo_mx, hi_mx), None, length=bisect_rounds)
    return lo, hi, 0.5 * (lo_mx + hi_mx)


def csd_reg_params(CSD, cond_max=1e3, eps_max=1e-3, nSteps=15):
    """
    Regularization parameters for :func:`regularize_csd`, computed from a
    batched Hermitian eigendecomposition of `CSD` (or, from 96 channels,
    Cholesky-bisection extents, :func:`csd_lam_extents`). Split out so callers with MANY spectrally-adjacent matrices (jackknife
    leave-one-out replicates differ by O(1/nTrials)) can compute the
    parameters ONCE from their mean and share them (see
    GrangerCausality.process_batch + :func:`psd_topup`).

    Returns (psd_shift (F,), eps scalar [-1 marks failure], ini_cond).
    """
    rdtype = jnp.float64 if CSD.dtype == jnp.complex128 else jnp.float32
    epsilons = jnp.concatenate(
        [jnp.zeros(1, rdtype), jnp.asarray(np.logspace(-10, np.log10(eps_max), nSteps), dtype=rdtype)]
    )
    # the CSD is Hermitian, so cond_2(CSD + eps*I) follows analytically from
    # the eigenvalue EXTREMES: the shifted eigenvalues are lambda_i + eps.
    # This replaces the reference's per-candidate SVD sweep (wilson_sf.py:
    # 197-262) — same selection, one spectral sweep instead of
    # nSteps*nFreq SVDs.
    CSDh = (CSD + jnp.conj(jnp.swapaxes(CSD, -1, -2))) / 2
    if _fast_reg_enabled(CSD.shape[-1]):
        # wide channels: lambda extents via Cholesky bisection + power
        # iteration (the full batched eigvalsh is 1.75 s at (501,128,128) —
        # 73 % of the whole factorization wall). The selection below only
        # needs (lam_min, lam_max) per frequency.
        lam_lo, lam_hi, lam_max_f = csd_lam_extents(CSDh)
        lam_mid = 0.5 * (lam_lo + lam_hi)
        bin_scale = jnp.maximum(jnp.abs(lam_mid), lam_max_f)  # max |lam|
        # min |lam| per frequency: equals lam_min on the PSD bulk; for an
        # indefinite bin |lam_min| still carries its magnitude scale (the
        # value is a diagnostic, not part of the selection)
        raw_min = jnp.maximum(jnp.abs(lam_mid), jnp.finfo(rdtype).tiny)
        ini_cond_raw = (bin_scale / raw_min).max()
        lam_floor = 1e-6 * bin_scale
        # PSD repair (rationale below) from the bracket's LOWER edge: the
        # shift errs on the over-lift side by at most the bracket width
        psd_shift = jnp.maximum(lam_floor - lam_lo, jnp.zeros((), rdtype))
        psd_shift = jnp.where(lam_lo < lam_floor, psd_shift,
                              jnp.zeros((), rdtype))
        smin = jnp.abs(lam_mid + psd_shift)  # >= ~lam_floor by construction
        smax = lam_max_f + psd_shift
        shifted_min = smin[None] + epsilons[:, None]  # (E+1, F)
        shifted_max = smax[None] + epsilons[:, None]
        conds = (shifted_max / shifted_min).max(axis=1)  # (E+1,)
    else:
        lam = jnp.linalg.eigvalsh(CSDh).astype(rdtype)  # (F, N)
        # PSD repair: a trial sum accumulated sequentially in f32 can
        # leave a many-trial CSD with tiny NEGATIVE (or
        # near-singular) smallest eigenvalues (measured ~3e-5 relative at
        # 1000 trials). An indefinite matrix has no Wilson factorization
        # and a near-singular one breaks the float32 iteration — lift each
        # offending frequency's spectrum to a small floor relative to its
        # own diagonal power; healthy bins are untouched.
        # diagnostics must reflect the matrix as RECEIVED: record the
        # initial condition number before any repair
        raw_abs = jnp.abs(lam)
        ini_cond_raw = (raw_abs.max(axis=1) / raw_abs.min(axis=1)).max()
        lam_min = lam.min(axis=1)  # (F,)
        bin_scale = raw_abs.max(axis=1)  # (F,)
        lam_floor = 1e-6 * bin_scale
        psd_shift = jnp.maximum(lam_floor - lam_min, jnp.zeros((), rdtype))
        psd_shift = jnp.where(lam_min < lam_floor, psd_shift,
                              jnp.zeros((), rdtype))
        lam = lam + psd_shift[:, None]
        shifted = jnp.abs(lam[None] + epsilons[:, None, None])  # (E+1, F, N)
        conds = (shifted.max(axis=2) / shifted.min(axis=2)).max(axis=1)
    ok = conds < cond_max
    any_ok = jnp.any(ok)
    first_ok = jnp.argmax(ok)  # smallest epsilon that works (ordered ascending)
    chosen = jnp.where(any_ok, first_ok, len(epsilons) - 1)
    eps_sel = epsilons[chosen]
    eps = jnp.where(any_ok, eps_sel, -1.0)
    return psd_shift, eps, ini_cond_raw


def apply_csd_reg(CSD, psd_shift, eps, eps_max=1e-3):
    """Apply precomputed regularization: per-frequency PSD-repair shift
    plus the global eps loading (``eps = -1`` applies `eps_max`, the
    largest candidate — :func:`regularize_csd`'s failure behavior)."""
    I = jnp.eye(CSD.shape[1], dtype=CSD.dtype)
    eps_eff = jnp.where(eps < 0, jnp.asarray(eps_max, eps.dtype), eps)
    return CSD + (psd_shift[:, None, None] + eps_eff) * I


def psd_topup(CSDreg, rel_lift=3e-6, max_rounds=3):
    """Cheap per-matrix safety net for SHARED regularization parameters:
    probe positive-definiteness with one batched Cholesky (~8 ms at
    (501, 128, 128) vs 1.75 s for eigvalsh) and lift only the failing
    frequency bins by ``rel_lift`` of their own diagonal power, up to
    `max_rounds` doublings. Used when jackknife replicates reuse the
    mean-CSD regularization: an individual replicate's lambda_min can sit
    O(1/nTrials) below the mean's, so its shared shift may under-lift."""
    diag = jnp.abs(jnp.diagonal(CSDreg, axis1=-2, axis2=-1)).mean(axis=-1)
    I = jnp.eye(CSDreg.shape[-1], dtype=CSDreg.dtype)
    lift = rel_lift * diag
    for _ in range(max_rounds):
        L = jnp.linalg.cholesky(CSDreg)
        bad = ~jnp.isfinite(L).all(axis=(-2, -1))
        bad = bad[..., None, None]
        CSDreg = jnp.where(bad, CSDreg + lift[..., None, None] * I, CSDreg)
        lift = 2 * lift
    return CSDreg


def regularize_csd(CSD, cond_max=1e3, eps_max=1e-3, nSteps=15):
    """
    Condition-number loading: add the smallest ``eps*I`` (log-spaced up to
    `eps_max`) that brings the worst per-frequency condition number below
    `cond_max` (reference wilson_sf.py:197-262). All candidates are
    evaluated batched; the selection is an argmax over a boolean mask.

    Returns (CSDreg, eps, initial_cond_num); ``eps = -1`` marks failure.
    """
    psd_shift, eps, ini_cond = csd_reg_params(CSD, cond_max, eps_max, nSteps)
    CSDreg = apply_csd_reg(CSD, psd_shift, eps, eps_max=eps_max)
    return CSDreg, eps, ini_cond


def wilson_sf_host(CSD, nIter=100, rtol=1e-6, g_force=False):
    """
    Host-side float64 Wilson factorization — same algorithm as
    :func:`wilson_sf`, in numpy. Used when the float32 device
    factorization cannot converge, and as the tests' float64 oracle.
    `g_force` substitutes the exact fixed-point update ``g + I = 2I`` at
    near-zero-power bins, as the float32 device path does (see
    :func:`_wilson_sf_impl`); off by default (the reference iteration).
    """
    CSD = np.asarray(CSD, dtype=np.complex128)
    CSD = (CSD + np.conj(np.swapaxes(CSD, 1, 2))) / 2
    nFreq, N = CSD.shape[0], CSD.shape[1]
    Ident = np.eye(N)

    scale = np.mean(np.abs(np.einsum("fii->fi", CSD)))
    CSD = CSD / scale
    CSDfull = np.concatenate([CSD, np.conj(CSD[nFreq - 2 : 0 : -1])], axis=0)

    diag_power = np.mean(np.abs(np.einsum("fii->fi", CSDfull)), axis=1)
    valid_bin = (diag_power > 1e-9 * diag_power.max())[:, None, None]

    gamma0 = np.fft.fft(CSDfull, axis=0)[0]
    gamma0 = np.real((gamma0 + np.conj(gamma0.T)) / 2)
    psi0 = np.linalg.cholesky(gamma0).T
    psi = np.tile(psi0, (CSDfull.shape[0], 1, 1)).astype(np.complex128)
    psi0 = psi0.astype(np.complex128)

    U = np.linalg.cholesky(CSDfull)
    err = np.inf
    converged = False
    n_lag = CSDfull.shape[0] // 2
    prev_err = np.inf
    for _ in range(nIter):
        g = np.linalg.inv(psi) @ U  # inv+GEMM beats batched LU-solve (measured)
        g = g @ np.conj(np.swapaxes(g, 1, 2)) + Ident
        if g_force:
            g = np.where(valid_bin, g, 2 * Ident)
        beta = np.real(np.fft.ifft(g, axis=0)).astype(np.complex128)
        beta[0] *= 0.5
        g0 = beta[0].copy()
        beta[n_lag] *= 0.5
        beta[n_lag + 1 :] = 0
        gplus = np.fft.fft(beta, axis=0)
        S = np.triu(g0)
        S = S - np.conj(S.T)
        psi = psi @ (gplus + S)
        psi0 = psi0 @ (g0 + S)
        CSDfac = psi @ np.conj(np.swapaxes(psi, 1, 2))
        rel = np.abs(CSDfull - CSDfac) / np.abs(CSDfull)
        err = float(np.max(np.where(valid_bin, rel, 0.0)))
        if err < rtol:
            converged = True
            break
        if err < 1e-2 and prev_err - err < 1e-4 * err:
            # fixed point above tolerance (typically a low-power bin whose
            # RELATIVE error floors while the absolute fit is tight) — no
            # further progress possible
            break
        prev_err = err

    Sigma = (psi0 @ psi0.T) * scale
    Hfunc = psi @ np.linalg.inv(psi0)
    return Hfunc[:nFreq], Sigma, converged, err


def regularize_csd_host(CSD, cond_max=1e3, eps_max=1e-3, nSteps=15):
    """Host-side counterpart of :func:`regularize_csd` (incl. PSD repair of
    float32-accumulated trial sums)."""
    CSD = np.asarray(CSD, dtype=np.complex128)
    I = np.eye(CSD.shape[1])
    CSDh = (CSD + np.conj(np.swapaxes(CSD, 1, 2))) / 2
    lam = np.linalg.eigvalsh(CSDh)
    lam_min = lam.min(axis=1)
    lam_floor = 1e-6 * np.abs(lam).max(axis=1)
    psd_shift = np.where(lam_min < lam_floor, lam_floor - lam_min, 0.0)
    CSD = CSD + psd_shift[:, None, None] * I
    ini = float(np.linalg.cond(CSD).max())
    if ini < cond_max:
        return CSD, 0.0, ini
    for eps in np.logspace(-10, np.log10(eps_max), nSteps):
        CSDreg = CSD + eps * I
        if float(np.linalg.cond(CSDreg).max()) < cond_max:
            return CSDreg, float(eps), ini
    return CSDreg, -1.0, ini


def granger(CSD, Hfunc, Sigma):
    """
    Pairwise Granger-Geweke causality, Eq. 8 of Dhamala et al. 2008
    (reference granger.py:10-80). ``Granger[:, i, j]`` is causality i -> j.

    Near-zero-power bins (e.g. the demeaned DC bin) are returned as 0: no
    causality is measurable there, and the log ratio would be the noise of
    a noise estimate (the reference propagates it as garbage/NaN). Bins
    with genuine power are untouched.
    """
    nChannels = CSD.shape[1]
    auto_spectra = jnp.abs(jnp.diagonal(CSD, axis1=1, axis2=2))  # (F, N)
    Smat = auto_spectra[:, None, :] * jnp.ones((nChannels, 1), dtype=auto_spectra.dtype)
    Hmat = jnp.abs(jnp.swapaxes(Hfunc, 1, 2)) ** 2
    SigmaJI = jnp.abs(Sigma.T)
    auto_cov = jnp.abs(jnp.diagonal(Sigma))
    SigmaII = auto_cov[None, :] * jnp.ones((nChannels, 1), dtype=auto_cov.dtype)
    denom = SigmaII.T - SigmaJI**2 / SigmaII
    denom = Smat - denom * Hmat
    G = jnp.log(Smat / denom)
    dpow = jnp.mean(auto_spectra, axis=1)
    valid = dpow > 1e-9 * jnp.max(dpow)
    return jnp.where(valid[:, None, None], G, jnp.zeros((), G.dtype))


def granger_host(CSD, Hfunc, Sigma):
    """Host-side float64 counterpart of :func:`granger` (same Eq. 8,
    same zero-power-bin zeroing)."""
    CSD, Hfunc, Sigma = (np.asarray(a) for a in (CSD, Hfunc, Sigma))
    nChannels = CSD.shape[1]
    auto_spectra = np.abs(np.einsum("fii->fi", CSD))
    Smat = auto_spectra[:, None, :] * np.ones((nChannels, 1))
    Hmat = np.abs(np.swapaxes(Hfunc, 1, 2)) ** 2
    SigmaJI = np.abs(Sigma.T)
    auto_cov = np.abs(np.diag(Sigma))
    SigmaII = auto_cov[None, :] * np.ones((nChannels, 1))
    denom = SigmaII.T - SigmaJI**2 / SigmaII
    denom = Smat - denom * Hmat
    dpow = auto_spectra.mean(axis=1)
    valid = dpow > 1e-9 * dpow.max()
    # mask excluded bins BEFORE the log so only genuine-power bins can
    # still raise the divide/log warnings (a valid bin with denom <= 0 is
    # a real problem the user should see)
    ratio = np.where(valid[:, None, None], Smat / np.where(
        valid[:, None, None], denom, 1.0), 1.0)
    return np.log(ratio)


def ppc_from_spectra(cs_stack):
    """
    Pairwise phase consistency from the single-trial cross-spectral stack
    (Vinck 2010, Eq. 14). Uses the O(nTrials) resultant-vector identity
    instead of the reference's O(nTrials^2) pair loop
    (reference connectivity_analysis.py:624-667, ST_compRoutines.py:158-266):

        PPC = (|sum_j u_j|^2 - n) / (n (n - 1)),   u_j = z_j / |z_j|.
    """
    n = cs_stack.shape[0]
    u = cs_stack / jnp.abs(cs_stack)
    resultant = jnp.sum(u, axis=0)
    return ((jnp.abs(resultant) ** 2 - n) / (n * (n - 1))).astype(jnp.float32)
