# -*- coding: utf-8 -*-
#
# Synthetic continuous-data generators.
#
# Parity target: reference syncopy/synthdata/analog.py:20-330
# (white_noise, linear_trend, harmonic, phase_diffusion, ar2_network,
# red_noise + helpers). Implementations are fresh; the AR(2) recursion is
# vectorized over channels (and optionally batched on device via
# ar2_network_batched for benchmarks).

import numpy as np

from .utils import collect_trials

__all__ = [
    "white_noise",
    "linear_trend",
    "harmonic",
    "phase_diffusion",
    "ar2_network",
    "red_noise",
    "ar2_peak_freq",
    "mk_RandomAdjMat",
]

_2pi = 2 * np.pi


@collect_trials
def white_noise(nSamples=1000, nChannels=2, seed=None):
    """Standard-normal white noise, shape ``nSamples x nChannels``."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nSamples, nChannels)).astype("f4")


@collect_trials
def linear_trend(y_max, nSamples=1000, nChannels=2):
    """Linear ramp from 0 to `y_max` on every channel."""
    trend = np.linspace(0, y_max, nSamples, dtype="f4")
    return np.column_stack([trend] * nChannels)


@collect_trials
def harmonic(freq, samplerate, nSamples=1000, nChannels=2):
    """Clean cosine of frequency `freq` Hz on every channel."""
    tvec = np.arange(nSamples) / samplerate
    sig = np.cos(_2pi * freq * tvec).astype("f4")
    return np.column_stack([sig] * nChannels)


@collect_trials
def phase_diffusion(
    freq,
    eps=0.1,
    samplerate=1000,
    nChannels=2,
    nSamples=1000,
    rand_ini=False,
    return_phase=False,
    seed=None,
):
    """
    Harmonic phase evolution plus Brownian phase diffusion; `eps` scales the
    Wiener increments relative to the deterministic phase velocity.
    """
    rng = np.random.default_rng(seed)
    wn = rng.normal(size=(nSamples, nChannels)).astype("f4")

    tvec = np.linspace(0, nSamples / samplerate, nSamples, dtype="f4")
    omega0 = _2pi * freq
    lin_phase = np.tile(omega0 * tvec, (nChannels, 1)).T
    if rand_ini:
        lin_phase += _2pi * rng.uniform(size=nChannels).astype("f4")

    rel_eps = np.sqrt(omega0 / samplerate * eps)
    phases = lin_phase + np.cumsum(rel_eps * wn, axis=0)
    return phases if return_phase else np.cos(phases)


def _ar2_single(AdjMat, nSamples, alphas, seed):
    AdjMat = np.asarray(AdjMat, dtype=np.float32)
    nChannels = AdjMat.shape[0]
    alpha1, alpha2 = alphas
    # lag-1 system matrix: self-interaction + coupling (i -> j convention)
    M1 = np.diag(nChannels * [alpha1]) + AdjMat.T
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(nSamples, nChannels)).astype(np.float32)
    sig = np.zeros((nSamples, nChannels), dtype=np.float32)
    sig[:2] = noise[:2]
    for i in range(2, nSamples):
        sig[i] = M1 @ sig[i - 1] + alpha2 * sig[i - 2] + noise[i]
    return sig


@collect_trials
def ar2_network(AdjMat=None, nSamples=1000, alphas=(0.55, -0.8), seed=None):
    """
    Network of coupled AR(2) processes. Default: 2 channels with
    unidirectional 2 -> 1 coupling of strength 0.25 and a 40 Hz spectral
    peak at 200 Hz sampling (Dhamala 2008 setup).
    """
    if AdjMat is None:
        AdjMat = np.zeros((2, 2), dtype=np.float32)
        AdjMat[1, 0] = 0.25
    return _ar2_single(AdjMat, nSamples, alphas, seed)


@collect_trials
def red_noise(alpha, nSamples=1000, nChannels=2, seed=None):
    """Uncoupled AR(1) processes (1/f-ish background for alpha near 1)."""
    AdjMat = np.zeros((nChannels, nChannels), dtype=np.float32)
    return _ar2_single(AdjMat, nSamples, (alpha, 0.0), seed)


def ar2_peak_freq(a1, a2, samplerate=1):
    """Spectral peak frequency of an AR(2) process."""
    if np.any((a1**2 + 4 * a2) > 0):
        raise ValueError("No complex roots!")
    return np.arccos(a1 * (a2 - 1) / (4 * a2)) / _2pi * samplerate


def mk_RandomAdjMat(nChannels=3, conn_thresh=0.25, max_coupling=0.25, seed=None):
    """
    Random sparse adjacency matrix: couplings uniform in
    ``[0, max_coupling]``, entries below `conn_thresh` (quantile) dropped,
    zero diagonal.
    """
    rng = np.random.default_rng(seed)
    AdjMat = rng.uniform(0, max_coupling, size=(nChannels, nChannels))
    conns = rng.uniform(size=(nChannels, nChannels)) > conn_thresh
    AdjMat = np.where(conns, AdjMat, 0.0)
    np.fill_diagonal(AdjMat, 0.0)
    return AdjMat.astype(np.float32)


def ar2_network_device(nTrials, AdjMat=None, nSamples=1000, alphas=(0.55, -0.8), seed=42):
    """
    Device-resident AR(2) network generator: all trials at once via
    ``lax.scan`` over time, vmapped over trials; returns the ``jax.Array``
    WITHOUT a host readback (used by the device-bound benchmarks, where
    inputs must never cross the host<->device link).
    """
    import jax
    import jax.numpy as jnp

    if AdjMat is None:
        AdjMat = np.zeros((2, 2), dtype=np.float32)
        AdjMat[1, 0] = 0.25
    AdjMat = jnp.asarray(AdjMat, dtype=jnp.float32)
    nChannels = AdjMat.shape[0]
    alpha1, alpha2 = alphas
    M1 = jnp.diag(jnp.full((nChannels,), alpha1)) + AdjMat.T

    key = jax.random.PRNGKey(seed)
    noise = jax.random.normal(key, (nTrials, nSamples, nChannels), dtype=jnp.float32)

    def step(carry, eps):
        prev1, prev2 = carry
        cur = jnp.matmul(prev1, M1.T, precision=jax.lax.Precision.HIGHEST) + alpha2 * prev2 + eps
        return (cur, prev1), cur

    def run(trial_noise):
        init = (trial_noise[1], trial_noise[0])
        _, out = jax.lax.scan(step, init, trial_noise[2:])
        return jnp.concatenate([trial_noise[:2], out], axis=0)

    return jax.jit(jax.vmap(run))(noise)


def ar2_network_batched(nTrials, AdjMat=None, nSamples=1000, alphas=(0.55, -0.8), seed=42):
    """
    Device-batched AR(2) network generator (all trials at once via
    ``lax.scan`` over time, vmapped over trials) — the fast path used by
    benchmarks; statistically identical to :func:`ar2_network`.
    """
    return np.asarray(
        ar2_network_device(nTrials, AdjMat=AdjMat, nSamples=nSamples,
                           alphas=alphas, seed=seed)
    )
