# -*- coding: utf-8 -*-
#
# Taper/window generation (host-side setup code).
#
# Parity targets: reference syncopy/specest/mtmfft.py:95-101 (window
# construction), _norm_spec.py:9-45 (power-preserving normalization),
# mtmfft.py:132-148 (`_get_dpss_pars`).
#
# Windows are built with numpy/scipy on the host at trace/setup time and
# enter the jitted device kernels as constants (XLA constant-folds them); the
# spectral normalization scalar is folded into the taper itself so the
# device kernel is a pure multiply + rfft.

import functools

import numpy as np
from scipy.signal import windows as sp_windows

__all__ = ["make_tapers", "get_dpss_pars", "nextpow2"]


def nextpow2(n):
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


def get_dpss_pars(tapsmofrq, nSamples, samplerate):
    """Derive Slepian parameters (NW, Kmax) from the smoothing bandwidth
    (reference mtmfft.py:132-148)."""
    NW = tapsmofrq * nSamples / samplerate
    Kmax = int(2 * NW - 1)
    return NW, Kmax if Kmax > 1 else 1


@functools.lru_cache(maxsize=128)
def _cached_tapers(taper, taper_opt_items, signal_length, pad_length, samplerate, ft_compat):
    taper_opt = dict(taper_opt_items)
    if taper is None:
        taper = "boxcar"
    win_fn = getattr(sp_windows, taper)
    wins = np.atleast_2d(win_fn(signal_length, **taper_opt)).astype(np.float64)

    # power-preserving taper normalization (reference _norm_taper)
    if taper == "dpss":
        wins = wins * np.sqrt(pad_length)
    elif taper == "boxcar":
        wins = wins * np.sqrt(pad_length / wins.sum())
    else:
        wins = wins * (np.sqrt(4.0 / 3.0) * np.sqrt(pad_length / wins.sum()))

    # fold the spectral normalization scalar into the taper
    # (reference _norm_spec with mode='bins': ftr *= sqrt(2)/nSamples_eff);
    # non-ft_compat keeps power invariant under padding
    if ft_compat:
        n_eff = float(pad_length)
    else:
        n_eff = signal_length * np.sqrt(pad_length / signal_length)
    wins = wins * (np.sqrt(2.0) / n_eff)
    return wins.astype(np.float32)


def make_tapers(taper, taper_opt, signal_length, pad_length=None, samplerate=1.0, ft_compat=False):
    """
    Return the ``(nTaper, signal_length)`` float32 taper bank with the
    full mtmfft normalization folded in: multiplying the signal by these
    windows and taking ``rfft(..., n=pad_length)`` directly yields
    power-normalized Fourier coefficients (``Sxx = |ftr|^2`` peaks at
    ``A^2/2`` for a harmonic of amplitude A).
    """
    if pad_length is None:
        pad_length = signal_length
    # lru_cache key must be hashable: list/array option values (e.g.
    # general_cosine's coefficient vector) become tuples
    items = tuple(
        (k, tuple(np.ravel(v)) if isinstance(v, (list, tuple, np.ndarray)) else v)
        for k, v in sorted((taper_opt or {}).items())
    )
    return _cached_tapers(taper, items, int(signal_length), int(pad_length), float(samplerate), bool(ft_compat))
