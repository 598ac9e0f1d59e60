#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""
Run every analysis family once on one NVIDIA GPU, through the public
frontends at real sizes, and check each result against a float64 oracle.

    python chip_smoke.py [--seed N]          # one card: phases 1-6
    python chip_smoke.py --four-cards        # the mesh path on four cards

Phases (one card):
  1. north star: mtmfft PSD, coherence, CSD and fused PPC on
     1,000 trials x 64 channels x 1 s at 1 kHz;
  2. Granger causality at 128 channels (500 trials), on the device;
  3. preprocessing: Butterworth + zscore, FIRWS low-pass + Hilbert
     envelope, polyphase resampling;
  4. time-frequency: wavelet, superlet, mtmconvol, welch at 64 channels;
  5. a device-resident preprocessing -> fourier -> coherence chain, and
     jackknife coherence;
  6. coherence from an HDF5 container (left out where h5py is missing).

Every phase prints its wall time on the card, its largest error against
its oracle with the tolerance and the reason for it, and the device's
peak memory. Any failure ends the script with a non-zero exit code. The
last line of a successful run is one JSON object naming the device.

With no GPU the script exits non-zero before any phase runs. Data are made
from ``--seed``; library defaults apply throughout (no ``SPY_TPU_*``
knobs are set).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: one card's sizes; the CPU tests run the same phases at TINY
FULL = dict(n_trials=1000, n_chan=64, n_samples=1000, fs=1000.0,
            granger_trials=500, granger_chan=128, tf_trials=250,
            jack_trials=100, oracle_trials=8, ppc_freq_stride=8)
TINY = dict(n_trials=12, n_chan=4, n_samples=400, fs=1000.0,
            granger_trials=40, granger_chan=3, tf_trials=6,
            jack_trials=6, oracle_trials=3, ppc_freq_stride=4)


# ------------------------------------------------------------------ #
# reporting
# ------------------------------------------------------------------ #


def card_name():
    """`name, power.limit` of the first card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "no nvidia-smi"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "no nvidia-smi"


class Report:
    """One printed line per check: wall time on the card, max error vs
    tolerance (with its reason) and the device's peak memory so far."""

    def __init__(self, card, device):
        self.card = card
        self.device = device

    def peak_gb(self):
        stats = self.device.memory_stats() or {}
        return stats.get("peak_bytes_in_use", 0) / 1e9

    def check(self, name, wall, err, tol, reason):
        print("{:<28s} {:9.3f} s on {} | max err {:.3e} <= tol {:.0e} ({}) | "
              "peak {:.2f} GB".format(name, wall, self.card, err, tol, reason,
                                      self.peak_gb()), flush=True)
        if not (err <= tol):
            raise AssertionError("{}: error {:.3e} exceeds tolerance {:.0e}".format(
                name, err, tol))


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


# ------------------------------------------------------------------ #
# data and float64 oracles
# ------------------------------------------------------------------ #


def make_analog(spy, x, n_samples, fs):
    """AnalogData of equal trials from a (nTrials * nSamples, C) array."""
    n_trials = x.shape[0] // n_samples
    trl = np.zeros((n_trials, 3))
    trl[:, 0] = np.arange(n_trials) * n_samples
    trl[:, 1] = trl[:, 0] + n_samples
    ad = spy.AnalogData(data=x, samplerate=fs)
    ad.trialdefinition = trl
    return ad


def north_star_array(cfg, seed):
    """White noise plus four shared sources: coherences between ~0.1 and
    ~0.9, so the checks see the whole range."""
    rng = np.random.default_rng(seed)
    rows = cfg["n_trials"] * cfg["n_samples"]
    x = rng.standard_normal((rows, cfg["n_chan"]), dtype=np.float32)
    x += rng.standard_normal((rows, 4), dtype=np.float32) @ (
        0.5 * rng.standard_normal((4, cfg["n_chan"]))).astype(np.float32)
    return x


def tapers64(kind, n, fs, tapsmofrq=None):
    """Power-normalized taper bank in float64 (the reference mtmfft
    normalization: Sxx = |ftr|^2 peaks at A^2/2 for amplitude A)."""
    from scipy.signal import windows

    if kind == "dpss":
        # the bandwidth is clamped to the attainable minimum fs / n
        nw = max(tapsmofrq, fs / n) * n / fs
        w = np.atleast_2d(windows.dpss(n, nw, max(int(2 * nw - 1), 1))) * np.sqrt(n)
    else:
        w = np.atleast_2d(getattr(windows, kind)(n))
        w = w * np.sqrt(4.0 / 3.0) * np.sqrt(n / w.sum())
    return w * np.sqrt(2.0) / n


def trials64(x, cfg, idx):
    """Trials `idx` as a (B, T, C) float64 array."""
    T = cfg["n_samples"]
    return np.stack([x[i * T:(i + 1) * T].astype(np.float64) for i in idx])


def spectra64(trials, taps, demean_taper=False):
    """(B, K, F, C) float64 spectra of demeaned, tapered trials."""
    x = trials - trials.mean(axis=1, keepdims=True)
    tapered = taps[None, :, :, None] * x[:, None, :, :]
    if demean_taper:
        tapered = tapered - tapered.mean(axis=2, keepdims=True)
    return np.fft.rfft(tapered, axis=2)


def csd_sum64(spec):
    """sum over trials and tapers of spec_i conj(spec_j): (F, C, C)."""
    B, K, F, C = spec.shape
    rows = np.transpose(spec, (2, 0, 1, 3)).reshape(F, B * K, C)
    return np.conj(np.swapaxes(rows, 1, 2)) @ rows  # [f, i, j] = sum conj(a_i) a_j


def rel_err(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def abs_err(got, want):
    return float(np.nanmax(np.abs(np.asarray(got) - want)))


# ------------------------------------------------------------------ #
# phases
# ------------------------------------------------------------------ #


def phase_north_star(spy, x, cfg, rep):
    """mtmfft PSD, coherence, CSD, fused PPC vs float64 numpy over all trials."""
    T, fs, N = cfg["n_samples"], cfg["fs"], cfg["n_trials"]
    ad = make_analog(spy, x, T, fs)
    psd, t_psd = timed(spy.freqanalysis, ad, method="mtmfft", tapsmofrq=2)
    coh, t_coh = timed(spy.connectivityanalysis, ad, method="coh", tapsmofrq=2)
    csd, t_csd = timed(spy.connectivityanalysis, ad, method="csd", tapsmofrq=2)
    ppc, t_ppc = timed(spy.connectivityanalysis, ad, method="ppc", tapsmofrq=2)

    taps = tapers64("dpss", T, fs, tapsmofrq=2)
    K = taps.shape[0]
    fsel = np.arange(0, T // 2 + 1, cfg["ppc_freq_stride"])
    pow_ref = np.zeros((N, T // 2 + 1, x.shape[1]))
    csd_ref = 0.0
    U = 0.0
    step = 25
    for b0 in range(0, N, step):
        spec = spectra64(trials64(x, cfg, range(b0, min(b0 + step, N))), taps)
        pow_ref[b0:b0 + spec.shape[0]] = np.mean(np.abs(spec) ** 2, axis=1)
        csd_ref = csd_ref + csd_sum64(spec)
        s = spec[:, :, fsel, :]  # (B, K, Fs, C)
        per = np.einsum("bkfi,bkfj->bfij", s, np.conj(s)) / K
        U = U + np.sum(per / np.abs(per), axis=0)
    csd_ref = np.conj(csd_ref) / (N * K)  # [f, i, j] = mean a_i conj(a_j)
    diag = np.real(np.einsum("fii->fi", csd_ref))
    coh_ref = np.abs(csd_ref) / np.sqrt(diag[:, :, None] * diag[:, None, :])
    ppc_ref = (np.abs(U) ** 2 - N) / (N * (N - 1))

    rep.check("1 mtmfft psd", t_psd, rel_err(np.asarray(psd.data)[:, 0], pow_ref), 1e-4,
              "rel. to max; f32 FFT ~1e-6")
    rep.check("1 coherence", t_coh, abs_err(np.asarray(coh.data)[0], coh_ref), 1e-4,
              "abs; f32 Gram of 3000 rows ~1e-6")
    rep.check("1 csd", t_csd, rel_err(np.asarray(csd.data)[0], csd_ref), 1e-4,
              "rel. to max; f32 Gram ~1e-6")
    rep.check("1 ppc (fused)", t_ppc, abs_err(np.asarray(ppc.data)[0][fsel], ppc_ref), 1e-4,
              "abs; f32 sum of N unit phasors ~1e-6")
    return np.asarray(coh.data)


def granger_array(cfg, seed):
    """Sparse stable 128-node AR(2) network (one coupling per channel)."""
    C = cfg["granger_chan"]
    rng = np.random.default_rng(seed + 1)
    adj = np.zeros((C, C), dtype=np.float32)
    src = rng.permutation(C)
    adj[src, np.arange(C)] = rng.uniform(0.1, 0.25, size=C)
    np.fill_diagonal(adj, 0.0)
    return adj


def phase_granger(spy, cfg, seed, rep):
    """Granger at 128 channels on the device vs host float64 Wilson."""
    from syncopy_tpu.connectivity import connectivity_analysis as ca
    from syncopy_tpu.ops.connectivity import granger_host, regularize_csd_host, wilson_sf_host

    C, T, fs = cfg["granger_chan"], cfg["n_samples"], cfg["fs"]
    adj = granger_array(cfg, seed)
    ad = spy.synthdata.ar2_network(AdjMat=adj, nTrials=cfg["granger_trials"],
                                   nSamples=T, samplerate=fs, seed=seed)
    host_routes = []
    real_host_full = ca._granger_host_full

    def counting_host_full(*args, **kwargs):
        host_routes.append(1)
        return real_host_full(*args, **kwargs)

    ca._granger_host_full = counting_host_full
    try:
        out, wall = timed(spy.connectivityanalysis, ad, method="granger")
    finally:
        ca._granger_host_full = real_host_full
    assert out.info["converged"] is True, out.info
    assert not host_routes, "Granger left the device for the host float64 route"

    x = np.asarray(ad.data)
    taps = tapers64("hann", T, fs)
    acc = 0.0
    for b0 in range(0, cfg["granger_trials"], 50):
        idx = range(b0, min(b0 + 50, cfg["granger_trials"]))
        spec = spectra64(trials64(x, dict(cfg, n_samples=T), idx), taps, demean_taper=True)
        acc = acc + csd_sum64(spec)
    csd64 = np.conj(acc) / cfg["granger_trials"]
    reg, _, _ = regularize_csd_host(csd64, cond_max=1e4, eps_max=1e-1)
    # the float32 device factorization substitutes the exact update at the
    # zero-power DC bin (g-forcing); the oracle does the same in float64
    import jax

    H, S, conv, _ = wilson_sf_host(reg, nIter=100, rtol=5e-6,
                                   g_force=not jax.config.jax_enable_x64)
    assert conv, "float64 oracle did not converge"
    G64 = granger_host(reg, H, S)
    rep.check("2 granger {}ch".format(C), wall, abs_err(np.asarray(out.data)[0], G64), 1e-4,
              "abs; f32 Wilson + compensated Newton ~1e-6")


def phase_preprocessing(spy, x, cfg, rep):
    """Butterworth+zscore, FIRWS lp + Hilbert, resample vs scipy float64."""
    import scipy.signal as sig

    from syncopy_tpu.ops.filtering import _resample_kernel

    T, fs = cfg["n_samples"], cfg["fs"]
    ad = make_analog(spy, x, T, fs)
    sub = trials64(x, cfg, range(cfg["oracle_trials"]))

    but, t_but = timed(spy.preprocessing, ad, filter_class="but", filter_type="bp",
                       freq=[8, 30], order=4, zscore=True)
    z = (sub - sub.mean(axis=1, keepdims=True)) / sub.std(axis=1, keepdims=True)
    ref = sig.sosfiltfilt(sig.butter(4, [8, 30], "bandpass", fs=fs, output="sos"), z, axis=1)
    got = np.stack([np.asarray(but.trials[i]) for i in range(len(sub))])
    rep.check("3 butterworth+zscore", t_but, abs_err(got, ref), 2e-3,
              "abs on unit-variance data; f32 scan, poles near z=1")

    fir, t_fir = timed(spy.preprocessing, ad, filter_class="firws", filter_type="lp",
                       freq=40, hilbert="abs")
    k = sig.firwin(1001, 40, window="hamming", fs=fs)
    y = np.stack([sig.convolve(s, k[:, None], mode="same") for s in sub])
    y = np.stack([sig.convolve(s[::-1], k[:, None], mode="same")[::-1] for s in y])
    ref = np.abs(sig.hilbert(y, axis=1))
    got = np.stack([np.asarray(fir.trials[i]) for i in range(len(sub))])
    rep.check("3 firws lp + hilbert", t_fir, rel_err(got, ref), 1e-4,
              "rel. to max; f32 FIR + analytic signal")

    res, t_res = timed(spy.resampledata, ad, resamplefs=fs * 2 / 5, method="resample")
    kern = _resample_kernel(2, 5, T, None, None, fs)
    ref = sig.resample_poly(sub, 2, 5, window=kern, axis=1)
    got = np.stack([np.asarray(res.trials[i]) for i in range(len(sub))])
    rep.check("3 resample 2/5", t_res, abs_err(got, ref), 1e-4,
              "abs on unit-variance data; f32 polyphase FIR")


def _cwt64(trials, wav, scales, dt):
    """Direct per-scale 'same' convolution (Torrence & Compo sampling)."""
    from scipy.signal import fftconvolve

    out = []
    for s in scales:
        M = 10 * s / dt
        t = np.arange((-M + 1) / 2.0, (M + 1) / 2.0) * dt
        kern = (dt ** 0.5 / (s * 8 * np.pi)) * wav.time(t, s)
        out.append(fftconvolve(trials, kern[None, :, None], mode="same", axes=1))
    return np.stack(out, axis=2)  # (B, T, S, C)


def _superlet64(trials, scales, order_max, c_1, dt):
    """Multiplicative superlet magnitude: geometric mean over orders of
    |CWT| with MorletSL(c_1 * order) kernels."""
    from scipy.signal import fftconvolve

    from syncopy_tpu.ops.wavelet import MorletSL, superlet_weights

    w, orders = superlet_weights(np.asarray(scales), order_max, 1, False)
    acc = 0.0
    for j, o in enumerate(orders):
        wav = MorletSL(c_1 * o)
        mags = []
        for s in scales:
            M = 10 * s * wav.c_i / dt
            t = np.arange((-M + 1) / 2.0, (M + 1) / 2.0) * dt
            kern = (dt ** 0.5 / (4 * np.pi)) * wav.time(t, s)
            mags.append(np.abs(fftconvolve(trials, kern[None, :, None], mode="same", axes=1)))
        acc = acc + w[j][None, None, :, None] * np.log(np.stack(mags, axis=2))
    return np.exp(acc)


def _stft_pow64(trials, nperseg, hop, fs):
    """Hann-tapered power at window centers 0, hop, 2 hop, ... with
    zero extension and per-window demeaning: (B, nTime, F, C)."""
    half = nperseg // 2
    T = trials.shape[1]
    xp = np.pad(trials, ((0, 0), (half, nperseg), (0, 0)))
    starts = np.arange(int(np.ceil(T / hop))) * hop
    frames = np.stack([xp[:, c:c + nperseg] for c in starts], axis=1)
    frames = frames - frames.mean(axis=2, keepdims=True)
    taper = tapers64("hann", nperseg, fs)[0]
    return np.abs(np.fft.rfft(frames * taper[None, None, :, None], axis=2)) ** 2


def phase_time_frequency(spy, x, cfg, rep):
    """wavelet / superlet / mtmconvol / welch at 64 channels."""
    from syncopy_tpu.ops.wavelet import Morlet, MorletSL

    T, fs = cfg["n_samples"], cfg["fs"]
    dt = 1.0 / fs
    ad = make_analog(spy, x[: cfg["tf_trials"] * T], T, fs)
    raw = trials64(x, cfg, range(cfg["oracle_trials"]))
    sub = raw - raw.mean(axis=1, keepdims=True)  # wavelets demean whole trials
    n = cfg["oracle_trials"]
    foi = np.arange(4.0, fs / 10, fs / 250)
    toi = np.arange(0.1, T / fs - 0.05, 0.02)
    centers = np.round(toi * fs).astype(int)

    wl, t_wl = timed(spy.freqanalysis, ad, method="wavelet", foi=foi, toi=toi)
    ref = np.abs(_cwt64(sub, Morlet(6), Morlet(6).scale_from_period(1 / foi), dt)) ** 2
    got = np.stack([np.asarray(wl.trials[i])[:, 0] for i in range(n)])
    rep.check("4 wavelet", t_wl, rel_err(got, ref[:, centers]), 1e-4,
              "rel. to max; f32 convolution bank")

    sl, t_sl = timed(spy.freqanalysis, ad, method="superlet", foi=foi, toi=toi,
                     order_max=5, c_1=3)
    ref = _superlet64(sub, MorletSL.scale_from_period(1 / foi), 5, 3, dt) ** 2
    got = np.stack([np.asarray(sl.trials[i])[:, 0] for i in range(n)])
    rep.check("4 superlet", t_sl, rel_err(got, ref[:, centers]), 1e-4,
              "rel. to max; f32 log-magnitude mean")

    nper = int(0.2 * fs)
    mc, t_mc = timed(spy.freqanalysis, ad, method="mtmconvol", t_ftimwin=0.2, toi=0.5)
    ref = _stft_pow64(raw, nper, nper - int(0.5 * nper), fs)
    got = np.stack([np.asarray(mc.trials[i])[:, 0] for i in range(n)])
    rep.check("4 mtmconvol", t_mc, rel_err(got, ref), 1e-4, "rel. to max; f32 FFT")

    nper = int(0.25 * fs)
    we, t_we = timed(spy.freqanalysis, ad, method="welch", t_ftimwin=0.25, toi=0.5)
    ref = _stft_pow64(raw, nper, nper - int(0.5 * nper), fs).mean(axis=1)
    got = np.stack([np.asarray(we.trials[i])[0, 0] for i in range(n)])
    rep.check("4 welch", t_we, rel_err(got, ref), 1e-4, "rel. to max; f32 FFT")


def phase_resident_and_jackknife(spy, x, cfg, rep):
    """Resident chain == host chain; jackknife coherence vs float64."""
    from syncopy_tpu.engine.resident import DeferredArray

    T, fs = cfg["n_samples"], cfg["fs"]
    ad = make_analog(spy, x, T, fs)

    def chain():
        pre = spy.preprocessing(ad, filter_class="but", filter_type="bp",
                                freq=[5, 80], order=4)
        spec = spy.freqanalysis(pre, method="mtmfft", output="fourier", keeptrials=True)
        return pre, spec, spy.connectivityanalysis(spec, method="coh")

    (pre, spec, coh), wall = timed(chain)
    assert isinstance(pre._data, DeferredArray) and isinstance(spec._data, DeferredArray), \
        "chain intermediates left the device"
    os.environ["SPY_TPU_DEVICE_RESIDENT"] = "0"
    try:
        _, _, coh_host = chain()
    finally:
        del os.environ["SPY_TPU_DEVICE_RESIDENT"]
    rep.check("5 resident chain", wall,
              abs_err(np.asarray(coh.data), np.asarray(coh_host.data)), 1e-6,
              "abs; same programs, host round trips only")

    N = cfg["jack_trials"]
    jad = make_analog(spy, x[: N * T], T, fs)
    jk, wall = timed(spy.connectivityanalysis, jad, method="coh", tapsmofrq=2, jackknife=True)
    taps = tapers64("dpss", T, fs, tapsmofrq=2)
    K = taps.shape[0]
    fsel = np.arange(0, T // 2 + 1, cfg["ppc_freq_stride"])
    spec = spectra64(trials64(x, cfg, range(N)), taps)[:, :, fsel]
    per = np.einsum("bkfi,bkfj->bfij", spec, np.conj(spec)) / K  # (N, Fs, C, C)
    total = per.sum(axis=0)

    def coh64(c):
        d = np.real(np.einsum("...ii->...i", c))
        return np.abs(c) / np.sqrt(d[..., :, None] * d[..., None, :])

    reps = coh64((total[None] - per) / (N - 1))
    var = (N - 1) * np.sum(np.abs(reps - reps.mean(axis=0)) ** 2, axis=0)
    rep.check("5 jackknife coh", wall,
              abs_err(np.asarray(jk.data)[0][fsel], coh64(total / N)), 1e-4,
              "abs; as phase 1")
    rep.check("5 jackknife variance", 0.0,
              rel_err(np.asarray(jk._get_extra_dataset("jack_var"))[0][fsel], var), 1e-3,
              "rel. to max; differences of near-equal f32 replicates")


def phase_from_disk(spy, x, cfg, rep, coh_ref, workdir):
    """save -> load -> coherence from the file (trial-store miss)."""
    T, fs = cfg["n_samples"], cfg["fs"]
    ad = make_analog(spy, x, T, fs)
    path = os.path.join(workdir, "north_star.spy")
    spy.save(ad, container=path, overwrite=True)
    loaded = spy.load(path)
    coh, wall = timed(spy.connectivityanalysis, loaded, method="coh", tapsmofrq=2)
    rep.check("6 coherence from disk", wall, abs_err(np.asarray(coh.data), coh_ref), 1e-6,
              "abs; same programs as phase 1")


def run_one_card(spy, cfg, seed, rep, workdir):
    x = north_star_array(cfg, seed)
    coh = phase_north_star(spy, x, cfg, rep)
    phase_granger(spy, cfg, seed, rep)
    phase_preprocessing(spy, x, cfg, rep)
    phase_time_frequency(spy, x, cfg, rep)
    phase_resident_and_jackknife(spy, x, cfg, rep)
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("6 coherence from disk: left out, h5py is not installed", flush=True)
    else:
        phase_from_disk(spy, x, cfg, rep, coh, workdir)


def run_four_cards(spy, cfg, seed, rep):
    """The mesh path: the multichip dry-run, then coherence, mtmfft and
    fused PPC (one Triton kernel per card) under use_mesh(make_mesh())
    against the same calls with parallel=False."""
    sys.path.insert(0, REPO)
    import __graft_entry__

    _, wall = timed(__graft_entry__.dryrun_multichip, 4)
    rep.check("4-card dryrun_multichip", wall, 0.0, 0.0, "asserts inside")
    x = north_star_array(cfg, seed)
    ad = make_analog(spy, x, cfg["n_samples"], cfg["fs"])
    cases = (
        ("coherence", spy.connectivityanalysis, "coh", rel_err,
         "rel. to max; trial sums split over 4 cards"),
        ("mtmfft psd", spy.freqanalysis, "mtmfft", rel_err,
         "rel. to max; per-trial spectra, no cross-card sum"),
        ("ppc (fused)", spy.connectivityanalysis, "ppc", abs_err,
         "abs; unit-phasor sums split over 4 cards"),
    )
    for name, call, method, err, reason in cases:
        kw = dict(method=method, tapsmofrq=2)
        solo = np.asarray(call(ad, parallel=False, **kw).data)
        with spy.use_mesh(spy.make_mesh()):
            meshed, wall = timed(call, ad, **kw)
        rep.check("4-card " + name, wall, err(np.asarray(meshed.data), solo), 1e-5, reason)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card mesh path")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit("chip_smoke.py needs a GPU; JAX found platform '{}'".format(
            devices[0].platform))
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        sys.exit("chip_smoke.py needs {} GPUs; JAX found {}".format(n_cards, len(devices)))

    sys.path.insert(0, REPO)
    import syncopy_tpu as spy

    card = card_name()
    print("card: {}".format(card))
    print("jax {} | XLA_FLAGS={!r} | compile cache {}".format(
        jax.__version__, os.environ.get("XLA_FLAGS", ""),
        jax.config.jax_compilation_cache_dir), flush=True)
    rep = Report(card, devices[0])
    t0 = time.perf_counter()
    if args.four_cards:
        run_four_cards(spy, FULL, args.seed, rep)
    else:
        import tempfile

        with tempfile.TemporaryDirectory(dir=REPO) as workdir:
            run_one_card(spy, FULL, args.seed, rep, workdir)
    print("all phases passed in {:.1f} s".format(time.perf_counter() - t0))
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": n_cards}}))


if __name__ == "__main__":
    main()
