# -*- coding: utf-8 -*-
#
# Spectral-estimation compute routines: the glue binding the jittable
# kernels in ops/ into the engine.
#
# Parity target: reference syncopy/specest/compRoutines.py (cF/CR pairs).
# Here each CR exposes `process_single_trial` — a pure jit-safe function the
# engine vmaps over the (sharded) trial batch — instead of the reference's
# `computeFunction` + Dask worker pairs.

import numpy as np

import jax.numpy as jnp

from ..engine.routine import ComputationalRoutine
from ..ops.spectral import detrend, mtmfft, mtmfft_exact, spectral_convert
from ..ops.stft import mtmconvol
from ..ops.wavelet import cwt, superlet
from ..ops.windows import make_tapers

__all__ = ["MultiTaperFFT", "MultiTaperFFTConvol", "WaveletTransform", "SuperletTransform"]


class MultiTaperFFT(ComputationalRoutine):
    """
    (Multi-)tapered Fourier transform of AnalogData trials
    (reference compRoutines.py:59-236, kernel mtmfft.py:16-129).

    Output per trial: ``(1, nTaper|1, nFreq, nChannel)``; tapers are
    averaged unless ``keeptapers=True``.
    """

    valid_kws = [
        "taper",
        "taper_opt",
        "tapsmofrq",
        "nTaper",
        "keeptapers",
        "demean_taper",
        "pad",
        "foi",
        "foilim",
        "output",
        "polyremoval",
        "ft_compat",
        "exact_fft",
    ]

    def __init__(self, samplerate=1.0, nfft=None, taper="hann", taper_opt=None,
                 demean_taper=False, output="pow", keeptapers=False,
                 polyremoval=0, freq_idx=None, ft_compat=False, exact_fft=False):
        # exact_fft: compensated double-f32 DFT — entry-proportional
        # spectral rounding so downstream trial-averaged CSDs stay
        # Wilson-factorizable (ops/spectral.mtmfft_exact)
        super().__init__(
            samplerate=samplerate, nfft=nfft, taper=taper, taper_opt=taper_opt,
            demean_taper=demean_taper, output=output, keeptapers=keeptapers,
            polyremoval=polyremoval,
            freq_idx=None if freq_idx is None else np.asarray(freq_idx, dtype=int),
            ft_compat=ft_compat, exact_fft=bool(exact_fft),
        )

    def process_single_trial(self, trial, **cfg):
        nfft = cfg["nfft"] or trial.shape[0]
        x = detrend(trial.astype(jnp.float32), cfg["polyremoval"], axis=0)
        tapers = jnp.asarray(
            make_tapers(
                cfg["taper"], cfg["taper_opt"], trial.shape[0], nfft,
                cfg["samplerate"], cfg["ft_compat"],
            )
        )
        if cfg.get("exact_fft"):
            ftr = mtmfft_exact(x, tapers, nfft, demean_taper=cfg["demean_taper"])
        else:
            # parity-sensitive complex outputs keep the platform FFT
            # (~2.4e-7 vs the matmul DFT's ~1e-6); magnitude outputs take
            # the matmul DFT where selected (ops/fft.py::_prefer_matmul)
            ftr = mtmfft(
                x, tapers, nfft, demean_taper=cfg["demean_taper"],
                platform_fft=cfg["output"] in ("fourier", "complex"),
            )
        if cfg["freq_idx"] is not None:
            ftr = jnp.take(ftr, jnp.asarray(cfg["freq_idx"]), axis=1)
        spec = spectral_convert(ftr, cfg["output"])
        if not cfg["keeptapers"]:
            spec = jnp.mean(spec, axis=0, keepdims=True)
        return spec[None]  # (1, nTaper|1, nFreq, nChannel)

    def process_metadata(self, data, out):
        out.trialdefinition = self._spectral_trialdefinition(data)
        out.samplerate = data.samplerate
        self.propagate_properties(data, out)
        nfft = self.cfg["nfft"]
        freqs = np.fft.rfftfreq(nfft, 1.0 / self.cfg["samplerate"])
        if self.cfg["freq_idx"] is not None:
            freqs = freqs[self.cfg["freq_idx"]]
        out.freq = freqs
        n_taper = out.data.shape[out.dimord.index("taper")]
        name = self.cfg["taper"] or "boxcar"
        out.taper = [name] * n_taper

    def _spectral_trialdefinition(self, data):
        """One spectral sample per trial; offsets carried from the input
        (reference compRoutines.py:215-235)."""
        trl_sel = self.selector.trialdefinition
        n_out = trl_sel.shape[0] if self.keeptrials else 1
        trl = np.zeros((n_out, trl_sel.shape[1]))
        trl[:, 0] = np.arange(n_out)
        trl[:, 1] = np.arange(n_out) + 1
        trl[:, 2] = trl_sel[:n_out, 2]
        if trl_sel.shape[1] > 3:
            trl[:, 3:] = trl_sel[:n_out, 3:]
        return trl


class _TimeFreqRoutine(ComputationalRoutine):
    """
    Shared scaffolding for time-resolved spectral CRs: window-center
    geometry from `toi` and the time-frequency trialdefinition
    (reference compRoutines.py:813-905, `_make_trialdef`).

    `toi` semantics (reference freqanalysis.py:674-790): `'all'` centers a
    window on every sample, a float in [0, 1] sets the window overlap, an
    array gives explicit window-center times in seconds.
    """

    def per_trial_inputs(self, data, trial_positions):
        toi = self.cfg["toi"]
        if not isinstance(toi, np.ndarray):
            return ()
        sel = self.selector
        trl = sel.trialdefinition
        centers = np.zeros((len(trial_positions), toi.size), dtype=np.int32)
        for i, pos in enumerate(trial_positions):
            t_start = trl[pos, 2] / data.samplerate
            centers[i] = np.round((toi - t_start) * data.samplerate).astype(np.int32)
        return (centers,)

    def _centers_for(self, n_samples):
        """Window centers for non-array `toi` (static, from trial length)."""
        toi = self.cfg["toi"]
        if isinstance(toi, str):  # 'all'
            return jnp.arange(n_samples, dtype=jnp.int32)
        # percentage overlap
        hop = self._hop()
        n_time = int(np.ceil(n_samples / hop))
        return (jnp.arange(n_time) * hop).astype(jnp.int32)

    def _hop(self):
        nperseg = self.cfg.get("nperseg")
        if nperseg is None:
            return 1
        toi = self.cfg["toi"]
        if isinstance(toi, str):
            return 1
        noverlap = min(nperseg - 1, int(toi * nperseg))
        return nperseg - noverlap

    def _tf_trialdefinition(self, data, n_times):
        """Output trialdefinition + samplerate for time-resolved spectra."""
        sel_trl = self.selector.trialdefinition
        toi = self.cfg["toi"]
        samplerate = data.samplerate
        n_trials = len(n_times)
        trl = np.zeros((n_trials, sel_trl.shape[1]))
        bounds = np.cumsum([0] + list(n_times))
        trl[:, 0] = bounds[:-1]
        trl[:, 1] = bounds[1:]
        if sel_trl.shape[1] > 3:
            trl[:, 3:] = sel_trl[:n_trials, 3:]

        # per-trial onsets in output sampling units; for a trial average the
        # onsets of the (equal-length) input trials are averaged
        if isinstance(toi, np.ndarray):
            steps = np.diff(toi)
            if steps.size and np.allclose(steps, steps[0]):
                new_rate = 1.0 / steps[0]
            else:
                # unevenly spaced toi: the trialdefinition keeps a nominal
                # 1 Hz bookkeeping rate, and the EXACT requested points are
                # attached as the output's irregular time axis in
                # process_metadata (out.time then equals the request — the
                # reference instead warns and misrepresents the axis,
                # reference compRoutines.py:864-874)
                new_rate = 1.0
            offsets = np.full(sel_trl.shape[0], toi[0] * new_rate)
        elif isinstance(toi, str):  # 'all'
            new_rate = samplerate
            offsets = sel_trl[:, 2].astype(float)
        else:  # percentage
            hop = self._hop()
            new_rate = samplerate / hop
            offsets = sel_trl[:, 2] / hop

        if self.cfg.get("time_average"):
            offsets = np.zeros_like(offsets)  # matches spy.mean(dim='time')
        if self.keeptrials:
            trl[:, 2] = offsets[:n_trials]
        else:
            trl[:, 2] = offsets.mean()
        return trl, new_rate

    def process_metadata(self, data, out):
        sdim = 0
        n_times = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
        if not self.keeptrials:
            n_times = n_times[:1]
        trl, new_rate = self._tf_trialdefinition(data, n_times)
        out.trialdefinition = trl
        self.propagate_properties(data, out)
        # after propagate_properties: the time-frequency output has its own
        # sampling rate (window hop / toi spacing), not the input's
        out.samplerate = new_rate
        out.freq = self.cfg["foi"]
        self._set_taper_labels(out)
        toi = self.cfg["toi"]
        if isinstance(toi, np.ndarray) and not self.cfg.get("time_average"):
            steps = np.diff(toi)
            if steps.size and not np.allclose(steps, steps[0]):
                # uneven toi: attach the exact requested time points so
                # out.time returns the request verbatim
                out.irregular_time = toi

    def _set_taper_labels(self, out):
        n_taper = out.data.shape[out.dimord.index("taper")]
        taper = self.cfg.get("taper")
        if taper is None:
            out.taper = ["None"] * n_taper
        elif taper == "dpss":
            out.taper = ["dpss" + str(i) for i in range(n_taper)]
        else:
            out.taper = [taper] * n_taper


class MultiTaperFFTConvol(_TimeFreqRoutine):
    """
    Sliding-window (multi-)tapered STFT (reference compRoutines.py:244-478,
    kernels mtmconvol.py:17-152 / stft.py:16-200).

    Output per trial: ``(nTime, nTaper|1, nFreq, nChannel)``.

    Deviation from the reference: explicit-`toi` windows are exactly
    `nperseg` samples (the reference's non-equidistant path uses
    ``2*halfWin+1``), and window framing always zero-extends at trial edges
    — one uniform gather kernel instead of three host paths.
    """

    valid_kws = [
        "taper",
        "taper_opt",
        "tapsmofrq",
        "nTaper",
        "keeptapers",
        "pad",
        "foi",
        "foilim",
        "toi",
        "t_ftimwin",
        "output",
        "polyremoval",
        "time_average",
    ]

    def __init__(self, samplerate=1.0, nperseg=256, toi="all", taper="hann",
                 taper_opt=None, output="pow", keeptapers=False, polyremoval=0,
                 freq_idx=None, foi=None, time_average=False):
        super().__init__(
            samplerate=samplerate, nperseg=int(nperseg), toi=toi, taper=taper,
            taper_opt=taper_opt, output=output, keeptapers=keeptapers,
            polyremoval=polyremoval,
            freq_idx=None if freq_idx is None else np.asarray(freq_idx, dtype=int),
            foi=foi, time_average=bool(time_average),
        )

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """STFT workspace: (nTime, nTaper, nperseg, nChannels) frames +
        their rfft."""
        T, C = shp[0], shp[1]
        nperseg = self.cfg["nperseg"]
        toi = self.cfg["toi"]
        if isinstance(toi, np.ndarray):
            n_time = toi.size
        elif isinstance(toi, str):
            n_time = T
        else:
            n_time = int(np.ceil(T / self._hop()))
        n_taper = 1
        if (self.cfg.get("taper_opt") or {}).get("Kmax"):
            n_taper = self.cfg["taper_opt"]["Kmax"]
        return n_time * n_taper * nperseg * C * 4 * 4

    def process_single_trial(self, trial, *aux, **cfg):
        nperseg = cfg["nperseg"]
        taper_opt = dict(cfg["taper_opt"] or {})
        if cfg["taper"] == "dpss":
            # odd slepians must not sum to zero (reference mtmconvol.py:105-111)
            taper_opt["sym"] = False
        tapers = jnp.asarray(
            make_tapers(cfg["taper"], taper_opt, nperseg, nperseg, cfg["samplerate"])
        )
        if aux:
            centers = aux[0]
        else:
            centers = self._centers_for(trial.shape[0])
        spec = mtmconvol(
            trial, tapers, centers, nperseg,
            polyremoval=cfg["polyremoval"], output=cfg["output"],
            keeptapers=cfg["keeptapers"], freq_idx=cfg["freq_idx"],
        )
        if cfg.get("time_average"):
            # Welch: segment-average ON DEVICE — the full spectrogram never
            # crosses the device boundary (reference welch = mtmconvol +
            # spy.mean(dim='time'), freqanalysis.py:1054-1056)
            spec = jnp.mean(spec, axis=0, keepdims=True)
        return spec


class WaveletTransform(_TimeFreqRoutine):
    """
    Continuous wavelet transform (reference compRoutines.py:482-650,
    kernel wavelet.py:15-49 + wavelets/transform.py:88-108).

    Output per trial: ``(nTime, 1, nScales, nChannel)``.

    Deviation from the reference: explicit-`toi` spectra are computed on
    the full trial and gathered at the requested centers (the reference
    trims the trial first, which adds edge artifacts at the trim boundary).
    """

    valid_kws = ["wavelet", "width", "order", "foi", "foilim", "toi", "output", "polyremoval"]

    def __init__(self, samplerate=1.0, scales=None, wavelet=None, toi="all",
                 output="pow", polyremoval=0, foi=None):
        super().__init__(
            samplerate=samplerate, scales=np.asarray(scales), wavelet=wavelet,
            toi=toi, output=output, polyremoval=polyremoval, foi=foi, taper=None,
        )

    def extra_cache_key(self):
        from ..ops.wavelet import _gemm_fingerprint

        return _gemm_fingerprint()

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """CWT workspace: (nScales, fft_len, nChannels) complex buffers
        (input spectrum broadcast, product, inverse transform); on the
        direct-GEMM path, the (nScales, T, C) re/im/complex buffers."""
        from ..ops.wavelet import _next_fast_len, _prefer_conv_gemm

        T, C = shp[0], shp[1]
        scales = np.asarray(self.cfg["scales"])
        if _prefer_conv_gemm(T, len(scales)):
            return len(scales) * T * C * 16
        dt = 1.0 / self.cfg["samplerate"]
        max_support = int(np.ceil(10 * scales.max() / dt)) + 1
        L = _next_fast_len(T + max_support)
        return len(scales) * L * C * 8 * 4

    def device_constants(self, shp):
        from ..ops.wavelet import cwt_gemm_consts

        return cwt_gemm_consts(
            self.cfg["wavelet"], self.cfg["scales"],
            1.0 / self.cfg["samplerate"], shp[0],
        )

    def process_single_trial(self, trial, *aux, **cfg):
        x = detrend(trial.astype(jnp.float32), cfg["polyremoval"], axis=0)
        # output='pow' never consumes the complex transform — the GEMM
        # epilogue then emits |W|^2 directly (no complex64 buffer)
        pow_only = cfg["output"] == "pow"
        spec = cwt(x, cfg["wavelet"], cfg["scales"], 1.0 / cfg["samplerate"],
                   bank=self._live_consts, power_only=pow_only)
        spec = jnp.transpose(spec, (1, 0, 2))  # (T, S, C)
        toi = cfg["toi"]
        if isinstance(toi, np.ndarray):
            spec = jnp.take(spec, aux[0], axis=0)
        if pow_only:
            return spec[:, None, :, :].astype(jnp.float32)
        return spectral_convert(spec[:, None, :, :], cfg["output"])


class SuperletTransform(_TimeFreqRoutine):
    """
    Superlet transform (reference compRoutines.py:654-810, kernel
    superlet.py:15-401).

    Output per trial: ``(nTime, 1, nScales, nChannel)``.
    """

    valid_kws = ["order_max", "order_min", "c_1", "adaptive", "foi", "foilim", "toi", "output", "polyremoval"]

    def __init__(self, samplerate=1.0, scales=None, order_max=2, order_min=1,
                 c_1=3, adaptive=False, toi="all", output="pow", polyremoval=0, foi=None):
        super().__init__(
            samplerate=samplerate, scales=np.asarray(scales), order_max=int(order_max),
            order_min=int(order_min), c_1=int(c_1), adaptive=bool(adaptive),
            toi=toi, output=output, polyremoval=polyremoval, foi=foi, taper=None,
        )

    def extra_cache_key(self):
        from ..ops.wavelet import _gemm_fingerprint

        return _gemm_fingerprint()

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """Superlet workspace: the kernel scans scales (lax.map), so only
        one (nOrders, L, nChannels) complex block is live per trial —
        plus the data spectrum and the (nScales, T, C) result. On the
        direct-GEMM path, the (nPairs, T, C) re/im/complex buffers."""
        from ..ops.wavelet import _next_fast_len, _prefer_conv_gemm, superlet_weights

        T, C = shp[0], shp[1]
        scales = np.asarray(self.cfg["scales"])
        w, _ = superlet_weights(
            scales, self.cfg["order_max"], self.cfg["order_min"],
            self.cfg["adaptive"],
        )
        n_pairs = int(np.count_nonzero(w > 0))
        if _prefer_conv_gemm(T, n_pairs, superlet=True):
            return n_pairs * T * C * 16
        dt = 1.0 / self.cfg["samplerate"]
        max_cycles = self.cfg["c_1"] * self.cfg["order_max"]
        max_support = int(np.ceil(10 * scales.max() * max_cycles / dt)) + 1
        L = _next_fast_len(T + max_support)
        n_orders = self.cfg["order_max"] - self.cfg["order_min"] + 1
        return (n_orders * L * C * 3 + L * C + len(scales) * T * C) * 8

    def device_constants(self, shp):
        from ..ops.wavelet import superlet_gemm_consts

        return superlet_gemm_consts(
            self.cfg["scales"], self.cfg["order_max"], self.cfg["order_min"],
            self.cfg["c_1"], self.cfg["adaptive"],
            1.0 / self.cfg["samplerate"], shp[0],
        )

    def process_single_trial(self, trial, *aux, **cfg):
        x = detrend(trial.astype(jnp.float32), cfg["polyremoval"], axis=0)
        # pow/abs outputs only consume |gmean| — take the magnitude-only
        # kernel (real log/exp accumulation over orders; no complex
        # log/atan2/sincos transcendentals — see ops/wavelet.superlet)
        mag_only = cfg["output"] in ("pow", "abs")
        spec = superlet(
            x, cfg["scales"], cfg["order_max"], cfg["order_min"], cfg["c_1"],
            cfg["adaptive"], dt=1.0 / cfg["samplerate"], magnitude_only=mag_only,
            bank=self._live_consts,
        )
        spec = jnp.transpose(spec, (1, 0, 2))
        toi = cfg["toi"]
        if isinstance(toi, np.ndarray):
            spec = jnp.take(spec, aux[0], axis=0)
        if mag_only:
            m = spec[:, None, :, :]
            return (m * m if cfg["output"] == "pow" else m).astype(jnp.float32)
        return spectral_convert(spec[:, None, :, :], cfg["output"])
