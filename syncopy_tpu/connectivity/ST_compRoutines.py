# -*- coding: utf-8 -*-
#
# Single-trial connectivity compute routines.
#
# Parity target: reference syncopy/connectivity/ST_compRoutines.py:29-640.

import numpy as np

import jax
import jax.numpy as jnp

from ..engine.routine import ComputationalRoutine
from ..ops.connectivity import (
    ccov_batch_sum,
    cross_covariance_trial,
    cross_spectra_trial,
    spectral_dyadic_product,
)

__all__ = ["CrossSpectra", "PPCSpectra", "SpectralDyadicProduct",
           "CrossCovariance"]


def _take_labels(labels, indexer):
    labels = np.asarray(labels)
    if indexer is None:
        return labels
    if isinstance(indexer, slice):
        return labels[indexer]
    return labels[np.asarray(indexer, dtype=int)]


class _CrossRoutine(ComputationalRoutine):
    """Shared metadata propagation for CrossSpectralData outputs."""

    dimord = ["time", "freq", "channel_i", "channel_j"]

    def _cross_trialdefinition(self, n_times):
        if not self.keeptrials:
            n_times = n_times[:1]
        bounds = np.concatenate([[0], np.cumsum(n_times)])
        trl = np.zeros((len(n_times), 3))
        trl[:, 0] = bounds[:-1]
        trl[:, 1] = bounds[1:]
        return trl

    def process_metadata(self, data, out):
        sdim = 0
        n_times = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
        out.trialdefinition = self._cross_trialdefinition(n_times)
        out.samplerate = data.samplerate
        sel = self.selector
        chan = _take_labels(data.channel, getattr(sel, "channel", None))
        out.channel_i = chan
        out.channel_j = chan
        if self.cfg.get("foi") is not None:
            out.freq = self.cfg["foi"]


class CrossSpectra(_CrossRoutine):
    """
    Single-trial (multi-)tapered cross spectra of AnalogData
    (reference ST_compRoutines.py:270-463): implicit mtmfft + channel
    outer product, tapers averaged. Output per trial ``(1, nFreq, N, N)``.
    """

    valid_kws = ["taper", "taper_opt", "tapsmofrq", "nTaper", "pad", "foi", "foilim",
                 "polyremoval", "demean_taper", "output"]

    def __init__(self, samplerate=1.0, nSamples=None, taper="hann", taper_opt=None,
                 demean_taper=False, polyremoval=0, freq_idx=None, foi=None,
                 exact_fft=False):
        # exact_fft: factorization-grade CSD — compensated double-float32
        # DFT + Gram (ops/connectivity.csd_sum_df32). Required for Granger:
        # a float32 FFT's error structure leaves the averaged CSD without
        # an exact Wilson factorization.
        super().__init__(
            samplerate=samplerate, nSamples=nSamples, taper=taper, taper_opt=taper_opt,
            demean_taper=demean_taper, polyremoval=polyremoval,
            freq_idx=None if freq_idx is None else np.asarray(freq_idx, dtype=int),
            foi=foi, exact_fft=bool(exact_fft),
        )
    def process_single_trial(self, trial, **cfg):
        nfft = cfg["nSamples"] or trial.shape[0]
        return cross_spectra_trial(
            trial, cfg["samplerate"], nfft, taper=cfg["taper"], taper_opt=cfg["taper_opt"],
            demean_taper=cfg["demean_taper"], polyremoval=cfg["polyremoval"],
            freq_idx=cfg["freq_idx"],
        )

    @staticmethod
    def _tapered_batch(batch, cfg):
        """(B, K, T, C) detrended+tapered trial batch and the taper count."""
        from ..ops.spectral import detrend
        from ..ops.windows import make_tapers

        nfft = cfg["nSamples"] or batch.shape[1]
        x = detrend(batch.astype(jnp.float32), cfg["polyremoval"], axis=1)
        tapers = jnp.asarray(
            make_tapers(cfg["taper"], cfg["taper_opt"], batch.shape[1], nfft, cfg["samplerate"])
        )
        tapered = tapers[None, :, :, None] * x[:, None, :, :]  # (B, K, T, C)
        if cfg["demean_taper"]:
            tapered = tapered - jnp.mean(tapered, axis=2, keepdims=True)
        return tapered, tapers.shape[0], nfft

    @staticmethod
    def _batch_spectra(tapered, nfft, cfg):
        """(B, K, F, C) one-sided spectra of a tapered batch."""
        from ..ops.fft import rfft_auto

        spec = rfft_auto(tapered, nfft, axis=2)  # (B, K, F, C)
        if cfg["freq_idx"] is not None:
            spec = jnp.take(spec, jnp.asarray(cfg["freq_idx"]), axis=2)
        return spec

    def process_batch_sum(self, batch, n_valid, **cfg):
        """
        Fused trial-summed cross spectra: the whole (masked) trial x taper
        stack collapses in ONE batched contraction instead of
        materializing per-trial (nFreq, N, N) matrices — the engine's
        `keeptrials=False` fast path.
        """
        tapered, K, nfft = self._tapered_batch(batch, cfg)

        if cfg.get("exact_fft") and batch.shape[1] <= 1024:
            # factorization-grade CSD: compensated double-f32 DFT + Gram —
            # a plain float32 FFT's error structure otherwise floors
            # Wilson's elementwise-relative error ~100x above the spectral
            # noise
            from ..ops.connectivity import csd_sum_df32

            mask = (jnp.arange(tapered.shape[0]) < n_valid)[:, None, None, None]
            tapered = jnp.where(mask, tapered, jnp.zeros((), tapered.dtype))
            cs_sum = csd_sum_df32(tapered, nfft, freq_idx=cfg["freq_idx"]) / K
            return cs_sum[None].astype(jnp.complex64)

        from ..ops.connectivity import csd_sum_compensated

        spec = self._batch_spectra(tapered, nfft, cfg)
        # where-mask (not multiply): resident-input padding rows can be
        # kernel(0) garbage incl. NaN, and NaN * 0 would poison the sum
        mask = (jnp.arange(spec.shape[0]) < n_valid)[:, None, None, None]
        spec = jnp.where(mask, spec, jnp.zeros((), spec.dtype))
        if cfg.get("exact_fft"):
            # Granger on trials too long for the df32 DFT: plain float32
            # accumulation noise (~3e-5 at 1000 trials) makes the CSD
            # un-factorizable — see ops/connectivity.csd_sum_compensated
            cs_sum = csd_sum_compensated(spec)
        else:
            # coherence/CSD: one batched Gram at full float32 precision.
            # On an NVIDIA H100 (700 W) at 1000 trials x 64 ch x 3 tapers
            # it takes 2.4 ms with coherence error 3.7e-6 against float64,
            # the compensated sum 12.0 ms with 1.9e-7
            # (benchmarks/branch_ab.py)
            cs_sum = jnp.einsum("bkfi,bkfj->fij", spec, jnp.conj(spec),
                                precision=jax.lax.Precision.HIGHEST)
        return (cs_sum / K)[None].astype(jnp.complex64)


class PPCSpectra(CrossSpectra):
    """
    Fused single-pass pairwise phase consistency from AnalogData: the
    single-trial cross spectra AND the unit-phasor resultant reduction
    (Vinck 2010 Eq. 14; reference connectivity_analysis.py:624-667)
    collapse into ONE engine pass — the per-trial CSD stack that the
    two-pass path materializes (its device-memory and readback bound)
    never exists. ``process_batch_sum`` returns the resultant SUM of unit
    CSDs; the frontend's fused post computes ``(|U|^2 - n) / (n (n - 1))``.

    On a GPU the reduction runs in the Triton kernel
    :func:`~syncopy_tpu.ops.pallas_kernels.ppc_resultant_triton` (the unit
    normalization happens in registers per trial); on the CPU plain XLA
    computes the identical sum through the per-chunk stack. On a mesh
    each device runs the kernel on its own trials and the partial sums
    meet in one ``psum`` (``ppc_resultant_sharded``).
    """

    def process_single_trial(self, trial, **cfg):
        cs = super().process_single_trial(trial, **cfg)
        # same semantics as PPCReduction.process_single_trial: exact-zero
        # bins are 0/0 — production inputs are tapered spectra of real
        # data where this cannot occur off the padding (which the batch
        # paths mask by n_valid)
        return cs / jnp.abs(cs)

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """Per-trial footprint: tapered copy + spectrum, plus — on the XLA
        path only — the per-chunk (F, C, C) unit-CSD stack the GPU kernel
        avoids."""
        T, C = shp[0], shp[1]
        nfft = self.cfg["nSamples"] or T
        fi = self.cfg["freq_idx"]
        F = (nfft // 2 + 1) if fi is None else len(fi)
        K = int(((self.cfg.get("taper_opt") or {}).get("Kmax", 1)) or 1)
        spec = K * T * C * 4 + K * F * C * 8
        if jax.default_backend() == "gpu":
            return spec + K * F * C * 8  # real/imag split copy for the kernel
        return spec + F * C * C * 8

    def process_batch_sum(self, batch, n_valid, **cfg):
        from ..ops.pallas_kernels import ppc_resultant

        tapered, K, nfft = self._tapered_batch(batch, cfg)
        spec = self._batch_spectra(tapered, nfft, cfg)
        U = ppc_resultant(spec, n_valid, mesh=self._live_mesh)
        return U[None].astype(jnp.complex64)


class SpectralDyadicProduct(_CrossRoutine):
    """
    Single-trial cross spectra from complex SpectralData: channel outer
    product, tapers averaged (reference ST_compRoutines.py:29-152).
    Optional (senders x receivers) restriction via `send_idx`/`rec_idx`.
    """

    valid_kws = ["send_idx", "rec_idx", "output"]

    def __init__(self, send_idx=None, rec_idx=None):
        super().__init__(
            send_idx=None if send_idx is None else np.asarray(send_idx, dtype=int),
            rec_idx=None if rec_idx is None else np.asarray(rec_idx, dtype=int),
            foi=None,
        )

    def process_single_trial(self, trial, **cfg):
        return spectral_dyadic_product(trial, cfg["send_idx"], cfg["rec_idx"])

    def process_batch_sum(self, batch, n_valid, **cfg):
        """Fused masked trial sum with COMPENSATED accumulation: the
        averaged CSD feeds Wilson downstream (granger on SpectralData
        input), where plain serial f32 accumulation noise destroys
        factorizability (see ops/connectivity.csd_sum_compensated)."""
        from ..ops.connectivity import csd_sum_compensated

        # batch: (B, nTime, K, F, C) complex
        if cfg["send_idx"] is not None:
            a = jnp.take(batch, jnp.asarray(cfg["send_idx"]), axis=4)
            b = jnp.take(batch, jnp.asarray(cfg["rec_idx"]), axis=4)
            mask = (jnp.arange(batch.shape[0]) < n_valid)[:, None, None, None, None]
            a = jnp.where(mask, a, jnp.zeros((), a.dtype))
            b = jnp.where(mask, b, jnp.zeros((), b.dtype))
            cs = jnp.einsum(
                "btkfi,btkfj->tfij", a, jnp.conj(b),
                precision=jax.lax.Precision.HIGHEST,
            ) / batch.shape[2]
            return cs.astype(jnp.complex64)
        mask = (jnp.arange(batch.shape[0]) < n_valid)[:, None, None, None, None]
        x = jnp.where(mask, batch, jnp.zeros((), batch.dtype))
        B, T, K, F, C = x.shape
        per_time = jax.vmap(
            lambda s: csd_sum_compensated(s), in_axes=1, out_axes=0
        )(x.reshape(B, T, K, F, C))
        return (per_time / K).astype(jnp.complex64)

    def process_metadata(self, data, out):
        sdim = 0
        n_times = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
        out.trialdefinition = self._cross_trialdefinition(n_times)
        out.samplerate = data.samplerate
        sel = self.selector
        chan = _take_labels(data.channel, getattr(sel, "channel", None))
        if self.cfg["send_idx"] is not None:
            out.channel_i = np.asarray(data.channel)[self.cfg["send_idx"]]
            out.channel_j = np.asarray(data.channel)[self.cfg["rec_idx"]]
        else:
            out.channel_i = chan
            out.channel_j = chan
        freqs = np.asarray(data.freq)
        fsel = getattr(sel, "freq", None)
        out.freq = _take_labels(freqs, fsel)


class CrossCovariance(_CrossRoutine):
    """
    Single-trial cross-covariance at non-negative lags
    (reference ST_compRoutines.py:465-640). Output per trial
    ``(nLags, 1, N, N)``; the lag axis rides on the time dimension.
    """

    valid_kws = ["norm", "polyremoval"]

    def __init__(self, samplerate=1.0, polyremoval=0, norm=False):
        super().__init__(samplerate=samplerate, polyremoval=polyremoval, norm=norm, foi=None)

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """Per-trial footprint. Fused keeptrials=False path: one (L_fft, C)
        complex spectrum row per trial (the (L_fft, C, C) Gram is a fixed
        per-chunk cost, charged to the first trial's share conservatively
        via the output term the engine already adds). keeptrials=True runs
        the FFT correlation with its (fft_len, C, C) spectrum product."""
        T, C = shp[0], shp[1]
        L = 1 << int(2 * T - 1).bit_length()
        if not self.keeptrials:
            return T * C * 4 + (L // 2 + 1) * C * 8
        return L * C * C * 16

    def process_single_trial(self, trial, **cfg):
        return cross_covariance_trial(trial, polyremoval=cfg["polyremoval"], norm=cfg["norm"])

    def process_batch_sum(self, batch, n_valid, **cfg):
        """Fused masked trial sum: frequency-domain Gram accumulation +
        one inverse FFT (ops/connectivity.py::ccov_batch_sum). `norm`
        is per-trial (divides by each trial's own stds) and cannot fuse —
        fall back to summing per-trial outputs in that case (the corr
        frontend never averages normed trials: norm=bool(keeptrials))."""
        if cfg["norm"]:
            per_trial = jax.vmap(
                lambda t: cross_covariance_trial(
                    t, polyremoval=cfg["polyremoval"], norm=True)
            )(batch)
            mask = (jnp.arange(batch.shape[0]) < n_valid)[:, None, None, None, None]
            return jnp.sum(
                jnp.where(mask, per_trial, jnp.zeros((), per_trial.dtype)), axis=0
            )
        return ccov_batch_sum(batch, n_valid, polyremoval=cfg["polyremoval"])

    def process_metadata(self, data, out):
        sdim = 0
        n_lags = [oshp[sdim] for oshp in self._per_trial_out_shapes_ordered]
        # lags are encoded on the time axis with offset 0 (the 0-lag)
        out.trialdefinition = self._cross_trialdefinition(n_lags)
        out.samplerate = data.samplerate
        sel = self.selector
        chan = _take_labels(data.channel, getattr(sel, "channel", None))
        out.channel_i = chan
        out.channel_j = chan
