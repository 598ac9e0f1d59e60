# -*- coding: utf-8 -*-
#
# Averaged-input connectivity compute routines: operate on trial-averaged
# cross-spectral / cross-covariance data.
#
# Parity target: reference syncopy/connectivity/AV_compRoutines.py:35-484.

import numpy as np

import jax
import jax.numpy as jnp

from ..engine.routine import ComputationalRoutine
from ..ops.connectivity import (
    apply_csd_reg,
    csd_reg_params,
    granger,
    normalize_ccov,
    normalize_csd,
    psd_topup,
    regularize_csd,
    wilson_sf,
)
from ..shared.errors import SPYValueError

__all__ = ["NormalizeCrossSpectra", "NormalizeCrossCov", "GrangerCausality", "PPCReduction"]


class PPCReduction(ComputationalRoutine):
    """
    Pairwise phase consistency via the streamed resultant-vector identity
    (Vinck 2010, Eq. 14; see ops/connectivity.py::ppc_from_spectra):

        PPC = (|sum_j u_j|^2 - n) / (n (n - 1)),   u_j = z_j / |z_j|

    The per-trial unit cross-spectra are accumulated chunk-wise on device
    through the engine's ``keeptrials=False`` path (replaces the former
    whole-ensemble host stack + single transfer, reference
    connectivity_analysis.py:624-667); the final normalization runs as the
    fused ``post_device_fn``. Device-resident single-trial CSDs are
    consumed straight from HBM.
    """

    valid_kws = []

    def process_single_trial(self, trial, **cfg):
        return trial / jnp.abs(trial)

    def process_batch_sum(self, batch, n_valid, **cfg):
        u = batch / jnp.abs(batch)
        # where-mask: padding rows are 0/0 = NaN phase units
        mask_shape = (u.shape[0],) + (1,) * (u.ndim - 1)
        mask = (jnp.arange(u.shape[0]) < n_valid).reshape(mask_shape)
        u = jnp.where(mask, u, jnp.zeros((), u.dtype))
        return jnp.sum(u, axis=0)

    @staticmethod
    def make_post(n_trials):
        """Fused finalization: the engine hands the resultant / n."""

        def post(mean_u):
            resultant = n_trials * mean_u
            power = (resultant * jnp.conj(resultant)).real
            return ((power - n_trials) / (n_trials * (n_trials - 1))).astype(jnp.float32)

        return post

    def process_metadata(self, data, out):
        out.trialdefinition = np.array([[0, self.outputShape[0], 0]])
        out.samplerate = data.samplerate
        out.channel_i = np.asarray(data.channel_i)
        out.channel_j = np.asarray(data.channel_j)
        out.freq = np.asarray(data.freq)


class _AVRoutine(ComputationalRoutine):
    """Shared pre-check + metadata for averaged-input routines."""

    dimord = ["time", "freq", "channel_i", "channel_j"]

    def pre_check(self):
        """Assert the input is a trial average (reference
        AV_compRoutines.py:141-153)."""
        if self.buckets is None:
            raise SPYValueError(
                legal="Initialize the computational Routine first!",
                varname=self.__class__.__name__,
                actual="ComputationalRoutine not initialized!",
            )
        if self.numTrials != 1:
            raise SPYValueError(
                legal="1 trial: normalizations can only be done on averaged quantities!",
                varname="data",
                actual="DataSet contains {} trials".format(self.numTrials),
            )

    def process_metadata(self, data, out):
        out.trialdefinition = np.array(self.selector.trialdefinition)
        out.samplerate = data.samplerate

        def _take(labels, indexer):
            labels = np.asarray(labels)
            if indexer is None or (isinstance(indexer, slice) and indexer == slice(None)):
                return labels
            if isinstance(indexer, slice):
                return labels[indexer]
            return labels[np.asarray(indexer, dtype=int)]

        sel = self.selector
        out.channel_i = _take(data.channel_i, getattr(sel, "channel_i", None))
        out.channel_j = _take(data.channel_j, getattr(sel, "channel_j", None))
        freqs = np.asarray(data.freq)
        out.freq = _take(freqs, getattr(sel, "freq", None))


class NormalizeCrossSpectra(_AVRoutine):
    """Coherence from a trial-averaged CSD (reference
    AV_compRoutines.py:35-163)."""

    valid_kws = ["output"]

    def __init__(self, output="abs"):
        super().__init__(output=output)

    def process_single_trial(self, trial, **cfg):
        return normalize_csd(trial, cfg["output"])


class NormalizeCrossCov(_AVRoutine):
    """Cross-correlation from trial-averaged cross-covariance (reference
    AV_compRoutines.py:165-290)."""

    valid_kws = []

    def __init__(self):
        super().__init__()

    def process_single_trial(self, trial, **cfg):
        return normalize_ccov(trial)


class GrangerCausality(_AVRoutine):
    """
    Pairwise Granger-Geweke causality from a trial-averaged CSD:
    condition-number regularization + Wilson factorization + Granger
    (reference AV_compRoutines.py:292-484). The factorization runs as a
    batched `lax.while_loop` on device; convergence diagnostics surface in
    ``out.info`` via the engine's aux-info channel.
    """

    valid_kws = ["rtol", "nIter", "cond_max"]

    metadata_keys = ("converged", "max rel. err", "reg. factor", "initial cond. num")

    # one diagnostic per factorized input row (trial-average or jackknife
    # replicate) — declared so the engine never has to guess from shapes
    aux_per_trial = frozenset(metadata_keys)

    # multi-replicate chunks (jackknife LOO averages) run through lax.map,
    # never jax.vmap: a batched rewrite of the Wilson lax.while_loop once
    # miscompiled (divergence at >=128 ch even for a batch of ONE).
    # Serialization costs nothing here: each factorization is itself
    # batched over frequency.
    sequential_batch = True

    def __init__(self, rtol=5e-6, nIter=100, cond_max=1e4):
        super().__init__(rtol=float(rtol), nIter=int(nIter), cond_max=float(cond_max))

    def extra_cache_key(self):
        from ..ops.connectivity import wilson_env_fingerprint

        return wilson_env_fingerprint()

    def device_bytes_per_trial(self, shp, out_shp, out_dt):
        """Wilson workspace per factorization: the compensated-residual
        refinement slices psi into mantissa pieces and XLA keeps many
        ``(2F, N, N)`` float32 intermediates live inside the while loop —
        the compiler reports ~1 GB per replicate at (251, 16, 16).
        Without this hook the engine would vmap ALL jackknife replicates
        into one program (measured 30 GB HBM at 200 x 16 ch, a
        compile-time OOM)."""
        F, N = shp[1], shp[2]
        return int(2 * F * N * N * 8 * 300)

    def process_batch(self, batch, *aux, **cfg):
        if batch.shape[0] == 1 or batch.shape[1] != 1:
            return super().process_batch(batch, *aux, **cfg)
        # multi-replicate chunks (jackknife LOO averages, (R, 1, F, N, N)):
        # the regularization parameters come from ONE eigendecomposition of
        # the replicate MEAN and are SHARED by every replicate, because the
        # regularization spectrum is the costliest step of a wide
        # factorization and leave-one-out averages
        # differ by only O(1/nTrials). Identical loading per replicate is
        # also statistically cleaner: the jackknife spread then measures
        # trial influence, not regularization-grid flips. A per-replicate
        # batched-Cholesky top-up (psd_topup, ~8 ms) lifts any bin the
        # shared shift under-repairs; a replicate that still cannot
        # factorize reports converged=False and the frontend redoes the
        # replicates on the host (connectivity_analysis.py fallback).
        # Factorizations run via lax.map, NEVER vmap (round-3 platform
        # miscompile of the batched while_loop rewrite).
        cdtype = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
        rows = batch[:, 0].astype(cdtype)
        # engine padding rows are all-zero: exclude them from the mean
        nz = jnp.abs(rows).max(axis=(1, 2, 3)) > 0
        n_nz = jnp.maximum(jnp.sum(nz), 1)
        mean_csd = jnp.sum(jnp.where(nz[:, None, None, None], rows, 0), axis=0) / n_nz
        psd_shift, eps, ini_cn = csd_reg_params(
            mean_csd, cond_max=cfg["cond_max"], eps_max=1e-1
        )

        def one(CSD):
            CSDreg = psd_topup(apply_csd_reg(CSD, psd_shift, eps, eps_max=1e-1))
            H, Sigma, conv, err = wilson_sf(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
            return granger(CSDreg, H, Sigma).astype(jnp.float32), conv, err

        G, conv, err = jax.lax.map(one, rows)
        R = batch.shape[0]
        info = {
            "converged": conv,
            "max rel. err": err,
            "reg. factor": jnp.broadcast_to(eps, (R,)),
            "initial cond. num": jnp.broadcast_to(ini_cn, (R,)),
        }
        return G[:, None], info

    def process_single_trial(self, trial, **cfg):
        cdtype = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64

        def one(CSD):
            CSDreg, factor, ini_cn = regularize_csd(
                CSD, cond_max=cfg["cond_max"], eps_max=1e-1
            )
            H, Sigma, conv, err = wilson_sf(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
            return granger(CSDreg, H, Sigma), conv, err, factor, ini_cn

        if trial.shape[0] == 1:
            G, conv, err, factor, ini_cn = one(trial[0].astype(cdtype))
            G = G[None]
        else:
            # TIME-RESOLVED Granger (beyond the reference, which raises
            # NotImplementedError for tf-spectra — reference
            # connectivity_analysis.py:487): one factorization per sliding
            # window via lax.map — NEVER vmap (the batched while_loop
            # rewrite is the round-3 platform miscompile; scan is verified
            # healthy to 128 channels, BASELINE.md round 4)
            G, conv, err, factor, ini_cn = jax.lax.map(
                one, trial.astype(cdtype)
            )
            conv, err = jnp.all(conv), jnp.max(err)
            factor, ini_cn = jnp.max(factor), jnp.max(ini_cn)
        info = {
            "converged": conv,
            "max rel. err": err,
            "reg. factor": factor,
            "initial cond. num": ini_cn,
        }
        return G.astype(jnp.float32), info

    def process_metadata(self, data, out):
        super().process_metadata(data, out)
        for key, value in self.aux_info.items():
            val = np.asarray(value).ravel()
            if key == "converged":
                # multiple factorized rows (jackknife replicates): the run
                # only counts as converged when EVERY replicate converged
                out.info[key] = bool(val.all()) if val.size else False
            elif key == "max rel. err":
                out.info[key] = float(val.max()) if val.size else float("nan")
            else:
                scalar = val[0] if val.size else val
                out.info[key] = float(scalar)
