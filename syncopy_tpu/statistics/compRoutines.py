# -*- coding: utf-8 -*-
#
# Statistics compute routines.
#
# Parity target: reference syncopy/statistics/compRoutines.py:22-391.

import numpy as np

import jax
import jax.numpy as jnp

from ..engine.routine import ComputationalRoutine

__all__ = ["NumpyStatDim", "Covariance", "TrialReduce", "LOOAverage", "EngineScratch"]


class EngineScratch:
    """Duck-typed output target for engine-internal passes whose result is
    not a valid data-class payload (e.g. a (nTrials, C, C) covariance
    stack): plain attributes, no shape validation, no persistence."""

    def __init__(self):
        self._log = ""
        self._data = None
        self._device_resident = None
        self.data = None
        self.log = ""

    @property
    def filename(self):
        from ..datatype.util import gen_session_filename

        return gen_session_filename(".scratch")


def _batch_mask(batch, n_valid):
    """(B, 1, 1, ...) boolean validity mask for a padded compute chunk."""
    shape = (batch.shape[0],) + (1,) * (batch.ndim - 1)
    return (jnp.arange(batch.shape[0]) < n_valid).reshape(shape)


class TrialReduce(ComputationalRoutine):
    """
    Streamed reduction over the TRIAL axis — the engine's chunked
    ``keeptrials=False`` accumulation replaces the reference's sequential
    trial loop (reference summary_stats.py:321-488) AND the former
    whole-ensemble ``np.stack`` (host memory stays bounded by one chunk;
    device-resident inputs are consumed straight from HBM).

    Modes (the engine divides the accumulated sum by ``numTrials``):

    - ``sum``: plain masked trial sum -> trial mean.
    - ``unit_sum``: sum of phase unit vectors ``x/|x|`` -> the resultant
      for ITC / PPC-style statistics.
    - ``centered_sq``: sum of ``|x - m|**2`` with the precomputed trial
      mean `m` fed as an auxiliary input -> exact two-pass variance.
    """

    valid_kws = ["mode"]

    def __init__(self, mode="sum", center=None):
        super().__init__(mode=str(mode))
        # aux array, NOT part of cfg: cfg is hashed into the executable
        # cache key by content — a per-dataset mean there would force a
        # re-compile for every new dataset
        self._center = None if center is None else np.asarray(center)

    def per_trial_inputs(self, data, trial_positions):
        if self.cfg["mode"] != "centered_sq":
            return ()
        # zero-copy broadcast: the engine slices per-chunk rows out of this
        # virtual (nTrials, ...) view, so host RAM stays chunk-bounded
        return (np.broadcast_to(self._center, (len(trial_positions),) + self._center.shape),)

    def _reduce_one(self, x, *aux, mode):
        if mode == "unit_sum":
            return x / jnp.abs(x)
        if mode == "centered_sq":
            d = x - aux[0]
            if jnp.iscomplexobj(d):
                return (d * jnp.conj(d)).real
            return d * d
        return x

    def process_single_trial(self, trial, *aux, **cfg):
        return self._reduce_one(trial, *aux, mode=cfg["mode"])

    def process_batch_sum(self, batch, n_valid, *aux, **cfg):
        x = self._reduce_one(batch, *aux, mode=cfg["mode"])
        # where-mask (NaN-safe): padding rows can hold 0/0 phase units or
        # resident-input garbage
        x = jnp.where(_batch_mask(x, n_valid), x, jnp.zeros((), x.dtype))
        return jnp.sum(x, axis=0)

    def process_metadata(self, data, out):
        # single-"trial" reduction output: carry the first selected trial's
        # definition row (direct assignment — the engine result is not a
        # sample-bounded continuous payload)
        out._trialdefinition = np.array(self.selector.trialdefinition[0, :][None, :])
        if getattr(data, "samplerate", None) is not None:
            out.samplerate = data.samplerate


class LOOAverage(ComputationalRoutine):
    """
    Leave-one-out trial-average replicates for jackknifing
    (reference jackknifing.py:14-108): per trial ``(N*avg - x_i)/(N-1)``,
    with the precomputed trial average `avg` streamed in as an auxiliary
    input. Runs ``keeptrials=True`` through the engine, so replicates of a
    device-resident ensemble never touch the host.
    """

    valid_kws = ["n_trials"]

    def __init__(self, n_trials, avg):
        super().__init__(n_trials=int(n_trials))
        self._avg = np.asarray(avg)

    def per_trial_inputs(self, data, trial_positions):
        return (np.broadcast_to(self._avg, (len(trial_positions),) + self._avg.shape),)

    def process_single_trial(self, trial, avg, **cfg):
        n = cfg["n_trials"]
        # algebraically identical to (n*avg - trial)/(n-1), but WITHOUT
        # the large-scale subtraction: n*avg - trial cancels at n times
        # the result's magnitude, losing ~log2(n) mantissa bits — at
        # n=1000 that is ~6e-5 relative inconsistency, enough to make a
        # wide-channel jackknife CSD replicate un-factorizable in float32
        # (Wilson floors ~100x above it). avg + (avg - trial)/(n-1)
        # subtracts at the operands' own scale and stays ~ulp-accurate.
        return (avg + (avg - trial) / (n - 1)).astype(trial.dtype)

    def process_metadata(self, data, out):
        out.trialdefinition = self.default_trialdefinition(data, out)
        if getattr(data, "samplerate", None) is not None:
            out.samplerate = data.samplerate


class NumpyStatDim(ComputationalRoutine):
    """
    Summary statistic along one dimord axis of each trial, reducing it to a
    singleton (reference statistics/compRoutines.py:22-137).
    """

    valid_kws = ["operation", "axis", "dim"]

    methods = {
        "mean": jnp.nanmean,
        "std": jnp.nanstd,
        "var": jnp.nanvar,
        "median": jnp.nanmedian,
    }

    def __init__(self, operation="mean", axis=0):
        super().__init__(operation=operation, axis=int(axis))

    def process_single_trial(self, trial, **cfg):
        return self.methods[cfg["operation"]](trial, axis=cfg["axis"], keepdims=True)

    def process_metadata(self, in_data, out_data):
        dim = in_data.dimord[self.cfg["axis"]]
        out_data.samplerate = in_data.samplerate
        sel = self.selector

        if dim == "time" and not self.keeptrials:
            trldef = np.array([[0, 1, 0]])
        elif dim != "time" and not self.keeptrials:
            trldef = sel.trialdefinition[0, :][None, :]
        elif dim == "time" and self.keeptrials:
            n_trials = len(sel.trial_ids)
            stacking = np.arange(n_trials)[:, None]
            trldef = np.hstack((stacking, stacking + 1, np.zeros((n_trials, 1))))
        else:
            trldef = sel.trialdefinition
        out_data.trialdefinition = trldef

        _propagate_dim_props(in_data, out_data, sel, reduced_dim=dim, label=self.cfg["operation"])


class Covariance(ComputationalRoutine):
    """
    Per-trial channel covariance of time-locked data
    (reference statistics/compRoutines.py:139-233). Output per trial:
    ``(1, nChannel, nChannel)`` stacked along the first axis.
    """

    valid_kws = ["ddof", "demean"]

    def __init__(self, ddof=1, demean=True):
        super().__init__(ddof=int(ddof), demean=bool(demean))

    def process_single_trial(self, trial, **cfg):
        x = trial.astype(jnp.float32)
        if cfg["demean"]:
            x = x - jnp.mean(x, axis=0, keepdims=True)
        n = x.shape[0] - cfg["ddof"]
        cov = jnp.matmul(x.T, x, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST) / n
        return cov[None]

    def process_metadata(self, data, out):
        pass  # caller attaches the result as an extra dataset


def _propagate_dim_props(in_data, out_data, sel, reduced_dim, label):
    """Propagate channel/freq/taper labels honoring selections; the reduced
    dimension collapses to a single `label` entry (freq becomes None)."""

    def _take(labels, indexer):
        labels = np.asarray(labels)
        if indexer is None:
            return labels
        if isinstance(indexer, slice):
            return labels[indexer]
        return labels[np.asarray(indexer, dtype=int)]

    for prop, sel_attr in (
        ("channel", "channel"),
        ("channel_i", "channel_i"),
        ("channel_j", "channel_j"),
        ("taper", "taper"),
    ):
        if prop in in_data.dimord and hasattr(out_data.__class__, prop):
            if prop == reduced_dim:
                setattr(out_data, prop, [label])
            else:
                try:
                    setattr(out_data, prop, _take(getattr(in_data, prop), getattr(sel, sel_attr, None)))
                except Exception:
                    pass
    if "freq" in in_data.dimord and hasattr(out_data.__class__, "freq"):
        if reduced_dim == "freq":
            out_data.freq = None
        else:
            out_data.freq = _take(in_data.freq, getattr(sel, "freq", None))
