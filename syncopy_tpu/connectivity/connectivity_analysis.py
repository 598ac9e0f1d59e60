# -*- coding: utf-8 -*-
#
# connectivityanalysis: user-facing connectivity frontend.
#
# Parity target: reference syncopy/connectivity/connectivity_analysis.py:51-872.
# Methods: coh, corr, granger, csd, ppc; channelcmb subsetting; jackknife
# error estimation. Architecture follows the reference's two stages —
# single-trial (ST) cross quantities, then averaged (AV) normalization —
# with the trial loop batched on device. Device redesigns: the PPC pair loop
# is an O(nTrials) resultant-vector reduction, and pairwise Granger
# (`channelcmb`) runs one vmapped Wilson factorization over all pairs
# instead of the reference's per-pair CR re-initialization.

import os

import numpy as np

import jax
import jax.numpy as jnp

from ..datatype.continuous_data import AnalogData, CrossSpectralData, SpectralData
from ..shared.errors import SPYTypeError, SPYValueError, SPYWarning, SPYInfo
from ..shared.input_processors import (
    check_effective_parameters,
    check_passed_kwargs,
    process_foi,
    process_padding,
    process_taper,
)
from ..shared.kwarg_decorators import detect_parallel_client, unwrap_cfg, unwrap_select
from ..shared.parsers import data_parser, scalar_parser, sequence_parser
from ..shared.tools import best_match, get_defaults, get_frontend_cfg

__all__ = ["connectivityanalysis"]

availableMethods = ("coh", "corr", "granger", "csd", "ppc")
connectivity_outputs = ("abs", "pow", "complex", "fourier", "angle", "real", "imag")


@unwrap_cfg
@unwrap_select
@detect_parallel_client
def connectivityanalysis(
    data,
    method="coh",
    keeptrials=False,
    output="abs",
    foi=None,
    foilim=None,
    pad="maxperlen",
    channelcmb=None,
    polyremoval=0,
    tapsmofrq=None,
    nTaper=None,
    taper="hann",
    taper_opt=None,
    jackknife=False,
    parallel=None,
    **kwargs,
):
    """
    Perform connectivity analysis of AnalogData or (complex) SpectralData.

    Methods: ``coh`` (coherence), ``corr`` (cross-correlation), ``granger``
    (nonparametric Granger-Geweke causality via Wilson factorization),
    ``csd`` (single-trial/averaged cross-spectra), ``ppc`` (pairwise phase
    consistency).

    Parameters
    ----------
    data : :class:`~syncopy_tpu.AnalogData` or complex :class:`~syncopy_tpu.SpectralData`
        Time series, or pre-computed single-trial Fourier spectra
        (``output="fourier"``, trials kept).
    method : {"coh", "corr", "granger", "csd", "ppc"}
        Connectivity measure (see above).
    keeptrials : bool
        Keep single-trial estimates ("csd"/"corr" only; the averaged
        measures are defined across trials).
    output : str
        For "coh": "abs", "pow", "complex"/"fourier", "real", "imag",
        "angle". Ignored (with a warning) by the other methods.
    foi, foilim : array_like / [fmin, fmax] / None
        Frequencies of interest (see :func:`~syncopy_tpu.freqanalysis`).
    pad : "maxperlen", "nextpow2", or float
        Trial padding policy ("corr" requires the default).
    channelcmb : [senders, receivers] or None
        Two channel lists restricting the pairwise computation (granger/
        coh); results contain only the requested block.
    polyremoval : {0, 1, None}
        Per-trial detrend order before tapering.
    tapsmofrq, nTaper, taper, taper_opt
        Multi-taper controls, as in :func:`~syncopy_tpu.freqanalysis`.
    jackknife : bool
        Leave-one-out trial jackknife for "coh"/"granger": adds
        bias-corrected estimates and variance via the engine-streamed LOO
        path. Wide-channel note: the LOO cross-spectral matrices must be
        full rank, i.e. ``(n_trials - 1) * n_tapers > n_channels``.
    parallel : bool or None
        Shard trials over the active device mesh (None = auto-detect).
        ``chan_per_worker`` (via kwargs) is accepted for reference
        compatibility but ADVISORY ONLY: the engine replaces channel
        blocking with the mesh "channel" axis (results invariant, request
        logged). See `doc/engine.md`.

    Returns
    -------
    :class:`~syncopy_tpu.CrossSpectralData`
        ``(time, freq, channel_i, channel_j)`` connectivity estimates with
        replayable ``cfg``; Granger convergence diagnostics land in
        ``out.info``.

    Reference: connectivity_analysis.py:51.
    """
    data_parser(data, varname="data", empty=False)
    if not isinstance(data, (AnalogData, SpectralData)):
        raise SPYValueError(
            legal="either AnalogData or SpectralData as input", varname="data",
            actual=data.__class__.__name__,
        )
    timeAxis = data.dimord.index("time")
    defaults = get_defaults(connectivityanalysis)
    lcls = dict(locals())
    check_passed_kwargs(lcls, defaults, frontend_name="connectivity")

    if method not in availableMethods:
        raise SPYValueError(legal=str(availableMethods), varname="method", actual=method)
    if not isinstance(jackknife, bool):
        raise SPYTypeError(jackknife, "jackknife", "boolean")
    if jackknife and method not in ("coh", "granger"):
        SPYWarning("Jackknife is not available for method {}".format(method))
        jackknife = False
    if method != "coh" and output != defaults["output"]:
        SPYWarning("Setting `output` for method {} has no effect!".format(method))

    if data.selection is not None:
        sinfo = data.selection.trialdefinition[:, :2]
    else:
        sinfo = data.sampleinfo
    lenTrials = np.atleast_1d(np.diff(sinfo).squeeze())
    nTrials = len(sinfo)

    send_idx = rec_idx = None
    if channelcmb is not None:
        send_idx, rec_idx = _digest_channelcmb(data, channelcmb)

    if method == "corr" and pad != "maxperlen":
        raise SPYValueError(
            legal="'maxperlen', no padding needed/allowed for cross-correlations",
            varname="pad", actual=str(pad),
        )
    if polyremoval is not None:
        scalar_parser(polyremoval, varname="polyremoval", ntype="int_like", lims=[0, 1])

    log_dict = {"method": method, "keeptrials": keeptrials, "polyremoval": polyremoval,
                "pad": pad, "channelcmb": channelcmb}
    new_cfg = get_frontend_cfg(defaults, lcls, kwargs)

    from .AV_compRoutines import GrangerCausality, NormalizeCrossCov, NormalizeCrossSpectra
    from .ST_compRoutines import (
        CrossCovariance,
        CrossSpectra,
        PPCSpectra,
        SpectralDyadicProduct,
    )

    # -- single-trial stage setup ---------------------------------------- #

    av_compRoutine = None
    fused_ppc = False
    if method == "corr":
        if not isinstance(data, AnalogData):
            raise SPYValueError(
                legal="AnalogData instance as input for method corr", varname="data",
                actual=data.__class__.__name__,
            )
        if foi is not None:
            SPYWarning("Parameter `foi` has no effect for method `corr`")
        check_effective_parameters(CrossCovariance, defaults, lcls, besides=["jackknife"])
        st_compRoutine = CrossCovariance(
            samplerate=data.samplerate, polyremoval=polyremoval, norm=bool(keeptrials)
        )
        if not keeptrials:
            av_compRoutine = NormalizeCrossCov()

    else:  # csd / coh / ppc / granger need single-trial cross spectra
        if nTrials == 1:
            raise SPYValueError(
                legal="multi-trial input data, spectral connectivity measures "
                "critically depend on trial averaging!",
                varname="data", actual="only one trial",
            )
        if keeptrials is not False and method in ("coh", "ppc", "granger"):
            raise SPYValueError(
                legal="False, trial averaging needed for method {}!".format(method),
                varname="keeptrials", actual=str(keeptrials),
            )

        if isinstance(data, AnalogData):
            nSamples = process_padding(pad, lenTrials, data.samplerate)
            check_effective_parameters(
                CrossSpectra, defaults, lcls, besides=["jackknife", "channelcmb"]
            )
            # fused single-pass PPC: spectra + unit-phasor reduction in one
            # engine pass (PPCSpectra) — the per-trial CSD stack of the
            # two-pass path never materializes. SPY_TPU_FUSED_PPC=0 reverts
            # to the two-pass (CrossSpectra keeptrials + PPCReduction) path.
            fused_ppc = (
                method == "ppc" and send_idx is None
                and os.environ.get("SPY_TPU_FUSED_PPC", "1") != "0"
            )
            st_compRoutine, out_foi = _setup_cross_spectra(
                data, method, nSamples, foi, foilim, tapsmofrq, nTaper, taper,
                taper_opt, polyremoval, lenTrials, log_dict,
                cls=PPCSpectra if fused_ppc else CrossSpectra,
            )
        else:
            # dtype check via the payload's dtype attribute — never slice
            # here: element access would force a device-resident input
            # (freqanalysis output still in HBM) through a host readback
            if not np.issubdtype(np.dtype(data.data.dtype), np.complexfloating):
                raise SPYValueError(
                    legal="complex valued spectra, set `output='fourier'` in spy.freqanalysis!",
                    varname="data", actual="real valued spectral data",
                )
            if method == "granger":
                if data.data.shape[data.dimord.index("time")] != len(data.trials):
                    # BEYOND the reference (which raises NotImplementedError
                    # here, connectivity_analysis.py:487): each sliding
                    # window's trial-averaged CSD is factorized separately
                    # (lax.map over windows on device)
                    SPYInfo(
                        "time-resolved Granger: factorizing one CSD per "
                        "sliding window ({} windows per trial)".format(
                            data.data.shape[data.dimord.index("time")]
                            // max(len(data.trials), 1))
                    )
                # accuracy trap: a CSD accumulated from plain-f32 FFT spectra
                # is not exactly factorizable — Wilson floors at ~1e-4 and
                # reports converged=False. The compensated double-f32 DFT
                # only applies when the spectra are computed HERE (from
                # AnalogData) or upstream with exact_fft=True; detect the
                # lossy producer via the attached provenance and warn
                # actionably (reference pre_check contract,
                # AV_compRoutines.py:292-380).
                fa_cfg = data.cfg.get("freqanalysis", None)
                if fa_cfg is not None and not fa_cfg.get("exact_fft", False):
                    SPYWarning(
                        "Granger from precomputed float32 'fourier' spectra is "
                        "numerically degraded: the accumulated CSD carries "
                        "plain-f32 rounding, which biases the Granger estimate "
                        "by O(1e-2) absolute even when the factorization "
                        "converges (and can make it fail outright). Recompute "
                        "the spectra with spy.freqanalysis(..., "
                        "exact_fft=True), or run "
                        "connectivityanalysis(method='granger') directly on "
                        "the raw AnalogData (the compensated DFT then applies "
                        "automatically)."
                    )
            check_effective_parameters(
                SpectralDyadicProduct, defaults, lcls, besides=["jackknife", "channelcmb"]
            )
            if send_idx is not None and method in ("ppc", "csd"):
                st_compRoutine = SpectralDyadicProduct(send_idx=send_idx, rec_idx=rec_idx)
            else:
                st_compRoutine = SpectralDyadicProduct()

    # -- AV stage selection ---------------------------------------------- #

    if method == "coh":
        if output not in connectivity_outputs:
            raise SPYValueError(
                legal="one of {}".format(connectivity_outputs), varname="output", actual=output
            )
        log_dict["output"] = output
        av_compRoutine = NormalizeCrossSpectra(output=output)
    elif method == "granger":
        av_compRoutine = GrangerCausality(rtol=5e-6, nIter=100, cond_max=1e4)

    # -- run the single-trial stage --------------------------------------- #

    st_out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    st_keeptrials = bool(keeptrials or jackknife
                         or (method == "ppc" and not fused_ppc))

    # operator fusion: coherence/cross-correlation = trial-averaged cross
    # quantity + normalization; the normalization runs on-device fused onto
    # the ST stage's reduction (no intermediate round-trip, replaces the
    # separate AV pass)
    fused_post = None
    if not st_keeptrials:
        import functools

        if method == "coh":
            fused_post = (functools.partial(_coh_post, output=output), ("coh", output))
        elif method == "ppc":
            # fused PPCSpectra pass: the engine hands resultant/n; the post
            # finalizes (|U|^2 - n)/(n (n-1)). n needs the selected trial
            # count — filled right after initialize below.
            fused_post = "ppc-pending"
        elif method == "corr":
            fused_post = (_corr_post, ("corr",))
        elif method in ("csd", "granger"):
            # no normalization, but fusing an identity post enables the
            # Hermitian triangular packing of the averaged-CSD readback
            # (for granger the packed CSD then feeds the factorization)
            fused_post = (lambda x: x, ("csd",))

    st_compRoutine.initialize(data, st_out._stackingDim, keeptrials=st_keeptrials)
    if fused_post == "ppc-pending":
        from .AV_compRoutines import PPCReduction

        n_tr = st_compRoutine.numTrials
        fused_post = (PPCReduction.make_post(n_tr), ("ppc", n_tr))
    if fused_post is not None:
        pack = unpack = None
        n_chan = int(next(iter(st_compRoutine.out_per_trial_shapes.values()))[0][-1])
        if method == "coh" and output in _COH_MIRROR_SIGN:
            pack, unpack = _make_triu_pack(n_chan, _COH_MIRROR_SIGN[output])
        elif method == "ppc":
            # PPC of a full dyadic CSD is symmetric real
            pack, unpack = _make_triu_pack(n_chan, 1.0)
        elif method in ("csd", "granger"):
            pack, unpack = _make_herm_pack(n_chan)
        st_compRoutine.compute(
            data, st_out, parallel=parallel, log_dict=log_dict,
            post_device_fn=fused_post[0], post_key=fused_post[1],
            post_pack=pack, post_unpack=unpack,
            # the Hermitian pack encodes the COMPLEX averaged CSD — must
            # never be downcast by SPY_TPU_READBACK_DTYPE (Wilson amplifies
            # f16 quantization to O(0.1) Granger errors)
            post_pack_complex=(method in ("csd", "granger")),
        )
        if method != "granger":
            out = st_out
            if send_idx is not None and method == "coh":
                out = out.selectdata(channel_i=[str(c) for c in np.asarray(data.channel)[send_idx]])
                out = out.selectdata(channel_j=[str(c) for c in np.asarray(data.channel)[rec_idx]])
            out.cfg.update(data.cfg)
            new_cfg.update({"output": output})
            out.cfg.update({"connectivityanalysis": new_cfg})
            return out
    else:
        st_compRoutine.compute(data, st_out, parallel=parallel, log_dict=log_dict)

    replicates_avg = None
    if jackknife:
        from ..statistics import jackknifing as jk
        from ..statistics.summary_stats import mean as spy_mean

        if method == "granger":
            # each trial contributes rank <= nTapers to the averaged CSD, so
            # a leave-one-out replicate has rank <= (nTrials-1)*nTapers — if
            # that is below the channel count the CSD is SINGULAR and no
            # Wilson factorization exists (device f32, host f64, any
            # batching; round-4 root-cause of the 128-ch jackknife scare)
            t_opt = (getattr(st_compRoutine, "cfg", None) or {}).get("taper_opt")
            n_tap = int((t_opt or {}).get("Kmax", 1) or 1)
            if (nTrials - 1) * n_tap < len(data.channel):
                SPYWarning(
                    "jackknife Granger with {} trials x {} taper(s) on {} "
                    "channels: leave-one-out CSDs have rank {} < {} and are "
                    "singular — the factorization CANNOT converge. Use more "
                    "trials/tapers or fewer channels.".format(
                        nTrials, n_tap, len(data.channel),
                        (nTrials - 1) * n_tap, len(data.channel))
                )

        jack_in = st_out
        st_out = spy_mean(st_out, dim="trials")
        replicates_avg = jk.trial_avg_replicates(jack_in, parallel=parallel)

    # -- evaluate the AV stage -------------------------------------------- #

    if av_compRoutine is None and method != "ppc":
        st_out.cfg.update(data.cfg)
        st_out.cfg.update({"connectivityanalysis": new_cfg})
        return st_out

    if method == "ppc":
        out = _compute_ppc(st_out, parallel=parallel)
    elif method == "granger" and send_idx is not None:
        out = _granger_pairwise(st_out, send_idx, rec_idx, data, av_compRoutine)
    elif method == "granger" and os.environ.get("SPY_GRANGER_HOST", "") not in ("", "0"):
        # escape hatch: force the host float64 factorization (the default
        # device path runs float32 Wilson + compensated-residual Newton
        # refinement, which matches the float64 result to ~1e-6 — see
        # ops/connectivity.py::_wilson_refine)
        out = _granger_host_full(st_out, av_compRoutine)
    elif method == "granger" and _granger_rank_deficient(st_compRoutine, nTrials,
                                                         st_out):
        # PRE-FLIGHT GATE (round-5): each trial contributes rank <= nTapers
        # to the averaged CSD, so nTrials*nTapers < nChannels means the CSD
        # is SINGULAR by construction — the float32 device factorization
        # cannot converge (the round-4 "256-ch platform limit" was exactly
        # this: a 250-trial single-taper probe on 256 channels) and would
        # burn ~26 s at 256 ch before the converged=False fallback fires.
        # Route straight to the host float64 factorization, which operates
        # on the eps-regularized (full-rank) matrix like the reference
        # does; results at such shapes are regularization-dominated.
        SPYWarning(
            "Granger with {} trials x {} taper(s) on {} channels: the "
            "averaged CSD has rank {} < {} and is singular — skipping the "
            "doomed float32 device factorization and using the host "
            "float64 path on the regularized matrix. Results depend on "
            "the regularization; use more trials/tapers or fewer "
            "channels.".format(
                nTrials, _granger_n_tapers(st_compRoutine), len(st_out.channel_i),
                nTrials * _granger_n_tapers(st_compRoutine), len(st_out.channel_i))
        )
        out = _granger_host_full(st_out, av_compRoutine)
    else:
        out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
        av_compRoutine.initialize(st_out, out._stackingDim)
        av_compRoutine.pre_check()
        av_compRoutine.compute(st_out, out, parallel=parallel, log_dict=log_dict)
        if (
            method == "granger"
            and out.info.get("converged") is False
            and os.environ.get("SPY_GRANGER_HOST_FALLBACK", "1") != "0"
        ):
            # the float32 device factorization can diverge on wide/ill-
            # conditioned CSDs (the reference always factorizes in float64,
            # syncopy/connectivity/AV_compRoutines.py:292-484): retry on the
            # host in float64 so the user never keeps an unreliable estimate
            SPYWarning(
                "float32 device Wilson factorization did not converge "
                "(max rel. err {:.2e}) — retrying with the host float64 "
                "factorization (disable via SPY_GRANGER_HOST_FALLBACK=0).".format(
                    float(out.info.get("max rel. err", float("nan")))
                )
            )
            out = _granger_host_full(st_out, av_compRoutine)

    if jackknife:
        from ..statistics import jackknifing as jk

        jack_rep = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
        av_compRoutine.initialize(replicates_avg, jack_rep._stackingDim)
        av_compRoutine.compute(replicates_avg, jack_rep, parallel=parallel, log_dict=log_dict)
        if (
            method == "granger"
            and jack_rep.info.get("converged") is False
            and os.environ.get("SPY_GRANGER_HOST_FALLBACK", "1") != "0"
        ):
            # the leave-one-out CSDs share the full average's conditioning:
            # if ANY replicate's f32 factorization diverged, pairing its
            # bias/variance with a (possibly host-f64-retried) good point
            # estimate would silently attach garbage error bars — redo the
            # replicates in host float64
            SPYWarning(
                "Wilson factorization did not converge on at least one "
                "jackknife replicate (max rel. err {:.2e}) — recomputing "
                "the replicates with the host float64 factorization.".format(
                    float(jack_rep.info.get("max rel. err", float("nan")))
                )
            )
            jack_rep = _granger_host_replicates(replicates_avg, av_compRoutine)
        bias, variance = jk.bias_var(out, jack_rep)
        out._register_dataset("jack_var", np.asarray(variance.data))
        out._register_dataset("jack_bias", np.asarray(bias.data))

    if send_idx is not None and method == "coh":
        out = out.selectdata(channel_i=[str(c) for c in np.asarray(data.channel)[send_idx]])
        out = out.selectdata(channel_j=[str(c) for c in np.asarray(data.channel)[rec_idx]])

    # non-convergence is a RESULT-QUALITY problem, not a diagnostic detail:
    # surface it as a warning rather than leaving it buried in out.info
    if method == "granger" and out.info.get("converged") is False:
        SPYWarning(
            "Wilson factorization did NOT converge (max rel. err {:.2e}); "
            "the Granger estimates are unreliable. Typical cause: input "
            "spectra from a plain float32 FFT (see the exact_fft note "
            "above); otherwise raise nIter or loosen rtol.".format(
                float(out.info.get("max rel. err", float("nan")))
            )
        )

    out.cfg.update(data.cfg)
    new_cfg.update({"output": output})
    out.cfg.update({"connectivityanalysis": new_cfg})
    return out


# ------------------------------------------------------------------------ #
# helpers
# ------------------------------------------------------------------------ #


def _coh_post(csd_avg, output="abs"):
    """Device-side coherence normalization fused onto the trial-averaged
    CSD (reference AV_compRoutines.normalize_csd_cF)."""
    from ..ops.connectivity import normalize_csd

    return normalize_csd(csd_avg, output)


def _corr_post(ccov_avg):
    """Device-side cross-correlation normalization fused onto the
    trial-averaged cross-covariance (reference
    AV_compRoutines.normalize_ccov_cF)."""
    from ..ops.connectivity import normalize_ccov

    return normalize_ccov(ccov_avg)


#: mirror sign of the Hermitian coherency matrix per real output flavor
_COH_MIRROR_SIGN = {"abs": 1.0, "pow": 1.0, "real": 1.0, "imag": -1.0, "angle": -1.0}


def _mirror_gather(n_chan):
    """Flat gather map reconstructing an (N, N) block from its packed upper
    triangle: ``full.ravel()[k] = tri[gather[k]]``, plus the strictly-lower
    flat positions that need the mirror sign/conjugate. One contiguous
    GATHER is ~3x faster on host than the two fancy-index SCATTERS it
    replaces (the warm-call unpack was 26 ms of the ~80 ms host share)."""
    iu0, iu1 = np.triu_indices(n_chan)
    tri_num = np.zeros((n_chan, n_chan), dtype=np.int64)
    tri_num[iu0, iu1] = np.arange(len(iu0))
    tri_num[iu1, iu0] = tri_num[iu0, iu1]
    il0, il1 = np.tril_indices(n_chan, -1)
    return tri_num.ravel(), (il0 * n_chan + il1)


def _make_triu_pack(n_chan, sign):
    """(pack, unpack) closures: device-side upper-triangle gather of the
    channel x channel block + host-side (anti)symmetric reconstruction —
    halves the result readback bytes losslessly (the matrix is Hermitian)."""
    iu0, iu1 = np.triu_indices(n_chan)
    flat_idx = (iu0 * n_chan + iu1).astype(np.int32)
    gather, lower_flat = _mirror_gather(n_chan)

    def pack(y):
        import jax.numpy as jnp

        flat = y.reshape(y.shape[:-2] + (n_chan * n_chan,))
        return jnp.take(flat, jnp.asarray(flat_idx), axis=-1)

    def unpack(packed):
        full = packed[..., gather]
        if sign != 1.0:
            full[..., lower_flat] *= packed.dtype.type(sign)
        return full.reshape(packed.shape[:-1] + (n_chan, n_chan))

    return pack, unpack


def _make_herm_pack(n_chan):
    """(pack, unpack) for a COMPLEX Hermitian matrix result (averaged CSD):
    upper triangle as a leading (re, im) pair on device, conjugate-mirrored
    reconstruction on host. Halves the complex readback bytes losslessly."""
    import jax.numpy as jnp

    iu0, iu1 = np.triu_indices(n_chan)
    flat_idx = (iu0 * n_chan + iu1).astype(np.int32)

    def pack(y):
        flat = y.reshape(y.shape[:-2] + (n_chan * n_chan,))
        tri = jnp.take(flat, jnp.asarray(flat_idx), axis=-1)
        return jnp.stack([jnp.real(tri), jnp.imag(tri)], axis=0)

    gather, lower_flat = _mirror_gather(n_chan)

    def unpack(packed):
        shape = packed.shape[1:-1] + (n_chan, n_chan)
        full = np.empty(shape, dtype=np.complex64)
        flat = full.reshape(packed.shape[1:-1] + (n_chan * n_chan,))
        flat.real = packed[0][..., gather]
        im = packed[1][..., gather]
        im[..., lower_flat] *= -1  # conjugate mirror on the lower triangle
        flat.imag = im
        return full

    return pack, unpack


def _digest_channelcmb(data, channelcmb):
    """Validate [senders, receivers] and return index arrays
    (reference connectivity_analysis.py:335-381)."""
    if not isinstance(data, SpectralData):
        raise SPYTypeError(
            data, "data", expected="SpectralData, `channelcmb` not supported for other data types"
        )
    if not isinstance(channelcmb, list) or len(channelcmb) != 2:
        raise SPYValueError(
            legal="list with exactly two elements: [senders, receivers]",
            varname="channelcmb",
            actual=str(channelcmb),
        )
    if data.selection is not None and data.selection.channel not in (slice(None), slice(None, None, 1)):
        raise SPYValueError("either channel selection or use channelcmb", "select/channelcmb", "both")
    senders, receivers = channelcmb
    sequence_parser(senders, varname="channelcmb[senders,")
    cmb_type = type(senders[0])
    if cmb_type not in (str, int) and not np.issubdtype(cmb_type, np.integer):
        raise SPYTypeError(senders[0], "channelcmb[senders,", "either `int` or `str`")
    labels = [str(c) for c in np.asarray(data.channel)]

    def to_idx(seq, name):
        idx = []
        for chan in seq:
            if isinstance(chan, str):
                if chan not in labels:
                    raise SPYValueError("names or indices of existing channels", "channelcmb", str(chan))
                idx.append(labels.index(chan))
            else:
                ichan = int(chan)
                if ichan < 0 or ichan >= len(labels):
                    raise SPYValueError("names or indices of existing channels", "channelcmb", str(chan))
                idx.append(ichan)
        return np.asarray(idx, dtype=int)

    return to_idx(senders, "senders"), to_idx(receivers, "receivers")


def _setup_cross_spectra(data, method, nSamples, foi, foilim, tapsmofrq, nTaper,
                         taper, taper_opt, polyremoval, lenTrials, log_dict,
                         cls=None):
    """Configure the implicit mtmfft+dyadic ST routine for AnalogData input
    (reference connectivity_analysis.py:775-872). `cls` picks the routine
    class (CrossSpectra or its fused-PPC subclass)."""
    from .ST_compRoutines import CrossSpectra

    if cls is None:
        cls = CrossSpectra

    foi, foilim = process_foi(foi, foilim, data.samplerate)
    if method == "granger" and (foi is not None or foilim is not None):
        raise SPYValueError(
            legal="no foi specification for Granger analysis", varname="foi/foilim",
            actual="foi or foilim specification",
        )
    if method == "granger":
        nChannels = len(data.channel)
        if nChannels / len(lenTrials) > 0.1:
            SPYWarning(
                "Multi-channel Granger analysis can be numerically unstable, it is "
                "recommended to have at least 10 times the number of trials compared "
                "to the number of channels. Try calculating in sub-groups of fewer channels!"
            )

    freqs = np.fft.rfftfreq(nSamples, 1 / data.samplerate)
    freq_idx = None
    if foi is not None:
        out_foi, freq_idx = best_match(freqs, foi, squash_duplicates=True)
    elif foilim is not None:
        out_foi, freq_idx = best_match(freqs, foilim, span=True)
    else:
        SPYInfo("Setting frequencies of interest to {:.1f}-{:.1f}Hz".format(freqs[0], freqs[-1]))
        out_foi = freqs

    taper, taper_opt = process_taper(
        taper, taper_opt, tapsmofrq, nTaper, keeptapers=False, foimax=out_foi.max(),
        samplerate=data.samplerate, nSamples=lenTrials.mean(), output="pow",
    )
    log_dict["foi"] = out_foi
    log_dict["taper"] = taper

    st = cls(
        samplerate=data.samplerate, nSamples=nSamples, taper=taper, taper_opt=taper_opt,
        demean_taper=(method == "granger"), polyremoval=polyremoval,
        freq_idx=freq_idx, foi=out_foi,
        # Granger needs a factorization-grade CSD (compensated DFT+Gram);
        # coherence is a normalized ratio where plain f32 spectra suffice
        exact_fft=(method == "granger"),
    )
    return st, out_foi


def _compute_ppc(st_out, parallel=None):
    """PPC from the single-trial cross-spectra via the streamed resultant
    identity (replaces reference connectivity_analysis.py:624-667): the
    engine accumulates unit cross-spectra chunk-wise on device — host RAM
    stays bounded by one chunk, and device-resident ST results never make
    a host round-trip."""
    from .AV_compRoutines import PPCReduction

    out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    cr = PPCReduction()
    cr.initialize(st_out, out._stackingDim, keeptrials=False)
    n_trials = cr.numTrials

    # PPC of a full dyadic CSD is symmetric real: pack the upper triangle
    # for readback (channelcmb-restricted senders x receivers are not)
    trial_shape = next(iter(cr.out_per_trial_shapes.values()))[0]
    pack = unpack = None
    if trial_shape[-1] == trial_shape[-2]:
        ci = [str(c) for c in np.asarray(st_out.channel_i)]
        cj = [str(c) for c in np.asarray(st_out.channel_j)]
        if ci == cj:
            pack, unpack = _make_triu_pack(trial_shape[-1], 1.0)

    cr.compute(
        st_out, out, parallel=parallel,
        log_dict={"method": "ppc", "nTrials": n_trials},
        post_device_fn=PPCReduction.make_post(n_trials), post_key=("ppc", n_trials),
        post_pack=pack, post_unpack=unpack,
    )
    out._log = str(st_out._log)
    out.log = "computed pairwise phase consistency over {} trials".format(n_trials)
    return out


def _granger_n_tapers(st_compRoutine):
    """Taper count of the ST stage (Kmax for dpss, else 1)."""
    t_opt = (getattr(st_compRoutine, "cfg", None) or {}).get("taper_opt")
    return int((t_opt or {}).get("Kmax", 1) or 1)


def _granger_rank_deficient(st_compRoutine, nTrials, st_out):
    """True when the trial-averaged CSD is singular by construction:
    each trial contributes rank <= nTapers per frequency, so
    nTrials * nTapers < nChannels has NO Wilson factorization (round-5
    256-ch forensics: 250 trials x 256 ch is indefinite with lam_min < 0,
    cond ~1.5e8; 300 trials conditions at ~470)."""
    n_chan = len(np.asarray(st_out.channel_i))
    return nTrials * _granger_n_tapers(st_compRoutine) < n_chan


def _granger_host_full(st_avg, av_routine):
    """Full-matrix Granger with host float64 factorization
    (fallback when JAX x64 is disabled). Handles time-resolved inputs
    (one factorization per sliding window)."""
    from ..ops.connectivity import granger_host, regularize_csd_host, wilson_sf_host

    cfg = av_routine.cfg
    csd_windows = np.asarray(st_avg.trials[0])  # (nTime, F, N, N)
    G = np.empty(csd_windows.shape, dtype=np.float32)
    convs, errs, factors, ini_cns = [], [], [], []
    for t in range(csd_windows.shape[0]):
        CSDreg, factor, ini_cn = regularize_csd_host(
            csd_windows[t], cond_max=cfg["cond_max"], eps_max=1e-1)
        H, Sigma, conv, err = wilson_sf_host(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
        G[t] = granger_host(CSDreg, H, Sigma).astype(np.float32)
        convs.append(bool(conv))
        errs.append(float(err))
        factors.append(float(factor))
        ini_cns.append(float(ini_cn))
    conv = all(convs)
    err = max(errs)
    factor = max(factors)
    ini_cn = max(ini_cns)

    out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    out.data = G
    out.samplerate = st_avg.samplerate
    out.trialdefinition = np.array([[0, float(G.shape[0]), 0]])
    out.channel_i = np.asarray(st_avg.channel_i)
    out.channel_j = np.asarray(st_avg.channel_j)
    out.freq = np.asarray(st_avg.freq)
    out.info["converged"] = bool(conv)
    out.info["max rel. err"] = float(err)
    out.info["reg. factor"] = float(factor)
    out.info["initial cond. num"] = float(ini_cn)
    out._log = str(st_avg._log)
    out.log = "computed Granger causality (host float64 factorization)"
    return out


def _granger_host_replicates(replicates_avg, av_routine):
    """Host float64 Granger for every jackknife replicate (fallback when a
    float32 device factorization of the leave-one-out CSDs diverges)."""
    from ..ops.connectivity import granger_host, regularize_csd_host, wilson_sf_host

    cfg = av_routine.cfg
    stacked, convs, errs = [], [], []
    for k in range(len(replicates_avg.trials)):
        csd = np.asarray(replicates_avg.trials[k])[0]  # (F, N, N)
        CSDreg, _, _ = regularize_csd_host(csd, cond_max=cfg["cond_max"], eps_max=1e-1)
        H, Sigma, conv, err = wilson_sf_host(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
        stacked.append(granger_host(CSDreg, H, Sigma).astype(np.float32)[None])
        convs.append(bool(conv))
        errs.append(float(err))

    jack_rep = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    jack_rep.data = np.concatenate(stacked, axis=0)
    jack_rep.samplerate = replicates_avg.samplerate
    n_rep = len(stacked)
    trl = np.zeros((n_rep, 3))
    trl[:, 0] = np.arange(n_rep)
    trl[:, 1] = trl[:, 0] + 1
    jack_rep.trialdefinition = trl
    jack_rep.channel_i = np.asarray(replicates_avg.channel_i)
    jack_rep.channel_j = np.asarray(replicates_avg.channel_j)
    jack_rep.freq = np.asarray(replicates_avg.freq)
    jack_rep.info["converged"] = bool(np.all(convs))
    jack_rep.info["max rel. err"] = float(np.max(errs)) if errs else float("nan")
    jack_rep._log = str(replicates_avg._log)
    jack_rep.log = "computed {} jackknife Granger replicates (host float64)".format(n_rep)
    return jack_rep


def _granger_pairwise(st_avg, send_idx, rec_idx, data, av_routine):
    """
    Pairwise Granger over (senders x receivers): one vmapped
    regularize+Wilson+Granger over all 2x2 pair-CSDs (replaces the
    reference's per-pair CR loop, connectivity_analysis.py:683-733).
    """
    from ..ops.connectivity import granger as granger_kernel
    from ..ops.connectivity import regularize_csd, wilson_sf

    from ..parallel.device_io import run_on_device

    csd_avg = np.asarray(st_avg.trials[0])[0]  # (F, N, N)
    cdtype = np.complex128 if jax.config.jax_enable_x64 else np.complex64
    pairs = np.array([(s, r) for s in send_idx for r in rec_idx])  # (P, 2)
    sub_np = csd_avg[:, pairs[:, :, None], pairs[:, None, :]]  # (F, P, 2, 2)
    sub_np = sub_np.transpose(1, 0, 2, 3).astype(cdtype)

    cfg = av_routine.cfg

    # the float32 device path (Wilson + compensated-residual refinement)
    # matches the float64 factorization to ~1e-6 — no host fallback needed
    def one_pair(CSD):
        CSDreg, _, _ = regularize_csd(CSD, cond_max=cfg["cond_max"], eps_max=1e-1)
        H, Sigma, conv, err = wilson_sf(CSDreg, nIter=cfg["nIter"], rtol=cfg["rtol"])
        G = granger_kernel(CSDreg, H, Sigma)
        return G[:, 0, 1], conv, err

    from ..ops.connectivity import wilson_env_fingerprint

    G_pairs, convs, errs = run_on_device(
        jax.vmap(one_pair), sub_np,
        key=("granger_pairs", cfg["rtol"], cfg["nIter"], cfg["cond_max"],
             wilson_env_fingerprint()),
    )
    G_pairs = np.asarray(G_pairs, dtype=np.float32)  # (P, F)
    result = G_pairs.reshape(len(send_idx), len(rec_idx), -1).transpose(2, 0, 1)[None]

    out = CrossSpectralData(dimord=list(CrossSpectralData._defaultDimord))
    out.data = result
    out.samplerate = st_avg.samplerate
    out.trialdefinition = np.array([[0, 1.0, 0]])
    out.channel_i = np.asarray(data.channel)[send_idx]
    out.channel_j = np.asarray(data.channel)[rec_idx]
    out.freq = np.asarray(st_avg.freq)
    out.info["converged"] = bool(np.all(np.asarray(convs)))
    out.info["max rel. err"] = float(np.max(np.asarray(errs)))
    out._log = str(st_avg._log)
    out.log = "computed pairwise Granger causality for {} pairs".format(len(pairs))
    return out
