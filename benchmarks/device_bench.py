# -*- coding: utf-8 -*-
#
# Device-bound benchmarks: isolate the card's KERNEL throughput from host
# work.
#
#   - inputs are GENERATED ON DEVICE (synthdata.ar2_network_device /
#     jax.random), never uploaded;
#   - outputs stay RESIDENT (timings end in jax.block_until_ready, results
#     are never fetched);
#   - the compute programs are the PRODUCTION kernels (the engine's
#     CrossSpectra.process_batch_sum fused CSD, ops.wavelet.cwt,
#     ops.connectivity regularize+wilson_sf+granger), jitted exactly as
#     the engine jits them.
#
# Reported per workload:
#   trials_per_s  — steady-state best-of-N wall-clock on the card
#   flops         — XLA's own cost-model count for one timed call
#                   (compiled.cost_analysis(); analytic fallback)
#   util_vs_peak  — flops/s divided by the card's published dense TF32
#                   tensor-core peak (PEAKS below)
#
# Scenario shapes mirror BASELINE.json: headline mtmfft+coherence
# (1000 trials x 64 ch x 1 s @ 1 kHz), wavelet TFR (config #2), device
# Granger (config #4 core).

import json
import os
import time

import numpy as np

#: published peaks per device kind (NVIDIA H100 SXM data sheet, dense,
#: at the full 700 W power limit): FLOP/s of the bf16 and TF32 tensor
#: cores and device-memory bytes/s. A device not listed is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_kind=None):
    """Peak table row of `device_kind` (default: the first device)."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError("no published peaks for device kind '{}'".format(device_kind))


def _cost_flops(jitted, *args):
    """XLA cost-model flop count for one call; None when unavailable."""
    return _cost_metrics(jitted, *args)[0]


def _cost_metrics(jitted, *args):
    """XLA cost-model (flops, bytes accessed) for one call; None when
    unavailable. "bytes accessed" counts every operand + output touch of
    every HLO — an upper bound on HBM traffic (fusion keeps some of it in
    registers/shared memory), so the memory roofline fraction derived from it is
    OPTIMISTIC about how close to the bandwidth wall the kernel runs."""
    try:
        cost = jitted.lower(*args).compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0] if cost else {}
        f = float(cost.get("flops", 0.0))
        b = float(cost.get("bytes accessed", 0.0))
        return (f if f > 0 else None), (b if b > 0 else None)
    except Exception:
        return None, None


def _roofline(dt, flops, bytes_):
    """Classify one timed kernel against the card's dual roofline.

    arithmetic intensity AI = flops/byte; ridge = peak FLOP/s over peak
    bytes/s: AI below the ridge means the BINDING limit is device-memory
    bandwidth, above it the tensor cores. `bound_frac` is the achieved
    fraction of the binding roofline; rows where both fractions are tiny
    AND the wall is micro-dispatch-short are latency-bound."""
    peaks = device_peaks()
    peak_flops, peak_bps = peaks["tf32_flops"], peaks["hbm_bytes_per_s"]
    out = {}
    fl = (flops or 0.0) / dt
    bw = (bytes_ or 0.0) / dt
    out["gflops_per_s"] = round(fl / 1e9, 1)
    out["gbytes_per_s"] = round(bw / 1e9, 1)
    out["util_vs_peak"] = round(fl / peak_flops, 4)
    out["util_vs_hbm"] = round(bw / peak_bps, 4)
    if not flops or not bytes_:
        out["bound"] = "unknown"
        out["bound_frac"] = None
        return out
    ridge = peak_flops / peak_bps
    ai = flops / bytes_
    out["arith_intensity"] = round(ai, 2)
    if ai >= ridge:
        out["bound"], out["bound_frac"] = "compute", out["util_vs_peak"]
    else:
        out["bound"], out["bound_frac"] = "memory", out["util_vs_hbm"]
    # a kernel achieving <15% of its binding roofline with a sub-5 ms wall
    # is dominated by per-dispatch/enqueue overheads, not the card
    if out["bound_frac"] < 0.15 and dt < 5e-3:
        out["bound"] = "latency"
    return out


def _time_best(fn, args, repeats=3):
    """Best-of-N steady-state wall-clock of one call (the first call,
    outside the window, compiles), each ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return max(min(times), 1e-9)


def _coherence_program(n_trials, n_samples, n_chan, samplerate=1000.0, tapsmofrq=2):
    """The headline kernel chain: fused multitaper CSD trial-sum (the
    engine's keeptrials=False fast path) + coherence normalization —
    identical math to connectivityanalysis(method='coh', tapsmofrq=2)."""
    import jax
    import jax.numpy as jnp

    from syncopy_tpu.connectivity.ST_compRoutines import CrossSpectra
    from syncopy_tpu.ops.connectivity import normalize_csd
    from syncopy_tpu.shared.input_processors import process_taper

    taper, taper_opt = process_taper(
        "hann", None, tapsmofrq, None, keeptapers=False,
        foimax=samplerate / 2, samplerate=samplerate, nSamples=n_samples,
        output="pow",
    )
    cr = CrossSpectra(samplerate=samplerate, nSamples=n_samples, taper=taper,
                      taper_opt=taper_opt, demean_taper=False, polyremoval=0)

    def step(x):
        n = jnp.asarray(x.shape[0], dtype=jnp.int32)
        cs_sum = cr.process_batch_sum(x, n, **cr.cfg)[0]
        return normalize_csd(cs_sum / x.shape[0], "abs")

    return jax.jit(step)


def _wavelet_program(scales, dt, n_samples):
    """Morlet TFR power for a trial batch (production ops.wavelet.cwt).
    On the direct-GEMM path the convolution bank crosses as a runtime
    argument (the engine's device-constant form) — returns (fn, args)
    with the bank device-put and bound."""
    import jax
    import jax.numpy as jnp

    from syncopy_tpu.ops.wavelet import Morlet, cwt, cwt_gemm_consts

    wav = Morlet(6)
    bank = cwt_gemm_consts(wav, scales, dt, n_samples)
    if bank:
        bank_d = tuple(jax.device_put(a) for a in bank)

        def step(x, br, bi):
            # production output='pow' path: fused power epilogue
            return jax.vmap(
                lambda t: cwt(t, wav, scales, dt, bank=(br, bi),
                              power_only=True))(x)

        return jax.jit(step), bank_d

    def step(x):  # (b, T, C) -> (b, S, T, C) float32 power, stays resident
        return jax.vmap(lambda t: jnp.abs(cwt(t, wav, scales, dt)) ** 2)(x)

    return jax.jit(step), ()


def _granger_program(n_trials, n_samples, n_chan, samplerate=1000.0):
    """All-device Granger: compensated double-f32 DFT + Gram CSD ->
    regularization -> f32 Wilson + compensated Newton -> Granger
    (identical math to connectivityanalysis(method='granger')).

    TWO programs with a device-array (re, im) handoff, NOT one fused jit:
    a fused program once miscompiled the Wilson while_loop with the CSD
    builder co-resident (exit at err ~1537 at 128 ch where the split
    program converged to 4e-8). The split mirrors the production engine's
    ST-program -> AV-program structure."""
    import jax
    import jax.numpy as jnp

    from syncopy_tpu.connectivity.ST_compRoutines import CrossSpectra
    from syncopy_tpu.ops.connectivity import granger, regularize_csd, wilson_sf

    cr = CrossSpectra(samplerate=samplerate, nSamples=n_samples, taper="hann",
                      taper_opt=None, demean_taper=True, polyremoval=0,
                      exact_fft=True)

    def build(x):
        n = jnp.asarray(x.shape[0], dtype=jnp.int32)
        csd_avg = cr.process_batch_sum(x, n, **cr.cfg)[0] / x.shape[0]
        csd_avg = csd_avg.astype(jnp.complex64)
        return jnp.real(csd_avg), jnp.imag(csd_avg)

    def factorize(re, im):
        CSD = (re + 1j * im).astype(jnp.complex64)
        CSDreg, _, _ = regularize_csd(CSD, cond_max=1e4, eps_max=1e-1)
        H, Sigma, conv, err = wilson_sf(CSDreg, nIter=100, rtol=5e-6)
        return granger(CSDreg, H, Sigma), conv, err

    build = jax.jit(build)
    factorize = jax.jit(factorize)

    def step(x):
        return factorize(*build(x))

    step.programs = (build, factorize)
    return step


def _flops_fft(batch_rows, n):
    """Analytic rfft flop estimate: 2.5 * n * log2(n) per row."""
    return 2.5 * batch_rows * n * np.log2(max(n, 2))


def _record(results, name, fn, args, n_items, repeats, flops=None, bytes_=None):
    """Compile, time, and record one device-bound row (roofline-tagged).
    `flops`/`bytes_` override the XLA cost model — required for Python
    chunk loops (`corr_run`/`ppc_run`), which are not a single lowerable
    program: pass the per-chunk `_cost_metrics` scaled by chunk count."""
    import jax

    jax.block_until_ready(fn(*args))
    dt = _time_best(fn, args, repeats)
    f, b = _cost_metrics(fn, *args)
    if flops is not None:
        f = flops
    if bytes_ is not None:
        b = bytes_
    results[name] = {
        "trials_per_s": round(n_items / dt, 1),
        "wall_s": round(dt, 4),
        "flops": f or 0.0,
    }
    results[name].update(_roofline(dt, f, b))
    return results[name]


def _matrix_workloads(x, results, repeats, n_trials, n_samples, n_chan, fs):
    """Device-bound rows for the remaining production kernels: corr (FFT
    cross-correlation), csd (per-trial CSD stack), ppc (streamed resultant
    reduction), mtmconvol (sliding-window spectrogram); reference scope benchmarks/benchmarks.py:8-81 + BASELINE
    configs #2/#3."""
    import jax
    import jax.numpy as jnp

    from syncopy_tpu.ops.connectivity import (
        cross_covariance_trial,
        cross_spectra_trial,
        normalize_ccov,
    )
    from syncopy_tpu.ops.stft import mtmconvol
    from syncopy_tpu.ops.windows import make_tapers

    # -- corr: trial-averaged cross-correlation (config #3 sibling), the
    # production fused keeptrials=False structure: frequency-domain trial
    # Gram per chunk (ccov_batch_sum) + 0-lag normalization. ---------------- #
    from syncopy_tpu.ops.connectivity import ccov_batch_sum

    corr_chunk = 500
    n_corr_chunks = max(n_trials // corr_chunk, 1)

    @jax.jit
    def corr_chunk_sum(xc):
        return ccov_batch_sum(xc, xc.shape[0])

    @jax.jit
    def corr_finalize(acc):
        return normalize_ccov(acc[None] / n_trials)

    def corr_run(x):
        acc = None
        for i in range(n_corr_chunks):
            s = corr_chunk_sum(x[i * corr_chunk : (i + 1) * corr_chunk])
            acc = s if acc is None else acc + s
        return corr_finalize(acc)

    corr_f, corr_b = _cost_metrics(corr_chunk_sum, x[:corr_chunk])
    _record(results, "corr_device", corr_run, (x,), n_trials, repeats,
            flops=(corr_f or 0.0) * n_corr_chunks,
            bytes_=(corr_b or 0.0) * n_corr_chunks or None)

    # -- csd: per-trial multitaper CSD stack kept resident (keeptrials=True
    # production path, method='csd'). Mirrors the engine's compiled program
    # tail: complex CSD + fused (re, im) boundary encode on axis=1, the
    # layout the production program emits (engine/routine.py::
    # _flatten_dev). ----------------------------------------------------- #
    csd_batch = 128

    @jax.jit
    def csd_stack(xb):
        cs = jax.vmap(
            lambda t: cross_spectra_trial(t, fs, n_samples, taper="hann")
        )(xb)
        return jnp.stack([cs.real, cs.imag], axis=1)

    _record(results, "csd_device", csd_stack, (x[:csd_batch],), csd_batch, repeats)

    # -- ppc: streamed resultant-vector reduction over single-trial CSDs
    # (the O(n) PPCReduction path replacing the reference's O(n^2) pair
    # loop, connectivity_analysis.py:624-667) ----------------------------- #
    # 500-trial chunks: without the per-trial CSD stack the workspace is
    # just the (B, K, F, C) spectra (~0.4 GB)
    ppc_chunk = 500
    n_ppc_chunks = max(n_trials // ppc_chunk, 1)

    # production fused structure (PPCSpectra.process_batch_sum): taper +
    # rfft + unit-phasor resultant (the Triton kernel on a GPU) — the
    # per-trial CSD stack never reaches device memory
    from syncopy_tpu.connectivity.ST_compRoutines import PPCSpectra

    ppc_cr = PPCSpectra(samplerate=fs, nSamples=n_samples, taper="hann",
                        taper_opt=None, demean_taper=False, polyremoval=0)

    @jax.jit
    def ppc_chunk_sum(xc):
        return ppc_cr.process_batch_sum(
            xc, jnp.asarray(xc.shape[0], jnp.int32), **ppc_cr.cfg)[0]

    @jax.jit
    def ppc_finalize(u_sum):
        power = (u_sum * jnp.conj(u_sum)).real
        return ((power - n_trials) / (n_trials * (n_trials - 1))).astype(jnp.float32)

    def ppc_run(x):
        acc = None
        for i in range(n_ppc_chunks):
            s = ppc_chunk_sum(x[i * ppc_chunk : (i + 1) * ppc_chunk])
            acc = s if acc is None else acc + s
        return ppc_finalize(acc)

    ppc_f, ppc_b = _cost_metrics(ppc_chunk_sum, x[:ppc_chunk])
    _record(results, "ppc_device", ppc_run, (x,), n_trials, repeats,
            flops=(ppc_f or 0.0) * n_ppc_chunks,
            bytes_=(ppc_b or 0.0) * n_ppc_chunks or None)

    # -- mtmconvol: sliding-window spectrogram, config #2 shape ----------- #
    nperseg = 250
    taps = jnp.asarray(make_tapers("hann", None, nperseg, nperseg, fs))
    centers = jnp.arange(nperseg // 2, n_samples - nperseg // 2 + 1, 50,
                         dtype=jnp.int32)
    mtm_trials = 500

    @jax.jit
    def mtmconvol_stack(xb):
        return jax.vmap(
            lambda t: mtmconvol(t, taps, centers, nperseg, output="pow",
                                keeptapers=False)
        )(xb)

    _record(results, "mtmconvol_device", mtmconvol_stack, (x[:mtm_trials],),
            mtm_trials, repeats)
    return results


def _jackknife_granger_row(results, repeats, n_trials=200, n_chan=16,
                           n_samples=1000, n_rep=32, fs=1000.0,
                           via="map"):
    """Device-bound jackknife Granger (config #4 core): LOO replicate CSDs
    factorized either through lax.map in ONE program (``via='map'``, the
    engine's sequential_batch path) or as one UNBATCHED program invoked
    per replicate (``via='unbatched'``, the engine's 1-row-chunk path) —
    both converge at 128 ch (round 4: 5.3e-7 both ways, ~12 s walls).
    NOTE rank: LOO CSDs need n_trials * n_tapers > n_chan or the CSD is
    singular and NO structure (device, host, any batching) can factorize
    it — the round-4 "scan diverges at 128 ch" scare was exactly a
    64-trial/128-ch singular CSD plus a bench-side LOO scaling bug.
    Reports replicates/s."""
    import jax
    import jax.numpy as jnp

    from syncopy_tpu.connectivity.ST_compRoutines import CrossSpectra
    from syncopy_tpu.ops.connectivity import granger, regularize_csd, wilson_sf
    from syncopy_tpu.synthdata import ar2_network_device

    adj = np.zeros((n_chan, n_chan), dtype=np.float32)
    adj[1, 0] = 0.25
    x = ar2_network_device(n_trials, AdjMat=adj, nSamples=n_samples, seed=7)
    jax.block_until_ready(x)

    cr = CrossSpectra(samplerate=fs, nSamples=n_samples, taper="hann",
                      taper_opt=None, demean_taper=True, polyremoval=0,
                      exact_fft=True)

    @jax.jit
    def build(x):
        n = jnp.asarray(x.shape[0], dtype=jnp.int32)
        # only the first n_rep replicates are factorized — materializing
        # the other per-trial CSDs would OOM at wide shapes (256 trials x
        # 128 ch is a 15.7 GB stack)
        per_trial = jax.vmap(
            lambda t: cr.process_single_trial(t, **cr.cfg)[0]
        )(x[:n_rep])  # (n_rep, F, C, C)
        # process_batch_sum returns the trial SUM (tapers averaged)
        total = cr.process_batch_sum(x, n, **cr.cfg)[0]
        loo = (total[None] - per_trial) / (x.shape[0] - 1)
        return jnp.real(loo), jnp.imag(loo)

    def one(args):
        CSD = (args[0] + 1j * args[1]).astype(jnp.complex64)
        CSDreg, _, _ = regularize_csd(CSD, cond_max=1e4, eps_max=1e-1)
        H, Sigma, conv, err = wilson_sf(CSDreg, nIter=100, rtol=5e-6)
        return granger(CSDreg, H, Sigma), conv, err

    if via == "map":
        # the production GrangerCausality.process_batch structure (round 5):
        # regularization parameters from ONE eigendecomposition of the
        # replicate mean, shared by every replicate (the per-replicate
        # eigvalsh was 73% of the factorization wall at 128 ch), with the
        # batched-Cholesky psd_topup safety lift; factorizations via
        # lax.map, NEVER vmap (the batched while_loop rewrite is the
        # platform miscompile)
        from syncopy_tpu.ops.connectivity import (
            apply_csd_reg, csd_reg_params, psd_topup,
        )

        @jax.jit
        def factorize_all(re, im):
            rows = (re + 1j * im).astype(jnp.complex64)
            psd_shift, eps, _ = csd_reg_params(
                rows.mean(axis=0), cond_max=1e4, eps_max=1e-1)

            def one_shared(CSD):
                CSDreg = psd_topup(apply_csd_reg(CSD, psd_shift, eps,
                                                 eps_max=1e-1))
                H, Sigma, conv, err = wilson_sf(CSDreg, nIter=100, rtol=5e-6)
                return granger(CSDreg, H, Sigma), conv, err

            return jax.lax.map(one_shared, rows)

    else:
        one_prog = jax.jit(one)

        def factorize_all(re, im):
            # one unbatched executable per replicate (the engine's 1-row
            # chunk structure): the ONLY structure verified to converge at
            # 128 ch — scan-wrapping the while_loop diverges there
            outs = [one_prog((re[i], im[i])) for i in range(re.shape[0])]
            return (jnp.stack([o[0] for o in outs]),
                    jnp.stack([o[1] for o in outs]),
                    jnp.stack([o[2] for o in outs]))

    re, im = build(x)
    jax.block_until_ready(re)
    G, conv, err = factorize_all(re, im)
    jax.block_until_ready(G)
    dt = _time_best(lambda a, b: factorize_all(a, b)[0], (re, im), repeats)
    row = {
        "replicates_per_s": round(n_rep / dt, 2),
        "wall_s": round(dt, 4),
        "n_replicates": n_rep,
        "n_chan": n_chan,
        "via": via,
        "all_converged": bool(np.asarray(jax.device_get(jnp.all(conv)))),
        "max_rel_err": float(np.asarray(jax.device_get(jnp.max(err)))),
    }
    results["granger_jackknife{}_device".format(n_chan)] = row
    return row


def _extended_workloads(x, results, repeats, n_trials, n_samples, n_chan, fs):
    """Optional additional device-bound rows (bench.py --device-only --full):
    welch, superlet TFR, and a FIR band-pass -> hilbert-envelope -> PSD
    pipeline — all production kernels, all resident."""
    import jax
    import jax.numpy as jnp

    from syncopy_tpu.ops.filtering import apply_fir, design_wsinc, hilbert
    from syncopy_tpu.ops.stft import mtmconvol
    from syncopy_tpu.ops.wavelet import superlet
    from syncopy_tpu.ops.windows import make_tapers

    # -- welch: segment-averaged periodogram, fused on device ------------ #
    nperseg = 256
    tapers = jnp.asarray(make_tapers("hann", None, nperseg, nperseg, fs))
    centers = jnp.arange(0, n_samples, nperseg // 2, dtype=jnp.int32)

    def welch_step(batch):
        def one(tr):
            spec = mtmconvol(tr, tapers, centers, nperseg, output="pow",
                             keeptapers=False)
            return jnp.mean(spec, axis=0)

        return jax.vmap(one)(batch)

    fn = jax.jit(welch_step)
    jax.block_until_ready(fn(x))
    dt = _time_best(fn, (x,), repeats)
    flops, nbytes = _cost_metrics(fn, x)
    results["welch_device"] = {
        "trials_per_s": round(n_trials / dt, 1), "wall_s": round(dt, 4),
        "flops": flops or 0.0,
    }
    results["welch_device"].update(_roofline(dt, flops, nbytes))

    # -- superlet TFR (config #2 sibling); the scale-scanned kernel keeps
    # one (b, nOrders, L, C) block live, so the batch can be wide -------- #
    foi = np.linspace(10.0, 100.0, 15)
    scales = (1.0 / foi) / (2 * np.pi)
    xb = x[:64]

    from syncopy_tpu.ops.wavelet import superlet_gemm_consts

    sl_bank = superlet_gemm_consts(np.asarray(scales), 5, 1, 3, False,
                                   1.0 / fs, n_samples)
    sl_bank_d = tuple(jax.device_put(a) for a in sl_bank)

    def sl_step(batch, *bank):
        # production output='pow' path: magnitude-only kernel (real
        # log/exp order accumulation), squared; on the GEMM path the
        # pair bank crosses as a runtime operand (device-constant form)
        return jax.vmap(
            lambda tr: superlet(tr, np.asarray(scales), order_max=5,
                                dt=1.0 / fs, magnitude_only=True,
                                bank=bank if bank else None) ** 2
        )(batch)

    fn = jax.jit(sl_step)
    jax.block_until_ready(fn(xb, *sl_bank_d))
    dt = _time_best(fn, (xb,) + sl_bank_d, repeats)
    flops, nbytes = _cost_metrics(fn, xb, *sl_bank_d)
    results["superlet_device"] = {
        "trials_per_s": round(xb.shape[0] / dt, 1), "wall_s": round(dt, 4),
        "flops": flops or 0.0,
    }
    results["superlet_device"].update(_roofline(dt, flops, nbytes))

    # -- preproc pipeline: FIR bp -> hilbert envelope -> mean PSD -------- #
    kernel = jnp.asarray(design_wsinc("hamming", 400, (8.0 / fs, 12.0 / fs), "bp"))

    def pipe_step(batch):
        def one(tr):
            y = apply_fir(tr, kernel)
            env = jnp.abs(hilbert(y))
            spec = jnp.fft.rfft(env, axis=0)
            return jnp.mean(jnp.abs(spec) ** 2, axis=1)

        return jax.vmap(one)(batch)

    fn = jax.jit(pipe_step)
    jax.block_until_ready(fn(x))
    dt = _time_best(fn, (x,), repeats)
    flops, nbytes = _cost_metrics(fn, x)
    results["preproc_pipeline_device"] = {
        "trials_per_s": round(n_trials / dt, 1), "wall_s": round(dt, 4),
        "flops": flops or 0.0,
    }
    results["preproc_pipeline_device"].update(_roofline(dt, flops, nbytes))

    # -- corr at the reference's config #3 shape (128 ch x 500 trials):
    # the reference headline is ~64 trials/s warm (BASELINE.md) ----------- #
    from syncopy_tpu.ops.connectivity import ccov_batch_sum, normalize_ccov
    from syncopy_tpu.synthdata import ar2_network_device

    adj128 = np.zeros((128, 128), dtype=np.float32)
    adj128[1, 0] = 0.25
    x128 = ar2_network_device(500, AdjMat=adj128, nSamples=n_samples, seed=5)
    jax.block_until_ready(x128)
    c128_chunk = 250

    @jax.jit
    def c128_sum(xc):
        return ccov_batch_sum(xc, xc.shape[0])

    @jax.jit
    def c128_fin(acc):
        return normalize_ccov(acc[None] / 500)

    def c128_run(xa):
        acc = None
        for i in range(500 // c128_chunk):
            s = c128_sum(xa[i * c128_chunk : (i + 1) * c128_chunk])
            acc = s if acc is None else acc + s
        return c128_fin(acc)

    c128_f, c128_b = _cost_metrics(c128_sum, x128[:c128_chunk])
    _record(results, "corr128_device", c128_run, (x128,), 500, repeats,
            flops=(c128_f or 0.0) * (500 // c128_chunk),
            bytes_=(c128_b or 0.0) * (500 // c128_chunk) or None)
    return results


def run_device_bench(repeats=3, n_trials=1000, n_samples=1000, n_chan=64,
                     wavelet_trials=512, wavelet_batch=64, n_scales=30,
                     full=False):
    """Run the three device-bound workloads; returns {name: metrics}."""
    import jax

    from syncopy_tpu.ops.wavelet import Morlet
    from syncopy_tpu.synthdata import ar2_network_device

    fs = 1000.0
    results = {}

    adj = np.zeros((n_chan, n_chan), dtype=np.float32)
    adj[1, 0] = 0.25
    x = ar2_network_device(n_trials, AdjMat=adj, nSamples=n_samples, seed=7)
    jax.block_until_ready(x)

    # -- headline: multitaper CSD + coherence -------------------------- #
    coh = _coherence_program(n_trials, n_samples, n_chan, samplerate=fs)
    jax.block_until_ready(coh(x))  # compile
    dt_best = _time_best(coh, (x,), repeats)
    flops, nbytes = _cost_metrics(coh, x)
    if flops is None:
        K, F = 3, n_samples // 2 + 1
        flops = (_flops_fft(n_trials * K * n_chan, n_samples)
                 + 8.0 * n_trials * K * F * n_chan * n_chan)
    results["coh_device"] = {
        "trials_per_s": round(n_trials / dt_best, 1),
        "wall_s": round(dt_best, 4),
        "flops": flops,
    }
    results["coh_device"].update(_roofline(dt_best, flops, nbytes))

    # -- wavelet TFR (config #2 core), batched ------------------------- #
    foi = np.linspace(10.0, 150.0, n_scales)
    scales = Morlet(6).scale_from_period(1.0 / foi)
    wav, wav_bank = _wavelet_program(np.asarray(scales), 1.0 / fs, n_samples)
    xb = x[:wavelet_batch]
    jax.block_until_ready(wav(xb, *wav_bank))  # compile
    n_batches = max(wavelet_trials // wavelet_batch, 1)

    def tfr_sweep(xb):
        last = None
        for _ in range(n_batches):
            last = wav(xb, *wav_bank)
        return last

    # tfr_sweep already enqueues n_batches executions per call (its own
    # amortization) and each queues a ~0.5 GB result buffer — never let
    # _time_best multiply that queue (max_inner=1)
    dt_best = _time_best(tfr_sweep, (xb,), repeats, max_inner=1)
    per_call, per_bytes = _cost_metrics(wav, xb, *wav_bank)
    if per_call is None:
        L = 2048  # next_fast_len(2 * n_samples) conv length
        per_call = (_flops_fft(wavelet_batch * n_chan, L)
                    + _flops_fft(wavelet_batch * n_chan * n_scales, L) * 2
                    + 6.0 * wavelet_batch * n_scales * L * n_chan)
    flops = per_call * n_batches
    results["wavelet_tfr_device"] = {
        "trials_per_s": round(n_batches * wavelet_batch / dt_best, 1),
        "wall_s": round(dt_best, 4),
        "flops": flops,
    }
    results["wavelet_tfr_device"].update(
        _roofline(dt_best, flops, per_bytes * n_batches if per_bytes else None))

    # -- Granger (config #4 core): CSD + Wilson + Granger --------------- #
    gr = _granger_program(n_trials, n_samples, n_chan, samplerate=fs)
    G, conv, err = gr(x)
    jax.block_until_ready(G)  # compile
    dt_best = _time_best(lambda x: gr(x)[0], (x,), repeats)
    build_prog, factor_prog = gr.programs
    flops_build, bytes_build = _cost_metrics(build_prog, x)
    flops_factor, bytes_factor = _cost_metrics(factor_prog, *build_prog(x))
    flops = (flops_build + flops_factor
             if flops_build is not None and flops_factor is not None else None)
    nbytes = (bytes_build + bytes_factor
              if bytes_build is not None and bytes_factor is not None else None)
    if flops is None:
        F = n_samples // 2 + 1
        # dominated by the sliced exact Gram (~9x a plain f32 einsum)
        flops = 9.0 * 8.0 * n_trials * F * n_chan * n_chan
    results["granger_device"] = {
        "trials_per_s": round(n_trials / dt_best, 1),
        "wall_s": round(dt_best, 4),
        "flops": flops,
        "converged": bool(np.asarray(conv)),
        "max_rel_err": float(np.asarray(err)),
    }
    results["granger_device"].update(_roofline(dt_best, flops, nbytes))

    # remaining production-kernel rows (corr/csd/ppc/mtmconvol) + the
    # lax.map jackknife factorization — part of the DEFAULT matrix
    _matrix_workloads(x, results, repeats, n_trials, n_samples, n_chan, fs)
    _jackknife_granger_row(results, repeats)

    # -- Granger at the 128-channel north-star width -------------------- #
    # (post vmap-bypass + program-split fixes this converges on-device;
    # round 5: the Cholesky-bisection regularization — SPY_TPU_FAST_REG,
    # auto at >=96 ch — took the factorization 2.38 s -> 0.72 s, so the
    # row is cheap enough for the DEFAULT matrix)
    adj128 = np.zeros((128, 128), dtype=np.float32)
    adj128[1, 0] = 0.25
    x128 = ar2_network_device(n_trials, AdjMat=adj128,
                              nSamples=n_samples, seed=7)
    jax.block_until_ready(x128)
    gr = _granger_program(n_trials, n_samples, 128, samplerate=fs)
    G, conv, err = gr(x128)
    jax.block_until_ready(G)
    dt_best = _time_best(lambda x: gr(x)[0], (x128,), repeats)
    build_prog, factor_prog = gr.programs
    fb, bb = _cost_metrics(build_prog, x128)
    ff, bf = _cost_metrics(factor_prog, *build_prog(x128))
    flops = fb + ff if fb is not None and ff is not None else None
    nbytes = bb + bf if bb is not None and bf is not None else None
    if flops is None:
        F = n_samples // 2 + 1
        flops = 9.0 * 8.0 * n_trials * F * 128 * 128
    results["granger128_device"] = {
        "trials_per_s": round(n_trials / dt_best, 1),
        "wall_s": round(dt_best, 4),
        "flops": flops,
        "converged": bool(np.asarray(conv)),
        "max_rel_err": float(np.asarray(err)),
    }
    results["granger128_device"].update(_roofline(dt_best, flops, nbytes))
    del x128

    if full:
        _extended_workloads(x, results, repeats, n_trials, n_samples, n_chan, fs)

        # -- wide-channel jackknife: 128-ch LOO replicates through the
        # engine's lax.map sequential_batch structure, NO host fallback in
        # the loop — proves the hazardous shape runs on-device end to end.
        # 256 trials: LOO CSDs must be full-rank (n_trials > n_chan) ------ #
        _jackknife_granger_row(results, repeats=1, n_trials=256, n_chan=128,
                               n_samples=n_samples, n_rep=4, via="map")

        # -- 256-channel probe at 2x the north-star width. 320 trials x 1
        # hann taper: the CSD must be FULL RANK (nTrials*nTapers > nChan).
        # The round-4 probe ran 250 trials — rank <= 250 < 256, i.e. the
        # CSD was indefinite by construction (lam_min < 0, cond ~1.5e8 vs
        # ~470 at 300 trials, CPU forensics in BASELINE.md round 5) and
        # its divergence was mislabeled "platform limit". The frontend now
        # gates such shapes to host f64 (connectivity_analysis.py
        # _granger_rank_deficient). ---------------------------------------- #
        n256 = 320
        adj256 = np.zeros((256, 256), dtype=np.float32)
        adj256[1, 0] = 0.25
        x256 = ar2_network_device(n256, AdjMat=adj256, nSamples=n_samples, seed=7)
        jax.block_until_ready(x256)
        gr256 = _granger_program(n256, n_samples, 256, samplerate=fs)
        G, conv, err = gr256(x256)
        jax.block_until_ready(G)
        dt_best = _time_best(lambda x: gr256(x)[0], (x256,), 1)
        results["granger256_device"] = {
            "trials_per_s": round(n256 / dt_best, 1),
            "wall_s": round(dt_best, 4),
            "n_trials": n256,
            "converged": bool(np.asarray(conv)),
            "max_rel_err": float(np.asarray(err)),
        }

    return results


def main(full=False):
    res = run_device_bench(full=full)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    import sys

    main(full="--full" in sys.argv)
