# -*- coding: utf-8 -*-
#
# BASELINE config #5 AT SPEC, device-bound: Butterworth band-pass ->
# resample -> Hilbert -> multitaper spectra -> trial-averaged CSD ->
# coherence, 1024 channels x 10,000 trials, STREAMED in fixed-size
# chunks that never leave the chip.
#
# This measures what the spec workload costs once data is on the card
# (the 20.5 GB host ingest is left out). Trials are generated on device
# (AR(2), elementwise lax.scan) inside the same jitted chunk program,
# standing in for the ingest stream; the CSD accumulates across chunks
# in device memory and only the final (F, C, C) coherence is read back.
#
# The Granger stage of config #5 at 1024 channels (~17 GB of Wilson
# workspace) is left out; its mesh-sharded form is `wilson_sf_sharded`
# (doc/scaling.md).
#
# Reference scenario: BASELINE.json config #5; reference pipeline
# equivalents syncopy/preproc/compRoutines.py (but filter, resample,
# hilbert) + specest/mtmfft.py + connectivity/csd.py.

import time

import numpy as np


def run_config5_device(n_trials=10000, n_chan=1024, n_samples=1000, fs=1000.0,
                       chunk=125, seed=7):
    import jax
    import jax.numpy as jnp
    from scipy.signal import butter

    from syncopy_tpu.ops.filtering import downsample, hilbert, sosfiltfilt
    from syncopy_tpu.ops.windows import get_dpss_pars, make_tapers

    ds = 4                      # 1 kHz -> 250 Hz; the 30-100 Hz band-pass
    T2 = n_samples // ds        # doubles as the anti-alias filter
    F = T2 // 2 + 1
    sos = butter(4, [30.0, 100.0], btype="bandpass", fs=fs, output="sos")
    NW, Kmax = get_dpss_pars(2.0, T2, fs / ds)
    # numpy constant (NOT jnp.asarray): closure-captured device arrays are
    # embedded via a device->host readback at lowering time
    tapers = make_tapers("dpss", {"NW": NW, "Kmax": Kmax}, T2, T2, fs / ds)  # (K, T2)
    a1, a2 = 0.55, -0.8

    def one_trial(x):
        y = sosfiltfilt(sos, x)               # (T, C) band-pass, zero-phase
        y = downsample(y, ds)                 # (T2, C) @ 250 Hz
        z = hilbert(y)                        # analytic signal, complex64
        spec = jnp.fft.fft(tapers[:, :, None] * z[None, :, :], axis=1)[:, :F]
        return spec                           # (K, F, C)

    # the cross-chunk accumulator crosses the jit boundary every chunk as
    # a leading (re, im) float32 pair (project-wide convention, see
    # parallel/device_io.py)
    def chunk_step(key, acc):
        noise = jax.random.normal(key, (chunk, n_samples, n_chan), dtype=jnp.float32)

        def ar2(carry, eps):
            p1, p2 = carry
            cur = a1 * p1 + a2 * p2 + eps
            return (cur, p1), cur

        _, x = jax.lax.scan(
            ar2,
            (jnp.zeros((chunk, n_chan), jnp.float32),) * 2,
            jnp.swapaxes(noise, 0, 1),
        )
        x = jnp.swapaxes(x, 0, 1)             # (chunk, T, C)
        spec = jax.vmap(one_trial)(x)         # (chunk, K, F, C)
        csd = jnp.einsum("bkfi,bkfj->fij", spec, jnp.conj(spec)) / Kmax
        return acc + jnp.stack([jnp.real(csd), jnp.imag(csd)])

    step = jax.jit(chunk_step, donate_argnums=(1,))

    @jax.jit
    def coherence(acc):
        csd_av = jax.lax.complex(acc[0], acc[1]) / n_trials
        diag = jnp.abs(jnp.einsum("fii->fi", csd_av))
        return jnp.abs(csd_av) / jnp.sqrt(diag[:, :, None] * diag[:, None, :])

    n_chunks = n_trials // chunk
    if n_chunks < 1 or n_chunks * chunk != n_trials:
        raise ValueError(
            "n_trials ({}) must be a positive multiple of chunk ({})".format(
                n_trials, chunk
            )
        )
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)

    # compile both programs outside the timed window
    acc0 = jnp.zeros((2, F, n_chan, n_chan), dtype=jnp.float32)
    warm = step(keys[0], jnp.zeros_like(acc0))
    jax.block_until_ready(coherence(warm))
    del warm

    t0 = time.perf_counter()
    acc = acc0
    for k in range(n_chunks):
        acc = step(keys[k], acc)
    coh = coherence(acc)
    jax.block_until_ready(coh)
    wall = time.perf_counter() - t0

    coh_host = np.asarray(coh[:, :4, :4])     # spot-check readback only
    assert np.all(np.isfinite(coh_host)) and coh_host.max() <= 1.0 + 1e-5
    return {
        "config5_device": {
            "n_trials": n_trials, "n_chan": n_chan, "chunks": n_chunks,
            "wall_s": round(wall, 2),
            "trials_per_s": round(n_trials / wall, 1),
        }
    }
