# -*- coding: utf-8 -*-
# Full-pipeline integration (BASELINE.md config #5, scaled):
# Butterworth filter -> resample -> Hilbert envelope -> mtmfft + Granger.

import numpy as np
import pytest

import syncopy_tpu as spy


class TestFullPipeline:
    def test_filter_resample_hilbert_spectrum_granger(self):
        # AR(2) network with 40 Hz resonance @ 200 Hz, upsampled scenario
        data = spy.synthdata.ar2_network(nTrials=60, samplerate=200, nSamples=2000, seed=7)

        filt = spy.preprocessing(data, filter_class="but", filter_type="bp", freq=[25, 55])
        rs = spy.resampledata(filt, method="downsample", resamplefs=100)
        assert rs.samplerate == 100
        assert np.asarray(rs.trials[0]).shape[0] == 1000

        env = spy.preprocessing(rs, filter_class="but", filter_type="lp", freq=45, hilbert="abs")
        assert np.all(np.asarray(env.data) >= 0)

        spec = spy.freqanalysis(rs, method="mtmfft", tapsmofrq=2, keeptrials=False)
        arr = np.asarray(spec.data)[0, 0, :, 0]
        peak = spec.freq[np.argmax(arr[5:]) + 5]
        assert 30 <= peak <= 50  # band-limited around the resonance

        gr = spy.connectivityanalysis(rs, method="granger")
        garr = np.asarray(gr.data)
        f40 = np.argmin(np.abs(gr.freq - 40))
        assert garr[0, f40, 1, 0] > garr[0, f40, 0, 1]  # direction preserved

        # provenance chain recorded end to end
        assert "preprocessing" in rs.cfg
        assert "resampledata" in rs.cfg
        assert "connectivityanalysis" in gr.cfg

    def test_pipeline_on_mesh(self, testmesh):
        data = spy.synthdata.ar2_network(nTrials=16, samplerate=200, nSamples=500, seed=8)
        with spy.use_mesh(testmesh):
            filt = spy.preprocessing(data, filter_class="firws", filter_type="lp", freq=60, order=200)
            coh = spy.connectivityanalysis(filt, method="coh", tapsmofrq=3)
        filt_seq = spy.preprocessing(data, filter_class="firws", filter_type="lp", freq=60, order=200)
        coh_seq = spy.connectivityanalysis(filt_seq, method="coh", tapsmofrq=3)
        assert np.allclose(np.asarray(coh.data), np.asarray(coh_seq.data), atol=1e-5)


class TestConfig5DeviceProgram:
    """The streamed at-spec config-#5 benchmark program (scaled down):
    correctness properties the full-size run on the card relies on."""

    def test_smoke_and_determinism(self):
        from benchmarks.config5_device import run_config5_device

        r1 = run_config5_device(n_trials=8, n_chan=6, n_samples=400, chunk=4, seed=3)
        r2 = run_config5_device(n_trials=8, n_chan=6, n_samples=400, chunk=4, seed=3)
        assert r1["config5_device"]["chunks"] == 2
        assert r1["config5_device"]["wall_s"] >= 0

    def test_coherence_properties(self):
        """Accumulated-CSD coherence: unit diagonal, bounded off-diagonal,
        and the band-pass kills out-of-band power."""
        import jax
        import jax.numpy as jnp
        from scipy.signal import butter

        from syncopy_tpu.ops.filtering import downsample, hilbert, sosfiltfilt
        from syncopy_tpu.ops.windows import get_dpss_pars, make_tapers

        fs, T, ds = 1000.0, 800, 4
        T2, F = T // ds, T // ds // 2 + 1
        sos = butter(4, [30.0, 100.0], btype="bandpass", fs=fs, output="sos")
        NW, Kmax = get_dpss_pars(2.0, T2, fs / ds)
        tapers = jnp.asarray(make_tapers("dpss", {"NW": NW, "Kmax": Kmax}, T2, T2, fs / ds))

        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(size=(24, T, 3)).astype("f4"))

        def one(tr):
            y = downsample(sosfiltfilt(sos, tr), ds)
            z = hilbert(y)
            return jnp.fft.fft(tapers[:, :, None] * z[None], axis=1)[:, :F]

        spec = jax.vmap(one)(x)
        csd = np.asarray(jnp.einsum("bkfi,bkfj->fij", spec, jnp.conj(spec))) / (24 * Kmax)
        diag = np.abs(np.einsum("fii->fi", csd))
        coh = np.abs(csd) / np.sqrt(diag[:, :, None] * diag[:, None, :] + 1e-30)
        freqs = np.arange(F) * (fs / ds) / T2
        inband = (freqs > 35) & (freqs < 95)
        outband = freqs < 20
        assert np.allclose(coh[inband, 0, 0], 1.0, atol=1e-5)
        assert coh[inband].max() <= 1.0 + 1e-5
        # the band-pass (doubling as anti-alias filter) kills out-of-band power
        assert diag[inband].mean() > 50 * diag[outband].mean()


class TestProfiler:
    def test_profile_context(self, tmp_path, adata_equal):
        with spy.profile(str(tmp_path / "traces")):
            spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        import os

        assert any(os.scandir(str(tmp_path / "traces")))

    def test_timer(self):
        with spy.Timer() as t:
            sum(range(1000))
        assert t.seconds >= 0
