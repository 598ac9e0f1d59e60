# -*- coding: utf-8 -*-
# Connectivity tests (modeled on reference tests/test_connectivity.py and
# tests/backend/test_conn.py): AR(2) network ground truth for coherence and
# Granger, cross-correlation sanity, PPC, channelcmb, jackknife.

import os

import numpy as np
import pytest

import syncopy_tpu as spy


@pytest.fixture(scope="module")
def ar2_data():
    # Dhamala 2008 setup: 40 Hz peak at 200 Hz sampling, channel 1 drives
    # channel 0 (AdjMat[1, 0] = 0.25 with the M1 = diag + AdjMat.T recursion)
    return spy.synthdata.ar2_network(nTrials=120, samplerate=200, nSamples=1000, seed=42)


class TestCoherence:
    def test_ar2_coherence_peak(self, ar2_data):
        coh = spy.connectivityanalysis(ar2_data, method="coh", tapsmofrq=3)
        assert coh.dimord == ["time", "freq", "channel_i", "channel_j"]
        arr = np.asarray(coh.data)
        peak_freq = coh.freq[np.argmax(arr[0, :, 0, 1])]
        assert abs(peak_freq - 40) < 5
        assert arr[0, :, 0, 1].max() > 0.5
        # diagonal is 1 (auto-coherence)
        assert np.allclose(arr[0, :, 0, 0], 1.0, atol=1e-5)

    def test_outputs(self, ar2_data):
        for output in ("abs", "pow", "imag", "angle"):
            coh = spy.connectivityanalysis(ar2_data, method="coh", tapsmofrq=3, output=output)
            assert np.isrealobj(np.asarray(coh.data))
        cplx = spy.connectivityanalysis(ar2_data, method="coh", tapsmofrq=3, output="complex")
        assert np.iscomplexobj(np.asarray(cplx.data))

    def test_uncoupled_low_coherence(self):
        data = spy.synthdata.white_noise(nTrials=60, nSamples=500, nChannels=2, seed=0)
        coh = spy.connectivityanalysis(data, method="coh", tapsmofrq=4)
        arr = np.asarray(coh.data)
        assert arr[0, 5:, 0, 1].mean() < 0.25

    def test_jackknife(self, ar2_data):
        coh = spy.connectivityanalysis(ar2_data, method="coh", tapsmofrq=3, jackknife=True)
        var = np.asarray(coh._get_extra_dataset("jack_var"))
        bias = np.asarray(coh._get_extra_dataset("jack_bias"))
        assert var.shape == coh.data.shape
        assert np.all(var >= 0)
        # jackknife variance should be small for 120 trials
        assert var[0, :, 0, 1].max() < 0.1
        assert np.abs(bias[0, :, 0, 1]).max() < 0.2


class TestGranger:
    def test_ar2_directionality(self, ar2_data):
        gr = spy.connectivityanalysis(ar2_data, method="granger")
        arr = np.asarray(gr.data)
        f40 = np.argmin(np.abs(gr.freq - 40))
        # channel 1 drives channel 0
        assert arr[0, f40, 1, 0] > 0.5
        assert arr[0, f40, 0, 1] < 0.1
        assert gr.info["converged"]
        assert gr.info["max rel. err"] < 5e-6

    def test_granger_rejects_foi(self, ar2_data):
        with pytest.raises(spy.SPYValueError):
            spy.connectivityanalysis(ar2_data, method="granger", foi=[10, 20])

    @pytest.mark.skipif(os.environ.get("SPY_TEST_NO_X64") == "1",
                        reason="float64 oracle required")
    def test_vs_reference_wilson(self):
        """Wilson factorization + Granger match the reference backend."""
        import importlib.util

        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import granger as jgranger
        from syncopy_tpu.ops.connectivity import wilson_sf as jwilson

        spec = importlib.util.spec_from_file_location(
            "ref_wilson", "/root/reference/syncopy/connectivity/wilson_sf.py"
        )
        rw = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(spec and rw)
        spec2 = importlib.util.spec_from_file_location(
            "ref_granger", "/root/reference/syncopy/connectivity/granger.py"
        )
        rg = importlib.util.module_from_spec(spec2)
        spec2.loader.exec_module(rg)

        rng = np.random.default_rng(7)
        X = rng.normal(size=(50, 101, 3)) + 1j * rng.normal(size=(50, 101, 3))
        CSD = np.einsum("nfi,nfj->fij", X, np.conj(X)).astype(np.complex128) / 50

        H_ref, S_ref, conv_ref, err_ref = rw.wilson_sf(CSD.copy(), nIter=100, rtol=1e-9)
        H, S, conv, err = jwilson(jnp.asarray(CSD), nIter=100, rtol=1e-9)
        assert bool(conv) == bool(conv_ref)
        assert np.abs(np.asarray(H) - H_ref).max() < 1e-10
        G_ref = rg.granger(CSD, H_ref, S_ref)
        G = jgranger(jnp.asarray(CSD), H, S)
        assert np.abs(np.asarray(G) - G_ref).max() < 1e-10


class TestWilsonFloat32Refined:
    """The float32 device Wilson path (compensated-residual Newton
    refinement, ops/connectivity.py::_wilson_refine) must converge to the
    reference rtol and match the float64 factorization to ~1e-6 on the
    final Granger output — this is the production device path (float32)."""

    def _avg_csd(self, nChannels=8, nTrials=60, nSamples=400, seed=13):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import cross_spectra_trial

        adj = spy.synthdata.mk_RandomAdjMat(
            nChannels, conn_thresh=0.8, max_coupling=0.15, seed=seed
        )
        adj = adj / max(1.0, 3 * np.abs(np.linalg.eigvals(adj)).max())
        ad = spy.synthdata.ar2_network(AdjMat=adj, nTrials=nTrials, nSamples=nSamples, seed=seed)
        acc = None
        for k in range(len(ad.trials)):
            cs = np.asarray(
                cross_spectra_trial(
                    jnp.asarray(np.asarray(ad.trials[k], dtype=np.float64)),
                    1000.0, nSamples, taper="hann",
                )
            )[0]
            acc = cs.astype(np.complex128) if acc is None else acc + cs
        return acc / nTrials

    def test_f32_matches_f64(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import (
            granger, granger_host, regularize_csd_host, wilson_sf, wilson_sf_host,
        )

        CSD = self._avg_csd()
        CSDreg, _, _ = regularize_csd_host(CSD, cond_max=1e4, eps_max=1e-1)
        H64, S64, conv64, err64 = wilson_sf_host(CSDreg, nIter=100, rtol=5e-6)
        G64 = granger_host(CSDreg, H64, S64)

        C32 = jnp.asarray(CSDreg.astype(np.complex64))
        H32, S32, conv32, err32 = wilson_sf(C32, nIter=100, rtol=5e-6)
        assert bool(conv32), "refined f32 Wilson did not converge"
        assert float(err32) < 5e-6
        G32 = np.asarray(granger(C32, H32, S32))
        assert np.abs(G32 - G64).max() < 1e-6
        assert np.abs(np.asarray(S32) - S64).max() / np.abs(S64).max() < 1e-5

    @pytest.mark.skipif(os.environ.get("SPY_TEST_NO_X64") == "1",
                        reason="float64 oracle required")
    def test_f32_regularize_matches_host(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import regularize_csd, regularize_csd_host

        CSD = self._avg_csd(nChannels=6, nTrials=8)  # few trials: ill-conditioned
        Creg_h, eps_h, ini_h = regularize_csd_host(CSD, cond_max=1e3, eps_max=1e-1)
        Creg_d, eps_d, ini_d = regularize_csd(jnp.asarray(CSD), cond_max=1e3, eps_max=1e-1)
        assert abs(float(ini_d) - ini_h) / ini_h < 1e-3
        if eps_h > 0:
            assert float(eps_d) > 0
            assert abs(float(eps_d) - eps_h) / eps_h < 1e-6
        assert np.abs(np.asarray(Creg_d) - Creg_h).max() < 1e-10

    def test_gforce_excluded_bins(self, monkeypatch):
        """Demeaned-DC CSDs: the f32 path substitutes the exact fixed-point
        update factor (g + I = 2I) at excluded near-zero-power bins instead
        of computing it from a near-singular factorization. The result must
        converge and match the plain f64 host factorization away from the
        excluded bin (the DC-adjacent bins depend on accumulation-rounding
        noise in the plain iteration — see ops/connectivity.py)."""
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import (
            granger, granger_host, wilson_sf, wilson_sf_host,
        )
        from syncopy_tpu.ops.connectivity import cross_spectra_trial

        nSamples, nTrials = 256, 80
        ad = spy.synthdata.ar2_network(nTrials=nTrials, nSamples=nSamples, seed=21)
        acc = None
        for k in range(nTrials):
            cs = np.asarray(cross_spectra_trial(
                jnp.asarray(np.asarray(ad.trials[k], dtype=np.float64)),
                1000.0, nSamples, taper="hann", demean_taper=True))[0]
            acc = cs.astype(np.complex128) if acc is None else acc + cs
        CSD = acc / nTrials
        # the demeaned DC bin must actually be excluded for this test to bite
        dpow = np.abs(np.einsum("fii->fi", CSD)).mean(axis=1)
        assert dpow[0] < 1e-9 * dpow.max()

        H64, S64, c64, e64 = wilson_sf_host(CSD, nIter=100, rtol=5e-6)
        G64 = granger_host(CSD, H64, S64)

        C32 = jnp.asarray(CSD.astype(np.complex64))
        monkeypatch.setenv("SPY_TPU_WILSON_GFORCE", "1")
        H32, S32, c32, e32 = wilson_sf(C32, nIter=100, rtol=5e-6)
        assert bool(c32), float(e32)
        G32 = np.asarray(granger(C32, H32, S32))
        # bulk bins: the one-bin substitution carries ~1/M lag-domain
        # weight (M = 256 here), i.e. an O(1e-3) perturbation — far below
        # the 80-trial estimator noise (~0.1)
        assert np.abs(G32[20:] - G64[20:]).max() < 3e-3
        # DC-proximal bins: bounded by the measured ~1e-2 noise sensitivity
        assert np.nanmax(np.abs(G32[1:20] - G64[1:20])) < 5e-2
        # the physics is untouched: same 1 -> 0 peak height
        assert abs(G32[:, 1, 0].max() - G64[:, 1, 0].max()) < 5e-3

        # the escape hatch restores the plain iteration
        monkeypatch.setenv("SPY_TPU_WILSON_GFORCE", "0")
        H32p, S32p, c32p, e32p = wilson_sf(C32, nIter=100, rtol=5e-6)
        assert bool(c32p), float(e32p)
        G32p = np.asarray(granger(C32, H32p, S32p))
        assert np.abs(G32p[20:] - G64[20:]).max() < 3e-3

    def test_compensated_residual_accuracy(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import _csd_residual_df32

        rng = np.random.default_rng(2)
        L, N = 200, 8
        P = (rng.normal(size=(L, N, N)) + 1j * rng.normal(size=(L, N, N))).astype(np.complex64)
        S64 = P.astype(np.complex128) @ np.conj(np.swapaxes(P.astype(np.complex128), 1, 2))
        S32 = S64.astype(np.complex64)
        Rr, Ri = _csd_residual_df32(
            jnp.real(jnp.asarray(S32)), jnp.imag(jnp.asarray(S32)),
            jnp.real(jnp.asarray(P)), jnp.imag(jnp.asarray(P)),
        )
        Rme = np.asarray(Rr, np.float64) + 1j * np.asarray(Ri, np.float64)
        Rtrue = S32.astype(np.complex128) - P.astype(np.complex128) @ np.conj(
            np.swapaxes(P.astype(np.complex128), 1, 2)
        )
        # naive f32 product would err at ~3e-7·|S|; compensated must be far below
        assert np.abs(Rme - Rtrue).max() < 1e-10 * np.abs(S64).max()


class TestCorr:
    def test_autocorr_is_one_at_zero_lag(self, ar2_data):
        corr = spy.connectivityanalysis(ar2_data, method="corr")
        arr = np.asarray(corr.data)
        assert arr[0, 0, 0, 0] == pytest.approx(1.0, abs=1e-5)
        assert arr[0, 0, 1, 1] == pytest.approx(1.0, abs=1e-5)
        assert np.all(np.abs(arr) < 1.01)

    def test_harmonic_periodicity(self):
        data = spy.synthdata.harmonic(freq=10, samplerate=1000, nTrials=5, nSamples=1000, nChannels=1)
        corr = spy.connectivityanalysis(data, method="corr")
        arr = np.asarray(corr.data)[:, 0, 0, 0]
        # autocorrelation of a 10 Hz harmonic has period 100 samples
        assert arr[100] == pytest.approx(1.0, abs=0.05)
        assert arr[50] == pytest.approx(-1.0, abs=0.05)

    def test_keeptrials(self, ar2_data):
        corr = spy.connectivityanalysis(ar2_data, method="corr", keeptrials=True)
        assert len(corr.trials) == len(ar2_data.trials)


class TestCSD:
    def test_averaged_csd(self, ar2_data):
        csd = spy.connectivityanalysis(ar2_data, method="csd", tapsmofrq=2)
        assert np.iscomplexobj(np.asarray(csd.data))
        assert len(csd.trials) == 1
        # diagonal of the CSD is the (real, positive) auto-spectrum
        arr = np.asarray(csd.data)
        assert np.all(arr[0, :, 0, 0].real > 0)
        assert np.abs(arr[0, :, 0, 0].imag).max() < 1e-5

    def test_single_trial_csd(self, ar2_data):
        csd = spy.connectivityanalysis(ar2_data, method="csd", keeptrials=True)
        assert len(csd.trials) == len(ar2_data.trials)


class TestPPC:
    def test_phase_locked_ppc_high(self):
        data = spy.synthdata.harmonic(freq=40, samplerate=500, nTrials=20, nSamples=500, nChannels=2)
        spec = spy.freqanalysis(data, method="mtmfft", taper="hann", output="fourier")
        ppc = spy.connectivityanalysis(spec, method="ppc")
        arr = np.asarray(ppc.data)
        f40 = np.argmin(np.abs(ppc.freq - 40))
        assert arr[0, f40, 0, 1] == pytest.approx(1.0, abs=1e-3)

    def test_random_ppc_low(self):
        data = spy.synthdata.white_noise(nTrials=40, nSamples=500, nChannels=2, seed=1)
        spec = spy.freqanalysis(data, method="mtmfft", taper="hann", output="fourier")
        ppc = spy.connectivityanalysis(spec, method="ppc")
        arr = np.asarray(ppc.data)
        assert np.abs(arr[0, 5:, 0, 1]).mean() < 0.15

    def test_ppc_matches_pair_loop(self):
        """The O(nTrials) resultant identity equals the explicit pair loop."""
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import ppc_from_spectra

        rng = np.random.default_rng(3)
        z = rng.normal(size=(12, 1, 9, 2, 2)) + 1j * rng.normal(size=(12, 1, 9, 2, 2))
        got = np.asarray(ppc_from_spectra(jnp.asarray(z)))
        n = z.shape[0]
        acc = np.zeros(z.shape[1:])
        for j in range(n):
            for k in range(j + 1, n):
                acc += np.cos(np.angle(z[j] * np.conj(z[k])))
        ref = acc * 2 / (n * (n - 1))
        assert np.abs(got - ref).max() < 1e-5


class TestTimeResolvedGranger:
    """Granger from tf-spectra: one factorization per sliding window
    (BEYOND the reference, which raises NotImplementedError —
    reference connectivity_analysis.py:487)."""

    def test_stationary_coupling_every_window(self):
        data = spy.synthdata.ar2_network(nTrials=40, samplerate=200,
                                         nSamples=800, seed=3)
        spec = spy.freqanalysis(data, method="mtmconvol", t_ftimwin=1.25,
                                toi=0.5, taper=None, output="fourier",
                                polyremoval=0, demean_taper=True)
        g = spy.connectivityanalysis(spec, method="granger")
        arr = np.asarray(g.data)
        n_win = spec.data.shape[0] // len(spec.trials)
        assert arr.shape[0] == n_win and n_win > 3
        assert g.info["converged"], g.info
        f40 = np.argmin(np.abs(np.asarray(g.freq) - 40))
        # the AR2 network couples 1 -> 0 at ~40 Hz in EVERY window
        assert np.all(arr[:, f40, 1, 0] > 0.3), arr[:, f40, 1, 0]
        assert np.all(arr[:, f40, 0, 1] < 0.1), arr[:, f40, 0, 1]

    def test_coupling_onset_detected(self):
        """Coupling switched on mid-recording must appear only in the
        late windows."""
        rng = np.random.default_rng(7)
        fs, T, n_trials = 200.0, 1200, 50
        half = T // 2
        alpha1, alpha2 = 0.55, -0.8
        xs = np.zeros((n_trials, T, 2), dtype=np.float64)
        for tr in range(n_trials):
            e = rng.normal(size=(T + 2, 2))
            x = np.zeros((T + 2, 2))
            for n in range(2, T + 2):
                c = 0.25 if (n - 2) >= half else 0.0
                x[n, 0] = alpha1 * x[n - 1, 0] + alpha2 * x[n - 2, 0] \
                    + c * x[n - 1, 1] + e[n, 0]
                x[n, 1] = alpha1 * x[n - 1, 1] + alpha2 * x[n - 2, 1] + e[n, 1]
            xs[tr] = x[2:]
        ad = spy.AnalogData(data=xs.reshape(-1, 2).astype("f4"), samplerate=fs)
        trl = np.zeros((n_trials, 3))
        trl[:, 0] = np.arange(n_trials) * T
        trl[:, 1] = trl[:, 0] + T
        ad.trialdefinition = trl
        spec = spy.freqanalysis(ad, method="mtmconvol", t_ftimwin=1.5,
                                toi=0.5, taper=None, output="fourier",
                                polyremoval=0, demean_taper=True)
        g = spy.connectivityanalysis(spec, method="granger")
        arr = np.asarray(g.data)
        f40 = np.argmin(np.abs(np.asarray(g.freq) - 40))
        n_win = arr.shape[0]
        early = arr[: n_win // 2 - 1, f40, 1, 0]
        late = arr[n_win // 2 + 1:, f40, 1, 0]
        assert late.mean() > 5 * max(early.mean(), 1e-3), (early, late)


class TestFusedPPC:
    """The fused single-pass PPC (PPCSpectra; default for AnalogData input)
    must equal the two-pass path (CrossSpectra keeptrials + PPCReduction,
    SPY_TPU_FUSED_PPC=0)."""

    def test_fused_equals_two_pass(self, monkeypatch):
        data = spy.synthdata.harmonic(freq=40, samplerate=500, nTrials=15,
                                      nSamples=500, nChannels=3)
        data += spy.synthdata.white_noise(nTrials=15, nSamples=500,
                                          nChannels=3, seed=2)
        fused = spy.connectivityanalysis(data, method="ppc", taper="hann")
        monkeypatch.setenv("SPY_TPU_FUSED_PPC", "0")
        twopass = spy.connectivityanalysis(data, method="ppc", taper="hann")
        a, b = np.asarray(fused.data), np.asarray(twopass.data)
        assert a.shape == b.shape
        assert np.abs(a - b).max() < 1e-5
        assert np.allclose(np.asarray(fused.freq), np.asarray(twopass.freq))
        assert list(fused.channel_i) == list(twopass.channel_i)
        # a phase-locked pair is near 1 on both
        f40 = np.argmin(np.abs(fused.freq - 40))
        assert a[0, f40, 0, 1] > 0.5

    def test_fused_respects_selection(self):
        data = spy.synthdata.white_noise(nTrials=20, nSamples=300,
                                         nChannels=4, seed=9)
        sub = spy.connectivityanalysis(data, method="ppc", taper="hann",
                                       select={"trials": list(range(10)),
                                               "channel": [0, 1, 2]})
        assert np.asarray(sub.data).shape[2:] == (3, 3)
        # PPC normalization used the SELECTED trial count: diagonal == 1
        assert np.allclose(np.asarray(sub.data)[0, :, 0, 0], 1.0, atol=1e-4)

    def test_fused_multichunk_equals_single(self):
        """1-trial chunks (stress knob) must reproduce the one-chunk sum."""
        import subprocess
        import sys

        code = (
            "import os; os.environ['JAX_PLATFORMS']='cpu';"
            "os.environ['SPY_TPU_CHUNK_BYTES']='1';"
            "import jax; jax.config.update('jax_platforms','cpu');"
            "import numpy as np, syncopy_tpu as spy;"
            "d = spy.synthdata.white_noise(nTrials=7, nSamples=200,"
            " nChannels=2, seed=4);"
            "p = spy.connectivityanalysis(d, method='ppc', taper='hann');"
            "print('CHK', float(np.asarray(p.data)[0, 5, 0, 1]))"
        )
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        chunked = float(out.stdout.split("CHK")[1].strip().split()[0])
        d = spy.synthdata.white_noise(nTrials=7, nSamples=200, nChannels=2,
                                      seed=4)
        p = spy.connectivityanalysis(d, method="ppc", taper="hann")
        assert abs(float(np.asarray(p.data)[0, 5, 0, 1]) - chunked) < 1e-5


class TestChannelCmb:
    def test_granger_pairwise(self):
        data = spy.synthdata.ar2_network(nTrials=80, samplerate=200, nSamples=800, seed=1)
        spec = spy.freqanalysis(data, method="mtmfft", taper=None, output="fourier", polyremoval=0, demean_taper=True)
        gr = spy.connectivityanalysis(spec, method="granger", channelcmb=[[1], [0]])
        arr = np.asarray(gr.data)
        assert arr.shape[2] == 1 and arr.shape[3] == 1
        f40 = np.argmin(np.abs(gr.freq - 40))
        assert arr[0, f40, 0, 0] > 0.3  # 1 -> 0 coupling

    def test_coh_channelcmb(self):
        data = spy.synthdata.white_noise(nTrials=20, nSamples=400, nChannels=4, seed=5)
        spec = spy.freqanalysis(data, method="mtmfft", taper="hann", output="fourier")
        coh = spy.connectivityanalysis(spec, method="coh", channelcmb=[[0, 1], [2, 3]])
        assert np.asarray(coh.data).shape[2:] == (2, 2)
        assert list(coh.channel_i) == ["channel1", "channel2"]

    def test_ppc_channelcmb(self):
        data = spy.synthdata.white_noise(nTrials=10, nSamples=400, nChannels=4, seed=6)
        spec = spy.freqanalysis(data, method="mtmfft", taper="hann", output="fourier")
        ppc = spy.connectivityanalysis(spec, method="ppc", channelcmb=[[0], [1, 2]])
        assert np.asarray(ppc.data).shape[2:] == (1, 2)


class TestSpectralInput:
    def test_coh_from_spectral(self, ar2_data):
        spec = spy.freqanalysis(ar2_data, tapsmofrq=3, output="fourier", keeptapers=True)
        coh = spy.connectivityanalysis(spec, method="coh")
        arr = np.asarray(coh.data)
        peak_freq = coh.freq[np.argmax(arr[0, :, 0, 1])]
        assert abs(peak_freq - 40) < 5

    def test_rejects_real_spectra(self, ar2_data):
        spec = spy.freqanalysis(ar2_data, method="mtmfft", taper="hann", output="pow")
        with pytest.raises(spy.SPYValueError):
            spy.connectivityanalysis(spec, method="coh")


class TestParallelConnectivity:
    def test_coh_on_mesh(self, ar2_data, testmesh):
        seq = spy.connectivityanalysis(ar2_data, method="coh", tapsmofrq=3)
        with spy.use_mesh(testmesh):
            par = spy.connectivityanalysis(ar2_data, method="coh", tapsmofrq=3)
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=1e-5)


class TestSpectralInputSelections:
    def test_inplace_selection_on_spectral(self, ar2_data):
        spec = spy.freqanalysis(ar2_data, tapsmofrq=3, output="fourier", keeptapers=True)
        spec.selectdata(trials=list(range(0, 60)), inplace=True)
        coh = spy.connectivityanalysis(spec, method="coh")
        spec.selection = None
        full = spy.connectivityanalysis(spec, method="coh")
        arr_sel, arr_full = np.asarray(coh.data), np.asarray(full.data)
        # subset average differs from full average but both are valid coherences
        assert arr_sel.shape == arr_full.shape
        assert np.all(arr_sel <= 1.0 + 1e-5)


class TestPackedReadback:
    """The fused coh/csd paths pack the Hermitian result's upper triangle
    for the device->host readback; reconstruction must be exact."""

    def test_coh_outputs_mirror(self):
        d = spy.synthdata.ar2_network(nTrials=20, samplerate=200, nSamples=400, seed=7)
        for output, sign in [("abs", 1), ("pow", 1), ("real", 1), ("imag", -1), ("angle", -1)]:
            coh = spy.connectivityanalysis(d, method="coh", tapsmofrq=3, output=output)
            arr = np.asarray(coh.data)[0]
            assert np.allclose(arr, sign * np.swapaxes(arr, -1, -2), atol=1e-5), output

    def test_csd_hermitian_and_mean(self):
        d = spy.synthdata.ar2_network(nTrials=20, samplerate=200, nSamples=400, seed=8)
        csd = spy.connectivityanalysis(d, method="csd", tapsmofrq=2)
        arr = np.asarray(csd.data)[0]
        assert np.allclose(arr, np.conj(np.swapaxes(arr, -1, -2)), atol=1e-6)
        per_trial = spy.connectivityanalysis(d, method="csd", keeptrials=True, tapsmofrq=2)
        mean = np.asarray(per_trial.data).mean(axis=0)
        assert np.abs(arr - mean).max() / np.abs(mean).max() < 1e-5


class TestPSDRepair:
    """Floating-point trial accumulation can leave the CSD slightly
    indefinite (tiny negative eigenvalues); an indefinite matrix has no
    Wilson factorization, so regularize_csd must repair it (measured floor
    ~3e-5 at 1000 trials of sequential f32 accumulation)."""

    def _psd_csd(self, N=8, seed=0):
        """Smooth, factorizable CSD: hann-tapered spectra of AR(2) noise
        (a Wilson factorization only exists for a valid spectral density —
        per-bin random matrices are NOT one)."""
        from scipy.signal import lfilter

        rng = np.random.default_rng(seed)
        n_trials, n_samp = 120, 256
        e = rng.normal(size=(n_trials, n_samp, N)).astype("f4")
        x = lfilter([1.0], [1.0, -0.55, 0.8], e, axis=1)
        win = np.hanning(n_samp)
        win = win * np.sqrt(2.0 / (win**2).sum())
        tap = (x - x.mean(axis=1, keepdims=True)) * win[None, :, None]
        spec = np.fft.rfft(tap, axis=1)
        return (np.einsum("tfi,tfj->fij", spec, np.conj(spec)) / n_trials).astype(np.complex64)

    def test_indefinite_csd_converges(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import regularize_csd, wilson_sf
        from syncopy_tpu.parallel.device_io import run_on_device

        csd = self._psd_csd()
        # inject accumulation-noise-like indefiniteness at some bins
        lam = np.linalg.eigvalsh(csd)
        scale = float(np.abs(lam).mean())
        eye = np.eye(csd.shape[1])
        csd[10] -= (np.linalg.eigvalsh(csd[10]).min() + 3e-5 * scale) * eye
        csd[40] -= (np.linalg.eigvalsh(csd[40]).min() + 1e-5 * scale) * eye
        assert np.linalg.eigvalsh(csd[10]).min() < 0

        def factorize(c):
            creg, eps, _ = regularize_csd(
                c.astype(jnp.complex64), cond_max=1e4, eps_max=1e-1
            )
            H, Sigma, conv, err = wilson_sf(creg, nIter=100, rtol=5e-6)
            return conv, err

        conv, err = run_on_device(factorize, csd, key=("psd_repair_test",))
        assert bool(np.asarray(conv)), float(np.asarray(err))

    def test_repair_leaves_psd_untouched(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import regularize_csd
        from syncopy_tpu.parallel.device_io import run_on_device

        csd = self._psd_csd(seed=1)
        creg, eps, _ = run_on_device(
            lambda c: regularize_csd(c.astype(jnp.complex64), cond_max=1e9),
            csd, key=("psd_noop_test",),
        )
        assert np.allclose(creg, csd, atol=1e-7)


class TestFastRegExtents:
    """Wide-channel regularization runs WITHOUT an eigendecomposition
    (``csd_lam_extents``: Cholesky bisection of both spectral extremes,
    cheaper than a batched eigvalsh at wide channel counts). The fast path must
    reproduce the eigvalsh path's regularization selection exactly."""

    def _wishart(self, F, N, K, seed=0, indefinite_bins=()):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(F, N, K)) + 1j * rng.normal(size=(F, N, K))
        C = (A @ A.conj().transpose(0, 2, 1) / K).astype(np.complex64)
        for b in indefinite_bins:
            lam_min = np.linalg.eigvalsh(C[b]).min()
            C[b] -= (lam_min + 1e-5 * np.abs(C[b]).max()) * np.eye(N)
        return C

    def test_extents_match_eigvalsh(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import csd_lam_extents

        C = self._wishart(17, 96, 120, seed=2, indefinite_bins=(3,))
        Ch = (C + C.conj().transpose(0, 2, 1)) / 2
        lam = np.linalg.eigvalsh(Ch.astype(np.complex128))
        lo, hi, lmax = [np.asarray(x) for x in csd_lam_extents(jnp.asarray(Ch))]
        scale = np.abs(lam).max(axis=1)
        # the true lam_min must sit inside the (tiny) returned bracket
        assert np.all(lo <= lam.min(axis=1) + 1e-6 * scale)
        assert np.all(hi >= lam.min(axis=1) - 1e-6 * scale)
        assert float(((hi - lo) / scale).max()) < 1e-6
        assert float((np.abs(lmax - lam.max(axis=1)) / lam.max(axis=1)).max()) < 1e-6

    @pytest.mark.parametrize("K,cond_max", [(130, 1e3), (130, 1e4), (512, 1e4)])
    def test_selection_matches_eig_path(self, monkeypatch, K, cond_max):
        """eps ladder selection, PSD-repair shift, and the Wilson outcome
        must agree between the fast (bisection) and eigvalsh paths —
        including on near-singular inputs where eps loading engages."""
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import csd_reg_params

        C = jnp.asarray(self._wishart(13, 128, K, seed=4, indefinite_bins=(1,)))
        monkeypatch.setenv("SPY_TPU_FAST_REG", "1")
        s1, e1, c1 = [np.asarray(x) for x in
                      csd_reg_params(C, cond_max=cond_max, eps_max=1e-1)]
        monkeypatch.setenv("SPY_TPU_FAST_REG", "0")
        s0, e0, c0 = [np.asarray(x) for x in
                      csd_reg_params(C, cond_max=cond_max, eps_max=1e-1)]
        assert np.isclose(float(e1), float(e0), rtol=1e-5)
        scale = float(np.abs(np.asarray(C)).max())
        assert float(np.abs(s1 - s0).max()) < 1e-6 * scale
        # ini_cond is a diagnostic: order-of-magnitude agreement suffices,
        # but on these PSD-dominated inputs it should be tight
        assert np.isclose(float(c1), float(c0), rtol=1e-2)

    def test_fast_reg_granger_end_to_end(self, monkeypatch):
        """A genuine spectral density (AR(2) CSD, wide channels) must
        factorize and produce the SAME Granger under fast regularization
        as under the eigvalsh path."""
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import granger, regularize_csd, wilson_sf
        from scipy.signal import lfilter

        rng = np.random.default_rng(11)
        n_trials, n_samp, N = 300, 128, 96
        e = rng.normal(size=(n_trials, n_samp, N)).astype("f4")
        x = lfilter([1.0], [1.0, -0.55, 0.8], e, axis=1)
        win = np.hanning(n_samp)
        win = win * np.sqrt(2.0 / (win ** 2).sum())
        tap = (x - x.mean(axis=1, keepdims=True)) * win[None, :, None]
        spec = np.fft.rfft(tap, axis=1)
        csd = (np.einsum("tfi,tfj->fij", spec, np.conj(spec)) / n_trials
               ).astype(np.complex64)

        def run():
            creg, eps, _ = regularize_csd(
                jnp.asarray(csd), cond_max=1e4, eps_max=1e-1)
            H, Sigma, conv, err = wilson_sf(creg, nIter=100, rtol=5e-6)
            return np.asarray(granger(creg, H, Sigma)), bool(conv), float(err)

        monkeypatch.setenv("SPY_TPU_FAST_REG", "1")
        G1, conv1, err1 = run()
        monkeypatch.setenv("SPY_TPU_FAST_REG", "0")
        G0, conv0, err0 = run()
        assert conv1 and conv0, (err1, err0)
        assert np.abs(G1 - G0).max() < 1e-6


class TestCompensatedCSDAccumulation:
    """Many-trial CSD sums need double-float32 accumulation: plain serial
    f32 accumulation noise (~3e-5 relative at 1000 trials) leaves the CSD
    without an exact Wilson factorization (measured: host float64 floors at
    the SAME level on an f32-accumulated CSD)."""

    def test_matches_float64_sum(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import csd_sum_compensated
        from syncopy_tpu.parallel.device_io import run_on_device

        rng = np.random.default_rng(8)
        spec = (rng.normal(size=(1000, 1, 40, 8))
                + 1j * rng.normal(size=(1000, 1, 40, 8))).astype(np.complex64)
        ref = np.einsum("bkfi,bkfj->fij", spec.astype(np.complex128),
                        np.conj(spec.astype(np.complex128)))
        got = run_on_device(csd_sum_compensated, spec, key=("comp_csd_test",))
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel < 5e-7, rel

    def test_many_trial_granger_converges_f32(self):
        """End-to-end: 600-trial Granger through the engine's compensated
        CSD must converge at the reference rtol in pure float32."""
        from scipy.signal import lfilter

        rng = np.random.default_rng(9)
        n_trials, n_samp, n_chan = 600, 500, 8
        e = rng.normal(size=(n_trials * n_samp, n_chan)).astype("f4")
        x = lfilter([1.0], [1.0, -0.55, 0.8], e, axis=0).astype("f4")
        trl = np.zeros((n_trials, 3))
        trl[:, 0] = np.arange(n_trials) * n_samp
        trl[:, 1] = trl[:, 0] + n_samp
        ad = spy.AnalogData(data=x, samplerate=1000.0)
        ad.trialdefinition = trl
        g = spy.connectivityanalysis(ad, method="granger")
        assert g.info["converged"], g.info["max rel. err"]
        assert g.info["max rel. err"] < 5e-6


class TestDf32SpectralPath:
    """The factorization-grade CSD path: compensated double-float32 DFT +
    Gram (ops/connectivity.rfft_df32 / csd_sum_df32), used by Granger."""

    def test_rfft_df32_matches_float64(self):
        from syncopy_tpu.ops.connectivity import rfft_df32
        from syncopy_tpu.parallel.device_io import run_on_device

        rng = np.random.default_rng(0)
        x = rng.normal(size=(1000, 16)).astype("f4")
        ref = np.fft.rfft(x.astype(np.float64), axis=0)
        hr, lr, hi, li = run_on_device(lambda a: rfft_df32(a, 1000), x,
                                       key=("df32_rfft_test",))
        got = (hr.astype(np.float64) + lr) + 1j * (hi.astype(np.float64) + li)
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel < 1e-9, rel

    def test_rfft_df32_zero_padding(self):
        from syncopy_tpu.ops.connectivity import rfft_df32
        from syncopy_tpu.parallel.device_io import run_on_device

        rng = np.random.default_rng(1)
        x = rng.normal(size=(300, 4)).astype("f4")
        ref = np.fft.rfft(x.astype(np.float64), n=512, axis=0)
        hr, lr, hi, li = run_on_device(lambda a: rfft_df32(a, 512), x,
                                       key=("df32_pad_test",))
        got = (hr.astype(np.float64) + lr) + 1j * (hi.astype(np.float64) + li)
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-9

    def test_csd_sum_df32_entrywise_accuracy(self):
        from syncopy_tpu.ops.connectivity import csd_sum_df32
        from syncopy_tpu.parallel.device_io import run_on_device

        rng = np.random.default_rng(2)
        tp = rng.normal(size=(64, 1, 500, 8)).astype("f4")
        spec64 = np.fft.rfft(tp.astype(np.float64), n=500, axis=2)
        ref = np.einsum("bkfi,bkfj->fij", spec64, np.conj(spec64))
        got = run_on_device(lambda a: csd_sum_df32(a, 500), tp,
                            key=("df32_csd_test",))
        # errors must be ENTRY-proportional (what keeps the Wilson
        # factorization's elementwise metric convergent), bounded by the
        # complex64 output storage quantization
        denom = np.maximum(np.abs(ref), np.abs(ref).max() * 1e-6)
        assert (np.abs(got - ref) / denom).max() < 2e-5


class TestGrangerFromSpectra:
    """Granger from precomputed fourier spectra converges when the spectra
    come from the exact DFT path (freqanalysis exact_fft=True) and the
    dyadic trial sum is compensated."""

    def test_exact_fft_spectra_converge(self):
        from scipy.signal import lfilter

        rng = np.random.default_rng(12)
        n_trials, n_samp, n_chan = 300, 400, 6
        e = rng.normal(size=(n_trials * n_samp, n_chan)).astype("f4")
        x = lfilter([1.0], [1.0, -0.55, 0.8], e, axis=0).astype("f4")
        trl = np.zeros((n_trials, 3))
        trl[:, 0] = np.arange(n_trials) * n_samp
        trl[:, 1] = trl[:, 0] + n_samp
        ad = spy.AnalogData(data=x, samplerate=1000.0)
        ad.trialdefinition = trl
        spec = spy.freqanalysis(ad, method="mtmfft", output="fourier",
                                keeptrials=True, demean_taper=True,
                                exact_fft=True)
        g = spy.connectivityanalysis(spec, method="granger")
        assert g.info["converged"], g.info["max rel. err"]

    def test_plain_f32_spectra_warn_actionably(self):
        """The accuracy trap is guarded: Granger consuming SpectralData
        whose provenance shows a plain-f32 FFT warns at call time."""
        d = spy.synthdata.white_noise(nTrials=20, nSamples=256, nChannels=3, seed=7)
        spec = spy.freqanalysis(d, method="mtmfft", output="fourier",
                                keeptrials=True, demean_taper=True)
        with pytest.warns(RuntimeWarning, match="exact_fft"):
            spy.connectivityanalysis(spec, method="granger")

    def test_exact_fft_spectra_no_trap_warning(self, recwarn):
        d = spy.synthdata.white_noise(nTrials=20, nSamples=256, nChannels=3, seed=7)
        spec = spy.freqanalysis(d, method="mtmfft", output="fourier",
                                keeptrials=True, demean_taper=True,
                                exact_fft=True)
        spy.connectivityanalysis(spec, method="granger")
        assert not any("exact_fft" in str(w.message) for w in recwarn.list)

    def test_nonconvergence_surfaces_as_warning(self, monkeypatch):
        """converged=False must raise a RuntimeWarning, not just sit in
        out.info (forced here via an unattainable rtol)."""
        from syncopy_tpu.connectivity import AV_compRoutines as av

        orig = av.GrangerCausality.__init__

        def unattainable(self, rtol=5e-6, nIter=100, cond_max=1e4):
            orig(self, rtol=1e-300, nIter=2, cond_max=cond_max)

        monkeypatch.setattr(av.GrangerCausality, "__init__", unattainable)
        d = spy.synthdata.white_noise(nTrials=10, nSamples=128, nChannels=2, seed=5)
        with pytest.warns(RuntimeWarning, match="did NOT converge"):
            spy.connectivityanalysis(d, method="granger", tapsmofrq=2)

    def test_nonconvergence_triggers_host_f64_fallback(self, monkeypatch):
        """A non-converged float32 device factorization is automatically
        retried with the host float64 path — the returned estimate is the
        converged f64 one, not the diverged f32 one."""
        from syncopy_tpu.connectivity import AV_compRoutines as av

        real_wilson = av.wilson_sf

        def diverged(CSD, nIter=100, rtol=1e-6):
            H, Sigma, conv, err = real_wilson(CSD, nIter=nIter, rtol=rtol)
            import jax.numpy as jnp
            return H, Sigma, jnp.asarray(False), jnp.asarray(1e3, err.dtype)

        monkeypatch.setattr(av, "wilson_sf", diverged)
        # unique shape: the engine's executable cache is keyed by shapes —
        # reusing a shape from another test would bypass the monkeypatch
        d = spy.synthdata.ar2_network(nTrials=50, nSamples=260, seed=3)
        try:
            with pytest.warns(RuntimeWarning, match="retrying with the host float64"):
                g = spy.connectivityanalysis(d, method="granger", tapsmofrq=2)
        finally:
            # the monkeypatched (always-diverged) wilson is baked into the
            # compiled executable — evict it so no later same-shape run in
            # this process silently reuses it
            from syncopy_tpu.engine import routine as _routine

            _routine._GLOBAL_JIT_CACHE.clear()
        assert g.info["converged"], g.info
        assert "host float64" in str(g._log)
        # the fallback estimate carries the physics: directed 0 -> 1 coupling
        arr = np.asarray(g.data)
        assert arr[..., 1, 0].max() > 5 * arr[..., 0, 1].max()

    def test_jackknife_replicates_host_fallback(self, monkeypatch):
        """When the f32 device factorization of the leave-one-out CSDs
        diverges, the jackknife replicates are recomputed in host float64
        instead of attaching garbage error bars."""
        from syncopy_tpu.connectivity import AV_compRoutines as av

        real_wilson = av.wilson_sf

        def diverged(CSD, nIter=100, rtol=1e-6):
            H, Sigma, conv, err = real_wilson(CSD, nIter=nIter, rtol=rtol)
            import jax.numpy as jnp
            return H, Sigma, jnp.asarray(False), jnp.asarray(1e3, err.dtype)

        monkeypatch.setattr(av, "wilson_sf", diverged)
        d = spy.synthdata.ar2_network(nTrials=20, nSamples=268, seed=5)
        try:
            with pytest.warns(RuntimeWarning,
                              match="recomputing the replicates"):
                g = spy.connectivityanalysis(d, method="granger",
                                             tapsmofrq=2, jackknife=True)
        finally:
            from syncopy_tpu.engine import routine as _routine

            _routine._GLOBAL_JIT_CACHE.clear()
        assert g.info["converged"], g.info
        var = np.asarray(g._get_extra_dataset("jack_var"))
        bias = np.asarray(g._get_extra_dataset("jack_bias"))
        assert np.isfinite(var).all() and np.isfinite(bias).all()
        assert var.shape == g.data.shape
        assert np.all(var >= 0)
        # 20-trial jackknife variance at an O(1) peak stays O(1-10);
        # the point is it is finite and sane, not tight
        assert var[0, 5:, 1, 0].max() < 10.0

    def test_jackknife_rank_deficiency_warns(self, monkeypatch):
        """LOO CSD rank (nTrials-1)*nTapers below the channel count means a
        SINGULAR replicate CSD — the frontend must say so up front instead
        of letting Wilson grind to non-convergence (round-4 root cause of
        the 128-ch jackknife scare)."""
        monkeypatch.setenv("SPY_GRANGER_HOST_FALLBACK", "0")
        # 4 trials x 1 hann taper on 8 channels: LOO rank 3 < 8
        dd = spy.synthdata.white_noise(nTrials=4, nSamples=128, nChannels=8,
                                       seed=7)
        with pytest.warns(RuntimeWarning, match="singular"):
            spy.connectivityanalysis(dd, method="granger", taper="hann",
                                     jackknife=True)

    def test_exact_fft_matches_plain(self):
        d = spy.synthdata.white_noise(nTrials=4, nSamples=300, nChannels=3, seed=4)
        plain = spy.freqanalysis(d, method="mtmfft", output="fourier")
        exact = spy.freqanalysis(d, method="mtmfft", output="fourier",
                                 exact_fft=True)
        a, b = np.asarray(plain.data), np.asarray(exact.data)
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-5


class TestGrangerRankGate:
    """Pre-flight rank gate: nTrials*nTapers <
    nChannels means the averaged CSD is singular by construction — the
    frontend must route straight to the host-f64 path WITHOUT attempting
    the doomed device factorization (which burns ~26 s at 256 ch)."""

    def test_rank_deficient_skips_device_attempt(self, monkeypatch):
        from syncopy_tpu.connectivity import AV_compRoutines as av

        calls = {"device": 0}
        real_wilson = av.wilson_sf

        def counting(*a, **k):
            calls["device"] += 1
            return real_wilson(*a, **k)

        monkeypatch.setattr(av, "wilson_sf", counting)
        # 6 trials x 1 hann taper on 8 channels: rank 6 < 8 -> singular
        adj = np.zeros((8, 8), dtype=np.float32)
        adj[1, 0] = 0.25
        d = spy.synthdata.ar2_network(nTrials=6, AdjMat=adj, nSamples=264, seed=11)
        with pytest.warns(RuntimeWarning, match="singular"):
            out = spy.connectivityanalysis(d, method="granger")
        assert calls["device"] == 0, "device factorization attempted at a gated shape"
        assert np.asarray(out.data).shape[-1] == 8
        assert "converged" in out.info

    def test_full_rank_not_gated(self, monkeypatch):
        from syncopy_tpu.connectivity import connectivity_analysis as ca

        # 12 trials x 1 taper on 8 channels: full rank -> normal path
        adj = np.zeros((8, 8), dtype=np.float32)
        adj[1, 0] = 0.25
        d = spy.synthdata.ar2_network(nTrials=12, AdjMat=adj, nSamples=272, seed=12)
        called = {"host_full": 0}
        real = ca._granger_host_full

        def wrapped(*a, **k):
            called["host_full"] += 1
            return real(*a, **k)

        monkeypatch.setattr(ca, "_granger_host_full", wrapped)
        out = spy.connectivityanalysis(d, method="granger")
        assert out.info.get("converged") is True
        assert called["host_full"] == 0


class TestConnectivityValidationMatrix:
    """Frontend validation (reference test_connectivity.py exception
    blocks + connectivity_analysis.py:80-145 guards)."""

    @pytest.fixture(scope="class")
    def d(self):
        return spy.synthdata.white_noise(nTrials=6, nSamples=256,
                                         samplerate=500, nChannels=3, seed=0)

    def test_invalid_method(self, d):
        with pytest.raises(spy.SPYValueError, match="method"):
            spy.connectivityanalysis(d, method="plv")

    def test_single_trial_rejected(self, d):
        solo = spy.AnalogData(data=np.asarray(d.trials[0]), samplerate=500)
        with pytest.raises(spy.SPYValueError, match="trial"):
            spy.connectivityanalysis(solo, method="coh", tapsmofrq=2)

    @pytest.mark.parametrize("method", ["coh", "ppc", "granger"])
    def test_keeptrials_rejected_for_averaged_methods(self, d, method):
        with pytest.raises(spy.SPYValueError, match="keeptrials"):
            spy.connectivityanalysis(d, method=method, keeptrials=True,
                                     tapsmofrq=2)

    def test_corr_rejects_padding(self, d):
        with pytest.raises(spy.SPYValueError, match="pad"):
            spy.connectivityanalysis(d, method="corr", pad=2.0)

    def test_corr_rejects_spectral_input(self, d):
        spec = spy.freqanalysis(d, method="mtmfft", output="fourier",
                                keeptrials=True)
        with pytest.raises(spy.SPYValueError):
            spy.connectivityanalysis(spec, method="corr")

    def test_granger_rejects_foi(self, d):
        with pytest.raises(spy.SPYValueError, match="foi"):
            spy.connectivityanalysis(d, method="granger", foilim=[10, 50])

    def test_real_spectra_rejected(self, d):
        pw = spy.freqanalysis(d, method="mtmfft", output="pow",
                              keeptrials=True)
        with pytest.raises(spy.SPYValueError, match="fourier"):
            spy.connectivityanalysis(pw, method="coh")

    def test_jackknife_only_for_coh_granger(self, d):
        with pytest.warns(RuntimeWarning, match="[Jj]ackknife"):
            spy.connectivityanalysis(d, method="csd", jackknife=True)

    def test_channelcmb_validation(self, d):
        spec = spy.freqanalysis(d, method="mtmfft", output="fourier",
                                keeptrials=True)
        with pytest.raises(spy.SPYValueError):
            spy.connectivityanalysis(spec, method="csd",
                                     channelcmb=[[0], [1], [2]])
        with pytest.raises(spy.SPYValueError):
            spy.connectivityanalysis(spec, method="csd",
                                     channelcmb=[[0], [99]])
        with pytest.raises(spy.SPYTypeError):
            spy.connectivityanalysis(d, method="coh", tapsmofrq=2,
                                     channelcmb=[[0], [1]])


class TestConnectivityEstimatorProperties:
    """Estimator-level physics (reference test_connectivity.py AR(2) and
    phase-diffusion ground-truth blocks)."""

    def test_coherence_of_common_drive(self):
        """Two channels sharing a common harmonic + independent noise:
        coherence at the drive frequency matches the analytic
        signal-to-total ratio."""
        rng = np.random.default_rng(3)
        fs, n_samp, n_trials = 500.0, 500, 150
        t = np.arange(n_samp) / fs
        amp, nstd = 1.0, 1.0
        sigs = []
        for k in range(n_trials):
            phase = rng.uniform(0, 2 * np.pi)
            drive = amp * np.cos(2 * np.pi * 50 * t + phase)
            ch1 = drive + nstd * rng.normal(size=n_samp)
            ch2 = drive + nstd * rng.normal(size=n_samp)
            sigs.append(np.column_stack([ch1, ch2]).astype("f4"))
        ad = spy.AnalogData(data=sigs, samplerate=fs)
        coh = spy.connectivityanalysis(ad, method="coh", tapsmofrq=2)
        freqs = np.asarray(coh.freq)
        arr = np.asarray(coh.data)[0]
        f_idx = np.argmin(np.abs(freqs - 50))
        # per-bin SNR: harmonic power A^2/4 (hann split) vs noise density;
        # empirically the coherence plateaus near s/(s+n) — just require a
        # strong, localized peak with the right magnitude ordering
        assert arr[f_idx, 0, 1] > 0.55
        off = np.r_[arr[5:f_idx - 10, 0, 1], arr[f_idx + 10:-5, 0, 1]]
        assert off.mean() < 0.1
        # diagonal exactly 1
        assert np.allclose(arr[:, 0, 0], 1.0, atol=1e-5)
        assert np.allclose(arr[:, 1, 1], 1.0, atol=1e-5)

    def test_independent_channels_coherence_floor(self):
        """Independent noise: coherence ~ sqrt(pi/4/nTrials) estimator
        floor (reference test_coherence white-noise block)."""
        d = spy.synthdata.white_noise(nTrials=200, nSamples=500,
                                      samplerate=500, nChannels=2, seed=8)
        coh = spy.connectivityanalysis(d, method="coh", taper="hann")
        arr = np.asarray(coh.data)[0, :, 0, 1]
        expected_floor = np.sqrt(np.pi / 4 / 200)
        assert arr.mean() == pytest.approx(expected_floor, rel=0.25)
        assert arr.max() < 6 * expected_floor

    def test_crosscorr_known_lag(self):
        """Channel 2 = channel 1 delayed by L samples: cross-correlation
        peaks exactly at lag L."""
        rng = np.random.default_rng(5)
        fs, n_samp, lag = 1000.0, 1000, 20
        sigs = []
        for _ in range(30):
            x = rng.normal(size=n_samp + lag).astype("f4")
            sigs.append(np.column_stack([x[lag:], x[:-lag]]))
        ad = spy.AnalogData(data=sigs, samplerate=fs)
        cc = spy.connectivityanalysis(ad, method="corr")
        arr = np.asarray(cc.data)  # (lags, 1, C, C)
        # convention: CC[l, 0, i, j] = <x_i[m] x_j[m-l]> for i >= j
        # (ops/connectivity.cross_covariance_trial) — channel 0 leading
        # channel 1 by `lag` peaks in the [1, 0] entry at l = lag
        peak = np.argmax(np.abs(arr[:, 0, 1, 0]))
        assert peak == lag
        assert arr[lag, 0, 1, 0] == pytest.approx(1.0, abs=0.02)
        # zero-lag autocorrelation is exactly 1
        assert arr[0, 0, 0, 0] == pytest.approx(1.0, abs=1e-4)

    def test_ppc_matches_pair_loop(self):
        """The streamed resultant identity equals the direct O(n^2) pair
        average (reference PPC definition, ST_compRoutines.py:158-266)."""
        d = spy.synthdata.phase_diffusion(freq=40, eps=0.05, samplerate=250,
                                          nSamples=250, nChannels=2,
                                          nTrials=12, seed=11)
        spec = spy.freqanalysis(d, method="mtmfft", output="fourier",
                                keeptrials=True, taper=None)
        ppc = spy.connectivityanalysis(spec, method="ppc")
        arr = np.asarray(spec.data).reshape(12, -1, 2)
        csds = arr[:, :, 0] * np.conj(arr[:, :, 1])
        units = csds / np.abs(csds)
        n = 12
        acc = np.zeros(units.shape[1])
        for j in range(n):
            for k in range(j + 1, n):
                acc += np.cos(np.angle(units[j]) - np.angle(units[k]))
        manual = acc / (n * (n - 1) / 2)
        got = np.asarray(ppc.data)[0, :, 0, 1]
        assert np.allclose(got, manual, atol=1e-4)

    def test_granger_directionality_ground_truth(self):
        """AR(2) network with 0->1 coupling: G(0->1) >> G(1->0) in the
        resonance band and the reversed system flips it."""
        Adj = np.zeros((2, 2), dtype=np.float32)
        Adj[1, 0] = 0.3  # 0 drives 1 (column drives row? see synthdata)
        ad = spy.synthdata.ar2_network(nTrials=80, AdjMat=Adj,
                                       nSamples=500, seed=14)
        g = spy.connectivityanalysis(ad, method="granger", tapsmofrq=3)
        arr = np.asarray(g.data)[0]
        band = slice(20, 120)
        # index convention [i, j]: coupling AdjMat[1, 0] surfaces at [1, 0]
        # (same as the Dhamala fixture in TestGranger above)
        fwd = arr[band, 1, 0].mean()
        rev = arr[band, 0, 1].mean()
        assert fwd > 10 * rev
        assert g.info["converged"]


class TestPlusOperatorOnesided:
    """The one-sided []+ operator (half-spectrum Wilson fast path) is
    exactly the two-sided operator restricted to non-negative bins."""

    @pytest.mark.parametrize("F,N", [(9, 3), (64, 4), (251, 2)])
    def test_matches_two_sided(self, F, N):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import (
            _plus_operator,
            _plus_operator_onesided,
        )

        rng = np.random.default_rng(F)
        half = (rng.normal(size=(F, N, N))
                + 1j * rng.normal(size=(F, N, N))).astype(np.complex64)
        # enforce the conjugate frequency symmetry the iteration guarantees:
        # bins 0 and F-1 (Nyquist) must be real entrywise
        half[0] = half[0].real
        half[-1] = half[-1].real
        full = np.concatenate([half, np.conj(half[F - 2:0:-1])], axis=0)

        gp_full, g0_full = _plus_operator(jnp.asarray(full))
        gp_half, g0_half = _plus_operator_onesided(
            jnp.asarray(half), full.shape[0]
        )
        assert np.allclose(np.asarray(gp_half), np.asarray(gp_full)[:F],
                           atol=1e-5)
        assert np.allclose(np.asarray(g0_half), np.asarray(g0_full),
                           atol=1e-5)

    def test_wilson_half_on_valid_spectrum(self):
        """End check on a VALID (smooth AR-process) spectrum: the
        half-spectrum iteration converges and reconstructs the CSD.
        (A random independent-bins matrix is NOT Wilson-factorizable —
        the host float64 oracle fails on it identically.)"""
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import cross_spectra_trial, wilson_sf

        ad = spy.synthdata.ar2_network(nTrials=60, nSamples=400, seed=5)
        acc = None
        for k in range(len(ad.trials)):
            cs = np.asarray(cross_spectra_trial(
                jnp.asarray(np.asarray(ad.trials[k], dtype=np.float64)),
                1000.0, 400, taper="hann",
            ))[0]
            acc = cs.astype(np.complex128) if acc is None else acc + cs
        CSD = acc / 60
        H, Sigma, conv, err = wilson_sf(jnp.asarray(CSD.astype(np.complex64)),
                                        nIter=100, rtol=5e-6)
        assert bool(conv), float(err)
        S_rec = np.asarray(H) @ np.asarray(Sigma) @ np.conj(
            np.swapaxes(np.asarray(H), 1, 2))
        rel = np.abs(S_rec - CSD).max() / np.abs(CSD).max()
        assert rel < 1e-4


def _csd_oracle(spec, n_valid):
    """float64 trial+taper CSD sum of the first `n_valid` trials."""
    spec = spec[:n_valid].astype(np.complex128)
    return np.einsum("bkfi,bkfj->fij", spec, np.conj(spec))


def _cross_spectra_cr(T=250, fs=1000.0):
    from syncopy_tpu.connectivity.ST_compRoutines import CrossSpectra
    from syncopy_tpu.shared.input_processors import process_taper

    taper, taper_opt = process_taper(
        "hann", None, 4, None, keeptapers=False, foimax=fs / 2,
        samplerate=fs, nSamples=T, output="pow",
    )
    return CrossSpectra(samplerate=fs, nSamples=T, taper=taper, taper_opt=taper_opt)


class TestCSDBatchSum:
    """The fused trial-summed CSD (CrossSpectra.process_batch_sum, the
    coherence/CSD Gram): masking, padding garbage, counts, and equality
    with the per-trial path."""

    def _spectra64(self, cr, x):
        from syncopy_tpu.ops.windows import make_tapers

        cfg = cr.cfg
        taps = make_tapers(cfg["taper"], cfg["taper_opt"], x.shape[1], x.shape[1],
                           cfg["samplerate"]).astype(np.float64)
        xd = x.astype(np.float64) - x.astype(np.float64).mean(axis=1, keepdims=True)
        return np.fft.rfft(taps[None, :, :, None] * xd[:, None], axis=2), taps.shape[0]

    def test_matches_f64_oracle_with_masking(self):
        import jax.numpy as jnp

        cr = _cross_spectra_cr()
        rng = np.random.default_rng(3)
        x = rng.normal(size=(11, 250, 6)).astype(np.float32)
        nv = 7
        got = np.asarray(cr.process_batch_sum(jnp.asarray(x), nv, **cr.cfg))[0]
        spec, K = self._spectra64(cr, x)
        want = _csd_oracle(spec, nv) / K
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
        assert np.allclose(got, np.conj(np.swapaxes(got, 1, 2)),
                           atol=1e-5 * np.abs(want).max())

    def test_nan_padding_rows_masked(self):
        """Rows at/past n_valid may be garbage (resident padding is
        kernel(0) output incl. NaN): they must be where-masked out."""
        import jax.numpy as jnp

        cr = _cross_spectra_cr()
        rng = np.random.default_rng(4)
        x = rng.normal(size=(9, 250, 4)).astype(np.float32)
        poisoned = x.copy()
        poisoned[6:] = np.nan
        got = np.asarray(cr.process_batch_sum(jnp.asarray(poisoned), 6, **cr.cfg))[0]
        spec, K = self._spectra64(cr, x)
        want = _csd_oracle(spec, 6) / K
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    def test_zero_valid_rows_gives_zero(self):
        import jax.numpy as jnp

        cr = _cross_spectra_cr()
        x = np.random.default_rng(5).normal(size=(3, 250, 4)).astype(np.float32)
        got = np.asarray(cr.process_batch_sum(jnp.asarray(x), 0, **cr.cfg))
        assert np.all(got == 0)

    def test_full_count(self):
        import jax.numpy as jnp

        cr = _cross_spectra_cr()
        x = np.random.default_rng(6).normal(size=(5, 250, 3)).astype(np.float32)
        got = np.asarray(cr.process_batch_sum(jnp.asarray(x), 5, **cr.cfg))[0]
        spec, K = self._spectra64(cr, x)
        want = _csd_oracle(spec, 5) / K
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5

    def test_production_coherence_equivalence(self):
        """Fused trial-sum coherence equals the per-trial path's coherence
        below 1e-5 on the production shapes."""
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import cross_spectra_trial, normalize_csd

        fs, T, C, B = 1000.0, 250, 16, 40
        cr = _cross_spectra_cr(T, fs)
        x = np.random.default_rng(6).normal(size=(B, T, C)).astype(np.float32)
        cs_sum = np.asarray(cr.process_batch_sum(jnp.asarray(x), B, **cr.cfg))[0]
        coh_fused = np.asarray(normalize_csd(jnp.asarray(cs_sum / B), "abs"))
        per = sum(np.asarray(cross_spectra_trial(
            jnp.asarray(x[b]), fs, T, taper=cr.cfg["taper"],
            taper_opt=cr.cfg["taper_opt"]))[0] for b in range(B))
        coh_trial = np.asarray(normalize_csd(jnp.asarray(per / B), "abs"))
        assert np.abs(coh_fused - coh_trial).max() < 1e-5


def _ppc_oracle(spec, nv):
    spec = spec.astype(np.complex128)
    csd = np.einsum("nkfi,nkfj->nfij", spec, np.conj(spec)) / spec.shape[1]
    mag = np.abs(csd)
    unit = np.where(mag > 0, csd / np.where(mag > 0, mag, 1.0), 0.0)
    return unit[:nv].sum(axis=0)


def _ppc_impl(name):
    """The two PPC resultant implementations, on complex (N, K, F, C)
    input: the Triton kernel run by the Pallas interpreter, and XLA."""
    import jax.numpy as jnp

    from syncopy_tpu.ops.pallas_kernels import ppc_resultant_triton, ppc_resultant_xla

    if name == "triton":
        return lambda spec, nv: np.asarray(ppc_resultant_triton(
            jnp.asarray(spec.real), jnp.asarray(spec.imag), nv, interpret=True))
    return lambda spec, nv: np.asarray(ppc_resultant_xla(jnp.asarray(spec), nv))


@pytest.mark.parametrize("impl", ["triton", "xla"])
class TestPPCResultant:
    """PPC resultant of per-trial unit cross-spectra (ops/pallas_kernels.py)
    against a float64 oracle, for the GPU kernel (interpret mode) and the
    plain XLA form."""

    def test_matches_f64_oracle_with_masking(self, impl):
        rng = np.random.default_rng(5)
        N, K, F, C = 21, 3, 11, 19  # channels not a multiple of the tile
        spec = (rng.normal(size=(N, K, F, C))
                + 1j * rng.normal(size=(N, K, F, C))).astype(np.complex64)
        got = _ppc_impl(impl)(spec, 17)
        want = _ppc_oracle(spec, 17)
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-4
        # resultant terms are unit phasors: the diagonal is exactly nv
        assert np.allclose(got[:, np.arange(C), np.arange(C)].real, 17, atol=1e-3)

    def test_full_count_and_ppc_value(self, impl):
        rng = np.random.default_rng(8)
        N, K, F, C = 16, 2, 8, 4
        spec = (rng.normal(size=(N, K, F, C))
                + 1j * rng.normal(size=(N, K, F, C))).astype(np.complex64)
        U = _ppc_impl(impl)(spec, N)
        want = _ppc_oracle(spec, N)
        ppc_got = ((U * np.conj(U)).real - N) / (N * (N - 1))
        ppc_want = ((want * np.conj(want)).real - N) / (N * (N - 1))
        assert np.abs(ppc_got - ppc_want).max() < 1e-4
        assert np.allclose(ppc_got[:, np.arange(C), np.arange(C)], 1.0, atol=1e-4)

    def test_zero_trial_guard(self, impl):
        spec = np.zeros((4, 1, 3, 4), dtype=np.complex64)
        assert np.allclose(_ppc_impl(impl)(spec, 0), 0.0)

    def test_nan_padding_trials_masked(self, impl):
        """Trials at/past n_valid may be NaN garbage (resident padding):
        they must never reach the resultant."""
        rng = np.random.default_rng(11)
        N, K, F, C = 13, 2, 9, 6
        spec = (rng.normal(size=(N, K, F, C))
                + 1j * rng.normal(size=(N, K, F, C))).astype(np.complex64)
        poisoned = spec.copy()
        poisoned[9:] = np.nan
        got = _ppc_impl(impl)(poisoned, 9)
        assert np.isfinite(got).all()
        assert np.abs(got - _ppc_oracle(spec, 9)).max() < 1e-4


class TestPPCResultantSharded:
    """The Triton resultant split over a trial-sharded mesh (one kernel per
    device, partial sums psum-ed), run by the Pallas interpreter on four
    CPU devices against the float64 oracle."""

    @pytest.mark.parametrize("nv", [24, 17, 5, 0])
    def test_matches_f64_oracle(self, nv):
        """n_valid spanning all shards, ending mid-shard, leaving whole
        shards empty, and zero; trials past n_valid are NaN garbage."""
        import jax
        import jax.numpy as jnp

        from syncopy_tpu.ops.pallas_kernels import ppc_resultant_sharded
        from syncopy_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(nv)
        N, K, F, C = 24, 2, 5, 7
        spec = (rng.normal(size=(N, K, F, C))
                + 1j * rng.normal(size=(N, K, F, C))).astype(np.complex64)
        poisoned = spec.copy()
        poisoned[nv:] = np.nan
        mesh = make_mesh(devices=jax.devices()[:4])
        got = np.asarray(jax.jit(
            lambda s, n: ppc_resultant_sharded(s, n, mesh, interpret=True)
        )(jnp.asarray(poisoned), nv))
        assert got.shape == (F, C, C)
        assert np.isfinite(got).all()
        assert np.abs(got - _ppc_oracle(spec, nv)).max() < 1e-4

    def test_frontend_passes_engine_mesh(self, monkeypatch):
        """PPCSpectra hands the engine's mesh to the resultant, and the
        mesh result equals the single-device one."""
        from jax.sharding import Mesh

        import syncopy_tpu as spy
        from syncopy_tpu.engine import routine as _routine
        from syncopy_tpu.ops import pallas_kernels as pk

        seen = []
        real = pk.ppc_resultant

        def recording(spec, n_valid, mesh=None):
            seen.append(mesh)
            return real(spec, n_valid, mesh=mesh)

        monkeypatch.setattr(pk, "ppc_resultant", recording)
        _routine._GLOBAL_JIT_CACHE.clear()
        d = spy.synthdata.white_noise(nTrials=10, nSamples=200, nChannels=3, seed=4)
        solo = np.asarray(spy.connectivityanalysis(
            d, method="ppc", tapsmofrq=5, parallel=False).data)
        meshed = np.asarray(spy.connectivityanalysis(
            d, method="ppc", tapsmofrq=5, parallel=True).data)
        _routine._GLOBAL_JIT_CACHE.clear()
        assert seen[0] is None
        assert isinstance(seen[-1], Mesh) and seen[-1].size > 1
        assert np.abs(meshed - solo).max() < 1e-5


class TestPPCKernelChoice:
    """Which PPC resultant runs where, and what the GPU route compiles to."""

    def test_choice_by_platform(self, monkeypatch):
        import jax

        from syncopy_tpu.ops import pallas_kernels as pk

        from syncopy_tpu.parallel.mesh import make_mesh

        monkeypatch.setattr(pk, "ppc_resultant_triton", lambda re, im, nv: "triton")
        monkeypatch.setattr(pk, "ppc_resultant_sharded", lambda spec, nv, mesh: "sharded")
        monkeypatch.setattr(pk, "ppc_resultant_xla", lambda spec, nv: "xla")
        spec = np.zeros((2, 1, 3, 4), dtype=np.complex64)
        mesh4 = make_mesh(devices=jax.devices()[:4])
        mesh1 = make_mesh(devices=jax.devices()[:1])
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert pk.ppc_resultant(spec, 2) == "triton"
        assert pk.ppc_resultant(spec, 2, mesh=mesh1) == "triton"
        assert pk.ppc_resultant(spec, 2, mesh=mesh4) == "sharded"
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        assert pk.ppc_resultant(spec, 2) == "xla"
        assert pk.ppc_resultant(spec, 2, mesh=mesh4) == "xla"
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(NotImplementedError):
            pk.ppc_resultant(spec, 2)

    def test_block_sizes(self):
        from syncopy_tpu.ops.pallas_kernels import ppc_block_for

        assert ppc_block_for(3) == 16
        assert ppc_block_for(19) == 32
        assert ppc_block_for(64) == 32
        assert ppc_block_for(1024) == 32

    def test_lowers_to_triton_for_cuda(self):
        """The kernel lowers for the CUDA platform through Triton (the
        GPU compiler itself runs only on the card)."""
        import jax
        import jax.numpy as jnp

        from syncopy_tpu.ops.pallas_kernels import ppc_resultant_triton

        re = jnp.zeros((5, 3, 7, 64), jnp.float32)
        lowered = jax.jit(lambda a, b: ppc_resultant_triton(a, b, 4)).trace(
            re, re).lower(lowering_platforms=("cuda",))
        text = lowered.as_text()
        assert "triton" in text.lower()
        assert "ppc_resultant" in text

    def test_device_bytes_follow_path(self, monkeypatch):
        import jax

        from syncopy_tpu.connectivity.ST_compRoutines import PPCSpectra

        cr = PPCSpectra(samplerate=1000.0, nSamples=1000, taper="hann")
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        gpu = cr.device_bytes_per_trial((1000, 64), None, None)
        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        cpu = cr.device_bytes_per_trial((1000, 64), None, None)
        # only the XLA path keeps the (F, C, C) per-trial stack
        assert cpu - gpu > 501 * 64 * 64 * 8 * 0.9


class TestMatmulFFT:
    """Two-stage Cooley-Tukey matmul rfft (ops/fft.py), selected by
    SPY_TPU_MATMUL_FFT=1."""

    def test_matches_numpy_rfft(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.fft import rfft_via_matmul

        rng = np.random.default_rng(8)
        for nfft, T in ((1000, 1000), (256, 200), (360, 360)):
            x = rng.normal(size=(3, 2, T, 5)).astype(np.float32)
            got = np.asarray(rfft_via_matmul(jnp.asarray(x), nfft, axis=2))
            want = np.fft.rfft(x.astype(np.float64), n=nfft, axis=2)
            assert got.shape == want.shape
            assert np.abs(got - want).max() / np.abs(want).max() < 1e-6

    def test_prime_length_falls_back(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.fft import matmul_fft_split, rfft_via_matmul

        assert matmul_fft_split(97) is None
        x = np.random.default_rng(1).normal(size=(97, 2)).astype(np.float32)
        got = np.asarray(rfft_via_matmul(jnp.asarray(x), 97, axis=0))
        want = np.fft.rfft(x.astype(np.float64), axis=0)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6

    def test_split_selection(self):
        from syncopy_tpu.ops.fft import matmul_fft_split

        for n in (1000, 1024, 500, 250, 800, 2048):
            n1, n2 = matmul_fft_split(n)
            assert n1 * n2 == n


class TestCcovLagGemm:
    """The lag-batched Gram cross-covariance (``_ccov_lags_gemm``, called
    directly; no production path takes it) must match the FFT correlation
    to float32 rounding, even/odd lengths, including the block-tail clamp
    region (ops/connectivity.py)."""

    @pytest.mark.parametrize("T", [1000, 999, 100, 101, 64, 65])
    def test_gemm_matches_fft(self, T):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import _ccov_lags_fft, _ccov_lags_gemm

        rng = np.random.default_rng(T)
        x = jnp.asarray(rng.normal(size=(T, 5)).astype(np.float32))
        n_lags = T // 2 if T % 2 == 0 else T // 2 + 1
        delta = 1 if T % 2 == 0 else 0
        a = np.asarray(_ccov_lags_fft(x, n_lags, delta))
        b = np.asarray(_ccov_lags_gemm(x, n_lags, delta))
        assert a.shape == b.shape
        assert np.abs(a - b).max() / np.abs(a).max() < 2e-6

    def test_trial_path_uses_gemm_on_accelerator(self, monkeypatch):
        """cross_covariance_trial takes the FFT correlation on every
        backend (the lag Grams lose on the GPU) and agrees with the lag
        Grams assembled the same way."""
        import jax.numpy as jnp

        from syncopy_tpu.ops import connectivity as oc

        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.normal(size=(200, 4)).astype(np.float32))
        xd = oc.detrend(x, 0, axis=0)
        n_lags, delta = oc._ccov_lag_geometry(200)
        want = np.asarray(oc._ccov_assemble(oc._ccov_lags_gemm(xd, n_lags, delta), 200))
        called = {}
        real_gemm = oc._ccov_lags_gemm

        def spy_gemm(*a, **k):
            called["yes"] = True
            return real_gemm(*a, **k)

        monkeypatch.setattr(oc, "_ccov_lags_gemm", spy_gemm)
        for backend in ("cpu", "gpu"):
            monkeypatch.setattr(oc.jax, "default_backend", lambda b=backend: b)
            got = np.asarray(oc.cross_covariance_trial(x, polyremoval=0))[:, 0]
            assert not called, f"{backend}: the lag Grams are off every path"
            assert np.abs(got - want).max() / np.abs(want).max() < 2e-6


class TestCcovBatchSum:
    """The fused keeptrials=False cross-covariance path (frequency-domain
    trial Gram + one inverse FFT, ops/connectivity.py::ccov_batch_sum)
    must match the per-trial sum to FFT rounding, mask padding rows
    (including NaN garbage), and the norm=True CR fallback must keep
    per-trial normalization semantics."""

    @pytest.mark.parametrize("T", [1000, 999, 64])
    def test_matches_per_trial_sum(self, T):
        import jax.numpy as jnp

        from syncopy_tpu.ops.connectivity import (
            ccov_batch_sum,
            cross_covariance_trial,
        )

        rng = np.random.default_rng(T)
        x = rng.normal(size=(6, T, 4)).astype(np.float32)
        pad = np.full((2, T, 4), np.nan, np.float32)  # masked garbage rows
        xb = jnp.asarray(np.concatenate([x, pad]))
        want = sum(
            np.asarray(cross_covariance_trial(xb[i], polyremoval=1))
            for i in range(6)
        )
        got = np.asarray(ccov_batch_sum(xb, 6, polyremoval=1))
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-6

    def test_cr_norm_fallback(self):
        """CrossCovariance.process_batch_sum with norm=True sums per-trial
        NORMALIZED covariances (not the fused linear path)."""
        import jax.numpy as jnp

        from syncopy_tpu.connectivity.ST_compRoutines import CrossCovariance
        from syncopy_tpu.ops.connectivity import cross_covariance_trial

        rng = np.random.default_rng(7)
        xb = jnp.asarray(rng.normal(size=(5, 100, 3)).astype(np.float32))
        cr = CrossCovariance(samplerate=1.0, polyremoval=0, norm=True)
        got = np.asarray(cr.process_batch_sum(xb, 4, **cr.cfg))
        want = sum(
            np.asarray(cross_covariance_trial(xb[i], polyremoval=0, norm=True))
            for i in range(4)
        )
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-6


class TestPreferredFFTLen:
    """Padded-convolution lengths are always pow2 (bucketed pow2 platform
    ifft measured faster than any {2,3}-smooth matmul variant — see
    preferred_fft_len's docstring)."""

    def test_pow2_everywhere(self):
        from syncopy_tpu.ops.fft import preferred_fft_len

        for n in (1000, 3388, 2048, 1025, 5, 97):
            L = preferred_fft_len(n)
            assert L >= n and L & (L - 1) == 0
        assert preferred_fft_len(2048) == 2048
        assert preferred_fft_len(3388) == 4096


class TestMatmulIFFT:
    """Cropped inverse matmul DFT (ops/fft.py), the wavelet-bank inverse
    transform where SPY_TPU_MATMUL_FFT=1 selects it."""

    def test_matches_numpy_ifft(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.fft import ifft_via_matmul

        rng = np.random.default_rng(9)
        for N, n_out in ((2048, 1000), (250, 250), (360, 100)):
            X = (rng.normal(size=(2, N, 3))
                 + 1j * rng.normal(size=(2, N, 3))).astype(np.complex64)
            got = np.asarray(ifft_via_matmul(jnp.asarray(X), axis=1, n_out=n_out))
            want = np.fft.ifft(X.astype(np.complex128), axis=1)[:, :n_out]
            assert got.shape == want.shape
            assert np.abs(got - want).max() / np.abs(want).max() < 1e-6

    def test_prime_length_falls_back(self):
        import jax.numpy as jnp

        from syncopy_tpu.ops.fft import ifft_via_matmul

        X = (np.random.default_rng(2).normal(size=(89, 2))
             + 1j * np.random.default_rng(3).normal(size=(89, 2))).astype(np.complex64)
        got = np.asarray(ifft_via_matmul(jnp.asarray(X), axis=0, n_out=40))
        want = np.fft.ifft(X.astype(np.complex128), axis=0)[:40]
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
