# -*- coding: utf-8 -*-
# Multi-device sharding tests on the virtual 8-device CPU mesh: channel
# axis sharding through the engine, halo-exchange time sharding, and the
# graft entry points.

import os

import numpy as np
import pytest

import syncopy_tpu as spy


class TestHaloFIR:
    def test_matches_unsharded(self, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.filtering import apply_fir, apply_fir_time_sharded, design_wsinc

        rng = np.random.default_rng(0)
        x = rng.normal(size=(1600, 4)).astype("f4")
        kern = design_wsinc("hamming", 200, 0.1, "lp")  # odd length 201
        ref = np.asarray(apply_fir(jnp.asarray(x), kern))
        got = np.asarray(apply_fir_time_sharded(x, kern, testmesh, axis_name="trial"))
        assert np.abs(got - ref).max() < 1e-5

    def test_rejects_even_kernel(self, testmesh):
        from syncopy_tpu.ops.filtering import apply_fir_time_sharded

        with pytest.raises(ValueError):
            apply_fir_time_sharded(np.zeros((800, 2), "f4"), np.ones(10), testmesh)


class TestChannelAxisSharding:
    def test_engine_results_invariant(self, testmesh):
        """4x2 (trial x channel) mesh with the channel dim actually sharded
        must reproduce the single-device result."""
        data = spy.synthdata.white_noise(nTrials=8, nSamples=512, nChannels=8, seed=0)
        seq = spy.freqanalysis(data, method="mtmfft", taper="hann")
        with spy.use_mesh(testmesh):
            par = spy.freqanalysis(data, method="mtmfft", taper="hann")
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=1e-6)

    def test_cross_spectra_with_channel_sharding(self, testmesh):
        data = spy.synthdata.ar2_network(nTrials=16, samplerate=200, nSamples=512, seed=1)
        # 2 channels over a 2-way channel axis
        seq = spy.connectivityanalysis(data, method="coh", tapsmofrq=3)
        with spy.use_mesh(testmesh):
            par = spy.connectivityanalysis(data, method="coh", tapsmofrq=3)
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=1e-5)


class TestGraftEntry:
    def test_entry_and_dryrun(self):
        import sys

        sys.path.insert(0, "/root/repo")
        import jax

        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out.shape[-1] == out.shape[-2]
        g.dryrun_multichip(8)


class TestShardedNewPaths:
    def test_welch_on_mesh(self, testmesh):
        import syncopy_tpu as spy

        d = spy.synthdata.white_noise(nTrials=8, nSamples=512, nChannels=4, seed=21)
        seq = spy.freqanalysis(d, method="welch", t_ftimwin=0.25, toi=0.5)
        with spy.use_mesh(testmesh):
            par = spy.freqanalysis(d, method="welch", t_ftimwin=0.25, toi=0.5)
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=1e-6)

    def test_packed_csd_on_mesh(self, testmesh):
        import syncopy_tpu as spy

        d = spy.synthdata.ar2_network(nTrials=16, samplerate=200, nSamples=400, seed=22)
        seq = spy.connectivityanalysis(d, method="csd", tapsmofrq=2)
        with spy.use_mesh(testmesh):
            par = spy.connectivityanalysis(d, method="csd", tapsmofrq=2)
        assert np.allclose(np.asarray(seq.data), np.asarray(par.data), atol=1e-6)


class TestShardedWilson:
    """Mesh-sharded Wilson factorization (the >512-channel Granger path:
    frequency-sharded linalg alternating with channel-sharded lag FFTs)."""

    @staticmethod
    def _make_csd(N=6, seed=0):
        """Trial-averaged multitaper CSD of a coupled AR(2) network — a
        valid (factorizable) spectral density, 101 one-sided bins (not
        divisible by the 4-way mesh axis: exercises GSPMD's padding)."""
        import jax

        from syncopy_tpu.ops.connectivity import cross_spectra_trial

        adj = spy.synthdata.mk_RandomAdjMat(N, conn_thresh=0.8, max_coupling=0.15, seed=seed)
        adj = adj / max(1.0, 3 * np.abs(np.linalg.eigvals(adj)).max())
        ad = spy.synthdata.ar2_network(AdjMat=adj, nTrials=40, nSamples=200, seed=seed)
        acc = 0.0
        for k in range(len(ad.trials)):
            import jax.numpy as jnp

            cs = np.asarray(
                cross_spectra_trial(
                    jnp.asarray(np.asarray(ad.trials[k], dtype=np.float64)),
                    1000.0, 200, taper="hann",
                )
            )[0]
            acc = acc + cs.astype(np.complex128)
        csd = acc / len(ad.trials)
        dtype = "complex128" if jax.config.jax_enable_x64 else "complex64"
        return csd.astype(dtype)

    def test_matches_single_device(self, testmesh):
        import jax

        from syncopy_tpu.ops.connectivity import wilson_sf, wilson_sf_sharded

        CSD = self._make_csd()
        H0, S0, conv0, err0 = map(np.asarray, wilson_sf(CSD))
        H1, S1, conv1, err1 = map(
            np.asarray, wilson_sf_sharded(CSD, mesh=testmesh, axis_name="trial")
        )
        assert bool(conv0) and bool(conv1)
        tol = 1e-8 if jax.config.jax_enable_x64 else 5e-4
        assert np.abs(H1 - H0).max() < tol * max(np.abs(H0).max(), 1)
        assert np.abs(S1 - S0).max() < tol * max(np.abs(S0).max(), 1)

    def test_factorization_property(self, testmesh):
        """psi = H @ chol(Sigma)-ish: the factorization must reproduce the
        CSD itself: S(w) = H(w) Sigma H(w)^H (Geweke's identity)."""
        from syncopy_tpu.ops.connectivity import wilson_sf_sharded

        CSD = self._make_csd(seed=3)
        H, Sigma, conv, err = wilson_sf_sharded(CSD, mesh=testmesh, axis_name="trial")
        H, Sigma = np.asarray(H), np.asarray(Sigma)
        rebuilt = np.einsum("fij,jk,flk->fil", H, Sigma, np.conj(H))
        rel = np.abs(rebuilt - CSD).max() / np.abs(CSD).max()
        assert bool(conv) and rel < 1e-4

    def test_granger_sharded_info(self, testmesh):
        from syncopy_tpu.ops.connectivity import granger_sharded

        CSD = self._make_csd(seed=5)
        G, info = granger_sharded(CSD, mesh=testmesh, axis_name="trial")
        G = np.asarray(G)
        assert G.shape == CSD.shape and np.all(np.isfinite(G)) and np.all(G >= 0)
        assert info["converged"] and info["max rel. err"] < 5e-6

    def test_active_mesh_default(self, testmesh):
        from syncopy_tpu.ops.connectivity import wilson_sf_sharded

        with spy.use_mesh(testmesh):
            H, Sigma, conv, err = wilson_sf_sharded(self._make_csd(seed=7))
        assert bool(np.asarray(conv))

    def test_no_mesh_raises(self):
        from syncopy_tpu.ops.connectivity import wilson_sf_sharded

        if spy.active_mesh() is not None:
            pytest.skip("ambient mesh active")
        with pytest.raises(ValueError):
            wilson_sf_sharded(self._make_csd())


class TestTimeShardedTransforms:
    """Halo'd time-axis sharding of the windowed transforms (SURVEY §5
    long-context): sharded == unsharded, and a long-trial case runs."""

    def test_stft_matches_unsharded(self, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.stft import mtmconvol, mtmconvol_time_sharded
        from syncopy_tpu.ops.windows import make_tapers

        rng = np.random.default_rng(2)
        T, C, nperseg = 1024, 3, 64
        x = rng.normal(size=(T, C)).astype("f4")
        tapers = np.asarray(make_tapers("hann", None, nperseg, nperseg, 1000.0))
        ref = np.asarray(
            mtmconvol(jnp.asarray(x), jnp.asarray(tapers), jnp.arange(T), nperseg)
        )
        got = np.asarray(
            mtmconvol_time_sharded(x, tapers, nperseg, testmesh, axis_name="trial")
        )
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-5

    def test_stft_power_dpss(self, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.stft import mtmconvol, mtmconvol_time_sharded
        from syncopy_tpu.ops.windows import make_tapers

        rng = np.random.default_rng(3)
        T, C, nperseg = 512, 2, 128
        x = rng.normal(size=(T, C)).astype("f4")
        tapers = np.asarray(
            make_tapers("dpss", {"Kmax": 3, "NW": 2}, nperseg, nperseg, 1000.0)
        )
        ref = np.asarray(
            mtmconvol(jnp.asarray(x), jnp.asarray(tapers), jnp.arange(T), nperseg,
                      output="pow", keeptapers=False)
        )
        got = np.asarray(
            mtmconvol_time_sharded(x, tapers, nperseg, testmesh,
                                   output="pow", keeptapers=False)
        )
        assert np.abs(got - ref).max() < 1e-4

    def test_cwt_matches_unsharded(self, testmesh):
        import jax.numpy as jnp

        from syncopy_tpu.ops.wavelet import Morlet, cwt, cwt_time_sharded

        rng = np.random.default_rng(4)
        T, C = 2048, 2
        dt = 1.0 / 1000.0
        x = rng.normal(size=(T, C)).astype("f4")
        scales = np.array([0.01, 0.02, 0.04])
        ref = np.asarray(cwt(jnp.asarray(x), Morlet(6), scales, dt))
        got = np.asarray(cwt_time_sharded(x, Morlet(6), scales, dt, testmesh))
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-5

    def test_cwt_halo_guard(self, testmesh):
        from syncopy_tpu.ops.wavelet import Morlet, cwt_time_sharded

        # scale so large the halo exceeds the local shard -> explicit error
        with pytest.raises(ValueError, match="halo"):
            cwt_time_sharded(np.zeros((1024, 1), "f4"), Morlet(6),
                             np.array([1.0]), 1.0 / 1000.0, testmesh)

    def test_long_trial_runs_sharded(self, testmesh):
        from syncopy_tpu.ops.wavelet import Morlet, cwt_time_sharded

        # ~1e6 samples: the full-signal FFT bank would be (S, 2^21) complex
        # per channel on ONE device; sharded it is 8x smaller per device
        T = 1 << 20
        t = np.arange(T, dtype="f4") / 1000.0
        x = np.sin(2 * np.pi * 40 * t)[:, None].astype("f4")
        scales = np.array([0.004, 0.008])
        spec = cwt_time_sharded(x, Morlet(6), scales, 1.0 / 1000.0, testmesh)
        power = np.abs(np.asarray(spec[:, T // 2 - 512 : T // 2 + 512, 0]))
        # the 40 Hz scale (0.004 ~ 40 Hz Morlet) dominates mid-signal
        assert power[0].mean() > power[1].mean()


class TestMultiHostDistributed:
    """2-process `jax.distributed` dryrun: spawns
    two worker processes that initialize a CPU cluster through
    spy.init_distributed, build the global ("trial", "channel") mesh over
    8 devices (4 per process), and run one trial-sharded coherence step
    with a cross-process psum, each verifying against a numpy oracle.

    The analog of the reference's LocalCluster-based distributed tests
    (reference tests/conftest.py:19-61)."""

    def test_two_process_cluster(self, tmp_path):
        import socket
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        worker = os.path.join(repo, "scripts", "multihost_worker.py")
        assert os.path.exists(worker)

        # free port from the OS
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]

        env = dict(os.environ)
        env["PYTHONPATH"] = repo
        env.pop("XLA_FLAGS", None)  # the worker sets its own device count
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(i), "2", str(port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            )
            for i in range(2)
        ]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=240)
                outs.append(out.decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 and (
                "distributed runtime is not available" in out
                or "Unavailable" in out and "coordin" in out.lower()
            ):
                pytest.skip("jax.distributed unsupported here: {}".format(
                    out.strip().splitlines()[-1][:200]))
            assert p.returncode == 0, "worker {} failed:\n{}".format(i, out[-3000:])
            assert "MULTIHOST OK process {}/2 global_devices=8".format(i) in out
