# -*- coding: utf-8 -*-
#
# Mesh invariance matrix: every analysis frontend must produce the same
# numbers on an 8-device (trial x channel) mesh as on a single device —
# the device analog of the reference's dask sequential-vs-parallel equality
# sweeps (tests/test_specest.py parallel blocks, test_connectivity.py
# `test_parallel`, test_resampledata.py `test_*_parallel`).

import numpy as np
import pytest

import syncopy_tpu as spy


ATOL = 1e-6


@pytest.fixture(scope="module")
def adata():
    return spy.synthdata.ar2_network(
        nTrials=12, AdjMat=np.zeros((4, 4)), nSamples=400, seed=8
    )


def _both(frontend, data, mesh, **kw):
    solo = frontend(data, parallel=False, **kw)
    with spy.use_mesh(mesh):
        dist = frontend(data, parallel=True, **kw)
    return np.asarray(solo.data), np.asarray(dist.data)


class TestMeshInvariance:
    def test_mtmfft(self, adata, testmesh):
        a, b = _both(spy.freqanalysis, adata, testmesh,
                     method="mtmfft", tapsmofrq=2, keeptrials=True)
        assert np.allclose(a, b, atol=ATOL)

    def test_mtmfft_trialaverage(self, adata, testmesh):
        a, b = _both(spy.freqanalysis, adata, testmesh,
                     method="mtmfft", taper="hann", keeptrials=False)
        assert np.allclose(a, b, atol=ATOL)

    def test_wavelet(self, adata, testmesh):
        a, b = _both(spy.freqanalysis, adata, testmesh, method="wavelet",
                     foi=np.arange(10, 60, 10.0))
        assert np.allclose(a, b, atol=ATOL)

    def test_superlet(self, adata, testmesh):
        a, b = _both(spy.freqanalysis, adata, testmesh, method="superlet",
                     foi=np.arange(10, 60, 10.0), order_max=5)
        assert np.allclose(a, b, atol=ATOL)

    def test_mtmconvol(self, adata, testmesh):
        a, b = _both(spy.freqanalysis, adata, testmesh, method="mtmconvol",
                     t_ftimwin=0.1, taper="hann")
        assert np.allclose(a, b, atol=ATOL, equal_nan=True)

    def test_coherence(self, adata, testmesh):
        a, b = _both(spy.connectivityanalysis, adata, testmesh,
                     method="coh", tapsmofrq=2)
        assert np.allclose(a, b, atol=ATOL)

    def test_granger(self, testmesh):
        # Granger is NOT bit-invariant across shardings: the compensated
        # CSD summation is exact per (chunk x device-shard) and partials
        # combine in f32, so the averaged CSD moves ~1e-6 relative; Wilson
        # factorization amplifies that strongly on near-singular (zero
        # coupling, few trials) inputs. On a well-conditioned coupled
        # system the results must agree scientifically: same convergence,
        # same coupling structure, small numeric delta.
        AdjMat = np.zeros((2, 2))
        AdjMat[0, 1] = 0.25
        ad = spy.synthdata.ar2_network(nTrials=40, AdjMat=AdjMat,
                                       nSamples=500, seed=8)
        solo = spy.connectivityanalysis(ad, method="granger", tapsmofrq=3,
                                        parallel=False)
        with spy.use_mesh(testmesh):
            dist = spy.connectivityanalysis(ad, method="granger",
                                            tapsmofrq=3, parallel=True)
        assert solo.info["converged"] and dist.info["converged"]
        a, b = np.asarray(solo.data), np.asarray(dist.data)
        # low-power bins see the strongest Wilson amplification of the
        # sharding-dependent ~1e-6 CSD rounding: 2e-2 absolute bounds it
        # while still failing on any structural disagreement
        assert np.allclose(a, b, atol=2e-2)
        # the 0 -> 1 coupling dominates in both
        band = slice(20, 80)
        assert a[0, band, 0, 1].mean() > 5 * abs(a[0, band, 1, 0]).mean()
        assert b[0, band, 0, 1].mean() > 5 * abs(b[0, band, 1, 0]).mean()

    def test_granger_wide_channel_bound(self, testmesh):
        """Quantitative mesh-variance bound at realistic channel width
        (16-ch coupled network): the sharding-induced deviation must stay
        (a) under the documented absolute/rms bounds and (b) far below the
        estimator's own trial-sampling noise, measured in-run as the
        half-split delta. Measured reference values (doc/scaling.md):
        max|d| ~1.5e-2, rms ~3e-4 vs estimator rms ~1.7e-2 at 160 trials;
        32-ch measurements are of the same magnitude."""
        C, nT, nS = 16, 160, 300
        Adj = spy.synthdata.mk_RandomAdjMat(nChannels=C, max_coupling=2.0 / C, seed=3)
        ad = spy.synthdata.ar2_network(nTrials=nT, AdjMat=Adj, nSamples=nS, seed=3)
        solo = spy.connectivityanalysis(ad, method="granger", tapsmofrq=3,
                                        parallel=False)
        with spy.use_mesh(testmesh):
            dist = spy.connectivityanalysis(ad, method="granger", tapsmofrq=3,
                                            parallel=True)
        assert solo.info["converged"] and dist.info["converged"]
        a, b = np.asarray(solo.data), np.asarray(dist.data)
        d = np.abs(a - b)
        assert d.max() < 2e-2  # same absolute bound as the 2-ch case
        assert np.sqrt((d ** 2).mean()) < 1.5e-3  # rms bound (measured 3e-4)
        # structure preserved
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999

        # scientific irrelevance: sharding noise << estimator noise
        h1 = spy.connectivityanalysis(ad, method="granger", tapsmofrq=3,
                                      parallel=False,
                                      select={"trials": list(range(nT // 2))})
        h2 = spy.connectivityanalysis(ad, method="granger", tapsmofrq=3,
                                      parallel=False,
                                      select={"trials": list(range(nT // 2, nT))})
        est = np.asarray(h1.data) - np.asarray(h2.data)
        est_rms = np.sqrt((est ** 2).mean())
        shard_rms = np.sqrt((d ** 2).mean())
        assert shard_rms < est_rms / 5, (shard_rms, est_rms)

    def test_ppc(self, adata, testmesh):
        a, b = _both(spy.connectivityanalysis, adata, testmesh,
                     method="ppc", tapsmofrq=2)
        assert np.allclose(a, b, atol=ATOL, equal_nan=True)

    def test_corr(self, adata, testmesh):
        a, b = _both(spy.connectivityanalysis, adata, testmesh, method="corr")
        assert np.allclose(a, b, atol=ATOL)

    def test_preprocessing(self, adata, testmesh):
        a, b = _both(spy.preprocessing, adata, testmesh,
                     filter_class="but", filter_type="lp", freq=80)
        assert np.allclose(a, b, atol=ATOL)

    def test_resample(self, adata, testmesh):
        a, b = _both(spy.resampledata, adata, testmesh,
                     method="resample", resamplefs=250)
        assert np.allclose(a, b, atol=ATOL)

    def test_itc(self, adata, testmesh):
        spec = spy.freqanalysis(adata, method="mtmfft", taper="hann",
                                output="fourier", keeptrials=True)
        a = np.asarray(spy.itc(spec, parallel=False).data)
        with spy.use_mesh(testmesh):
            b = np.asarray(spy.itc(spec, parallel=True).data)
        assert np.allclose(a, b, atol=ATOL)

    def test_selection_on_mesh(self, adata, testmesh):
        # uneven selected trial count (9 over 4 trial-shards) still matches
        sel = {"trials": list(range(9)), "channel": [2, 0, 1]}
        a, b = _both(spy.freqanalysis, adata, testmesh,
                     method="mtmfft", taper="hann", select=sel)
        assert np.allclose(a, b, atol=ATOL)
