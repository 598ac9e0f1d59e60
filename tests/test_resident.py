# -*- coding: utf-8 -*-
#
# Device-resident outputs (engine/resident.py): chained pipelines must stay
# in HBM until the final stage, with deferred readback that is bit-equal to
# the eager host path.

import os

import numpy as np
import pytest

import syncopy_tpu as spy
from syncopy_tpu.engine import routine
from syncopy_tpu.engine.resident import DeferredArray, _REGISTRY


@pytest.fixture()
def adata():
    rng = np.random.default_rng(7)
    arr = rng.normal(size=(20 * 256, 4)).astype(np.float32)
    trl = np.stack([np.arange(0, 20 * 256, 256), np.arange(256, 20 * 256 + 1, 256),
                    np.full(20, -50)], axis=1)
    return spy.AnalogData(data=arr, samplerate=1000, trialdefinition=trl)


def _host_reference(adata, fn, *args, **kwargs):
    """Run `fn` with residency disabled."""
    import os

    os.environ["SPY_TPU_DEVICE_RESIDENT"] = "0"
    try:
        return fn(adata, *args, **kwargs)
    finally:
        del os.environ["SPY_TPU_DEVICE_RESIDENT"]


@pytest.mark.skipif(os.environ.get("SPY_TPU_DEVICE_RESIDENT") == "0",
                    reason="device residency disabled via env")
class TestResidentChain:
    def test_chain_stays_on_device(self, adata):
        pre = spy.preprocessing(adata, filter_class="but", filter_type="lp",
                                freq=100, order=4)
        assert isinstance(pre._data, DeferredArray)
        spec = spy.freqanalysis(pre, method="mtmfft", output="fourier",
                                keeptrials=True)
        # consuming `pre` must NOT have materialized it
        assert isinstance(pre._data, DeferredArray)
        assert isinstance(spec._data, DeferredArray)
        coh = spy.connectivityanalysis(spec, method="coh")
        # the complex spectrum was consumed straight from HBM
        assert isinstance(spec._data, DeferredArray)
        assert coh.data.shape[-1] == 4

    def test_chain_matches_host_path(self, adata):
        pre = spy.preprocessing(adata, filter_class="but", filter_type="lp",
                                freq=100, order=4)
        spec = spy.freqanalysis(pre, method="mtmfft", output="fourier",
                                keeptrials=True)
        coh = spy.connectivityanalysis(spec, method="coh")

        pre2 = _host_reference(adata, spy.preprocessing, filter_class="but",
                               filter_type="lp", freq=100, order=4)
        spec2 = _host_reference(pre2, spy.freqanalysis, method="mtmfft",
                                output="fourier", keeptrials=True)
        coh2 = _host_reference(spec2, spy.connectivityanalysis, method="coh")

        assert np.array_equal(np.asarray(coh.data), np.asarray(coh2.data))
        assert np.array_equal(np.asarray(spec.data), np.asarray(spec2.data))
        assert np.array_equal(np.asarray(pre.data), np.asarray(pre2.data))

    def test_metadata_without_materialization(self, adata):
        spec = spy.freqanalysis(adata, method="mtmfft", output="pow",
                                keeptrials=True)
        # all of these are shape/label reads — none may trigger readback
        assert spec.data.shape == (20, 1, 129, 4)
        assert len(spec.freq) == 129
        assert len(spec.channel) == 4
        assert len(spec.trials) == 20
        str(spec)
        assert isinstance(spec._data, DeferredArray)

    def test_selection_falls_back_to_host(self, adata):
        pre = spy.preprocessing(adata, filter_class="but", filter_type="lp",
                                freq=100, order=4)
        spy.selectdata(pre, trials=[0, 2, 4], inplace=True)
        spec = spy.freqanalysis(pre, method="mtmfft", output="pow")
        pre._selection = None
        # fallback materialized the producer
        assert not isinstance(pre._data, DeferredArray)
        pre2 = _host_reference(adata, spy.preprocessing, filter_class="but",
                               filter_type="lp", freq=100, order=4)
        spy.selectdata(pre2, trials=[0, 2, 4], inplace=True)
        spec2 = _host_reference(pre2, spy.freqanalysis, method="mtmfft", output="pow")
        assert np.allclose(np.asarray(spec.data), np.asarray(spec2.data), atol=1e-6)

    def test_mutation_after_seal_disables_consumption(self, adata):
        pre = spy.preprocessing(adata, filter_class="but", filter_type="lp",
                                freq=100, order=4)
        res = pre._device_resident
        assert res.consumable_by(pre)
        # re-defining trials invalidates the trial->record mapping ...
        pre.trialdefinition = pre.trialdefinition
        assert not res.consumable_by(pre)
        # ... but the payload itself is still recoverable, bit-exact
        pre2 = _host_reference(adata, spy.preprocessing, filter_class="but",
                               filter_type="lp", freq=100, order=4)
        assert np.array_equal(np.asarray(pre.data), np.asarray(pre2.data))

    def test_ragged_trials_roundtrip(self):
        rng = np.random.default_rng(3)
        trls = [rng.normal(size=(n, 3)).astype("f4") for n in (300, 400, 300, 400)]
        ad = spy.AnalogData(data=trls, samplerate=1000)
        pre = spy.preprocessing(ad, filter_class="firws", filter_type="lp", freq=80)
        assert isinstance(pre._data, DeferredArray)
        pre2 = _host_reference(ad, spy.preprocessing, filter_class="firws",
                               filter_type="lp", freq=80)
        assert np.array_equal(np.asarray(pre.data), np.asarray(pre2.data))

    def test_hbm_budget_evicts_by_materializing(self, adata, monkeypatch):
        # one 5120x4 f32 result is 82-132 kB on device depending on chunk
        # padding (pow2 chunks vs SPY_TPU_CHUNK_BYTES=1); 150 kB admits one
        # result but never two, in ANY chunk layout
        monkeypatch.setenv("SPY_TPU_RESIDENT_BYTES", "150000")
        first = spy.preprocessing(adata, filter_class="but", filter_type="lp",
                                  freq=100, order=4)
        assert isinstance(first._data, DeferredArray)
        # the next resident result exceeds the budget together with `first`:
        # `first` must be flushed to host (data preserved), not dropped
        second = spy.preprocessing(adata, filter_class="but", filter_type="hp",
                                   freq=10, order=4)
        assert first._device_resident.materialized
        ref = _host_reference(adata, spy.preprocessing, filter_class="but",
                              filter_type="lp", freq=100, order=4)
        assert np.array_equal(np.asarray(first.data), np.asarray(ref.data))

    def test_save_materializes(self, adata, tmp_path):
        spec = spy.freqanalysis(adata, method="mtmfft", output="pow",
                                keeptrials=True)
        assert isinstance(spec._data, DeferredArray)
        spy.save(spec, container=str(tmp_path / "resident_spec"))
        loaded = spy.load(str(tmp_path / "resident_spec.spy"))
        assert np.array_equal(np.asarray(loaded.data), np.asarray(spec.data))

    def test_parallel_mesh_consumption(self, adata):
        from syncopy_tpu.parallel.mesh import make_mesh, use_mesh

        with use_mesh(make_mesh()):
            pre = spy.preprocessing(adata, filter_class="but", filter_type="lp",
                                    freq=100, order=4)
            assert isinstance(pre._data, DeferredArray)
            spec = spy.freqanalysis(pre, method="mtmfft", output="pow",
                                    keeptrials=True)
            assert isinstance(pre._data, DeferredArray)
        spec2 = _host_reference(adata, lambda d, **kw: spy.freqanalysis(
            spy.preprocessing(d, filter_class="but", filter_type="lp",
                              freq=100, order=4),
            method="mtmfft", output="pow", keeptrials=True))
        assert np.allclose(np.asarray(spec.data), np.asarray(spec2.data), atol=1e-5)

    def test_registry_prunes_dead_objects(self, adata):
        n0 = len([r for r in _REGISTRY if r() is not None])
        pre = spy.preprocessing(adata, filter_class="but", filter_type="lp",
                                freq=100, order=4)
        del pre
        import gc

        gc.collect()
        routine.clear_device_cache()  # also prunes the registry
        assert len([r for r in _REGISTRY if r() is not None]) <= n0 + 1


@pytest.mark.skipif(os.environ.get("SPY_TPU_DEVICE_RESIDENT") == "0",
                    reason="device residency disabled via env")
class TestStreamedReductions:
    """PPC / trial statistics / jackknife must consume device-resident
    inputs chunk-wise — never a whole-ensemble host stack."""

    @pytest.fixture()
    def spec(self, adata):
        return spy.freqanalysis(adata, method="mtmfft", output="fourier",
                                keeptrials=True)

    def test_itc_consumes_resident(self, spec):
        assert isinstance(spec._data, DeferredArray)
        res = spy.itc(spec)
        assert isinstance(spec._data, DeferredArray), "itc stacked on host"
        # oracle
        stack = np.stack([np.asarray(t) for t in spec.trials])
        unit = stack / np.abs(stack)
        itc_ref = np.abs(unit.mean(axis=0).mean(axis=0, keepdims=True))
        assert np.allclose(np.asarray(res.data), itc_ref, atol=1e-6)

    def test_trial_var_std_consume_resident(self, spec):
        v = spy.var(spec, dim="trials")
        s = spy.std(spec, dim="trials")
        assert isinstance(spec._data, DeferredArray), "var/std stacked on host"
        stack = np.stack([np.asarray(t) for t in spec.trials])
        var_ref = np.mean(np.abs(stack - stack.mean(axis=0)) ** 2, axis=0)
        assert np.allclose(np.asarray(v.data), var_ref, atol=1e-6)
        assert np.allclose(np.asarray(s.data), np.sqrt(var_ref), atol=1e-6)

    def test_ppc_consumes_resident_st_stage(self, adata):
        spec = spy.freqanalysis(adata, method="mtmfft", output="fourier",
                                keeptrials=True)
        ppc = spy.connectivityanalysis(spec, method="ppc")
        # the single-trial CSD stage inside connectivityanalysis produces a
        # resident object; PPC must reduce it on device
        from syncopy_tpu.ops.connectivity import ppc_from_spectra
        import jax.numpy as jnp

        csd = np.stack([
            np.einsum("tkfi,tkfj->tfij", np.asarray(t), np.conj(np.asarray(t))).mean(axis=0)
            for t in spec.trials
        ])[:, None][:, 0]
        ref = np.asarray(ppc_from_spectra(jnp.asarray(csd)))
        assert np.allclose(np.asarray(ppc.data)[0], ref, atol=1e-5)

    def test_jackknife_streams_and_matches_loo(self, adata):
        res = spy.connectivityanalysis(adata, method="coh", jackknife=True)
        var = np.asarray(res._get_extra_dataset("jack_var"))
        bias = np.asarray(res._get_extra_dataset("jack_bias"))
        # oracle: explicit per-replicate LOO coherence
        spec = spy.freqanalysis(adata, method="mtmfft", output="fourier",
                                keeptrials=True)
        csd = np.stack([
            np.einsum("kfi,kfj->fij", np.asarray(t)[0], np.conj(np.asarray(t)[0]))
            for t in spec.trials
        ])
        n = csd.shape[0]
        loo = (csd.sum(axis=0)[None] - csd) / (n - 1)

        def coh_of(c):
            d = np.sqrt(np.abs(np.einsum("fii->fi", c)))
            return np.abs(c) / (d[:, :, None] * d[:, None, :])

        reps = np.stack([coh_of(c) for c in loo])
        jack_avg = reps.mean(axis=0)
        var_ref = (n - 1) * np.sum(np.abs(reps - jack_avg[None]) ** 2, axis=0)
        direct = coh_of(csd.mean(axis=0))
        bias_ref = (n - 1) * (jack_avg - direct)
        assert np.allclose(var[0], var_ref, atol=1e-5)
        assert np.allclose(bias[0], bias_ref, atol=1e-5)

    def test_multichunk_reduction_matches(self, adata, monkeypatch):
        # force tiny chunks through the reduction path
        from syncopy_tpu.engine import routine

        monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 4)
        spec = spy.freqanalysis(adata, method="mtmfft", output="fourier",
                                keeptrials=True)
        v = spy.var(spec, dim="trials")
        stack = np.stack([np.asarray(t) for t in spec.trials])
        var_ref = np.mean(np.abs(stack - stack.mean(axis=0)) ** 2, axis=0)
        assert np.allclose(np.asarray(v.data), var_ref, atol=1e-6)

    def test_bounded_host_memory(self, adata, monkeypatch):
        """The reductions must not allocate the full trial ensemble on the
        host: with chunking forced small, peak traced allocations stay well
        below the ensemble size."""
        import tracemalloc

        from syncopy_tpu.engine import routine

        monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 2)
        monkeypatch.setenv("SPY_TPU_DEVICE_RESIDENT", "0")
        rng = np.random.default_rng(0)
        n_tr, n_smp, n_ch = 64, 1024, 8
        arr = rng.normal(size=(n_tr * n_smp, n_ch)).astype(np.float32)
        trl = np.stack([np.arange(0, n_tr * n_smp, n_smp),
                        np.arange(n_smp, n_tr * n_smp + 1, n_smp),
                        np.zeros(n_tr)], axis=1)
        ad = spy.AnalogData(data=arr, samplerate=1000, trialdefinition=trl)
        spec = spy.freqanalysis(ad, method="mtmfft", output="fourier",
                                keeptrials=True)
        ensemble_bytes = np.asarray(spec.data).nbytes
        tracemalloc.start()
        spy.itc(spec)
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        # a host np.stack of the ensemble would show up as >= ensemble_bytes
        assert peak < ensemble_bytes, (peak, ensemble_bytes)


@pytest.mark.skipif(os.environ.get("SPY_TPU_DEVICE_RESIDENT") == "0",
                    reason="device residency disabled via env")
class TestResidentSubChunking:
    """A consumer whose chunk budget is smaller than the producer's record
    size must split resident records on device (regression: jackknife
    Granger's Wilson workspace blew compile-time HBM when it inherited the
    LOO producer's 200-replicate chunks)."""

    def test_consumer_splits_producer_records(self, adata, monkeypatch):
        from syncopy_tpu.engine import routine

        spec = spy.freqanalysis(adata, method="mtmfft", output="fourier",
                                keeptrials=True)
        assert isinstance(spec._data, DeferredArray)
        # shrink the consumer's chunk ceiling below the producer's record
        monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 4)
        res = spy.itc(spec)
        # still consumed from HBM (no materialization) ...
        assert isinstance(spec._data, DeferredArray)
        # ... and numerically identical to the oracle
        stack = np.stack([np.asarray(t) for t in spec.trials])
        unit = stack / np.abs(stack)
        ref = np.abs(unit.mean(axis=0).mean(axis=0, keepdims=True))
        assert np.allclose(np.asarray(res.data), ref, atol=1e-6)

    def test_split_keeptrials_consumer(self, adata, monkeypatch):
        from syncopy_tpu.engine import routine

        pre = spy.preprocessing(adata, filter_class="but", filter_type="lp",
                                freq=100, order=4)
        monkeypatch.setattr(routine, "MAX_CHUNK_TRIALS", 4)
        spec = spy.freqanalysis(pre, method="mtmfft", output="pow",
                                keeptrials=True)
        assert isinstance(pre._data, DeferredArray)
        pre2 = _host_reference(adata, spy.preprocessing, filter_class="but",
                               filter_type="lp", freq=100, order=4)
        spec2 = _host_reference(pre2, spy.freqanalysis, method="mtmfft",
                                output="pow", keeptrials=True)
        assert np.allclose(np.asarray(spec.data), np.asarray(spec2.data),
                           atol=1e-6)


@pytest.mark.skipif(os.environ.get("SPY_TPU_DEVICE_RESIDENT", "1") == "0",
                    reason="device residency disabled")
class TestPlotResolutionView:
    """fetch_trial_view: plot-resolution readback of one resident trial,
    decimated + magnitude-reduced on device."""

    def _tfr(self, output="pow"):
        d = spy.synthdata.harmonic(freq=40, samplerate=500, nTrials=3,
                                   nSamples=1000, nChannels=2)
        return spy.freqanalysis(d, method="wavelet", output=output,
                                foi=np.arange(10, 60, 10.0), keeptrials=True)

    def test_view_matches_host_decimation(self):
        tf = self._tfr()
        res = tf._device_resident
        assert res is not None and res.consumable_by(tf)
        view, factor = res.fetch_trial_view(1, max_time=100)
        assert factor == 10 and view.shape[0] == 100
        full = np.asarray(tf.data)[1000:2000]  # trial 1 rows
        want = full[:1000].reshape(100, 10, *full.shape[1:]).mean(axis=1)
        assert np.allclose(view, want, atol=1e-5)

    def test_view_magnitude_for_complex(self):
        tf = self._tfr(output="fourier")
        res = tf._device_resident
        view, factor = res.fetch_trial_view(0, max_time=250)
        assert not np.iscomplexobj(view)
        full = np.abs(np.asarray(tf.data)[:1000])
        want = full.reshape(250, 4, *full.shape[1:]).mean(axis=1)
        assert np.allclose(view, want, atol=1e-4)

    def test_view_after_materialization(self):
        tf = self._tfr()
        res = tf._device_resident
        _ = np.asarray(tf.data)  # force readback
        view, factor = res.fetch_trial_view(2, max_time=100)
        assert view.shape[0] == 100 and factor == 10

    def test_plot_uses_decimated_view(self):
        pytest.importorskip("matplotlib")
        tf = self._tfr()
        fig, ax = spy.singlepanelplot(tf, trials=0)
        img = ax.get_images()[0]
        # the plotted image is at plot resolution, not the full 1000 cols
        assert img.get_array().shape[1] <= 1024
        import matplotlib.pyplot as plt

        plt.close(fig)

    def test_plot_with_list_trials_does_not_crash(self):
        pytest.importorskip("matplotlib")
        tf = self._tfr()
        fig, ax = spy.singlepanelplot(tf, trials=[1])  # list: host fallback
        assert ax.get_images()
        import matplotlib.pyplot as plt

        plt.close(fig)
