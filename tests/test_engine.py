# -*- coding: utf-8 -*-
# Engine conformance suite with a toy kernel (modeled on reference
# tests/test_computationalroutine.py: its LowPassFilter CR + frontend).

import os

import jax.numpy as jnp
import numpy as np
import pytest

import syncopy_tpu as spy
from syncopy_tpu.engine.routine import ComputationalRoutine


class TimesTwo(ComputationalRoutine):
    """Toy CR: double the signal, keep shape."""

    valid_kws = []

    def process_single_trial(self, trial, **cfg):
        return trial * 2.0

    def process_metadata(self, data, out):
        if self.keeptrials:
            trl = np.array(self.selector.trialdefinition)
        else:
            trl = np.array(self.selector.trialdefinition[:1])
        out.trialdefinition = trl
        out.samplerate = data.samplerate
        self.propagate_properties(data, out)


class ChannelMean(ComputationalRoutine):
    """Toy CR with shape change: average over channels -> (time, 1)."""

    valid_kws = []

    def process_single_trial(self, trial, **cfg):
        return jnp.mean(trial, axis=1, keepdims=True)

    def process_metadata(self, data, out):
        out.trialdefinition = np.array(self.selector.trialdefinition)
        out.samplerate = data.samplerate


def run_cr(cr, data, keeptrials=True, parallel=None):
    out = spy.AnalogData(dimord=["time", "channel"])
    cr.initialize(data, out._stackingDim, keeptrials=keeptrials)
    cr.compute(data, out, parallel=parallel)
    return out


class TestSequential:
    def test_identity_shape(self, adata_equal):
        out = run_cr(TimesTwo(), adata_equal)
        assert out.data.shape == adata_equal.data.shape
        assert np.allclose(np.asarray(out.data), 2 * np.asarray(adata_equal.data))
        assert len(out.trials) == len(adata_equal.trials)

    def test_ragged_trials(self, adata_ragged):
        out = run_cr(TimesTwo(), adata_ragged)
        for k in range(len(adata_ragged.trials)):
            assert np.allclose(
                np.asarray(out.trials[k]), 2 * np.asarray(adata_ragged.trials[k])
            )

    def test_keeptrials_false(self, adata_equal):
        out = run_cr(TimesTwo(), adata_equal, keeptrials=False)
        expected = 2 * np.mean(
            np.stack([np.asarray(t) for t in adata_equal.trials]), axis=0
        )
        assert np.allclose(np.asarray(out.data), expected, atol=1e-6)

    def test_keeptrials_false_ragged_raises(self, adata_ragged):
        cr = TimesTwo()
        with pytest.raises(spy.SPYValueError):
            cr.initialize(adata_ragged, 0, keeptrials=False)

    def test_shape_change(self, adata_equal):
        out = run_cr(ChannelMean(), adata_equal)
        assert out.data.shape[1] == 1
        assert np.allclose(
            np.asarray(out.trials[0]),
            np.asarray(adata_equal.trials[0]).mean(axis=1, keepdims=True),
            atol=1e-6,
        )

    def test_selection(self, adata_equal):
        adata_equal.selectdata(trials=[1, 3], channel=[0, 2], inplace=True)
        out = run_cr(TimesTwo(), adata_equal)
        assert len(out.trials) == 2
        assert out.data.shape[1] == 2
        expected = 2 * np.asarray(adata_equal.trials[1])[:, [0, 2]]
        assert np.allclose(np.asarray(out.trials[0]), expected)
        adata_equal.selectdata(inplace=True, clear=True)

    def test_latency_selection(self, adata_equal):
        adata_equal.selectdata(latency=[0.0, 0.25], inplace=True)
        out = run_cr(TimesTwo(), adata_equal)
        assert np.asarray(out.trials[0]).shape[0] == 251
        adata_equal.selectdata(inplace=True, clear=True)


class TestParallel:
    def test_mesh_matches_sequential(self, adata_equal, testmesh):
        out_seq = run_cr(TimesTwo(), adata_equal)
        with spy.use_mesh(testmesh):
            out_par = run_cr(TimesTwo(), adata_equal)
        assert np.allclose(np.asarray(out_seq.data), np.asarray(out_par.data))

    def test_mesh_keeptrials_false(self, adata_equal, testmesh):
        out_seq = run_cr(TimesTwo(), adata_equal, keeptrials=False)
        with spy.use_mesh(testmesh):
            out_par = run_cr(TimesTwo(), adata_equal, keeptrials=False)
        assert np.allclose(
            np.asarray(out_seq.data), np.asarray(out_par.data), atol=1e-6
        )

    def test_mesh_ragged(self, adata_ragged, testmesh):
        out_seq = run_cr(TimesTwo(), adata_ragged)
        with spy.use_mesh(testmesh):
            out_par = run_cr(TimesTwo(), adata_ragged)
        assert np.allclose(np.asarray(out_seq.data), np.asarray(out_par.data))

    def test_parallel_debug(self, adata_equal):
        cr = TimesTwo()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(adata_equal, 0, keeptrials=True)
        cr.compute(adata_equal, out, parallel_debug=True)
        assert np.allclose(np.asarray(out.data), 2 * np.asarray(adata_equal.data))


class TestProvenance:
    def test_log_propagation(self, adata_equal):
        adata_equal.log = "pre-existing entry"
        out = run_cr(TimesTwo(), adata_equal)
        assert "pre-existing entry" in out.log
        assert "TimesTwo" in out.log

    def test_save_load_roundtrip(self, tmp_path, adata_equal):
        out = run_cr(TimesTwo(), adata_equal)
        spy.save(out, container=str(tmp_path / "crout"))
        loaded = spy.load(str(tmp_path / "crout.spy"))
        assert loaded == out


class TestReadbackDtype:
    def test_f16_readback_knob(self, monkeypatch):
        """SPY_TPU_READBACK_DTYPE=float16 halves readback bytes for real
        per-trial outputs within ~1e-3 quantization; complex outputs are
        never downcast."""
        import syncopy_tpu as spy

        ad = spy.synthdata.harmonic(freq=30, samplerate=500, nTrials=3, nSamples=400, nChannels=2)
        ref = np.asarray(spy.freqanalysis(ad, method="mtmfft", taper="hann", output="pow").data)
        monkeypatch.setenv("SPY_TPU_READBACK_DTYPE", "float16")
        got = np.asarray(spy.freqanalysis(ad, method="mtmfft", taper="hann", output="pow").data)
        assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-3

        four = np.asarray(spy.freqanalysis(ad, method="mtmfft", taper="hann", output="fourier").data)
        monkeypatch.delenv("SPY_TPU_READBACK_DTYPE")
        four_ref = np.asarray(spy.freqanalysis(ad, method="mtmfft", taper="hann", output="fourier").data)
        assert np.abs(four - four_ref).max() == 0

    def test_f16_readback_fused_reduction(self, monkeypatch):
        """The knob also covers the keeptrials=False fused post path
        (coherence via post_pack): real packed results downcast within the
        f16 bound 2^-11, final dtype stays float32; a complex fused result
        (trial-averaged fourier) is never downcast."""
        import syncopy_tpu as spy

        ad = spy.synthdata.ar2_network(nTrials=6, AdjMat=np.zeros((3, 3)),
                                       nSamples=300, seed=2)
        ref = np.asarray(spy.connectivityanalysis(ad, method="coh", tapsmofrq=3).data)
        monkeypatch.setenv("SPY_TPU_READBACK_DTYPE", "float16")
        got_obj = spy.connectivityanalysis(ad, method="coh", tapsmofrq=3)
        got = np.asarray(got_obj.data)
        assert got.dtype == np.float32
        assert np.abs(got - ref).max() < 2 ** -11 + 1e-6
        assert np.abs(got - ref).max() > 0  # quantization did happen

        cplx = np.asarray(spy.freqanalysis(ad, method="mtmfft", taper="hann",
                                           output="fourier", keeptrials=False).data)
        monkeypatch.delenv("SPY_TPU_READBACK_DTYPE")
        cplx_ref = np.asarray(spy.freqanalysis(ad, method="mtmfft", taper="hann",
                                               output="fourier", keeptrials=False).data)
        assert np.abs(cplx - cplx_ref).max() == 0

    def test_f16_readback_never_touches_packed_complex(self, monkeypatch):
        """The Hermitian pack used by csd/granger encodes COMPLEX content
        in a real array — post_pack_complex must exempt it from the knob
        (f16 CSD quantization is amplified ~O(0.1) by Wilson)."""
        import syncopy_tpu as spy

        ad = spy.synthdata.ar2_network(nTrials=10, nSamples=300, seed=4)
        csd_ref = np.asarray(spy.connectivityanalysis(ad, method="csd",
                                                      tapsmofrq=3).data)
        g_ref = np.asarray(spy.connectivityanalysis(ad, method="granger",
                                                    tapsmofrq=3).data)
        monkeypatch.setenv("SPY_TPU_READBACK_DTYPE", "float16")
        csd = np.asarray(spy.connectivityanalysis(ad, method="csd",
                                                  tapsmofrq=3).data)
        g = np.asarray(spy.connectivityanalysis(ad, method="granger",
                                                tapsmofrq=3).data)
        assert np.abs(csd - csd_ref).max() == 0
        # the FINAL granger matrix is real and may be f16-quantized by the
        # knob (~|g|*2^-11); what must NOT happen is quantization of the
        # intermediate CSD, which Wilson amplifies to O(0.1)
        gmax = max(np.abs(g_ref).max(), 1.0)
        assert np.abs(g - g_ref).max() < gmax * 2 ** -10


class TestPostPackHook:
    def test_pack_unpack_roundtrip(self):
        """compute(post_pack=, post_unpack=) compresses the fused readback;
        the host reconstruction must be what the post fn produced."""
        import jax.numpy as jnp

        import syncopy_tpu as spy
        from syncopy_tpu.datatype.continuous_data import SpectralData
        from syncopy_tpu.engine.routine import ComputationalRoutine

        class MeanPow(ComputationalRoutine):
            def process_single_trial(self, trial, **cfg):
                return jnp.abs(jnp.fft.rfft(trial, axis=0))[None, None] ** 2

            def process_metadata(self, data, out):
                self.propagate_properties(data, out)
                out.trialdefinition = np.array([[0, 1, 0]])

        ad = spy.synthdata.white_noise(nTrials=6, nSamples=200, nChannels=2, seed=9)

        def run(pack, unpack):
            cr = MeanPow()
            out = SpectralData(dimord=SpectralData._defaultDimord)
            cr.initialize(ad, out._stackingDim, keeptrials=False)
            cr.compute(ad, out, post_device_fn=lambda x: x * 2.0, post_key=("x2",),
                       post_pack=pack, post_unpack=unpack)
            return np.asarray(out.data)

        plain = run(None, None)
        packed = run(lambda y: y.reshape(-1)[::-1],
                     lambda p: p[::-1].reshape(plain.shape))
        assert np.allclose(plain, packed, atol=1e-6)


class TestAuxInfoAccumulation:
    """Per-trial aux metadata must survive multi-chunk execution (the
    reference side-channel collects metadata for ALL chunks,
    reference shared/metadata.py:135-220)."""

    class WithAux(ComputationalRoutine):
        def process_single_trial(self, trial, **cfg):
            return trial * 2.0, {"tmax": jnp.max(trial), "tsum": jnp.sum(trial)}

        def process_metadata(self, data, out):
            out.trialdefinition = np.array(self.selector.trialdefinition)
            out.samplerate = data.samplerate

    def _run(self, data, chunk_budget=None):
        cr = self.WithAux()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(data, out._stackingDim, keeptrials=True)
        if chunk_budget is not None:
            cr._chunk_budget = chunk_budget
        cr.compute(data, out)
        return cr, out

    def test_single_chunk(self, adata_equal):
        cr, _ = self._run(adata_equal)
        trials = [np.asarray(t) for t in adata_equal.trials]
        assert cr.aux_info["tmax"].shape[0] == len(trials)
        assert np.allclose(cr.aux_info["tmax"], [t.max() for t in trials], atol=1e-6)

    def test_multi_chunk_all_trials(self, adata_equal):
        # force 1-trial chunks: every chunk's aux must be retained
        cr, _ = self._run(adata_equal, chunk_budget=1)
        trials = [np.asarray(t) for t in adata_equal.trials]
        assert cr.aux_info["tmax"].shape[0] == len(trials)
        assert np.allclose(cr.aux_info["tmax"], [t.max() for t in trials], atol=1e-6)
        assert np.allclose(cr.aux_info["tsum"], [t.sum() for t in trials], atol=1e-3)

    def test_multi_bucket_ragged(self, adata_ragged):
        cr, _ = self._run(adata_ragged, chunk_budget=1)
        trials = [np.asarray(t) for t in adata_ragged.trials]
        assert cr.aux_info["tmax"].shape[0] == len(trials)
        assert np.allclose(cr.aux_info["tmax"], [t.max() for t in trials], atol=1e-6)


class TestDeclarativeAux:
    """CRs can declare aux semantics explicitly via ``aux_per_trial``; a
    fused reduction emitting a per-chunk diagnostic whose leading dim
    happens to equal the chunk size must NOT be misclassified."""

    class FusedWithChunkAux(ComputationalRoutine):
        aux_per_trial = frozenset()  # everything is a per-chunk diagnostic

        def process_single_trial(self, trial, **cfg):
            return jnp.sum(trial, axis=0, keepdims=True)

        def process_batch_sum(self, batch, n_valid, **cfg):
            s = jnp.sum(batch, axis=1)  # per-trial sums, (chunkN, nChan)
            mask = (jnp.arange(batch.shape[0]) < n_valid)[:, None]
            total = jnp.sum(jnp.where(mask, s, 0.0), axis=0, keepdims=True)
            # diagnostic with leading dim == chunkN: the old heuristic
            # would have treated this as per-trial and dropped the padding
            return total, {"row_energy": jnp.sum(s**2, axis=1)}

        def process_metadata(self, data, out):
            out.trialdefinition = np.array([[0, 1, 0]])
            out.samplerate = data.samplerate

    class PerTrialMismatch(ComputationalRoutine):
        aux_per_trial = frozenset({"tmax"})

        def process_batch(self, batch, *aux, **cfg):
            # batch-level aux that ignores the declared per-trial contract
            return batch * 2.0, {"tmax": jnp.max(batch)}

        def process_single_trial(self, trial, **cfg):
            return trial * 2.0

        def process_metadata(self, data, out):
            out.trialdefinition = np.array(self.selector.trialdefinition)
            out.samplerate = data.samplerate

    def test_chunk_sized_aux_stays_per_chunk(self, adata_equal):
        cr = self.FusedWithChunkAux()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(adata_equal, out._stackingDim, keeptrials=False)
        cr._chunk_budget = 2**30  # one chunk regardless of env stress knobs
        cr.compute(adata_equal, out)
        n_trials = len(adata_equal.trials)
        chunkN = 1 << (n_trials - 1).bit_length()  # padded batch size
        # per-chunk: the full padded diagnostic is kept, nothing dropped
        assert cr.aux_info["row_energy"].shape[0] == chunkN
        assert chunkN != n_trials  # the trap this test guards against

    def test_declared_per_trial_shape_mismatch_raises(self, adata_equal):
        from syncopy_tpu.shared.errors import SPYError

        cr = self.PerTrialMismatch()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(adata_equal, out._stackingDim, keeptrials=True)
        with pytest.raises(SPYError, match="declared per-trial"):
            cr.compute(adata_equal, out)


class TestSpillGuard:
    """_allocate_host_output must never truncate a payload file that
    already holds data (a reused output object)."""

    def test_reused_output_not_truncated(self, adata_equal, monkeypatch):
        import os

        import h5py

        from syncopy_tpu.engine import routine as eng

        monkeypatch.setattr(eng, "DEFAULT_HOST_BUDGET", 1)
        cr = TimesTwo()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(adata_equal, out._stackingDim, keeptrials=True)
        cr.compute(adata_equal, out, device_resident=False)
        first_file = out.filename
        assert isinstance(out.data, h5py.Dataset)
        first = np.asarray(out.data[...]).copy()

        # second compute into the SAME object: spills to a fresh file,
        # leaving the existing payload intact until the result replaces it
        cr.compute(adata_equal, out, device_resident=False)
        assert out.filename != first_file
        assert np.allclose(np.asarray(out.data[...]), first)
        assert os.path.exists(first_file)
        assert os.path.getsize(first_file) > 0


class TestComputeIdempotent:
    """A second compute() on the same initialized CR must not double-apply
    the fused post-transform shape overlay (engine re-entrancy)."""

    def test_double_compute_post_fn(self):
        from syncopy_tpu.datatype.continuous_data import SpectralData

        class MeanPow(ComputationalRoutine):
            def process_single_trial(self, trial, **cfg):
                return jnp.abs(jnp.fft.rfft(trial, axis=0))[None, None] ** 2

            def process_metadata(self, data, out):
                self.propagate_properties(data, out)
                out.trialdefinition = np.array([[0, 1, 0]])

        ad = spy.synthdata.white_noise(nTrials=4, nSamples=128, nChannels=2, seed=3)
        cr = MeanPow()
        out1 = SpectralData(dimord=SpectralData._defaultDimord)
        cr.initialize(ad, out1._stackingDim, keeptrials=False)
        post = lambda x: jnp.mean(x, axis=-1, keepdims=True)  # noqa: E731
        cr.compute(ad, out1, post_device_fn=post, post_key=("chmean",))
        shape1, d1 = out1.data.shape, np.asarray(out1.data)

        out2 = SpectralData(dimord=SpectralData._defaultDimord)
        cr.compute(ad, out2, post_device_fn=post, post_key=("chmean",))
        assert out2.data.shape == shape1
        assert np.allclose(np.asarray(out2.data), d1, atol=1e-7)

        # and a re-run WITHOUT the post fn returns the pristine shape
        out3 = SpectralData(dimord=SpectralData._defaultDimord)
        cr.compute(ad, out3)
        assert out3.data.shape[-1] == 2


class TestDispatchRecovery:
    """Failure detection/recovery (SURVEY §5): device OOM evicts the
    device caches before one retry; every other error is raised."""

    def test_oom_evicts_caches(self, monkeypatch):
        from syncopy_tpu.engine import routine

        evicted = {"n": 0}
        monkeypatch.setattr(routine, "clear_device_cache",
                            lambda: evicted.update(n=evicted["n"] + 1))
        calls = {"n": 0}

        def oom_once():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("RESOURCE_EXHAUSTED: HBM out of memory")
            return "ok"

        assert routine._dispatch_with_recovery(oom_once, what="test") == "ok"
        assert evicted["n"] == 1

    def test_permanent_error_raises(self):
        from syncopy_tpu.engine.routine import _dispatch_with_recovery

        def broken():
            raise ValueError("a plain logic bug")

        with pytest.raises(ValueError, match="logic bug"):
            _dispatch_with_recovery(broken, what="test")

    def test_non_oom_runtime_error_not_retried(self):
        """A device runtime error other than OOM (an XLA INTERNAL, say) is
        raised on the first attempt: retrying could hide a real fault."""
        from syncopy_tpu.engine import routine

        calls = {"n": 0}

        def failing():
            calls["n"] += 1
            raise RuntimeError("INTERNAL: CUDA error: an illegal memory access")

        with pytest.raises(RuntimeError, match="INTERNAL"):
            routine._dispatch_with_recovery(failing, what="test")
        assert calls["n"] == 1

    def test_oom_retried_once_only(self, monkeypatch):
        from syncopy_tpu.engine import routine

        monkeypatch.setattr(routine, "clear_device_cache", lambda: None)
        calls = {"n": 0}

        def always_oom():
            calls["n"] += 1
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            routine._dispatch_with_recovery(always_oom, what="test")
        assert calls["n"] == 2

    def test_oom_retry_uses_rebuilt_inputs(self, monkeypatch):
        from syncopy_tpu.engine import routine

        monkeypatch.setattr(routine, "clear_device_cache", lambda: None)

        def oom():
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

        assert routine._dispatch_with_recovery(
            oom, rebuild=lambda: (lambda: "rebuilt"), what="test") == "rebuilt"

    def test_engine_end_to_end_with_flaky_executable(self, monkeypatch):
        """A compute whose first chunk dispatch runs out of device memory
        must still produce the correct result after the eviction retry."""
        import syncopy_tpu as spy
        from syncopy_tpu.engine import routine

        d = spy.synthdata.white_noise(nTrials=6, nSamples=256, nChannels=3, seed=44)
        ref = spy.freqanalysis(d, method="mtmfft", taper="hann")

        real_get = routine.ComputationalRoutine._get_compiled
        state = {"fail": True}

        def wrap_get(self, *a, **kw):
            fn = real_get(self, *a, **kw)

            def flaky_fn(*args, **kwargs):
                if state["fail"]:
                    state["fail"] = False
                    raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
                return fn(*args, **kwargs)

            return flaky_fn

        monkeypatch.setattr(routine.ComputationalRoutine, "_get_compiled", wrap_get)
        d2 = spy.synthdata.white_noise(nTrials=6, nSamples=256, nChannels=3, seed=44)
        got = spy.freqanalysis(d2, method="mtmfft", taper="hann")
        assert np.array_equal(np.asarray(got.data), np.asarray(ref.data))


class TestComplexBoundaryInvariant:
    """No complex array may ever cross the host->device boundary (complex
    transfers are UNIMPLEMENTED on some runtimes): the engine must
    encode the main batch AND auxiliary per-trial inputs as real pairs."""

    def test_aux_inputs_cross_encoded(self, monkeypatch):
        import syncopy_tpu as spy
        from syncopy_tpu.parallel import mesh as mesh_mod
        from syncopy_tpu.engine import routine

        seen = []
        real_shard = mesh_mod.shard_batch

        def checking_shard(batch, m, channel_axis_pos=None):
            seen.append(np.asarray(batch).dtype)
            assert not np.iscomplexobj(batch), "complex host->device transfer"
            return real_shard(batch, m, channel_axis_pos=channel_axis_pos)

        monkeypatch.setattr(routine, "shard_batch", checking_shard)
        monkeypatch.setenv("SPY_TPU_DEVICE_RESIDENT", "0")

        d = spy.synthdata.white_noise(nTrials=8, nSamples=256, nChannels=3, seed=50)
        spec = spy.freqanalysis(d, method="mtmfft", output="fourier", keeptrials=True)
        # jackknife drives the complex-aux path: the LOO average is complex
        coh = spy.connectivityanalysis(d, method="coh", jackknife=True)
        # complex trial statistics (centered second moment aux = complex mean)
        spy.var(spec, dim="trials")
        assert seen, "shard_batch never called"
        assert all(not np.issubdtype(dt, np.complexfloating) for dt in seen)


class TestHostPathPaddingMask:
    """Regression (code review): the FIRST, uncached host upload must mask
    zero-padded rows — NaN-sensitive reductions (phase unit vectors,
    centered moments) were poisoned when the trial count was not a power
    of two and the input was not device-resident."""

    def _spec(self, n_trials=20):
        import syncopy_tpu as spy

        d = spy.synthdata.white_noise(nTrials=n_trials, nSamples=128,
                                      nChannels=2, seed=60)
        return spy.freqanalysis(d, method="mtmfft", output="fourier",
                                keeptrials=True)

    def test_itc_first_pass_host_path(self, monkeypatch):
        import syncopy_tpu as spy
        from syncopy_tpu.engine.routine import clear_device_cache

        monkeypatch.setenv("SPY_TPU_DEVICE_RESIDENT", "0")
        spec = self._spec()
        clear_device_cache()  # force the fresh-upload branch
        res = spy.itc(spec)
        arr = np.asarray(res.data)
        assert np.isfinite(arr).all(), "padding rows leaked into the resultant"
        stack = np.stack([np.asarray(t) for t in spec.trials])
        unit = stack / np.abs(stack)
        ref = np.abs(unit.mean(axis=0).mean(axis=0, keepdims=True))
        assert np.allclose(arr, ref, atol=1e-6)

    def test_var_first_pass_host_path(self, monkeypatch):
        import syncopy_tpu as spy
        from syncopy_tpu.engine.routine import clear_device_cache

        monkeypatch.setenv("SPY_TPU_DEVICE_RESIDENT", "0")
        spec = self._spec()
        clear_device_cache()
        v = spy.var(spec, dim="trials")
        stack = np.stack([np.asarray(t) for t in spec.trials])
        ref = np.mean(np.abs(stack - stack.mean(axis=0)) ** 2, axis=0)
        assert np.allclose(np.asarray(v.data), ref, atol=1e-6)


class TestTimelockExactTransfer:
    """The keeptrials identity copy must be bit-exact even when f16 ingest
    is enabled globally (an identity kernel must never quantize)."""

    def test_no_f16_quantization(self, monkeypatch):
        import syncopy_tpu as spy
        from syncopy_tpu.engine import routine

        monkeypatch.setattr(routine, "TRANSFER_DTYPE", "float16")
        d = spy.synthdata.white_noise(nTrials=6, nSamples=100, nChannels=2, seed=61)
        tl = spy.timelockanalysis(d, keeptrials=True)
        stack = np.concatenate([np.asarray(t) for t in d.trials], axis=0)
        assert np.array_equal(np.asarray(tl.data), stack)


class TestEngineContract:
    """Engine API-contract depth (reference test_computationalroutine.py
    lifecycle/validation blocks)."""

    def test_compute_before_initialize_raises(self, adata_equal):
        from syncopy_tpu.shared.errors import SPYError

        cr = TimesTwo()
        out = spy.AnalogData(dimord=["time", "channel"])
        with pytest.raises(SPYError, match="initialize"):
            cr.compute(adata_equal, out)

    def test_empty_selection_rejected(self, adata_equal):
        from syncopy_tpu.shared.errors import SPYValueError

        cr = TimesTwo()
        out = spy.AnalogData(dimord=["time", "channel"])
        with pytest.raises((SPYValueError, spy.SPYError)):
            adata_equal.selectdata(inplace=True, trials=[99])

    def test_keeptrials_false_rejects_ragged(self, adata_ragged):
        from syncopy_tpu.shared.errors import SPYValueError

        cr = TimesTwo()
        out = spy.AnalogData(dimord=["time", "channel"])
        with pytest.raises(SPYValueError, match="identical trial shapes"):
            cr.initialize(adata_ragged, out._stackingDim, keeptrials=False)

    def test_workspace_hook_bounds_chunk(self, adata_equal):
        """device_bytes_per_trial shrinks the chunk: with a huge declared
        workspace every chunk holds exactly one (padded) trial."""
        seen = []

        class Hungry(TimesTwo):
            def device_bytes_per_trial(self, shp, out_shp, out_dt):
                return 10**12

            def process_batch(self, batch, *aux, **cfg):
                seen.append(batch.shape[0])
                return batch * 2.0

        cr = Hungry()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(adata_equal, out._stackingDim, keeptrials=True)
        cr.compute(adata_equal, out, device_resident=False)
        assert seen and max(seen) == 1
        assert np.allclose(np.asarray(out.data),
                           2 * np.asarray(adata_equal.data))

    def test_chunk_cap_respected(self, adata_equal, monkeypatch):
        from syncopy_tpu.engine import routine as eng

        monkeypatch.setattr(eng, "MAX_CHUNK_TRIALS", 2)
        seen = []

        class Spy2(TimesTwo):
            def process_batch(self, batch, *aux, **cfg):
                seen.append(batch.shape[0])
                return batch * 2.0

        cr = Spy2()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(adata_equal, out._stackingDim, keeptrials=True)
        cr.compute(adata_equal, out, device_resident=False)
        assert seen and max(seen) <= 2

    def test_exact_powerof2_trialcount_single_chunk(self):
        d = spy.synthdata.white_noise(nTrials=8, nSamples=64, nChannels=2,
                                      seed=1)
        seen = []

        class Spy3(TimesTwo):
            def process_batch(self, batch, *aux, **cfg):
                seen.append(batch.shape[0])
                return batch * 2.0

        cr = Spy3()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(d, out._stackingDim, keeptrials=True)
        cr._chunk_budget = 2**30
        cr.compute(d, out, device_resident=False)
        assert seen == [8]  # no padding, one executable, one dispatch

    def test_single_trial_input(self):
        d = spy.AnalogData(data=np.ones((16, 2), "f4"), samplerate=10.0)
        out = run_cr(TimesTwo(), d)
        assert np.allclose(np.asarray(out.data), 2.0)

    def test_chan_per_worker_is_advisory(self, adata_equal):
        cr = TimesTwo()
        out = spy.AnalogData(dimord=["time", "channel"])
        cr.initialize(adata_equal, out._stackingDim, chan_per_worker=2,
                      keeptrials=True)
        cr.compute(adata_equal, out)
        assert np.allclose(np.asarray(out.data),
                           2 * np.asarray(adata_equal.data))


class TestResolveParallel:
    def test_false_ignores_active_mesh(self, testmesh):
        from syncopy_tpu.parallel.mesh import resolve_parallel, use_mesh

        with use_mesh(testmesh):
            assert resolve_parallel(False) is None
            assert resolve_parallel(None) is testmesh
            assert resolve_parallel(True) is testmesh

    def test_none_without_mesh_is_solo(self):
        from syncopy_tpu.parallel.mesh import resolve_parallel

        assert resolve_parallel(None) is None

    def test_esi_cluster_setup_installs_mesh(self):
        from syncopy_tpu.parallel.mesh import active_mesh

        mesh = spy.esi_cluster_setup(n_workers=2, partition="ignored",
                                     mem_per_worker="8GB")
        try:
            assert active_mesh() is mesh
            assert mesh.devices.size == 2
        finally:
            spy.cluster_cleanup()
        assert active_mesh() is None

    def test_too_many_workers_rejected(self):
        import jax

        from syncopy_tpu.shared.errors import SPYParallelError

        with pytest.raises(SPYParallelError):
            spy.esi_cluster_setup(n_workers=len(jax.devices()) + 1)


class TestCompileFailure:
    """A chunk program that fails is raised to the caller, not retried at
    another chunk size."""

    def test_non_compile_failure_still_raises(self, monkeypatch):
        import syncopy_tpu as spy
        from syncopy_tpu.engine import routine

        ad = spy.synthdata.white_noise(nTrials=4, nChannels=2, nSamples=64,
                                       samplerate=200.0, seed=1)

        def always_logic_error(self, *a, **kw):
            def boom(*args, **kwargs):
                raise ValueError("a plain logic bug")
            return boom

        monkeypatch.setattr(routine.ComputationalRoutine, "_get_compiled",
                            always_logic_error)
        with pytest.raises(ValueError, match="logic bug"):
            spy.freqanalysis(ad, method="mtmfft", taper="hann")


class TestBatchOfOneBypass:
    """A batch of ONE trial must not go through jax.vmap: a platform that
    miscompiles the batched rewrite of `lax.while_loop` (wide-channel
    Wilson factorization once diverged under vmap at 128 ch while the
    identical unbatched program converged) must never see it. The
    engine's default process_batch therefore calls process_single_trial
    directly for batch size 1 and re-attaches the leading axis."""

    class _WithAux(ComputationalRoutine):
        valid_kws = []

        def process_single_trial(self, trial, **cfg):
            out = trial * 3.0
            info = {"peak": jnp.max(trial), "flag": jnp.any(trial > 0)}
            return out, info

        def process_metadata(self, data, out):  # pragma: no cover
            pass

    def test_bypass_taken_and_vmap_for_larger(self, monkeypatch):
        import jax

        from syncopy_tpu.engine import routine

        calls = []
        orig_vmap = jax.vmap

        def spy_vmap(*args, **kwargs):
            calls.append(True)
            return orig_vmap(*args, **kwargs)

        monkeypatch.setattr(routine.jax, "vmap", spy_vmap)
        cr = TimesTwo()
        one = jnp.ones((1, 8, 2), dtype=jnp.float32)
        res1 = cr.process_batch(one)
        assert not calls, "batch of one must bypass jax.vmap"
        res4 = cr.process_batch(jnp.ones((4, 8, 2), dtype=jnp.float32))
        assert calls, "larger batches still vmap"
        assert res1.shape == (1, 8, 2)
        np.testing.assert_allclose(np.asarray(res1), np.asarray(res4[:1]))

    def test_bypass_matches_vmap_pytree(self):
        """The bypass must reproduce the vmapped output structure exactly,
        including aux-info dict leaves gaining the leading batch axis."""
        import jax

        cr = self._WithAux()
        batch = jnp.arange(16, dtype=jnp.float32).reshape(1, 8, 2) - 5.0
        out1, info1 = cr.process_batch(batch)
        out_v, info_v = jax.vmap(
            lambda x: cr.process_single_trial(x, **cr.cfg)
        )(batch)
        np.testing.assert_allclose(np.asarray(out1), np.asarray(out_v))
        assert set(info1) == set(info_v)
        for k in info1:
            assert np.asarray(info1[k]).shape == np.asarray(info_v[k]).shape
            np.testing.assert_allclose(np.asarray(info1[k]), np.asarray(info_v[k]))

    def test_per_trial_aux_rows_sliced(self):
        """aux arrays are indexed per trial in the bypass, matching vmap."""

        class WithAuxInput(ComputationalRoutine):
            valid_kws = []

            def process_single_trial(self, trial, gain, **cfg):
                return trial * gain

            def process_metadata(self, data, out):  # pragma: no cover
                pass

        cr = WithAuxInput()
        batch = jnp.ones((1, 4, 2), dtype=jnp.float32)
        gains = jnp.asarray([2.5], dtype=jnp.float32)
        res = cr.process_batch(batch, gains)
        np.testing.assert_allclose(np.asarray(res), 2.5 * np.ones((1, 4, 2)))

    def test_granger_point_estimate_uses_single_row(self, monkeypatch):
        """connectivityanalysis(method='granger') reaches the AV routine
        with exactly one row (the trial average) — the shape class a
        batched while_loop miscompile once hit — and must produce the
        unbatched program."""
        import jax

        from syncopy_tpu.engine import routine

        vmapped_batch_shapes = []
        orig_vmap = jax.vmap

        def spy_vmap(fn, *args, **kwargs):
            mapped = orig_vmap(fn, *args, **kwargs)

            def wrapper(batch, *a):
                vmapped_batch_shapes.append(tuple(batch.shape))
                return mapped(batch, *a)

            return wrapper

        monkeypatch.setattr(routine.jax, "vmap", spy_vmap)
        adata = spy.synthdata.ar2_network(
            nTrials=20, AdjMat=np.zeros((2, 2), dtype=np.float32),
            nSamples=256, seed=3,
        )
        res = spy.connectivityanalysis(adata, method="granger")
        assert res.info["converged"]
        assert not any(s[0] == 1 for s in vmapped_batch_shapes), (
            "the one-row trial-average must not be vmapped: {}".format(
                vmapped_batch_shapes)
        )


class TestSequentialBatch:
    """CRs with ``sequential_batch = True`` must run multi-row chunks
    through ``lax.map`` (body traced unbatched, executed serially) instead
    of ``jax.vmap`` — the insurance against a batched while_loop
    miscompile for ANY chunk size, not just batch-of-one."""

    class _SeqCR(ComputationalRoutine):
        valid_kws = []
        sequential_batch = True

        def process_single_trial(self, trial, **cfg):
            # contains a while_loop on purpose: the hazardous construct
            import jax

            def body(state):
                i, acc = state
                return i + 1, acc + trial

            def cond(state):
                return state[0] < 3

            _, acc = jax.lax.while_loop(cond, body, (0, jnp.zeros_like(trial)))
            return acc, {"peak": jnp.max(trial)}

        def process_metadata(self, data, out):  # pragma: no cover
            pass

    def test_multi_row_batch_avoids_vmap(self, monkeypatch):
        import jax

        from syncopy_tpu.engine import routine

        calls = []
        orig_vmap = jax.vmap

        def spy_vmap(*args, **kwargs):
            calls.append(True)
            return orig_vmap(*args, **kwargs)

        monkeypatch.setattr(routine.jax, "vmap", spy_vmap)
        cr = self._SeqCR()
        batch = jnp.arange(24, dtype=jnp.float32).reshape(4, 3, 2)
        out, info = cr.process_batch(batch)
        assert not calls, "sequential_batch CRs must never vmap"
        np.testing.assert_allclose(np.asarray(out), 3 * np.asarray(batch))
        assert np.asarray(info["peak"]).shape == (4,)

    def test_matches_vmap_semantics_with_aux(self):
        """lax.map output (incl. aux rows) must be indistinguishable from
        the vmapped structure."""

        class SeqAux(ComputationalRoutine):
            valid_kws = []
            sequential_batch = True

            def process_single_trial(self, trial, gain, **cfg):
                return trial * gain, {"g": gain}

            def process_metadata(self, data, out):  # pragma: no cover
                pass

        cr = SeqAux()
        batch = jnp.ones((3, 4, 2), dtype=jnp.float32)
        gains = jnp.asarray([1.0, 2.0, 3.0], dtype=jnp.float32)
        out, info = cr.process_batch(batch, gains)
        expected = np.ones((3, 4, 2)) * np.array([1.0, 2.0, 3.0])[:, None, None]
        np.testing.assert_allclose(np.asarray(out), expected)
        np.testing.assert_allclose(np.asarray(info["g"]), [1.0, 2.0, 3.0])

    def test_granger_jackknife_never_vmaps_wilson(self, monkeypatch):
        """End-to-end: jackknife Granger replicates arrive at the AV stage
        as multi-row chunks — with GrangerCausality.sequential_batch they
        must take lax.map, so the Wilson factorization is NEVER traced
        under a vmap batch tracer anywhere in the frontend call."""
        from jax._src.interpreters.batching import BatchTracer

        from syncopy_tpu.connectivity.AV_compRoutines import GrangerCausality

        seen = []
        orig = GrangerCausality.process_single_trial

        def wrapper(self, trial, *aux, **cfg):
            seen.append(isinstance(trial, BatchTracer))
            return orig(self, trial, *aux, **cfg)

        monkeypatch.setattr(GrangerCausality, "process_single_trial", wrapper)
        # evict warm GrangerCausality entries from the process-global trace
        # caches (executables + eval_shape results): a prior test in the
        # same process may have compiled identical shapes, in which case
        # nothing would be re-traced and `seen` would stay empty
        from syncopy_tpu.engine.routine import _EVAL_SHAPE_CACHE, _GLOBAL_JIT_CACHE

        for cache in (_GLOBAL_JIT_CACHE, _EVAL_SHAPE_CACHE):
            for k in [k for k in cache if "GrangerCausality" in str(k[0])]:
                del cache[k]
        AdjMat = np.zeros((2, 2), dtype=np.float32)
        AdjMat[0, 1] = 0.25
        adata = spy.synthdata.ar2_network(
            nTrials=8, AdjMat=AdjMat, nSamples=256, seed=11,
        )
        res = spy.connectivityanalysis(adata, method="granger", jackknife=True)
        assert res.info["converged"]
        # traced at least once with a multi-row replicate chunk, and never
        # under a vmap batch tracer
        assert seen
        assert not any(seen), "Wilson factorization was traced under vmap"
        assert "jack_var" in res._registered_datasets or hasattr(res, "jack_var")


class TestLOOAccuracy:
    """LOO replicate arithmetic must not lose mantissa bits to large-scale
    cancellation: (n*avg - x)/(n-1) subtracts at n times the result's
    magnitude (~log2(n) bits lost; at n=1000 the ~6e-5 relative noise is
    enough to make a wide-channel jackknife CSD un-factorizable in f32).
    The algebraically identical avg + (avg - x)/(n-1) stays ~ulp-accurate
    (round-4 root cause of the 128-ch jackknife divergence, alongside the
    rank-deficiency hazard)."""

    def test_loo_average_matches_f64(self):
        import jax.numpy as jnp

        from syncopy_tpu.statistics.compRoutines import LOOAverage

        rng = np.random.default_rng(5)
        n = 1000
        trials = rng.normal(size=(n, 32)).astype(np.float64) + 10.0
        avg64 = trials.mean(axis=0)
        cr = LOOAverage(n_trials=n, avg=avg64.astype(np.float32))
        got = np.asarray(cr.process_single_trial(
            jnp.asarray(trials[0].astype(np.float32)),
            jnp.asarray(avg64.astype(np.float32)), n_trials=n))
        want = (avg64 * n - trials[0]) / (n - 1)
        # naive f32 arithmetic would land ~6e-5 away; the rewritten form
        # stays within a few ulp of the f64 value
        assert np.max(np.abs(got - want) / np.abs(want)) < 3e-7


class TestLazyReadbackFlatten:
    """keeptrials=True chunk results stay in their NATURAL encoded layout
    in device memory (an in-program (N, 128) relayout costs a second
    write of the whole result); the readback relayout happens lazily at
    host-fetch time via _flatten_dev."""

    def test_flatten_dev_fetch_roundtrip(self):
        from syncopy_tpu.engine.routine import _fetch_readback, _flatten_dev

        rng = np.random.default_rng(7)
        # odd sizes so the 128-lane padding path is exercised
        nat = rng.normal(size=(3, 2, 5, 7, 11)).astype(np.float32)
        dev = jnp.asarray(nat)
        flat = _flatten_dev(dev)
        assert flat.ndim == 2 and flat.shape[1] == 128
        got = _fetch_readback(flat, nat.shape)
        np.testing.assert_array_equal(got, nat)

    def test_compiled_keeptrials_output_is_natural_layout(self):
        """The compiled per-trial program must emit (B, ...) natural-layout
        chunks, not pre-flattened (N, 128) planes."""
        data = spy.AnalogData(
            data=np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32),
            samplerate=10.0,
        )
        data.trialdefinition = np.array([[0, 16, 0], [16, 32, 0], [32, 48, 0],
                                         [48, 64, 0]])
        cr = TimesTwo()
        cr.initialize(data, 0, keeptrials=True)
        fn = cr._get_compiled((16, 4), None)
        import jax

        out = jax.eval_shape(
            fn, (), jnp.zeros((4, 16, 4), jnp.float32), jnp.int32(4)
        )
        leaf = out[0] if isinstance(out, tuple) else out
        assert leaf.shape[0] == 4 and leaf.shape[-1] == 4, leaf.shape
