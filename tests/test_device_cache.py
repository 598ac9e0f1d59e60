# -*- coding: utf-8 -*-
# HBM-resident trial-store cache: repeated analyses reuse device chunks;
# payload/trial-layout mutations invalidate.

import numpy as np
import pytest

import syncopy_tpu as spy
import syncopy_tpu.engine.routine as routine


@pytest.fixture(autouse=True)
def fresh_cache():
    routine.clear_device_cache()
    yield
    routine.clear_device_cache()


class TestDeviceCache:
    def test_second_call_hits_cache_and_matches(self, adata_equal):
        s1 = spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        assert len(routine._DEVICE_CACHE) == 1
        s2 = spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        assert np.allclose(np.asarray(s1.data), np.asarray(s2.data))

    def test_cache_shared_across_analyses(self, adata_equal):
        spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        n = len(routine._DEVICE_CACHE)
        # same gather plan, same chunking -> same cached upload is reused
        spy.freqanalysis(adata_equal, method="mtmfft", taper=None)
        assert len(routine._DEVICE_CACHE) == n

    def test_mutation_invalidates(self, adata_equal):
        s1 = spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        new_data = np.asarray(adata_equal.data) * 2
        adata_equal.data = new_data  # bumps the cache token
        s2 = spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        assert np.allclose(np.asarray(s2.data), 4 * np.asarray(s1.data), atol=1e-5)

    def test_trialdefinition_change_invalidates(self, adata_equal):
        spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        trl = adata_equal.trialdefinition
        adata_equal.trialdefinition = trl[:5]
        s2 = spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        assert s2.data.shape[0] == 5

    def test_different_selections_do_not_collide(self, adata_equal):
        a = spy.freqanalysis(adata_equal, method="mtmfft", taper="hann", select={"channel": [0]})
        b = spy.freqanalysis(adata_equal, method="mtmfft", taper="hann", select={"channel": [1]})
        raw = spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        assert np.allclose(np.asarray(a.data)[..., 0], np.asarray(raw.data)[..., 0], atol=1e-6)
        assert np.allclose(np.asarray(b.data)[..., 0], np.asarray(raw.data)[..., 1], atol=1e-6)

    def test_lru_eviction(self, adata_equal, monkeypatch):
        monkeypatch.setattr(routine, "DEVICE_CACHE_BYTES", 1)  # nothing fits
        spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        assert len(routine._DEVICE_CACHE) == 0

    def test_clear(self, adata_equal):
        spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
        routine.clear_device_cache()
        assert routine._DEVICE_CACHE_SIZE[0] == 0

    def test_unfingerprintable_selection_bypasses_and_warns(
            self, adata_equal, monkeypatch, caplog):
        # a selector whose indexer repr fails disables the trial store for
        # the run (correctness-safe) — but the bypass must be LOGGED, not
        # silent
        import logging

        from syncopy_tpu.datatype.selector import Selector

        orig = Selector.trial_indexer

        class _NoRepr(tuple):
            def __repr__(self):
                raise RuntimeError("synthetic unfingerprintable selection")

        def wrapped(self, data, k):
            # behaves exactly like the real indexer tuple, but its repr —
            # which only the fingerprint needs — fails
            return _NoRepr(orig(self, data, k))

        monkeypatch.setattr(Selector, "trial_indexer", wrapped)
        monkeypatch.setattr(routine, "_FINGERPRINT_BYPASS_LOGGED", False)
        # the package logger doesn't propagate to root — hook caplog's
        # handler onto it directly
        pkg_logger = logging.getLogger("syncopy_tpu")
        pkg_logger.addHandler(caplog.handler)
        try:
            spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
            assert len(routine._DEVICE_CACHE) == 0
            bypass = [r for r in caplog.records
                      if "trial store is bypassed" in r.getMessage()]
            assert len(bypass) == 1
            # one-shot: a second run does not re-warn
            spy.freqanalysis(adata_equal, method="mtmfft", taper="hann")
            bypass = [r for r in caplog.records
                      if "trial store is bypassed" in r.getMessage()]
            assert len(bypass) == 1
        finally:
            pkg_logger.removeHandler(caplog.handler)

    def test_fingerprintable_selection_caches(self, adata_equal):
        spy.freqanalysis(adata_equal, method="mtmfft", taper="hann",
                         select={"channel": [0, 1]})
        assert len(routine._DEVICE_CACHE) == 1
