# -*- coding: utf-8 -*-
# Complex-pair boundary encoding tests (parallel/device_io.py): the
# load-bearing machinery for runtimes without complex transfer support.

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from syncopy_tpu.parallel.device_io import (
    _RUN_CACHE,
    decode_host,
    decode_in_jit,
    encode_host,
    encode_in_jit,
    run_on_device,
)


class TestEncoding:
    def test_roundtrip_complex(self):
        rng = np.random.default_rng(0)
        z = rng.normal(size=(5, 7)) + 1j * rng.normal(size=(5, 7))
        z = z.astype(np.complex64)
        enc, flag = encode_host(z, axis=0)
        assert flag and enc.shape == (2, 5, 7) and enc.dtype == np.float32
        assert np.allclose(decode_host(enc, flag, axis=0), z)

    def test_roundtrip_axis1(self):
        z = (np.arange(12).reshape(3, 4) * (1 + 2j)).astype(np.complex64)
        enc, flag = encode_host(z, axis=1)
        assert enc.shape == (3, 2, 4)
        assert np.allclose(decode_host(enc, flag, axis=1), z)

    def test_real_passthrough(self):
        x = np.ones((3, 3), dtype=np.float32)
        enc, flag = encode_host(x)
        assert not flag and enc is x

    def test_complex128(self):
        z = np.ones((2, 2), dtype=np.complex128) * (1 + 1j)
        enc, flag = encode_host(z)
        assert enc.dtype == np.float64
        assert decode_host(enc, flag).dtype == np.complex128

    def test_in_jit_roundtrip(self):
        z = (np.random.default_rng(1).normal(size=(4, 6))).astype(np.float32) * (1 + 0j)
        z = z.astype(np.complex64) + 1j * 0.5

        @jax.jit
        def f(enc):
            c = decode_in_jit(enc, True, axis=0)
            return encode_in_jit(c * 2, axis=0)[0]

        enc, _ = encode_host(z)
        out = decode_host(np.asarray(f(enc)), True)
        assert np.allclose(out, 2 * z, atol=1e-6)


class TestRunOnDevice:
    def test_complex_in_real_out(self):
        z = (np.random.default_rng(2).normal(size=(8, 4))
             + 1j * np.random.default_rng(3).normal(size=(8, 4))).astype(np.complex64)
        got = run_on_device(lambda c: jnp.abs(c) ** 2, z, key=("test_abs2",))
        assert np.allclose(got, np.abs(z) ** 2, atol=1e-5)

    def test_complex_out(self):
        x = np.random.default_rng(4).normal(size=(16, 2)).astype(np.float32)
        got = run_on_device(lambda v: jnp.fft.fft(v, axis=0), x, key=("test_fft",))
        assert np.allclose(got, np.fft.fft(x, axis=0), atol=1e-4)

    def test_pytree_output(self):
        x = np.ones((4, 4), dtype=np.float32)
        a, b = run_on_device(lambda v: (v + 1, v * 1j), x, key=("test_tree",))
        assert np.allclose(a, 2.0)
        assert np.iscomplexobj(b)

    def test_wrapper_cached(self):
        x = np.zeros((4, 4), dtype=np.float32)
        key = ("test_cache_hit",)
        run_on_device(lambda v: v + 1, x, key=key)
        n = len(_RUN_CACHE)
        run_on_device(lambda v: v + 1, x, key=key)
        assert len(_RUN_CACHE) == n  # same key+shape -> reused

    def test_different_shapes_not_conflated(self):
        key = ("test_shapes",)
        a = run_on_device(lambda v: v.sum(), np.ones((2, 2), "f4"), key=key)
        b = run_on_device(lambda v: v.sum(), np.ones((3, 3), "f4"), key=key)
        assert float(a) == 4.0 and float(b) == 9.0


class TestReducedPrecisionBounds:
    """Assert the documented error bounds of the reduced-precision
    transfer paths (CLAUDE.md / BASELINE.md claims)."""

    def test_f16_transfer_coherence_bound(self, monkeypatch):
        import syncopy_tpu as spy
        from syncopy_tpu.engine import routine

        # the bench workload (white noise, the context of the documented
        # <5e-5 bound); strongly autocorrelated data lands nearer ~1e-4
        d = spy.synthdata.white_noise(nTrials=60, nSamples=500,
                                      nChannels=8, seed=30, samplerate=200)
        ref = spy.connectivityanalysis(d, method="coh", tapsmofrq=3)
        monkeypatch.setattr(routine, "TRANSFER_DTYPE", "float16")
        d2 = spy.synthdata.white_noise(nTrials=60, nSamples=500,
                                       nChannels=8, seed=30, samplerate=200)
        got = spy.connectivityanalysis(d2, method="coh", tapsmofrq=3)
        dev = np.abs(np.asarray(got.data) - np.asarray(ref.data)).max()
        assert dev < 5e-5, dev

        # colored AR(2) data: looser but still tight general bound
        a = spy.synthdata.ar2_network(nTrials=60, samplerate=200,
                                      nSamples=500, seed=30)
        monkeypatch.setattr(routine, "TRANSFER_DTYPE", "")
        ref2 = spy.connectivityanalysis(a, method="coh", tapsmofrq=3)
        monkeypatch.setattr(routine, "TRANSFER_DTYPE", "float16")
        a2 = spy.synthdata.ar2_network(nTrials=60, samplerate=200,
                                       nSamples=500, seed=30)
        got2 = spy.connectivityanalysis(a2, method="coh", tapsmofrq=3)
        dev2 = np.abs(np.asarray(got2.data) - np.asarray(ref2.data)).max()
        assert dev2 < 5e-4, dev2

    def test_f16_readback_power_bound(self, monkeypatch):
        import syncopy_tpu as spy

        monkeypatch.setenv("SPY_TPU_DEVICE_RESIDENT", "0")
        d = spy.synthdata.white_noise(nTrials=10, nSamples=512,
                                      nChannels=4, seed=31)
        foi = np.linspace(10, 90, 20)
        ref = spy.freqanalysis(d, method="wavelet", foi=foi, output="pow",
                               keeptrials=True)
        monkeypatch.setenv("SPY_TPU_READBACK_DTYPE", "float16")
        got = spy.freqanalysis(d, method="wavelet", foi=foi, output="pow",
                               keeptrials=True)
        r = np.asarray(ref.data)
        g = np.asarray(got.data)
        rel = np.abs(g - r) / np.maximum(np.abs(r), np.abs(r).max() * 1e-3)
        # f16 has an 11-bit mantissa: relative quantization is bounded by
        # 2^-11 ~= 4.9e-4 (plus the shared-exponent flush guard above)
        assert rel.max() <= 2.0 ** -11 + 1e-6, rel.max()

    def test_f16_readback_never_downcasts_complex(self, monkeypatch):
        import syncopy_tpu as spy

        monkeypatch.setenv("SPY_TPU_DEVICE_RESIDENT", "0")
        monkeypatch.setenv("SPY_TPU_READBACK_DTYPE", "float16")
        d = spy.synthdata.white_noise(nTrials=4, nSamples=256,
                                      nChannels=2, seed=32)
        spec = spy.freqanalysis(d, method="mtmfft", output="fourier",
                                keeptrials=True)
        assert np.asarray(spec.data).dtype == np.complex64
        ref = spy.freqanalysis(d, method="mtmfft", output="fourier",
                               keeptrials=True)
        del_env = True  # readback env still set; complex path must be exact
        assert np.array_equal(np.asarray(spec.data), np.asarray(ref.data))
