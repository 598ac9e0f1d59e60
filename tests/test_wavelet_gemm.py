# -*- coding: utf-8 -*-
# Direct-GEMM wavelet/superlet convolution path (ops/wavelet.py): equality
# against the padded-FFT bank, runtime-bank operands, and the engine's
# device-constant plumbing (engine/routine.py::device_constants).

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import syncopy_tpu as spy
from syncopy_tpu.ops.wavelet import (
    DOG,
    Morlet,
    Paul,
    cwt,
    cwt_gemm_consts,
    superlet,
    superlet_gemm_consts,
)


@pytest.fixture
def signal():
    rng = np.random.default_rng(11)
    return jnp.asarray(rng.standard_normal((300, 3)).astype(np.float32))


SCALES = np.asarray(Morlet(6).scale_from_period(1.0 / np.linspace(10.0, 150.0, 12)))
SL_SCALES = (1.0 / np.linspace(10.0, 100.0, 8)) / (2 * np.pi)
DT = 1e-3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


class TestCwtGemmEquality:
    @pytest.mark.parametrize("wav", [Morlet(6), Paul(4), DOG(2)], ids=["morlet", "paul", "dog"])
    def test_matches_fft_path(self, monkeypatch, signal, wav):
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        ref = np.asarray(cwt(signal, wav, SCALES, DT))
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        new = np.asarray(cwt(signal, wav, SCALES, DT))
        assert _rel(new, ref) < 2e-5

    def test_bank_as_runtime_operand(self, monkeypatch, signal):
        """The engine form: bank built host-side, passed as jit args."""
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        ref = np.asarray(cwt(signal, Morlet(6), SCALES, DT))
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        bank = cwt_gemm_consts(Morlet(6), SCALES, DT, signal.shape[0])
        assert len(bank) == 2 and all(a.dtype == np.float32 for a in bank)
        fn = jax.jit(lambda x, br, bi: cwt(x, Morlet(6), SCALES, DT, bank=(br, bi)))
        new = np.asarray(fn(signal, *bank))
        assert _rel(new, ref) < 2e-5

    def test_gate_off_returns_no_consts(self, monkeypatch):
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        assert cwt_gemm_consts(Morlet(6), SCALES, DT, 300) == ()

    def test_kernel_longer_than_signal(self, monkeypatch):
        """Low-frequency kernels whose support exceeds the trial: the
        dense rows are simply full — still equal to the FFT path."""
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.standard_normal((64, 2)).astype(np.float32))
        scales = np.asarray(Morlet(6).scale_from_period(1.0 / np.asarray([2.0, 5.0])))
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        ref = np.asarray(cwt(x, Morlet(6), scales, DT))
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        new = np.asarray(cwt(x, Morlet(6), scales, DT))
        assert _rel(new, ref) < 2e-5


class TestSuperletGemmEquality:
    @pytest.mark.parametrize("adaptive", [False, True], ids=["mult", "adaptive"])
    @pytest.mark.parametrize("mag", [False, True], ids=["complex", "magnitude"])
    def test_matches_fft_path(self, monkeypatch, signal, adaptive, mag):
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        ref = np.asarray(superlet(signal, SL_SCALES, 4, 1, 3, adaptive,
                                  dt=DT, magnitude_only=mag))
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        new = np.asarray(superlet(signal, SL_SCALES, 4, 1, 3, adaptive,
                                  dt=DT, magnitude_only=mag))
        assert _rel(new, ref) < 2e-5

    def test_pair_bank_runtime_operand(self, monkeypatch, signal):
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        ref = np.asarray(superlet(signal, SL_SCALES, 4, dt=DT, magnitude_only=True))
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        bank = superlet_gemm_consts(SL_SCALES, 4, 1, 3, False, DT, signal.shape[0])
        # multiplicative SLT: every (order, scale) pair carries weight
        assert bank[0].shape[0] == 4 * len(SL_SCALES) * signal.shape[0]
        new = np.asarray(superlet(signal, SL_SCALES, 4, dt=DT,
                                  magnitude_only=True, bank=bank))
        assert _rel(new, ref) < 2e-5

    def test_adaptive_bank_drops_zero_weight_pairs(self, monkeypatch):
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        T = 100
        bank = superlet_gemm_consts(SL_SCALES, 4, 1, 3, True, DT, T)
        full = superlet_gemm_consts(SL_SCALES, 4, 1, 3, False, DT, T)
        assert 0 < bank[0].shape[0] < full[0].shape[0]


def _tfr_data(nTrials=3, nSamples=200, fs=1000.0):
    rng = np.random.default_rng(7)
    trls = [rng.standard_normal((nSamples, 2)).astype("f4") for _ in range(nTrials)]
    return spy.AnalogData(data=trls, samplerate=fs)


class TestEngineDeviceConstants:
    """The full production chain: freqanalysis -> engine -> device_put
    banks passed as runtime args -> process_single_trial bound consts."""

    def test_wavelet_frontend_parity(self, monkeypatch):
        data = _tfr_data()
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        ref = spy.freqanalysis(data, method="wavelet", foi=np.linspace(20, 80, 10),
                               output="pow")
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        from syncopy_tpu.engine.routine import _DEVICE_CONST_CACHE

        _DEVICE_CONST_CACHE.clear()
        new = spy.freqanalysis(data, method="wavelet", foi=np.linspace(20, 80, 10),
                               output="pow")
        # the bank really crossed through the device-constant path
        assert len(_DEVICE_CONST_CACHE) > 0
        assert np.allclose(np.asarray(new.data), np.asarray(ref.data),
                           rtol=1e-4, atol=1e-7 * float(np.max(np.asarray(ref.data))))

    def test_superlet_frontend_parity(self, monkeypatch):
        data = _tfr_data()
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        ref = spy.freqanalysis(data, method="superlet", foi=np.linspace(20, 80, 8),
                               order_max=3, output="pow")
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        from syncopy_tpu.engine.routine import _DEVICE_CONST_CACHE

        _DEVICE_CONST_CACHE.clear()
        new = spy.freqanalysis(data, method="superlet", foi=np.linspace(20, 80, 8),
                               order_max=3, output="pow")
        assert len(_DEVICE_CONST_CACHE) > 0
        assert np.allclose(np.asarray(new.data), np.asarray(ref.data),
                           rtol=1e-4, atol=1e-7 * float(np.max(np.asarray(ref.data))))

    def test_live_consts_cleared_after_run(self, monkeypatch):
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        data = _tfr_data(nTrials=2, nSamples=128)
        spy.freqanalysis(data, method="wavelet", foi=[30.0, 50.0], output="pow")
        from syncopy_tpu.specest.compRoutines import WaveletTransform

        # no leaked tracers on any instance: class default restored
        assert WaveletTransform._live_consts is None

    def test_keeptrials_false_path(self, monkeypatch):
        """Fused trial-average path (process_batch branch differs)."""
        data = _tfr_data()
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "0")
        ref = spy.freqanalysis(data, method="wavelet", foi=[30.0, 50.0],
                               output="pow", keeptrials=False)
        monkeypatch.setenv("SPY_TPU_WAVELET_GEMM", "1")
        new = spy.freqanalysis(data, method="wavelet", foi=[30.0, 50.0],
                               output="pow", keeptrials=False)
        assert np.allclose(np.asarray(new.data), np.asarray(ref.data),
                           rtol=1e-4, atol=1e-7 * float(np.max(np.asarray(ref.data))))


class TestBankChoice:
    """Which convolution bank the library picks with no knob set: the GEMM
    bank for the CWT of trials up to 1024 samples on a GPU, the FFT bank
    for longer trials, for superlets, and on the CPU."""

    @pytest.mark.parametrize("backend,T,superlet,want", [
        ("gpu", 500, False, True),
        ("gpu", 1000, False, True),
        ("gpu", 1024, False, True),
        ("gpu", 2000, False, False),
        ("gpu", 500, True, False),
        ("cpu", 500, False, False),
    ])
    def test_auto_choice(self, monkeypatch, backend, T, superlet, want):
        from syncopy_tpu.ops import wavelet as wv

        monkeypatch.delenv("SPY_TPU_WAVELET_GEMM", raising=False)
        monkeypatch.setattr(wv.jax, "default_backend", lambda: backend)
        assert wv._prefer_conv_gemm(T, 24, superlet=superlet) is want

    def test_bank_cap(self, monkeypatch):
        from syncopy_tpu.ops import wavelet as wv

        monkeypatch.delenv("SPY_TPU_WAVELET_GEMM", raising=False)
        monkeypatch.setattr(wv.jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(wv, "_GEMM_BANK_CAP_BYTES", 8.0 * 24 * 1000.0 ** 2 - 1)
        assert not wv._prefer_conv_gemm(1000, 24)
