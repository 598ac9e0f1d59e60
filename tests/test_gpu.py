# -*- coding: utf-8 -*-
# Tests that need an NVIDIA GPU. They skip elsewhere; on the card:
#     SPY_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_ppc_triton_kernel_matches_xla(gpu):
    """The compiled Triton PPC kernel against the XLA form at a real
    width (64 channels, 501 bins, 3 tapers)."""
    import jax
    import jax.numpy as jnp

    from syncopy_tpu.ops.pallas_kernels import ppc_resultant_triton, ppc_resultant_xla

    rng = np.random.default_rng(0)
    shape = (40, 3, 501, 64)
    spec = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    spec = jax.device_put(spec, gpu)
    got = np.asarray(ppc_resultant_triton(jnp.real(spec), jnp.imag(spec), 37))
    want = np.asarray(ppc_resultant_xla(spec, 37))
    assert np.abs(got - want).max() < 1e-4


def test_ppc_frontend_uses_kernel(gpu, monkeypatch):
    """connectivityanalysis(method='ppc') on the GPU goes through the
    Triton kernel."""
    import syncopy_tpu as spy
    from syncopy_tpu.ops import pallas_kernels as pk

    calls = []
    real = pk.ppc_resultant_triton

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(pk, "ppc_resultant_triton", counting)
    d = spy.synthdata.white_noise(nTrials=20, nSamples=500, nChannels=8, seed=3)
    out = spy.connectivityanalysis(d, method="ppc", tapsmofrq=4)
    assert calls and np.isfinite(np.asarray(out.data)).all()
