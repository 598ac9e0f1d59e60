# -*- coding: utf-8 -*-
#
# Test harness: run everything on a virtual 8-device CPU mesh so the
# multi-device (trial-sharded) code paths are exercised without a
# multi-GPU host (the analog of the reference's LocalCluster-based
# "distributed" testing, reference conftest.py:19-61).
#
# SPY_TEST_GPU=1 leaves the platform to JAX instead, and float32 as in
# production, for the tests marked `gpu` (run on the card:
# SPY_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py).

import os

ON_GPU = os.environ.get("SPY_TEST_GPU") == "1"
if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
# double precision for numerical-parity tests (Wilson factorization etc.);
# SPY_TEST_NO_X64=1 (or the card) runs float32-only like production
jax.config.update("jax_enable_x64", not ON_GPU and os.environ.get("SPY_TEST_NO_X64") != "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def gpu():
    """The first device, if it is an NVIDIA GPU; skips the test otherwise.
    Decided here, at run time, so every worker collects the same tests."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX platform is '{}')".format(device.platform))
    return device


@pytest.fixture(scope="session")
def testmesh():
    """An 8-device ('trial' x 'channel' = 4 x 2) mesh on host CPU."""
    import syncopy_tpu as spy

    return spy.make_mesh(n_trial=4, n_channel=2)


@pytest.fixture()
def adata_equal():
    """10 equal-length trials of white noise, 1 kHz, 4 channels."""
    import syncopy_tpu as spy

    return spy.synthdata.white_noise(nTrials=10, nSamples=1000, nChannels=4, seed=42)


@pytest.fixture()
def adata_ragged():
    """Unequal-length trials."""
    import numpy as np
    import syncopy_tpu as spy

    rng = np.random.default_rng(7)
    trls = [rng.normal(size=(n, 3)).astype("f4") for n in (800, 1000, 1000, 900, 800)]
    return spy.AnalogData(data=trls, samplerate=1000)
