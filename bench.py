#!/usr/bin/env python
# -*- coding: utf-8 -*-
#
# Driver benchmark: trials/sec for the BASELINE.json north-star workload —
# multitaper PSD + coherence on 1000 trials x 64 channels x 1 s @ 1 kHz.
#
# Prints ONE JSON line:
#   {"metric": ..., "value": N, "unit": "trials/sec", "vs_baseline": R}
#
# `vs_baseline` compares against a single-core NumPy implementation of the
# identical math (the reference syncopy's sequential compute path: per-trial
# tapered rfft + channel outer product + running average + coherence
# normalization), measured on this machine at runtime and extrapolated.

import json
import os
import sys
import time

import numpy as np

NTRIALS = int(os.environ.get("SPY_BENCH_TRIALS", 1000))
NCHAN = int(os.environ.get("SPY_BENCH_CHANNELS", 64))
NSAMP = int(os.environ.get("SPY_BENCH_SAMPLES", 1000))
FS = 1000.0


def make_data(n_trials):
    import syncopy_tpu as spy

    rng = np.random.default_rng(0)
    data = rng.normal(size=(n_trials * NSAMP, NCHAN)).astype("f4")
    trl = np.zeros((n_trials, 3))
    trl[:, 0] = np.arange(n_trials) * NSAMP
    trl[:, 1] = trl[:, 0] + NSAMP
    ad = spy.AnalogData(data=data, samplerate=FS)
    ad.trialdefinition = trl
    return ad


def numpy_baseline_rate(n_probe=20):
    """Single-core numpy mtmfft+coherence (the reference's per-worker
    math, run sequentially) -> trials/sec."""
    from scipy.signal import windows

    rng = np.random.default_rng(1)
    trials = [rng.normal(size=(NSAMP, NCHAN)).astype("f4") for _ in range(n_probe)]
    NW = 2 * NSAMP / FS
    Kmax = max(int(2 * NW - 1), 1)
    taps = windows.dpss(NSAMP, NW, Kmax) * np.sqrt(NSAMP) * (np.sqrt(2) / NSAMP)

    t0 = time.perf_counter()
    acc = np.zeros((NSAMP // 2 + 1, NCHAN, NCHAN), dtype=np.complex64)
    for trl in trials:
        x = trl - trl.mean(axis=0)
        spec = np.fft.rfft(taps[:, :, None] * x[None, :, :], axis=1)
        cs = np.einsum("kfi,kfj->fij", spec, np.conj(spec)) / Kmax
        acc += cs
    acc /= n_probe
    diag = np.abs(np.einsum("fii->fi", acc))
    _ = np.abs(acc) / np.sqrt(diag[:, :, None] * diag[:, None, :])
    t1 = time.perf_counter()
    return n_probe / (t1 - t0)


def device_only_metrics(full=False):
    """Device-bound kernel throughput + utilization: inputs generated on
    device, outputs resident — isolates the card's speed from host work
    (see benchmarks/device_bench.py)."""
    from benchmarks.device_bench import run_device_bench

    return run_device_bench(full=full)


def main():
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit("bench.py measures the GPU; JAX found no GPU (platform '{}')".format(
            device.platform))

    import syncopy_tpu as spy

    if "--device-only" in sys.argv:
        print(json.dumps(device_only_metrics(full="--full" in sys.argv)))
        return

    if "--config5-device" in sys.argv:
        # BASELINE config #5 at its full 1024-ch x 10k-trial spec,
        # device-bound (streamed on-chip; minutes of wall — not part of
        # the default driver benchmark)
        from benchmarks.config5_device import run_config5_device

        print(json.dumps(run_config5_device()))
        return

    # PRIMARY metric: the device-bound kernel rate for the north-star
    # workload; the end-to-end frontend call is a labeled secondary
    base_rate = max(numpy_baseline_rate(), numpy_baseline_rate())
    device = device_only_metrics()
    dev_rate = device.get("coh_device", {}).get("trials_per_s")

    result = {
        "metric": "device-bound mtmfft+coherence kernel trials/sec "
                  "(1000x64ch x 1s @ 1kHz)",
        "value": dev_rate,
        "unit": "trials/sec",
        "vs_baseline": round(dev_rate / base_rate, 2) if dev_rate else None,
        "device": device,
    }

    # secondary: the end-to-end frontend call from host memory
    ad = make_data(NTRIALS)
    # warm-up compiles every chunk shape
    spy.connectivityanalysis(ad, method="coh", tapsmofrq=2)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        spy.connectivityanalysis(ad, method="coh", tapsmofrq=2)
        times.append(time.perf_counter() - t0)
    result["end_to_end"] = {
        "warm_trials_per_s": round(NTRIALS / min(times), 2),
        "vs_baseline": round(NTRIALS / min(times) / base_rate, 2),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
