# -*- coding: utf-8 -*-
"""
A/B timings on one GPU for the path choices that depend on the platform:

  - SPY_TPU_MATMUL_FFT    matmul DFT vs the platform FFT (non-power-of-two)
  - SPY_TPU_FILTER_GEMM   dense-GEMM FIR/Hilbert vs FFT convolution
  - SPY_TPU_WAVELET_GEMM  GEMM convolution bank vs padded-FFT bank
  - SPY_TPU_WILSON_PLUS   GEMM vs FFT plus-operator in Wilson's iteration
  - lag-GEMM vs FFT cross-covariance (called directly)
  - plain vs compensated CSD Gram (called directly, with coherence error)
  - the Triton PPC kernel vs plain XLA, end to end and alone

    python benchmarks/branch_ab.py [--out FILE]
    python benchmarks/branch_ab.py --ppc-ab [--out FILE]
    python benchmarks/branch_ab.py --wavelet-ab [--out FILE]

The parent process never touches the GPU: it runs one child per knob
setting, one after another, and writes their JSON lines to FILE (and
stdout). Each child times warm frontend calls (best of three, after one
call that compiles) at the chip_smoke.py sizes.

``--ppc-ab`` compares the Triton PPC kernel with plain XLA in ONE
process, in turns (kernel, XLA, XLA, kernel, ...): end to end through
connectivityanalysis(method="ppc") and device-only on the fused batch
program.

``--wavelet-ab`` compares the GEMM and the padded-FFT wavelet banks in
ONE process, in alternating pairs (GEMM, FFT, FFT, GEMM, ...), through
freqanalysis(method="wavelet") at several trial lengths. The knob is read
at trace time and is part of the executable's cache key, so both programs
stay compiled side by side.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (label, extra environment, child options)
VARIANTS = [
    ("default", {}, ["--all"]),
    ("SPY_TPU_MATMUL_FFT=0", {"SPY_TPU_MATMUL_FFT": "0"}, ["--fft"]),
    ("SPY_TPU_FILTER_GEMM=0", {"SPY_TPU_FILTER_GEMM": "0"}, ["--filter"]),
    ("SPY_TPU_WAVELET_GEMM=0", {"SPY_TPU_WAVELET_GEMM": "0"}, ["--wavelet"]),
    ("SPY_TPU_WILSON_PLUS=fft", {"SPY_TPU_WILSON_PLUS": "fft"}, ["--wilson"]),
    ("ppc=xla", {}, ["--ppc-xla"]),
]


def _best(fn, repeats=3):
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times), times


def _frontend(call):
    """Best warm wall of a frontend call (the result's data reaches the
    host inside the window)."""
    import numpy as np

    def run():
        out = call()
        return np.asarray(out.data)

    run()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return min(times), times


def child(opts):
    sys.path.insert(0, REPO)
    import numpy as np

    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    import syncopy_tpu as spy

    if jax.devices()[0].platform != "gpu":
        sys.exit("branch_ab.py needs a GPU")
    cfg = cs.FULL
    T, fs = cfg["n_samples"], cfg["fs"]
    x = cs.north_star_array(cfg, 0)
    ad = cs.make_analog(spy, x, T, fs)
    rows = {}

    def rec(name, fn):
        try:
            best, all_ = fn()
            rows[name] = {"best_s": best, "all_s": all_}
        except Exception as exc:  # one failed row must not lose the others
            rows[name] = {"error": "{}: {}".format(type(exc).__name__, str(exc)[:300])}
        print(name, rows[name], file=sys.stderr, flush=True)

    if opts.ppc_xla:
        from syncopy_tpu.ops import pallas_kernels

        pallas_kernels.ppc_resultant = pallas_kernels.ppc_resultant_xla
    every = opts.all
    if every or opts.fft:
        rec("psd mtmfft", lambda: _frontend(
            lambda: spy.freqanalysis(ad, method="mtmfft", tapsmofrq=2)))
        rec("coherence", lambda: _frontend(
            lambda: spy.connectivityanalysis(ad, method="coh", tapsmofrq=2)))
    if every or opts.fft or opts.ppc_xla:
        rec("ppc", lambda: _frontend(
            lambda: spy.connectivityanalysis(ad, method="ppc", tapsmofrq=2)))
    tf = cs.make_analog(spy, x[: cfg["tf_trials"] * T], T, fs)
    foi = np.arange(4.0, fs / 10, fs / 250)
    toi = np.arange(0.1, T / fs - 0.05, 0.02)
    if every or opts.fft:
        rec("mtmconvol", lambda: _frontend(
            lambda: spy.freqanalysis(tf, method="mtmconvol", t_ftimwin=0.2, toi=0.5)))
        rec("welch", lambda: _frontend(
            lambda: spy.freqanalysis(tf, method="welch", t_ftimwin=0.25, toi=0.5)))
    if every or opts.filter:
        rec("firws lp + hilbert", lambda: _frontend(
            lambda: spy.preprocessing(ad, filter_class="firws", filter_type="lp",
                                      freq=40, hilbert="abs")))
    if every or opts.wavelet:
        rec("wavelet", lambda: _frontend(
            lambda: spy.freqanalysis(tf, method="wavelet", foi=foi, toi=toi)))
        rec("superlet", lambda: _frontend(
            lambda: spy.freqanalysis(tf, method="superlet", foi=foi, toi=toi,
                                     order_max=5, c_1=3)))
    if every or opts.wilson:
        gad = spy.synthdata.ar2_network(
            AdjMat=cs.granger_array(cfg, 0), nTrials=cfg["granger_trials"],
            nSamples=T, samplerate=fs, seed=0)
        rec("granger 128ch", lambda: _frontend(
            lambda: spy.connectivityanalysis(gad, method="granger")))
    if every:
        _direct_rows(rec, x, cfg, rows)
    d = jax.devices()[0]
    print(json.dumps({"device": d.device_kind, "rows": rows}))


def _direct_rows(rec, x, cfg, rows):
    """Rows that call library functions directly (no knob selects them)."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from syncopy_tpu.ops.connectivity import (
        _ccov_lags_fft, _ccov_lags_gemm, _ccov_lag_geometry, csd_sum_compensated,
        normalize_csd,
    )
    from syncopy_tpu.ops.pallas_kernels import ppc_resultant_triton, ppc_resultant_xla

    T, fs, N = cfg["n_samples"], cfg["fs"], cfg["n_trials"]
    # cross-covariance of 128 trials, both forms
    xb = jnp.asarray(x[: 128 * T].reshape(128, T, -1))
    n_lags, delta = _ccov_lag_geometry(T)
    for name, f in (("ccov lag-GEMM", _ccov_lags_gemm), ("ccov FFT", _ccov_lags_fft)):
        fn = jax.jit(jax.vmap(lambda t, f=f: f(t, n_lags, delta)))
        rec(name + " x128 trials", lambda fn=fn: _best(lambda: fn(xb)))

    # CSD Gram over all trials of the north-star spectra, both forms
    taps = cs.tapers64("dpss", T, fs, tapsmofrq=2)
    xs = jnp.asarray(x.reshape(N, T, -1))
    tj = jnp.asarray(taps, jnp.float32)

    @jax.jit
    def spectra(v):
        v = v - jnp.mean(v, axis=1, keepdims=True)
        return jnp.fft.rfft(tj[None, :, :, None] * v[:, None], axis=2)

    spec = spectra(xs)
    plain = jax.jit(lambda s: jnp.einsum("bkfi,bkfj->fij", s, jnp.conj(s),
                                         precision=jax.lax.Precision.HIGHEST))
    comp = jax.jit(csd_sum_compensated)
    acc = 0.0
    for b0 in range(0, N, 25):
        acc = acc + cs.csd_sum64(cs.spectra64(cs.trials64(x, cfg, range(b0, min(b0 + 25, N))), taps))
    csd64 = np.conj(acc) / (N * taps.shape[0])
    d = np.real(np.einsum("fii->fi", csd64))
    coh64 = np.abs(csd64) / np.sqrt(d[:, :, None] * d[:, None, :])
    for name, fn in (("csd gram plain", plain), ("csd gram compensated", comp)):
        rec(name, lambda fn=fn: _best(lambda: fn(spec)))
        coh = np.asarray(normalize_csd(fn(spec) / (N * taps.shape[0]), "abs"))
        rows[name]["coh_abs_err_vs_f64"] = float(np.abs(coh - coh64).max())

    # PPC resultant of one 125-trial chunk, kernel alone vs XLA alone
    chunk = spec[:125]
    nv = jnp.asarray(125, jnp.int32)
    tri = jax.jit(lambda s: ppc_resultant_triton(jnp.real(s), jnp.imag(s), nv))
    xla = jax.jit(lambda s: ppc_resultant_xla(s, nv))
    rec("ppc chunk triton", lambda: _best(lambda: tri(chunk)))
    rec("ppc chunk xla", lambda: _best(lambda: xla(chunk)))
    rows["ppc chunk triton"]["max_abs_diff_vs_xla"] = float(
        jnp.abs(tri(chunk) - xla(chunk)).max())


def ppc_ab(out_path, rounds=3, calls=5):
    sys.path.insert(0, REPO)
    import numpy as np

    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    import syncopy_tpu as spy
    from syncopy_tpu.connectivity.ST_compRoutines import PPCSpectra
    from syncopy_tpu.engine import routine
    from syncopy_tpu.ops import pallas_kernels as pk

    if jax.devices()[0].platform != "gpu":
        sys.exit("branch_ab.py needs a GPU")
    cfg = cs.FULL
    T, fs, N = cfg["n_samples"], cfg["fs"], cfg["n_trials"]
    x = cs.north_star_array(cfg, 0)
    ad = cs.make_analog(spy, x, T, fs)
    kernel = pk.ppc_resultant
    impls = {"triton": kernel, "xla": pk.ppc_resultant_xla}
    cr = PPCSpectra(samplerate=fs, nSamples=T, taper="dpss",
                    taper_opt={"NW": 2.0, "Kmax": 3})
    xb = jnp.asarray(x.reshape(N, T, -1))
    nv = jnp.asarray(N, jnp.int32)
    res = {"e2e_s": {"triton": [], "xla": []}, "device_s": {"triton": [], "xla": []}}
    order = ["triton", "xla", "xla", "triton"] * ((rounds + 1) // 2)
    for name in order[: 2 * rounds]:
        pk.ppc_resultant = impls[name]
        routine._GLOBAL_JIT_CACHE.clear()
        call = lambda: np.asarray(
            spy.connectivityanalysis(ad, method="ppc", tapsmofrq=2).data)
        call()  # compile outside the window
        for _ in range(calls):
            t0 = time.perf_counter()
            call()
            res["e2e_s"][name].append(time.perf_counter() - t0)
        dev = jax.jit(lambda b: cr.process_batch_sum(b, nv, **cr.cfg))
        best, _ = _best(lambda: dev(xb), repeats=calls)
        res["device_s"][name].append(best)
        print(name, res["e2e_s"][name][-calls:], best, file=sys.stderr, flush=True)
    pk.ppc_resultant = kernel
    res["device"] = jax.devices()[0].device_kind
    print(json.dumps(res))
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(res) + "\n")


def wavelet_ab(out_path, lengths=(500, 1000, 2000), pairs=10, calls=3):
    sys.path.insert(0, REPO)
    import numpy as np

    import jax

    import chip_smoke as cs
    import syncopy_tpu as spy

    if jax.devices()[0].platform != "gpu":
        sys.exit("branch_ab.py needs a GPU")
    fs = cs.FULL["fs"]
    foi = np.arange(4.0, fs / 10, fs / 250)
    res = {"device": jax.devices()[0].device_kind, "trials": cs.FULL["tf_trials"],
           "n_foi": len(foi), "wall_s": {}}
    order = ["1", "0", "0", "1"] * ((pairs + 1) // 2)
    for T in lengths:
        cfg = dict(cs.FULL, n_trials=cs.FULL["tf_trials"], n_samples=T)
        tf = cs.make_analog(spy, cs.north_star_array(cfg, 0), T, fs)
        toi = np.arange(0.1, T / fs - 0.05, 0.02)
        call = lambda: np.asarray(
            spy.freqanalysis(tf, method="wavelet", foi=foi, toi=toi).data)
        walls = {"gemm": [], "fft": []}
        for mode in ("1", "0"):  # compile both outside the window
            os.environ["SPY_TPU_WAVELET_GEMM"] = mode
            call()
        for mode in order[: 2 * pairs]:
            os.environ["SPY_TPU_WAVELET_GEMM"] = mode
            for _ in range(calls):
                t0 = time.perf_counter()
                call()
                walls["gemm" if mode == "1" else "fft"].append(time.perf_counter() - t0)
        os.environ.pop("SPY_TPU_WAVELET_GEMM")
        res["wall_s"][str(T)] = walls
        print(T, {k: (min(v), float(np.median(v)), max(v)) for k, v in walls.items()},
              file=sys.stderr, flush=True)
    print(json.dumps(res))
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(res) + "\n")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    for flag in ("--child", "--all", "--fft", "--filter", "--wavelet", "--wilson",
                 "--ppc-xla", "--ppc-ab", "--wavelet-ab"):
        parser.add_argument(flag, action="store_true")
    opts = parser.parse_args()
    if opts.ppc_ab:
        return ppc_ab(opts.out)
    if opts.wavelet_ab:
        return wavelet_ab(opts.out)
    if opts.child:
        return child(opts)
    results = []
    for label, env, args in VARIANTS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"] + args,
            env=dict(os.environ, **env), capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if proc.returncode == 0 and lines else {
            "error": proc.stderr[-2000:]}
        res.update(variant=label, wall_s=time.perf_counter() - t0, rc=proc.returncode)
        results.append(res)
        print(json.dumps(res), flush=True)
        if opts.out:
            with open(opts.out, "a") as f:
                f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
