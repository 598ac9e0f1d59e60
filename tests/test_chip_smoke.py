# -*- coding: utf-8 -*-
# chip_smoke.py: its refusal to run without a GPU, and every phase's
# control flow and oracle at a tiny size on the CPU (the card runs the
# same functions at FULL size).

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run(script_dir, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, os.path.join(script_dir, "chip_smoke.py"), *args],
                          cwd=script_dir, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_exits_nonzero_without_gpu(args):
    proc = _run(REPO, *args)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_exits_nonzero_alone(tmp_path):
    """Copied away from the repository, the script cannot import the
    package and must fail rather than print a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture(scope="module")
def tiny():
    import syncopy_tpu as spy

    x = cs.north_star_array(cs.TINY, 0)
    rep = cs.Report("cpu", jax.devices()[0])
    return spy, x, rep


def test_report_raises_over_tolerance(capsys):
    rep = cs.Report("cpu", jax.devices()[0])
    rep.check("within", 0.1, 1e-6, 1e-4, "test")
    with pytest.raises(AssertionError, match="exceeds"):
        rep.check("over", 0.1, 1e-3, 1e-4, "test")
    with pytest.raises(AssertionError):
        rep.check("nan", 0.1, float("nan"), 1e-4, "test")
    assert "within" in capsys.readouterr().out


def test_phase_north_star(tiny):
    spy, x, rep = tiny
    coh = cs.phase_north_star(spy, x, cs.TINY, rep)
    assert coh.shape == (1, cs.TINY["n_samples"] // 2 + 1, cs.TINY["n_chan"],
                         cs.TINY["n_chan"])


def test_phase_granger():
    """Run as on the card, in float32 (the suite enables x64, which turns
    the device factorization into the plain complex128 iteration)."""
    code = ("import jax, chip_smoke as cs, syncopy_tpu as spy\n"
            "assert not jax.config.jax_enable_x64\n"
            "cs.phase_granger(spy, cs.TINY, 0, cs.Report('cpu', jax.devices()[0]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "2 granger" in proc.stdout


def test_phase_granger_flags_host_route(tiny, monkeypatch):
    """A Granger call that ends on the host float64 route must fail the
    phase, even though its numbers would pass."""
    from syncopy_tpu.connectivity import connectivity_analysis as ca

    spy, _, rep = tiny
    monkeypatch.setattr(ca, "_granger_rank_deficient", lambda *a: True)
    with pytest.raises(AssertionError, match="host"):
        cs.phase_granger(spy, cs.TINY, 0, rep)


def test_phase_preprocessing(tiny):
    spy, x, rep = tiny
    cs.phase_preprocessing(spy, x, cs.TINY, rep)


def test_phase_time_frequency(tiny):
    spy, x, rep = tiny
    cs.phase_time_frequency(spy, x, cs.TINY, rep)


def test_phase_resident_and_jackknife(tiny):
    spy, x, rep = tiny
    cs.phase_resident_and_jackknife(spy, x, cs.TINY, rep)
    assert "SPY_TPU_DEVICE_RESIDENT" not in os.environ


def test_phase_from_disk(tiny, tmp_path):
    spy, x, rep = tiny
    coh = cs.phase_north_star(spy, x, cs.TINY, rep)
    cs.phase_from_disk(spy, x, cs.TINY, rep, coh, str(tmp_path))


def test_four_card_path_on_virtual_devices(tiny):
    spy, _, rep = tiny
    cs.run_four_cards(spy, cs.TINY, 0, rep)


def test_bench_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
