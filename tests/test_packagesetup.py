# -*- coding: utf-8 -*-
# Package-level behavior (modeled on reference tests/test_packagesetup.py):
# namespace assembly, session storage, temp-file hygiene.

import os

import numpy as np
import pytest

import syncopy_tpu as spy


class TestNamespace:
    def test_all_exports_resolve(self):
        for name in spy.__all__:
            assert hasattr(spy, name), name

    def test_frontends_present(self):
        for fe in ("freqanalysis", "connectivityanalysis", "preprocessing",
                   "resampledata", "spike_psth", "timelockanalysis",
                   "mean", "std", "var", "median", "itc",
                   "save", "load", "selectdata", "redefinetrial", "concat",
                   "singlepanelplot", "multipanelplot", "cleanup"):
            assert callable(getattr(spy, fe)), fe

    def test_data_classes_present(self):
        for cls in ("AnalogData", "SpectralData", "CrossSpectralData",
                    "TimeLockData", "SpikeData", "EventData"):
            assert isinstance(getattr(spy, cls), type)

    def test_sessionid(self):
        assert isinstance(spy.__sessionid__, str) and len(spy.__sessionid__) == 8


class TestStorage:
    def test_storage_dir_exists(self):
        assert os.path.isdir(spy.__storage__)

    def test_temp_file_reaped_on_delete(self):
        import gc

        obj = spy.AnalogData(data=np.zeros((100, 2), dtype="f4"), samplerate=100)
        fname = obj.to_hdf()
        assert os.path.exists(fname)
        del obj
        gc.collect()
        assert not os.path.exists(fname)

    def test_clear_keeps_live_objects(self):
        obj = spy.AnalogData(data=np.zeros((50, 2), dtype="f4"), samplerate=50)
        fname = obj.to_hdf()
        spy.clear()
        assert os.path.exists(fname)
        del obj


class TestReferenceApiParity:
    def test_reference_toplevel_names_present(self):
        """Every public name the reference exports at package level exists
        here too (reference __init__.py import surface)."""
        for name in ("SPYExceptionHandler", "get_dir_size", "log",
                     "cleanup", "clear", "copy", "esi_cluster_setup",
                     "cluster_cleanup", "definetrial", "redefinetrial"):
            assert callable(getattr(spy, name)), name

    def test_log_routes_to_logger(self):
        import logging

        records = []

        class Grab(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        logger = logging.getLogger("syncopy_tpu")
        h = Grab()
        logger.addHandler(h)
        prior = logger.level
        logger.setLevel(25)  # the custom IMPORTANT threshold
        try:
            spy.log("parity check message", level="IMPORTANT")
        finally:
            logger.removeHandler(h)
            logger.setLevel(prior)
        assert any("parity check message" in m for m in records)

    def test_exception_handler_formats_spy_errors(self, capsys):
        try:
            raise spy.SPYValueError(legal="x", varname="v")
        except spy.SPYValueError:
            spy.SPYExceptionHandler()
        assert "SPYValueError" in capsys.readouterr().err

    def test_log_parallel_default_level_not_dropped(self):
        import logging

        records = []

        class Grab(logging.Handler):
            def emit(self, record):
                records.append((record.levelno, record.getMessage()))

        plg = spy.get_parallel_logger()
        h = Grab()
        plg.addHandler(h)
        try:
            spy.log("par-important-msg", par=True)  # default IMPORTANT
        finally:
            plg.removeHandler(h)
        assert any(lvl == 25 and "par-important-msg" in m for lvl, m in records)

    def test_log_caller_prefix(self):
        import logging

        records = []

        class Grab(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        lg = logging.getLogger("syncopy_tpu")
        h = Grab()
        lg.addHandler(h)
        try:
            spy.log("something happened", level="WARNING", caller="preprocessing")
        finally:
            lg.removeHandler(h)
        assert any("<preprocessing>" in m and "something happened" in m
                   for m in records)

    def test_get_dir_size_invalid_unit(self, tmp_path):
        with pytest.raises(spy.SPYValueError, match="unit"):
            spy.get_dir_size(str(tmp_path), unit="MiB")


def _run_python(code, env_extra=None, cwd=None):
    """Run `code` in a fresh interpreter with the repo on the path."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd or repo,
                          capture_output=True, text=True, timeout=300)


class TestStartup:
    def test_compile_cache_honours_env(self, tmp_path):
        """With JAX_COMPILATION_CACHE_DIR set, the package sets no cache
        directory of its own: JAX reads the variable itself."""
        cache = str(tmp_path / "jaxcache")
        proc = _run_python(
            "import jax, syncopy_tpu; print(jax.config.jax_compilation_cache_dir)",
            {"JAX_COMPILATION_CACHE_DIR": cache})
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip().splitlines()[-1] == cache

    def test_default_compile_cache_is_fixed_in_checkout(self):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = "import jax, syncopy_tpu; print(jax.config.jax_compilation_cache_dir)"
        first = _run_python(code)
        second = _run_python(code)
        assert first.returncode == 0, first.stderr
        path = first.stdout.strip().splitlines()[-1]
        assert path == os.path.join(repo, ".jax_cache")
        assert second.stdout.strip().splitlines()[-1] == path

    def test_import_without_h5py(self):
        """`import syncopy_tpu` and an in-memory analysis need no h5py."""
        code = (
            "import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name == 'h5py' or name.startswith('h5py.'):\n"
            "            raise ImportError('h5py blocked')\n"
            "sys.meta_path.insert(0, Block())\n"
            "import syncopy_tpu as spy\n"
            "d = spy.synthdata.white_noise(nTrials=3, nSamples=100, nChannels=2, seed=1)\n"
            "s = spy.freqanalysis(d, method='mtmfft', taper='hann')\n"
            "assert 'h5py' not in sys.modules\n"
            "print('ok', s.data.shape)\n")
        proc = _run_python(code)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip().splitlines()[-1].startswith("ok")

    def test_is_h5_dataset_without_h5py_import(self):
        from syncopy_tpu.shared.tools import is_h5_dataset

        assert not is_h5_dataset(np.zeros(3))
        assert not is_h5_dataset(None)
