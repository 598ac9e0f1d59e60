# -*- coding: utf-8 -*-
#
# Profiling / tracing facilities.
#
# Parity target: reference SURVEY.md §5 "tracing/profiling" — the reference
# offers tqdm progress + `parallel_debug` single-threaded scheduling + an
# ASV suite; the device-native equivalents are the JAX profiler (XLA traces
# viewable in TensorBoard/Perfetto) plus the engine's per-phase timing
# (SPY_TPU_PROFILE=1, engine/routine.py).

import contextlib
import os
import time

__all__ = ["profile", "Timer"]


@contextlib.contextmanager
def profile(logdir=None):
    """
    Trace all device activity within the block with the JAX profiler::

        with spy.profile("/tmp/trace"):
            spy.freqanalysis(data, ...)

    View with TensorBoard or ui.perfetto.dev. Defaults to
    ``$SPYDIR/traces``.
    """
    import jax

    if logdir is None:
        spydir = os.environ.get("SPYDIR", os.path.join(os.path.expanduser("~"), ".spy"))
        logdir = os.path.join(spydir, "traces")
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock context timer: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False
