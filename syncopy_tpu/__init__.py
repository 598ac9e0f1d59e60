# -*- coding: utf-8 -*-
#
# syncopy_tpu: JAX framework for large-scale electrophysiology data
# analysis with the capabilities of esi-neuroscience/syncopy.
#
# Namespace assembly mirrors reference syncopy/__init__.py:147-228: every
# subpackage's __all__ is re-exported flat so `spy.freqanalysis(...)` works.

import os
import sys
import uuid

__version__ = "0.1.0"

# session identity + temp storage (reference syncopy/__init__.py:112-135)
__sessionid__ = str(uuid.uuid4())[:8]

from .shared.errors import (  # noqa: F401
    SPYError,
    SPYTypeError,
    SPYValueError,
    SPYIOError,
    SPYParallelError,
    SPYWarning,
    SPYInfo,
    SPYLog,
    SPYExceptionHandler,
    log,
)
from .shared.tools import StructDict, SerializableDict, get_defaults, best_match  # noqa: F401
from .shared.log import (  # noqa: F401
    setup_logging,
    get_logger,
    get_parallel_logger,
    set_loglevel,
)
from .shared.profiling import profile, Timer  # noqa: F401
from .datatype.util import setup_storage, storage_dir, get_dir_size  # noqa: F401

#: session-scoped temp-storage directory (reference `__storage__`)
__storage__, __storage_size_gb__, __storage_nfiles__ = setup_storage()

# persistent XLA compilation cache. Where JAX_COMPILATION_CACHE_DIR is
# set, JAX reads it itself and the package sets nothing; otherwise the
# cache lives at one fixed path inside the checkout (a cache key includes
# its directory, so the path must not move between processes).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    del _jax

setup_logging(session_id=__sessionid__)

from .shared.errors import install_exception_handler as _install_eh

_install_eh()  # concise SPYError tracebacks in interactive sessions

if __storage_size_gb__ > 10 and not os.environ.get("SPYSILENTSTARTUP"):
    print(
        "syncopy_tpu: temp storage holds {:.1f} GB in {} files; consider "
        "spy.cleanup()".format(__storage_size_gb__, __storage_nfiles__)
    )

from .datatype import (  # noqa: F401
    AnalogData,
    SpectralData,
    CrossSpectralData,
    TimeLockData,
    SpikeData,
    EventData,
    Selector,
    definetrial,
    redefinetrial,
    selectdata,
    show,
    concat,
)
from .engine.routine import ComputationalRoutine  # noqa: F401
from .parallel.mesh import (  # noqa: F401
    make_mesh,
    use_mesh,
    active_mesh,
    cluster_cleanup,
    esi_cluster_setup,
    init_distributed,
)
from .specest import freqanalysis  # noqa: F401
from .connectivity import connectivityanalysis  # noqa: F401
from .preproc import preprocessing, resampledata  # noqa: F401
from .statistics import (  # noqa: F401
    mean,
    std,
    var,
    median,
    itc,
    spike_psth,
    timelockanalysis,
)
from .io import save, load, load_ft_raw, load_tdt, load_nwb, cleanup, clear  # noqa: F401
from .io.mne_conv import (  # noqa: F401
    raw_adata_to_mne_raw,
    raw_mne_to_adata,
    tldata_to_mne_epochs,
    mne_epochs_to_tldata,
)
from .plotting import singlepanelplot, multipanelplot  # noqa: F401
from . import synthdata  # noqa: F401
from .datatype.methods.copy import copy  # noqa: F401
from .datatype.util import TrialIndexer, TimeIndexer  # noqa: F401
from .ops.wavelet import (  # noqa: F401
    Morlet,
    Paul,
    DOG,
    Ricker,
    MorletSL,
    cwt,
    WaveletAnalysis,
    WaveletTransform,
)
from .io import mne_conv  # noqa: F401

#: aliases kept for reference-API parity
Marr = Ricker
Mexican_hat = Ricker

__all__ = [
    "AnalogData",
    "SpectralData",
    "CrossSpectralData",
    "TimeLockData",
    "SpikeData",
    "EventData",
    "Selector",
    "StructDict",
    "definetrial",
    "redefinetrial",
    "selectdata",
    "show",
    "concat",
    "freqanalysis",
    "connectivityanalysis",
    "preprocessing",
    "resampledata",
    "mean",
    "std",
    "var",
    "median",
    "itc",
    "spike_psth",
    "timelockanalysis",
    "save",
    "load",
    "load_ft_raw",
    "load_tdt",
    "load_nwb",
    "cleanup",
    "clear",
    "singlepanelplot",
    "multipanelplot",
    "synthdata",
    "make_mesh",
    "use_mesh",
    "cluster_cleanup",
    "ComputationalRoutine",
    "get_defaults",
    "best_match",
    "setup_logging",
    "set_loglevel",
    "copy",
    "TrialIndexer",
    "TimeIndexer",
    "Morlet",
    "Paul",
    "DOG",
    "Ricker",
    "MorletSL",
    "Marr",
    "Mexican_hat",
    "cwt",
    "profile",
    "Timer",
]

# namespace hygiene: the stdlib imports above are implementation details —
# keep `dir(spy)` to the public API surface (doc/api/index.md)
del os, sys, uuid
