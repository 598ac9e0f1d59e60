# -*- coding: utf-8 -*-
#
# Generate the per-function API reference under doc/api/ from the live
# package: one markdown page per public `spy.*` symbol (signature +
# docstring) plus an index grouped by subsystem. Replaces the reference's
# Sphinx-autodoc site (reference doc/source/) with a dependency-free
# scripted dump.
#
#   python scripts/gen_api_docs.py          # writes doc/api/*.md
#   python scripts/gen_api_docs.py --check  # exit 1 if out of date

import inspect
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import syncopy_tpu as spy  # noqa: E402

GROUPS = [
    ("Data classes", ["AnalogData", "SpectralData", "CrossSpectralData",
                      "TimeLockData", "SpikeData", "EventData"]),
    ("Data handling", ["definetrial", "redefinetrial", "selectdata", "show",
                       "concat", "copy", "Selector", "TrialIndexer",
                       "TimeIndexer", "StructDict"]),
    ("Analysis frontends", ["freqanalysis", "connectivityanalysis",
                            "preprocessing", "resampledata", "spike_psth",
                            "timelockanalysis"]),
    ("Statistics", ["mean", "std", "var", "median", "itc"]),
    ("I/O", ["save", "load", "load_ft_raw", "load_tdt", "load_nwb",
             "cleanup", "clear", "raw_adata_to_mne_raw",
             "mne_raw_to_adata", "tldata_to_mne_epochs",
             "mne_epochs_to_tldata"]),
    ("Plotting", ["singlepanelplot", "multipanelplot"]),
    ("Parallelism (device mesh)", ["make_mesh", "use_mesh", "active_mesh",
                                "cluster_cleanup", "esi_cluster_setup"]),
    ("Engine & shared", ["ComputationalRoutine", "get_defaults",
                         "best_match", "setup_logging", "set_loglevel",
                         "log", "profile", "Timer"]),
    ("Wavelet library", ["cwt", "Morlet", "Paul", "DOG", "Ricker", "Marr",
                         "Mexican_hat", "WaveletAnalysis",
                         "WaveletTransform"]),
    ("Errors", ["SPYError", "SPYTypeError", "SPYValueError", "SPYIOError",
                "SPYWarning", "SPYInfo"]),
]


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _page(name, obj):
    kind = ("class" if inspect.isclass(obj)
            else "function" if callable(obj) else "object")
    lines = [f"# `spy.{name}`", ""]
    if callable(obj):
        sig = _signature(obj)
        lines += ["```python", f"spy.{name}{sig}", "```", ""]
    doc = inspect.getdoc(obj) or "*(no docstring)*"
    lines += [doc, ""]
    mod = getattr(obj, "__module__", None)
    if mod:
        lines += [f"*{kind} defined in `{mod}`*", ""]
    return "\n".join(lines)


def generate():
    pages = {}
    index = ["# syncopy_tpu API reference", "",
             "Generated by `scripts/gen_api_docs.py` from the live "
             "docstrings — regenerate after changing any public signature.",
             ""]
    covered = set()
    for title, names in GROUPS:
        index += [f"## {title}", ""]
        for name in names:
            obj = getattr(spy, name, None)
            if obj is None:
                continue
            covered.add(name)
            pages[name] = _page(name, obj)
            first = (inspect.getdoc(obj) or "").strip().split("\n")[0]
            index.append(f"- [`spy.{name}`]({name}.md) — {first}")
        index.append("")
    # anything public and callable not covered by a group
    extra = sorted(
        n for n in dir(spy)
        if not n.startswith("_") and n not in covered
        and not inspect.ismodule(getattr(spy, n))
        and callable(getattr(spy, n))
    )
    if extra:
        index += ["## Other", ""]
        for name in extra:
            obj = getattr(spy, name)
            pages[name] = _page(name, obj)
            first = (inspect.getdoc(obj) or "").strip().split("\n")[0]
            index.append(f"- [`spy.{name}`]({name}.md) — {first}")
        index.append("")
    pages["index"] = "\n".join(index)
    return pages


def main():
    outdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "doc", "api")
    pages = generate()
    if "--check" in sys.argv:
        stale = []
        for name, text in pages.items():
            p = os.path.join(outdir, f"{name}.md")
            if not os.path.exists(p) or open(p).read() != text:
                stale.append(name)
        if stale:
            print(f"STALE: {stale}")
            sys.exit(1)
        print(f"doc/api up to date ({len(pages)} pages)")
        return
    os.makedirs(outdir, exist_ok=True)
    for name, text in pages.items():
        with open(os.path.join(outdir, f"{name}.md"), "w") as fh:
            fh.write(text)
    print(f"wrote {len(pages)} pages to {outdir}")


if __name__ == "__main__":
    main()
