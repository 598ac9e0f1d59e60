# -*- coding: utf-8 -*-
#
# API documentation coverage: every public `spy.*` symbol must carry a
# docstring, the analysis frontends must document their parameters, and
# the generated per-function reference (doc/api/, scripts/gen_api_docs.py)
# must exist and cover the public namespace (the reference ships Sphinx
# autodoc under doc/source/).

import inspect
import os

import pytest

import syncopy_tpu as spy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRONTENDS = [
    "freqanalysis", "connectivityanalysis", "preprocessing",
    "resampledata", "spike_psth", "timelockanalysis", "selectdata",
    "mean", "itc", "save", "load",
]


def _public_names():
    return [
        n for n in dir(spy)
        if not n.startswith("_") and not inspect.ismodule(getattr(spy, n))
    ]


def test_every_public_symbol_has_a_docstring():
    missing = [
        n for n in _public_names() if not (inspect.getdoc(getattr(spy, n)) or "").strip()
    ]
    assert missing == [], f"public symbols without docstring: {missing}"


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_documents_parameters(name):
    doc = inspect.getdoc(getattr(spy, name)) or ""
    assert "Parameters" in doc, f"spy.{name} docstring lacks a Parameters section"
    assert "----------" in doc


def test_chan_per_worker_delta_documented():
    # the advisory-semantics delta vs the reference must be stated where
    # users read it
    for name in ("freqanalysis", "connectivityanalysis"):
        doc = inspect.getdoc(getattr(spy, name)) or ""
        assert "chan_per_worker" in doc and "ADVISORY" in doc, name


def test_generated_api_reference_covers_namespace():
    apidir = os.path.join(REPO, "doc", "api")
    assert os.path.isdir(apidir), "run scripts/gen_api_docs.py"
    pages = {f[:-3] for f in os.listdir(apidir) if f.endswith(".md")}
    assert "index" in pages
    missing = [
        n for n in _public_names()
        if callable(getattr(spy, n)) and n not in pages
    ]
    assert missing == [], f"public callables without an API page: {missing}"
