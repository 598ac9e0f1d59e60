#!/usr/bin/env bash
# Local mirror of .github/workflows/ci.yml: the full suite plus the three
# engine stress sweeps (CLAUDE.md "Commands"). Everything runs on the
# virtual 8-device CPU mesh that tests/conftest.py forces. ~25-30 min total.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== full suite (x64, virtual 8-device CPU mesh) =="
python -m pytest tests/ -q

echo "== stress sweep: SPY_TEST_NO_X64=1 (float32-only, like production) =="
SPY_TEST_NO_X64=1 python -m pytest tests/ -q -x

echo "== stress sweep: SPY_TPU_CHUNK_BYTES=1 (1-trial chunks) =="
SPY_TPU_CHUNK_BYTES=1 python -m pytest tests/ -q -x

echo "== stress sweep: SPY_TPU_DEVICE_RESIDENT=0 (host path) =="
SPY_TPU_DEVICE_RESIDENT=0 python -m pytest tests/ -q -x

echo "ALL GREEN"
