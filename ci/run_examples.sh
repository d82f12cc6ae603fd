#!/usr/bin/env bash
# Integration lane: run every example end-to-end on CPU (the reference CI
# builds and RUNS its examples under sanitizers, run_thread_sanitizer_tests.sh:14-21).
set -euo pipefail
cd "$(dirname "$0")/.."
for ex in sinc sparse inspection sampler temperature distributed accuracy; do
  echo "=== examples/$ex.py ==="
  env JAX_PLATFORMS=cpu python "examples/$ex.py"
done
env JAX_PLATFORMS=cpu python __graft_entry__.py
